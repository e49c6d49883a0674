// Row LayerNorm with fp32 statistics: y = (x - mean) * rsqrt(var + eps) * g + b,
// and its backward.
//
// Replaces the LayerNorm stages inside nans_clip_tpu/ops/fused_block.py::_kernel
// and ::_mlp_kernel (their `_ln`, fused_block.py:96): the pre-LN prologue
// (bf16 in, bf16 out; the kernel's xn cast at :118/:808) and the post-LN
// epilogue that reads the fp32 residual sum written by gemm.cu
// (fused_block.py:191-194). The TPU kernels did this inside one VMEM-resident
// sub-block; here it is its own pass.
//
// Bound: memory. One read of the row and one write, 4-6 bytes per element
// against a few flops. Design: one warp per row, the whole row held in
// registers (W <= 1024, so at most 32 values a lane), two-pass mean and
// variance in fp32 (the JAX package's order: mean, then mean of squared
// deviations), warp-shuffle reductions, no shared memory.
//
// The backward (nans_layernorm_bwd) replaces the LayerNorm backward stages
// of nans_clip_tpu/ops/fused_block_bwd.py (_ln_bwd :101-105 and the dx_ln
// of _attn_bwd_math :208-212 and _mlp_bwd_math :773-777) and their dgamma /
// dbeta accumulation: it recomputes x-hat and rstd from the LN's input,
// forms dx = rstd * (gh - mean(gh) - xhat * mean(gh * xhat)) with gh =
// g * gamma, adds an optional residual gradient, and for a post-LN
// sub-block also writes dproj = dx * keep (the hidden dropout multiplier,
// dropout.cuh) as bf16. Column sums (sum g * xhat, sum g, sum dproj) are
// taken per block of 32 rows, the warps adding into shared memory one after
// another in a fixed order; reduce.cu sums the blocks in order. For the
// backward kernels that emit their activations (fused_block_bwd.py
// _bert_bwd_kernel :401 uhat, _mlp_bwd_kernel :797 lnstat) it also writes
// x-hat as bf16, and leaves the column sums out when no partials buffer is
// given. Bound: memory, as the forward; one warp a row, the row in registers.
//
// Rows wider than 1024 (ViT-H's 1280, up to the JAX package's 2048: the LN
// stages of fused_block.py::_wide_kernel :497, _mlp_tiled_kernel :911,
// _mlp_batched_kernel :1010 and fused_block_bwd.py::_mlp_bwd_chunked_kernel
// :1023, _attn_bwd_chunked_kernel :1153) would take 64 values a lane and
// spill. They take the *_wide kernels: one block of 256 threads a row, at
// most 8 values a thread, the same two-pass fp32 statistics with the warp
// sums added in a fixed order through shared memory. The backward keeps one
// block on 32 rows, one row after another, so each thread owns the same
// columns on every row and sums them in registers in row order. Rows of
// 1024 and less keep the one-warp kernels.
#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kMaxPerLane = 32;  // W <= 1024
constexpr int kWarps = 8;        // rows per block
constexpr int kBwdRows = 32;     // rows per block of the backward

NANS_DEVICE float load_f32(const float* p, int i) { return p[i]; }
NANS_DEVICE float load_f32(const __nv_bfloat16* p, int i) { return __bfloat162float(p[i]); }
NANS_DEVICE float load_any(const void* p, int f32, size_t i) {
  return f32 ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

NANS_DEVICE float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TIn>
__global__ void __launch_bounds__(kWarps * 32)
    layernorm_kernel(const TIn* __restrict__ x, const __nv_bfloat16* __restrict__ gamma,
                     const __nv_bfloat16* __restrict__ beta, __nv_bfloat16* __restrict__ y,
                     int rows, int width, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TIn* xr = x + static_cast<size_t>(row) * width;
  const int per_lane = width >> 5;

  float v[kMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (i < per_lane) {
      v[i] = load_f32(xr, i * 32 + lane);
      s += v[i];
    }
  }
  const float mean = warp_sum(s) / width;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (i < per_lane) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / width + eps);
  __nv_bfloat16* yr = y + static_cast<size_t>(row) * width;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (i < per_lane) {
      const int c = i * 32 + lane;
      const float o = (v[i] - mean) * rstd * __bfloat162float(gamma[c]) + __bfloat162float(beta[c]);
      yr[c] = __float2bfloat16_rn(o);
    }
  }
}

// One block: rows [blockIdx.x * kBwdRows, +kBwdRows), warp w taking rows
// w, w + 8, ... . part: [3][gridDim.x][width] fp32 column partials. kEmit
// compiles in what only the emitting backward kernels ask for (x-hat out,
// no partials), so that the full-gradient chains keep their code.
template <bool kEmit>
__global__ void __launch_bounds__(kWarps * 32)
    layernorm_bwd_kernel(const void* __restrict__ gin, int g_f32, const void* __restrict__ x,
                         int x_f32, const __nv_bfloat16* __restrict__ gamma,
                         const void* __restrict__ res, int res_f32, void* __restrict__ dx,
                         int dx_f32, __nv_bfloat16* __restrict__ dmul,
                         __nv_bfloat16* __restrict__ xhat_out, drop::Spec drop, int seq,
                         float* __restrict__ part, int rows, int width, float eps) {
  __shared__ float acc[3 * kMaxPerLane * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_lane = width >> 5;
  for (int c = threadIdx.x; c < 3 * width; c += kWarps * 32) acc[c] = 0.f;
  __syncthreads();

  for (int it = 0; it < kBwdRows / kWarps; ++it) {
    const int row = blockIdx.x * kBwdRows + it * kWarps + warp;
    const bool live = row < rows;
    float xh[kMaxPerLane], gr[kMaxPerLane], dm[kMaxPerLane];
    if (live) {
      const size_t base = static_cast<size_t>(row) * width;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          xh[i] = load_any(x, x_f32, base + i * 32 + lane);
          s += xh[i];
        }
      }
      const float mean = warp_sum(s) / width;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const float d = xh[i] - mean;
          sq += d * d;
        }
      }
      const float rstd = rsqrtf(warp_sum(sq) / width + eps);
      float sg = 0.f, sgx = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const int c = i * 32 + lane;
          xh[i] = (xh[i] - mean) * rstd;
          if (kEmit && xhat_out) xhat_out[base + c] = __float2bfloat16_rn(xh[i]);
          gr[i] = load_any(gin, g_f32, base + c);
          const float gh = gr[i] * __bfloat162float(gamma[c]);
          sg += gh;
          sgx += gh * xh[i];
        }
      }
      const float mg = warp_sum(sg) / width, mgx = warp_sum(sgx) / width;
      const int sample = row / seq, srow = row - sample * seq;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const int c = i * 32 + lane;
          float d = rstd * (gr[i] * __bfloat162float(gamma[c]) - mg - xh[i] * mgx);
          if (dmul) {
            dm[i] = d * drop::mult(drop, sample, 0, srow, c);
            dmul[base + c] = __float2bfloat16_rn(dm[i]);
          }
          if (res) d += load_any(res, res_f32, base + c);
          if (dx_f32) {
            static_cast<float*>(dx)[base + c] = d;
          } else {
            static_cast<__nv_bfloat16*>(dx)[base + c] = __float2bfloat16_rn(d);
          }
        }
      }
    }
    if (kEmit && !part) continue;  // uniform over the block: no sums asked for
    // The warps add their rows' terms one after another: a fixed order.
    for (int w = 0; w < kWarps; ++w) {
      if (live && warp == w) {
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
          if (i < per_lane) {
            const int c = i * 32 + lane;
            acc[c] += gr[i] * xh[i];
            acc[width + c] += gr[i];
            if (dmul) acc[2 * width + c] += dm[i];
          }
        }
      }
      __syncthreads();
    }
  }
  if (kEmit && !part) return;
  for (int c = threadIdx.x; c < 3 * width; c += kWarps * 32) {
    const int q = c / width, col = c - q * width;
    part[(static_cast<size_t>(q) * gridDim.x + blockIdx.x) * width + col] = acc[c];
  }
}

constexpr int kWideThreads = 256;
constexpr int kWidePerThread = 8;  // W <= 2048

// The sum of v over the block in a fixed order: each warp's shuffle sum,
// then the warps' sums in order. Every thread returns the same value.
NANS_DEVICE float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // the previous call's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWideThreads / 32; ++w) s += red[w];
  return s;
}

template <typename TIn>
__global__ void __launch_bounds__(kWideThreads)
    layernorm_wide_kernel(const TIn* __restrict__ x, const __nv_bfloat16* __restrict__ gamma,
                          const __nv_bfloat16* __restrict__ beta, __nv_bfloat16* __restrict__ y,
                          int width, float eps) {
  __shared__ float red[kWideThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * width;
  float v[kWidePerThread];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kWidePerThread; ++i) {
    const int c = i * kWideThreads + threadIdx.x;
    v[i] = c < width ? load_f32(x + base, c) : 0.f;
    s += v[i];
  }
  const float mean = block_sum(s, red) / width;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kWidePerThread; ++i) {
    const int c = i * kWideThreads + threadIdx.x;
    const float d = v[i] - mean;
    if (c < width) sq += d * d;
  }
  const float rstd = rsqrtf(block_sum(sq, red) / width + eps);
#pragma unroll
  for (int i = 0; i < kWidePerThread; ++i) {
    const int c = i * kWideThreads + threadIdx.x;
    if (c < width)
      y[base + c] = __float2bfloat16_rn((v[i] - mean) * rstd * __bfloat162float(gamma[c]) +
                                        __bfloat162float(beta[c]));
  }
}

// layernorm_bwd_kernel for rows wider than 1024: one block of kWideThreads
// on rows [blockIdx.x * kBwdRows, +kBwdRows), one row after another; thread
// t owns columns t, t + 256, ... and sums their column terms in registers.
template <bool kEmit>
__global__ void __launch_bounds__(kWideThreads)
    layernorm_bwd_wide_kernel(const void* __restrict__ gin, int g_f32,
                              const void* __restrict__ x, int x_f32,
                              const __nv_bfloat16* __restrict__ gamma,
                              const void* __restrict__ res, int res_f32, void* __restrict__ dx,
                              int dx_f32, __nv_bfloat16* __restrict__ dmul,
                              __nv_bfloat16* __restrict__ xhat_out, drop::Spec drop, int seq,
                              float* __restrict__ part, int rows, int width, float eps) {
  __shared__ float red[kWideThreads / 32];
  float gm[kWidePerThread], acc[3][kWidePerThread];
#pragma unroll
  for (int i = 0; i < kWidePerThread; ++i) {
    const int c = i * kWideThreads + threadIdx.x;
    gm[i] = c < width ? __bfloat162float(gamma[c]) : 0.f;
    acc[0][i] = acc[1][i] = acc[2][i] = 0.f;
  }
  for (int it = 0; it < kBwdRows; ++it) {
    const int row = blockIdx.x * kBwdRows + it;
    if (row >= rows) break;  // uniform over the block
    const size_t base = static_cast<size_t>(row) * width;
    float xh[kWidePerThread], gr[kWidePerThread];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWidePerThread; ++i) {
      const int c = i * kWideThreads + threadIdx.x;
      xh[i] = c < width ? load_any(x, x_f32, base + c) : 0.f;
      s += xh[i];
    }
    const float mean = block_sum(s, red) / width;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kWidePerThread; ++i) {
      const int c = i * kWideThreads + threadIdx.x;
      const float d = xh[i] - mean;
      if (c < width) sq += d * d;
    }
    const float rstd = rsqrtf(block_sum(sq, red) / width + eps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < kWidePerThread; ++i) {
      const int c = i * kWideThreads + threadIdx.x;
      xh[i] = (xh[i] - mean) * rstd;
      gr[i] = 0.f;
      if (c < width) {
        if (kEmit && xhat_out) xhat_out[base + c] = __float2bfloat16_rn(xh[i]);
        gr[i] = load_any(gin, g_f32, base + c);
        const float gh = gr[i] * gm[i];
        sg += gh;
        sgx += gh * xh[i];
      }
    }
    const float mg = block_sum(sg, red) / width, mgx = block_sum(sgx, red) / width;
    const int sample = row / seq, srow = row - sample * seq;
#pragma unroll
    for (int i = 0; i < kWidePerThread; ++i) {
      const int c = i * kWideThreads + threadIdx.x;
      if (c >= width) continue;
      float d = rstd * (gr[i] * gm[i] - mg - xh[i] * mgx);
      float dm = 0.f;
      if (dmul) {
        dm = d * drop::mult(drop, sample, 0, srow, c);
        dmul[base + c] = __float2bfloat16_rn(dm);
      }
      if (res) d += load_any(res, res_f32, base + c);
      if (dx_f32) {
        static_cast<float*>(dx)[base + c] = d;
      } else {
        static_cast<__nv_bfloat16*>(dx)[base + c] = __float2bfloat16_rn(d);
      }
      if (!kEmit || part) {
        acc[0][i] += gr[i] * xh[i];
        acc[1][i] += gr[i];
        acc[2][i] += dm;
      }
    }
  }
  if (kEmit && !part) return;
#pragma unroll
  for (int i = 0; i < kWidePerThread; ++i) {
    const int c = i * kWideThreads + threadIdx.x;
    if (c >= width) continue;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      part[(static_cast<size_t>(q) * gridDim.x + blockIdx.x) * width + c] = acc[q][i];
  }
}

}  // namespace

// gin: [rows, width] the LN output's gradient, fp32 (g_f32) or bf16; x:
// [rows, width] the LN's input, fp32 (x_f32) or bf16; gamma: [width] bf16;
// res: [rows, width] fp32 (res_f32) or bf16, or null; dx: [rows, width] fp32
// (dx_f32) or bf16; dmul: [rows, width] bf16 or null (then no dropout);
// xhat: [rows, width] bf16 or null; part: [3, ceil(rows / 32), width] fp32,
// or null for no column sums. width % 32 == 0, width <= 2048 (checked by
// the Python wrapper). Returns cudaGetLastError().
extern "C" int nans_layernorm_bwd(const void* gin, int g_f32, const void* x, int x_f32,
                                  const void* gamma, const void* res, int res_f32, void* dx,
                                  int dx_f32, void* dmul, void* xhat, unsigned drop_seed,
                                  unsigned drop_stream, unsigned drop_threshold,
                                  float drop_scale, int drop_on, int seq, void* part, int rows,
                                  int width, float eps, void* stream) {
  const dim3 grid((rows + kBwdRows - 1) / kBwdRows);
  const bool emit = xhat || !part, wide = width > kMaxPerLane * 32;
  auto* kernel = wide ? (emit ? layernorm_bwd_wide_kernel<true> : layernorm_bwd_wide_kernel<false>)
                      : (emit ? layernorm_bwd_kernel<true> : layernorm_bwd_kernel<false>);
  kernel<<<grid, wide ? kWideThreads : kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      gin, g_f32, x, x_f32, static_cast<const __nv_bfloat16*>(gamma), res, res_f32, dx, dx_f32,
      static_cast<__nv_bfloat16*>(dmul), static_cast<__nv_bfloat16*>(xhat),
      drop::Spec{drop_seed, drop_stream, drop_threshold, drop_scale, drop_on},
      seq > 0 ? seq : 1, static_cast<float*>(part), rows, width, eps);
  return static_cast<int>(cudaGetLastError());
}

// x: [rows, width] fp32 (x_is_fp32 != 0) or bf16; gamma, beta: [width] bf16;
// y: [rows, width] bf16. width % 32 == 0 and width <= 2048 (checked by the
// Python wrapper). Returns cudaGetLastError() after the launch.
extern "C" int nans_layernorm(const void* x, int x_is_fp32, const void* gamma, const void* beta,
                              void* y, int rows, int width, float eps, void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const __nv_bfloat16*>(gamma);
  const auto* b = static_cast<const __nv_bfloat16*>(beta);
  auto* out = static_cast<__nv_bfloat16*>(y);
  if (width > kMaxPerLane * 32) {
    if (x_is_fp32) {
      layernorm_wide_kernel<float><<<rows, kWideThreads, 0, s>>>(static_cast<const float*>(x), g,
                                                                 b, out, width, eps);
    } else {
      layernorm_wide_kernel<__nv_bfloat16><<<rows, kWideThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), g, b, out, width, eps);
    }
  } else if (x_is_fp32) {
    layernorm_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(x), g, b, out, rows,
                                                   width, eps);
  } else {
    layernorm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b, out, rows, width, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
