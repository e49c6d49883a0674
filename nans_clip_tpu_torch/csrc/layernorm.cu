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
// of _attn_bwd_math :208-212 and _mlp_bwd_math :773-777, and of the wide
// _mlp_bwd_chunked_kernel :1023, _attn_bwd_chunked_kernel :1153) and their
// dgamma / dbeta accumulation: it recomputes x-hat and rstd from the LN's
// input, forms dx = rstd * (gh - mean(gh) - xhat * mean(gh * xhat)) with gh
// = g * gamma, adds the residual gradient (pre-LN), and for a post-LN
// sub-block also writes dproj = dx * keep (the hidden dropout multiplier,
// dropout.cuh, indices (sample, 0, row, col) on the spec's stream) as bf16.
// Column partials (sum g * xhat, sum g, sum dproj) per block in fp32;
// reduce.cu sums them in block order. For the backward kernels that emit
// their activations (fused_block_bwd.py _bert_bwd_kernel :401 uhat,
// _mlp_bwd_kernel :797 lnstat) it also writes x-hat as bf16 and leaves the
// sums out. Bound: memory, 10 bytes an element at the pre-LN image form
// (gin fp32, x, res and dx bf16: 0.058 ms at [25,216, 768] and 3.35
// TB/s), 12 at the post-LN text form. Design:
// * Compile-time types and options: the two forms the chains call, with or
//   without sums and x-hat, are instances, so no element load picks its
//   type at run time.
// * 16-byte accesses: a lane owns runs of 8 consecutive columns (16 bytes
//   of bf16, 32 of fp32), lanes on neighbouring runs.
// * Column partials across all the rows a warp takes: in registers where
//   they fit beside the row (the pre-LN form up to W 768 a warp), else in
//   the warp's own rows of shared memory, which no other warp touches (the
//   post-LN form's three planes spilled 380-1008 bytes a thread at 128
//   registers in registers); the row slots' partials summed in slot order
//   once, at the block's end.
// * A persistent grid of two blocks an SM, each over a contiguous range of
//   rows (bwd_plan): [grid, planes, W] partials (263 x 2 x 768 at ViT-B's
//   image rows), summed by one column_sum launch.
// * One body for every width: the 8-column runs a lane (1-4) are a
//   template parameter; one warp a row up to W 1024, a pair of warps above
//   (ViT-H's 1280, up to the JAX package's 2048), their row sums exchanged
//   through shared memory under a barrier of the pair.
//
// The forward's rows wider than 1024 (the LN stages of
// fused_block.py::_wide_kernel :497, _mlp_tiled_kernel :911,
// _mlp_batched_kernel :1010) would take 64 values a lane and spill. They
// take layernorm_wide_kernel: one block of 256 threads a row, at most 8
// values a thread, the same two-pass fp32 statistics with the warp sums
// added in a fixed order through shared memory.
#include <type_traits>

#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kMaxPerLane = 32;  // W <= 1024
constexpr int kWarps = 8;        // rows per block

NANS_DEVICE float load_f32(const float* p, int i) { return p[i]; }
NANS_DEVICE float load_f32(const __nv_bfloat16* p, int i) { return __bfloat162float(p[i]); }

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

// ---------------------------------------------------------------------------
// The backward (see the note at the top): a persistent grid, a block of 8
// warps a contiguous range of rows.

constexpr int kBwdWarps = 8;
constexpr int kBwdBlocksPerSm = 2;

// The two forms the chains call (ops/fused_block_bwd.py): the pre-LN image
// form (gin fp32, x bf16, a bf16 residual gradient, dx bf16) and the
// post-LN text form (gin bf16, x fp32, no residual, dx fp32, dproj bf16
// under the hidden dropout).
enum Form { kPre = 0, kPost = 1 };

// Grid and rows of the backward at (rows, width) on `sms` SMs;
// ops/layernorm.py::layernorm_bwd_plan computes the same.
struct BwdPlan {
  int grid, rows_per_block, warps_per_row, chunks_per_lane;
};

BwdPlan bwd_plan(int rows, int width, int sms) {
  const int g = width > kMaxPerLane * 32 ? 2 : 1, slots = kBwdWarps / g;
  const int most = kBwdBlocksPerSm * sms, least_rows = (rows + slots - 1) / slots;
  int grid = most < least_rows ? most : least_rows;
  const int rpb = (rows + grid - 1) / grid;
  grid = (rows + rpb - 1) / rpb;
  return BwdPlan{grid, rpb, g, (width / 8 / g + 31) / 32};
}

// Eight consecutive values of a row (16 bytes of bf16, 32 of fp32) as fp32.
NANS_DEVICE void load8(float (&v)[8], const __nv_bfloat16* p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

NANS_DEVICE void load8(float (&v)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

NANS_DEVICE void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// p[0..8) += v (shared memory, 16-byte aligned).
NANS_DEVICE void add8(float* p, const float (&v)[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  const float4 a = q[0], b = q[1];
  q[0] = make_float4(a.x + v[0], a.y + v[1], a.z + v[2], a.w + v[3]);
  q[1] = make_float4(b.x + v[4], b.y + v[5], b.z + v[6], b.w + v[7]);
}

NANS_DEVICE void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

NANS_DEVICE float2 warp_sum(float2 v) {
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  return v;
}

NANS_DEVICE float2 operator+(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }

// The sum of v over the G warps of a row (G = 1: the warp's shuffle sum; G
// = 2: both warps' sums through red, added in warp order, after a barrier
// of the pair, named 1 + slot). Each call of a row takes its own red.
template <int G, typename T>
NANS_DEVICE T row_sum(T v, T* red, int slot, int half, int lane) {
  v = warp_sum(v);
  if constexpr (G == 1) {
    return v;
  } else {
    if (lane == 0) red[half] = v;
    asm volatile("bar.sync %0, %1;" ::"r"(1 + slot), "r"(64) : "memory");
    return red[0] + red[1];
  }
}

// Rows [blockIdx.x * rows_per_block, +rows_per_block) of the block; G warps
// a row, the block's 8 / G row slots taking rows in turn; lane `lane` of
// warp `half` of a row owns the 8-column chunks half * C/G + lane + 32 i (C
// = width / 8). part: [gridDim.x][planes][width] fp32 column partials
// (planes 2 pre-LN: sum g xhat, sum g; 3 post-LN: and sum dproj).
template <int kForm, bool kSums, bool kXhat, int N, int G>
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdBlocksPerSm)
    layernorm_bwd_kernel(const void* __restrict__ gin_, const void* __restrict__ x_,
                         const __nv_bfloat16* __restrict__ gamma,
                         const __nv_bfloat16* __restrict__ res, void* __restrict__ dx_,
                         __nv_bfloat16* __restrict__ dproj, __nv_bfloat16* __restrict__ xhat_out,
                         drop::Spec drop, int seq, float* __restrict__ part, int rows, int width,
                         int rows_per_block, float eps) {
  using TG = typename std::conditional<kForm == kPre, float, __nv_bfloat16>::type;
  using TX = typename std::conditional<kForm == kPre, __nv_bfloat16, float>::type;
  using TD = TX;
  constexpr int kPlanes = kForm == kPre ? 2 : 3, kSlots = kBwdWarps / G;
  // the partials in registers where they fit beside the row (2 planes of up
  // to 24 columns a lane), else in the slot's own shared rows (slot_acc:
  // [kSlots][kPlanes][width]), which only its lanes touch
  constexpr bool kRegAcc = kPlanes * N <= 6;
  __shared__ __align__(16) float acc_s[kSums && kRegAcc ? kPlanes * kMaxPerLane * 32 * 2 : 4];
  extern __shared__ __align__(16) float slot_acc[];
  __shared__ float2 red_s[kSlots][3][G];
  const auto* gin = static_cast<const TG*>(gin_);
  const auto* x = static_cast<const TX*>(x_);
  auto* dx = static_cast<TD*>(dx_);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / G, half = warp - slot * G;
  const int cw = width / 8 / G;  // chunks a warp
  const float inv_w = 1.f / width;

  float acc[kSums && kRegAcc ? kPlanes : 1][N][8];
  float* mine = slot_acc + slot * kPlanes * width;
  if (kSums) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
#pragma unroll
      for (int q = 0; q < kPlanes; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (kRegAcc) acc[q][i][j] = 0.f;
          else if (c < cw) mine[q * width + 8 * (half * cw + c) + j] = 0.f;
        }
    }
  }
  const int r0 = blockIdx.x * rows_per_block, r1 = min(rows, r0 + rows_per_block);
  for (int row = r0 + slot; row < r1; row += kSlots) {
    const size_t base = static_cast<size_t>(row) * width;
    float xh[N][8], g[N][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      if (c < cw) {
        const int col = 8 * (half * cw + c);
        load8(xh[i], x + base + col);
        load8(g[i], gin + base + col);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += xh[i][j];
      }
    }
    const float mean = row_sum<G>(s, &red_s[slot][0][0].x, slot, half, lane) * inv_w;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (lane + 32 * i < cw)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = xh[i][j] - mean;
          sq += d * d;
        }
    const float rstd = rsqrtf(row_sum<G>(sq, &red_s[slot][1][0].x, slot, half, lane) * inv_w + eps);
    float2 sums = make_float2(0.f, 0.f);   // sum gh, sum gh xhat
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      if (c < cw) {
        float gm[8];
        load8(gm, gamma + 8 * (half * cw + c));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xh[i][j] = (xh[i][j] - mean) * rstd;
          const float gh = g[i][j] * gm[j];
          sums.x += gh;
          sums.y += gh * xh[i][j];
        }
      }
    }
    sums = row_sum<G>(sums, &red_s[slot][2][0], slot, half, lane);
    const float mg = sums.x * inv_w, mgx = sums.y * inv_w;
    const int sample = row / seq, srow = row - sample * seq;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      if (c >= cw) continue;
      const int col = 8 * (half * cw + c);
      float gm[8], d[8], dm[8];
      load8(gm, gamma + col);
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = rstd * (g[i][j] * gm[j] - mg - xh[i][j] * mgx);
      if (kForm == kPost) {
#pragma unroll
        for (int j = 0; j < 8; ++j) dm[j] = d[j] * drop::mult(drop, sample, 0, srow, col + j);
        store8(dproj + base + col, dm);
      } else {
        float r[8];
        load8(r, res + base + col);
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] += r[j];
      }
      store8(dx + base + col, d);
      if (kXhat) store8(xhat_out + base + col, xh[i]);
      if (kSums && kRegAcc) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[0][i][j] += g[i][j] * xh[i][j];
          acc[1][i][j] += g[i][j];
          if (kForm == kPost) acc[kPlanes - 1][i][j] += dm[j];
        }
      } else if (kSums) {
        float a[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = g[i][j] * xh[i][j];
        add8(mine + col, a);
        add8(mine + width + col, g[i]);
        if (kForm == kPost) add8(mine + 2 * width + col, dm);
      }
    }
  }
  if constexpr (kSums && !kRegAcc) {
    // The row slots' partials summed in slot order: a fixed order.
    __syncthreads();
    float* out = part + static_cast<size_t>(blockIdx.x) * kPlanes * width;
    for (int c = threadIdx.x; c < kPlanes * width; c += kBwdWarps * 32) {
      float t = slot_acc[c];
#pragma unroll
      for (int k = 1; k < kSlots; ++k) t += slot_acc[k * kPlanes * width + c];
      out[c] = t;
    }
  }
  if constexpr (kSums && kRegAcc) {
    // The row slots' partials summed in slot order through shared memory,
    // then written once: a fixed order.
    for (int k = 0; k < kSlots; ++k) {
      if (slot == k) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int c = lane + 32 * i;
          if (c >= cw) continue;
          const int col = 8 * (half * cw + c);
#pragma unroll
          for (int q = 0; q < kPlanes; ++q)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float* a = acc_s + q * width + col + j;
              *a = k == 0 ? acc[q][i][j] : *a + acc[q][i][j];
            }
        }
      }
      __syncthreads();
    }
    float* out = part + static_cast<size_t>(blockIdx.x) * kPlanes * width;
    for (int c = threadIdx.x; c < kPlanes * width / 4; c += kBwdWarps * 32)
      reinterpret_cast<float4*>(out)[c] = reinterpret_cast<const float4*>(acc_s)[c];
  }
}

template <int kForm, bool kSums, bool kXhat, int N, int G>
int launch_ln_bwd_n(const void* gin, const void* x, const void* gamma, const void* res, void* dx,
                    void* dproj, void* xhat, const drop::Spec& drop, int seq, void* part,
                    int rows, int width, float eps, const BwdPlan& p, cudaStream_t stream) {
  const auto kernel = layernorm_bwd_kernel<kForm, kSums, kXhat, N, G>;
  constexpr int kPlanes = kForm == kPre ? 2 : 3;
  const int smem = kSums && kPlanes * N > 6 ? kBwdWarps / G * kPlanes * width * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<p.grid, kBwdWarps * 32, smem, stream>>>(
      gin, x, static_cast<const __nv_bfloat16*>(gamma), static_cast<const __nv_bfloat16*>(res),
      dx, static_cast<__nv_bfloat16*>(dproj), static_cast<__nv_bfloat16*>(xhat), drop, seq,
      static_cast<float*>(part), rows, width, p.rows_per_block, eps);
  return static_cast<int>(cudaGetLastError());
}

// The instance of the row width: chunks a lane 1-4, one warp a row up to
// W 1024, two above.
template <int kForm, bool kSums, bool kXhat>
int launch_ln_bwd(const void* gin, const void* x, const void* gamma, const void* res, void* dx,
                  void* dproj, void* xhat, const drop::Spec& drop, int seq, void* part, int rows,
                  int width, float eps, const BwdPlan& p, cudaStream_t stream) {
#define NANS_LN_BWD(N, G)                                                                      \
  return launch_ln_bwd_n<kForm, kSums, kXhat, N, G>(gin, x, gamma, res, dx, dproj, xhat, drop, \
                                                    seq, part, rows, width, eps, p, stream)
  if (p.warps_per_row == 1) {
    switch (p.chunks_per_lane) {
      case 1: NANS_LN_BWD(1, 1);
      case 2: NANS_LN_BWD(2, 1);
      case 3: NANS_LN_BWD(3, 1);
      case 4: NANS_LN_BWD(4, 1);
    }
  } else {
    switch (p.chunks_per_lane) {
      case 3: NANS_LN_BWD(3, 2);
      case 4: NANS_LN_BWD(4, 2);
    }
  }
#undef NANS_LN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The pre-LN form (form 0: gin fp32, x bf16, res bf16, dx bf16) or the
// post-LN form (form 1: gin bf16, x fp32, no res, dx fp32, dproj bf16 under
// the dropout spec), each [rows, width]; gamma: [width] bf16; xhat: [rows,
// width] bf16 or null; part: [grid, 2 (pre) or 3 (post), width] fp32 column
// partials (nans_layernorm_bwd_plan's grid), or null for no column sums.
// width % 32 == 0, width <= 2048 (checked by the Python wrapper). Returns
// cudaGetLastError().
extern "C" int nans_layernorm_bwd(int form, const void* gin, const void* x, const void* gamma,
                                  const void* res, void* dx, void* dproj, void* xhat,
                                  unsigned drop_seed, unsigned drop_stream,
                                  unsigned drop_threshold, float drop_scale, int drop_on,
                                  int drop_sample0, int seq,
                                  void* part, int rows, int width, int sms, float eps,
                                  void* stream) {
  const BwdPlan p = bwd_plan(rows, width, sms);
  const drop::Spec drop{drop_seed, drop_stream, drop_threshold, drop_scale, drop_on,
                        drop_sample0};
  const auto s = static_cast<cudaStream_t>(stream);
  seq = seq > 0 ? seq : 1;
#define NANS_LN_FORM(F, SUMS, XHAT)                                                         \
  return launch_ln_bwd<F, SUMS, XHAT>(gin, x, gamma, res, dx, dproj, xhat, drop, seq, part, \
                                      rows, width, eps, p, s)
  if (form == kPre && res) {
    if (part && !xhat) NANS_LN_FORM(kPre, true, false);
    if (!part && xhat) NANS_LN_FORM(kPre, false, true);
    if (!part && !xhat) NANS_LN_FORM(kPre, false, false);
  }
  if (form == kPost && !res) {
    if (part && !xhat) NANS_LN_FORM(kPost, true, false);
    if (!part && xhat) NANS_LN_FORM(kPost, false, true);
  }
#undef NANS_LN_FORM
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's launch plan at (rows, width) on `sms` SMs: out = {grid,
// rows a block, warps a row, 8-column chunks a lane}.
// ops/layernorm.py::layernorm_bwd_plan computes the same.
extern "C" int nans_layernorm_bwd_plan(int rows, int width, int sms, int* out) {
  const BwdPlan p = bwd_plan(rows, width, sms);
  out[0] = p.grid;
  out[1] = p.rows_per_block;
  out[2] = p.warps_per_row;
  out[3] = p.chunks_per_lane;
  return 0;
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
