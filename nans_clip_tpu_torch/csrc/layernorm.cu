// Row LayerNorm with fp32 statistics: y = (x - mean) * rsqrt(var + eps) * g + b.
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
#include "common.cuh"

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

}  // namespace

// x: [rows, width] fp32 (x_is_fp32 != 0) or bf16; gamma, beta: [width] bf16;
// y: [rows, width] bf16. width % 32 == 0 and width <= 1024 (checked by the
// Python wrapper). Returns cudaGetLastError() after the launch.
extern "C" int nans_layernorm(const void* x, int x_is_fp32, const void* gamma, const void* beta,
                              void* y, int rows, int width, float eps, void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const __nv_bfloat16*>(gamma);
  const auto* b = static_cast<const __nv_bfloat16*>(beta);
  auto* out = static_cast<__nv_bfloat16*>(y);
  if (x_is_fp32) {
    layernorm_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(x), g, b, out, rows,
                                                   width, eps);
  } else {
    layernorm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b, out, rows, width, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
