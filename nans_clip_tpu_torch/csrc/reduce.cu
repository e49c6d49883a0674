// Column sums in a fixed order: out[c][j] = sum of x[i][j] over the rows
// i of chunk c, row by row.
//
// Replaces the batch-grid accumulation of the backward kernels in
// nans_clip_tpu/ops/fused_block_bwd.py (the `dref[:] += d_c` blocks of
// _bwd_fullgrad_kernel :263-270, _bert_bwd_fullgrad_kernel :440-447 and
// _mlp_bwd_fullgrad_kernel :931-938): the TPU ran its grid in order on one
// core and carried the fp32 sums in VMEM; Hopper's blocks run in no order.
// So every sum across blocks is taken in two passes: partials per row chunk,
// then the partials summed in chunk order, with no float atomics, and two
// runs give the same bits. It sums the bias gradients (B*S rows), the
// LayerNorm kernel's per-block dgamma/dbeta partials and the weight
// gradient's K-split partials (gemm.cu).
//
// Bound: memory, one read of x. Design: one thread a column (neighbouring
// threads on neighbouring columns, so every row read is coalesced), one
// block row a chunk of rows. A sum over a few hundred fp32 rows (the
// LayerNorm backward's partials, a first pass's chunk sums) takes one
// launch of colsum_split_kernel instead: a block over 32 columns, its 8
// warps each over every 8th row, their sums added in warp order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    colsum_kernel(const void* __restrict__ x, int x_f32, int rows, int cols, int rows_per_chunk,
                  float* __restrict__ out) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= cols) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  if (x_f32) {
    const float* p = static_cast<const float*>(x) + col;
    for (int r = r0; r < r1; ++r) s += p[static_cast<size_t>(r) * cols];
  } else {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(x) + col;
    for (int r = r0; r < r1; ++r) s += __bfloat162float(p[static_cast<size_t>(r) * cols]);
  }
  out[static_cast<size_t>(blockIdx.y) * cols + col] = s;
}

// One pass over a few hundred rows: a block of kThreads takes 32 columns,
// warp w the rows w, w + 8, ... of them (lane l column l), and the 8 warps'
// sums are added in warp order. out: [cols] fp32.
constexpr int kSplitWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    colsum_split_kernel(const float* __restrict__ x, int rows, int cols,
                        float* __restrict__ out) {
  __shared__ float part[kSplitWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < cols) {
    const float* p = x + col;
#pragma unroll 4
    for (int r = warp; r < rows; r += kSplitWarps) s += p[static_cast<size_t>(r) * cols];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float t = part[0][lane];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) t += part[w][lane];
    out[col] = t;
  }
}

}  // namespace

// x: [rows, cols] fp32 (x_f32 != 0) or bf16; out: [ceil(rows /
// rows_per_chunk), cols] fp32. Returns cudaGetLastError().
extern "C" int nans_colsum(const void* x, int x_f32, int rows, int cols, int rows_per_chunk,
                           void* out, void* stream) {
  const dim3 grid((cols + kThreads - 1) / kThreads, (rows + rows_per_chunk - 1) / rows_per_chunk);
  colsum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_f32, rows, cols, rows_per_chunk, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x: [rows, cols] fp32; out: [cols] fp32, the column sums in one pass with
// the rows split over a block's warps (colsum_split_kernel). Returns
// cudaGetLastError().
extern "C" int nans_colsum_split(const void* x, int rows, int cols, void* out, void* stream) {
  colsum_split_kernel<<<(cols + 31) / 32, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, cols, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
