// Shared device helpers for the hand-written Hopper kernels (sm_90a).
//
// Tensor-core path: mma.sync m16n8k16 with bf16 inputs and fp32
// accumulators, fragments loaded from shared memory with ldmatrix.
// Everything here is header-only and `static` so that each .cu file can
// include it and the files still link into one shared library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NANS_DEVICE static __device__ __forceinline__

NANS_DEVICE uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared. `src_bytes` < 16 zero-fills the rest
// (0 gives a zero chunk: the ragged-edge mask).
NANS_DEVICE void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

NANS_DEVICE void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
NANS_DEVICE void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8.
NANS_DEVICE void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// The same, transposed: for a row-major [k][n] operand used as mma's B.
NANS_DEVICE void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 in, fp32 accumulate.
NANS_DEVICE void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16 (round to nearest even); `lo`
// lands in the low half, the element with the smaller column index.
NANS_DEVICE uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
