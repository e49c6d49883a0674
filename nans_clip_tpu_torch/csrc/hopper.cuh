// Hopper's asynchronous machinery, shared by gemm.cu and tower.cu: mbarrier
// rings fed by the Tensor Memory Accelerator (TMA), wgmma descriptors of
// 128-byte-swizzled K-major tiles, and the host side that encodes the 2D
// tensor maps. Header-only and `static`, as common.cuh, so that each .cu
// file includes it and the files still link into one library.
#pragma once

#include <cuda.h>

#include "common.cuh"

// An mbarrier wait of more than ~5 s (10^10 cycles) traps: a fault in the
// ring's protocol ends the launch with an error instead of hanging the card.
constexpr long long kWaitTimeout = 10000000000LL;

NANS_DEVICE void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

NANS_DEVICE void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed.
NANS_DEVICE void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  long long start = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) start = clock64();
    else if ((spin & 1023) == 0 && clock64() - start > kWaitTimeout) __trap();
  }
}

// A box of the 2D tensor map at (c0 along the contiguous dimension, c1
// along rows) into dst; its bytes complete the transaction count of `bar`.
NANS_DEVICE void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows in the
// 128-byte swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start
// address and strides in 16-byte units, LBO unused (1), SBO = 1024 bytes
// between 8-row atoms, layout type 1 (128B) in bits 62-63. A k16 step within
// the 64-wide tile advances the start by 32 bytes.
NANS_DEVICE uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

NANS_DEVICE void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
NANS_DEVICE void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
NANS_DEVICE void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, cols] row-major operand of `elem_bytes`-byte elements as boxes of
// box_rows x box_cols, zero fill past its edges (the rows past an
// activation's M, say). The map can live in a kernel parameter
// (__grid_constant__) or in device memory (64-byte aligned).
static inline bool encode_2d(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType dtype,
                             int elem_bytes, const void* base, int rows, int cols, int box_cols,
                             int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
