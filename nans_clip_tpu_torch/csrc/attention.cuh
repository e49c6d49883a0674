// The attention building blocks shared by attention.cu, flash.cu and
// tower.cu: one warp's 16 query rows of one (sample, head) against key rows
// (and their bias) already staged in shared memory.
//
// The head dim is a template parameter through the number of 16-wide k-steps
// KS that the fragment arrays carry (dh = 16 KS): KS = 4 is dh 64 (every
// ViT-B/L and RoBERTa tower), KS = 5 is dh 80 (ViT-H: five k-steps of 16 and
// ten n-tiles of 8); attention.cu, flash.cu and tower.cu instance both. Two
// layouts of a head's rows in shared memory: padded rows dh + 8 bf16 apart
// (attn::ldk: 144 bytes at dh 64, 176 at dh 80, both 16-byte multiples that
// keep ldmatrix's eight row addresses on distinct banks), which tower.cu's
// attention stage reads; and unpadded rows with XOR-swizzled 16-byte chunks
// (attn::swz, staged by cp.async), which attention.cu's and flash.cu's
// kernels read (the second half of this file).
//
// fp32 scores, fp32 softmax statistics, a max-subtracted exp and a row-sum
// divide; P is rounded to bf16 before the PV product and ctx is stored as
// bf16 (the rounding points of nans_clip_tpu/ops/fused_block.py:164-182 and
// layer_kernel.py:68-86). The two-pass core: the first pass over the keys
// finds the row max and sum (fold_row_stats, merge_row_stats), the second
// recomputes the scores, normalises P exactly as the TPU kernel did (p =
// exp(s - m) / l, then the bf16 cast) and accumulates P V. Recomputing Q K^T
// once costs less than holding S scores a row in registers. With a dropout
// spec on, P is multiplied by its keep multiplier (dropout.cuh, counter
// (sample, head, query, key)) in fp32 before the bf16 cast
// (fused_block.py:146-149).
#pragma once

#include "common.cuh"
#include "dropout.cuh"

namespace attn {

// Padded row stride (bf16) of a head's rows for KS k-steps.
template <int KS>
__host__ __device__ constexpr int ldk() {
  return 16 * KS + 8;
}

// Scaled and biased scores of this warp's 16 rows against keys j0..j0+15:
// s[t][e] is key j0 + 8t + 2(lane%4) + (e&1), row lane/4 + 8(e>>1).
template <int KS>
NANS_DEVICE void score_tile(float (&s)[2][4], const uint32_t (&qf)[KS][4],
                            const __nv_bfloat16* sK, const float* sKB, int j0, int lane,
                            float scale) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t kf[4];
    const int r = j0 + (lane & 7) + ((lane >> 4) << 3);
    ldmatrix_x4(kf, sK + r * ldk<KS>() + kk * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16_16816(s[0], qf[kk], kf[0], kf[1]);
    mma_bf16_16816(s[1], qf[kk], kf[2], kf[3]);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[t][e] = s[t][e] * scale + sKB[j0 + 8 * t + 2 * (lane & 3) + (e & 1)];
}

// Raw products of 16 A rows (fragments af, loaded as Q is: row_frags or
// global_frags) with rows j0..j0+15 of sB (row stride ldk): d[t][e] pairs A row
// lane/4 + 8(e>>1) with B row j0 + 8t + 2(lane%4) + (e&1).
template <int KS>
NANS_DEVICE void dot_tile(float (&d)[2][4], const uint32_t (&af)[KS][4],
                          const __nv_bfloat16* sB, int j0, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t bf[4];
    const int r = j0 + (lane & 7) + ((lane >> 4) << 3);
    ldmatrix_x4(bf, sB + r * ldk<KS>() + kk * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16_16816(d[0], af[kk], bf[0], bf[1]);
    mma_bf16_16816(d[1], af[kk], bf[2], bf[3]);
  }
}

// A fragments of 16 rows (row stride ldk) for dot_tile.
template <int KS>
NANS_DEVICE void row_frags(uint32_t (&f)[KS][4], const __nv_bfloat16* s, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(f[kk], s + (lane & 15) * ldk<KS>() + kk * 16 + (lane >> 4) * 8);
}

// The same fragments read straight from global memory: rows row0.. of a
// head whose row r starts at src + r * ld (bf16), zero for rows >= S.
// Register e of k-step kk holds row lane/4 + 8(e&1), columns 16kk + 8(e>>1)
// + 2(lane%4) + {0, 1}: what ldmatrix_x4 gives for the same rows.
template <int KS>
NANS_DEVICE void global_frags(uint32_t (&f)[KS][4], const __nv_bfloat16* src, size_t ld,
                              int row0, int S, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = row0 + (lane >> 2) + 8 * (e & 1);
    const __nv_bfloat16* p = src + static_cast<size_t>(r) * ld + 8 * (e >> 1) + 2 * (lane & 3);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      f[kk][e] = r < S ? *reinterpret_cast<const uint32_t*>(p + kk * 16) : 0u;
  }
}

// o[0..2KS) += a (16 x 16, bf16 A fragment) . rows j0..j0+15 of sB (the
// contraction runs over those rows, 16 KS columns out).
template <int NT>
NANS_DEVICE void accumulate_rows(float (&o)[NT][4], const uint32_t (&a)[4],
                                 const __nv_bfloat16* sB, int j0, int lane) {
  constexpr int KS = NT / 2;
#pragma unroll
  for (int dp = 0; dp < KS; ++dp) {
    uint32_t f[4];
    const int r = j0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldmatrix_x4_trans(f, sB + r * ldk<KS>() + dp * 16 + (lane >> 4) * 8);
    mma_bf16_16816(o[2 * dp], a, f[0], f[1]);
    mma_bf16_16816(o[2 * dp + 1], a, f[2], f[3]);
  }
}

// Merges the row max m and row sum l of the four lanes that share a row.
NANS_DEVICE void merge_row_stats(float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[hr], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[hr], o);
      const float m_new = fmaxf(m[hr], m_o);
      if (m_new == -INFINITY) continue;
      l[hr] = l[hr] * expf(m[hr] - m_new) + l_o * expf(m_o - m_new);
      m[hr] = m_new;
    }
  }
}

// Folds one score tile into this lane's running row max m and sum l.
NANS_DEVICE void fold_row_stats(float (&m)[2], float (&l)[2], const float (&s)[2][4]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float tmax = fmaxf(fmaxf(s[0][2 * hr], s[0][2 * hr + 1]),
                             fmaxf(s[1][2 * hr], s[1][2 * hr + 1]));
    const float m_new = fmaxf(m[hr], tmax);
    if (m_new == -INFINITY) continue;
    float acc = l[hr] * expf(m[hr] - m_new);
#pragma unroll
    for (int t = 0; t < 2; ++t)
      acc += expf(s[t][2 * hr] - m_new) + expf(s[t][2 * hr + 1] - m_new);
    l[hr] = acc;
    m[hr] = m_new;
  }
}

// ---------------------------------------------------------------------------
// Unpadded swizzled rows.

// Element offset of 16-byte chunk c of row r in a head's unpadded rows of
// 16 KS bf16. The chunk index is XOR-swizzled so that the eight rows of an
// ldmatrix (r0..r0+7, r0 % 8 == 0) fall on distinct banks: c ^ (r % 8) at
// dh 64 (128-byte rows); c ^ ((r / 4) % 2) at dh 80 (160-byte rows start
// 32 bytes apart mod 128, so rows r and r + 4 collide unswizzled; the XOR
// swaps chunks 2i and 2i + 1 and stays below 10).
template <int KS>
NANS_DEVICE int swz(int r, int c) {
  static_assert(KS == 4 || KS == 5, "heads of 64 or 80");
  const int x = KS == 4 ? (r & 7) : ((r >> 2) & 1);
  return r * 16 * KS + 8 * (c ^ x);
}

// Rows [0, n) of a head (row r at src + r * ld) into dst by cp.async, zero
// past `valid`; threads tid, tid + nthreads, ... share the 16-byte chunks.
template <int KS>
NANS_DEVICE void stage_async(__nv_bfloat16* dst, const __nv_bfloat16* src, size_t ld, int n,
                             int valid, int tid, int nthreads) {
  constexpr int kChunks = 2 * KS;
  for (int i = tid; i < n * kChunks; i += nthreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool in = r < valid;
    cp_async16(dst + swz<KS>(r, c), src + (in ? r * ld : 0) + 8 * c, in ? 16 : 0);
  }
}

// A lane's ldmatrix offsets (elements) within a 16-row tile of swizzled
// rows: the tile starts on a multiple of 16 rows, so the swizzle of a lane's
// row depends on the lane alone, and tile j0 adds j0 * 16 KS to each.
template <int KS>
struct LaneOffsets {
  int k[KS];   // K tiles (score16): rows (lane & 7) + 8 (lane >> 4), chunk 2kk + (lane >> 3) & 1
  int v[KS];   // V tiles, transposed (pv16): rows (lane & 7) + 8 ((lane >> 3) & 1), chunk 2dp + (lane >> 4)
  __device__ explicit LaneOffsets(int lane) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      k[kk] = swz<KS>((lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1));
      v[kk] = swz<KS>((lane & 7) + ((lane >> 3) & 1) * 8, 2 * kk + (lane >> 4));
    }
  }
};

// A fragments of a 16-row tile of swizzled rows (tile: its first row).
template <int KS>
NANS_DEVICE void tile_frags(uint32_t (&f)[KS][4], const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(f[kk], tile + swz<KS>(lane & 15, 2 * kk + (lane >> 4)));
}

// Raw products of 16 A rows (fragments af) with swizzled rows j0..j0+15 of
// sB: d[u][e] pairs A row lane/4 + 8(e>>1) with B row j0 + 8u + 2(lane%4) +
// (e&1).
template <int KS>
NANS_DEVICE void dot16(float (&d)[2][4], const uint32_t (&af)[KS][4], const __nv_bfloat16* sB,
                       int j0, const LaneOffsets<KS>& off) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[u][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t bf[4];
    ldmatrix_x4(bf, sB + j0 * 16 * KS + off.k[kk]);
    mma_bf16_16816(d[0], af[kk], bf[0], bf[1]);
    mma_bf16_16816(d[1], af[kk], bf[2], bf[3]);
  }
}

// Scaled and biased scores of a warp's 16 query rows (fragments qf) against
// swizzled key rows j0..j0+15: s[u][e] is key j0 + 8u + 2(lane%4) + (e&1),
// row lane/4 + 8(e>>1), = (q . k) * scale + sKB[key] (score_tile over
// swizzled rows).
template <int KS>
NANS_DEVICE void score16(float (&s)[2][4], const uint32_t (&qf)[KS][4], const __nv_bfloat16* sK,
                         const float* sKB, int j0, const LaneOffsets<KS>& off, int lane,
                         float scale) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[u][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t kf[4];
    ldmatrix_x4(kf, sK + j0 * 16 * KS + off.k[kk]);
    mma_bf16_16816(s[0], qf[kk], kf[0], kf[1]);
    mma_bf16_16816(s[1], qf[kk], kf[2], kf[3]);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[u][e] = s[u][e] * scale + sKB[j0 + 8 * u + 2 * (lane & 3) + (e & 1)];
}

// o += P (a 16 x 16 bf16 A fragment over rows j0..j0+15) . swizzled rows
// j0..j0+15 of sV (the contraction runs over those rows, 16 KS columns out).
template <int KS>
NANS_DEVICE void pv16(float (&o)[2 * KS][4], const uint32_t (&a)[4], const __nv_bfloat16* sV,
                      int j0, const LaneOffsets<KS>& off) {
#pragma unroll
  for (int dp = 0; dp < KS; ++dp) {
    uint32_t f[4];
    ldmatrix_x4_trans(f, sV + j0 * 16 * KS + off.v[dp]);
    mma_bf16_16816(o[2 * dp], a, f[0], f[1]);
    mma_bf16_16816(o[2 * dp + 1], a, f[2], f[3]);
  }
}

// Writes a warp's 16 x 16 KS output rows (o[d][e]: row lane/4 + 8(e>>1),
// column 8d + 2(lane%4) + (e&1)) as bf16: staged in the warp's 16-row
// buffer of swizzled rows, then stored in 16-byte pieces to rows row0..
// (< S) of `out` (row stride ld).
template <int KS>
NANS_DEVICE void store_ctx(const float (&o)[2 * KS][4], __nv_bfloat16* buf, __nv_bfloat16* out,
                           size_t ld, int row0, int S, int lane) {
  constexpr int kChunks = 2 * KS;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int d = 0; d < kChunks; ++d)
      *reinterpret_cast<uint32_t*>(buf + swz<KS>((lane >> 2) + 8 * hr, d) + 2 * (lane & 3)) =
          pack_bf16(o[d][2 * hr], o[d][2 * hr + 1]);
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i - r * kChunks;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * ld + 8 * c) =
          *reinterpret_cast<const uint4*>(buf + swz<KS>(r, c));
  }
}

}  // namespace attn
