// The attention core shared by attention.cu and tower.cu: one warp's 16
// query rows of one (sample, head) against all of that head's keys, with K,
// V and the key bias already staged in shared memory.
//
// The head dim is a template parameter through the number of 16-wide k-steps
// KS that the fragment arrays carry (dh = 16 KS): KS = 4 is dh 64 (every
// ViT-B/L and RoBERTa tower), KS = 5 is dh 80 (ViT-H: five k-steps of 16 and
// ten n-tiles of 8); attention.cu, flash.cu and tower.cu instance both. Shared rows are
// dh + 8 bf16 apart (attn::ldk): 144 bytes at dh 64, 176 at dh 80, both
// 16-byte multiples that keep ldmatrix's eight row addresses on distinct
// banks.
//
// fp32 scores, fp32 softmax statistics, a max-subtracted exp and a row-sum
// divide; P is rounded to bf16 before the PV product and ctx is stored as
// bf16 (the rounding points of nans_clip_tpu/ops/fused_block.py:164-182 and
// layer_kernel.py:68-86). Two passes over the keys with mma.sync: the first
// finds the row max and sum, the second recomputes the scores, normalises P
// exactly as the TPU kernel did (p = exp(s - m) / l, then the bf16 cast) and
// accumulates P V. Recomputing Q K^T once costs less than holding S scores a
// row in registers. With a dropout spec on, P is multiplied by its keep
// multiplier (dropout.cuh, counter (sample, head, query, key)) in fp32
// before the bf16 cast (fused_block.py:146-149).
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

// Raw products of 16 A rows (fragments af, loaded as attend_rows' callers
// load Q) with rows j0..j0+15 of sB (row stride ldk): d[t][e] pairs A row
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

// qf: this warp's 16 query rows as A fragments (row_frags or global_frags);
// sK, sV: s_pad keys (row stride ldk); sKB: s_pad biases (-inf past the
// sequence). Writes query rows row0.. (< S) of ctx, where `out` points at
// the head's column in ctx row 0 of the sample and `width` is ctx's row
// stride. `drop` (with the sample and head of the rows) is the
// attention-probability dropout, compiled in only with kDrop.
template <bool kDrop, int KS>
NANS_DEVICE void attend_rows(const uint32_t (&qf)[KS][4], const __nv_bfloat16* sK,
                             const __nv_bfloat16* sV, const float* sKB, int s_pad, int lane,
                             float scale, __nv_bfloat16* out, int width, int row0, int S,
                             const drop::Spec& drop, int sample, int head) {
  // Pass 1: row max m and row sum l = sum exp(s - m), per lane, then merged
  // across the four lanes that share a row.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < s_pad; j0 += 16) {
    float s[2][4];
    score_tile(s, qf, sK, sKB, j0, lane, scale);
    fold_row_stats(m, l, s);
  }
  merge_row_stats(m, l);

  // Pass 2: P = exp(s - m) / l rounded to bf16, O += P V.
  float o[2 * KS][4];
#pragma unroll
  for (int d = 0; d < 2 * KS; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  for (int j0 = 0; j0 < s_pad; j0 += 16) {
    float s[2][4];
    score_tile(s, qf, sK, sKB, j0, lane, scale);
    uint32_t pa[4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[t][e] - m[e >> 1]) / l[e >> 1];
        if (kDrop)
          p[e] *= drop::mult(drop, sample, head, row0 + (lane >> 2) + 8 * (e >> 1),
                             j0 + 8 * t + 2 * (lane & 3) + (e & 1));
      }
      pa[2 * t] = pack_bf16(p[0], p[1]);
      pa[2 * t + 1] = pack_bf16(p[2], p[3]);
    }
    accumulate_rows(o, pa, sV, j0, lane);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = row0 + (lane >> 2) + 8 * hr;
    if (q >= S) continue;
    __nv_bfloat16* dst = out + static_cast<size_t>(q) * width + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < 2 * KS; ++d)
      *reinterpret_cast<uint32_t*>(dst + d * 8) = pack_bf16(o[d][2 * hr], o[d][2 * hr + 1]);
  }
}

}  // namespace attn
