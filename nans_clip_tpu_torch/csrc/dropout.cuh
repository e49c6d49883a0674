// Counter-based dropout keep bits for the hand-written kernels.
//
// Replaces the TPU's in-kernel PRNG (pltpu.prng_seed / prng_random_bits in
// nans_clip_tpu/ops/fused_block.py::_keep_mask, re-seeded per sample so that
// the backward kernels redraw the forward's masks). Here each keep bit is a
// pure function of its indices: Philox4x32-10 keyed by (seed, stream) with
// the counter (sample0 + sample, head, row, col); word 0 of the output is
// compared with rate * 2^32 (kept where bits >= threshold, _keep_mask's
// rule). sample0 is the global index of the launch's first sample: a
// data-parallel rank that holds rows sample0.. of a microbatch draws the
// masks one process draws over the whole microbatch. A
// forward and a backward kernel that name the same element draw the same
// bit, and nothing is stored between them. stream 0: attention
// probabilities; stream 1: the hidden (projection) dropout; head is 0 for
// the hidden mask. ops/dropout.py computes the same bits in torch integer
// ops (the plain twin).
#pragma once

#include <stdint.h>

namespace drop {

struct Spec {
  uint32_t seed, stream, threshold;  // threshold = round(rate * 2^32), capped
  float scale;                       // 1 / (1 - rate)
  int on;                            // 0: no dropout (rate 0)
  int sample0;                       // global index of the launch's sample 0
};

static __device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1, uint32_t c2,
                                                        uint32_t c3, uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

// Whether one element is kept (the spec on).
static __device__ __forceinline__ bool kept(const Spec& d, int sample, int head, int row,
                                            int col) {
  return philox_word0(static_cast<uint32_t>(d.sample0 + sample), static_cast<uint32_t>(head),
                      static_cast<uint32_t>(row), static_cast<uint32_t>(col), d.seed,
                      d.stream) >= d.threshold;
}

// The keep multiplier of one element: scale where kept, 0 where dropped,
// 1 when the spec is off.
static __device__ __forceinline__ float mult(const Spec& d, int sample, int head, int row,
                                             int col) {
  if (!d.on) return 1.f;
  return kept(d, sample, head, row, col) ? d.scale : 0.f;
}

}  // namespace drop
