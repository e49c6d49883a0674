// Flash attention on [B, H, S, dh] tensors with an additive fp32 key bias
// [B, S], head dim 64 or 80, and its backward:
//
//   #22: nans_clip_tpu/ops/attention.py::_fwd_kernel (body :81, pallas_call
//        :131): s = q k^T / sqrt(dh) + key_bias, m = max s, l = sum exp(s - m),
//        o = exp(s - m) v / l in the io dtype, lse = m + log l in fp32;
//   #23: ::_bwd_kernel (body :96, pallas_call :161): p = exp(s - lse),
//        dv = p^T do, dp = do v^T, delta = rowsum(do * o) from the saved o,
//        ds = p (dp - delta), dq = ds k / sqrt(dh), dk = ds^T q / sqrt(dh).
//
// The TPU kernels held a whole head's K and V (and, backward, the whole
// [S, S] score tile) in VMEM, with S padded to the 128-row query block. A
// Hopper SM has 227 KB of shared memory, so here K and V stream through
// shared memory in tiles of 64 keys with an online softmax: a running row
// max m and sum l in fp32, the output accumulator rescaled by the exponent
// of m_old - m_new when the max grows. Shared memory does not grow with S,
// so the kernels run to S = 1024, the JAX route's MAX_PALLAS_SEQ, and
// beyond. The tail keys are masked in the kernel (zero-filled rows, bias
// -inf): no tensor is padded. Every tensor is read and written through its
// strides (the last dim contiguous), so the q/k/v views of a packed QKV
// projection and an output laid out as [B, S, H, dh] need no copy.
//
// Products run on mma.sync m16n8k16 with bf16 inputs and fp32 accumulation
// (attention.cuh's fragment code, its dh-64 and dh-80 instances KS = 4, 5).
// Rounding points: the JAX kernel forms P V in fp32; mma.sync needs bf16 P,
// so the unnormalised P is rounded to bf16 before P V (as attention.cu
// does) while l sums the unrounded fp32 P. In the backward, P and dS are
// rounded to bf16 as mma inputs; delta, lse and every sum stay fp32.
//
// Forward (#22). Bound: the bytes of q, k, v and o, 0.093 ms at (256, 12,
// 197, 64), against 0.031 ms of products; after the bytes come the exp a
// score and the ldmatrix traffic of the products. Design:
// * A block takes up to 8 strips of 16 query rows of one (head, sample), a
//   warp a strip, the strips of a head spread evenly over the fewest blocks
//   (fwd_plan: 13 strips at S 197 take two blocks of 7 warps, 37 at S 577
//   five of 8), so a head's K and V stream from device memory once for
//   each 128 query rows or fewer (four and ten times before).
// * The block's Q rows come by cp.async into swizzled rows (attn::swz),
//   read once into fragments by ldmatrix; that buffer then stages the
//   warp's o rows for 16-byte stores.
// * K and V tiles of 64 keys in swizzled unpadded rows, three in flight
//   (cp.async, one block barrier a tile; a ring of one or two where S has
//   no more tiles); the last tile is scored in steps of 16 keys up to S
//   only (208 keys scored for 197, not 256).
// * The exponent is exp2 of s c - m c, c = log2(e) / sqrt(dh): without a
//   key bias the max is taken over the raw products and P is one FFMA and
//   one ex2 a score, with no bias read; with one, the scores are s c + b
//   log2(e), the bias staged times log2(e). The accumulator and l are
//   rescaled only when a row of the warp raises its max (a warp-uniform
//   test; where the max holds the factor is exp2(0) = 1, so skipping it
//   changes no bit).
// Two blocks of 8 warps share an SM (at most 128 registers a thread).
//
// Backward (#23): one block of 4 warps per (64-row tile, head, sample), each
// warp owning 16 rows as mma A fragments read straight from global memory,
// K/V (or Q/dO) streamed in padded 64-row tiles, two in flight. Two kernels
// and no atomics, so two calls give the same bits: (a) dQ, a warp's query
// rows against the streamed key tiles, after forming its rows' delta from
// do and o and storing it fp32 [B, H, S]; (b) dK and dV, a warp's key rows
// against the streamed query tiles (Q, dO and their rows' lse and delta).
// Bound: the bytes of q/k/v/o/do/dq/dk/dv at CLIP's sequences, the exp work
// and the products at S = 577-1024 (the four products plus the recomputed
// Q K^T).
#include "attention.cuh"

namespace {

using attn::ldk;
constexpr int kWarps = 4;           // the backward's blocks
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a backward block owns (gates.FLASH_BLOCK_Q)
constexpr int kTile = 64;           // rows a streamed tile (gates.FLASH_BLOCK_K)
constexpr int kFwdMaxWarps = 8;     // forward strips a block (gates.FLASH_FWD_MAX_WARPS)
constexpr int kFwdStages = 3;       // forward key tiles in flight (gates.FLASH_FWD_STAGES)
constexpr float kLog2e = 1.4426950408889634f;

// A [B, H, S, dh] bf16 tensor through its strides, in elements.
struct View {
  __nv_bfloat16* p;
  long long sb, sh, ss;
  __device__ __forceinline__ __nv_bfloat16* head(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

// Rows j0..j0+kTile of a head (row stride ss) into shared rows of ldk, as
// 16-byte cp.async chunks; rows at or past S are zero-filled.
template <int KS>
NANS_DEVICE void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, long long ss, int j0,
                            int S, int tid) {
  constexpr int kChunks = 2 * KS;
  for (int c = tid; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, k8 = (c % kChunks) * 8;
    const int j = j0 + r;
    const bool in = j < S;
    cp_async16(dst + r * ldk<KS>() + k8, src + static_cast<long long>(in ? j : 0) * ss + k8,
               in ? 16 : 0);
  }
}

// Packs a 16x16 fp32 tile pair (v[t]: 8 columns each) into a bf16 A fragment.
NANS_DEVICE void pack_a(uint32_t (&a)[4], const float (&v)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    a[2 * t] = pack_bf16(v[t][0], v[t][1]);
    a[2 * t + 1] = pack_bf16(v[t][2], v[t][3]);
  }
}

// Stores 16 rows (row0.., < S) x 16 KS columns of an accumulator times mul
// as bf16 into the head at dst (row stride ss).
template <int NT>
NANS_DEVICE void store_head_rows(__nv_bfloat16* dst, long long ss, const float (&o)[NT][4],
                                 float mul, int row0, int S, int lane) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + (lane >> 2) + 8 * hr;
    if (r >= S) continue;
    __nv_bfloat16* p = dst + r * ss + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < NT; ++d)
      *reinterpret_cast<uint32_t*>(p + d * 8) = pack_bf16(o[d][2 * hr] * mul,
                                                          o[d][2 * hr + 1] * mul);
  }
}

template <int NT>
NANS_DEVICE void zero_acc(float (&o)[NT][4]) {
#pragma unroll
  for (int d = 0; d < NT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
}

// The key tiles of one head, double-buffered: K and V rows and the key bias
// (0 where bias is null, -inf past S).
template <int KS>
struct KeyTiles {
  __nv_bfloat16* sK;  // [2][kTile][ldk]
  __nv_bfloat16* sV;  // [2][kTile][ldk]
  float* sB;          // [2][kTile]

  __device__ __forceinline__ KeyTiles(unsigned char* smem) {
    sK = reinterpret_cast<__nv_bfloat16*>(smem);
    sV = sK + 2 * kTile * ldk<KS>();
    sB = reinterpret_cast<float*>(sV + 2 * kTile * ldk<KS>());
  }
  static constexpr size_t bytes() {
    return static_cast<size_t>(4 * kTile) * ldk<KS>() * sizeof(__nv_bfloat16) +
           2 * kTile * sizeof(float);
  }
  __device__ __forceinline__ void stage(int t, const __nv_bfloat16* kh, long long kss,
                                        const __nv_bfloat16* vh, long long vss,
                                        const float* bias_b, int S, int tid) {
    const int buf = t & 1, j0 = t * kTile;
    stage_tile<KS>(sK + buf * kTile * ldk<KS>(), kh, kss, j0, S, tid);
    stage_tile<KS>(sV + buf * kTile * ldk<KS>(), vh, vss, j0, S, tid);
    cp_async_commit();
    for (int r = tid; r < kTile; r += kThreads) {
      const int j = j0 + r;
      sB[buf * kTile + r] = j < S ? (bias_b ? bias_b[j] : 0.f) : -INFINITY;
    }
  }
};

// Waits for tile t (tile t + 1 may stay in flight) and makes it visible.
NANS_DEVICE void wait_tile(bool next_in_flight) {
  if (next_in_flight)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();
}

// 2^x by the SFU (ex2.approx.ftz: relative error ~2^-22, results below
// 2^-126 flushed to zero).
NANS_DEVICE float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The forward's launch plan at (S, dh); ops/attention.py::flash_fwd_plan
// computes the same: the S / 16 strips of a head over the fewest blocks of
// at most kFwdMaxWarps warps, evened; shared memory for the blocks' Q rows
// and a ring of kFwdStages tiles of K, V and the key bias, or of as many as
// S has (the text towers' one tile), so that short sequences keep more
// blocks an SM.
struct FwdPlan {
  int warps, blocks, strips, smem;
};

FwdPlan fwd_plan(int S, int dh) {
  const int strips = (S + 15) / 16;
  const int blocks = (strips + kFwdMaxWarps - 1) / kFwdMaxWarps;
  const int warps = (strips + blocks - 1) / blocks;
  const int tiles = (S + kTile - 1) / kTile, stages = tiles < kFwdStages ? tiles : kFwdStages;
  const int smem = warps * 16 * dh * 2 + stages * (2 * kTile * dh * 2 + kTile * 4);
  return FwdPlan{warps, blocks, strips, smem};
}

// One key tile of a warp's strip. kTail: the last tile, whose 16-key steps
// stop at S (`valid` keys, the rest masked); kBias: an additive key bias,
// staged times log2(e) in cB (-inf past S), so the scores and m are in
// log2 units; without it they stay raw products (m their max, scale2 > 0
// keeps the order) and P = exp2(s * scale2 - m * scale2) is one FFMA and
// one ex2. The rescale of acc and l runs only when a row of the warp raises
// its max. P, summed into l in fp32 and rounded to bf16, times V into acc.
template <int KS, bool kBias, bool kTail>
NANS_DEVICE void fwd_tile(float (&acc)[2 * KS][4], float (&m)[2], float (&l)[2],
                          const uint32_t (&qf)[KS][4], const __nv_bfloat16* cK,
                          const __nv_bfloat16* cV, const float* cB,
                          const attn::LaneOffsets<KS>& off, int valid, int lane, float scale2) {
  const int nsub = kTail ? min(4, (valid + 15) >> 4) : 4;
  const auto live = [nsub](int u) { return !kTail || u < nsub; };
  float s[4][2][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (!live(u)) continue;
    if (kBias) {
      attn::score16<KS>(s[u], qf, cK, cB, 16 * u, off, lane, scale2);
    } else {
      attn::dot16<KS>(s[u], qf, cK, 16 * u, off);
      if (kTail) {
#pragma unroll
        for (int e = 0; e < 8; ++e)   // key 16u + 8(e / 4) + 2(lane % 4) + e % 2
          if (16 * u + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1) >= valid)
            s[u][e >> 2][e & 3] = -INFINITY;
      }
    }
  }
  float m_new[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mt = -INFINITY;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (live(u))
        mt = fmaxf(mt, fmaxf(fmaxf(s[u][0][2 * hr], s[u][0][2 * hr + 1]),
                             fmaxf(s[u][1][2 * hr], s[u][1][2 * hr + 1])));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    m_new[hr] = fmaxf(m[hr], mt);
  }
  // the exponent's offset in log2 units: 0 while a row has seen no finite
  // score (a key bias of -inf), so that exp2 gives 0 and no NaN
  const float ms = kBias ? 1.f : scale2;
  float base[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) base[hr] = m_new[hr] == -INFINITY ? 0.f : m_new[hr] * ms;
  if (__any_sync(0xffffffffu, m_new[0] > m[0] || m_new[1] > m[1])) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float alpha = exp2_approx(m[hr] * ms - base[hr]);
      l[hr] *= alpha;
#pragma unroll
      for (int d = 0; d < 2 * KS; ++d) {
        acc[d][2 * hr] *= alpha;
        acc[d][2 * hr + 1] *= alpha;
      }
    }
  }
  m[0] = m_new[0];
  m[1] = m_new[1];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (!live(u)) continue;
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = kBias ? s[u][t2][e] - base[e >> 1]
                              : fmaf(s[u][t2][e], scale2, -base[e >> 1]);
        s[u][t2][e] = exp2_approx(x);
        l[e >> 1] += s[u][t2][e];
      }
    uint32_t pa[4];
    pack_a(pa, s[u]);
    attn::pv16<KS>(acc, pa, cV, 16 * u, off);
  }
}

// #22: a block of `warps` strips of one (head, sample) (see the note at the
// top). scale2 = log2(e) / sqrt(dh); kBias: bias is not null.
template <int KS, bool kBias>
__global__ void __launch_bounds__(32 * kFwdMaxWarps, 2)
    flash_fwd_kernel(View q, View k, View v, View o, const float* __restrict__ bias,
                     float* __restrict__ lse, int S, float scale2) {
  constexpr int DH = 16 * KS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int q0 = blockIdx.x * nw * 16, row0 = q0 + warp * 16;
  const bool active = row0 < S;  // warp-uniform; every warp joins the barriers
  // the ring: ns buffers (fwd_plan); tile t takes buffer t % kFwdStages,
  // which is t itself where there are fewer tiles than kFwdStages
  const int n_tiles = (S + kTile - 1) / kTile, ns = min(kFwdStages, n_tiles);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // the block's Q rows
  __nv_bfloat16* sK = sQ + nw * 16 * DH;                         // [ns][kTile] rows
  __nv_bfloat16* sV = sK + ns * kTile * DH;
  float* sB = reinterpret_cast<float*>(sV + ns * kTile * DH);    // [ns][kTile]
  const __nv_bfloat16 *kh = k.head(b, h), *vh = v.head(b, h);
  const float* bias_b = bias ? bias + static_cast<size_t>(b) * S : nullptr;

  // K, V rows of tile t and its key bias times log2(e) (-inf past S) into
  // buffer t % kFwdStages; the caller commits the group.
  const auto stage = [&](int t) {
    const int buf = t % kFwdStages, j0 = t * kTile;
    attn::stage_async<KS>(sK + buf * kTile * DH, kh + j0 * k.ss, k.ss, kTile, S - j0, tid,
                          blockDim.x);
    attn::stage_async<KS>(sV + buf * kTile * DH, vh + j0 * v.ss, v.ss, kTile, S - j0, tid,
                          blockDim.x);
    if (kBias)
      for (int r = tid; r < kTile; r += blockDim.x) {
        const int j = j0 + r;
        sB[buf * kTile + r] = j < S ? bias_b[j] * kLog2e : -INFINITY;
      }
  };
  // groups: Q with tile 0, then tiles 1 .. kFwdStages - 2 (empty past the last)
  attn::stage_async<KS>(sQ, q.head(b, h) + q0 * q.ss, q.ss, nw * 16, S - q0, tid, blockDim.x);
  stage(0);
  cp_async_commit();
#pragma unroll
  for (int t = 1; t < kFwdStages - 1; ++t) {
    if (t < n_tiles) stage(t);
    cp_async_commit();
  }

  const attn::LaneOffsets<KS> off(lane);
  __nv_bfloat16* buf = sQ + warp * 16 * DH;   // this warp's Q rows, then its o rows
  uint32_t qf[KS][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[2 * KS][4];
  zero_acc(acc);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kFwdStages - 2>();   // tile t (and Q) landed
    __syncthreads();                   // ... for every warp; tile t - 1's buffer is free
    if (t + kFwdStages - 1 < n_tiles) stage(t + kFwdStages - 1);
    cp_async_commit();
    if (!active) continue;
    if (t == 0) attn::tile_frags<KS>(qf, buf, lane);
    const int b_t = t % kFwdStages, valid = S - t * kTile;
    const __nv_bfloat16* cK = sK + b_t * kTile * DH;
    const __nv_bfloat16* cV = sV + b_t * kTile * DH;
    const float* cB = sB + b_t * kTile;
    const bool tail = valid < kTile;   // the last tile, where S is not a multiple of 64
    if (kBias)
      tail ? fwd_tile<KS, true, true>(acc, m, l, qf, cK, cV, cB, off, valid, lane, scale2)
           : fwd_tile<KS, true, false>(acc, m, l, qf, cK, cV, cB, off, valid, lane, scale2);
    else
      tail ? fwd_tile<KS, false, true>(acc, m, l, qf, cK, cV, cB, off, valid, lane, scale2)
           : fwd_tile<KS, false, false>(acc, m, l, qf, cK, cV, cB, off, valid, lane, scale2);
  }
  cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
#pragma unroll
    for (int d = 0; d < 2 * KS; ++d) {
      acc[d][2 * hr] /= l[hr];
      acc[d][2 * hr + 1] /= l[hr];
    }
  }
  attn::store_ctx<KS>(acc, buf, o.head(b, h), static_cast<size_t>(o.ss), row0, S, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + (lane >> 2) + 8 * hr;
      if (r < S)
        lse[(static_cast<size_t>(b) * H + h) * S + r] =
            (m[hr] * (kBias ? 1.f : scale2) + log2f(l[hr])) / kLog2e;
    }
  }
}

// #23 (a): dQ of a warp's 16 query rows, after their delta = rowsum(do * o).
template <int KS>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(View q, View k, View v, View o, View dout, View dq,
                        const float* __restrict__ bias, const float* __restrict__ lse,
                        float* __restrict__ delta, int S, float scale) {
  constexpr int DH = 16 * KS;
  extern __shared__ __align__(16) unsigned char smem[];
  KeyTiles<KS> tiles(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int row0 = blockIdx.x * kRows + warp * 16;
  const bool active = row0 < S;
  const __nv_bfloat16 *kh = k.head(b, h), *vh = v.head(b, h);
  const float* bias_b = bias ? bias + static_cast<size_t>(b) * S : nullptr;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;

  uint32_t qf[KS][4], gf[KS][4];
  attn::global_frags(qf, q.head(b, h), static_cast<size_t>(q.ss), row0, S, lane);
  attn::global_frags(gf, dout.head(b, h), static_cast<size_t>(dout.ss), row0, S, lane);
  // delta of rows lane/4 and lane/4 + 8: each of the row's four lanes sums a
  // quarter of its dh columns of do * o in fp32, then the four merge.
  float lr[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + (lane >> 2) + 8 * hr;
    float sum = 0.f;
    if (r < S) {
      const int c0 = (lane & 3) * (DH / 4);
      const __nv_bfloat16* po = o.head(b, h) + r * o.ss + c0;
      const __nv_bfloat16* pg = dout.head(b, h) + r * dout.ss + c0;
#pragma unroll
      for (int c = 0; c < DH / 4; c += 2) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(po + c));
        const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pg + c));
        sum += a.x * g.x + a.y * g.y;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[hr] = sum;
    lr[hr] = r < S ? lse[stat0 + r] : 0.f;
    if (r < S && (lane & 3) == 0) delta[stat0 + r] = sum;
  }

  float acc[2 * KS][4];
  zero_acc(acc);
  const int n_tiles = (S + kTile - 1) / kTile;
  tiles.stage(0, kh, k.ss, vh, v.ss, bias_b, S, tid);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) tiles.stage(t + 1, kh, k.ss, vh, v.ss, bias_b, S, tid);
    wait_tile(t + 1 < n_tiles);
    if (active) {
      const int buf = t & 1;
      const __nv_bfloat16* cK = tiles.sK + buf * kTile * ldk<KS>();
      const __nv_bfloat16* cV = tiles.sV + buf * kTile * ldk<KS>();
      const float* cB = tiles.sB + buf * kTile;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float s[2][4], dp[2][4];
        attn::score_tile(s, qf, cK, cB, 16 * u, lane, scale);
        attn::dot_tile(dp, gf, cV, 16 * u, lane);  // do v^T
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[t2][e] = expf(s[t2][e] - lr[e >> 1]) * (dp[t2][e] - dl[e >> 1]);  // dS
        uint32_t da[4];
        pack_a(da, s);
        attn::accumulate_rows(acc, da, cK, 16 * u, lane);
      }
    }
    __syncthreads();
  }
  if (active) store_head_rows(dq.head(b, h), dq.ss, acc, scale, row0, S, lane);
}

// The query tiles of one head for the dK/dV kernel, double-buffered: Q and
// dO rows and the rows' lse (+inf past S: p = 0 there) and delta.
template <int KS>
struct QueryTiles {
  __nv_bfloat16* sQ;  // [2][kTile][ldk]
  __nv_bfloat16* sG;  // [2][kTile][ldk]
  float* sL;          // [2][kTile]
  float* sD;          // [2][kTile]

  __device__ __forceinline__ QueryTiles(unsigned char* smem) {
    sQ = reinterpret_cast<__nv_bfloat16*>(smem);
    sG = sQ + 2 * kTile * ldk<KS>();
    sL = reinterpret_cast<float*>(sG + 2 * kTile * ldk<KS>());
    sD = sL + 2 * kTile;
  }
  static constexpr size_t bytes() {
    return static_cast<size_t>(4 * kTile) * ldk<KS>() * sizeof(__nv_bfloat16) +
           4 * kTile * sizeof(float);
  }
  __device__ __forceinline__ void stage(int t, const __nv_bfloat16* qh, long long qss,
                                        const __nv_bfloat16* gh, long long gss,
                                        const float* lse_h, const float* delta_h, int S,
                                        int tid) {
    const int buf = t & 1, j0 = t * kTile;
    stage_tile<KS>(sQ + buf * kTile * ldk<KS>(), qh, qss, j0, S, tid);
    stage_tile<KS>(sG + buf * kTile * ldk<KS>(), gh, gss, j0, S, tid);
    cp_async_commit();
    for (int r = tid; r < kTile; r += kThreads) {
      const int j = j0 + r;
      sL[buf * kTile + r] = j < S ? lse_h[j] : INFINITY;
      sD[buf * kTile + r] = j < S ? delta_h[j] : 0.f;
    }
  }
};

// #23 (b): dK and dV of a warp's 16 key rows over the streamed query tiles.
template <int KS>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(View q, View k, View v, View dout, View dk, View dv,
                         const float* __restrict__ bias, const float* __restrict__ lse,
                         const float* __restrict__ delta, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  QueryTiles<KS> tiles(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int k0 = blockIdx.x * kRows + warp * 16;
  const bool active = k0 < S;
  const __nv_bfloat16 *qh = q.head(b, h), *gh = dout.head(b, h);
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;

  uint32_t kf[KS][4], vf[KS][4];
  attn::global_frags(kf, k.head(b, h), static_cast<size_t>(k.ss), k0, S, lane);
  attn::global_frags(vf, v.head(b, h), static_cast<size_t>(v.ss), k0, S, lane);
  float kb[2];  // the key bias of rows lane/4 and lane/4 + 8
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + (lane >> 2) + 8 * hr;
    kb[hr] = bias && key < S ? bias[static_cast<size_t>(b) * S + key] : 0.f;
  }

  float dk_acc[2 * KS][4], dv_acc[2 * KS][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  const int n_tiles = (S + kTile - 1) / kTile;
  tiles.stage(0, qh, q.ss, gh, dout.ss, lse + stat0, delta + stat0, S, tid);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles)
      tiles.stage(t + 1, qh, q.ss, gh, dout.ss, lse + stat0, delta + stat0, S, tid);
    wait_tile(t + 1 < n_tiles);
    if (active) {
      const int buf = t & 1;
      const __nv_bfloat16* cQ = tiles.sQ + buf * kTile * ldk<KS>();
      const __nv_bfloat16* cG = tiles.sG + buf * kTile * ldk<KS>();
      const float* cL = tiles.sL + buf * kTile;
      const float* cD = tiles.sD + buf * kTile;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float st[2][4], dpt[2][4], pt[2][4];
        attn::dot_tile(st, kf, cQ, 16 * u, lane);   // k q^T: [key][query]
        attn::dot_tile(dpt, vf, cG, 16 * u, lane);  // v do^T = dp^T
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 16 * u + 8 * t2 + 2 * (lane & 3) + (e & 1);
            const float p = expf(st[t2][e] * scale + kb[e >> 1] - cL[qi]);
            pt[t2][e] = p;
            st[t2][e] = p * (dpt[t2][e] - cD[qi]);  // dS^T
          }
        uint32_t pa[4], da[4];
        pack_a(pa, pt);
        pack_a(da, st);
        attn::accumulate_rows(dv_acc, pa, cG, 16 * u, lane);  // dV += P^T dO
        attn::accumulate_rows(dk_acc, da, cQ, 16 * u, lane);  // dK += dS^T Q
      }
    }
    __syncthreads();
  }
  if (!active) return;
  store_head_rows(dk.head(b, h), dk.ss, dk_acc, scale, k0, S, lane);
  store_head_rows(dv.head(b, h), dv.ss, dv_acc, 1.f, k0, S, lane);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

View view(const void* p, const long long* st) {
  return View{static_cast<__nv_bfloat16*>(const_cast<void*>(p)), st[0], st[1], st[2]};
}

template <int KS>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
               const long long* st, int B, int H, int S, float scale, cudaStream_t stream) {
  const FwdPlan p = fwd_plan(S, 16 * KS);
  const auto kernel = bias ? flash_fwd_kernel<KS, true> : flash_fwd_kernel<KS, false>;
  if (const int err = set_smem(kernel, p.smem)) return err;
  const dim3 grid(p.blocks, H, B);
  kernel<<<grid, 32 * p.warps, p.smem, stream>>>(
      view(q, st), view(k, st + 3), view(v, st + 6), view(o, st + 9),
      static_cast<const float*>(bias), static_cast<float*>(lse), S, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_bwd(const void* q, const void* k, const void* v, const void* bias, const void* o,
               const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
               const long long* st, int B, int H, int S, float scale, cudaStream_t stream) {
  const View vq = view(q, st), vk = view(k, st + 3), vv = view(v, st + 6), vo = view(o, st + 9),
             vg = view(dout, st + 12), vdq = view(dq, st + 15), vdk = view(dk, st + 18),
             vdv = view(dv, st + 21);
  const auto* b = static_cast<const float*>(bias);
  const auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<float*>(delta);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  if (const int err = set_smem(flash_bwd_dq_kernel<KS>, KeyTiles<KS>::bytes())) return err;
  if (const int err = set_smem(flash_bwd_dkv_kernel<KS>, QueryTiles<KS>::bytes())) return err;
  flash_bwd_dq_kernel<KS><<<grid, kThreads, KeyTiles<KS>::bytes(), stream>>>(
      vq, vk, vv, vo, vg, vdq, b, l, d, S, scale);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  flash_bwd_dkv_kernel<KS><<<grid, kThreads, QueryTiles<KS>::bytes(), stream>>>(
      vq, vk, vv, vg, vdk, vdv, b, l, d, S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// #22. q, k, v, o: [B, H, S, dh] bf16 read and written through strides;
// strides: 12 int64, (batch, head, row) for q, k, v, o, in elements (each a
// multiple of 8, the last dim contiguous, pointers 16-byte aligned); bias:
// [B, S] fp32 or null; lse: [B, H, S] fp32. dh 64 or 80 (checked by the
// Python wrapper). Returns cudaGetLastError().
extern "C" int nans_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* o, void* lse, const long long* strides, int B, int H, int S,
                              int dh, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_fwd<4>(q, k, v, bias, o, lse, strides, B, H, S, scale, s);
  if (dh == 80) return launch_fwd<5>(q, k, v, bias, o, lse, strides, B, H, S, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// #22's launch plan at (S, dh): out = {warps a block, blocks a (head,
// sample), strips of 16 query rows, shared-memory bytes}; the grid is
// (blocks, H, B). ops/attention.py::flash_fwd_plan computes the same.
extern "C" int nans_flash_fwd_plan(int S, int dh, int* out) {
  const FwdPlan p = fwd_plan(S, dh);
  out[0] = p.warps;
  out[1] = p.blocks;
  out[2] = p.strips;
  out[3] = p.smem;
  return 0;
}

// #23. q, k, v, bias, lse as nans_flash_fwd; o: its output; dout: the
// gradient of o; dq, dk, dv: outputs; strides: 24 int64, (batch, head, row)
// for q, k, v, o, dout, dq, dk, dv; delta: [B, H, S] fp32 scratch (written
// by the dQ kernel, read by the dK/dV kernel). Two launches; returns
// cudaGetLastError() after each.
extern "C" int nans_flash_bwd(const void* q, const void* k, const void* v, const void* bias,
                              const void* o, const void* dout, const void* lse, void* delta,
                              void* dq, void* dk, void* dv, const long long* strides, int B,
                              int H, int S, int dh, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch_bwd<4>(q, k, v, bias, o, dout, lse, delta, dq, dk, dv, strides, B, H, S, scale,
                         s);
  if (dh == 80)
    return launch_bwd<5>(q, k, v, bias, o, dout, lse, delta, dq, dk, dv, strides, B, H, S, scale,
                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}
