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
//   (plan: 13 strips at S 197 take two blocks of 7 warps, 37 at S 577
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
// Backward (#23), two kernels and no atomics, so two calls give the same
// bits: (a) dQ, a warp's query rows against the streamed key tiles, after
// forming its rows' delta from do and o and storing it fp32 [B, H, S]; (b)
// dK and dV, a warp's key rows against the streamed query tiles (Q, dO and
// their rows' lse and delta). Every output is summed inside one warp in one
// fixed order. Bound: the products at S = 577-1024 (Q K^T and dO V^T in each
// kernel, dS K, P^T dO and dS^T Q: 10 B H S^2 dh flops counted once, 14 run),
// the bytes at CLIP's short sequences. The forward's design carries over:
// * A block takes up to 8 strips of 16 rows of one (head, sample), a warp a
//   strip, spread evenly over the fewest blocks as the forward's (plan), so
//   the streamed operand (K and V in (a), Q and dO in (b)) crosses device
//   memory once for each 128 rows or fewer, not each 64.
// * The block's own rows (Q and dO in (a), K and V in (b)) come by cp.async
//   into swizzled rows, read once into fragments by ldmatrix; the same
//   buffers stage the outputs for 16-byte stores.
// * The streamed tiles of 64 rows in swizzled unpadded rows, three in
//   flight (a ring only as deep as S has tiles); the last tile is scored in
//   16-row steps up to S only.
// * P = exp2(s c + b log2(e) - lse log2(e)), c = log2(e) / sqrt(dh): one
//   FFMA and one ex2 a score; the key bias is staged (or held, in (b)) times
//   log2(e), and (b) stages each query row's lse in log2 units once (+inf
//   past S, so P is 0 there) beside its delta.
// Kernel (a) holds 2 x KS fragments and 2 KS accumulator tiles a thread (two
// blocks of 8 warps an SM); (b) 2 x KS fragments and 4 KS tiles: at dh 80
// one block an SM, at dh 64 two capped at 128 registers for short sequences
// and one uncapped from 8 tiles on (kDkvOneBlockTiles).
#include "attention.cuh"

namespace {

constexpr int kTile = 64;       // rows a streamed tile (gates.FLASH_BLOCK_K)
constexpr int kMaxWarps = 8;    // strips a block (gates.FLASH_MAX_WARPS)
constexpr int kStages = 3;      // streamed tiles in flight (gates.FLASH_STAGES)
constexpr float kLog2e = 1.4426950408889634f;
// From this many streamed tiles on (S > 448), the dK/dV kernel at dh 64
// takes one block an SM with no register cap instead of two capped at 128
// (which spill): with both instances timed in turns on the card, the one
// block was the faster at S 577 (10 tiles) and the slower at S 197 (4),
// where a block's ramp is a larger share and a second block hides it. At
// dh 80 it always takes one block.
constexpr int kDkvOneBlockTiles = 8;

// A [B, H, S, dh] bf16 tensor through its strides, in elements.
struct View {
  __nv_bfloat16* p;
  long long sb, sh, ss;
  __device__ __forceinline__ __nv_bfloat16* head(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

// Packs a 16x16 fp32 tile pair (v[t]: 8 columns each) into a bf16 A fragment.
NANS_DEVICE void pack_a(uint32_t (&a)[4], const float (&v)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    a[2 * t] = pack_bf16(v[t][0], v[t][1]);
    a[2 * t + 1] = pack_bf16(v[t][2], v[t][3]);
  }
}

template <int NT>
NANS_DEVICE void zero_acc(float (&o)[NT][4]) {
#pragma unroll
  for (int d = 0; d < NT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
}

template <int NT>
NANS_DEVICE void scale_acc(float (&o)[NT][4], float mul) {
#pragma unroll
  for (int d = 0; d < NT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] *= mul;
}

// 2^x by the SFU (ex2.approx.ftz: relative error ~2^-22, results below
// 2^-126 flushed to zero).
NANS_DEVICE float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The launch plans at (S, dh); ops/attention.py::flash_fwd_plan and
// ::flash_bwd_plan compute the same: the S / 16 strips of a head over the
// fewest blocks of at most kMaxWarps warps, evened; shared memory for the
// block's own rows (Q; Q and dO in the dQ kernel; K and V in the dK/dV
// kernel) and a ring of kStages streamed tiles (K, V and the key bias; Q,
// dO and their rows' lse and delta), or of as many as S has (the text
// towers' one tile), so that short sequences keep more blocks an SM.
struct Plan {
  int warps, blocks, strips, smem, smem_dq, smem_dkv, dkv_blocks;
};

Plan plan(int S, int dh) {
  const int strips = (S + 15) / 16;
  const int blocks = (strips + kMaxWarps - 1) / kMaxWarps;
  const int warps = (strips + blocks - 1) / blocks;
  const int tiles = (S + kTile - 1) / kTile, stages = tiles < kStages ? tiles : kStages;
  const int own = warps * 16 * dh * 2, ring = stages * 2 * kTile * dh * 2;
  return Plan{warps, blocks, strips, own + ring + stages * kTile * 4,
              2 * own + ring + stages * kTile * 4, 2 * own + ring + stages * 2 * kTile * 4,
              dh == 64 && tiles < kDkvOneBlockTiles ? 2 : 1};
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
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
    flash_fwd_kernel(View q, View k, View v, View o, const float* __restrict__ bias,
                     float* __restrict__ lse, int S, float scale2) {
  constexpr int DH = 16 * KS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int q0 = blockIdx.x * nw * 16, row0 = q0 + warp * 16;
  const bool active = row0 < S;  // warp-uniform; every warp joins the barriers
  // the ring: ns buffers (plan); tile t takes buffer t % kStages,
  // which is t itself where there are fewer tiles than kStages
  const int n_tiles = (S + kTile - 1) / kTile, ns = min(kStages, n_tiles);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // the block's Q rows
  __nv_bfloat16* sK = sQ + nw * 16 * DH;                         // [ns][kTile] rows
  __nv_bfloat16* sV = sK + ns * kTile * DH;
  float* sB = reinterpret_cast<float*>(sV + ns * kTile * DH);    // [ns][kTile]
  const __nv_bfloat16 *kh = k.head(b, h), *vh = v.head(b, h);
  const float* bias_b = bias ? bias + static_cast<size_t>(b) * S : nullptr;

  // K, V rows of tile t and its key bias times log2(e) (-inf past S) into
  // buffer t % kStages; the caller commits the group.
  const auto stage = [&](int t) {
    const int buf = t % kStages, j0 = t * kTile;
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
  // groups: Q with tile 0, then tiles 1 .. kStages - 2 (empty past the last)
  attn::stage_async<KS>(sQ, q.head(b, h) + q0 * q.ss, q.ss, nw * 16, S - q0, tid, blockDim.x);
  stage(0);
  cp_async_commit();
#pragma unroll
  for (int t = 1; t < kStages - 1; ++t) {
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
    cp_async_wait<kStages - 2>();   // tile t (and Q) landed
    __syncthreads();                   // ... for every warp; tile t - 1's buffer is free
    if (t + kStages - 1 < n_tiles) stage(t + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    if (t == 0) attn::tile_frags<KS>(qf, buf, lane);
    const int b_t = t % kStages, valid = S - t * kTile;
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

// One key tile of a dQ warp's strip: s = q . k and dp = do . v over the
// tile's keys in 16-key steps (kTail: up to `valid` only, the rest of the
// last step masked), P = exp2(s c + b - lse2) with the key bias b staged
// times log2(e) in cB (-inf past S) when kBias, dS = P (dP - delta), acc +=
// dS K. lr: the rows' lse times log2(e); dl: their delta.
template <int KS, bool kBias, bool kTail>
NANS_DEVICE void dq_tile(float (&acc)[2 * KS][4], const uint32_t (&qf)[KS][4],
                         const uint32_t (&gf)[KS][4], const __nv_bfloat16* cK,
                         const __nv_bfloat16* cV, const float* cB, const float (&lr)[2],
                         const float (&dl)[2], const attn::LaneOffsets<KS>& off, int valid,
                         int lane, float scale2) {
  const int nsub = kTail ? min(4, (valid + 15) >> 4) : 4;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (kTail && u >= nsub) break;
    float s[2][4], dp[2][4];
    attn::dot16<KS>(s, qf, cK, 16 * u, off);
    attn::dot16<KS>(dp, gf, cV, 16 * u, off);   // do v^T
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // key 16u + 8 t2 + 2(lane % 4) + e % 2
        const int key = 16 * u + 8 * t2 + 2 * (lane & 3) + (e & 1);
        float p = exp2_approx(fmaf(s[t2][e], scale2, kBias ? cB[key] - lr[e >> 1]
                                                           : -lr[e >> 1]));
        if (kTail && !kBias && key >= valid) p = 0.f;   // zero rows past S
        s[t2][e] = p * (dp[t2][e] - dl[e >> 1]);       // dS
      }
    uint32_t da[4];
    pack_a(da, s);
    attn::pv16<KS>(acc, da, cK, 16 * u, off);   // dQ += dS K
  }
}

// #23 (a): dQ of a block of `warps` query strips of one (head, sample),
// after their rows' delta = rowsum(do * o). scale2 = log2(e) / sqrt(dh);
// kBias: bias is not null.
template <int KS, bool kBias>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
    flash_bwd_dq_kernel(View q, View k, View v, View o, View dout, View dq,
                        const float* __restrict__ bias, const float* __restrict__ lse,
                        float* __restrict__ delta, int S, float scale, float scale2) {
  constexpr int DH = 16 * KS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int q0 = blockIdx.x * nw * 16, row0 = q0 + warp * 16;
  const bool active = row0 < S;  // warp-uniform; every warp joins the barriers
  const int n_tiles = (S + kTile - 1) / kTile, ns = min(kStages, n_tiles);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // the block's Q rows
  __nv_bfloat16* sG = sQ + nw * 16 * DH;                         // ... and dO rows
  __nv_bfloat16* sK = sG + nw * 16 * DH;                         // [ns][kTile] rows
  __nv_bfloat16* sV = sK + ns * kTile * DH;
  float* sB = reinterpret_cast<float*>(sV + ns * kTile * DH);    // [ns][kTile]
  const __nv_bfloat16 *kh = k.head(b, h), *vh = v.head(b, h);
  const float* bias_b = bias ? bias + static_cast<size_t>(b) * S : nullptr;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * S;

  // K, V rows of tile t and its key bias times log2(e) (-inf past S) into
  // buffer t % kStages; the caller commits the group.
  const auto stage = [&](int t) {
    const int buf = t % kStages, j0 = t * kTile;
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
  // groups: Q and dO with tile 0, then tiles 1 .. kStages - 2 (empty past the last)
  attn::stage_async<KS>(sQ, q.head(b, h) + q0 * q.ss, q.ss, nw * 16, S - q0, tid, blockDim.x);
  attn::stage_async<KS>(sG, dout.head(b, h) + q0 * dout.ss, dout.ss, nw * 16, S - q0, tid,
                        blockDim.x);
  stage(0);
  cp_async_commit();
#pragma unroll
  for (int t = 1; t < kStages - 1; ++t) {
    if (t < n_tiles) stage(t);
    cp_async_commit();
  }

  // delta of rows lane/4 and lane/4 + 8 (each of the row's four lanes sums
  // a quarter of its dh columns of do * o in fp32, then the four merge), and
  // their lse in log2 units; 0 past S
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
    lr[hr] = r < S ? lse[stat0 + r] * kLog2e : 0.f;
    if (r < S && (lane & 3) == 0) delta[stat0 + r] = sum;
  }

  const attn::LaneOffsets<KS> off(lane);
  uint32_t qf[KS][4], gf[KS][4];
  float acc[2 * KS][4];
  zero_acc(acc);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t (and the own rows) landed
    __syncthreads();                // ... for every warp; tile t - 1's buffer is free
    if (t + kStages - 1 < n_tiles) stage(t + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    if (t == 0) {
      attn::tile_frags<KS>(qf, sQ + warp * 16 * DH, lane);
      attn::tile_frags<KS>(gf, sG + warp * 16 * DH, lane);
    }
    const int b_t = t % kStages, valid = S - t * kTile;
    const __nv_bfloat16* cK = sK + b_t * kTile * DH;
    const __nv_bfloat16* cV = sV + b_t * kTile * DH;
    const float* cB = sB + b_t * kTile;
    if (valid < kTile)   // the last tile, where S is not a multiple of 64
      dq_tile<KS, kBias, true>(acc, qf, gf, cK, cV, cB, lr, dl, off, valid, lane, scale2);
    else
      dq_tile<KS, kBias, false>(acc, qf, gf, cK, cV, cB, lr, dl, off, valid, lane, scale2);
  }
  cp_async_wait<0>();
  if (!active) return;
  scale_acc(acc, scale);
  attn::store_ctx<KS>(acc, sQ + warp * 16 * DH, dq.head(b, h), static_cast<size_t>(dq.ss), row0,
                      S, lane);
}

// One query tile of a dK/dV warp's strip: st = k . q and dpt = v . do over
// the tile's queries in 16-query steps (kTail: up to `valid`), P^T =
// exp2(st c + b - lse2) with this warp's key bias kb (times log2(e)) and the
// queries' lse2 from cL (+inf past S: P = 0 there), dS^T = P^T (dP^T -
// delta) with delta from cD; dv += P^T dO, dk += dS^T Q.
template <int KS, bool kTail>
NANS_DEVICE void dkv_tile(float (&dk)[2 * KS][4], float (&dv)[2 * KS][4],
                          const uint32_t (&kf)[KS][4], const uint32_t (&vf)[KS][4],
                          const __nv_bfloat16* cQ, const __nv_bfloat16* cG, const float* cL,
                          const float* cD, const float (&kb)[2], const attn::LaneOffsets<KS>& off,
                          int valid, int lane, float scale2) {
  const int nsub = kTail ? min(4, (valid + 15) >> 4) : 4;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (kTail && u >= nsub) break;
    float st[2][4], dpt[2][4], pt[2][4];
    attn::dot16<KS>(st, kf, cQ, 16 * u, off);    // k q^T: [key][query]
    attn::dot16<KS>(dpt, vf, cG, 16 * u, off);   // v do^T = dp^T
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2) {
      const int qi = 16 * u + 8 * t2 + 2 * (lane & 3);   // + e % 2
      const float2 l2 = *reinterpret_cast<const float2*>(cL + qi);
      const float2 d2 = *reinterpret_cast<const float2*>(cD + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(st[t2][e], scale2, kb[e >> 1] - (e & 1 ? l2.y : l2.x)));
        pt[t2][e] = p;
        st[t2][e] = p * (dpt[t2][e] - (e & 1 ? d2.y : d2.x));   // dS^T
      }
    }
    uint32_t pa[4], da[4];
    pack_a(pa, pt);
    pack_a(da, st);
    attn::pv16<KS>(dv, pa, cG, 16 * u, off);   // dV += P^T dO
    attn::pv16<KS>(dk, da, cQ, 16 * u, off);   // dK += dS^T Q
  }
}

// #23 (b): dK and dV of a block of `warps` key strips of one (head, sample)
// over the streamed query tiles; kMinBlocks: the blocks an SM it is compiled
// for (the plan's dkv_blocks).
template <int KS, int kMinBlocks>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
    flash_bwd_dkv_kernel(View q, View k, View v, View dout, View dk, View dv,
                         const float* __restrict__ bias, const float* __restrict__ lse,
                         const float* __restrict__ delta, int S, float scale, float scale2) {
  constexpr int DH = 16 * KS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int k0 = blockIdx.x * nw * 16, row0 = k0 + warp * 16;
  const bool active = row0 < S;
  const int n_tiles = (S + kTile - 1) / kTile, ns = min(kStages, n_tiles);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);   // the block's K rows
  __nv_bfloat16* sV = sK + nw * 16 * DH;                         // ... and V rows
  __nv_bfloat16* sQ = sV + nw * 16 * DH;                         // [ns][kTile] rows
  __nv_bfloat16* sG = sQ + ns * kTile * DH;
  float* sL = reinterpret_cast<float*>(sG + ns * kTile * DH);    // [ns][kTile] lse2
  float* sD = sL + ns * kTile;                                    // [ns][kTile] delta
  const __nv_bfloat16 *qh = q.head(b, h), *gh = dout.head(b, h);
  const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * S;

  const auto stage = [&](int t) {
    const int buf = t % kStages, j0 = t * kTile;
    attn::stage_async<KS>(sQ + buf * kTile * DH, qh + j0 * q.ss, q.ss, kTile, S - j0, tid,
                          blockDim.x);
    attn::stage_async<KS>(sG + buf * kTile * DH, gh + j0 * dout.ss, dout.ss, kTile, S - j0, tid,
                          blockDim.x);
    for (int r = tid; r < kTile; r += blockDim.x) {
      const int j = j0 + r;
      sL[buf * kTile + r] = j < S ? lse_h[j] * kLog2e : INFINITY;
      sD[buf * kTile + r] = j < S ? delta_h[j] : 0.f;
    }
  };
  attn::stage_async<KS>(sK, k.head(b, h) + k0 * k.ss, k.ss, nw * 16, S - k0, tid, blockDim.x);
  attn::stage_async<KS>(sV, v.head(b, h) + k0 * v.ss, v.ss, nw * 16, S - k0, tid, blockDim.x);
  stage(0);
  cp_async_commit();
#pragma unroll
  for (int t = 1; t < kStages - 1; ++t) {
    if (t < n_tiles) stage(t);
    cp_async_commit();
  }
  float kb[2];   // the key bias of rows lane/4 and lane/4 + 8, times log2(e)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = row0 + (lane >> 2) + 8 * hr;
    kb[hr] = bias && key < S ? bias[static_cast<size_t>(b) * S + key] * kLog2e : 0.f;
  }

  const attn::LaneOffsets<KS> off(lane);
  uint32_t kf[KS][4], vf[KS][4];
  float dk_acc[2 * KS][4], dv_acc[2 * KS][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) stage(t + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    if (t == 0) {
      attn::tile_frags<KS>(kf, sK + warp * 16 * DH, lane);
      attn::tile_frags<KS>(vf, sV + warp * 16 * DH, lane);
    }
    const int b_t = t % kStages, valid = S - t * kTile;
    const __nv_bfloat16* cQ = sQ + b_t * kTile * DH;
    const __nv_bfloat16* cG = sG + b_t * kTile * DH;
    const float* cL = sL + b_t * kTile;
    const float* cD = sD + b_t * kTile;
    if (valid < kTile)
      dkv_tile<KS, true>(dk_acc, dv_acc, kf, vf, cQ, cG, cL, cD, kb, off, valid, lane, scale2);
    else
      dkv_tile<KS, false>(dk_acc, dv_acc, kf, vf, cQ, cG, cL, cD, kb, off, valid, lane, scale2);
  }
  cp_async_wait<0>();
  if (!active) return;
  scale_acc(dk_acc, scale);
  attn::store_ctx<KS>(dk_acc, sK + warp * 16 * DH, dk.head(b, h), static_cast<size_t>(dk.ss),
                      row0, S, lane);
  attn::store_ctx<KS>(dv_acc, sV + warp * 16 * DH, dv.head(b, h), static_cast<size_t>(dv.ss),
                      row0, S, lane);
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
  const Plan p = plan(S, 16 * KS);
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
  const Plan p = plan(S, 16 * KS);
  const dim3 grid(p.blocks, H, B);
  const auto dq_kernel = bias ? flash_bwd_dq_kernel<KS, true> : flash_bwd_dq_kernel<KS, false>;
  auto dkv_kernel = flash_bwd_dkv_kernel<KS, 1>;
  if constexpr (KS == 4)
    if (p.dkv_blocks == 2) dkv_kernel = flash_bwd_dkv_kernel<KS, 2>;
  if (const int err = set_smem(dq_kernel, p.smem_dq)) return err;
  if (const int err = set_smem(dkv_kernel, p.smem_dkv)) return err;
  dq_kernel<<<grid, 32 * p.warps, p.smem_dq, stream>>>(vq, vk, vv, vo, vg, vdq, b, l, d, S,
                                                       scale, scale * kLog2e);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  dkv_kernel<<<grid, 32 * p.warps, p.smem_dkv, stream>>>(
      vq, vk, vv, vg, vdk, vdv, b, l, d, S, scale, scale * kLog2e);
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
  const Plan p = plan(S, dh);
  out[0] = p.warps;
  out[1] = p.blocks;
  out[2] = p.strips;
  out[3] = p.smem;
  return 0;
}

// #23's launch plan at (S, dh): out = {warps a block, blocks a (head,
// sample), strips of 16 rows, the dQ kernel's shared-memory bytes, the dK/dV
// kernel's, the dK/dV kernel's blocks an SM}; both grids are (blocks, H,
// B). ops/attention.py::flash_bwd_plan computes the same.
extern "C" int nans_flash_bwd_plan(int S, int dh, int* out) {
  const Plan p = plan(S, dh);
  out[0] = p.warps;
  out[1] = p.blocks;
  out[2] = p.strips;
  out[3] = p.smem_dq;
  out[4] = p.smem_dkv;
  out[5] = p.dkv_blocks;
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
