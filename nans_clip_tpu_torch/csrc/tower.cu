// The whole encoder tower in one launch: all L layers of
// encoder_layer_math for a batch of B <= 32 sequences.
//
// Replaces nans_clip_tpu/ops/tower_kernel.py::_tower_kernel (:36; bf16
// weights), ::_tower_kernel_q (:67; int8 weights with one fp32 scale per
// output channel, dequantized on chip as bf16(float(q) * scale), :89-90) and
// ::_tower_kernel_q_dma (:104; the same function with each layer's weights
// dequantized one layer ahead of its products, see "Dequantizing a layer
// ahead" below). Heads of 64 or 80 (the attention stage is a template over
// the head dim's k-steps, as attention.cuh), W up to 1024 at heads of 64 and
// up to 1280 at heads of 80 (the row stages hold 2 kRP values a thread).
// The rounding points are those of layer_kernel.py:43-113: xn, q/k/v, P,
// ctx, the attention sub-block's output a, the MLP hidden state h and each
// layer's output in bf16; LayerNorm and softmax statistics in fp32.
//
// Bound: at batch 1 the work is streaming the weights (7.08 M a layer,
// 170 MB for 12 layers in bf16, 85 MB in int8: 51 / 25 us at 3.35 TB/s);
// from batch ~8 on it is the tensor cores. The TPU kernel kept a batch tile's
// activations in VMEM and double-buffered each layer's weights through a
// sequential grid over the layers. Here blocks run in no order, so the
// kernel is persistent: a cooperative launch of at most the co-resident
// blocks, stepping through the stages of each layer with a grid-wide
// barrier between them. Activations live in device memory (mostly L2 at
// these batches), in scratch the wrapper allocates. The TPU kernel's weight
// double-buffering becomes an L2 prefetch: at the start of each layer every
// block asks L2 for a slice of the next layer's weights.
//
// Stages of one layer (pre-LN / post-LN):
//   G  qkv = bf16((xn | x) . Wqkv^T + bqkv)
//   AT ctx = attention(q, k, v)  per (sample, head, 16 queries)
//   G  sum = ctx . Wo^T + bo + x                 (fp32)
//   R  a = bf16(sum), xn = LN2(a)  |  a = bf16(LN1(sum))
//   G  h = bf16(act((xn | a) . W1^T + b1))
//   G  sum = h . W2^T + b2 + a                   (fp32)
//   R  x = bf16(sum), xn = LN1'(x) |  x = bf16(LN2(sum))
// A GEMM stage splits its work into 64x32 output tiles and, where that
// leaves blocks idle (batch 1), into K-splits too, so that every SM streams
// weights at once. A split writes its fp32 partial sums and counts itself in
// on its tile; the tile's last split adds all the partials in split order
// (deterministic, whichever split came last) and applies the epilogue. The
// products are mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed by a
// 4-stage cp.async ring of 64-wide K steps; in the int8 instance (#5) the
// weights land in their own ring and are converted to bf16 in shared memory
// before the mma, inside every K step.
//
// Dequantizing a layer ahead (#6, kMode kInt8Ahead): the TPU kernel DMA'd
// each layer's int8 blocks into a 3-deep VMEM ring and converted layer l+1
// into one of two bf16 buffers while layer l computed. Here the two bf16
// buffers are in device memory (wbuf: 2 x (4 W^2 + 2 W I) values, 14.2 MB a
// layer at W 768, 25.2 MB at W 1024), and layer l's products read buffer l %
// 2 through the bf16 GEMM path (the 4-deep ring, no conversion in the K
// loop). Layer l+1's conversion is cut into three parts, one in each of
// layer l's stages that leave blocks idle at serving batches (attention:
// B x heads x ceil(S / 16) units; the two row stages: B x S rows), done by
// the blocks past the stage's units before they arrive at the barrier, so
// the work fills their wait (every block takes a share, after its units,
// where none is idle). Spreading it over all seven stages on every block was
// measured too (profile_tower's stage clocks) and was slower at most of the
// serving shapes tried. A prologue stage converts layer 0. Buffer (l+1) % 2 was last read by layer l-1's products, and the
// barriers between them order those reads before these writes: one barrier
// stands where the TPU needed a third ring slot. The L2 prefetch moves one
// layer further ahead, to layer l+2's int8 blocks. The bf16 values and the
// mma order are those of #5, so at the same grid (the same K-splits) the
// output is #5's bit for bit.
//
// Memory ordering: every block writes its stage's results, then
// __threadfence(), then arrives at the barrier; data written by other
// blocks is read through L2 only (cp.async.cg, __ldcg), since L1 is not
// coherent across SMs. The barrier counter only grows (one fire-and-forget
// add an arrival; a block waits for its count to reach the next multiple of
// the grid), and the tile counters return to 0 after each use, so the
// wrapper hands the kernel zeroed counters and nothing else is reset.
#include "attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int BM = 64, BN = 32, BK = 64;  // GEMM output tile and K step
constexpr int LDS = BK + 8;               // padded row stride (bf16), 144 bytes
constexpr int kStages = 4;
constexpr int kPtrs = 16;                 // pointers a layer in the table
constexpr int kMaxSplits = 8;             // K-splits of one product, at most
// A barrier wait of more than ~5 s (10^10 cycles at ~2 GHz) traps: a fault
// then ends the launch with an error instead of hanging the card. No stage
// at batch <= 32 takes a millisecond.
constexpr long long kBarrierTimeout = 10000000000LL;

// The instances: bf16 weights (#4), int8 converted in each K step (#5), int8
// converted a layer ahead (#6).
enum { kBf16 = 0, kInt8 = 1, kInt8Ahead = 2 };

// The per-layer pointer table, in this order (scales are null for bf16).
enum { kLn1W, kLn1B, kWqkv, kBqkv, kWo, kBo, kLn2W, kLn2B, kW1, kB1, kW2, kB2,
       kSqkv, kSo, kS1, kS2 };

struct TowerArgs {
  bf16* x;                 // [M, W] the activations, in and out
  const float* key_bias;   // [B, S] or null
  const void* const* table;
  bf16 *xn, *a, *ctx, *qkv, *h;  // scratch: [M, W] x3, [M, 3W], [M, I]
  float* sum;              // [M, W] fp32: the residual sums before the row stages
  float* part;             // fp32 partial sums, [ks, M, N] of the current GEMM
  bf16* wbuf;              // #6: two layers' weights in bf16, or null
  unsigned* sem;           // zeroed: [0] the barrier, [1..] one counter a tile
  long long* clock;        // null, or the time after each barrier (ns)
  int B, S, W, I, L;
  float eps, scale;        // scale: 1 / sqrt(dh)
  int act, post_ln;
  int ks_qkv, ks_o, ks_1, ks_2;
};

// What a GEMM stage does with its fp32 result v (a column pair at a time):
// v + bias, then the activation (act 1 quick-GELU, 2 erf-GELU), then +
// residual; stored as bf16 (out_bf16) or fp32 (out_f32).
struct Epilogue {
  const bf16* bias;
  int act;
  const bf16* residual;
  bf16* out_bf16;
  float* out_f32;
};

NANS_DEVICE float activate(float v, int act) {
  if (act == 1) return v * (1.f / (1.f + expf(-1.702f * v)));
  if (act == 2) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  return v;
}

NANS_DEVICE float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

NANS_DEVICE float2 ldcg_bf2(const bf16* p) {
  const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

NANS_DEVICE float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

NANS_DEVICE void st_bf2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// The epilogue of kN column pairs (row[j], col[j]) with values v[j]. Every
// load (bias, residual) is issued before the first store: a store could
// alias them, so the compiler would not move a later load above it.
template <int kN>
NANS_DEVICE void epilogue(const Epilogue& ep, int M, int N, const int (&row)[kN],
                          const int (&col)[kN], float2 (&v)[kN]) {
  float2 b[kN], r[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    b[j] = ld_bf2(ep.bias + col[j]);
    r[j] = ep.residual && row[j] < M
               ? ldcg_bf2(ep.residual + static_cast<size_t>(row[j]) * N + col[j])
               : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (row[j] >= M) continue;
    const float v0 = activate(v[j].x + b[j].x, ep.act) + r[j].x;
    const float v1 = activate(v[j].y + b[j].y, ep.act) + r[j].y;
    const size_t off = static_cast<size_t>(row[j]) * N + col[j];
    if (ep.out_f32)
      *reinterpret_cast<float2*>(ep.out_f32 + off) = make_float2(v0, v1);
    else
      st_bf2(ep.out_bf16 + off, v0, v1);
  }
}

NANS_DEVICE unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

NANS_DEVICE long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// `target` is the barrier count that releases this crossing: the grid size
// times the crossings so far (the same in every thread).
NANS_DEVICE void grid_sync(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);  // result unused: a fire-and-forget reduction
    const long long start = clock64();
    while (ld_acquire(count) < target) {
      __nanosleep(20);
      if (clock64() - start > kBarrierTimeout) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Ask L2 for `bytes` from `base`, spread over every thread of the grid.
NANS_DEVICE void prefetch_l2(const void* base, size_t bytes) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads * 128;
  for (size_t off = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * 128;
       off < bytes; off += stride)
    asm volatile("prefetch.L2 [%0];\n" ::"l"(static_cast<const char*>(base) + off));
}

// ep(A[M, K] . W[N, K]^T): 64x32 tiles, each in `ks` K-splits.
template <bool kQuant>
__device__ void gemm_stage(const bf16* A, const void* Wv, const float* wscale, float* part,
                           unsigned* tile_count, const Epilogue& ep, int M, int N, int K,
                           int ks, unsigned char* smem) {
  __shared__ int s_last;
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * BM * LDS;
  int8_t* sQ8 = reinterpret_cast<int8_t*>(sB + (kQuant ? 1 : kStages) * BN * LDS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = (M + BM - 1) / BM, nt = N / BN, ksteps = K / BK;
  const int units = mt * nt * ks;
  const size_t plane = static_cast<size_t>(M) * N;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int split = u % ks, tile = u / ks;
    const int n0 = (tile % nt) * BN, m0 = (tile / nt) * BM;
    const int kb = split * ksteps / ks, ke = (split + 1) * ksteps / ks;

    auto load = [&](int slot, int kt) {
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // A: 64 rows x 8 chunks of 16 bytes
        const int c = tid + i * kThreads;
        const int r = c >> 3, kc = (c & 7) * 8, gm = m0 + r;
        cp_async16(sA + slot * BM * LDS + r * LDS + kc,
                   A + static_cast<size_t>(gm < M ? gm : M - 1) * K + k0 + kc, gm < M ? 16 : 0);
      }
      if (kQuant) {  // W: 32 rows x 4 chunks of 16 int8
        const int r = tid >> 2, kc = (tid & 3) * 16;
        cp_async16(sQ8 + slot * BN * BK + r * BK + kc,
                   static_cast<const int8_t*>(Wv) + static_cast<size_t>(n0 + r) * K + k0 + kc, 16);
      } else {  // W: 32 rows x 8 chunks of 8 bf16
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = tid + i * kThreads;
          const int r = c >> 3, kc = (c & 7) * 8;
          cp_async16(sB + slot * BN * LDS + r * LDS + kc,
                     static_cast<const bf16*>(Wv) + static_cast<size_t>(n0 + r) * K + k0 + kc,
                     16);
        }
      }
    };

    float acc[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (kb + s < ke) load(s, kb + s);
      cp_async_commit();
    }
    for (int kt = kb; kt < ke; ++kt) {
      const int i = kt - kb, slot = i % kStages;
      cp_async_wait<kStages - 2>();
      __syncthreads();  // slot is in; every warp is done with the previous step
      if (kt + kStages - 1 < ke) load((i + kStages - 1) % kStages, kt + kStages - 1);
      cp_async_commit();
      const bf16* b_s = sB + slot * BN * LDS;
      if (kQuant) {  // 32 x 64 int8 -> bf16(float(q) * scale[row]), 16 a thread
        const int r = tid >> 2, c16 = (tid & 3) * 16;
        const float sc = wscale[n0 + r];
        const uint4 raw = *reinterpret_cast<const uint4*>(sQ8 + slot * BN * BK + r * BK + c16);
        const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
        uint32_t out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          out[e] = pack_bf16(static_cast<float>(q[2 * e]) * sc,
                             static_cast<float>(q[2 * e + 1]) * sc);
        *reinterpret_cast<uint4*>(sB + r * LDS + c16) = make_uint4(out[0], out[1], out[2], out[3]);
        *reinterpret_cast<uint4*>(sB + r * LDS + c16 + 8) =
            make_uint4(out[4], out[5], out[6], out[7]);
        __syncthreads();
        b_s = sB;
      }
      const bf16* a_s = sA + slot * BM * LDS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, a_s + (warp * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
        uint32_t bfr[2][4];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int r = nj * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bfr[nj], b_s + r * LDS + kk + ((lane >> 3) & 1) * 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(acc[ni], af, bfr[ni >> 1][(ni & 1) * 2], bfr[ni >> 1][(ni & 1) * 2 + 1]);
      }
    }
    cp_async_wait<0>();

    // m16n8 accumulators: c0,c1 at (row g, cols 2q, 2q+1), c2,c3 at row g + 8.
    if (ks == 1) {
      int rows[8], cols[8];
      float2 vals[8];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rows[2 * ni + hh] = m0 + warp * 16 + (lane >> 2) + hh * 8;
          cols[2 * ni + hh] = n0 + ni * 8 + (lane & 3) * 2;
          vals[2 * ni + hh] = make_float2(acc[ni][2 * hh], acc[ni][2 * hh + 1]);
        }
      epilogue(ep, M, N, rows, cols, vals);
    } else {
      float* dst = part + split * plane;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + warp * 16 + (lane >> 2) + hh * 8;
          if (row < M)
            *reinterpret_cast<float2*>(dst + static_cast<size_t>(row) * N + n0 + ni * 8 +
                                       (lane & 3) * 2) =
                make_float2(acc[ni][2 * hh], acc[ni][2 * hh + 1]);
        }
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(tile_count + tile, 1u) == static_cast<unsigned>(ks - 1);
      __syncthreads();
      if (s_last) {  // every split of the tile is in: add them in order
        __threadfence();
        // 1024 column pairs, 8 a thread, in two rounds of 4 whose loads of
        // every split are all in flight together
#pragma unroll
        for (int round = 0; round < 2; ++round) {
          int rows[4], cols[4];
          float2 v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = tid + kThreads * (4 * round + j);
            rows[j] = m0 + e / (BN / 2);
            cols[j] = n0 + 2 * (e % (BN / 2));
            const float* src = part + static_cast<size_t>(rows[j] < M ? rows[j] : 0) * N + cols[j];
            v[j] = __ldcg(reinterpret_cast<const float2*>(src));
#pragma unroll
            for (int s = 1; s < kMaxSplits; ++s) {
              if (s < ks) {
                const float2 t = __ldcg(reinterpret_cast<const float2*>(src + s * plane));
                v[j].x += t.x;
                v[j].y += t.y;
              }
            }
          }
          epilogue(ep, M, N, rows, cols, v);
        }
        if (tid == 0) tile_count[tile] = 0u;  // ready for the next product
      }
    }
    __syncthreads();  // the next unit refills shared memory
  }
}

// ctx for each (sample, head, 16 queries) from the bf16 [M, 3W] qkv buffer
// (q heads | k heads | v heads), staged into shared memory with cp.async;
// heads of DH = 16 KS (64 or 80). At serving batches the units are few (12
// heads at batch 1), so a unit's four warps split its keys rather than its
// queries: each warp takes every fourth 16-key tile. Pass 1 gives each warp
// its rows' max and sum over its keys; they are merged in warp order; pass
// 2 gives each warp P V over its keys with P = exp(s - m) / l rounded to bf16
// (the rounding point of attention.cuh); the four partial outputs are added
// as (0 + 2) + (1 + 3).
template <int KS>
__device__ void attention_stage(const TowerArgs& p, unsigned char* smem) {
  constexpr int kWarps = kThreads / 32, DH = 16 * KS, LDK = attn::ldk<KS>();
  constexpr int kChunks = DH / 8;    // 16-byte chunks a row
  const int S = p.S, W = p.W, heads = W / DH, s_pad = (S + 15) & ~15;
  const int qtiles = (S + 15) / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;  // mma fragment row and column pair
  const size_t ld = 3 * static_cast<size_t>(W);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + 16 * LDK;
  bf16* sV = sK + s_pad * LDK;
  float* sKB = reinterpret_cast<float*>(sV + s_pad * LDK);
  float* sM = sKB + s_pad;           // [warp][16] row max over the warp's keys
  float* sL = sM + kWarps * 16;      // [warp][16] row sum
  float* sO = sL + kWarps * 16;      // [2][16][DH] partial P V, for the merge
  const float scale = p.scale;

  const int units = p.B * heads * qtiles;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int qt = u % qtiles, h = (u / qtiles) % heads, b = u / (qtiles * heads);
    const int q0 = qt * 16;
    const bf16* base = p.qkv + static_cast<size_t>(b) * S * ld + h * DH;
    // rows past S are zero-filled
    for (int c = tid; c < 16 * kChunks; c += kThreads) {
      const int r = c / kChunks, k8 = (c % kChunks) * 8, q = q0 + r;
      cp_async16(sQ + r * LDK + k8, base + static_cast<size_t>(q < S ? q : 0) * ld + k8,
                 q < S ? 16 : 0);
    }
    for (int c = tid; c < s_pad * kChunks; c += kThreads) {
      const int r = c / kChunks, k8 = (c % kChunks) * 8;
      const bf16* row = base + static_cast<size_t>(r < S ? r : 0) * ld + k8;
      cp_async16(sK + r * LDK + k8, row + W, r < S ? 16 : 0);
      cp_async16(sV + r * LDK + k8, row + 2 * W, r < S ? 16 : 0);
    }
    cp_async_commit();
    for (int j = tid; j < s_pad; j += kThreads)
      sKB[j] = j < S ? (p.key_bias ? p.key_bias[static_cast<size_t>(b) * S + j] : 0.f)
                     : -INFINITY;
    cp_async_wait<0>();
    __syncthreads();

    uint32_t qf[KS][4];
    attn::row_frags(qf, sQ, lane);

    // pass 1: this warp's keys
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j0 = 16 * warp; j0 < s_pad; j0 += 16 * kWarps) {
      float sc[2][4];
      attn::score_tile(sc, qf, sK, sKB, j0, lane, scale);
      attn::fold_row_stats(m, l, sc);
    }
    attn::merge_row_stats(m, l);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (q4 == 0) {
        sM[warp * 16 + g + 8 * hr] = m[hr];
        sL[warp * 16 + g + 8 * hr] = l[hr];
      }
    }
    __syncthreads();
    // the rows' max and sum over all keys, merged in warp order
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = g + 8 * hr;
      float mm = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sM[w * 16 + r]);
      float ll = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (sM[w * 16 + r] != -INFINITY) ll += sL[w * 16 + r] * expf(sM[w * 16 + r] - mm);
      m[hr] = mm;
      l[hr] = ll;
    }

    // pass 2: P V over this warp's keys
    float o[2 * KS][4];
#pragma unroll
    for (int d = 0; d < 2 * KS; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
    for (int j0 = 16 * warp; j0 < s_pad; j0 += 16 * kWarps) {
      float sc[2][4];
      attn::score_tile(sc, qf, sK, sKB, j0, lane, scale);
      uint32_t pa[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        pa[2 * t] = pack_bf16(expf(sc[t][0] - m[0]) / l[0], expf(sc[t][1] - m[0]) / l[0]);
        pa[2 * t + 1] = pack_bf16(expf(sc[t][2] - m[1]) / l[1], expf(sc[t][3] - m[1]) / l[1]);
      }
      attn::accumulate_rows(o, pa, sV, j0, lane);
    }
    // ctx = bf16((o0 + o2) + (o1 + o3)) through two 16 x DH fp32 buffers
    auto put = [&](float* buf) {
#pragma unroll
      for (int d = 0; d < 2 * KS; ++d)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(buf + (g + 8 * hr) * DH + d * 8 + 2 * q4) =
              make_float2(o[d][2 * hr], o[d][2 * hr + 1]);
    };
    auto add = [&](const float* buf) {
#pragma unroll
      for (int d = 0; d < 2 * KS; ++d)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 t =
              *reinterpret_cast<const float2*>(buf + (g + 8 * hr) * DH + d * 8 + 2 * q4);
          o[d][2 * hr] += t.x;
          o[d][2 * hr + 1] += t.y;
        }
    };
    if (warp >= 2) put(sO + (warp - 2) * 16 * DH);
    __syncthreads();
    if (warp < 2) add(sO + warp * 16 * DH);
    __syncthreads();
    if (warp == 1) put(sO);
    __syncthreads();
    if (warp == 0) {
      add(sO);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int q = q0 + g + 8 * hr;
        if (q >= S) continue;
        bf16* dst = p.ctx + (static_cast<size_t>(b) * S + q) * W + h * DH + 2 * q4;
#pragma unroll
        for (int d = 0; d < 2 * KS; ++d) st_bf2(dst + d * 8, o[d][2 * hr], o[d][2 * hr + 1]);
      }
    }
    __syncthreads();  // the next unit refills shared memory
  }
}

// The row stages give each row to one block: thread t holds the column
// pairs 2(t + 128 i), i < kRP (kRP 4: W <= 1024; kRP 5: W <= 1280).
NANS_DEVICE bool has_pair(int i, int W) { return 2 * (threadIdx.x + kThreads * i) < W; }
NANS_DEVICE int pair_col(int i) { return 2 * (threadIdx.x + kThreads * i); }

NANS_DEVICE float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  __syncthreads();  // red is reused by the next sum
  return t;
}

// This thread's pairs of an fp32 row written by other blocks.
template <int kRP>
NANS_DEVICE void load_row(float (&v)[2 * kRP], const float* row, int W) {
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    if (has_pair(i, W)) {
      const float2 f = __ldcg(reinterpret_cast<const float2*>(row + pair_col(i)));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// LayerNorm of one row held by the block (fp32 statistics: mean, then mean
// of squared deviations), stored as bf16.
template <int kRP>
NANS_DEVICE void ln_store(const float (&v)[2 * kRP], int W, const bf16* g, const bf16* b,
                          float eps, bf16* out_row, float* red) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kRP; ++i)
    if (has_pair(i, W)) s += v[2 * i] + v[2 * i + 1];
  const float mean = block_sum(s, red) / W;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    if (has_pair(i, W)) {
      const float d0 = v[2 * i] - mean, d1 = v[2 * i + 1] - mean;
      sq += d0 * d0 + d1 * d1;
    }
  }
  float2 gg[kRP], bb[kRP];
#pragma unroll
  for (int i = 0; i < kRP; ++i) {  // loaded before any store (see epilogue)
    if (has_pair(i, W)) {
      gg[i] = ld_bf2(g + pair_col(i));
      bb[i] = ld_bf2(b + pair_col(i));
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / W + eps);
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    if (has_pair(i, W))
      st_bf2(out_row + pair_col(i), (v[2 * i] - mean) * rstd * gg[i].x + bb[i].x,
             (v[2 * i + 1] - mean) * rstd * gg[i].y + bb[i].y);
  }
}

// Round this thread's pairs of the row to bf16, store them, and keep the
// rounded values in v.
template <int kRP>
NANS_DEVICE void round_store(float (&v)[2 * kRP], int W, bf16* out_row) {
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    if (has_pair(i, W)) {
      const __nv_bfloat162 r = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out_row + pair_col(i)) = r;
      const float2 f = __bfloat1622float2(r);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// #6: part `part` of `parts` of layer l's four int8 weights, converted to
// bf16(float(q) * scale[row]) (the values #5 forms in shared memory) into
// the layer's half of wbuf, by the blocks from `first` on. The four matrices
// are one flat range of 4 W^2 + 2 W I values (qkv [3W, W], o [W, W], fc1 [I,
// W], fc2 [W, I], each [out, in] row-major), taken 16 values (one 16-byte
// int8 load, two 16-byte stores) a thread at a time, kBatch chunks a thread
// in flight: the loads of a batch are issued before its stores.
__device__ void dequant_part(const TowerArgs& p, int l, int part, int parts, int first) {
  constexpr int kBatch = 4;
  if (static_cast<int>(blockIdx.x) < first) return;
  const size_t W = p.W, I = p.I;
  const size_t ends[4] = {3 * W * W, 4 * W * W, 4 * W * W + I * W, 4 * W * W + 2 * I * W};
  const size_t kdim[4] = {W, W, W, I};
  const void* const* t = p.table + static_cast<size_t>(l) * kPtrs;
  const int8_t* q8[4] = {static_cast<const int8_t*>(t[kWqkv]), static_cast<const int8_t*>(t[kWo]),
                         static_cast<const int8_t*>(t[kW1]), static_cast<const int8_t*>(t[kW2])};
  const float* scl[4] = {static_cast<const float*>(t[kSqkv]), static_cast<const float*>(t[kSo]),
                         static_cast<const float*>(t[kS1]), static_cast<const float*>(t[kS2])};
  const size_t chunks = ends[3] / 16;
  const size_t c0 = chunks * part / parts, c1 = chunks * (part + 1) / parts;
  const size_t stride = static_cast<size_t>(gridDim.x - first) * kThreads;
  bf16* dst = p.wbuf + (l & 1) * ends[3];
  for (size_t c = c0 + static_cast<size_t>(blockIdx.x - first) * kThreads + threadIdx.x; c < c1;
       c += kBatch * stride) {
    uint4 raw[kBatch];
    float sc[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const size_t e = (c + j * stride) * 16;
      if (e >= 16 * c1) break;
      int m = 0;
      while (e >= ends[m]) ++m;
      const size_t off = e - (m ? ends[m - 1] : 0);
      raw[j] = __ldg(reinterpret_cast<const uint4*>(q8[m] + off));
      sc[j] = __ldg(scl[m] + off / kdim[m]);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const size_t e = (c + j * stride) * 16;
      if (e >= 16 * c1) break;
      const int8_t* q = reinterpret_cast<const int8_t*>(&raw[j]);
      uint32_t out[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        out[i] = pack_bf16(static_cast<float>(q[2 * i]) * sc[j],
                           static_cast<float>(q[2 * i + 1]) * sc[j]);
      uint4* d = reinterpret_cast<uint4*>(dst + e);
      d[0] = make_uint4(out[0], out[1], out[2], out[3]);
      d[1] = make_uint4(out[4], out[5], out[6], out[7]);
    }
  }
}

// Rows of the grid, one block each.
#define FOR_ROWS(M) for (int row = blockIdx.x; row < (M); row += gridDim.x)

template <int kMode, int KS, int kRP>
__global__ void __launch_bounds__(kThreads) tower_kernel(const TowerArgs p) {
  constexpr bool kQuant = kMode == kInt8, kAhead = kMode == kInt8Ahead;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kThreads / 32];
  const int M = p.B * p.S, W = p.W, I = p.I;
  auto ptr = [&](int l, int k) { return p.table[l * kPtrs + k]; };
  auto vec = [&](int l, int k) { return static_cast<const bf16*>(ptr(l, k)); };
  auto scl = [&](int l, int k) { return static_cast<const float*>(ptr(l, k)); };
  const size_t esize = kMode == kBf16 ? sizeof(bf16) : 1;
  auto prefetch_layer = [&](int l) {
    prefetch_l2(ptr(l, kWqkv), 3 * static_cast<size_t>(W) * W * esize);
    prefetch_l2(ptr(l, kWo), static_cast<size_t>(W) * W * esize);
    prefetch_l2(ptr(l, kW1), static_cast<size_t>(I) * W * esize);
    prefetch_l2(ptr(l, kW2), static_cast<size_t>(I) * W * esize);
  };
  // #6: layer l's products read its bf16 copy in wbuf, the others the table
  const size_t layer_elems = 4 * static_cast<size_t>(W) * W + 2 * static_cast<size_t>(W) * I;
  auto weight = [&](int l, int k, size_t off) -> const void* {
    return kAhead ? static_cast<const void*>(p.wbuf + (l & 1) * layer_elems + off) : ptr(l, k);
  };
  // #6: part `part` (of 3) of layer l+1, at the end of a stage of layer l
  // with `units` units of work: on the blocks past them, or on every block
  // where none is idle
  auto ahead = [&](int l, int part, int units) {
    if (kAhead && l + 1 < p.L)
      dequant_part(p, l + 1, part, 3, units < static_cast<int>(gridDim.x) ? units : 0);
  };
  const int attn_units = p.B * (W / (16 * KS)) * ((p.S + 15) / 16);
  float v[2 * kRP];
  unsigned crossings = 0;
  int stage = 0;
  auto sync = [&]() {  // the grid barrier, and the stage clock when asked for
    grid_sync(p.sem, ++crossings * gridDim.x);
    if (p.clock && blockIdx.x == 0 && threadIdx.x == 0) p.clock[++stage] = globaltimer();
  };
  if (p.clock && blockIdx.x == 0 && threadIdx.x == 0) p.clock[0] = globaltimer();
  unsigned* tiles = p.sem + 1;
  if (kAhead) {  // the prologue: layer 0 converted whole, layer 1's int8 asked of L2
    if (p.L > 1) prefetch_layer(1);
    dequant_part(p, 0, 0, 1, 0);
  } else {
    prefetch_layer(0);
  }

  if (!p.post_ln) {  // xn = LN1(x) of layer 0
    FOR_ROWS(M) {
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        if (has_pair(i, W)) {
          const float2 f = ld_bf2(p.x + static_cast<size_t>(row) * W + pair_col(i));
          v[2 * i] = f.x;
          v[2 * i + 1] = f.y;
        }
      }
      ln_store<kRP>(v, W, vec(0, kLn1W), vec(0, kLn1B), p.eps,
                    p.xn + static_cast<size_t>(row) * W, red);
    }
  }
  if (kAhead || !p.post_ln) sync();

  const size_t ww = static_cast<size_t>(W) * W;
  for (int l = 0; l < p.L; ++l) {
    if (kAhead) {
      if (l + 2 < p.L) prefetch_layer(l + 2);
    } else if (l + 1 < p.L) {
      prefetch_layer(l + 1);
    }
    gemm_stage<kQuant>(p.post_ln ? p.x : p.xn, weight(l, kWqkv, 0), scl(l, kSqkv), p.part,
                       tiles, Epilogue{vec(l, kBqkv), 0, nullptr, p.qkv, nullptr}, M, 3 * W, W,
                       p.ks_qkv, smem);
    sync();
    attention_stage<KS>(p, smem);
    ahead(l, 0, attn_units);
    sync();
    gemm_stage<kQuant>(p.ctx, weight(l, kWo, 3 * ww), scl(l, kSo), p.part, tiles,
                       Epilogue{vec(l, kBo), 0, p.x, nullptr, p.sum}, M, W, W, p.ks_o, smem);
    sync();
    FOR_ROWS(M) {  // the attention sub-block's output a, and the MLP's LN input
      load_row<kRP>(v, p.sum + static_cast<size_t>(row) * W, W);
      bf16* a_row = p.a + static_cast<size_t>(row) * W;
      if (p.post_ln) {
        ln_store<kRP>(v, W, vec(l, kLn1W), vec(l, kLn1B), p.eps, a_row, red);
      } else {
        round_store<kRP>(v, W, a_row);
        ln_store<kRP>(v, W, vec(l, kLn2W), vec(l, kLn2B), p.eps,
                      p.xn + static_cast<size_t>(row) * W, red);
      }
    }
    ahead(l, 1, M);
    sync();
    gemm_stage<kQuant>(p.post_ln ? p.a : p.xn, weight(l, kW1, 4 * ww), scl(l, kS1), p.part,
                       tiles, Epilogue{vec(l, kB1), p.act, nullptr, p.h, nullptr}, M, I, W,
                       p.ks_1, smem);
    sync();
    gemm_stage<kQuant>(p.h, weight(l, kW2, 4 * ww + static_cast<size_t>(I) * W), scl(l, kS2),
                       p.part, tiles, Epilogue{vec(l, kB2), 0, p.a, nullptr, p.sum}, M, W, I,
                       p.ks_2, smem);
    sync();
    FOR_ROWS(M) {  // the layer's output, and the next layer's LN1 input
      load_row<kRP>(v, p.sum + static_cast<size_t>(row) * W, W);
      bf16* x_row = p.x + static_cast<size_t>(row) * W;
      if (p.post_ln) {
        ln_store<kRP>(v, W, vec(l, kLn2W), vec(l, kLn2B), p.eps, x_row, red);
      } else {
        round_store<kRP>(v, W, x_row);
        if (l + 1 < p.L)
          ln_store<kRP>(v, W, vec(l + 1, kLn1W), vec(l + 1, kLn1B), p.eps,
                        p.xn + static_cast<size_t>(row) * W, red);
      }
    }
    ahead(l, 2, M);
    if (l + 1 < p.L || p.clock) sync();
  }
}

template <int KS>
size_t attention_smem(int S) {
  const int s_pad = (S + 15) & ~15;
  return static_cast<size_t>(16 + 2 * s_pad) * attn::ldk<KS>() * sizeof(bf16) +
         static_cast<size_t>(s_pad + (kThreads / 32) * 16 * 2 + 2 * 16 * 16 * KS) *
             sizeof(float);
}

size_t tower_smem(int mode, int dh, int S) {
  const size_t attn_bytes = dh == 80 ? attention_smem<5>(S) : attention_smem<4>(S);
  const size_t gemm_bytes =
      mode == kInt8 ? (static_cast<size_t>(kStages) * BM * LDS + BN * LDS) * sizeof(bf16) +
                          static_cast<size_t>(kStages) * BN * BK
                    : static_cast<size_t>(kStages) * (BM + BN) * LDS * sizeof(bf16);
  return attn_bytes > gemm_bytes ? attn_bytes : gemm_bytes;
}

// The instance of (mode, head dim): heads of 64 with 4 column pairs a
// thread (W <= 1024) in all three modes; heads of 80 with 5 (W <= 1280) for
// #4 and #5 (#6 stops at W 1024, as the JAX kernel). Null for any other.
using TowerFn = void (*)(const TowerArgs);
TowerFn instance(int mode, int dh) {
  if (dh == 64 && mode == kBf16) return &tower_kernel<kBf16, 4, 4>;
  if (dh == 64 && mode == kInt8) return &tower_kernel<kInt8, 4, 4>;
  if (dh == 64 && mode == kInt8Ahead) return &tower_kernel<kInt8Ahead, 4, 4>;
  if (dh == 80 && mode == kBf16) return &tower_kernel<kBf16, 5, 5>;
  if (dh == 80 && mode == kInt8) return &tower_kernel<kInt8, 5, 5>;
  return nullptr;
}

cudaError_t prepare(int mode, int dh, int S, TowerFn* fn, size_t* smem) {
  *fn = instance(mode, dh);
  if (*fn == nullptr) return cudaErrorInvalidValue;
  *smem = tower_smem(mode, dh, S);
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(*fn),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// The largest grid that can be co-resident for sequence length S (blocks a
// multiprocessor at the kernel's dynamic shared memory, times the
// multiprocessors). mode: 0 bf16, 1 int8, 2 int8 converted a layer ahead;
// dh: 64 or 80. Returns a CUDA error code.
extern "C" int nans_tower_grid(int mode, int S, int dh, int* grid) {
  TowerFn fn = nullptr;
  size_t smem = 0;
  cudaError_t err = prepare(mode, dh, S, &fn, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = per_sm * sms;
  return static_cast<int>(err);
}

// x: [B*S, W] bf16, overwritten with the tower's output; key_bias: [B, S]
// fp32 or null; table: [L, 16] device pointers (see the enum above; int8
// weights [out, in] and fp32 scales [out] when mode != 0); work: bf16
// scratch of 6*B*S*W + B*S*I elements; sum: fp32 [B*S, W]; part: fp32
// scratch of max(ks * B*S * N) over the products with ks > 1 (ks <= 8);
// wbuf: bf16 scratch of 2 * (4 W^2 + 2 W I) elements when mode == 2, else
// null; sem: zeroed uint32, 1 + the most 64x32 tiles of a product; clock:
// null, or int64 room for the start and each barrier. dh: 64 or 80; scale:
// 1 / sqrt(dh). act: 1 quick-GELU, 2 erf-GELU. Shapes are checked by the
// Python wrapper. A grid larger than nans_tower_grid's is refused by the
// cooperative launch (cudaErrorCooperativeLaunchTooLarge). Returns the
// launch's error.
extern "C" int nans_tower(void* x, const void* key_bias, const void* table, void* work, void* sum,
                          void* part, void* wbuf, void* sem, void* clock, int B, int S, int W,
                          int I, int L, int dh, float eps, float scale, int act, int post_ln,
                          int mode, int ks_qkv, int ks_o, int ks_1, int ks_2, int grid,
                          void* stream) {
  TowerFn fn = nullptr;
  size_t smem = 0;
  cudaError_t err = prepare(mode, dh, S, &fn, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((mode == kInt8Ahead) != (wbuf != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t M = static_cast<size_t>(B) * S;
  bf16* w = static_cast<bf16*>(work);
  TowerArgs args{static_cast<bf16*>(x), static_cast<const float*>(key_bias),
                 static_cast<const void* const*>(table), w, w + M * W, w + 2 * M * W,
                 w + 3 * M * W, w + 6 * M * W, static_cast<float*>(sum), static_cast<float*>(part),
                 static_cast<bf16*>(wbuf), static_cast<unsigned*>(sem),
                 static_cast<long long*>(clock), B, S, W, I, L, eps, scale, act, post_ln, ks_qkv,
                 ks_o, ks_1, ks_2};
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(grid),
                                    dim3(kThreads), kargs, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
