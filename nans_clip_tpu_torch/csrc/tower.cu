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
//   G  sum = ctx . Wo^T + bo + x                 (fp32; K-split: partials)
//   R  a = bf16(sum), xn = LN2(a)  |  a = bf16(LN1(sum))
//   G  h = bf16(act((xn | a) . W1^T + b1))
//   G  sum = h . W2^T + b2 + a                   (fp32; K-split: partials)
//   R  x = bf16(sum), xn = LN1'(x) |  x = bf16(LN2(sum))
// (where out or fc2 runs in K-splits, the R stage after it forms sum from
// the partial sums, the bias and the residual)
// A GEMM stage is weight-streaming at serving batches (M = B S up to a few
// hundred rows against N x K weights), so it runs "swapped": W is wgmma's
// 64-row A operand (64 output channels x 16 k, K-major, from shared memory)
// and the activations its B operand (64 tokens x 16 k a wgmma m64n64k16,
// K-major). A unit is 64 output channels x a range of at most 128 tokens
// (M cut into the fewest even ranges; up to 2 accumulator chunks of 64
// tokens, 64 fp32 a thread: with 4, 128 fp32, the kernel spilled) x one
// K-split, so each weight byte crosses L2 once for each token range (twice
// at ViT-B's M 197 on the plan's one-chunk ranges, three times at ViT-H's
// 257) and the activations once for each 64 channels. The operands come by
// TMA (128-byte swizzle; rows
// past M zero-filled by the map) into a ring of 64-deep stages under
// mbarriers, one thread keeping the next stages in flight while the
// warpgroup multiplies; in the int8 instance (#5) the int8 W box lands
// unswizzled and the warpgroup converts it into a swizzled bf16 tile,
// bf16(float(q) * scale[n]), before a proxy fence and the wgmma. The
// epilogue stages the transposed accumulators (channels x tokens) in shared
// memory as [token][channel] fp32, so that bias, activation, residual and
// the bf16 / fp32 stores run along rows in 16-byte pieces. The units are
// (channel tile, token range) x K-splits, as many splits as fill the grid
// once (tower_plan), so the splits of a tile run at once on distinct blocks.
// The splits of qkv and fc1 (bf16 out) hand over in the stage: splits 1..
// write their fp32 partial sums and count themselves in on the tile, and
// split 0 waits for the count, adds their partials to its own in split
// order and applies the epilogue. Those of out and fc2 (fp32 out, epilogue
// + bias + residual) all write partial sums, and the row stage after the
// grid barrier adds them in split order with the epilogue's arithmetic:
// no split waits. Both orders are fixed, so two calls give the same bits.
// Each output's sum runs over its split's K in k16 steps in order.
//
// Dequantizing a layer ahead (#6, kMode kInt8Ahead): the TPU kernel DMA'd
// each layer's int8 blocks into a 3-deep VMEM ring and converted layer l+1
// into one of two bf16 buffers while layer l computed. Here the two bf16
// buffers are in device memory (wbuf: 2 x (4 W^2 + 2 W I) values, 14.2 MB a
// layer at W 768, 25.2 MB at W 1024), and layer l's products read buffer l %
// 2 through the bf16 GEMM path (its TMA ring, no conversion in the K
// loop). Layer l+1's conversion is cut into three parts, one in each of
// layer l's stages that leave blocks idle at serving batches (attention:
// B x heads x ceil(S / 16) units; the two row stages: B x S rows), done by
// the blocks past the stage's units before they arrive at the barrier, so
// the work fills their wait (every block takes a share, after its units,
// where none is idle). Spreading it over all seven stages on every block was
// measured too (profile_tower's stage clocks) and was slower at most of the
// serving shapes tried. A prologue stage converts layer 0. Buffer (l+1) % 2
// was last read by layer l-1's products, and the barriers between them
// order those reads before these writes: one barrier
// stands where the TPU needed a third ring slot. The L2 prefetch moves one
// layer further ahead, to layer l+2's int8 blocks. The bf16 values and the
// mma order are those of #5, so at the same grid (the same K-splits) the
// output is #5's bit for bit.
//
// Memory ordering: every block writes its stage's results, then a proxy
// fence (the next GEMM stage reads them by TMA, the async proxy) and
// __threadfence(), then arrives at the barrier; data written by other
// blocks is read through L2 only (TMA, cp.async.cg, __ldcg), since L1 is not
// coherent across SMs. The barrier counter only grows (one fire-and-forget
// add an arrival; a block waits for its count to reach the next multiple of
// the grid), and the tile counters return to 0 after each use, so the
// wrapper hands the kernel zeroed counters and nothing else is reset.
#include "attention.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;        // one warpgroup
constexpr int kTileN = 64;           // output channels a unit: wgmma's M (gates.TOWER_TILE)
constexpr int kTileK = 64;           // K a ring stage, the swizzle's row (gates.TOWER_KSTEP)
constexpr int kChunk = 64;           // tokens a wgmma: its N
constexpr int kMaxChunks = 2;        // chunks a unit: at most 128 tokens (gates.TOWER_MAX_CHUNKS)
constexpr int kMaxStages = 6;
constexpr int kBox = kChunk * kTileK * 2;   // bytes of a bf16 box of 64 rows x 64
constexpr int kBox8 = kTileN * kTileK;      // bytes of #5's int8 W box
constexpr int kRingBf16 = 96 * 1024;        // ring bytes: bf16 W
constexpr int kRingInt8 = 80 * 1024;        // int8 W, beside two converted bf16 tiles
constexpr int kLdC = kTileN + 4;            // fp32 row stride of the staged output tile
constexpr int kPtrs = 16;                   // pointers a layer in the table
constexpr int kMaxSplits = 8;               // K-splits of one product, at most
constexpr int kMinSplitSteps = 2;           // 64-deep stages a split, at least
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

// The activations' tensor maps, [M, W] bf16 (h: [M, I]) in 64 x 64 boxes.
enum { kMapX, kMapXn, kMapA, kMapCtx, kMapH, kMaps };

// The launch plan (tower_plan): M = B S cut into `ranges` even token ranges
// of at most `chunks` 64-token chunks; a ring of `stages` slots; the
// K-splits of the four products (qkv, out, fc1, fc2); the partial sums'
// fp32 elements and the counters (sem, the barrier's first).
struct TowerPlan {
  int ranges, chunks, stages, ks[4], part, sem, smem;
};

struct TowerArgs {
  CUtensorMap amap[kMaps];     // the activations (kMap*)
  CUtensorMap wahead[2][4];    // #6: the two bf16 layer buffers' four weights
  bf16* x;                 // [M, W] the activations, in and out
  const float* key_bias;   // [B, S] or null
  const void* const* table;
  const CUtensorMap* wmap; // [L][4] the weights' maps (qkv, o, fc1, fc2); null for #6
  bf16 *xn, *a, *ctx, *qkv, *h;  // scratch: [M, W] x3, [M, 3W], [M, I]
  float* sum;              // [M, W] fp32: the residual sums before the row stages
  float* part;             // fp32 partial sums, [ks, M, N] of the current GEMM
  bf16* wbuf;              // #6: two layers' weights in bf16, or null
  unsigned* sem;           // zeroed: [0] the barrier, [1..] one counter a tile
  long long* clock;        // null, or the time after each barrier (ns)
  int B, S, W, I, L;
  float eps, scale;        // scale: 1 / sqrt(dh)
  int act, post_ln;
  int ranges, chunks, stages;
  int ks[4];
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

NANS_DEVICE float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

NANS_DEVICE void st_bf2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// Proxy fences: this thread's generic-proxy writes become visible to the
// async proxy (TMA, wgmma), and its reads are ordered before the proxy's
// writes. Global memory only: a stage's results, before the grid barrier
// (the unqualified fence was slower at batch 1).
NANS_DEVICE void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Shared memory only.
NANS_DEVICE void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Asks for a tensor map's descriptor ahead of its first TMA load.
NANS_DEVICE void prefetch_map(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
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
  fence_proxy_async_global();   // this stage's global writes, for the TMA reads after it
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

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both K-major from shared memory
// (wgmma m64n64k16); scale_d 0 overwrites d. d[4 j + e] is row (output
// channel) 16 warp + lane / 4 + 8 (e / 2), column (token) 8 j + 2 (lane % 4)
// + e % 2.
NANS_DEVICE void wgmma_64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The epilogue of 8 consecutive outputs (row, col .. col + 7) of an N-wide
// product from their sums v, their bias b and residual r (8 bf16 each, r 0
// without one): + bias, the activation, + residual, one rounding at the
// store (bf16, or fp32 into out_f32).
NANS_DEVICE void epilogue8(const Epilogue& ep, int N, int row, int col, float (&v)[8],
                           const uint4& b, const uint4& r) {
  const size_t off = static_cast<size_t>(row) * N + col;
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(&b);
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t bb = bw[i >> 1], rr = rw[i >> 1];
    const float bias = __uint_as_float(i & 1 ? bb & 0xffff0000u : bb << 16);
    const float res = __uint_as_float(i & 1 ? rr & 0xffff0000u : rr << 16);
    v[i] = activate(v[i] + bias, ep.act) + res;
  }
  if (ep.out_f32) {
    float4* o = reinterpret_cast<float4*>(ep.out_f32 + off);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *reinterpret_cast<uint4*>(ep.out_bf16 + off) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                   pack_bf16(v[6], v[7]));
  }
}

// The residual of outputs (row, col .. col + 7), or 0 without one.
NANS_DEVICE uint4 residual8(const Epilogue& ep, int N, int row, int col) {
  return ep.residual
             ? __ldcg(reinterpret_cast<const uint4*>(ep.residual + static_cast<size_t>(row) * N +
                                                     col))
             : make_uint4(0, 0, 0, 0);
}

// 8 fp32 values of the staged tile.
NANS_DEVICE void staged8(float (&v)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

NANS_DEVICE void load8(float (&v)[8], const float* p) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// #5: the int8 W box of a stage (64 rows x 64, unswizzled) into a bf16 tile
// in the 128-byte swizzle TMA writes (16-byte chunk c of row r at c ^ (r %
// 8)), each value bf16(float(q) * sc) with sc the scale of the thread's row:
// thread t takes half t % 2 of row t / 2.
NANS_DEVICE void convert_w(bf16* dst, const unsigned char* src, float sc) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const uint4* in = reinterpret_cast<const uint4*>(src + r * kTileK + half * 32);
  const uint4 raw[2] = {in[0], in[1]};
  const int8_t* q = reinterpret_cast<const int8_t*>(raw);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = pack_bf16(static_cast<float>(q[8 * c + 2 * e]) * sc,
                       static_cast<float>(q[8 * c + 2 * e + 1]) * sc);
    const int chunk = (half * 4 + c) ^ (r & 7);
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(dst) + r * 128 + chunk * 16) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The block's TMA ring: `stages` slots of `slot` bytes from `base` (1024-byte
// aligned), one full barrier each; `it` counts the stages consumed so far,
// across units, products and layers (slot it % stages, phase parity (it /
// stages) % 2). #5 converts into cvt's two bf16 tiles in turn.
struct Ring {
  unsigned char* base;
  bf16* cvt;
  uint64_t* full;
  int stages, slot;
  unsigned it;
};

// One GEMM stage: ep(A[M, K] . W[N, K]^T) with A and W read through tensor
// maps; wscale: #5's per-channel scales (kQuant: W is int8); NC: the
// launch's chunks of 64 tokens a unit (the plan's `chunks`): every unit
// multiplies all NC, so that no wgmma sits on a divergent path (ptxas would
// serialize them); a chunk past its range's rows is loaded from the
// range's first rows and not stored. Returns the ring's stages consumed. Not
// inlined, and given the ring and the epilogue by value: inlined, its
// accumulators and the attention stage shared one register allocation of
// 255 that spilled, and the attention stage ran slower; by reference, the
// ring's fields sat in local memory.
template <bool kQuant, int NC>
__device__ __noinline__ unsigned gemm_units(const TowerArgs& p, const CUtensorMap* amap,
                                            const CUtensorMap* wmap, const float* wscale,
                                            unsigned* counters, const Epilogue ep, int N, int K,
                                            int ks, bool defer, Ring ring) {
  const int M = p.B * p.S, R = p.ranges, ct = N / kTileN;
  const int units = ct * R * ks, ksteps = K / kTileK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t plane = static_cast<size_t>(M) * N;
  const int wbytes = kQuant ? kBox8 : kBox;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    // channels n0 .. n0 + 63 of token range r (tokens t0 .. t0 + rows - 1),
    // K stages kb .. kb + n - 1 of 64 deep
    const int split = u % ks, tile = u / ks, n0 = (tile % ct) * kTileN, r = tile / ct;
    const int t0 = static_cast<int>(static_cast<long long>(r) * M / R);
    const int rows = static_cast<int>(static_cast<long long>(r + 1) * M / R) - t0;
    const int kb = split * ksteps / ks, n = (split + 1) * ksteps / ks - kb;
    const int nc = (rows + kChunk - 1) / kChunk;   // <= NC
    constexpr uint32_t bytes = (kQuant ? kBox8 : kBox) + NC * kBox;
    // stage j of this unit into its slot: W's 64 channels and NC token
    // boxes of its 64-deep K step (rows past M zero-filled)
    const auto issue = [&](int j) {
      const unsigned i = ring.it + j;
      unsigned char* s = ring.base + (i % ring.stages) * ring.slot;
      uint64_t* bar = &ring.full[i % ring.stages];
      const int k0 = (kb + j) * kTileK;
      mbar_expect_tx(bar, bytes);
      tma_load(s, wmap, bar, k0, n0);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load(s + wbytes + c * kBox, amap, bar, k0, t0 + (c < nc ? c * kChunk : 0));
    };
    fence_proxy_async_smem();   // the block's last writes to this memory (the
    __syncthreads();            // other stages, the staged tile) before the TMA's
    if (tid == 0)
      for (int j = 0; j < min(ring.stages, n); ++j) issue(j);
    const float sc = kQuant ? wscale[n0 + (tid >> 1)] : 0.f;
    // #5: stage j's int8 box, once landed, into converted tile j % 2
    const auto convert = [&](int j) {
      const unsigned i = ring.it + j;
      mbar_wait(&ring.full[i % ring.stages], (i / ring.stages) & 1);
      convert_w(ring.cvt + (i & 1) * (kTileN * kTileK), ring.base + (i % ring.stages) * ring.slot,
                sc);
      fence_proxy_async_smem();   // the converted tile, before the wgmma reads it
    };
    if (kQuant) convert(0);
    float acc[NC][32];
    for (int j = 0; j < n; ++j) {
      const unsigned i = ring.it + j;
      const unsigned char* s = ring.base + (i % ring.stages) * ring.slot;
      // a refill of stage j - 1's slot (with stage j - 1 + stages) waits for
      // every warp's products of stage j - 1, as #5's converted tile j waits
      // for every warp's conversion; stages already in the ring need neither
      const bool refill = j >= 1 && j - 1 + ring.stages < n;
      if (kQuant || refill) {
        wgmma_wait<0>();
        __syncthreads();
        if (tid == 0 && refill) issue(j - 1 + ring.stages);
      }
      if (!kQuant) mbar_wait(&ring.full[i % ring.stages], (i / ring.stages) & 1);
      const bf16* wt = kQuant ? ring.cvt + (i & 1) * (kTileN * kTileK)
                              : reinterpret_cast<const bf16*>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        const uint64_t dw = desc_sw128(wt + kk * 16);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_64(acc[c], dw, desc_sw128(s + wbytes + c * kBox + kk * 32), j > 0 || kk > 0);
      }
      wgmma_commit();
      if (kQuant && j + 1 < n) convert(j + 1);   // beside the products in flight
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(acc[c][e])::"memory");
    ring.it += n;
    __syncthreads();   // every warp's products are done: the ring takes the tile

    // the tile as [token][channel] fp32, then rows of it
    float* sC = reinterpret_cast<float*>(ring.base);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c >= nc) continue;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int ch = 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
        const int tok = c * kChunk + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        sC[tok * kLdC + ch] = acc[c][e];
      }
    }
    __syncthreads();
    // thread t takes channels col .. col + 7 of rows t / 8, + 16, ...
    constexpr int kStep = kThreads / 8;
    const int g8 = tid & 7, col = n0 + 8 * g8;
    const uint4 bias = *reinterpret_cast<const uint4*>(ep.bias + col);
    if (ks == 1) {
      for (int tr = tid >> 3; tr < rows; tr += kStep) {
        const uint4 res = residual8(ep, N, t0 + tr, col);
        float v[8];
        staged8(v, sC + tr * kLdC + 8 * g8);
        epilogue8(ep, N, t0 + tr, col, v, bias, res);
      }
    } else if (split > 0 || defer) {   // a partial sum, then its count (unless deferred)
      float* dst = p.part + split * plane;
      for (int tr = tid >> 3; tr < rows; tr += kStep) {
        const float4* src = reinterpret_cast<const float4*>(sC + tr * kLdC + 8 * g8);
        float4* d = reinterpret_cast<float4*>(dst + static_cast<size_t>(t0 + tr) * N + col);
        d[0] = src[0];
        d[1] = src[1];
      }
      if (!defer) {
        __syncthreads();
        if (tid == 0) {   // the block's stores, then its count (as grid_sync)
          __threadfence();
          atomicAdd(counters + tile, 1u);   // result unused: a reduction
        }
      }
    } else {   // split 0 adds the others' partial sums to its own, in split order
      if (tid == 0) {
        const long long start = clock64();
        while (ld_acquire(counters + tile) < static_cast<unsigned>(ks - 1)) {
          __nanosleep(20);
          if (clock64() - start > kBarrierTimeout) __trap();
        }
        __threadfence();
        counters[tile] = 0u;   // ready for the next product
      }
      __syncthreads();
      // the splits' loads two at a time (one at a time, each add waited on
      // its load; all at once, the registers spilled)
      for (int tr = tid >> 3; tr < rows; tr += kStep) {
        const float* src = p.part + static_cast<size_t>(t0 + tr) * N + col;
        const uint4 res = residual8(ep, N, t0 + tr, col);
        float v[8];
        staged8(v, sC + tr * kLdC + 8 * g8);
        for (int sp = 1; sp < ks; sp += 2) {
          float t0v[8], t1v[8];
          load8(t0v, src + sp * plane);
          if (sp + 1 < ks) load8(t1v, src + (sp + 1) * plane);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] += t0v[i];
          if (sp + 1 < ks)
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] += t1v[i];
        }
        epilogue8(ep, N, t0 + tr, col, v, bias, res);
      }
    }
  }
  return ring.it;
}

// The GEMM stage at the launch's chunk count. defer: with K-splits, every
// split only writes its partial sums, and the row stage after the GEMM adds
// them with the epilogue (the fp32 products out and fc2, whose epilogue is
// + bias + residual).
template <bool kQuant>
__device__ void gemm_stage(const TowerArgs& p, const CUtensorMap* amap, const CUtensorMap* wmap,
                           const float* wscale, unsigned* counters, const Epilogue& ep, int N,
                           int K, int ks, bool defer, Ring& ring) {
  if (p.chunks == 1)
    ring.it = gemm_units<kQuant, 1>(p, amap, wmap, wscale, counters, ep, N, K, ks, defer, ring);
  else
    ring.it = gemm_units<kQuant, 2>(p, amap, wmap, wscale, counters, ep, N, K, ks, defer, ring);
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

// This thread's pairs of row `row` of the fp32 [M, W] result of the out or
// fc2 product: the sum buffer, or, where the product ran in ks > 1 K-splits
// (gemm_stage's defer), its partial sums added in split order, + bias, +
// the bf16 residual: the epilogue's arithmetic in its order. The row's ks
// partial rows come by cp.async into `stage` (ks W fp32 of shared memory),
// all in flight at once and in no register (loaded into registers, a
// split a round trip, or all at once, the registers spilled).
template <int kRP>
NANS_DEVICE void load_sum(float (&v)[2 * kRP], const TowerArgs& p, int row, int ks,
                          const bf16* bias, const bf16* residual, float* stage) {
  const int W = p.W;
  if (ks == 1) {
    load_row<kRP>(v, p.sum + static_cast<size_t>(row) * W, W);
    return;
  }
  const size_t plane = static_cast<size_t>(p.B) * p.S * W;
  const int chunks = W / 4;   // 16-byte chunks of a row
  __syncthreads();            // the block's last reads of stage are done
  for (int c = threadIdx.x; c < ks * chunks; c += kThreads) {
    const int sp = c / chunks, k = c - sp * chunks;
    cp_async16(stage + sp * W + 4 * k, p.part + sp * plane + static_cast<size_t>(row) * W + 4 * k,
               16);
  }
  cp_async_commit();
  float2 b[kRP], r[kRP];
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    if (!has_pair(i, W)) continue;
    b[i] = ld_bf2(bias + pair_col(i));
    const unsigned ru = __ldcg(
        reinterpret_cast<const unsigned*>(residual + static_cast<size_t>(row) * W + pair_col(i)));
    r[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ru));
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    if (!has_pair(i, W)) continue;
    float2 a = *reinterpret_cast<const float2*>(stage + pair_col(i));
    for (int sp = 1; sp < ks; ++sp) {
      const float2 t = *reinterpret_cast<const float2*>(stage + sp * W + pair_col(i));
      a.x += t.x;
      a.y += t.y;
    }
    v[2 * i] = (a.x + b[i].x) + r[i].x;
    v[2 * i + 1] = (a.y + b[i].y) + r[i].y;
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
__global__ void __launch_bounds__(kThreads) tower_kernel(const __grid_constant__ TowerArgs p) {
  constexpr bool kQuant = kMode == kInt8, kAhead = kMode == kInt8Ahead;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kThreads / 32];
  __shared__ uint64_t full[kMaxStages];
  // the GEMM stages' ring, 1024-byte aligned (the swizzle's atom) in the
  // same shared memory as the attention stage's rows; #5's two converted
  // tiles after it
  Ring ring;
  ring.base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(1023));
  ring.cvt = reinterpret_cast<bf16*>(ring.base + kRingInt8);
  ring.full = full;
  ring.stages = p.stages;
  ring.slot = (kQuant ? kBox8 : kBox) + p.chunks * kBox;
  ring.it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
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
  // the map of layer l's weight w (0 qkv, 1 o, 2 fc1, 3 fc2): #6 reads its
  // bf16 copy in wbuf, the others the weights where the table points
  auto wmap = [&](int l, int w) { return kAhead ? &p.wahead[l & 1][w] : p.wmap + 4 * l + w; };
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
  if (threadIdx.x == 0)
    for (int i = 0; i < kMaps; ++i) prefetch_map(&p.amap[i]);
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

  for (int l = 0; l < p.L; ++l) {
    if (threadIdx.x == 0)
      for (int w = 0; w < 4; ++w) prefetch_map(wmap(l, w));
    if (kAhead) {
      if (l + 2 < p.L) prefetch_layer(l + 2);
    } else if (l + 1 < p.L) {
      prefetch_layer(l + 1);
    }
    gemm_stage<kQuant>(p, &p.amap[p.post_ln ? kMapX : kMapXn], wmap(l, 0), scl(l, kSqkv),
                       tiles, Epilogue{vec(l, kBqkv), 0, nullptr, p.qkv, nullptr}, 3 * W, W,
                       p.ks[0], false, ring);
    sync();
    attention_stage<KS>(p, smem);
    ahead(l, 0, attn_units);
    sync();
    gemm_stage<kQuant>(p, &p.amap[kMapCtx], wmap(l, 1), scl(l, kSo), tiles,
                       Epilogue{vec(l, kBo), 0, p.x, nullptr, p.sum}, W, W, p.ks[1], true, ring);
    sync();
    FOR_ROWS(M) {  // the attention sub-block's output a, and the MLP's LN input
      load_sum<kRP>(v, p, row, p.ks[1], vec(l, kBo), p.x, reinterpret_cast<float*>(smem));
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
    gemm_stage<kQuant>(p, &p.amap[p.post_ln ? kMapA : kMapXn], wmap(l, 2), scl(l, kS1), tiles,
                       Epilogue{vec(l, kB1), p.act, nullptr, p.h, nullptr}, I, W, p.ks[2], false,
                       ring);
    sync();
    gemm_stage<kQuant>(p, &p.amap[kMapH], wmap(l, 3), scl(l, kS2), tiles,
                       Epilogue{vec(l, kB2), 0, p.a, nullptr, p.sum}, W, I, p.ks[3], true, ring);
    sync();
    FOR_ROWS(M) {  // the layer's output, and the next layer's LN1 input
      load_sum<kRP>(v, p, row, p.ks[3], vec(l, kB2), p.a, reinterpret_cast<float*>(smem));
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

// Dynamic shared memory: the attention stage's rows, or the GEMM stages'
// ring (and #5's two converted tiles) with the slack to align it, whichever
// is larger; it does not depend on the batch.
size_t tower_smem(int mode, int dh, int S) {
  const size_t attn_bytes = dh == 80 ? attention_smem<5>(S) : attention_smem<4>(S);
  const size_t gemm_bytes = 1024 + (mode == kInt8 ? kRingInt8 + 2 * kBox : kRingBf16);
  return attn_bytes > gemm_bytes ? attn_bytes : gemm_bytes;
}

// The launch plan (ops/tower_kernel.py::tower_plan computes the same): M =
// B S in the fewest even token ranges of at most one chunk of 64 tokens
// where the largest product then fits the grid in one round of units, else
// of at most kMaxChunks chunks; the ring as deep as its bytes allow for that
// many chunks a stage; each product's units, (N / 64 channel tiles) x
// ranges x K-splits, as many splits as fill the grid once (half the grid
// for qkv and fc1, whose split 0 waits for the others and reads their
// partials: at RoBERTa-base's batch 1 their stages were faster than on the
// whole grid; never a second round of units, which would double the stage,
// and in which split 0 of a tile could wait for a split that no block runs
// yet), each at least kMinSplitSteps stages of 64 deep, at most kMaxSplits;
// the partial sums of the split products and a counter for each (channel
// tile, range) of the largest.
TowerPlan tower_plan(int mode, int B, int S, int W, int I, int dh, int grid) {
  TowerPlan p{};
  const int M = B * S;
  // one chunk a unit (the most units, the fewest K-splits) while the
  // largest product's tiles of 64 tokens fit the grid in one round
  const int n_max = 3 * W > I ? 3 * W : I;
  const int most = n_max / kTileN * ((M + kChunk - 1) / kChunk) <= grid ? 1 : kMaxChunks;
  p.ranges = (M + most * kChunk - 1) / (most * kChunk);
  p.chunks = ((M + p.ranges - 1) / p.ranges + kChunk - 1) / kChunk;
  const int slot = (mode == kInt8 ? kBox8 : kBox) + p.chunks * kBox;
  const int stages = (mode == kInt8 ? kRingInt8 : kRingBf16) / slot;
  p.stages = stages < kMaxStages ? stages : kMaxStages;
  const int nk[4][2] = {{3 * W, W}, {W, W}, {I, W}, {W, I}};
  long long part = 1;
  int tiles_max = 0;
  for (int i = 0; i < 4; ++i) {
    const int tiles = nk[i][0] / kTileN * p.ranges;
    int cap = nk[i][1] / kTileK / kMinSplitSteps;
    cap = cap < kMaxSplits ? cap : kMaxSplits;
    cap = cap > 1 ? cap : 1;
    // qkv and fc1 hand their splits over in the stage (split 0 waits, then
    // reads the others' partials): half the grid, fewer and longer splits;
    // out and fc2 leave the adding to the row stage: the whole grid
    const int fill = (i == 0 || i == 2 ? grid / 2 : grid) / tiles;
    p.ks[i] = fill < cap ? (fill > 1 ? fill : 1) : cap;
    if (p.ks[i] > 1 && static_cast<long long>(p.ks[i]) * M * nk[i][0] > part)
      part = static_cast<long long>(p.ks[i]) * M * nk[i][0];
    tiles_max = tiles > tiles_max ? tiles : tiles_max;
  }
  p.part = static_cast<int>(part);
  p.sem = 1 + tiles_max;
  p.smem = static_cast<int>(tower_smem(mode, dh, S));
  return p;
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

// An [rows, cols] bf16 operand in 64 x 64 boxes (128-byte swizzle).
bool encode_bf16(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int cols) {
  return encode_2d(fn, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, kTileK, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
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

// The launch plan of a tower at (mode, B, S, W, I, dh) on `grid` blocks: out
// = {ranges, chunks, stages, ks qkv, ks out, ks fc1, ks fc2, part fp32
// elements, sem counters, dynamic shared-memory bytes}.
// ops/tower_kernel.py::tower_plan computes the same.
extern "C" int nans_tower_plan(int mode, int B, int S, int W, int I, int dh, int grid, int* out) {
  const TowerPlan p = tower_plan(mode, B, S, W, I, dh, grid);
  const int v[10] = {p.ranges, p.chunks, p.stages, p.ks[0], p.ks[1], p.ks[2], p.ks[3], p.part,
                     p.sem, p.smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// The tensor maps of every layer's four weights for the tower's GEMM
// stages, read from device memory: table: the [L, 16] pointer table as host
// values; out: host room for L * 4 CUtensorMaps (128 bytes each, qkv, o,
// fc1, fc2 a layer), which the caller copies to the card (64-byte aligned).
// int8 weights (quant) as unswizzled 64 x 64-byte boxes, bf16 as 64 x 64
// boxes in the 128-byte swizzle. Returns a CUDA error code.
extern "C" int nans_tower_maps(const long long* table, int L, int W, int I, int quant, void* out) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorInitializationError);
  auto* maps = static_cast<CUtensorMap*>(out);
  const int shape[4][2] = {{3 * W, W}, {W, W}, {I, W}, {W, I}};
  const int at[4] = {kWqkv, kWo, kW1, kW2};
  for (int l = 0; l < L; ++l)
    for (int w = 0; w < 4; ++w) {
      const void* base = reinterpret_cast<const void*>(table[l * kPtrs + at[w]]);
      const bool ok = quant ? encode_2d(fn, &maps[4 * l + w], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                                        base, shape[w][0], shape[w][1], kTileK, kTileN,
                                        CU_TENSOR_MAP_SWIZZLE_NONE)
                            : encode_bf16(fn, &maps[4 * l + w], base, shape[w][0], shape[w][1]);
      if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    }
  return 0;
}

// x: [B*S, W] bf16, overwritten with the tower's output; key_bias: [B, S]
// fp32 or null; table: [L, 16] device pointers (see the enum above; int8
// weights [out, in] and fp32 scales [out] when mode != 0); wmaps: the
// weights' tensor maps on the card (nans_tower_maps; null when mode == 2);
// work: bf16 scratch of 6*B*S*W + B*S*I elements; sum: fp32 [B*S, W]; part:
// fp32 scratch of the plan's `part` elements; wbuf: bf16 scratch of 2 * (4
// W^2 + 2 W I) elements when mode == 2, else null; sem: zeroed uint32 of
// the plan's `sem`; clock: null, or int64 room for the start and each
// barrier. dh: 64 or 80; scale: 1 / sqrt(dh). act: 1 quick-GELU, 2
// erf-GELU. ks: the plan's K-splits of qkv, out, fc1, fc2 on this grid.
// Shapes are checked by the Python wrapper. A grid larger than
// nans_tower_grid's is refused by the cooperative launch
// (cudaErrorCooperativeLaunchTooLarge). Returns the launch's error.
extern "C" int nans_tower(void* x, const void* key_bias, const void* table, const void* wmaps,
                          void* work, void* sum, void* part, void* wbuf, void* sem, void* clock,
                          int B, int S, int W, int I, int L, int dh, float eps, float scale,
                          int act, int post_ln, int mode, int ks_qkv, int ks_o, int ks_1,
                          int ks_2, int grid, void* stream) {
  TowerFn fn = nullptr;
  size_t smem = 0;
  cudaError_t err = prepare(mode, dh, S, &fn, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((mode == kInt8Ahead) != (wbuf != nullptr) || (mode == kInt8Ahead) == (wmaps != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorInitializationError);
  const TowerPlan plan = tower_plan(mode, B, S, W, I, dh, grid);
  const size_t M = static_cast<size_t>(B) * S;
  bf16* w = static_cast<bf16*>(work);
  TowerArgs args{};
  args.x = static_cast<bf16*>(x);
  args.key_bias = static_cast<const float*>(key_bias);
  args.table = static_cast<const void* const*>(table);
  args.wmap = static_cast<const CUtensorMap*>(wmaps);
  args.xn = w;
  args.a = w + M * W;
  args.ctx = w + 2 * M * W;
  args.qkv = w + 3 * M * W;
  args.h = w + 6 * M * W;
  args.sum = static_cast<float*>(sum);
  args.part = static_cast<float*>(part);
  args.wbuf = static_cast<bf16*>(wbuf);
  args.sem = static_cast<unsigned*>(sem);
  args.clock = static_cast<long long*>(clock);
  args.B = B, args.S = S, args.W = W, args.I = I, args.L = L;
  args.eps = eps, args.scale = scale, args.act = act, args.post_ln = post_ln;
  args.ranges = plan.ranges, args.chunks = plan.chunks, args.stages = plan.stages;
  args.ks[0] = ks_qkv, args.ks[1] = ks_o, args.ks[2] = ks_1, args.ks[3] = ks_2;
  const bf16* acts[kMaps] = {args.x, args.xn, args.a, args.ctx, args.h};
  bool ok = true;
  for (int i = 0; i < kMaps; ++i)
    ok = ok && encode_bf16(enc, &args.amap[i], acts[i], static_cast<int>(M), i == kMapH ? I : W);
  if (mode == kInt8Ahead) {   // the two layer buffers of wbuf: qkv, o, fc1, fc2 in a row
    const size_t layer = 4 * static_cast<size_t>(W) * W + 2 * static_cast<size_t>(W) * I;
    const size_t off[4] = {0, 3 * static_cast<size_t>(W) * W, 4 * static_cast<size_t>(W) * W,
                           4 * static_cast<size_t>(W) * W + static_cast<size_t>(I) * W};
    const int shape[4][2] = {{3 * W, W}, {W, W}, {I, W}, {W, I}};
    for (int h = 0; h < 2; ++h)
      for (int i = 0; i < 4; ++i)
        ok = ok && encode_bf16(enc, &args.wahead[h][i], args.wbuf + h * layer + off[i],
                               shape[i][0], shape[i][1]);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(grid),
                                    dim3(kThreads), kargs, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
