"""The port's routing and admission table for the hand-written CUDA kernels.

Counterpart of ``nans_clip_tpu/ops/gates.py``, which records TPU constants
(VMEM budgets, Mosaic lane rules, tiles) settled on a TPU. None of those
carry over: each entry here is the port's own and says how it was settled.

Routing (which function a tower calls) is decided on the host from the
tensor's device, its dtype and the model's ``attn_impl``:

* ``plain`` always runs the plain-torch twins; ``xla`` (the JAX package's
  name for its plain route) means the same;
* ``kernel`` runs the kernels and raises for a tensor off the card;
* ``auto`` runs the kernels on CUDA tensors and the twins on CPU tensors;
  ``fused`` (the JAX name of the fused-kernel route) means the same: on
  CPU tensors the twins stand where the JAX package's interpret mode
  stands off the TPU (``nans_clip_tpu/models/vit.py:117-119``);
* ``pallas`` is the JAX package's flash-attention route: each layer is
  LayerNorm, the QKV and out projections and the MLP in plain torch around
  the flash attention (#22 forward, #23 backward, ``ops/attention.py``),
  which :func:`pallas_attention_route` admits; no sub-block, whole-layer or
  whole-tower kernel runs.

Under ``auto``, ``fused``, ``kernel`` and ``pallas`` a CUDA tensor in
another dtype than ``KERNEL_DTYPE`` raises: the plain path on the card is
reached only by asking for ``plain`` (or ``xla``).

Training: a forward with ``deterministic=False`` runs every layer through
the autograd Functions (``ops/fused_block.py``, ``ops/layer_bwd.py``:
kernels #1/#2 forward), never the whole-layer forward or whole-tower kernel.
Which backward a Function runs is decided by what needs a gradient and by
``ModelOptions.bwd_impl`` (:func:`bwd_route`, :func:`layer_bwd_route`): a
block with a frozen weight always takes the emitting kernels (#13/#15/#17)
and forms only the weight gradients that are needed.

Tensor parallelism (``ModelOptions.tp`` > 1): every layer of both towers
takes the sub-blocks of ``parallel/tp.py`` before any other route;
:func:`tp_impls` picks the partial kernels (#11/#12) or their twins as the
JAX towers pick them, :func:`fits_partial` names the local shapes the
kernels admit, and the whole-tower kernel never runs (:func:`tower_route`).

Admission (what a kernel takes) is checked by each wrapper before it
launches; a CUDA tensor that the kernel does not admit raises. No path
turns a failed build or launch into the plain path. The kernels' limits
(head dims 64 and 80, S <= 640, the one-shot backward's S <= 320, LayerNorm
rows up to 2048, the GEMM tiles) are constants below, each with what in the
kernel sets it.

Which TPU kernel's counterpart a wide block runs (#1 or #7, #2 or #9/#10)
follows the JAX towers: the last section answers the JAX package's routing
questions (``fits_fused``, ``fused_mlp_routable``, ``mlp_batch_tile``, ...)
as it answers them, for that choice and for the tests; no kernel is
admitted or refused by a TPU VMEM budget.
"""

from __future__ import annotations

import torch

# io dtype of the kernels. Chosen for bring-up: the slice runs in bf16
# (bench and serving are bf16 inference); not yet measured on H100.
KERNEL_DTYPE = torch.bfloat16

# attention.cu and attention.cuh: the kernels are templates over the head
# dim's 16-wide k-steps, instanced for heads of 64 (every ViT-B/L and
# RoBERTa tower) and 80 (ViT-H: five k-steps, ten n-tiles of 8). The
# forward holds a head's K and V in shared memory, dh bf16 a row (swizzled,
# unpadded), and two 16-row Q buffers a warp: above 256 keys a block a
# (head, sample), where S <= 640 keeps it at 227,840 bytes at dh 80 with 4
# warps; up to 256 the walking block's stages (K, V and key bias of a unit
# each) take what the warps' buffers leave of the card's 232,448 a block
# (SMEM_PER_BLOCK; ``ops/attention.py::attention_plan``). Set by the
# kernel's design.
HEAD_DIMS = (64, 80)
MAX_SEQ = 640
SMEM_PER_BLOCK = 232448
# An H100 SM: 233,472 bytes of shared memory (1 KB of it reserved a block),
# 65,536 registers, 132 SMs on the SXM part (a plan takes the card's count).
SMEM_PER_SM = 233472
REGS_PER_SM = 65536
H100_SMS = 132

# attention.cu's one-shot backward: Q, K, V and dctx of a head sit in shared
# memory (4 unpadded swizzled rows of dh bf16) plus 16 bytes of row
# statistics and key bias a row, and under dropout 2 bytes a row and key
# tile of keep bits: S <= 320 keeps the block at 168,960 bytes (dh 64) or
# 222,720 (dh 80, with dropout). A kernel limit, not a measured routing
# gate; the training shapes S = 52, 197, 257 qualify.
ATTN_BWD_MAX_SEQ = 320
# attention.cu's long-sequence backward (the core of #20): two kernels, each
# a block a (head, sample) walking all of its strips of 16 rows; the dQ
# kernel holds K and V of the head (swizzled, unpadded rows) and the key
# mask, the dK/dV kernel Q and dctx with each query row's max, sum and
# delta: S <= 640 keeps the larger at 215,040 bytes at dh 80
# (``ops/attention.py::attention_bwd_long_plan``). Pre-LN only: no key bias
# and no dropout (as _attn_bwd_chunked_kernel). Above ATTN_BWD_MAX_SEQ every
# backward chain takes it (ViT-L-14-336, S = 577).
ATTN_BWD_LONG_MAX_SEQ = 640

# layernorm.cu: the forward takes one warp a row, 32 values a lane at most,
# up to W = 1024 (ViT-B/L, RoBERTa), and wider rows up to MAX_LN_WIDTH one
# block of 256 threads a row, at most 8 values a thread (ViT-H's 1280); the
# backward one warp a row up to 1024 and a pair of warps above, runs of 8
# columns a lane (at most 4 runs). 2048 is the JAX package's widest kernel
# width (MAX_WIDE_WIDTH, MAX_TILED_MLP_WIDTH). Set by the design.
MAX_LN_WIDTH = 2048
LN_WIDTH_MULTIPLE = 32

# gemm.cu: one design for its three forms, 128 x 256 x 64 tiles fed by TMA
# (launch plans ``ops/gemm.py::gemm_plan``, ``dgrad_plan``, ``wgrad_plan``,
# each within SMEM_PER_BLOCK). The forward form (``linear``) takes a last N
# tile of 64, 128 or 192 columns: W's rows past N load as zeros and nothing
# is stored there, so its N need only be a multiple of GEMM_FWD_N_MULTIPLE
# (tensor parallelism at tp 4: the local QKV width is 3 x 192 = 576 at
# ViT-B and 3 x 320 = 960 at ViT-H), and its K of GEMM_K_MULTIPLE (a
# half-filled last 64-deep stage). The backward forms take the widths of
# the first port: the input gradient's output width (the forward's K) a
# multiple of GEMM_N_MULTIPLE and its contraction (the forward's N) of
# GEMM_K_MULTIPLE; the weight gradient's [N, K] output both multiples of
# GEMM_N_MULTIPLE, its contraction over B*S rows with a masked tail. Kernel
# limits, not measured routing gates; the slice's N (768, 2304, 3072; 1024,
# 3072, 4096; 1280, 3840, 5120) and K (768, 3072; 1024, 4096; 1280, 5120)
# all qualify.
GEMM_N_MULTIPLE = 128
GEMM_FWD_N_MULTIPLE = 64
GEMM_K_MULTIPLE = 32

# tower.cu (the whole-tower kernel, batch 1-32): heads of 64 or 80 (the
# attention stage's instances over attention.cuh's k-steps), S <= 640 (a
# head's K and V in shared memory, as attention.cu), W a multiple of 64 and
# at most 256 x the row stages' column pairs a thread (each row stage holds a
# row in one block of 128 threads, 2 values a pair): 4 pairs at heads of 64
# (W <= 1024: ViT-B/L, RoBERTa), 5 at heads of 80 (W <= 1280: ViT-H-14's image
# tower, the JAX package's TOWER_MAX_WIDTH, nans_clip_tpu/ops/gates.py:183),
# and I a multiple of its 64-wide K step. The GEMM stages cut N in tiles of
# 64 output channels (wgmma's M) and M in ranges of at most 2 chunks of 64
# tokens (``tower_kernel.tower_plan``). Set by the kernel's design. Whether a
# grid can be co-resident at all is asked of the card at launch
# (``tower_kernel.max_grid``).
TOWER_ROW_PAIRS = {64: 4, 80: 5}
TOWER_WIDTH_MULTIPLE = 64
TOWER_MAX_WIDTH = 1280
TOWER_TILE = 64
TOWER_KSTEP = 64
TOWER_MAX_CHUNKS = 2

# The dequant-ahead int8 instance (#6, ``fused_tower(quant_dma=True)``):
# refused, on every device, where the JAX kernel refuses it by width: W a
# multiple of 128 and at most 1024 (``tower_qdma_tile``,
# nans_clip_tpu/ops/tower_kernel.py:229-230; the TPU's reason was VMEM, 3 int8
# + 2 bf16 weight sets, ~138 MB at W 1280). On the card the two bf16 layer
# buffers live in device memory (50.3 MB at W 1024) and the rest of the JAX
# VMEM budget decides nothing (it also refused S 577 at W 1024, which the
# card takes). The kernel itself is compiled for heads of 64 only
# (``TOWER_QDMA_HEAD_DIM``), checked with tower.cu's other limits on CUDA
# tensors.
TOWER_QDMA_MAX_WIDTH = 1024
TOWER_QDMA_HEAD_DIM = 64

# Routing: the batches that take the tower kernel, per tower and weight
# type (the JAX gate, fits_tower, also takes the weights' quantization).
# Batch 1 always does (as in the JAX package); a larger batch does only up
# to the largest batch at which chip_smoke.py measured the tower kernel no
# slower than the per-layer route (int8 weights dequantized on entry, as
# that route runs them), at ViT-B/16 (S = 197) and RoBERTa-base (S = 52), 12
# layers, W = 768. Measured at batch 1, 8 and 32 only, so each gate is one
# of those values. Provenance: chip_smoke.py phase 4 on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit, CUDA events, ms of the tower kernel vs the
# per-layer route at batch 1 / 8 / 32:
#   text  bf16  0.7738 vs 4.4544 / 1.3974 vs 3.6630 /  3.6656 vs 3.1964
#   text  int8  0.6984 vs 5.0874 / 1.3833 vs 4.9771 /  4.0418 vs 6.4699
#   image bf16  0.9956 vs 2.5305 / 3.8150 vs 3.4416 / 12.9265 vs 7.2877
#   image int8  1.1118 vs 5.4307 / 4.0895 vs 4.2375 / 13.3744 vs 8.3606
# The per-layer route at these batches waits on the host (84 launches a
# text tower), so its times spread by ~20% between runs; image int8 at
# batch 8 is within that spread. Re-read on the wgmma GEMM stages (two
# chip_smoke runs of that tree, the same card): text bf16 at batch 32 2.4097
# vs 2.6853 / 2.4506 vs 3.1514 (one run beyond the spread: unchanged);
# image bf16 at batch 8 2.6491 vs 3.6160 / 2.6629 vs 3.9062, both beyond
# it, but the gate is one a (tower, weight type) for every width, and at 8
# it would move ViT-H-14's batch-3 image tower off #9, whose main path that
# is: unchanged until a gate by width.
TOWER_MAX_BATCH = {("text", "bf16"): 8, ("text", "int8"): 32,
                   ("image", "bf16"): 1, ("image", "int8"): 8}

IMPLS = ("auto", "plain", "kernel", "xla", "pallas", "fused")
# The values that run the sub-block, whole-layer and whole-tower kernels.
_KERNEL_IMPLS = ("auto", "kernel", "fused")

# The JAX route's sequence limit for its flash kernel, copied as
# nans_clip_tpu/ops/gates.py:192 sets it (fused_attention sends longer
# sequences to XLA, nans_clip_tpu/ops/attention.py:339). Under ``pallas``
# the port routes as JAX does: above it the attention is the plain one.
MAX_PALLAS_SEQ = 1024

# flash.cu (#22, #23): 16 rows a warp (one mma.sync m16 tile); a block takes
# up to 8 strips of one head, in the forward and in both backward kernels
# (``ops/attention.py::flash_fwd_plan``, ``flash_bwd_plan``); keys (and, in
# the dK/dV kernel, queries) stream through shared memory in tiles of 64
# rows, three tiles in flight: at most 82,688 bytes a forward block (dh 80)
# and 103,936 a backward one (the dK/dV kernel at dh 80: its K and V rows,
# the ring of Q, dO, lse and delta), whatever S is. Head dims as HEAD_DIMS
# (attention.cuh's k-step instances). Set by the kernels' design; S itself
# is not limited by it.
FLASH_BLOCK_K = 64
FLASH_MAX_WARPS = 8
FLASH_STAGES = 3
# #23's dK/dV kernel at heads of 64: two blocks an SM (128 registers, which
# spill) below this many key tiles, one (224 registers) from it on. Set by
# timing both instances of the kernel in turns on an NVIDIA H100 80GB HBM3
# at a 700.00 W power limit (CUDA events): one block was the faster at
# (32, 16, 577, 64), 10 tiles, and the slower at (256, 12, 197, 64), 4.
FLASH_DKV_ONE_BLOCK_TILES = 8

# Routing of the training backward when every weight of a block needs its
# gradient, per block kind: "fullgrad" (#14/#16/#18: the chain forms the
# weight gradients with wgrad_kernel and its own column sums) or "emit"
# (#13/#15/#17, then the weight gradients as library products of the emitted
# activations, ops/fused_block.py). Provenance: chip_smoke.py phase 8 on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit, CUDA events,
# ViT-B/16 + RoBERTa-base at full depth, bf16, with gemm.cu's backward forms
# on wgmma. One block's backward with every weight gradient, ms, emit vs
# fullgrad at batch 128 / 32:
#   attn_pre  (S=197)  3.6012 vs 3.1168 / 1.0857 vs 1.0169
#   attn_post (S=52)   1.0814 vs 1.0426 / 0.9369 vs 0.8856
#   mlp_pre   (S=197)  2.3530 vs 2.3895 / 0.8244 vs 0.8441
#   mlp_post  (S=52)   0.8929 vs 0.8895 / 0.9343 vs 0.6958
# (the S=52 blocks differ by 0.4-4% at batch 128 and swap sides between
# runs; the full step decides). One train step at batch 128, 6 steps a route
# taken in turns, upper median:
#   fullgrad 130.11 ms   emit 133.76 ms   layer 129.96 ms   this table 127.69 ms
# The table stays: cheaper weight gradients brought fullgrad within 2% of it
# but not past it.
BWD_ROUTE = {"attn_pre": "fullgrad", "attn_post": "emit", "mlp_pre": "emit",
             "mlp_post": "emit"}

# Whether ``bwd_impl="auto"`` sends a pre-LN layer whose weights all need
# gradients through the whole-layer Function (#21, ops/layer_bwd.py). On the
# card #21 is #18 then #14 in one call, the gradient between them passing
# through L2/HBM as before: 5.4427 ms against 5.4572 ms for the two calls at
# (128, 197), and the step above 129.96 ms against 130.11 ms on fullgrad
# (same run, same card). No gain beyond the spread, and the table's route is
# faster than both: off.
LAYER_BWD_ROUTE = False

BWD_IMPLS = ("auto", "fullgrad", "emit", "layer")


def bwd_route(kind: str, bwd_impl: str) -> str:
    """"fullgrad" or "emit" for a sub-block of ``kind`` (a key of
    ``BWD_ROUTE``) whose weights all need gradients. ``auto`` reads the
    measured table; ``layer`` concerns the image tower's layers alone and
    leaves the sub-blocks on "fullgrad"."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl must be one of {BWD_IMPLS}, got {bwd_impl!r}")
    if bwd_impl == "auto":
        return BWD_ROUTE[kind]
    return "emit" if bwd_impl == "emit" else "fullgrad"


def layer_bwd_route(bwd_impl: str, weights, seq: int, width: int, heads: int,
                    inter: int) -> bool:
    """True when a pre-LN layer of shape (``seq``, ``width``, ``heads``,
    ``inter``) takes the whole-layer Function: asked for (``layer``) or
    measured no slower (``auto`` and ``LAYER_BWD_ROUTE``), every one of its
    ``weights`` needs a gradient, and the JAX tower would take #21 there:
    #1 (``fits_fused``), the one-shot MLP #2 (``fits_fused_mlp``) and
    ``fits_layer_bwd_fullgrad`` (``nans_clip_tpu/models/vit.py:266-271``),
    with the one-shot attention backward that #21's chain runs (S <=
    ``ATTN_BWD_MAX_SEQ``). Elsewhere the layer takes the sub-block
    Functions."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl must be one of {BWD_IMPLS}, got {bwd_impl!r}")
    asked = bwd_impl == "layer" or (bwd_impl == "auto" and LAYER_BWD_ROUTE)
    return (asked and all(torch.is_tensor(t) and t.requires_grad for t in weights)
            and seq <= ATTN_BWD_MAX_SEQ and fits_fused(seq, width)
            and fits_fused_mlp(seq, width)
            and fits_layer_bwd_fullgrad(seq, width, heads, inter))


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"attn_impl must be one of {IMPLS}, got {impl!r}")


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype != KERNEL_DTYPE:
        raise ValueError(f"the kernels take {KERNEL_DTYPE} on CUDA, got {x.dtype}: pass "
                         "ModelOptions(compute_dtype='bfloat16'), or attn_impl='plain' "
                         "for the plain-torch path")


def use_kernel(x: torch.Tensor, impl: str) -> bool:
    """True when a tower should call the sub-block, whole-layer or
    whole-tower kernel wrappers for ``x``: never under ``plain``, ``xla``
    or ``pallas``."""
    _check_impl(impl)
    if impl not in _KERNEL_IMPLS:
        return False
    if not x.is_cuda:
        if impl == "kernel":
            raise ValueError("attn_impl='kernel' needs CUDA tensors")
        return False
    _check_dtype(x)
    return True


def pallas_route(impl: str) -> bool:
    """True when the towers take the JAX ``pallas`` layer structure (the
    unfused branch of ``nans_clip_tpu/models/vit.py:327-338`` and
    ``bert.py:246-262``)."""
    _check_impl(impl)
    return impl == "pallas"


def pallas_attention_route(q_or_x: torch.Tensor, impl: str, seq: int,
                           dropout_active: bool) -> bool:
    """True when an attention runs the flash attention (#22/#23 on CUDA
    tensors, their twins on CPU tensors): ``fused_attention``'s condition
    (``nans_clip_tpu/ops/attention.py:337-341``), ``impl == "pallas"``, no
    active attention-probability dropout and ``seq <= MAX_PALLAS_SEQ``.
    Else the attention is the plain one, as in JAX: a route decided on the
    host from the shape, not a fallback. A CUDA tensor under ``pallas`` in
    another dtype than ``KERNEL_DTYPE`` raises."""
    if not pallas_route(impl):
        return False
    if q_or_x.is_cuda:
        _check_dtype(q_or_x)
    return not dropout_active and seq <= MAX_PALLAS_SEQ


def fits_tower(seq: int, width: int, heads: int, inter: int) -> bool:
    """The shapes tower.cu admits."""
    dh = width // heads if heads and width % heads == 0 else 0
    return (dh in TOWER_ROW_PAIRS and width % TOWER_WIDTH_MULTIPLE == 0
            and width <= min(TOWER_MAX_WIDTH, 256 * TOWER_ROW_PAIRS[dh]) and seq <= MAX_SEQ
            and inter % TOWER_KSTEP == 0)


def fits_tower_qdma(width: int) -> bool:
    """The widths at which a dequant-ahead tower (#6) exists: the JAX
    ``tower_qdma_tile`` width rule (W % 128 == 0, W <= 1024)."""
    return width % 128 == 0 and width <= TOWER_QDMA_MAX_WIDTH


def tower_route(x: torch.Tensor, impl: str, tower: str, heads: int, inter: int,
                quant: bool, tp: int = 1) -> bool:
    """THE whole-tower predicate of each tower (JAX ``_tower_route``): it
    decides both whether int8 weights stream as they are and whether the
    tower kernel runs. ``x``: the tower's input [B, S, W]; ``quant``: the
    tower holds int8 weights. Never under tensor parallelism (``tp`` > 1),
    as the JAX predicate requires ``options.tp == 1`` (vit.py:128,
    bert.py:118)."""
    b, s, w = x.shape
    return (tp == 1 and use_kernel(x, impl) and fits_tower(s, w, heads, inter)
            and (b == 1 or b <= TOWER_MAX_BATCH[(tower, "int8" if quant else "bf16")]))


def tp_impls(x: torch.Tensor, impl: str, hidden_act=None):
    """(attention impl, MLP impl) of every layer of a tower under tensor
    parallelism, for the tower's input ``x`` [B, S, W]: "fused" (the
    partial kernels #11 / #12, which take their twins for CPU tensors) or
    "xla" (the twins), as the JAX towers choose them. "fused" where the JAX
    tower's ``use_fused`` holds (``attn_impl`` "fused", or the kernels'
    route on the card: :func:`use_kernel`) and ``fits_fused`` /
    ``fits_fused_mlp`` hold at the FULL width (``nans_clip_tpu/models/
    vit.py:150-151``); for the text tower (``hidden_act`` given) the fused
    MLP also needs ``hidden_act == "gelu"`` (``bert.py:142-144``). Under
    ``pallas`` both are "xla", as in JAX. No kernel is admitted or refused
    here: that is :func:`fits_partial`'s question."""
    _, seq, width = x.shape
    use_fused = impl == "fused" or use_kernel(x, impl)
    a = "fused" if use_fused and fits_fused(seq, width) else "xla"
    mlp_ok = use_fused and fits_fused_mlp(seq, width) and hidden_act in (None, "gelu")
    return a, "fused" if mlp_ok else "xla"


def fits_partial(width: int, tp: int, heads=None, inter=None) -> bool:
    """Whether the partial kernels admit a rank's shapes at ``tp`` ranks:
    #11 (``heads`` given) takes each rank's heads of a width in
    ``HEAD_DIMS``, its QKV width 3 W / tp a multiple of
    ``GEMM_FWD_N_MULTIPLE`` (the forward GEMM's N) and its out-projection's
    contraction W / tp of ``GEMM_K_MULTIPLE``; #12 (``inter`` given) its
    fc1 width I / tp of both; both the LayerNorm row as ``MAX_LN_WIDTH``
    and the output width W as a GEMM N. ViT-B/L/H and RoBERTa-base/large
    qualify at tp 2 and 4."""
    ok = (width % GEMM_FWD_N_MULTIPLE == 0 and width % LN_WIDTH_MULTIPLE == 0
          and width <= MAX_LN_WIDTH)
    if heads is not None:
        wl = width // tp
        ok = ok and (heads % tp == 0 and width % heads == 0 and width // heads in HEAD_DIMS
                     and (3 * wl) % GEMM_FWD_N_MULTIPLE == 0 and wl % GEMM_K_MULTIPLE == 0)
    if inter is not None:
        il = inter // tp
        ok = ok and (inter % tp == 0 and il % GEMM_FWD_N_MULTIPLE == 0
                     and il % GEMM_K_MULTIPLE == 0)
    return ok


def admit(ok: bool, what: str) -> None:
    """Raise for a CUDA tensor that a kernel does not take."""
    if not ok:
        raise ValueError(f"kernel does not admit this input: {what}")


def admit_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel io: CUDA, contiguous, the kernel dtype, 16-byte aligned."""
    for t in tensors:
        admit(t.is_cuda and t.is_contiguous(), f"{name}: tensors must be contiguous on CUDA")
        admit(t.dtype == KERNEL_DTYPE, f"{name}: dtype {t.dtype}, kernels take {KERNEL_DTYPE}")
        admit(t.data_ptr() % 16 == 0, f"{name}: tensor not 16-byte aligned")


# ---------------------------------------------------------------------------
# The JAX package's routing questions, answered as it answers them
# (nans_clip_tpu/ops/fused_block.py:460-488, :738-773, :960-1102 and
# fused_block_bwd.py:1063-1087, :1234-1249). Their constants are TPU VMEM
# budgets and Mosaic tiling rules, copied here as the JAX package sets them
# (nans_clip_tpu/ops/gates.py). They decide only WHICH TPU kernel's
# counterpart a block runs (#1 or #7, #9 or #10), as the JAX towers choose:
# on the card those counterparts are chains of the same kernels, and
# ``heads_per_chunk``, ``chunk`` and ``batch_tile`` change no arithmetic.
# Whether a kernel admits a shape is decided by the port's own limits above.
# ---------------------------------------------------------------------------

_MIB = 1024 * 1024
JAX_MAX_FUSED_WIDTH = 1024
JAX_MAX_FUSED_SEQ = 640
JAX_ONESHOT_ATTN_WIDE_WIDTH = 1280
JAX_ONESHOT_ATTN_WIDE_SEQ = 320
JAX_MAX_WIDE_WIDTH = 2048
JAX_MAX_FUSED_MLP_WIDTH = 768
JAX_MLP_ONESHOT_WIDE_SEQ = 64
JAX_MLP_ONESHOT_WIDE_WIDTH = 1024
JAX_MAX_TILED_MLP_WIDTH = 2048
JAX_MLP_CHUNK_WEIGHT_BYTES = 2 * _MIB
JAX_MLP_REGRID_BUDGET = 26 * _MIB
JAX_MLP_REGRID_TILE_CAP = 2
JAX_HEAD_CHUNK_BUDGET = 24 * _MIB
JAX_MLP_BWD_CHUNK_BUDGET = 10 * _MIB


def _rup(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def fits_fused(seq: int, width: int) -> bool:
    """#1's shapes in the JAX towers (fused_block.py:460)."""
    if width % 128:
        return False
    if width <= JAX_MAX_FUSED_WIDTH and seq <= JAX_MAX_FUSED_SEQ:
        return True
    return width <= JAX_ONESHOT_ATTN_WIDE_WIDTH and seq <= JAX_ONESHOT_ATTN_WIDE_SEQ


def fits_fused_wide(seq: int, width: int) -> bool:
    """#7's shapes (fused_block.py:484): 1024 < W <= 2048, S <= 640."""
    return (width % 128 == 0 and JAX_MAX_FUSED_WIDTH < width <= JAX_MAX_WIDE_WIDTH
            and seq <= JAX_MAX_FUSED_SEQ)


def fits_fused_mlp(seq: int, width: int) -> bool:
    """#2's classic shapes (fused_block.py:738)."""
    return width % 128 == 0 and width <= JAX_MAX_FUSED_MLP_WIDTH and seq <= JAX_MAX_FUSED_SEQ


def fits_fused_mlp_oneshot(seq: int, width: int) -> bool:
    """#2's shapes, with the wide short-sequence tier of RoBERTa-large
    (fused_block.py:744)."""
    if fits_fused_mlp(seq, width):
        return True
    return (width % 128 == 0 and seq <= JAX_MLP_ONESHOT_WIDE_SEQ
            and width <= JAX_MLP_ONESHOT_WIDE_WIDTH)


def mlp_oneshot_direct_ok(seq: int, width: int) -> bool:
    """#2 at sub-lane widths on a direct call (fused_block.py:756)."""
    if width % 128 == 0:
        return False
    return ((width <= JAX_MAX_FUSED_MLP_WIDTH and seq <= JAX_MAX_FUSED_SEQ)
            or (width <= JAX_MLP_ONESHOT_WIDE_WIDTH and seq <= JAX_MLP_ONESHOT_WIDE_SEQ))


def fits_fused_mlp_tiled(seq: int, width: int) -> bool:
    """#9/#10's shapes (fused_block.py:960): 768 < W <= 2048, S <= 640."""
    return (width % 128 == 0 and JAX_MAX_FUSED_MLP_WIDTH < width <= JAX_MAX_TILED_MLP_WIDTH
            and seq <= JAX_MAX_FUSED_SEQ)


def mlp_chunk_size(width: int, inter: int, esize: int = 2):
    """The intermediate chunk of #9/#10 (fused_block.py:966): the largest
    divisor of ``inter`` that is a multiple of 256 with a weight tile of at
    most 2 MiB; None where there is none."""
    for k in range(inter // 256, 0, -1):
        c = k * 256
        if inter % c == 0 and width * c * esize <= JAX_MLP_CHUNK_WEIGHT_BYTES:
            return c
    return None


def mlp_batch_tile(b: int, seq: int, width: int, inter: int, chunk: int,
                   esize: int = 2) -> int:
    """The batch tile of #10 (fused_block.py:1079); 1 means #9."""
    weights = 2 * width * chunk * esize
    per_sample = seq * width * (2 * esize + 4) + seq * chunk * 4
    t = max(1, (JAX_MLP_REGRID_BUDGET - weights) // per_sample)
    t = min(t, JAX_MLP_REGRID_TILE_CAP)
    while t > 1 and b % t:
        t -= 1
    return int(t)


def fused_mlp_routable(b: int, seq: int, width: int, inter: int, esize: int = 2) -> bool:
    """Whether the JAX towers route a fused MLP kernel at this shape
    (fused_block.py:977): one-shot widths always, wider ones where #10's
    tile exceeds 1."""
    if fits_fused_mlp(seq, width):
        return True
    if not fits_fused_mlp_tiled(seq, width):
        return False
    chunk = mlp_chunk_size(width, inter, esize)
    return chunk is not None and mlp_batch_tile(b, seq, width, inter, chunk, esize) > 1


# #21's VMEM estimate in the JAX package (nans_clip_tpu/ops/layer_bwd.py:45-
# 60, fused_block_bwd.py:600-608 and :868-874) against its budget,
# LAYER_FULLGRAD_BUDGET (nans_clip_tpu/ops/gates.py:162), copied: it decides
# where the JAX tower may take the whole-layer backward.
JAX_LAYER_FULLGRAD_BUDGET = 96 * _MIB


def fits_layer_bwd_fullgrad(seq: int, width: int, heads: int, inter: int,
                            esize: int = 2) -> bool:
    """#21's shapes in the JAX package (layer_bwd.py:56)."""
    sp = _rup(seq, 8)
    attn = ((4 * width * width) * (esize + 4) + sp * 3 * width * 8 + heads * sp * seq * 4
            + sp * width * 24 + sp * width * 2 * esize * 2)
    mlp_resident = 2 * width * inter * esize + 2 * width * inter * 4
    mlp_per = (sp * inter * 4 * 3 + sp * width * 4 * 4
               + sp * (5 * width + 2 * inter) * esize * 2)
    shared_io = sp * width * 2 * esize
    return attn + mlp_resident + mlp_per - shared_io < JAX_LAYER_FULLGRAD_BUDGET


def attn_bwd_head_chunk(seq: int, width: int, heads: int):
    """#20's heads a chunk (fused_block_bwd.py:1234), or None."""
    dh = width // heads
    for hpc in (8, 4, 2, 1):
        if heads % hpc:
            continue
        weights = hpc * width * 3 * dh * 2 + hpc * dh * width * 2
        probs = 2 * _rup(seq, 8) * seq * 4 * max(1, hpc // 2)
        acts = _rup(seq, 8) * (width * 16 + 3 * hpc * dh * 8)
        if weights + probs + acts < JAX_HEAD_CHUNK_BUDGET:
            return hpc
    return None


def mlp_bwd_chunk_tile(b: int, seq: int, width: int, inter: int):
    """#19's (chunk, batch tile) (fused_block_bwd.py:1063), or None."""
    if width % 128:
        return None
    for c in (1024, 512, 256):
        if inter % c:
            continue
        weights = 4 * width * c * 2
        per_sample = seq * (width * 12 + c * (4 + 12))
        t = (JAX_MLP_BWD_CHUNK_BUDGET - weights) // per_sample
        while t > 1 and b % t:
            t -= 1
        if t >= 2:
            return c, int(t)
    return None
