"""The whole encoder tower in one launch, and its kernel ``csrc/tower.cu``.

Ports of ``nans_clip_tpu/ops/tower_kernel.py::_tower_kernel`` (:36, bf16
weights), ``::_tower_kernel_q`` (:67, int8 weights with fp32 scales per
output channel) and ``::_tower_kernel_q_dma`` (:104, the same function with
each layer's int8 weights dequantized one layer ahead; ``quant_dma=True``):
all L layers of ``encoder_layer_math`` for a serving batch (1-32), in the
pre-LN quick-GELU form (ViT) or the post-LN erf-GELU form with an additive
``[B, S]`` key bias (BERT), at heads of 64 or 80 (``gates.fits_tower``).

``layers`` is a sequence of per-layer tuples in ``encoder_layer_math``'s
order, ``(ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b, w1, b1, w2,
b2)``, weights in the torch Linear layout ``[out, in]``; the four weights of
every layer are either all bf16 tensors or all :class:`Int8Weight`.

The kernel reads each layer's tensors where the modules keep them, through
a device table of pointers (:class:`TowerTable`, 16 pointers a layer: 1.5 KB
for 12 layers) and, for its GEMM stages' TMA loads, a device array of the
weights' tensor maps (4 a layer, 128 bytes each, encoded by
``nans_tower_maps``). A model holds one table per tower; it is rebuilt, and
the layers are checked again, when a source tensor's address changes, and
it keeps its sources alive meanwhile. No weight is copied or stacked.

``tower_math`` is the plain twin: ``encoder_layer_math`` looped over the
layers, the output in the io dtype after each layer
(``tower_kernel.py:57``); int8 weights are first dequantized to the io
dtype as ``tower_kernel.py:89-90`` does; it is the twin of the
dequant-ahead instance too, which computes #5's function. :func:`fused_tower`
runs the twin for CPU tensors and launches the kernel for CUDA tensors (or
raises). It counts bf16 launches in ``fused_tower.launches``, int8 launches
in ``fused_tower.launches_int8`` and dequant-ahead launches in
``fused_tower.launches_qdma``. As in the JAX package, no model path asks for
``quant_dma``: only direct calls launch #6.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from nans_clip_tpu_torch.ops import _build, gates
from nans_clip_tpu_torch.ops.layer_kernel import encoder_layer_math
from nans_clip_tpu_torch.utils.quantize import dequantize_weight, is_quantized

_ACT_CODES = {"quick_gelu": 1, "gelu": 2}
_WEIGHTS = (2, 4, 8, 10)  # positions of w_qkv, w_o, w1, w2 in a layer tuple
MAX_SPLITS = 8            # tower.cu's kMaxSplits
MIN_KSTEPS_PER_SPLIT = 2  # each K-split streams at least 2 x 64 of K
CHUNK = 64                # tokens a wgmma (its N)
MAX_STAGES = 6            # tower.cu's kMaxStages
RING_BYTES = {False: 96 * 1024, True: 80 * 1024}   # bf16 / int8 W (kRingBf16, kRingInt8)
BOX = CHUNK * gates.TOWER_KSTEP * 2                 # a bf16 box of 64 rows x 64
HANDOVER = (0, 2)   # the products (qkv, fc1) whose K-splits split 0 adds in the stage


def tower_math(x: torch.Tensor, key_bias: Optional[torch.Tensor], layers: Sequence[tuple],
               heads: int, eps: float, act: str, post_ln: bool) -> torch.Tensor:
    """Plain-torch twin. x: [B, S, W]; key_bias: [B, S] fp32 or None."""
    for p in layers:
        p = tuple(dequantize_weight(t, x.dtype) if is_quantized(t) else t for t in p)
        x = encoder_layer_math(x, *p, heads, eps, act, post_ln, key_bias).to(x.dtype)
    return x


class TowerTable:
    """The device table of per-layer pointers, cached on the addresses of
    its sources (which it keeps alive, so an address is not reused while
    the table holds it)."""

    def __init__(self):
        self._key = None
        self._sources = None
        self._table = None
        self._maps = None

    def __deepcopy__(self, memo):
        return TowerTable()

    def get(self, layers: Sequence[tuple], width: int, device):
        """(the pointer table, the weights' tensor maps) for ``layers``,
        checked by :func:`_admit_layers` when they are (re)built."""
        flat = []
        for p in layers:
            ts = [t.int8 if is_quantized(t) else t for t in p]
            scales = [p[i].scale if is_quantized(p[i]) else None for i in _WEIGHTS]
            flat.extend(ts + scales)
        key = tuple(0 if t is None else t.data_ptr() for t in flat)
        if key != self._key:
            _admit_layers(layers, width)
            table = torch.tensor(key, dtype=torch.int64)
            maps = torch.empty(len(layers) * 4 * 128, dtype=torch.uint8)
            with torch.cuda.device(device):
                _build.check(_build.library().nans_tower_maps(
                    table.data_ptr(), len(layers), width, layers[0][8].shape[0],
                    int(is_quantized(layers[0][2])), maps.data_ptr()), "nans_tower_maps")
            self._table, self._maps = table.to(device), maps.to(device)
            self._sources, self._key = flat, key
        return self._table, self._maps


# tower.cu's instances: bf16 weights (#4), int8 (#5), int8 dequantized a
# layer ahead (#6)
MODE_BF16, MODE_INT8, MODE_QDMA = 0, 1, 2


@functools.lru_cache(maxsize=None)
def max_grid(device_index: int, mode: int, seq: int, dh: int = 64) -> int:
    """The largest co-resident grid of tower.cu's instance ``mode`` (a
    ``MODE_*``; False / True are bf16 / int8) at head dim ``dh`` on the
    device (blocks a multiprocessor at its shared memory for ``seq`` and its
    registers, times the SMs)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(_build.library().nans_tower_grid(int(mode), seq, dh, ctypes.byref(out)),
                     "nans_tower_grid")
    return out.value


def tower_plan(mode: int, b: int, s: int, w: int, inter: int, dh: int, grid: int) -> dict:
    """tower.cu's launch plan, as ``nans_tower_plan`` computes it. M = B S
    is cut into the fewest even token ``ranges`` of one chunk of 64 tokens
    where the largest product's tiles then fit the grid in one round (the
    most units, the fewest K-splits), else of at most
    ``gates.TOWER_MAX_CHUNKS`` ``chunks`` (a unit's accumulators, one wgmma
    m64n64 a chunk); the ring holds as many 64-deep ``stages`` of
    a W box and ``chunks`` token boxes as its bytes allow; each product
    (qkv, out, fc1, fc2: ``products`` of (N, K)) has ``N / 64 * ranges``
    tiles, each in ``ks`` K-splits: as many as fill the grid once, or half
    of it for the products in HANDOVER (qkv, fc1: split 0 of a tile waits
    for the others' partial sums and adds them; out and fc2 leave that to
    the row stage after them), never a second round of units, each at least
    MIN_KSTEPS_PER_SPLIT stages, at most MAX_SPLITS;
    ``part``: the fp32 partial sums of the split products; ``sem``: the
    barrier and a counter for each tile of the largest;
    ``smem``: the block's dynamic shared memory (:func:`tower_smem`)."""
    m = b * s
    tile_n, kstep = gates.TOWER_TILE, gates.TOWER_KSTEP
    most = 1 if max(3 * w, inter) // tile_n * -(-m // CHUNK) <= grid else gates.TOWER_MAX_CHUNKS
    ranges = -(-m // (most * CHUNK))
    chunks = -(-(-(-m // ranges)) // CHUNK)
    quant = mode == MODE_INT8
    slot = (tile_n * kstep if quant else BOX) + chunks * BOX
    products = ((3 * w, w), (w, w), (inter, w), (w, inter))
    ks, tiles = [], []
    for i, (n, k) in enumerate(products):
        tiles.append(n // tile_n * ranges)
        cap = max(1, min(MAX_SPLITS, k // kstep // MIN_KSTEPS_PER_SPLIT))
        fill = (grid // 2 if i in HANDOVER else grid) // tiles[-1]
        ks.append(max(1, min(cap, fill)))
    part = max([1] + [kk * m * n for kk, (n, _) in zip(ks, products) if kk > 1])
    return dict(ranges=ranges, chunks=chunks, stages=min(MAX_STAGES, RING_BYTES[quant] // slot),
                ks=ks, tiles=tiles, products=products, part=part, sem=1 + max(tiles),
                smem=tower_smem(mode, s, dh))


def tower_smem(mode: int, s: int, dh: int) -> int:
    """tower.cu's dynamic shared memory: the attention stage's padded rows
    (a head's K and V of S rounded up to 16, a strip of Q, the key bias,
    each warp's row statistics and two partial outputs), or the GEMM
    stages' ring (with #5's two converted tiles) and 1 KB to align it."""
    s_pad, ldk = -(-s // 16) * 16, dh + 8
    attn = (16 + 2 * s_pad) * ldk * 2 + (s_pad + 4 * 16 * 2 + 2 * 16 * dh) * 4
    gemm = 1024 + (RING_BYTES[True] + 2 * BOX if mode == MODE_INT8 else RING_BYTES[False])
    return max(attn, gemm)


def stage_names(n_layers: int, post_ln: bool, quant_dma: bool = False) -> list:
    """The kernel's stages in order, one clock entry after each. The
    dequant-ahead instance adds a prologue that converts layer 0 (with the
    pre-LN form's first LayerNorm); each later layer's conversion runs in
    the attention and row stages of the layer before it."""
    layer = ["qkv GEMM", "attention", "out GEMM", "out rows", "fc1 GEMM", "fc2 GEMM",
             "fc2 rows"]
    if quant_dma:
        first = ["dequant layer 0" if post_ln else "LN1 rows + dequant layer 0"]
    else:
        first = [] if post_ln else ["LN1 rows"]
    return first + layer * n_layers


def _admit_layers(layers: Sequence[tuple], w: int) -> None:
    quant = is_quantized(layers[0][2])
    inter = layers[0][8].shape[0]
    for p in layers:
        gates.admit(len(p) == 12, "tower: a layer is 12 tensors")
        gates.admit(all(is_quantized(p[i]) == quant for i in _WEIGHTS),
                    "tower: the four weights of every layer are all int8 or all bf16")
        shapes = ((3 * w, w), (w, w), (inter, w), (w, inter))
        for i, shape in zip(_WEIGHTS, shapes):
            t = p[i]
            gates.admit(tuple(t.shape) == shape, f"tower: weight {i} {tuple(t.shape)} != {shape}")
            if quant:
                gates.admit(t.int8.is_cuda and t.int8.is_contiguous()
                            and t.int8.data_ptr() % 16 == 0
                            and t.scale.dtype == torch.float32 and t.scale.is_contiguous()
                            and t.scale.numel() == shape[0],
                            "tower: int8 weights contiguous and 16-byte aligned on CUDA, fp32 "
                            "scales [out, 1]")
        gates.admit_cuda("tower", *(t for i, t in enumerate(p) if i not in _WEIGHTS))
        if not quant:
            gates.admit_cuda("tower", *(p[i] for i in _WEIGHTS))


def _admit(x, key_bias, layers, heads, act) -> bool:
    """Checks of the call's own inputs; the layers are checked when their
    pointer table is built."""
    b, s, w = x.shape
    quant = is_quantized(layers[0][2])
    gates.admit(gates.fits_tower(s, w, heads, layers[0][8].shape[0]),
                f"tower: S={s} W={w} heads={heads} I={layers[0][8].shape[0]}")
    gates.admit(act in _ACT_CODES, f"tower: activation {act!r}")
    gates.admit_cuda("tower", x)
    if key_bias is not None:
        gates.admit(key_bias.is_cuda and key_bias.dtype == torch.float32
                    and key_bias.is_contiguous() and key_bias.numel() == b * s,
                    "tower: key_bias must be contiguous fp32 [B, S] on CUDA")
    return quant


def _admit_qdma(x: torch.Tensor, layers: Sequence[tuple]) -> bool:
    """True when ``quant_dma`` applies (int8 weights: bf16 weights run #4, as
    JAX's ``if quant and quant_dma``, tower_kernel.py:298); raises, on every
    device as the JAX assertion does (:304-306), at a width where the
    dequant-ahead tower does not exist."""
    if not is_quantized(layers[0][2]):
        return False
    b, s, w = x.shape
    gates.admit(gates.fits_tower_qdma(w),
                f"qdma cell does not exist at b={b} s={s} w={w} (the dequant-ahead tower takes "
                f"W a multiple of 128 up to {gates.TOWER_QDMA_MAX_WIDTH}, as JAX "
                "tower_qdma_tile)")
    return True


def fused_tower(x: torch.Tensor, key_bias: Optional[torch.Tensor], layers: Sequence[tuple],
                heads: int, eps: float, act: str, post_ln: bool,
                table: Optional[TowerTable] = None, grid: Optional[int] = None,
                clock: Optional[torch.Tensor] = None, quant_dma: bool = False) -> torch.Tensor:
    """All layers of the encoder on x [B, S, W]; returns a new tensor.
    ``table`` caches the pointer table between calls (a fresh one is built
    otherwise); ``grid`` overrides the co-resident grid (a larger one is
    refused by the cooperative launch and raises); ``clock``, an int64
    tensor on the card of ``len(stage_names(L, post_ln, quant_dma)) + 1``
    entries, receives the device time (ns) at the start and after each
    stage. ``quant_dma`` with int8 weights runs the dequant-ahead instance
    (#6), with bf16 weights #4. While a program is exported it is the
    operator ``nans_clip::tower`` (``ops/library.py``), which builds the
    table itself."""
    if torch.compiler.is_exporting():
        gates.admit(grid is None and clock is None and not quant_dma,
                    "tower: an exported forward takes no grid, clock or quant_dma")
        from nans_clip_tpu_torch.ops import library
        return library.tower(x, key_bias, layers, heads, eps, act, post_ln)
    ahead = quant_dma and _admit_qdma(x, layers)
    if not x.is_cuda:
        return tower_math(x, key_bias, layers, heads, eps, act, post_ln)
    quant = _admit(x, key_bias, layers, heads, act)
    if ahead:
        gates.admit(x.shape[2] == heads * gates.TOWER_QDMA_HEAD_DIM,
                    f"tower quant_dma: heads of {gates.TOWER_QDMA_HEAD_DIM} only")
    mode = MODE_QDMA if ahead else MODE_INT8 if quant else MODE_BF16
    b, s, w = x.shape
    m, inter, n_layers = b * s, layers[0][8].shape[0], len(layers)
    dh = w // heads
    dev = x.device
    if grid is None:
        grid = max_grid(dev.index if dev.index is not None else torch.cuda.current_device(),
                        mode, s, dh)
        gates.admit(grid >= 1, f"tower: no block of the kernel fits a multiprocessor at S={s}")
    plan = tower_plan(mode, b, s, w, inter, dh, grid)
    out = x.contiguous().clone()
    work = torch.empty(m * (6 * w + inter), dtype=x.dtype, device=dev)
    sums = torch.empty(m * w, dtype=torch.float32, device=dev)
    part = torch.empty(plan["part"], dtype=torch.float32, device=dev)
    wbuf = (torch.empty(2 * (4 * w * w + 2 * w * inter), dtype=x.dtype, device=dev)
            if ahead else None)
    sem = torch.zeros(plan["sem"], dtype=torch.int32, device=dev)
    if clock is not None:
        gates.admit(clock.is_cuda and clock.dtype == torch.int64
                    and clock.numel() >= len(stage_names(n_layers, post_ln, ahead)) + 1,
                    "tower: clock must be int64 on CUDA with room for every stage")
    ptrs, maps = (table or TowerTable()).get(layers, w, dev)
    err = _build.library().nans_tower(
        out.data_ptr(), None if key_bias is None else key_bias.data_ptr(), ptrs.data_ptr(),
        None if ahead else maps.data_ptr(), work.data_ptr(), sums.data_ptr(), part.data_ptr(),
        None if wbuf is None else wbuf.data_ptr(), sem.data_ptr(),
        None if clock is None else clock.data_ptr(), b, s, w, inter, n_layers, dh, float(eps),
        1.0 / math.sqrt(dh), _ACT_CODES[act], int(post_ln), mode, *plan["ks"], grid,
        _build.stream_ptr(dev))
    _build.check(err, "nans_tower")
    if ahead:
        fused_tower.launches_qdma += 1
    elif quant:
        fused_tower.launches_int8 += 1
    else:
        fused_tower.launches += 1
    return out


fused_tower.launches = 0
fused_tower.launches_int8 = 0
fused_tower.launches_qdma = 0
