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
for 12 layers). A model holds one table per tower; it is rebuilt, and the
layers are checked again, when a source tensor's address changes, and it
keeps its sources alive meanwhile. No weight is copied or stacked.

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
BM = 64                   # tower.cu's GEMM rows per tile
MAX_SPLITS = 8            # tower.cu's kMaxSplits
MIN_KSTEPS_PER_SPLIT = 2  # each K-split streams at least 2 x 64 of K


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

    def __deepcopy__(self, memo):
        return TowerTable()

    def get(self, layers: Sequence[tuple], width: int, device) -> torch.Tensor:
        """The table for ``layers``, checked by :func:`_admit_layers` when
        it is (re)built."""
        flat = []
        for p in layers:
            ts = [t.int8 if is_quantized(t) else t for t in p]
            scales = [p[i].scale if is_quantized(p[i]) else None for i in _WEIGHTS]
            flat.extend(ts + scales)
        key = tuple(0 if t is None else t.data_ptr() for t in flat)
        if key != self._key:
            _admit_layers(layers, width)
            self._table = torch.tensor(key, dtype=torch.int64).to(device)
            self._sources, self._key = flat, key
        return self._table


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


def k_splits(m: int, n: int, k: int, grid: int) -> int:
    """K-splits of one product: as many (m-tile, n-tile, split) units as the
    grid has blocks, never more (a second round of units would double the
    stage), each split at least MIN_KSTEPS_PER_SPLIT steps of the kernel's
    64-wide K."""
    units = math.ceil(m / BM) * (n // gates.TOWER_TILE)
    cap = max(1, min(MAX_SPLITS, k // gates.TOWER_KSTEP // MIN_KSTEPS_PER_SPLIT))
    return max(1, min(cap, grid // units))


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
    (#6), with bf16 weights #4."""
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
    products = ((3 * w, w), (w, w), (inter, w), (w, inter))
    ks = [k_splits(m, n, k, grid) for n, k in products]
    out = x.contiguous().clone()
    work = torch.empty(m * (6 * w + inter), dtype=x.dtype, device=dev)
    sums = torch.empty(m * w, dtype=torch.float32, device=dev)
    part = torch.empty(max([1] + [kk * m * n for kk, (n, _) in zip(ks, products) if kk > 1]),
                       dtype=torch.float32, device=dev)
    wbuf = (torch.empty(2 * (4 * w * w + 2 * w * inter), dtype=x.dtype, device=dev)
            if ahead else None)
    tiles = math.ceil(m / BM) * max(n for n, _ in products) // gates.TOWER_TILE
    sem = torch.zeros(1 + tiles, dtype=torch.int32, device=dev)
    if clock is not None:
        gates.admit(clock.is_cuda and clock.dtype == torch.int64
                    and clock.numel() >= len(stage_names(n_layers, post_ln, ahead)) + 1,
                    "tower: clock must be int64 on CUDA with room for every stage")
    ptrs = (table or TowerTable()).get(layers, w, dev)
    err = _build.library().nans_tower(
        out.data_ptr(), None if key_bias is None else key_bias.data_ptr(), ptrs.data_ptr(),
        work.data_ptr(), sums.data_ptr(), part.data_ptr(),
        None if wbuf is None else wbuf.data_ptr(), sem.data_ptr(),
        None if clock is None else clock.data_ptr(), b, s, w, inter, n_layers, dh, float(eps),
        1.0 / math.sqrt(dh), _ACT_CODES[act], int(post_ln), mode, *ks, grid,
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
