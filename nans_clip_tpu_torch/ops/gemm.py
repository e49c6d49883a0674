"""Linear layers with fused epilogues and their backward products, and their
kernel ``csrc/gemm.cu``.

``linear`` computes ``A . W^T`` with bf16 inputs and fp32 accumulation,
then, in fp32, ``+ bias``, an optional activation, an optional hidden
dropout and an optional ``+ residual``, and stores bf16 (or fp32 where a
post-LN follows). These are the matrix products inside
``nans_clip_tpu/ops/fused_block.py::_kernel`` (QKV :120, out-projection
:185-191) and ``::_mlp_kernel`` (fc1 :809, fc2 :816-828), with their
rounding points. ``W`` is the torch Linear layout ``[out, in]``.

The backward products of ``nans_clip_tpu/ops/fused_block_bwd.py``:
``linear_dgrad`` is ``dY . W`` (the input gradient, optionally times
``act'(h_pre)``, plus a residual gradient) and ``linear_wgrad`` is ``dY^T .
X`` (the weight gradient, fp32, ``[out, in]``), K-split with its slices
summed in a fixed order (``ops/reduce.py``).

On the card all three run ``csrc/gemm.cu``'s one design: wgmma over a
TMA-fed ring of 4 stages, persistent 128 x 256 x 64 tiles in clusters of two
that share one operand's boxes (W, or the weight gradient's X). Their launch
plans are :func:`gemm_plan`, :func:`dgrad_plan` and :func:`wgrad_plan`.

The ``*_plain`` functions are the twins; CPU tensors take them.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from nans_clip_tpu_torch.ops import _build, dropout as drop, gates
from nans_clip_tpu_torch.ops.activations import ACT2FN, ACT_GRAD, plain_dtype, upcast
from nans_clip_tpu_torch.ops.reduce import column_sum

_ACT_CODES = {None: 0, "quick_gelu": 1, "gelu": 2}

# csrc/gemm.cu's design, the same for its three forms: the block tile (BM,
# BN, BK), the ring's stages, the block's threads (two consumer warpgroups of
# 64 rows and a producer warpgroup), and the CTAs of a cluster, which share
# each W (or X) box by multicast. The backward forms read an operand whose
# contraction runs along its rows in boxes of BWD_BOX columns x BK rows.
# Set by the kernel's design. The plans are cached: callers only read them.
TILE = (128, 256, 64)
STAGES = 4
THREADS = 384
CLUSTER = 2
BWD_BOX = 64
# How many clusters of two the card holds at once (132 SMs, one block an
# SM): the default of the plans, and the count wgrad_splits fills.
CO_RESIDENT_CLUSTERS = 66
# The weight gradient's K-split is taken in slices of whole 32-row k-tiles.
WGRAD_KTILE = 32
# H100 SXM data sheet: dense bf16 tensor-core peak and HBM bandwidth, the
# rates of wgrad_splits' model
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _ring_smem(bias_copies: bool) -> int:
    """Bytes of shared memory a block: the ring, its full and empty barriers,
    the slack that aligns it to 1024 bytes, and (the forward) a copy of the
    tile's bias a consumer warp."""
    bm, bn, bk = TILE
    return (STAGES * (bm + bn) * bk * 2 + 2 * STAGES * 8 + 1024
            + (8 * bn * 2 if bias_copies else 0))


def _pairs_plan(m: int, n_out: int, k: int, clusters: int) -> dict:
    """The walk of the forward form and the input gradient: a work unit is
    ``CLUSTER`` M tiles of one N tile."""
    bm, bn, bk = TILE
    tiles_m, tiles_n = -(-m // bm), -(-n_out // bn)
    units = tiles_n * -(-tiles_m // CLUSTER)
    return dict(tile=TILE, stages=STAGES, threads=THREADS, cluster=CLUSTER,
                tiles_m=tiles_m, tiles_n=tiles_n, units=units,
                grid=CLUSTER * min(units, clusters), k_steps=-(-k // bk))


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, n: int, k: int, clusters: int = CO_RESIDENT_CLUSTERS) -> dict:
    """The forward form's launch plan for ``[m, k] . [n, k]^T`` when the card
    holds ``clusters`` of its clusters at once, as ``nans_gemm_plan``
    computes it. A work unit is ``CLUSTER`` M tiles of one N tile: unit
    ``u`` is M tiles ``CLUSTER * (u // tiles_n) + r`` (CTA ``r`` of the
    cluster; a tile past ``tiles_m`` stores nothing) and N tile ``u %
    tiles_n``; cluster ``c`` of ``grid // CLUSTER`` persistent clusters
    takes units ``c``, ``c + grid // CLUSTER``, .... A tile is rows
    ``BM`` x columns ``BN``, clipped to ``m`` and ``n``, and runs ``k_steps``
    stages of the ring; the TMA boxes (innermost first) are ``box_a`` of A
    and ``box_w`` of W (each CTA loads its part of the W tile into both),
    zero-filled past the edges."""
    bm, bn, bk = TILE
    return dict(_pairs_plan(m, n, k, clusters), smem=_ring_smem(True), box_a=(bk, bm),
                box_w=(bk, bn // CLUSTER))


@functools.lru_cache(maxsize=None)
def dgrad_plan(m: int, n: int, k: int, clusters: int = CO_RESIDENT_CLUSTERS) -> dict:
    """The input gradient's launch plan for ``dy [m, n] . w [n, k]`` (output
    ``[m, k]``), as ``nans_gemm_dgrad_plan`` computes it: the forward's walk
    over output tiles (``tiles_n`` over ``k``), ``k_steps`` stages over the
    contraction ``n``. dY comes in ``box_a`` boxes (K-major, as the forward's
    A); W as it lies, ``boxes_b`` boxes of ``box_b`` a stage side by side
    along its columns (MN-major), each CTA loading ``boxes_b //
    CLUSTER`` of them into both."""
    bm, bn, bk = TILE
    return dict(_pairs_plan(m, k, n, clusters), smem=_ring_smem(False), box_a=(bk, bm),
                box_b=(BWD_BOX, bk), boxes_b=bn // BWD_BOX)


@functools.lru_cache(maxsize=None)
def wgrad_splits(m: int, n: int, k: int) -> int:
    """K-split of the weight gradient ``[n, k]`` over ``m`` rows: the count
    of slices (each at least 16 k-tiles, 512 rows, deep) that minimises a
    model of the kernel and its sum: waves of ``CO_RESIDENT_CLUSTERS``
    cluster units (two 128-row tiles of dW by one 256-column tile, over one
    slice), each wave as long as a slice at the tensor-core peak, plus
    ``column_sum``'s pass over the fp32 partials at the HBM rate. A function
    of the shape alone, so the summation order is fixed."""
    bm, bn, _ = TILE
    units = -(-n // (CLUSTER * bm)) * -(-k // bn)
    ktiles = -(-m // WGRAD_KTILE)
    ktile_s = 2 * WGRAD_KTILE * bm * bn / (BF16_FLOPS / (CO_RESIDENT_CLUSTERS * CLUSTER))
    best, best_s = None, 1
    for want in range(1, max(1, ktiles // 16) + 1):
        per = -(-ktiles // want)
        splits = -(-ktiles // per)
        t = -(-units * splits // CO_RESIDENT_CLUSTERS) * per * ktile_s
        if splits > 1:
            t += (splits + 1) * n * k * 4 / HBM_BYTES_PER_S
        if best is None or t < best:
            best, best_s = t, splits
    return best_s


@functools.lru_cache(maxsize=None)
def wgrad_plan(m: int, n: int, k: int, clusters: int = CO_RESIDENT_CLUSTERS) -> dict:
    """The weight gradient's launch plan for ``dy [m, n]^T . x [m, k]``, as
    ``nans_gemm_wgrad_plan`` computes it. The ``m`` rows are cut into
    ``splits`` slices of ``per`` k-tiles of 32 rows (``slices``: each one's
    [first, end) row); slice ``z`` runs ``slice_stages[z]`` stages of the ring from
    its first row, and ``last_steps[z]`` k16 steps in its last one (2 where
    the slice ends halfway through a 64-row stage). A work unit is
    ``CLUSTER`` 128-row tiles of dW (CTA ``r`` takes N tile
    ``CLUSTER * pair + r``; one past ``tiles_n`` stores nothing) by one
    256-column tile over one slice: unit ``u`` is pair ``u % pairs``, column
    tile ``u // pairs % tiles_k``, slice ``u // (pairs * tiles_k)``. Both
    operands come as they lie (MN-major) in ``box`` boxes: two of dY a CTA,
    four of X a stage, each CTA loading two into both."""
    bm, bn, bk = TILE
    ktiles = -(-m // WGRAD_KTILE)
    per = -(-ktiles // wgrad_splits(m, n, k))
    splits = -(-ktiles // per)
    tiles_n, tiles_k = n // bm, -(-k // bn)
    pairs = -(-tiles_n // CLUSTER)
    units = pairs * tiles_k * splits
    kts = [min(ktiles, (z + 1) * per) - z * per for z in range(splits)]
    return dict(tile=TILE, stages=STAGES, threads=THREADS, cluster=CLUSTER,
                smem=_ring_smem(False), splits=splits, per=per,
                slices=[(z * per * WGRAD_KTILE, min(m, (z + 1) * per * WGRAD_KTILE))
                        for z in range(splits)],
                slice_stages=[-(-t // 2) for t in kts],
                last_steps=[2 if t % 2 else 4 for t in kts],
                tiles_n=tiles_n, tiles_k=tiles_k, pairs=pairs, units=units,
                grid=CLUSTER * min(units, clusters), box=(BWD_BOX, bk))


def linear_plain(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                 act: Optional[str] = None, residual: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None,
                 dropout: Optional[drop.Dropout] = None, pre_out: bool = False):
    """Twin of the kernel: the product of the (possibly bf16) operands in
    fp32, the epilogue in fp32, one cast at the end. ``pre_out`` also
    returns the fp32 value before the activation. ``bias`` may be None."""
    y = F.linear(upcast(a), upcast(w), None if bias is None else upcast(bias))
    pre = y
    if act is not None:
        y = ACT2FN[act](y)
    if drop.active(dropout):
        y = y * drop.hidden_multiplier(dropout, y.numel() // y.shape[-1], y.shape[-1],
                                       y.device).view(y.shape).to(y.dtype)
    if residual is not None:
        y = y + upcast(residual)
    out = y.to(plain_dtype(out_dtype, a) or a.dtype)
    return (out, pre) if pre_out else out


def _launch(a, w, w_trans, bias, act, dact, aux, dropout, residual, out, c_pre, c2, n, k):
    seed, stream, thresh, scale, on, sample0 = drop.kernel_args(dropout)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.library().nans_gemm(
        a.data_ptr(), w.data_ptr(), int(w_trans), ptr(bias), _ACT_CODES[act], _ACT_CODES[dact],
        ptr(aux), seed, stream, thresh, scale, on, sample0, dropout.seq if on else 0,
        ptr(residual),
        int(residual is not None and residual.dtype == torch.float32), out.data_ptr(),
        int(out.dtype == torch.float32), ptr(c_pre), ptr(c2), a.numel() // k, n, k,
        _build.stream_ptr(a.device))
    _build.check(err, "nans_gemm")


def _admit_epilogue(name, m, n, residual=None, aux=None):
    if residual is not None:
        gates.admit(residual.is_cuda and residual.is_contiguous()
                    and residual.dtype in (gates.KERNEL_DTYPE, torch.float32)
                    and residual.numel() == m * n and residual.data_ptr() % 16 == 0,
                    f"{name}: residual must be contiguous 16-byte aligned bf16 or fp32 [M, N] "
                    "on CUDA")
    if aux is not None:
        gates.admit(aux.is_cuda and aux.is_contiguous() and aux.dtype == torch.float32
                    and aux.numel() == m * n, f"{name}: aux must be contiguous fp32 [M, N]")


def linear(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           act: Optional[str] = None, residual: Optional[torch.Tensor] = None,
           out_dtype: Optional[torch.dtype] = None,
           dropout: Optional[drop.Dropout] = None, pre_out: bool = False):
    """``a``: [..., K]; ``w``: [N, K]; ``bias``: [N] or None; ``residual``:
    [..., N] (bf16 or fp32). CPU tensors take :func:`linear_plain`; CUDA
    tensors launch the kernel (bf16 operands; output bf16 or fp32; N a
    multiple of ``gates.GEMM_FWD_N_MULTIPLE``, K of
    ``gates.GEMM_K_MULTIPLE``; launched as :func:`gemm_plan` says). While a
    program is exported it is the operator ``nans_clip::linear``
    (``ops/library.py``)."""
    if torch.compiler.is_exporting():
        gates.admit(not drop.active(dropout) and not pre_out,
                    "gemm: an exported forward takes no dropout and no pre-activation")
        from nans_clip_tpu_torch.ops import library
        return library.linear_op(a, w, bias, act, residual, out_dtype)
    if not a.is_cuda:
        return linear_plain(a, w, bias, act, residual, out_dtype, dropout, pre_out)
    n, k = w.shape
    gates.admit(a.shape[-1] == k, f"gemm: a {tuple(a.shape)} vs w {tuple(w.shape)}")
    gates.admit(n % gates.GEMM_FWD_N_MULTIPLE == 0 and k % gates.GEMM_K_MULTIPLE == 0,
                f"gemm: N={n} K={k}")
    out_dtype = out_dtype or a.dtype
    gates.admit(out_dtype in (gates.KERNEL_DTYPE, torch.float32), f"gemm: output {out_dtype}")
    gates.admit_cuda("gemm", a, w, *(() if bias is None else (bias,)))
    m = a.numel() // k
    _admit_epilogue("gemm", m, n, residual)
    plan = gemm_plan(m, n, k)
    gates.admit(plan["smem"] <= gates.SMEM_PER_BLOCK, f"gemm: plan {plan}")
    if drop.active(dropout):
        gates.admit(dropout.seq > 0 and m % dropout.seq == 0, "gemm: dropout needs seq | M")
    out = torch.empty((*a.shape[:-1], n), dtype=out_dtype, device=a.device)
    pre = torch.empty(out.shape, dtype=torch.float32, device=a.device) if pre_out else None
    _launch(a, w, False, bias, act, None, None, dropout, residual, out, pre, None, n, k)
    linear.launches += 1
    return (out, pre) if pre_out else out


def linear_dgrad_plain(dy: torch.Tensor, w: torch.Tensor, act: Optional[str] = None,
                       aux: Optional[torch.Tensor] = None,
                       residual: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None, copy: bool = False):
    """Twin of the input-gradient product: ``dY . W`` in fp32, times
    ``act'(aux)`` when ``aux`` (the fp32 pre-activation) is given, plus
    ``residual``; stored in ``out_dtype`` (default dY's). ``copy`` also
    returns the value before the residual in dY's dtype (the operand of the
    next products, or an emitted gradient)."""
    y = upcast(dy) @ upcast(w)
    if aux is not None:
        y = y * ACT_GRAD[act](aux)
    y2 = y.to(dy.dtype) if copy else None
    if residual is not None:
        y = y + upcast(residual)
    out = y.to(plain_dtype(out_dtype, dy) or dy.dtype)
    return (out, y2) if copy else out


def linear_dgrad(dy: torch.Tensor, w: torch.Tensor, act: Optional[str] = None,
                 aux: Optional[torch.Tensor] = None, residual: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None, copy: bool = False):
    """``dy``: [M, N]; ``w``: [N, K] (the forward's ``[out, in]`` weight);
    returns [M, K]. CPU tensors take :func:`linear_dgrad_plain`; CUDA
    tensors launch the kernel with ``w`` read as it lies (K a multiple of
    ``gates.GEMM_N_MULTIPLE``, N of ``gates.GEMM_K_MULTIPLE``; launched as
    :func:`dgrad_plan` says)."""
    if not dy.is_cuda:
        return linear_dgrad_plain(dy, w, act, aux, residual, out_dtype, copy)
    n, k = w.shape
    gates.admit(dy.dim() == 2 and dy.shape[1] == n, f"gemm dgrad: dy {tuple(dy.shape)} vs w "
                f"{tuple(w.shape)}")
    gates.admit(k % gates.GEMM_N_MULTIPLE == 0 and n % gates.GEMM_K_MULTIPLE == 0,
                f"gemm dgrad: N={k} K={n}")
    out_dtype = out_dtype or dy.dtype
    gates.admit(out_dtype in (gates.KERNEL_DTYPE, torch.float32),
                f"gemm dgrad: output {out_dtype}")
    gates.admit_cuda("gemm dgrad", dy, w)
    m = dy.shape[0]
    _admit_epilogue("gemm dgrad", m, k, residual, aux)
    gates.admit((aux is None) == (act is None), "gemm dgrad: act and aux go together")
    plan = dgrad_plan(m, n, k)
    gates.admit(plan["smem"] <= gates.SMEM_PER_BLOCK, "gemm dgrad: shared memory")
    out = torch.empty((m, k), dtype=out_dtype, device=dy.device)
    c2 = torch.empty((m, k), dtype=gates.KERNEL_DTYPE, device=dy.device) if copy else None
    _launch(dy, w, True, None, None, act, aux, None, residual, out, None, c2, k, n)
    linear_dgrad.launches += 1
    return (out, c2) if copy else out


def linear_wgrad_plain(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Twin of the weight-gradient product: ``dY^T . X`` in fp32."""
    return upcast(dy).T @ upcast(x)


def linear_wgrad(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``dy``: [M, N]; ``x``: [M, K]; returns fp32 [N, K] = dy^T . x (the
    ``[out, in]`` weight gradient). CPU tensors take
    :func:`linear_wgrad_plain`; CUDA tensors launch the kernel as
    :func:`wgrad_plan` says (N and K multiples of ``gates.GEMM_N_MULTIPLE``),
    then sum its K-split slices in order."""
    if not dy.is_cuda:
        return linear_wgrad_plain(dy, x)
    m, n = dy.shape
    k = x.shape[-1]
    gates.admit(x.dim() == 2 and x.shape[0] == m, f"gemm wgrad: dy {tuple(dy.shape)} vs x "
                f"{tuple(x.shape)}")
    gates.admit(n % gates.GEMM_N_MULTIPLE == 0 and k % gates.GEMM_N_MULTIPLE == 0,
                f"gemm wgrad: N={n} K={k}")
    gates.admit_cuda("gemm wgrad", dy, x)
    plan = wgrad_plan(m, n, k)
    gates.admit(plan["smem"] <= gates.SMEM_PER_BLOCK, "gemm wgrad: shared memory")
    splits = plan["splits"]
    part = torch.empty((splits, n, k), dtype=torch.float32, device=dy.device)
    err = _build.library().nans_gemm_wgrad(dy.data_ptr(), x.data_ptr(), part.data_ptr(), m, n,
                                           k, splits, plan["per"],
                                           _build.stream_ptr(dy.device))
    _build.check(err, "nans_gemm_wgrad")
    linear_wgrad.launches += 1
    return part[0] if splits == 1 else column_sum(part.view(splits, n * k)).view(n, k)


linear.launches = 0
linear_dgrad.launches = 0
linear_wgrad.launches = 0
