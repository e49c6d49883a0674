"""LayerNorm with fp32 statistics, and its kernel ``csrc/layernorm.cu``.

``layer_norm`` is the plain version (counterpart of
``nans_clip_tpu/ops/layernorm.py::layer_norm``): the towers call it where
the JAX package left LayerNorm to XLA (``ln_pre``, ``ln_post``, the BERT
embedding LN), and it is the twin of the kernel.

``row_layer_norm`` launches ``layernorm.cu`` for CUDA tensors: the LN
stages inside the ported sub-block kernels (pre-LN prologue, post-LN
epilogue on the fp32 residual sum). It replaces the ``_ln`` stages of
``nans_clip_tpu/ops/fused_block.py::_kernel`` and ``::_mlp_kernel`` (and of
the wide kernels, rows up to ``gates.MAX_LN_WIDTH`` = 2048: above 1024 each
row takes a block of its own).

``pallas_layer_norm`` is the counterpart of
``nans_clip_tpu/ops/layernorm.py::pallas_layer_norm`` (#24, ``_ln_kernel``
:32, ``pallas_call`` :53), the forward-only fused LayerNorm that the JAX
package calls directly (no tower routes it): the same ``layernorm.cu``
forward on CUDA tensors, ``layer_norm`` on CPU tensors.

``layer_norm_bwd`` (twin ``layer_norm_bwd_plain``) is the LayerNorm
backward of ``nans_clip_tpu/ops/fused_block_bwd.py`` (``_ln_bwd`` :101 and
the pre-LN dx of :208-212, :773-777) with its dgamma/dbeta sums, launching
the backward kernel of ``layernorm.cu`` for CUDA tensors (a persistent
grid, :func:`layernorm_bwd_plan`). For the backward kernels that emit their
activations it can also return x-hat in the io dtype (``emit_xhat``) and
leave the sums out (``sums=False``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from nans_clip_tpu_torch.ops import _build, dropout as drop, gates
from nans_clip_tpu_torch.ops.activations import plain_dtype, upcast
from nans_clip_tpu_torch.ops.reduce import column_sum


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Mean, then mean of squared deviations, both in fp32; the result is
    cast to ``out_dtype`` (default: the dtype of ``x``)."""
    xf = upcast(x)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * upcast(weight) + upcast(bias)
    return y.to(out_dtype or x.dtype)


def row_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over the last axis. CPU tensors take :func:`layer_norm`;
    CUDA tensors launch the kernel: ``x`` bf16 or fp32, params and output
    bf16. While a program is exported it is the operator
    ``nans_clip::layer_norm`` (``ops/library.py``)."""
    if torch.compiler.is_exporting():
        from nans_clip_tpu_torch.ops import library
        return library.layer_norm_op(x, weight, bias, eps, out_dtype)
    if not x.is_cuda:
        return layer_norm(x, weight, bias, eps, out_dtype)
    width = x.shape[-1]
    gates.admit(x.is_contiguous() and x.dtype in (torch.float32, gates.KERNEL_DTYPE),
                "layernorm: x must be contiguous bf16 or fp32")
    gates.admit(width % gates.LN_WIDTH_MULTIPLE == 0 and width <= gates.MAX_LN_WIDTH,
                f"layernorm: width {width}")
    gates.admit((out_dtype or gates.KERNEL_DTYPE) == gates.KERNEL_DTYPE,
                "layernorm: output is bf16")
    gates.admit_cuda("layernorm", weight, bias)
    y = torch.empty(x.shape, dtype=gates.KERNEL_DTYPE, device=x.device)
    rows = x.numel() // width
    err = _build.library().nans_layernorm(
        x.data_ptr(), int(x.dtype == torch.float32), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), rows, width, float(eps), _build.stream_ptr(x.device))
    _build.check(err, "nans_layernorm")
    row_layer_norm.launches += 1
    return y


def pallas_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5, block_rows: int = 256) -> torch.Tensor:
    """#24: LayerNorm over the last axis with fp32 statistics, in x's dtype.
    CPU tensors take :func:`layer_norm`; CUDA tensors launch
    ``layernorm.cu``'s forward (bf16 x, scale and bias; rows of width <=
    ``gates.MAX_LN_WIDTH``, a multiple of ``gates.LN_WIDTH_MULTIPLE``; a
    warp a row up to 1024, a block a row above) and raise on anything
    else. ``block_rows`` is the JAX kernel's rows a grid cell; the card's
    kernel takes a row a warp or a block, so it changes no arithmetic."""
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    if not x.is_cuda:
        return layer_norm(x, scale, bias, eps)
    width = x.shape[-1]
    gates.admit(width % gates.LN_WIDTH_MULTIPLE == 0 and width <= gates.MAX_LN_WIDTH,
                f"pallas_layer_norm: width {width}")
    gates.admit_cuda("pallas_layer_norm", x, scale, bias)
    y = torch.empty_like(x)
    err = _build.library().nans_layernorm(
        x.data_ptr(), 0, scale.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel() // width,
        width, float(eps), _build.stream_ptr(x.device))
    _build.check(err, "nans_layernorm")
    pallas_layer_norm.launches += 1
    return y


def layer_norm_bwd_plain(gin: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, eps: float,
                         residual: Optional[torch.Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None, emit_dproj: bool = False,
                         dropout: Optional[drop.Dropout] = None, emit_xhat: bool = False,
                         sums: bool = True):
    """Backward of ``layer_norm`` with respect to its input ``x`` for the
    output gradient ``gin``, in fp32 with x-hat and rstd recomputed as the
    forward forms them: ``dx = rstd (gh - mean(gh) - xhat mean(gh xhat))``,
    ``gh = gin * weight``, plus ``residual``. Returns ``(dx, dweight,
    dbias, dproj, dproj_sum)``: ``dweight = sum gin * xhat`` and ``dbias =
    sum gin`` over the rows, fp32; with ``emit_dproj``, ``dproj`` is ``dx *
    keep`` (before the residual; keep the hidden dropout multiplier, or 1)
    in gin's dtype and ``dproj_sum`` its fp32 column sum, else both None.
    ``sums=False`` returns None for the three sums; ``emit_xhat`` appends
    x-hat (in the dtype of ``dproj``: the io dtype) as a sixth value."""
    w = x.shape[-1]
    xf, g = upcast(x).reshape(-1, w), upcast(gin).reshape(-1, w)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    gh = g * upcast(weight)
    d = rstd * (gh - gh.mean(dim=-1, keepdim=True)
                - xhat * (gh * xhat).mean(dim=-1, keepdim=True))
    dproj = dproj_sum = None
    if emit_dproj:
        dm = d
        if drop.active(dropout):
            dm = d * drop.hidden_multiplier(dropout, d.shape[0], w, d.device).to(d.dtype)
        dproj, dproj_sum = dm.to(gin.dtype), dm.sum(dim=0)
    if residual is not None:
        d = d + upcast(residual).reshape(-1, w)
    dx = d.to(plain_dtype(out_dtype, gin) or gin.dtype).view(gin.shape)
    out = (dx, (g * xhat).sum(dim=0), g.sum(dim=0), dproj, dproj_sum) if sums \
        else (dx, None, None, dproj, None)
    return out + (xhat.to(_io_dtype(gin, x, residual)).view(gin.shape),) if emit_xhat else out


def _io_dtype(*tensors):
    """The io dtype of a chain: that of its first tensor which is not an fp32
    intermediate (all fp32 in an fp32 twin run)."""
    for t in tensors:
        if t is not None and t.dtype != torch.float32:
            return t.dtype
    return torch.float32


# layernorm.cu's backward: warps a block, blocks an SM of its persistent
# grid (kBwdWarps, kBwdBlocksPerSm), and the widest row one warp takes.
LN_BWD_WARPS = 8
LN_BWD_BLOCKS_PER_SM = 2
LN_BWD_WARP_WIDTH = 1024


def layernorm_bwd_plan(rows: int, width: int, sms: int = gates.H100_SMS,
                       planes: int = 2) -> dict:
    """The backward kernel's launch plan, as ``nans_layernorm_bwd_plan``
    computes it: a persistent grid of at most ``LN_BWD_BLOCKS_PER_SM``
    blocks an SM (``grid``), block ``i`` over rows ``[i *
    rows_per_block, (i + 1) * rows_per_block)``; ``warps_per_row`` warps a
    row (two above ``LN_BWD_WARP_WIDTH``), each lane over
    ``chunks_per_lane`` runs of 8 columns; the block's ``8 /
    warps_per_row`` row slots take its rows in turn. ``partials``: the
    shape of the fp32 column partials of ``planes`` sums (2 pre-LN, 3
    post-LN)."""
    g = 2 if width > LN_BWD_WARP_WIDTH else 1
    slots = LN_BWD_WARPS // g
    grid = min(LN_BWD_BLOCKS_PER_SM * sms, -(-rows // slots))
    rpb = -(-rows // grid)
    grid = -(-rows // rpb)
    return dict(grid=grid, rows_per_block=rpb, warps_per_row=g,
                chunks_per_lane=-(-(width // 8 // g) // 32), row_slots=slots,
                threads=32 * LN_BWD_WARPS, partials=(grid, planes, width))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layer_norm_bwd(gin: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, eps: float,
                   residual: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None, emit_dproj: bool = False,
                   dropout: Optional[drop.Dropout] = None, emit_xhat: bool = False,
                   sums: bool = True):
    """As :func:`layer_norm_bwd_plain`. CPU tensors take the twin; CUDA
    tensors launch the kernel in one of the two forms the chains call: the
    pre-LN form (``gin`` fp32, ``x`` bf16, ``residual`` bf16, dx bf16) or
    the post-LN form (``gin`` bf16, ``x`` fp32, no residual, dx fp32,
    ``emit_dproj``), with the sums or with x-hat (bf16) or, pre-LN, with
    neither; anything else raises. Launched as :func:`layernorm_bwd_plan`
    says; one ``column_sum`` launch then sums the per-block column partials
    of all the sums in block order."""
    if not gin.is_cuda:
        return layer_norm_bwd_plain(gin, x, weight, eps, residual, out_dtype, emit_dproj,
                                    dropout, emit_xhat, sums)
    w = x.shape[-1]
    rows = x.numel() // w
    bf16, f32 = gates.KERNEL_DTYPE, torch.float32
    for name, t in (("gin", gin), ("x", x), ("residual", residual)):
        gates.admit(t is None or (t.is_cuda and t.is_contiguous() and t.numel() == rows * w),
                    f"layernorm bwd: {name} must be contiguous [rows, {w}] on CUDA")
    gates.admit(rows > 0 and w % gates.LN_WIDTH_MULTIPLE == 0 and w <= gates.MAX_LN_WIDTH,
                f"layernorm bwd: width {w}")
    out_dtype = out_dtype or gin.dtype
    pre = (gin.dtype, x.dtype, None if residual is None else residual.dtype, out_dtype,
           emit_dproj) == (f32, bf16, bf16, bf16, False)
    post = residual is None and (gin.dtype, x.dtype, out_dtype, emit_dproj) == (bf16, f32, f32,
                                                                                True)
    gates.admit(pre or post, "layernorm bwd: the pre-LN form (gin fp32, x bf16, residual bf16, "
                "dx bf16) or the post-LN form (gin bf16, x fp32, no residual, dx fp32, dproj)")
    gates.admit(not (sums and emit_xhat) and (pre or sums or emit_xhat),
                "layernorm bwd: the sums or x-hat (pre-LN: or neither)")
    gates.admit_cuda("layernorm bwd", weight)
    if drop.active(dropout):
        gates.admit(dropout.seq > 0 and rows % dropout.seq == 0,
                    "layernorm bwd: dropout needs seq | rows")
    dx = torch.empty(gin.shape, dtype=out_dtype, device=gin.device)
    dproj = torch.empty(gin.shape, dtype=bf16, device=gin.device) if emit_dproj else None
    xhat = torch.empty(gin.shape, dtype=bf16, device=gin.device) if emit_xhat else None
    sms = _sms(gin.device.index if gin.device.index is not None else torch.cuda.current_device())
    plan = layernorm_bwd_plan(rows, w, sms, 2 if pre else 3)
    part = torch.empty(plan["partials"], dtype=f32, device=gin.device) if sums else None
    seed, stream, thresh, scale, on, sample0 = drop.kernel_args(dropout)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.library().nans_layernorm_bwd(
        0 if pre else 1, gin.data_ptr(), x.data_ptr(), weight.data_ptr(), ptr(residual),
        dx.data_ptr(), ptr(dproj), ptr(xhat), seed, stream, thresh, scale, on, sample0,
        dropout.seq if on else 0, ptr(part), rows, w, sms, float(eps),
        _build.stream_ptr(gin.device))
    _build.check(err, "nans_layernorm_bwd")
    layer_norm_bwd.launches += 1
    if sums:
        total = column_sum(part.view(plan["grid"], -1)).view(-1, w)
        out = (dx, total[0], total[1], dproj, total[2] if emit_dproj else None)
    else:
        out = (dx, None, None, dproj, None)
    return out + (xhat,) if emit_xhat else out


row_layer_norm.launches = 0
pallas_layer_norm.launches = 0
layer_norm_bwd.launches = 0
