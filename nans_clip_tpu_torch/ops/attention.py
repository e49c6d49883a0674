"""Multi-head attention over a packed QKV buffer and its backward, and
their kernels in ``csrc/attention.cu``.

``qkv``: ``[B*S, 3W]`` with the q heads, then the k heads, then the v heads
(``nans_clip_tpu/ops/fused_block.py:136-138``); ``key_bias``: ``[B, S]``
additive fp32 or None; ``dropout``: the attention-probability dropout
(``ops/dropout.py``) or None. Returns ctx ``[B*S, W]``. Scores and softmax
statistics are fp32; q/k/v, P (after its dropout) and ctx are in the io
dtype, the rounding points of the attention loop in
``fused_block.py::_kernel`` (:131-182).

``attention_bwd`` recomputes P and returns ``dqkv`` ``[B*S, 3W]`` in fp32
and in the io dtype, as the backward kernels of
``nans_clip_tpu/ops/fused_block_bwd.py`` form it (:165-202, :348-378). On
the card it launches the one-shot backward kernel up to
``gates.ATTN_BWD_MAX_SEQ`` (:func:`attention_bwd_plan`) and the
long-sequence pair of kernels above it (:func:`attention_bwd_long_plan`; no
key bias and no dropout there: the pre-LN blocks of
``_attn_bwd_chunked_kernel``, :1163-1192); both take each query row's
softmax max and sum from the forward (``attention(..., stats=True)``: ``[2,
B, H, S]`` fp32).

Heads are 64 or 80 wide (``gates.HEAD_DIMS``): every ViT-B/L and RoBERTa
tower, and ViT-H.

On the card, ``attention`` launches one block a (head, sample) that holds
the head's K and V and covers all its query rows, in one pass over the keys
up to S = 256 and two above (:func:`attention_plan`).

``attention_plain`` and ``attention_bwd_plain`` are the twins; CPU tensors
take them.

The second half ports ``nans_clip_tpu/ops/attention.py`` itself: the flash
attention on ``[B, H, S, dh]`` tensors with an additive fp32 ``[B, S]`` key
bias, #22 (``_fwd_kernel``: o and the row logsumexp) and #23
(``_bwd_kernel``: dq, dk, dv from the saved o and logsumexp), both in
``csrc/flash.cu``, wrapped by :func:`flash_fwd` and :func:`flash_bwd`, with
``attention_pallas_plain`` and ``attention_pallas_bwd_plain`` as their
twins; the autograd Function that joins them (the JAX ``custom_vjp``,
:177-194), ``attention_pallas``, ``fused_attention``, ``split_heads``,
``merge_heads`` and ``mha`` (the JAX ``pallas`` and ``xla`` routes), and
``flash_attention_block`` (:246-317).
"""

from __future__ import annotations

import math
from typing import Optional

import ctypes

import torch
import torch.nn.functional as F

from nans_clip_tpu_torch.ops import _build, dropout as drop, gates
from nans_clip_tpu_torch.ops.activations import mm32, upcast
from nans_clip_tpu_torch.ops.layernorm import layer_norm, layer_norm_bwd_plain


def _heads(qkv: torch.Tensor, batch: int, heads: int):
    """Three [B, H, S, dh] views of the packed buffer, upcast."""
    rows, w3 = qkv.shape
    seq, dh = rows // batch, w3 // 3 // heads
    return [upcast(t) for t in qkv.view(batch, seq, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)]


def _scores(q, k, key_bias, batch, seq):
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if key_bias is not None:
        s = s + key_bias.float().view(batch, 1, 1, seq).to(s.dtype)
    return s


def _row_stats(s):
    """Each row's max and sum of exp(s - max): [2, B, H, S]."""
    m = s.amax(dim=-1, keepdim=True)
    return torch.stack([m, torch.exp(s - m).sum(dim=-1, keepdim=True)]).squeeze(-1)


def _probs(q, k, key_bias, batch, seq, stats=None):
    """P = exp(s - m) / l, from the rows' statistics ``stats`` where given
    (else formed here, as :func:`_row_stats`)."""
    s = _scores(q, k, key_bias, batch, seq)
    m, l = (_row_stats(s) if stats is None else stats.to(s.dtype)).unsqueeze(-1).unbind(0)
    return torch.exp(s - m) / l


def _keep(dropout, batch, heads, seq, like):
    if not drop.active(dropout):
        return None
    return drop.attention_multiplier(dropout, batch, heads, seq, like.device).to(like.dtype)


def attention_plain(qkv: torch.Tensor, key_bias: Optional[torch.Tensor],
                    batch: int, heads: int, dropout: Optional[drop.Dropout] = None,
                    stats: bool = False):
    """Twin of :func:`attention`: ctx, and with ``stats`` also each query
    row's max and sum of exp(s - max), fp32 ``[2, B, H, S]``."""
    rows, w3 = qkv.shape
    q, k, v = qkv.view(batch, rows // batch, 3, heads, w3 // 3 // heads).permute(
        2, 0, 3, 1, 4).unbind(0)
    ctx = merge_heads(attention_xla(q, k, v, key_bias, dropout)).reshape(rows, w3 // 3)
    if not stats:
        return ctx
    return ctx, _row_stats(_scores(upcast(q), upcast(k), key_bias, batch, rows // batch)).float()


def _admit(name, qkv, key_bias, batch, heads, max_seq):
    rows, w3 = qkv.shape
    seq, w = rows // batch, w3 // 3
    gates.admit(rows == batch * seq and w3 == 3 * w, f"{name}: qkv {tuple(qkv.shape)}")
    gates.admit(w % heads == 0 and w // heads in gates.HEAD_DIMS,
                f"{name}: head dim {w / heads}")
    gates.admit(seq <= max_seq, f"{name}: S={seq}")
    gates.admit_cuda(name, qkv)
    if key_bias is not None:
        gates.admit(key_bias.is_cuda and key_bias.dtype == torch.float32
                    and key_bias.is_contiguous() and key_bias.numel() == batch * seq,
                    f"{name}: key_bias must be contiguous fp32 [B, S] on CUDA")
    return seq, w


# attention.cu's forward: the one-pass instances' key tiles of 16 (a warp's
# 16 x 16 KT scores in registers; 13 is ViT-B-16's 197 keys), and the most
# warps a block of each form. Set by the kernel's design.
ATTN_ONE_PASS_TILES = (4, 8, 13, 16)
ATTN_MAX_WARPS = {True: 4, False: 8}


def attention_plan(batch: int, seq: int, heads: int, dh: int) -> dict:
    """The forward kernel's launch plan, as ``nans_attention_plan`` computes
    it: a block a (head, sample) (``grid``) holds the head's K and V (``seq``
    padded to ``strips`` x 16 rows) and covers its ``strips`` strips of 16
    query rows with ``warps`` warps, warp ``i`` taking strips ``i``, ``i +
    warps``, ...; one pass over the keys (the instance of ``key_tiles``) up
    to 16 key tiles, two above (``key_tiles`` 0). Fewer warps than the most
    where that leaves the rounds as many, or where shared memory runs
    short."""
    s_pad = -(-seq // 16) * 16
    strips = s_pad // 16
    one_pass = strips <= ATTN_ONE_PASS_TILES[-1]
    key_tiles = next(t for t in ATTN_ONE_PASS_TILES if t >= strips) if one_pass else 0
    fixed = 2 * s_pad * dh * 2 + s_pad * 4           # K, V, key bias
    per_warp = 2 * 16 * dh * 2                       # two 16-row buffers
    most = min(ATTN_MAX_WARPS[one_pass], (gates.SMEM_PER_BLOCK - fixed) // per_warp)
    rounds = -(-strips // most)
    warps = -(-strips // rounds)
    return dict(key_tiles=key_tiles, warps=warps, threads=32 * warps,
                smem=fixed + warps * per_warp, strips=strips, rounds=rounds,
                grid=(heads, batch))


def attention(qkv: torch.Tensor, key_bias: Optional[torch.Tensor],
              batch: int, heads: int, dropout: Optional[drop.Dropout] = None,
              stats: bool = False):
    """CPU tensors take :func:`attention_plain`; CUDA tensors launch the
    kernel (bf16 qkv, head dim 64 or 80, S <= ``gates.MAX_SEQ``; launched as
    :func:`attention_plan` says). With ``stats``, returns (ctx, stats): each
    query row's softmax max and sum, fp32 ``[2, B, H, S]``, which
    :func:`attention_bwd` takes (the kernel's instance without them, which
    inference runs, stores nothing). While a program is exported it is the
    operator ``nans_clip::attention`` (``ops/library.py``)."""
    if torch.compiler.is_exporting():
        gates.admit(not drop.active(dropout) and not stats,
                    "attention: an exported forward takes no dropout and no statistics")
        from nans_clip_tpu_torch.ops import library
        return library.attention_op(qkv, key_bias, batch, heads)
    if not qkv.is_cuda:
        return attention_plain(qkv, key_bias, batch, heads, dropout, stats)
    seq, w = _admit("attention", qkv, key_bias, batch, heads, gates.MAX_SEQ)
    dh = w // heads
    plan = attention_plan(batch, seq, heads, dh)
    gates.admit(plan["smem"] <= gates.SMEM_PER_BLOCK, f"attention: plan {plan}")
    ctx = torch.empty((qkv.shape[0], w), dtype=qkv.dtype, device=qkv.device)
    st = torch.empty((2, batch, heads, seq), dtype=torch.float32, device=qkv.device) \
        if stats else None
    err = _build.library().nans_attention(
        qkv.data_ptr(), None if key_bias is None else key_bias.data_ptr(), ctx.data_ptr(),
        None if st is None else st.data_ptr(), batch, seq, w, dh, 1.0 / math.sqrt(dh),
        *drop.kernel_args(dropout), _build.stream_ptr(qkv.device))
    _build.check(err, "nans_attention")
    attention.launches += 1
    return (ctx, st) if stats else ctx


def attention_bwd_plain(qkv: torch.Tensor, dctx: torch.Tensor,
                        key_bias: Optional[torch.Tensor], batch: int, heads: int,
                        dropout: Optional[drop.Dropout] = None, need32: bool = True,
                        stats: Optional[torch.Tensor] = None):
    """Twin of the backward, step by step as ``_bert_bwd_math``
    (fused_block_bwd.py:356-373): returns (dqkv in fp32, dqkv in the io
    dtype); the first is None where ``need32`` is False. P from the rows'
    ``stats`` where given (the forward's), else recomputed."""
    rows, w3 = qkv.shape
    seq, w = rows // batch, w3 // 3
    dh = w // heads
    scale = 1.0 / math.sqrt(dh)
    q, k, v = _heads(qkv, batch, heads)
    p = _probs(q, k, key_bias, batch, seq, stats)               # [B, H, S, S]
    keep = _keep(dropout, batch, heads, seq, p)
    do = upcast(dctx).view(batch, seq, heads, dh).permute(0, 2, 1, 3)
    rnd = lambda t: upcast(t.to(qkv.dtype))                     # a bf16 rounding point
    pd = p if keep is None else p * keep
    dv = torch.matmul(rnd(pd).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    if keep is not None:
        dp = dp * keep
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = rnd(p * (dp - delta))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(rows, w3)
    return (dqkv if need32 else None), dqkv.to(qkv.dtype)


# attention.cu's one-shot backward: the most warps a block by head dim
# (bwd::max_warps).
ATTN_BWD_MAX_WARPS = {64: 7, 80: 12}


def attention_bwd_plan(batch: int, seq: int, heads: int, dh: int, dropout: bool = False) -> dict:
    """The one-shot backward's launch plan, as ``nans_attention_bwd_plan``
    computes it: a block a (head, sample) (``grid``) holds the head's Q, K,
    V and dctx (``seq`` padded to ``strips`` x 16 rows, unpadded swizzled
    rows), the rows' max, sum and delta and the key bias, and under
    ``dropout`` the keep bits (16 a row and key tile); ``warps`` warps take
    the strips of 16 query rows (phase A), then of 16 key rows (phase B),
    warp ``i`` taking strips ``i``, ``i + warps``, ..., in ``rounds``
    rounds: the fewest warps that keep the rounds as few as
    ``ATTN_BWD_MAX_WARPS[dh]`` would."""
    s_pad = -(-seq // 16) * 16
    strips = s_pad // 16
    rounds = -(-strips // ATTN_BWD_MAX_WARPS[dh])
    warps = -(-strips // rounds)
    smem = 4 * s_pad * dh * 2 + 4 * s_pad * 4 + (s_pad * strips * 2 if dropout else 0)
    return dict(warps=warps, threads=32 * warps, smem=smem, strips=strips, rounds=rounds,
                grid=(heads, batch),
                blocks_per_sm=min(gates.SMEM_PER_SM // (smem + 1024),
                                  gates.REGS_PER_SM // (32 * warps * _BWD_REGS[dh]), 32,
                                  64 // warps))


# attention.cu's long-sequence pair: the most warps a block by head dim
# (bwd_long::max_warps: 128 registers a thread at dh 64, 168 at dh 80, one
# block an SM).
ATTN_BWD_LONG_MAX_WARPS = {64: 16, 80: 12}


def attention_bwd_long_plan(batch: int, seq: int, heads: int, dh: int) -> dict:
    """The long-sequence pair's launch plan, as ``nans_attention_bwd_long_plan``
    computes it: each of the two kernels runs a block a (head, sample)
    (``grid``) whose ``warps`` warps walk the head's ``strips`` strips of 16
    rows (query rows in the dQ kernel, key rows in the dK/dV kernel), warp
    ``i`` taking strips ``i``, ``i + warps``, ..., in ``rounds`` rounds: the
    fewest warps that keep the rounds as few as
    ``ATTN_BWD_LONG_MAX_WARPS[dh]`` would. ``smem_dq``: K and V of the head
    (``seq`` padded to ``strips`` x 16 unpadded swizzled rows) and the key
    mask; ``smem_dkv``: Q and dctx, the key mask and each query row's max,
    sum and delta."""
    s_pad = -(-seq // 16) * 16
    strips = s_pad // 16
    rounds = -(-strips // ATTN_BWD_LONG_MAX_WARPS[dh])
    warps = -(-strips // rounds)
    rows = 2 * s_pad * dh * 2
    return dict(warps=warps, threads=32 * warps, rounds=rounds, strips=strips,
                smem_dq=rows + s_pad * 4, smem_dkv=rows + 4 * s_pad * 4, grid=(heads, batch))


# registers a thread of the one-shot backward's instances may take (its
# __launch_bounds__: two blocks of 7 warps an SM at dh 64, the 14 warps 4
# to an SM quarter of 16,384 registers; one block of up to 12 warps at dh
# 80, 3 to a quarter)
_BWD_REGS = {64: 128, 80: 168}


def attention_bwd(qkv: torch.Tensor, dctx: torch.Tensor, key_bias: Optional[torch.Tensor],
                  batch: int, heads: int, dropout: Optional[drop.Dropout] = None,
                  need32: bool = True, stats: Optional[torch.Tensor] = None):
    """``dctx``: [B*S, W] in the io dtype. CPU tensors take
    :func:`attention_bwd_plain`; CUDA tensors launch the one-shot kernel
    (bf16, head dim 64 or 80, S <= ``gates.ATTN_BWD_MAX_SEQ``; launched as
    :func:`attention_bwd_plan` says) or, for a longer sequence without key
    bias or dropout (S <= ``gates.ATTN_BWD_LONG_MAX_SEQ``), the
    long-sequence pair (:func:`attention_bwd_long_plan`). ``dropout`` must
    be the forward's. ``need32`` False leaves the fp32 form unwritten
    (None). ``stats``: the forward's row statistics (``attention(...,
    stats=True)``), which both take; where they are not given, one forward
    launch forms them first."""
    if not qkv.is_cuda:
        return attention_bwd_plain(qkv, dctx, key_bias, batch, heads, dropout, need32, stats)
    seq = qkv.shape[0] // batch
    long_seq = seq > gates.ATTN_BWD_MAX_SEQ
    seq, w = _admit("attention bwd", qkv, key_bias, batch, heads,
                    gates.ATTN_BWD_LONG_MAX_SEQ if long_seq else gates.ATTN_BWD_MAX_SEQ)
    gates.admit(not long_seq or (key_bias is None and not drop.active(dropout)),
                f"attention bwd: S={seq} takes no key bias and no dropout")
    gates.admit_cuda("attention bwd", dctx)
    gates.admit(dctx.shape == (qkv.shape[0], w), f"attention bwd: dctx {tuple(dctx.shape)}")
    dh = w // heads
    d32 = torch.empty(qkv.shape, dtype=torch.float32, device=qkv.device) if need32 else None
    d16 = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.library()
    if stats is None:
        stats = attention(qkv, key_bias, batch, heads, dropout, stats=True)[1]
    gates.admit(stats.is_cuda and stats.dtype == torch.float32 and stats.is_contiguous()
                and tuple(stats.shape) == (2, batch, heads, seq),
                "attention bwd: stats must be contiguous fp32 [2, B, H, S] on CUDA")
    if long_seq:
        plan = attention_bwd_long_plan(batch, seq, heads, dh)
        gates.admit(max(plan["smem_dq"], plan["smem_dkv"]) <= gates.SMEM_PER_BLOCK,
                    f"attention bwd: plan {plan}")
        delta = torch.empty((batch, heads, seq), dtype=torch.float32, device=qkv.device)
        err = lib.nans_attention_bwd_long(
            qkv.data_ptr(), dctx.data_ptr(), stats.data_ptr(), delta.data_ptr(), ptr(d32),
            d16.data_ptr(), batch, seq, w, dh, 1.0 / math.sqrt(dh), _build.stream_ptr(qkv.device))
        _build.check(err, "nans_attention_bwd_long")
        attention_bwd.launches_long += 1
    else:
        plan = attention_bwd_plan(batch, seq, heads, dh, drop.active(dropout))
        gates.admit(plan["smem"] <= gates.SMEM_PER_BLOCK, f"attention bwd: plan {plan}")
        err = lib.nans_attention_bwd(
            qkv.data_ptr(), dctx.data_ptr(), ptr(key_bias), stats.data_ptr(), ptr(d32),
            d16.data_ptr(), batch, seq, w, dh, 1.0 / math.sqrt(dh), *drop.kernel_args(dropout),
            _build.stream_ptr(qkv.device))
        _build.check(err, "nans_attention_bwd")
    attention_bwd.launches += 1
    return d32, d16


attention.launches = 0
attention_bwd.launches = 0
attention_bwd.launches_long = 0   # of them, the long-sequence pair's


# ---------------------------------------------------------------------------
# Flash attention on [B, H, S, dh] tensors: #22 and #23
# (nans_clip_tpu/ops/attention.py:81-194), and the JAX routes around it.
# ---------------------------------------------------------------------------

def attention_pallas_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_bias: Optional[torch.Tensor] = None):
    """Twin of #22, step by step as ``_fwd_kernel`` (:81-93) in fp32:
    returns (o in q's dtype, lse fp32 ``[B, H, S]``). The JAX kernel's
    padding of S to its query block (keys past S biased by -1e30) adds
    exact zeros to every sum, so the twin does not pad."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = upcast(q), upcast(k), upcast(v)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if key_bias is not None:
        s = s + upcast(key_bias)[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, vf) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def attention_pallas_bwd_plain(q, k, v, key_bias, o, do, lse):
    """Twin of #23, step by step as ``_bwd_kernel`` (:96-122) in fp32, from
    the saved o and lse (not autograd through the forward's twin): returns
    (dq, dk, dv) in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, gf = (upcast(t) for t in (q, k, v, o, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if key_bias is not None:
        s = s + upcast(key_bias)[:, None, None, :]
    p = torch.exp(s - upcast(lse)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _strided_ok(t: torch.Tensor) -> bool:
    """What flash.cu reads and writes through strides: the last dim
    contiguous, the other strides whole 16-byte chunks, 16-byte aligned."""
    return (t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _admit_flash(name: str, q, k, v, key_bias, *more):
    gates.admit(q.dim() == 4 and k.shape == q.shape and v.shape == q.shape,
                f"{name}: q/k/v must share one [B, H, S, dh] shape, got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    gates.admit(q.shape[-1] in gates.HEAD_DIMS, f"{name}: head dim {q.shape[-1]}")
    for t in (q, k, v, *more):
        gates.admit(t.is_cuda and t.dtype == gates.KERNEL_DTYPE,
                    f"{name}: tensors must be {gates.KERNEL_DTYPE} on CUDA, got {t.dtype}")
        gates.admit(t.shape == q.shape and _strided_ok(t),
                    f"{name}: a [B, H, S, dh] view with a contiguous last dim, the other "
                    "strides multiples of 8 and 16-byte alignment")
    b, _, s, _ = q.shape
    if key_bias is not None:
        gates.admit(key_bias.is_cuda and key_bias.dtype == torch.float32
                    and key_bias.is_contiguous() and tuple(key_bias.shape) == (b, s),
                    f"{name}: key_bias must be contiguous fp32 [B, S] on CUDA")


def _heads_like(q: torch.Tensor, n: int = 1):
    """``n`` empty [B, H, S, dh] views of one [B, S, n, H, dh] buffer:
    ``merge_heads`` reads each without a copy."""
    b, h, s, dh = q.shape
    buf = torch.empty((b, s, n, h, dh), dtype=q.dtype, device=q.device)
    return [buf[:, :, i].permute(0, 2, 1, 3) for i in range(n)]


def _strides(*tensors) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(tensors)))(*[st for t in tensors
                                                      for st in t.stride()[:3]])


def flash_fwd_plan(batch: int, heads: int, seq: int, dh: int) -> dict:
    """#22's launch plan, as ``nans_flash_fwd_plan`` computes it: a head's
    ``strips`` strips of 16 query rows over the fewest ``blocks`` of at most
    ``gates.FLASH_MAX_WARPS`` warps, evened (``warps`` a block, warp ``i``
    of block ``x`` taking strip ``x * warps + i``; a warp past the last strip
    only stages); ``smem``: the block's Q rows and a ring of
    ``gates.FLASH_STAGES`` tiles of ``gates.FLASH_BLOCK_K`` keys (K, V, the
    key bias), or of as many tiles as ``seq`` has. The grid is (``blocks``,
    heads, batch)."""
    strips = -(-seq // 16)
    blocks = -(-strips // gates.FLASH_MAX_WARPS)
    warps = -(-strips // blocks)
    tile = gates.FLASH_BLOCK_K
    stages = min(gates.FLASH_STAGES, -(-seq // tile))
    own, ring = warps * 16 * dh * 2, stages * 2 * tile * dh * 2
    return dict(warps=warps, threads=32 * warps, blocks=blocks, strips=strips,
                smem=own + ring + stages * tile * 4, grid=(blocks, heads, batch),
                stages=stages, own=own, ring=ring)


def flash_bwd_plan(batch: int, heads: int, seq: int, dh: int) -> dict:
    """#23's launch plan, as ``nans_flash_bwd_plan`` computes it: both
    kernels take #22's strips and blocks (warp ``i`` of block ``x`` owning
    strip ``x * warps + i`` of the queries in the dQ kernel, of the keys in
    the dK/dV kernel); ``smem_dq``: the block's Q and dO rows and a ring of
    K, V and key-bias tiles; ``smem_dkv``: its K and V rows and a ring of Q,
    dO, lse and delta tiles; ``dkv_blocks``: the blocks an SM the dK/dV
    kernel's instance is compiled for (two, capped at 128 registers, at dh 64
    below ``gates.FLASH_DKV_ONE_BLOCK_TILES`` key tiles; else one). Both
    grids are (``blocks``, heads, batch)."""
    p = flash_fwd_plan(batch, heads, seq, dh)
    tile, stages = gates.FLASH_BLOCK_K, p["stages"]
    one = dh != 64 or -(-seq // tile) >= gates.FLASH_DKV_ONE_BLOCK_TILES
    return dict(warps=p["warps"], threads=p["threads"], blocks=p["blocks"],
                strips=p["strips"], grid=p["grid"],
                smem_dq=2 * p["own"] + p["ring"] + stages * tile * 4,
                smem_dkv=2 * p["own"] + p["ring"] + stages * 2 * tile * 4,
                dkv_blocks=1 if one else 2)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_bias: Optional[torch.Tensor] = None):
    """#22: (o, lse) for q/k/v ``[B, H, S, dh]`` and an additive fp32
    ``key_bias`` ``[B, S]`` or None. CPU tensors take
    :func:`attention_pallas_plain`; CUDA tensors launch ``nans_flash_fwd``
    (bf16, head dim 64 or 80, any S; read through strides; launched as
    :func:`flash_fwd_plan` says). o comes back as a [B, H, S, dh] view of a
    [B, S, H, dh] buffer, lse fp32 [B, H, S]."""
    if not q.is_cuda:
        return attention_pallas_plain(q, k, v, key_bias)
    _admit_flash("flash fwd", q, k, v, key_bias)
    b, h, s, dh = q.shape
    plan = flash_fwd_plan(b, h, s, dh)
    gates.admit(plan["smem"] <= gates.SMEM_PER_BLOCK, f"flash fwd: plan {plan}")
    (o,) = _heads_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _build.library().nans_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_bias is None else key_bias.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _strides(q, k, v, o), b, h, s, dh, 1.0 / math.sqrt(dh), _build.stream_ptr(q.device))
    _build.check(err, "nans_flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd(q, k, v, key_bias, o, do, lse):
    """#23: (dq, dk, dv) from the forward's inputs, its o and lse, and
    ``do``, the gradient of o. CPU tensors take
    :func:`attention_pallas_bwd_plain`; CUDA tensors launch
    ``nans_flash_bwd``: the dQ kernel (which stores delta = rowsum(do * o),
    fp32) then the dK/dV kernel, launched as :func:`flash_bwd_plan` says. dq,
    dk and dv come back as views of one [B, S, 3, H, dh] buffer."""
    if not q.is_cuda:
        return attention_pallas_bwd_plain(q, k, v, key_bias, o, do, lse)
    _admit_flash("flash bwd", q, k, v, key_bias, o, do)
    b, h, s, dh = q.shape
    gates.admit(lse.is_cuda and lse.dtype == torch.float32 and lse.is_contiguous()
                and tuple(lse.shape) == (b, h, s), "flash bwd: lse must be contiguous fp32 "
                "[B, H, S] on CUDA")
    plan = flash_bwd_plan(b, h, s, dh)
    gates.admit(max(plan["smem_dq"], plan["smem_dkv"]) <= gates.SMEM_PER_BLOCK,
                f"flash bwd: plan {plan}")
    dq, dk, dv = _heads_like(q, 3)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _build.library().nans_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_bias is None else key_bias.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, o, do, dq, dk, dv), b, h, s, dh, 1.0 / math.sqrt(dh),
        _build.stream_ptr(q.device))
    _build.check(err, "nans_flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_fwd.launches = 0
flash_bwd.launches = 0


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` as flash.cu reads it: as it is where its strides allow, else a
    contiguous copy (an incoming gradient's layout is autograd's choice)."""
    return t if not t.is_cuda or _strided_ok(t) else t.contiguous()


class _FlashAttention(torch.autograd.Function):
    """#22 forward, #23 backward (the JAX ``custom_vjp``,
    attention.py:177-194): saves q, k, v, the key bias, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias):
        o, lse = flash_fwd(q, k, v, key_bias)
        ctx.save_for_backward(q, k, v, key_bias, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, key_bias, o, _kernel_layout(g), lse)
        return dq, dk, dv, None


def attention_pallas(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_bias: Optional[torch.Tensor] = None,
                     block_q: int = 128) -> torch.Tensor:
    """The flash attention (JAX ``attention_pallas``, :197): q/k/v ``[B, H,
    S, dh]``, key_bias ``[B, S]`` additive or None. Differentiable through
    #23 where a gradient is needed. ``block_q`` is the JAX kernel's query
    block; on the card, whose kernels tile by 16-row strips and
    ``gates.FLASH_BLOCK_K`` and mask the tail instead of padding, it changes
    no arithmetic."""
    if block_q <= 0:
        raise ValueError(f"block_q must be positive, got {block_q}")
    if key_bias is not None:
        key_bias = key_bias.float().contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, key_bias)
    return flash_fwd(q, k, v, key_bias)[0]


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_bias: Optional[torch.Tensor] = None,
                  dropout: Optional[drop.Dropout] = None) -> torch.Tensor:
    """The plain attention on [B, H, S, dh] (JAX ``attention_xla``, :59):
    fp32 scores and softmax, the probability dropout of ``dropout`` (the
    port's keep masks), P in the io dtype times v. Autograd differentiates
    it."""
    b, h, s, _ = q.shape
    p = _probs(upcast(q), upcast(k), key_bias, b, s)
    keep = _keep(dropout, b, h, s, p)
    if keep is not None:
        p = p * keep
    return torch.matmul(upcast(p.to(v.dtype)), upcast(v)).to(v.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: Optional[torch.Tensor] = None, impl: str = "auto",
                    dropout: Optional[drop.Dropout] = None) -> torch.Tensor:
    """Multi-head self-attention on [B, H, S, dh] (JAX ``fused_attention``,
    :324): the flash attention where ``gates.pallas_attention_route`` holds
    (``impl == "pallas"``, no active ``dropout``, S <= 1024), else
    :func:`attention_xla`."""
    if gates.pallas_attention_route(q, impl, q.shape[2], drop.active(dropout)):
        return attention_pallas(q, k, v, key_bias)
    return attention_xla(q, k, v, key_bias, dropout)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, D] -> [B, H, S, dh] (a view)."""
    b, s, d = x.shape
    return x.view(b, s, heads, d // heads).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, dh] -> [B, S, D]."""
    b, h, s, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * dh)


def mha(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor, w_o: torch.Tensor,
        b_o: torch.Tensor, heads: int, key_bias: Optional[torch.Tensor] = None,
        impl: str = "auto", dropout: Optional[drop.Dropout] = None) -> torch.Tensor:
    """The MHA block (JAX ``mha``, :356): the fused QKV projection and the
    out projection in plain torch (XLA in JAX), :func:`fused_attention`
    between them. Weights in the torch Linear layout: ``w_qkv`` [3W, W]
    (q rows, then k, then v), ``w_o`` [W, W]; the JAX ``params`` hold their
    transposes."""
    q, k, v = F.linear(x, w_qkv, b_qkv).chunk(3, dim=-1)
    out = fused_attention(split_heads(q, heads), split_heads(k, heads), split_heads(v, heads),
                          key_bias, impl, dropout)
    return F.linear(merge_heads(out), w_o, b_o)


def _flash_block_parts(x, ln_w, ln_b, w_qkv, b_qkv, heads: int, eps: float):
    """LN -> QKV -> per-head views (JAX ``_flash_block_parts``, :226, without
    its padding): (xn, q, k, v)."""
    xn = layer_norm(x, ln_w, ln_b, eps)
    q, k, v = F.linear(xn, w_qkv, b_qkv).chunk(3, dim=-1)
    return (xn, *(split_heads(t, heads) for t in (q, k, v)))


class _FlashAttentionBlock(torch.autograd.Function):
    """The JAX ``flash_attention_block`` custom_vjp (:246-317): saves x, the
    merged ctx and the lse; the backward recomputes LN + QKV, forms the out
    projection's gradients, runs #23, then the QKV projection's gradients
    and the LayerNorm backward in fp32. The products and the LN backward are
    plain torch, as XLA einsums are in JAX."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps):
        _, q, k, v = _flash_block_parts(x, ln_w, ln_b, w_qkv, b_qkv, heads, eps)
        o, lse = flash_fwd(q, k, v, None)
        ctx_m = merge_heads(o)
        ctx.save_for_backward(x, ln_w, ln_b, w_qkv, b_qkv, w_o, ctx_m, lse)
        ctx.heads, ctx.eps = heads, eps
        return x + F.linear(ctx_m, w_o, b_o)

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w_qkv, b_qkv, w_o, ctx_m, lse = ctx.saved_tensors
        heads, eps = ctx.heads, ctx.eps
        b, s, w = x.shape
        xn, q, k, v = _flash_block_parts(x, ln_w, ln_b, w_qkv, b_qkv, heads, eps)
        g = g.contiguous()
        g2, gf = g.view(b * s, w), upcast(g)
        flat = lambda t: t.reshape(b * s, t.shape[-1])
        # the out projection's gradients
        dwo = mm32(g2.T, flat(ctx_m)).to(w_o.dtype)
        dbo = gf.sum(dim=(0, 1)).to(w_o.dtype)
        dctx_m = mm32(g2, w_o).to(x.dtype).view(b, s, w)
        # the attention backward, #23
        dq, dk, dv = flash_bwd(q, k, v, None, split_heads(ctx_m, heads),
                               _kernel_layout(split_heads(dctx_m, heads)), lse)
        dqkv = torch.cat([merge_heads(t) for t in (dq, dk, dv)], dim=-1)
        # the QKV projection's gradients
        dwqkv = mm32(flat(dqkv).T, flat(xn)).to(w_qkv.dtype)
        dqkv_f = upcast(dqkv)
        dbqkv = dqkv_f.sum(dim=(0, 1)).to(b_qkv.dtype)
        dxn = (flat(dqkv_f) @ upcast(w_qkv)).view(b, s, w)
        # the LayerNorm backward in fp32 (its statistics recomputed), plus g
        dx, d_scale, d_bias, _, _ = layer_norm_bwd_plain(dxn, x, ln_w, eps, residual=g,
                                                         out_dtype=x.dtype)
        return (dx, d_scale.to(ln_w.dtype), d_bias.to(ln_b.dtype), dwqkv, dbqkv, dwo, dbo,
                None, None)


def flash_attention_block(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads: int,
                          eps: float = 1e-5, block_q: int = 128) -> torch.Tensor:
    """Pre-LN ViT attention block through the flash kernels (JAX
    ``flash_attention_block``, :247): ``x + out_proj(flash_mha(LN(x)))``, x
    ``[B, S, W]``, no key mask, weights in the torch Linear layout (``wqkv``
    [3W, W], ``wo`` [W, W]). Its backward recomputes LN + QKV and runs #23.
    ``block_q`` changes no arithmetic, as in :func:`attention_pallas`. No
    tower routes it (the JAX towers route it only where no published shape
    goes, ``vit.py:248-256``): a direct call."""
    if block_q <= 0:
        raise ValueError(f"block_q must be positive, got {block_q}")
    return _FlashAttentionBlock.apply(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads, eps)
