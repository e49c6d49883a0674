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
``gates.ATTN_BWD_MAX_SEQ`` and the long-sequence pair of kernels above it
(no key bias and no dropout there: the pre-LN blocks of
``_attn_bwd_chunked_kernel``, :1163-1192).

Heads are 64 or 80 wide (``gates.HEAD_DIMS``): every ViT-B/L and RoBERTa
tower, and ViT-H.

``attention_plain`` and ``attention_bwd_plain`` are the twins; CPU tensors
take them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nans_clip_tpu_torch.ops import _build, dropout as drop, gates
from nans_clip_tpu_torch.ops.activations import upcast


def _heads(qkv: torch.Tensor, batch: int, heads: int):
    """Three [B, H, S, dh] views of the packed buffer, upcast."""
    rows, w3 = qkv.shape
    seq, dh = rows // batch, w3 // 3 // heads
    return [upcast(t) for t in qkv.view(batch, seq, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)]


def _probs(q, k, key_bias, batch, seq):
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if key_bias is not None:
        s = s + key_bias.float().view(batch, 1, 1, seq).to(s.dtype)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return p / p.sum(dim=-1, keepdim=True)


def _keep(dropout, batch, heads, seq, like):
    if not drop.active(dropout):
        return None
    return drop.attention_multiplier(dropout, batch, heads, seq, like.device).to(like.dtype)


def attention_plain(qkv: torch.Tensor, key_bias: Optional[torch.Tensor],
                    batch: int, heads: int,
                    dropout: Optional[drop.Dropout] = None) -> torch.Tensor:
    rows, w3 = qkv.shape
    seq, w = rows // batch, w3 // 3
    q, k, v = _heads(qkv, batch, heads)
    p = _probs(q, k, key_bias, batch, seq)
    keep = _keep(dropout, batch, heads, seq, p)
    if keep is not None:
        p = p * keep
    ctx = torch.matmul(upcast(p.to(qkv.dtype)), v)
    return ctx.to(qkv.dtype).permute(0, 2, 1, 3).reshape(rows, w)


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


def attention(qkv: torch.Tensor, key_bias: Optional[torch.Tensor],
              batch: int, heads: int, dropout: Optional[drop.Dropout] = None) -> torch.Tensor:
    """CPU tensors take :func:`attention_plain`; CUDA tensors launch the
    kernel (bf16 qkv, head dim 64 or 80, S <= ``gates.MAX_SEQ``)."""
    if not qkv.is_cuda:
        return attention_plain(qkv, key_bias, batch, heads, dropout)
    seq, w = _admit("attention", qkv, key_bias, batch, heads, gates.MAX_SEQ)
    dh = w // heads
    ctx = torch.empty((qkv.shape[0], w), dtype=qkv.dtype, device=qkv.device)
    err = _build.library().nans_attention(
        qkv.data_ptr(), None if key_bias is None else key_bias.data_ptr(), ctx.data_ptr(),
        batch, seq, w, dh, 1.0 / math.sqrt(dh), *drop.kernel_args(dropout),
        _build.stream_ptr(qkv.device))
    _build.check(err, "nans_attention")
    attention.launches += 1
    return ctx


def attention_bwd_plain(qkv: torch.Tensor, dctx: torch.Tensor,
                        key_bias: Optional[torch.Tensor], batch: int, heads: int,
                        dropout: Optional[drop.Dropout] = None, need32: bool = True):
    """Twin of the backward, step by step as ``_bert_bwd_math``
    (fused_block_bwd.py:356-373): returns (dqkv in fp32, dqkv in the io
    dtype); the first is None where ``need32`` is False."""
    rows, w3 = qkv.shape
    seq, w = rows // batch, w3 // 3
    dh = w // heads
    scale = 1.0 / math.sqrt(dh)
    q, k, v = _heads(qkv, batch, heads)
    p = _probs(q, k, key_bias, batch, seq)                      # [B, H, S, S]
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


def attention_bwd(qkv: torch.Tensor, dctx: torch.Tensor, key_bias: Optional[torch.Tensor],
                  batch: int, heads: int, dropout: Optional[drop.Dropout] = None,
                  need32: bool = True):
    """``dctx``: [B*S, W] in the io dtype. CPU tensors take
    :func:`attention_bwd_plain`; CUDA tensors launch the one-shot kernel
    (bf16, head dim 64 or 80, S <= ``gates.ATTN_BWD_MAX_SEQ``) or, for a
    longer sequence without key bias or dropout (S <=
    ``gates.ATTN_BWD_LONG_MAX_SEQ``), the long-sequence pair. ``dropout``
    must be the forward's. ``need32`` False leaves the fp32 form unwritten
    (None)."""
    if not qkv.is_cuda:
        return attention_bwd_plain(qkv, dctx, key_bias, batch, heads, dropout, need32)
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
    if long_seq:
        stats = torch.empty((3, batch, heads, seq), dtype=torch.float32, device=qkv.device)
        err = lib.nans_attention_bwd_long(
            qkv.data_ptr(), dctx.data_ptr(), ptr(d32), d16.data_ptr(), stats.data_ptr(), batch,
            seq, w, dh, 1.0 / math.sqrt(dh), _build.stream_ptr(qkv.device))
        _build.check(err, "nans_attention_bwd_long")
    else:
        err = lib.nans_attention_bwd(
            qkv.data_ptr(), dctx.data_ptr(), ptr(key_bias), ptr(d32), d16.data_ptr(), batch,
            seq, w, dh, 1.0 / math.sqrt(dh), *drop.kernel_args(dropout),
            _build.stream_ptr(qkv.device))
        _build.check(err, "nans_attention_bwd")
    attention_bwd.launches += 1
    return d32, d16


attention.launches = 0
attention_bwd.launches = 0
