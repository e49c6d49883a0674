"""Multi-head attention over a packed QKV buffer, and its kernel
``csrc/attention.cu``.

``qkv``: ``[B*S, 3W]`` with the q heads, then the k heads, then the v heads
(``nans_clip_tpu/ops/fused_block.py:136-138``); ``key_bias``: ``[B, S]``
additive fp32 or None. Returns ctx ``[B*S, W]``. Scores and softmax
statistics are fp32; q/k/v, P and ctx are in the io dtype, the rounding
points of the attention loop in ``fused_block.py::_kernel`` (:164-182).

``attention_plain`` is the twin; CPU tensors take it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nans_clip_tpu_torch.ops import _build, gates


def attention_plain(qkv: torch.Tensor, key_bias: Optional[torch.Tensor],
                    batch: int, heads: int) -> torch.Tensor:
    rows, w3 = qkv.shape
    seq, w = rows // batch, w3 // 3
    dh = w // heads
    # [B, S, 3, H, dh] -> three [B, H, S, dh]
    q, k, v = qkv.view(batch, seq, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    if key_bias is not None:
        s = s + key_bias.float().view(batch, 1, 1, seq)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(p.to(qkv.dtype).float(), v.float())
    return ctx.to(qkv.dtype).permute(0, 2, 1, 3).reshape(rows, w)


def attention(qkv: torch.Tensor, key_bias: Optional[torch.Tensor],
              batch: int, heads: int) -> torch.Tensor:
    """CPU tensors take :func:`attention_plain`; CUDA tensors launch the
    kernel (bf16 qkv, head dim 64, S <= 640)."""
    if not qkv.is_cuda:
        return attention_plain(qkv, key_bias, batch, heads)
    rows, w3 = qkv.shape
    seq, w = rows // batch, w3 // 3
    gates.admit(rows == batch * seq and w3 == 3 * w, f"attention: qkv {tuple(qkv.shape)}")
    gates.admit(w == heads * gates.HEAD_DIM, f"attention: head dim {w // heads}")
    gates.admit(seq <= gates.MAX_SEQ, f"attention: S={seq}")
    gates.admit_cuda("attention", qkv)
    if key_bias is not None:
        gates.admit(key_bias.is_cuda and key_bias.dtype == torch.float32
                    and key_bias.is_contiguous() and key_bias.numel() == batch * seq,
                    "attention: key_bias must be contiguous fp32 [B, S] on CUDA")
    ctx = torch.empty((rows, w), dtype=qkv.dtype, device=qkv.device)
    err = _build.library().nans_attention(
        qkv.data_ptr(), None if key_bias is None else key_bias.data_ptr(), ctx.data_ptr(),
        batch, seq, w, 1.0 / math.sqrt(gates.HEAD_DIM), _build.stream_ptr(qkv.device))
    _build.check(err, "nans_attention")
    attention.launches += 1
    return ctx


attention.launches = 0
