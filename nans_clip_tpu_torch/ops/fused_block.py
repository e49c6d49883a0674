"""Transformer sub-blocks as chains of the hand-written Hopper kernels.

Ports of ``nans_clip_tpu/ops/fused_block.py``:

* ``_kernel`` (fused_block.py:103) -> :func:`fused_attention_block` (pre-LN,
  ViT) and :func:`fused_bert_attention_block` (post-LN, key-masked, BERT);
* ``_mlp_kernel`` (fused_block.py:797) -> :func:`fused_mlp_block`.

On the TPU each sub-block was one kernel, because 64-110 MB of VMEM held a
whole weight set. A Hopper SM has 227 KB of shared memory, so each becomes a
short chain that computes the same function with the same rounding points:

* attention, pre-LN:  LN -> GEMM(Wqkv, +bqkv) -> attention -> GEMM(Wo, +bo, +x)
* attention, post-LN: GEMM(Wqkv, +bqkv) -> attention -> GEMM(Wo, +bo, +x; fp32) -> LN
* MLP: [LN] -> GEMM(w1, +b1, act) -> GEMM(w2, +b2, +x) [-> fp32 sum -> LN]

(``csrc/layernorm.cu``, ``csrc/gemm.cu``, ``csrc/attention.cu``). Deterministic
forward only. Weights are in the torch Linear layout ``[out, in]``.

``_reference_block`` and ``_reference_mlp`` are the plain-torch twins: the
same chains through the kernels' plain versions. The public wrappers run
the twins for CPU tensors and the kernels for CUDA tensors (or raise),
and count their kernel launches in ``.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from nans_clip_tpu_torch.ops.attention import attention, attention_plain
from nans_clip_tpu_torch.ops.gemm import linear, linear_plain
from nans_clip_tpu_torch.ops.layernorm import layer_norm, row_layer_norm

KERNEL_OPS = (row_layer_norm, linear, attention)
PLAIN_OPS = (layer_norm, linear_plain, attention_plain)


def attention_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, eps: float,
                    key_bias: Optional[torch.Tensor], post_ln: bool, ops):
    """One attention sub-block through ``ops`` = (layer norm, linear,
    attention). x: [B, S, W] in the io dtype; returns the same."""
    ln, lin, attn = ops
    b, s, w = x.shape
    x2 = x.reshape(b * s, w)
    xn = x2 if post_ln else ln(x2, ln_w, ln_b, eps)
    qkv = lin(xn, w_qkv, b_qkv)
    ctx = attn(qkv, key_bias, b, heads)
    if post_ln:
        out = ln(lin(ctx, w_o, b_o, residual=x2, out_dtype=torch.float32), ln_w, ln_b, eps,
                 out_dtype=x.dtype)
    else:
        out = lin(ctx, w_o, b_o, residual=x2)
    return out.reshape(b, s, w)


def mlp_chain(x, ln_w, ln_b, w1, b1, w2, b2, act: str, eps: float, post_ln: bool, ops):
    """One MLP sub-block through ``ops``. x: [B, S, W]; returns the same."""
    ln, lin, _ = ops
    b, s, w = x.shape
    x2 = x.reshape(b * s, w)
    xn = x2 if post_ln else ln(x2, ln_w, ln_b, eps)
    h = lin(xn, w1, b1, act=act)
    if post_ln:
        out = ln(lin(h, w2, b2, residual=x2, out_dtype=torch.float32), ln_w, ln_b, eps,
                 out_dtype=x.dtype)
    else:
        out = lin(h, w2, b2, residual=x2)
    return out.reshape(b, s, w)


def _reference_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, eps: float,
                     key_bias=None, post_ln: bool = False):
    """Plain-torch twin of the attention sub-block.
    pre-LN: x + proj(MHA(LN(x))); post-LN: LN(x + proj(MHA(x))) with an
    additive [B, S] key bias."""
    return attention_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps, key_bias,
                           post_ln, PLAIN_OPS)


def _reference_mlp(x, ln_w, ln_b, w1, b1, w2, b2, act: str, eps: float, post_ln: bool):
    """Plain-torch twin of the MLP sub-block.
    pre-LN: x + fc2(act(fc1(LN(x)))); post-LN: LN(x + fc2(act(fc1(x))))."""
    return mlp_chain(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, PLAIN_OPS)


def fused_attention_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int,
                          eps: float = 1e-5):
    """ViT pre-LN layout: x + out_proj(MHA(LN(x))). x: [B, S, W]."""
    if not x.is_cuda:
        return _reference_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps)
    out = attention_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps, None, False,
                          KERNEL_OPS)
    fused_attention_block.launches += 1
    return out


def fused_bert_attention_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias,
                               heads: int, eps: float = 1e-12):
    """BERT post-LN layout: LN(x + out_proj(MHA(x))) with the additive
    padding bias ``key_bias`` [B, S] (fp32)."""
    if not x.is_cuda:
        return _reference_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps,
                                key_bias, post_ln=True)
    out = attention_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps, key_bias, True,
                          KERNEL_OPS)
    fused_bert_attention_block.launches += 1
    return out


def fused_mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, act: str = "quick_gelu",
                    eps: float = 1e-5, post_ln: bool = False):
    """x + fc2(act(fc1(LN(x)))) (pre-LN) or LN(x + fc2(act(fc1(x)))) (post-LN)."""
    if not x.is_cuda:
        return _reference_mlp(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln)
    out = mlp_chain(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, KERNEL_OPS)
    fused_mlp_block.launches += 1
    return out


fused_attention_block.launches = 0
fused_bert_attention_block.launches = 0
fused_mlp_block.launches = 0
