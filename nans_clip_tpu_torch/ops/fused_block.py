"""Transformer sub-blocks as chains of the hand-written Hopper kernels.

Ports of ``nans_clip_tpu/ops/fused_block.py``:

* ``_kernel`` (fused_block.py:103) -> :func:`fused_attention_block` (pre-LN,
  ViT) and :func:`fused_bert_attention_block` (post-LN, key-masked, with
  attention-probability and hidden dropout, BERT);
* ``_mlp_kernel`` (fused_block.py:797) -> :func:`fused_mlp_block` (with
  hidden dropout).

On the TPU each sub-block was one kernel, because 64-110 MB of VMEM held a
whole weight set. A Hopper SM has 227 KB of shared memory, so each becomes a
short chain that computes the same function with the same rounding points:

* attention, pre-LN:  LN -> GEMM(Wqkv, +bqkv) -> attention -> GEMM(Wo, +bo, +x)
* attention, post-LN: GEMM(Wqkv, +bqkv) -> attention[drop P] ->
  GEMM(Wo, +bo, drop, +x; fp32) -> LN
* MLP: [LN] -> GEMM(w1, +b1, act) -> GEMM(w2, +b2, [drop], +x) [-> fp32 sum -> LN]

(``csrc/layernorm.cu``, ``csrc/gemm.cu``, ``csrc/attention.cu``). Weights are
in the torch Linear layout ``[out, in]``. Dropout (``ops/dropout.py``) is on
when a ``seed`` and a rate above 0 are given; the backward redraws its masks
from the same seed.

``_reference_block`` and ``_reference_mlp`` are the plain-torch twins: the
same chains through the kernels' plain versions. The public wrappers run
the twins for CPU tensors and the kernels for CUDA tensors (or raise),
and count their kernel launches in ``.launches``.

Training: :func:`attention_block_train` and :func:`mlp_block_train` are
``torch.autograd.Function``s (the JAX ``custom_vjp``s, fused_block.py:268
and :1134). The forward runs the chains above and saves only the block
inputs, the weights, the key bias and the seed (the JAX residuals,
fused_block.py:282, :1147); the backward is #14, #16 or #18
(``ops/fused_block_bwd.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
from nans_clip_tpu_torch.ops.attention import attention, attention_plain
from nans_clip_tpu_torch.ops.gemm import linear, linear_plain
from nans_clip_tpu_torch.ops.layernorm import layer_norm, row_layer_norm

KERNEL_OPS = (row_layer_norm, linear, attention)
PLAIN_OPS = (layer_norm, linear_plain, attention_plain)


def attention_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, eps: float,
                    key_bias: Optional[torch.Tensor], post_ln: bool, ops, seed=None,
                    attn_drop: float = 0.0, hid_drop: float = 0.0):
    """One attention sub-block through ``ops`` = (layer norm, linear,
    attention). x: [B, S, W] in the io dtype; returns the same."""
    ln, lin, attn = ops
    b, s, w = x.shape
    a_drop, h_drop = drop.sub_block(seed, attn_drop, hid_drop, s)
    x2 = x.reshape(b * s, w)
    xn = x2 if post_ln else ln(x2, ln_w, ln_b, eps)
    qkv = lin(xn, w_qkv, b_qkv)
    ctx = attn(qkv, key_bias, b, heads, a_drop)
    if post_ln:
        out = ln(lin(ctx, w_o, b_o, residual=x2, out_dtype=torch.float32, dropout=h_drop),
                 ln_w, ln_b, eps, out_dtype=x.dtype)
    else:
        out = lin(ctx, w_o, b_o, residual=x2, dropout=h_drop)
    return out.reshape(b, s, w)


def mlp_chain(x, ln_w, ln_b, w1, b1, w2, b2, act: str, eps: float, post_ln: bool, ops,
              seed=None, hid_drop: float = 0.0):
    """One MLP sub-block through ``ops``. x: [B, S, W]; returns the same."""
    ln, lin, _ = ops
    b, s, w = x.shape
    _, h_drop = drop.sub_block(seed, 0.0, hid_drop, s)
    x2 = x.reshape(b * s, w)
    xn = x2 if post_ln else ln(x2, ln_w, ln_b, eps)
    h = lin(xn, w1, b1, act=act)
    if post_ln:
        out = ln(lin(h, w2, b2, residual=x2, out_dtype=torch.float32, dropout=h_drop),
                 ln_w, ln_b, eps, out_dtype=x.dtype)
    else:
        out = lin(h, w2, b2, residual=x2, dropout=h_drop)
    return out.reshape(b, s, w)


def _reference_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, eps: float,
                     key_bias=None, post_ln: bool = False, seed=None, attn_drop: float = 0.0,
                     hid_drop: float = 0.0):
    """Plain-torch twin of the attention sub-block.
    pre-LN: x + proj(MHA(LN(x))); post-LN: LN(x + drop(proj(MHA_drop(x))))
    with an additive [B, S] key bias."""
    return attention_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps, key_bias,
                           post_ln, PLAIN_OPS, seed, attn_drop, hid_drop)


def _reference_mlp(x, ln_w, ln_b, w1, b1, w2, b2, act: str, eps: float, post_ln: bool,
                   seed=None, hid_drop: float = 0.0):
    """Plain-torch twin of the MLP sub-block.
    pre-LN: x + fc2(act(fc1(LN(x)))); post-LN: LN(x + drop(fc2(act(fc1(x)))))."""
    return mlp_chain(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, PLAIN_OPS, seed,
                     hid_drop)


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
                               heads: int, eps: float = 1e-12, seed=None,
                               attn_drop: float = 0.0, hid_drop: float = 0.0):
    """BERT post-LN layout: LN(x + drop(out_proj(MHA_drop(x)))) with the
    additive padding bias ``key_bias`` [B, S] (fp32) (modeling_bert.py:118-152)."""
    if not x.is_cuda:
        return _reference_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps,
                                key_bias, True, seed, attn_drop, hid_drop)
    out = attention_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps, key_bias, True,
                          KERNEL_OPS, seed, attn_drop, hid_drop)
    fused_bert_attention_block.launches += 1
    return out


def fused_mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, act: str = "quick_gelu",
                    eps: float = 1e-5, post_ln: bool = False, seed=None,
                    hid_drop: float = 0.0):
    """x + fc2(act(fc1(LN(x)))) (pre-LN) or LN(x + drop(fc2(act(fc1(x)))))
    (post-LN)."""
    if not x.is_cuda:
        return _reference_mlp(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, seed,
                              hid_drop)
    out = mlp_chain(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, KERNEL_OPS, seed,
                    hid_drop)
    fused_mlp_block.launches += 1
    return out


class _AttentionBlock(torch.autograd.Function):
    """The attention sub-block under autograd: forward #1, backward #14
    (pre-LN) or #16 (post-LN); the twins where ``use_kernel`` is False."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, heads, eps, post_ln,
                seed, attn_drop, hid_drop, use_kernel):
        weights = (ln_w, ln_b, w_qkv, b_qkv, w_o, b_o)
        if not use_kernel:
            out = _reference_block(x, *weights, heads, eps, key_bias, post_ln, seed, attn_drop,
                                   hid_drop)
        elif post_ln:
            out = fused_bert_attention_block(x, *weights, key_bias, heads, eps, seed, attn_drop,
                                             hid_drop)
        else:
            out = fused_attention_block(x, *weights, heads, eps)
        ctx.save_for_backward(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias)
        ctx.config = (heads, eps, post_ln, seed, attn_drop, hid_drop, use_kernel)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias = ctx.saved_tensors
        heads, eps, post_ln, seed, attn_drop, hid_drop, use_kernel = ctx.config
        g = g.contiguous()
        if post_ln:
            bwd = (fbb.fused_bert_attention_block_bwd_fullgrad if use_kernel
                   else fbb._bert_bwd_math)
            grads = bwd(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g, heads, eps,
                        attn_drop, hid_drop)
        else:
            bwd = fbb.fused_attention_block_bwd_fullgrad if use_kernel else fbb._attn_bwd_math
            grads = bwd(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads, eps)
        dx, dwqkv, dbqkv, dwo, dbo, d_ln_w, d_ln_b = grads
        return (dx, d_ln_w, d_ln_b, dwqkv, dbqkv, dwo, dbo) + (None,) * 8


class _MlpBlock(torch.autograd.Function):
    """The MLP sub-block under autograd: forward #2, backward #18; the twins
    where ``use_kernel`` is False."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, seed, hid_drop,
                use_kernel):
        fwd = fused_mlp_block if use_kernel else _reference_mlp
        out = fwd(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, seed, hid_drop)
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.config = (act, eps, post_ln, seed, hid_drop, use_kernel)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w1, b1, w2, b2 = ctx.saved_tensors
        act, eps, post_ln, seed, hid_drop, use_kernel = ctx.config
        bwd = fbb.fused_mlp_block_bwd_fullgrad if use_kernel else fbb._mlp_bwd_math
        dx, dw1, db1, dw2, db2, d_ln_w, d_ln_b = bwd(x, ln_w, ln_b, w1, b1, w2, b2, seed,
                                                     g.contiguous(), act, eps, post_ln,
                                                     hid_drop)
        return (dx, d_ln_w, d_ln_b, dw1, db1, dw2, db2) + (None,) * 6


def attention_block_train(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, heads: int,
                          eps: float, post_ln: bool, seed=None, attn_drop: float = 0.0,
                          hid_drop: float = 0.0, use_kernel: bool = True):
    """The attention sub-block with its backward: pre-LN (ViT, no mask or
    dropout) or post-LN (BERT). ``use_kernel``: the kernels (CUDA tensors)
    or the twins."""
    return _AttentionBlock.apply(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, heads, eps,
                                 post_ln, seed, attn_drop, hid_drop, use_kernel)


def mlp_block_train(x, ln_w, ln_b, w1, b1, w2, b2, act: str, eps: float, post_ln: bool,
                    seed=None, hid_drop: float = 0.0, use_kernel: bool = True):
    """The MLP sub-block with its backward."""
    return _MlpBlock.apply(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, seed, hid_drop,
                           use_kernel)


fused_attention_block.launches = 0
fused_bert_attention_block.launches = 0
fused_mlp_block.launches = 0
