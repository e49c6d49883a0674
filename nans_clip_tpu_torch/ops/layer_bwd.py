"""The whole pre-LN layer's training backward in one call.

Port of ``nans_clip_tpu/ops/layer_bwd.py``: ``_layer_bwd_fullgrad_kernel``
(:74) -> :func:`fused_layer_block_bwd_fullgrad` (#21), and its
``custom_vjp`` ``fused_layer_train`` (:216) -> :func:`fused_layer_train`.

The TPU kernel chained the MLP backward body and the attention backward
body in one grid cell, so that the gradient between them stayed in VMEM. On
the card it is the MLP chain (#18's) and then the attention chain (#14's) of
``ops/fused_block_bwd.py`` in one call, the gradient between them rounded to
the io dtype exactly as the kernel rounds it (:101-103), through L2/HBM: the
same kernels of ``csrc/`` in the same order as #18 followed by #14, so the
13 outputs are bit-equal to that pair's. ViT pre-LN, no dropout, as in JAX.

``fused_layer_train`` is one autograd Function a layer: forward #1 then #2,
saving only the layer's input ``x`` and the attention sub-block's output
``xm`` (:224-232); backward #21. Every weight of the layer must need its
gradient (the towers route a layer with a frozen weight through the
sub-block Functions of ``ops/fused_block.py`` instead).
"""

from __future__ import annotations

import torch

from nans_clip_tpu_torch.ops import fused_block as fb
from nans_clip_tpu_torch.ops.fused_block_bwd import (KERNEL_OPS, PLAIN_OPS, BwdOps,
                                                     attention_bwd_chain, mlp_bwd_chain)


def layer_bwd_chain(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, xm, ln2_w, ln2_b, w1, b1, w2, b2, g,
                    heads: int, act: str, eps: float, ops: BwdOps):
    """MLP backward at ``xm``, its dx (io dtype) as the attention backward's
    g at ``x``. Returns (dx, dwqkv, dbqkv, dwo, dbo, d_ln1_w, d_ln1_b, dw1,
    db1, dw2, db2, d_ln2_w, d_ln2_b) (layer_bwd.py:156-159)."""
    dxm, *mlp_grads = mlp_bwd_chain(xm, ln2_w, ln2_b, w1, b1, w2, b2, None, g, act, eps, False,
                                    0.0, ops)
    dx, *attn_grads = attention_bwd_chain(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, dxm, heads, eps,
                                          ops)
    return (dx, *attn_grads, *mlp_grads)


def _layer_bwd_math(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, xm, ln2_w, ln2_b, w1, b1, w2, b2, g,
                    heads: int, act: str = "quick_gelu", eps: float = 1e-5):
    """Plain twin of #21."""
    return layer_bwd_chain(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, xm, ln2_w, ln2_b, w1, b1, w2, b2,
                           g, heads, act, eps, PLAIN_OPS)


def fused_layer_block_bwd_fullgrad(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, xm, ln2_w, ln2_b, w1,
                                   b1, w2, b2, g, heads: int, act: str = "quick_gelu",
                                   eps: float = 1e-5):
    """#21. ``xm``: the attention sub-block's output. x, xm, g: [B, S, W] in
    the io dtype; weight gradients fp32 ``[out, in]``."""
    args = (x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, xm, ln2_w, ln2_b, w1, b1, w2, b2, g, heads, act,
            eps)
    if not x.is_cuda:
        return _layer_bwd_math(*args)
    out = layer_bwd_chain(*args, KERNEL_OPS)
    fused_layer_block_bwd_fullgrad.launches += 1
    return out


class _LayerTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b, w1, b1, w2, b2,
                heads, act, eps, use_kernel):
        attn = fb.fused_attention_block if use_kernel else fb._reference_block
        xm = attn(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, heads, eps)
        mlp = fb.fused_mlp_block if use_kernel else fb._reference_mlp
        y = mlp(xm, ln2_w, ln2_b, w1, b1, w2, b2, act, eps, False)
        ctx.save_for_backward(x, xm, ln1_w, ln1_b, w_qkv, b_qkv, w_o, ln2_w, ln2_b, w1, b1, w2,
                              b2)
        ctx.config = (heads, act, eps, use_kernel)
        return y

    @staticmethod
    def backward(ctx, g):
        x, xm, ln1_w, ln1_b, w_qkv, b_qkv, w_o, ln2_w, ln2_b, w1, b1, w2, b2 = ctx.saved_tensors
        heads, act, eps, use_kernel = ctx.config
        if not all(ctx.needs_input_grad[1:13]):
            raise RuntimeError("fused_layer_train forms every weight gradient: route a layer "
                               "with a frozen weight through the sub-block Functions")
        bwd = fused_layer_block_bwd_fullgrad if use_kernel else _layer_bwd_math
        (dx, dwqkv, dbqkv, dwo, dbo, d1w, d1b, dw1, db1, dw2, db2, d2w, d2b) = bwd(
            x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, xm, ln2_w, ln2_b, w1, b1, w2, b2,
            g.contiguous(), heads, act, eps)
        return (dx, d1w, d1b, dwqkv, dbqkv, dwo, dbo, d2w, d2b, dw1, db1, dw2, db2,
                None, None, None, None)


def fused_layer_train(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b, w1, b1, w2, b2,
                      heads: int, act: str = "quick_gelu", eps: float = 1e-5,
                      use_kernel: bool = True):
    """One pre-LN layer with its whole-layer backward. ``use_kernel``: the
    kernels (CUDA tensors) or the twins."""
    return _LayerTrain.apply(x, ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b, w1, b1, w2,
                             b2, heads, act, eps, use_kernel)


fused_layer_block_bwd_fullgrad.launches = 0
