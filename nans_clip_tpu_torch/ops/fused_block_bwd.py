"""Backward passes of the transformer sub-blocks, as chains of the
hand-written Hopper kernels.

Ports of ``nans_clip_tpu/ops/fused_block_bwd.py``:

* ``_bwd_fullgrad_kernel`` (:229; math ``_attn_bwd_math`` :134) ->
  :func:`fused_attention_block_bwd_fullgrad` (pre-LN, ViT), #14;
* ``_bert_bwd_fullgrad_kernel`` (:404; math ``_bert_bwd_math`` :273) ->
  :func:`fused_bert_attention_block_bwd_fullgrad` (post-LN, key-masked,
  attention and hidden dropout, BERT), #16;
* ``_mlp_bwd_fullgrad_kernel`` (:894; math ``_mlp_bwd_math`` :709) ->
  :func:`fused_mlp_block_bwd_fullgrad` (pre-LN quick-GELU or post-LN
  erf-GELU with hidden dropout), #18.

Each TPU kernel recomputed its sub-block's forward in VMEM, formed dx and
accumulated fp32 weight gradients across a batch grid run in order. On the
card each is a chain of the kernels of ``csrc/``: the forward recompute
(``layernorm.cu``, ``gemm.cu``, ``attention.cu``), the attention backward
(``attention.cu``), the input-gradient and weight-gradient products
(``gemm.cu``), the LayerNorm backward (``layernorm.cu``) and fixed-order
column sums (``reduce.cu``), with the TPU kernels' rounding points: dqkv,
dS, P (after its dropout), dproj and dh_pre are rounded to the io dtype
before the products that read them, weight gradients are fp32. Dropout
masks are redrawn from the forward's seed (``ops/dropout.py``), nothing is
stored.

Outputs have the JAX signature and order: ``(dx, dW_a, db_a, dW_b, db_b,
d_ln_weight, d_ln_bias)``, dx in the io dtype, weight gradients fp32 in the
port's ``[out, in]`` layout, vectors fp32 ``[N]``.

``_attn_bwd_math``, ``_bert_bwd_math`` and ``_mlp_bwd_math`` are the plain
twins: the same chains through the kernels' plain versions, step by step as
the JAX math bodies. The public wrappers run the twins for CPU tensors and
the kernels for CUDA tensors (or raise), and count their calls in
``.launches``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.ops.attention import (attention, attention_bwd, attention_bwd_plain,
                                               attention_plain)
from nans_clip_tpu_torch.ops.gemm import (linear, linear_dgrad, linear_dgrad_plain,
                                          linear_plain, linear_wgrad, linear_wgrad_plain)
from nans_clip_tpu_torch.ops.layernorm import (layer_norm, layer_norm_bwd, layer_norm_bwd_plain,
                                               row_layer_norm)
from nans_clip_tpu_torch.ops.reduce import column_sum, column_sum_plain


class BwdOps(NamedTuple):
    ln: object
    lin: object
    attn: object
    dgrad: object
    wgrad: object
    colsum: object
    ln_bwd: object
    attn_bwd: object


KERNEL_OPS = BwdOps(row_layer_norm, linear, attention, linear_dgrad, linear_wgrad, column_sum,
                    layer_norm_bwd, attention_bwd)
PLAIN_OPS = BwdOps(layer_norm, linear_plain, attention_plain, linear_dgrad_plain,
                   linear_wgrad_plain, column_sum_plain, layer_norm_bwd_plain,
                   attention_bwd_plain)


def attention_bwd_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads: int, eps: float,
                        ops: BwdOps):
    """#14: pre-LN attention sub-block backward (``_attn_bwd_math``).
    x, g: [B, S, W] in the io dtype."""
    b, s, w = x.shape
    x2, g2 = x.reshape(b * s, w), g.reshape(b * s, w)
    # forward recompute
    xn = ops.ln(x2, ln_w, ln_b, eps)                         # io dtype (:155)
    qkv = ops.lin(xn, w_qkv, b_qkv)                          # q/k/v in the io dtype (:170)
    ctx = ops.attn(qkv, None, b, heads)                      # io dtype (:246)
    # backward
    dctx = ops.dgrad(g2, w_o)                                # g . Wo, io dtype (:161, :181)
    dqkv32, dqkv = ops.attn_bwd(qkv, dctx, None, b, heads)   # fp32 and io dtype (:201, :205)
    dxn = ops.dgrad(dqkv, w_qkv, out_dtype=torch.float32)    # (:205)
    dx, d_scale, d_bias, _, _ = ops.ln_bwd(dxn, x2, ln_w, eps, residual=g2,
                                           out_dtype=x.dtype)  # g + dx_ln (:209-213, :251-252)
    dwqkv = ops.wgrad(dqkv, xn)                              # (:243)
    dwo = ops.wgrad(g2, ctx)                                 # (:246)
    return (dx.reshape(b, s, w), dwqkv, ops.colsum(dqkv32), dwo, ops.colsum(g2), d_scale,
            d_bias)


def bert_attention_bwd_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g,
                             heads: int, eps: float, attn_drop: float, hid_drop: float,
                             ops: BwdOps):
    """#16: post-LN, key-masked attention sub-block backward with attention
    and hidden dropout (``_bert_bwd_math``)."""
    b, s, w = x.shape
    x2, g2 = x.reshape(b * s, w), g.reshape(b * s, w)
    a_drop, h_drop = drop.sub_block(seed, attn_drop, hid_drop, s)
    # forward recompute, as the forward chain formed it
    qkv = ops.lin(x2, w_qkv, b_qkv)                                     # (:293-294)
    ctx = ops.attn(qkv, key_bias, b, heads, a_drop)                     # (:310-329)
    u = ops.lin(ctx, w_o, b_o, residual=x2, out_dtype=torch.float32,
                dropout=h_drop)                                         # (:331-336)
    # backward
    du, d_scale, d_bias, dproj, dbo = ops.ln_bwd(g2, u, ln_w, eps, out_dtype=torch.float32,
                                                 emit_dproj=True, dropout=h_drop)  # (:340-343)
    dctx = ops.dgrad(dproj, w_o)                                        # (:344-346)
    dqkv32, dqkv = ops.attn_bwd(qkv, dctx, key_bias, b, heads, a_drop)  # (:348-378)
    dx = ops.dgrad(dqkv, w_qkv, residual=du, out_dtype=x.dtype)         # du + dx_qkv (:380-383)
    dwqkv = ops.wgrad(dqkv, x2)                                         # (:420)
    dwo = ops.wgrad(dproj, ctx)                                         # (:423)
    return dx.reshape(b, s, w), dwqkv, ops.colsum(dqkv32), dwo, dbo, d_scale, d_bias


def mlp_bwd_chain(x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act: str, eps: float,
                  post_ln: bool, hid_drop: float, ops: BwdOps):
    """#18: MLP sub-block backward, pre-LN or post-LN with hidden dropout
    (``_mlp_bwd_math``)."""
    b, s, w = x.shape
    x2, g2 = x.reshape(b * s, w), g.reshape(b * s, w)
    _, h_drop = drop.sub_block(seed, 0.0, hid_drop, s)
    # forward recompute
    xn = x2 if post_ln else ops.ln(x2, ln_w, ln_b, eps)                 # (:726-733)
    h, h_pre = ops.lin(xn, w1, b1, act=act, pre_out=True)               # (:734-737)
    # backward
    if post_ln:
        u = ops.lin(h, w2, b2, residual=x2, out_dtype=torch.float32, dropout=h_drop)
        du, d_scale, d_bias, dproj, db2 = ops.ln_bwd(
            g2, u, ln_w, eps, out_dtype=torch.float32, emit_dproj=True,
            dropout=h_drop)                                             # (:750-761)
    else:
        du, dproj, db2 = g2, g2, ops.colsum(g2)                         # (:756-759)
    dh32, dh = ops.dgrad(dproj, w2, act=act, aux=h_pre, out_dtype=torch.float32,
                         copy=True)                                     # (:763-766)
    if post_ln:
        dx = ops.dgrad(dh, w1, residual=du, out_dtype=x.dtype)          # du + dxn (:767-771)
    else:
        dxn = ops.dgrad(dh, w1, out_dtype=torch.float32)                # (:767-769)
        dx, d_scale, d_bias, _, _ = ops.ln_bwd(dxn, x2, ln_w, eps, residual=g2,
                                               out_dtype=x.dtype)       # (:773-777, :917-920)
    dw1 = ops.wgrad(dh, xn)                                             # (:909)
    dw2 = ops.wgrad(dproj, h)                                           # (:912)
    return dx.reshape(b, s, w), dw1, ops.colsum(dh32), dw2, db2, d_scale, d_bias


def _attn_bwd_math(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads: int, eps: float):
    """Plain twin of #14."""
    return attention_bwd_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads, eps, PLAIN_OPS)


def _bert_bwd_math(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g, heads: int,
                   eps: float, attn_drop: float = 0.0, hid_drop: float = 0.0):
    """Plain twin of #16."""
    return bert_attention_bwd_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g,
                                    heads, eps, attn_drop, hid_drop, PLAIN_OPS)


def _mlp_bwd_math(x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act: str, eps: float, post_ln: bool,
                  hid_drop: float = 0.0):
    """Plain twin of #18."""
    return mlp_bwd_chain(x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act, eps, post_ln, hid_drop,
                         PLAIN_OPS)


def fused_attention_block_bwd_fullgrad(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads: int,
                                       eps: float = 1e-5):
    """#14: returns (dx, dwqkv, dbqkv, dwo, dbo, d_ln_w, d_ln_b)."""
    if not x.is_cuda:
        return _attn_bwd_math(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads, eps)
    out = attention_bwd_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads, eps, KERNEL_OPS)
    fused_attention_block_bwd_fullgrad.launches += 1
    return out


def fused_bert_attention_block_bwd_fullgrad(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o,
                                            key_bias: Optional[torch.Tensor], seed, g,
                                            heads: int, eps: float = 1e-12,
                                            attn_drop: float = 0.0, hid_drop: float = 0.0):
    """#16: returns (dx, dwqkv, dbqkv, dwo, dbo, d_ln_w, d_ln_b); ``seed``
    and the rates must be the forward's."""
    if not x.is_cuda:
        return _bert_bwd_math(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g, heads,
                              eps, attn_drop, hid_drop)
    out = bert_attention_bwd_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g,
                                   heads, eps, attn_drop, hid_drop, KERNEL_OPS)
    fused_bert_attention_block_bwd_fullgrad.launches += 1
    return out


def fused_mlp_block_bwd_fullgrad(x, ln_w, ln_b, w1, b1, w2, b2, seed, g,
                                 act: str = "quick_gelu", eps: float = 1e-5,
                                 post_ln: bool = False, hid_drop: float = 0.0):
    """#18: returns (dx, dw1, db1, dw2, db2, d_ln_w, d_ln_b)."""
    if not x.is_cuda:
        return _mlp_bwd_math(x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act, eps, post_ln,
                             hid_drop)
    out = mlp_bwd_chain(x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act, eps, post_ln, hid_drop,
                        KERNEL_OPS)
    fused_mlp_block_bwd_fullgrad.launches += 1
    return out


fused_attention_block_bwd_fullgrad.launches = 0
fused_bert_attention_block_bwd_fullgrad.launches = 0
fused_mlp_block_bwd_fullgrad.launches = 0
