"""Backward passes of the transformer sub-blocks, as chains of the
hand-written Hopper kernels.

Ports of ``nans_clip_tpu/ops/fused_block_bwd.py``:

* ``_bwd_fullgrad_kernel`` (:229; math ``_attn_bwd_math`` :134) ->
  :func:`fused_attention_block_bwd_fullgrad` (pre-LN, ViT), #14, and
  ``_bwd_kernel`` (:216) -> :func:`fused_attention_block_bwd`, #13;
* ``_bert_bwd_fullgrad_kernel`` (:404; math ``_bert_bwd_math`` :273) ->
  :func:`fused_bert_attention_block_bwd_fullgrad` (post-LN, key-masked,
  attention and hidden dropout, BERT), #16, and ``_bert_bwd_kernel`` (:386)
  -> :func:`fused_bert_attention_block_bwd`, #15;
* ``_mlp_bwd_fullgrad_kernel`` (:894; math ``_mlp_bwd_math`` :709) ->
  :func:`fused_mlp_block_bwd_fullgrad` (pre-LN quick-GELU or post-LN
  erf-GELU with hidden dropout), #18, and ``_mlp_bwd_kernel`` (:781) ->
  :func:`fused_mlp_block_bwd`, #17.

* ``_mlp_bwd_chunked_kernel`` (:1015) -> :func:`fused_mlp_block_bwd_chunked`,
  #19: the pre-LN emitting MLP chain at the wide widths, no dropout;
* ``_attn_bwd_chunked_kernel`` (:1144) -> :func:`fused_attention_block_bwd_chunked`,
  #20: the pre-LN emitting attention chain with the long-sequence attention
  backward of ``attention.cu`` (S up to 640, heads of 64 or 80), its outputs
  laid out by head chunks as JAX returns them.

#13, #15, #17, #19 and #20 are the emitting forms: the same chain bodies with ``full``
False, which leaves out the weight-gradient products and every column sum
and returns dx with the recomputed activations, in the io dtype and in the
JAX wrappers' order, for a caller that forms only the weight gradients it
needs (``ops/fused_block.py``).

Each TPU kernel recomputed its sub-block's forward in VMEM, formed dx and
accumulated fp32 weight gradients across a batch grid run in order. On the
card each is a chain of the kernels of ``csrc/``: the forward recompute
(``layernorm.cu``, ``gemm.cu``, ``attention.cu``), the attention backward
(``attention.cu``, from the forward recompute's softmax row statistics),
the input-gradient and weight-gradient products
(``gemm.cu``), the LayerNorm backward (``layernorm.cu``) and fixed-order
column sums (``reduce.cu``), with the TPU kernels' rounding points: dqkv,
dS, P (after its dropout), dproj and dh_pre are rounded to the io dtype
before the products that read them, weight gradients are fp32. Dropout
masks are redrawn from the forward's seed (``ops/dropout.py``), nothing is
stored.

Outputs of the full-gradient forms have the JAX signature and order: ``(dx,
dW_a, db_a, dW_b, db_b, d_ln_weight, d_ln_bias)``, dx in the io dtype,
weight gradients fp32 in the port's ``[out, in]`` layout, vectors fp32
``[N]``. The emitting forms return ``(dx, xn, ctx, dqkv)`` (#13), ``(dx,
dqkv, ctx, dproj, uhat)`` (#15) and ``(dx, xn, h, dh_pre, dproj, lnstat,
dxn)`` (#17; ``lnstat`` is x-hat pre-LN and u-hat post-LN, ``xn`` is x
post-LN, ``dproj`` is g pre-LN), every tensor ``[B, S, .]`` in the io dtype.

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


def _pair(out):
    """(value, copy) of a dgrad call made with or without ``copy``."""
    return out if isinstance(out, tuple) else (out, None)


def attention_bwd_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads: int, eps: float,
                        ops: BwdOps, full: bool = True):
    """#14 (``full``) or #13: pre-LN attention sub-block backward
    (``_attn_bwd_math``). x, g: [B, S, W] in the io dtype."""
    b, s, w = x.shape
    x2, g2 = x.reshape(b * s, w), g.reshape(b * s, w)
    # forward recompute
    xn = ops.ln(x2, ln_w, ln_b, eps)                         # io dtype (:155)
    qkv = ops.lin(xn, w_qkv, b_qkv)                          # q/k/v in the io dtype (:170)
    ctx, stats = ops.attn(qkv, None, b, heads, stats=True)   # io dtype (:246); P's row stats
    # backward
    dctx = ops.dgrad(g2, w_o)                                # g . Wo, io dtype (:161, :181)
    dqkv32, dqkv = ops.attn_bwd(qkv, dctx, None, b, heads, need32=full,
                                stats=stats)                 # fp32 and io dtype (:201, :205)
    dxn = ops.dgrad(dqkv, w_qkv, out_dtype=torch.float32)    # (:205)
    dx, d_scale, d_bias = ops.ln_bwd(dxn, x2, ln_w, eps, residual=g2, out_dtype=x.dtype,
                                     sums=full)[:3]          # g + dx_ln (:209-213, :251-252)
    dx = dx.reshape(b, s, w)
    if not full:
        return dx, xn.view(b, s, w), ctx.view(b, s, w), dqkv.view(b, s, 3 * w)   # (:223-226)
    dwqkv = ops.wgrad(dqkv, xn)                              # (:243)
    dwo = ops.wgrad(g2, ctx)                                 # (:246)
    return dx, dwqkv, ops.colsum(dqkv32), dwo, ops.colsum(g2), d_scale, d_bias


def bert_attention_bwd_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g,
                             heads: int, eps: float, attn_drop: float, hid_drop: float,
                             ops: BwdOps, full: bool = True):
    """#16 (``full``) or #15: post-LN, key-masked attention sub-block
    backward with attention and hidden dropout (``_bert_bwd_math``)."""
    b, s, w = x.shape
    x2, g2 = x.reshape(b * s, w), g.reshape(b * s, w)
    a_drop, h_drop = drop.sub_block(seed, attn_drop, hid_drop, s)
    # forward recompute, as the forward chain formed it
    qkv = ops.lin(x2, w_qkv, b_qkv)                                     # (:293-294)
    ctx, stats = ops.attn(qkv, key_bias, b, heads, a_drop, stats=True)  # (:310-329)
    u = ops.lin(ctx, w_o, b_o, residual=x2, out_dtype=torch.float32,
                dropout=h_drop)                                         # (:331-336)
    # backward
    du, d_scale, d_bias, dproj, dbo, *uhat = ops.ln_bwd(
        g2, u, ln_w, eps, out_dtype=torch.float32, emit_dproj=True, dropout=h_drop,
        emit_xhat=not full, sums=full)                                  # (:340-343)
    dctx = ops.dgrad(dproj, w_o)                                        # (:344-346)
    dqkv32, dqkv = ops.attn_bwd(qkv, dctx, key_bias, b, heads, a_drop, need32=full,
                                stats=stats)                            # (:348-378)
    dx = ops.dgrad(dqkv, w_qkv, residual=du, out_dtype=x.dtype)         # du + dx_qkv (:380-383)
    dx = dx.reshape(b, s, w)
    if not full:
        return (dx, dqkv.view(b, s, 3 * w), ctx.view(b, s, w), dproj.view(b, s, w),
                uhat[0].view(b, s, w))                                  # (:397-401)
    dwqkv = ops.wgrad(dqkv, x2)                                         # (:420)
    dwo = ops.wgrad(dproj, ctx)                                         # (:423)
    return dx, dwqkv, ops.colsum(dqkv32), dwo, dbo, d_scale, d_bias


def mlp_bwd_chain(x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act: str, eps: float,
                  post_ln: bool, hid_drop: float, ops: BwdOps, full: bool = True):
    """#18 (``full``) or #17: MLP sub-block backward, pre-LN or post-LN with
    hidden dropout (``_mlp_bwd_math``)."""
    b, s, w = x.shape
    x2, g2 = x.reshape(b * s, w), g.reshape(b * s, w)
    _, h_drop = drop.sub_block(seed, 0.0, hid_drop, s)
    # forward recompute
    xn = x2 if post_ln else ops.ln(x2, ln_w, ln_b, eps)                 # (:726-733)
    h, h_pre = ops.lin(xn, w1, b1, act=act, pre_out=True)               # (:734-737)
    # backward
    if post_ln:
        u = ops.lin(h, w2, b2, residual=x2, out_dtype=torch.float32, dropout=h_drop)
        du, d_scale, d_bias, dproj, db2, *lnstat = ops.ln_bwd(
            g2, u, ln_w, eps, out_dtype=torch.float32, emit_dproj=True, dropout=h_drop,
            emit_xhat=not full, sums=full)                              # (:750-761)
    else:
        du, dproj, db2 = g2, g2, ops.colsum(g2) if full else None       # (:756-759)
    dh32, dh = _pair(ops.dgrad(dproj, w2, act=act, aux=h_pre, copy=full,
                               out_dtype=torch.float32 if full else x.dtype))  # (:763-766)
    dh = dh32 if dh is None else dh
    # the emitting form also takes dxn in the io dtype, rounded from the
    # fp32 value that dx is formed from (:767-777, :798)
    if post_ln:
        dx, dxn = _pair(ops.dgrad(dh, w1, residual=du, out_dtype=x.dtype,
                                  copy=not full))                       # du + dxn (:767-771)
    else:
        dxn32, dxn = _pair(ops.dgrad(dh, w1, out_dtype=torch.float32,
                                     copy=not full))                    # (:767-769)
        dx, d_scale, d_bias, _, _, *lnstat = ops.ln_bwd(
            dxn32, x2, ln_w, eps, residual=g2, out_dtype=x.dtype, emit_xhat=not full,
            sums=full)                                                  # (:773-777, :917-920)
    dx = dx.reshape(b, s, w)
    if not full:
        r3 = lambda t: t.view(b, s, -1)
        return dx, r3(xn), r3(h), r3(dh), r3(dproj), r3(lnstat[0]), r3(dxn)  # (:792-798)
    dw1 = ops.wgrad(dh, xn)                                             # (:909)
    dw2 = ops.wgrad(dproj, h)                                           # (:912)
    return dx, dw1, ops.colsum(dh32), dw2, db2, d_scale, d_bias


def _attn_bwd_math(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads: int, eps: float,
                   full: bool = True):
    """Plain twin of #14, and of #13 with ``full`` False."""
    return attention_bwd_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads, eps, PLAIN_OPS, full)


def _bert_bwd_math(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g, heads: int,
                   eps: float, attn_drop: float = 0.0, hid_drop: float = 0.0,
                   full: bool = True):
    """Plain twin of #16, and of #15 with ``full`` False."""
    return bert_attention_bwd_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g,
                                    heads, eps, attn_drop, hid_drop, PLAIN_OPS, full)


def _mlp_bwd_math(x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act: str, eps: float, post_ln: bool,
                  hid_drop: float = 0.0, full: bool = True):
    """Plain twin of #18, and of #17 with ``full`` False."""
    return mlp_bwd_chain(x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act, eps, post_ln, hid_drop,
                         PLAIN_OPS, full)


def _run(wrapper, chain, math, full, x, *args):
    """One public wrapper's call: the twin for CPU tensors, else the kernels
    (or they raise), with one launch counted."""
    if not x.is_cuda:
        return math(x, *args, full=full)
    out = chain(x, *args, KERNEL_OPS, full)
    wrapper.launches += 1
    return out


def fused_attention_block_bwd_fullgrad(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads: int,
                                       eps: float = 1e-5):
    """#14: returns (dx, dwqkv, dbqkv, dwo, dbo, d_ln_w, d_ln_b)."""
    return _run(fused_attention_block_bwd_fullgrad, attention_bwd_chain, _attn_bwd_math, True,
                x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads, eps)


def fused_attention_block_bwd(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads: int,
                              eps: float = 1e-5):
    """#13: returns (dx, xn, ctx, dqkv); the caller forms the weight
    gradients it needs (``dwqkv = dqkv^T xn``, ``dwo = g^T ctx``, ...)."""
    return _run(fused_attention_block_bwd, attention_bwd_chain, _attn_bwd_math, False,
                x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads, eps)


def fused_bert_attention_block_bwd_fullgrad(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o,
                                            key_bias: Optional[torch.Tensor], seed, g,
                                            heads: int, eps: float = 1e-12,
                                            attn_drop: float = 0.0, hid_drop: float = 0.0):
    """#16: returns (dx, dwqkv, dbqkv, dwo, dbo, d_ln_w, d_ln_b); ``seed``
    and the rates must be the forward's."""
    return _run(fused_bert_attention_block_bwd_fullgrad, bert_attention_bwd_chain,
                _bert_bwd_math, True, x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g,
                heads, eps, attn_drop, hid_drop)


def fused_bert_attention_block_bwd(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o,
                                   key_bias: Optional[torch.Tensor], seed, g, heads: int,
                                   eps: float = 1e-12, attn_drop: float = 0.0,
                                   hid_drop: float = 0.0):
    """#15: returns (dx, dqkv, ctx, dproj, uhat); ``seed`` and the rates
    must be the forward's. The caller's weight gradients: ``dwqkv = dqkv^T
    x``, ``dwo = dproj^T ctx``, ``d_ln_w = sum g uhat``, ..."""
    return _run(fused_bert_attention_block_bwd, bert_attention_bwd_chain, _bert_bwd_math, False,
                x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g, heads, eps, attn_drop,
                hid_drop)


def fused_mlp_block_bwd_fullgrad(x, ln_w, ln_b, w1, b1, w2, b2, seed, g,
                                 act: str = "quick_gelu", eps: float = 1e-5,
                                 post_ln: bool = False, hid_drop: float = 0.0):
    """#18: returns (dx, dw1, db1, dw2, db2, d_ln_w, d_ln_b)."""
    return _run(fused_mlp_block_bwd_fullgrad, mlp_bwd_chain, _mlp_bwd_math, True,
                x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act, eps, post_ln, hid_drop)


def fused_mlp_block_bwd(x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act: str = "quick_gelu",
                        eps: float = 1e-5, post_ln: bool = False, hid_drop: float = 0.0):
    """#17: returns (dx, xn, h, dh_pre, dproj, lnstat, dxn). The caller's
    weight gradients: ``dw1 = dh_pre^T xn``, ``dw2 = dproj^T h``, ``d_ln_w
    = sum dxn lnstat`` (pre-LN) or ``sum g lnstat`` (post-LN), ..."""
    return _run(fused_mlp_block_bwd, mlp_bwd_chain, _mlp_bwd_math, False,
                x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act, eps, post_ln, hid_drop)


def mlp_bwd_wide(x, ln_w, ln_b, w1, b1, w2, g, act: str, eps: float):
    """#19 inside a tower: the pre-LN emitting MLP chain, counted in
    ``fused_mlp_block_bwd_chunked.launches``, returning #17's tuple (dx, xn,
    h, dh_pre, dproj, lnstat, dxn) for the caller's weight gradients."""
    return _run(fused_mlp_block_bwd_chunked, mlp_bwd_chain, _mlp_bwd_math, False,
                x, ln_w, ln_b, w1, b1, w2, None, None, g, act, eps, False, 0.0)


def fused_mlp_block_bwd_chunked(x, ln_w, ln_b, w1, b1, w2, g, act: str, eps: float,
                                chunk: int, tile: int, interpret: bool = False):
    """#19: the pre-LN MLP backward without dropout at the wide widths (JAX
    ``fused_mlp_block_bwd_chunked``, fused_block_bwd.py:1089). ``chunk`` must
    divide the intermediate width and ``tile`` the batch (:1097); neither
    changes the arithmetic on the card. Returns (dx, xn, h, dh_pre, dxn);
    the caller's weight gradients: ``dw1 = dh_pre^T xn``, ``db1 = sum
    dh_pre``, ``dw2 = g^T h``, ``db2 = sum g``, ``d_ln_w = sum dxn xhat``,
    ``d_ln_b = sum dxn``."""
    if w1.shape[0] % chunk or x.shape[0] % tile:
        raise ValueError(f"chunk {chunk} must divide the intermediate width {w1.shape[0]} "
                         f"and tile {tile} the batch {x.shape[0]}")
    dx, xn, h, dh_pre, _, _, dxn = mlp_bwd_wide(x, ln_w, ln_b, w1, b1, w2, g, act, eps)
    return dx, xn, h, dh_pre, dxn


def attention_bwd_long(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads: int, eps: float):
    """#20 inside a tower: the pre-LN emitting attention chain, counted in
    ``fused_attention_block_bwd_chunked.launches``, returning #13's tuple
    (dx, xn, ctx, dqkv) in the chain's own layout."""
    return _run(fused_attention_block_bwd_chunked, attention_bwd_chain, _attn_bwd_math, False,
                x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads, eps)


def fused_attention_block_bwd_chunked(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads: int,
                                      hpc: int, eps: float = 1e-5, interpret: bool = False):
    """#20: the pre-LN attention backward by chunks of ``hpc`` heads (JAX
    ``fused_attention_block_bwd_chunked``, fused_block_bwd.py:1252), for a
    sequence the one-shot backward does not take. Returns (dx, xn, ctx_h,
    dqkv_h): ctx_h ``[B, C, S, hpc*dh]`` and dqkv_h ``[B, C, S,
    3*hpc*dh]`` (q, k, v of the chunk's heads) as JAX lays them out;
    ``ops/fused_block.py::assemble_chunked_attn_weight_grads`` forms the
    weight gradients. ``hpc`` must divide ``heads``; on the card it changes
    no arithmetic."""
    if heads % hpc:
        raise ValueError(f"hpc {hpc} must divide heads {heads}")
    return per_chunk(attention_bwd_long(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads, eps), heads,
                     hpc)


def per_chunk(emitted, heads: int, hpc: int):
    """#13's tuple (dx, xn, ctx, dqkv) as #20 returns it: ctx and dqkv laid
    out by chunks of ``hpc`` heads (``[B, C, S, hpc*dh]``, ``[B, C, S,
    3*hpc*dh]``)."""
    dx, xn, ctx, dqkv = emitted
    b, s, w = ctx.shape
    n_chunks, chunk = heads // hpc, hpc * (w // heads)
    ctx_h = ctx.reshape(b, s, n_chunks, chunk).permute(0, 2, 1, 3)
    dqkv_h = dqkv.reshape(b, s, 3, n_chunks, chunk).permute(0, 3, 1, 2, 4)
    return dx, xn, ctx_h.reshape(b, n_chunks, s, chunk), dqkv_h.reshape(b, n_chunks, s, 3 * chunk)


for _fn in (fused_attention_block_bwd_fullgrad, fused_attention_block_bwd,
            fused_bert_attention_block_bwd_fullgrad, fused_bert_attention_block_bwd,
            fused_mlp_block_bwd_fullgrad, fused_mlp_block_bwd, fused_mlp_block_bwd_chunked,
            fused_attention_block_bwd_chunked):
    _fn.launches = 0
