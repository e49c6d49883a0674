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
fused_block.py:282, :1147). The backward reads ``ctx.needs_input_grad``:

* every weight of the block needs its gradient and the route is
  ``fullgrad``: #14, #16 or #18 (``ops/fused_block_bwd.py``), the weight
  gradients formed inside the chain by ``wgrad_kernel``;
* otherwise (a frozen weight, as under LoRA, or the route ``emit``): #13,
  #15 or #17 for dx and the recomputed activations, then only the products
  and sums that a needed gradient asks for (:func:`attention_weight_grads`,
  :func:`mlp_weight_grads`; the JAX package forms them outside its kernels
  too, fused_block.py:285-307, :404-413, :1195-1204). A gradient that is
  not needed is ``None`` and never computed.

The route of a block whose weights all need gradients comes from
``ModelOptions.bwd_impl`` through ``ops/gates.py::bwd_route``.
"""

from __future__ import annotations

from typing import Optional

import torch

from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
from nans_clip_tpu_torch.ops.activations import upcast
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


def mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` in fp32 from operands in the io dtype: the
    ``preferred_element_type=float32`` contractions the JAX package leaves
    to XLA. One library product with bf16 operands and an fp32 result on
    the card; in fp32 after an exact upcast elsewhere."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return upcast(a) @ upcast(b)


def _sum32(t: torch.Tensor) -> torch.Tensor:
    """Column sum over the rows in fp32 (``sum(t.astype(float32), (0, 1))``)."""
    acc = torch.float64 if t.dtype == torch.float64 else torch.float32
    return _flat(t).sum(dim=0, dtype=acc)


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def attention_weight_grads(needs, post_ln: bool, x, ln_w, w_qkv, g, emitted, eps: float):
    """The weight gradients of an attention sub-block from what #13 or #15
    emitted, each formed only where ``needs`` (ln_w, ln_b, w_qkv, b_qkv,
    w_o, b_o) asks: fp32, ``[out, in]``. Returns them in that order, None
    where not needed (fused_block.py:285-307 pre-LN, :404-413 post-LN)."""
    n_lw, n_lb, n_wqkv, n_bqkv, n_wo, n_bo = needs
    if post_ln:
        _, dqkv, ctx, dproj, uhat = emitted
        a_in, d_out = x, dproj
    else:
        _, xn, ctx, dqkv = emitted
        a_in, d_out = xn, g
    dwqkv = mm32(_flat(dqkv).T, _flat(a_in)) if n_wqkv else None
    dbqkv = _sum32(dqkv) if n_bqkv else None
    dwo = mm32(_flat(d_out).T, _flat(ctx)) if n_wo else None
    dbo = _sum32(d_out) if n_bo else None
    d_lw = d_lb = None
    if post_ln:
        if n_lw:
            d_lw = (upcast(_flat(g)) * upcast(_flat(uhat))).sum(dim=0)
        if n_lb:
            d_lb = _sum32(g)
    elif n_lw or n_lb:
        # dxn recomputed for the LayerNorm parameters alone (:299-306)
        dxn = mm32(_flat(dqkv), w_qkv)
        if n_lw:
            xf = upcast(_flat(x))
            mean = xf.mean(dim=-1, keepdim=True)
            var = (xf - mean).square().mean(dim=-1, keepdim=True)
            d_lw = (dxn * ((xf - mean) * torch.rsqrt(var + eps))).sum(dim=0)
        if n_lb:
            d_lb = dxn.sum(dim=0)
    return d_lw, d_lb, dwqkv, dbqkv, dwo, dbo


def mlp_weight_grads(needs, post_ln: bool, g, emitted):
    """The weight gradients of an MLP sub-block from what #17 emitted, each
    formed only where ``needs`` (ln_w, ln_b, w1, b1, w2, b2) asks
    (fused_block.py:1195-1204)."""
    n_lw, n_lb, n_w1, n_b1, n_w2, n_b2 = needs
    _, xn, h, dh_pre, dproj, lnstat, dxn = emitted
    dw1 = mm32(_flat(dh_pre).T, _flat(xn)) if n_w1 else None
    db1 = _sum32(dh_pre) if n_b1 else None
    dw2 = mm32(_flat(dproj).T, _flat(h)) if n_w2 else None
    db2 = _sum32(dproj) if n_b2 else None
    gsrc = g if post_ln else dxn
    d_lw = (upcast(_flat(gsrc)) * upcast(_flat(lnstat))).sum(dim=0) if n_lw else None
    d_lb = _sum32(gsrc) if n_lb else None
    return d_lw, d_lb, dw1, db1, dw2, db2


class _AttentionBlock(torch.autograd.Function):
    """The attention sub-block under autograd: forward #1; backward #14
    (pre-LN) or #16 (post-LN), or #13 / #15 with the caller's weight
    gradients; the twins where ``use_kernel`` is False."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, heads, eps, post_ln,
                seed, attn_drop, hid_drop, use_kernel, route):
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
        ctx.config = (heads, eps, post_ln, seed, attn_drop, hid_drop, use_kernel, route)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias = ctx.saved_tensors
        heads, eps, post_ln, seed, attn_drop, hid_drop, use_kernel, route = ctx.config
        g = g.contiguous()
        needs = ctx.needs_input_grad[1:7]
        full = all(needs) and route == "fullgrad"
        if post_ln:
            args = (x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, seed, g, heads, eps,
                    attn_drop, hid_drop)
            if use_kernel:
                bwd = (fbb.fused_bert_attention_block_bwd_fullgrad if full
                       else fbb.fused_bert_attention_block_bwd)
                out = bwd(*args)
            else:
                out = fbb._bert_bwd_math(*args, full=full)
        else:
            args = (x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, heads, eps)
            if use_kernel:
                bwd = (fbb.fused_attention_block_bwd_fullgrad if full
                       else fbb.fused_attention_block_bwd)
                out = bwd(*args)
            else:
                out = fbb._attn_bwd_math(*args, full=full)
        if full:
            dx, dwqkv, dbqkv, dwo, dbo, d_ln_w, d_ln_b = out
            grads = (d_ln_w, d_ln_b, dwqkv, dbqkv, dwo, dbo)
        else:
            dx = out[0]
            grads = attention_weight_grads(needs, post_ln, x, ln_w, w_qkv, g, out, eps)
        return (dx, *grads) + (None,) * 9


class _MlpBlock(torch.autograd.Function):
    """The MLP sub-block under autograd: forward #2; backward #18, or #17
    with the caller's weight gradients; the twins where ``use_kernel`` is
    False."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, seed, hid_drop,
                use_kernel, route):
        fwd = fused_mlp_block if use_kernel else _reference_mlp
        out = fwd(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, seed, hid_drop)
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.config = (act, eps, post_ln, seed, hid_drop, use_kernel, route)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w1, b1, w2, b2 = ctx.saved_tensors
        act, eps, post_ln, seed, hid_drop, use_kernel, route = ctx.config
        g = g.contiguous()
        needs = ctx.needs_input_grad[1:7]
        full = all(needs) and route == "fullgrad"
        args = (x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act, eps, post_ln, hid_drop)
        if use_kernel:
            out = (fbb.fused_mlp_block_bwd_fullgrad if full else fbb.fused_mlp_block_bwd)(*args)
        else:
            out = fbb._mlp_bwd_math(*args, full=full)
        if full:
            dx, dw1, db1, dw2, db2, d_ln_w, d_ln_b = out
            grads = (d_ln_w, d_ln_b, dw1, db1, dw2, db2)
        else:
            dx = out[0]
            grads = mlp_weight_grads(needs, post_ln, g, out)
        return (dx, *grads) + (None,) * 7


def attention_block_train(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, heads: int,
                          eps: float, post_ln: bool, seed=None, attn_drop: float = 0.0,
                          hid_drop: float = 0.0, use_kernel: bool = True,
                          route: str = "fullgrad"):
    """The attention sub-block with its backward: pre-LN (ViT, no mask or
    dropout) or post-LN (BERT). ``use_kernel``: the kernels (CUDA tensors)
    or the twins. ``route``: "fullgrad" or "emit", the backward of a block
    whose weights all need gradients (``gates.bwd_route``)."""
    return _AttentionBlock.apply(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, heads, eps,
                                 post_ln, seed, attn_drop, hid_drop, use_kernel, route)


def mlp_block_train(x, ln_w, ln_b, w1, b1, w2, b2, act: str, eps: float, post_ln: bool,
                    seed=None, hid_drop: float = 0.0, use_kernel: bool = True,
                    route: str = "fullgrad"):
    """The MLP sub-block with its backward (``route`` as
    :func:`attention_block_train`)."""
    return _MlpBlock.apply(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, seed, hid_drop,
                           use_kernel, route)


fused_attention_block.launches = 0
fused_bert_attention_block.launches = 0
fused_mlp_block.launches = 0
