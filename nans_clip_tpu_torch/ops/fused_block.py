"""Transformer sub-blocks as chains of the hand-written Hopper kernels.

Ports of ``nans_clip_tpu/ops/fused_block.py``:

* ``_kernel`` (fused_block.py:103) -> :func:`fused_attention_block` (pre-LN,
  ViT) and :func:`fused_bert_attention_block` (post-LN, key-masked, with
  attention-probability and hidden dropout, BERT);
* ``_mlp_kernel`` (fused_block.py:797) -> :func:`fused_mlp_block` (with
  hidden dropout);
* ``_wide_kernel`` (:491) and ``_wide_batched_kernel`` (:568), #7 and #8 ->
  :func:`fused_attention_block_wide` (``batch_tile`` 1 and above);
* ``_mlp_tiled_kernel`` (:899) and ``_mlp_batched_kernel`` (:1005), #9 and
  #10 -> :func:`_fused_mlp_tiled_call` and :func:`_fused_mlp_batched_call`,
  reached through :func:`_mlp_dispatch` as in the JAX package (:1104);
* ``_partial_kernel`` (:1244) and ``_mlp_partial_kernel`` (:1346), #11 and
  #12, the sub-blocks of one tensor-parallel rank (``parallel/tp.py``) ->
  :func:`fused_attention_block_partial` and :func:`fused_mlp_block_partial`.

The wide forms are the same chains at W in (768, 2048] with heads of 64 or
80: on the TPU they streamed weights in chunks of heads or of the MLP's
intermediate width because VMEM could not hold them; on the card the GEMM's
K loop plays the role of the chunk and the kernels hold one head at a time
anyway, so ``heads_per_chunk``, ``chunk`` and ``batch_tile`` change no
arithmetic. The wrappers check them as the JAX package asserts them.

On the TPU each sub-block was one kernel, because 64-110 MB of VMEM held a
whole weight set. A Hopper SM has 227 KB of shared memory, so each becomes a
short chain that computes the same function with the same rounding points:

* attention, pre-LN:  LN -> GEMM(Wqkv, +bqkv) -> attention -> GEMM(Wo, +bo, +x)
* attention, post-LN: GEMM(Wqkv, +bqkv) -> attention[drop P] ->
  GEMM(Wo, +bo, drop, +x; fp32) -> LN
* MLP: [LN] -> GEMM(w1, +b1, act) -> GEMM(w2, +b2, [drop], +x) [-> fp32 sum -> LN]
* partial attention (#11): [LN] -> GEMM(Wqkv_local, +bqkv_local) -> attention
  (the local heads, [key bias]) -> GEMM(Wo_local), no bias, residual or LN
* partial MLP (#12): [LN] -> GEMM(w1_local, +b1_local, act) -> GEMM(w2_local),
  no bias, residual or LN

(``csrc/layernorm.cu``, ``csrc/gemm.cu``, ``csrc/attention.cu``). Weights are
in the torch Linear layout ``[out, in]``. Dropout (``ops/dropout.py``) is on
when a ``seed`` and a rate above 0 are given; the backward redraws its masks
from the same seed.

``_reference_block``, ``_reference_mlp``, ``_reference_block_partial`` and
``_reference_mlp_partial`` are the plain-torch twins: the same chains
through the kernels' plain versions. The public wrappers run
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
``ModelOptions.bwd_impl`` through ``ops/gates.py::bwd_route``. Wide blocks
(JAX ``_wide_bwd``, fused_block.py:687, and the MLP vjp, :1150): a pre-LN
attention block above ``gates.ATTN_BWD_MAX_SEQ`` always takes #20, the
head-chunked backward (``ops/fused_block_bwd.py``), then only the needed
weight gradients; a pre-LN MLP block that ran #9/#10 takes #19 where the
route is ``emit`` or a weight is frozen.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops.activations import mm32, upcast
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


def attention_partial_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, heads: int, eps: float,
                            key_bias: Optional[torch.Tensor], pre_ln: bool, ops,
                            dropout: Optional[drop.Dropout] = None):
    """One tensor-parallel rank's attention sub-block through ``ops``: [LN
    ->] QKV of the rank's heads -> attention -> ctx . Wo_local, with no
    residual, output bias or post-LN (the caller sums the ranks' outputs and
    adds those once). x: [B, S, W] in the io dtype; ``w_qkv``: [3 Wl, W],
    the q|k|v thirds of the local heads; ``w_o``: [W, Wl]; returns [B, S, W]
    in the io dtype. The rounding points of ``_partial_kernel``
    (fused_block.py:1244-1276): xn, q/k/v (fp32 product plus bias), P and
    ctx in the io dtype, the out-projection summed in fp32 and stored in the
    io dtype. ``dropout``: the attention-probability dropout of the rank's
    heads (its ``head0`` their first global index), or None."""
    ln, lin, attn = ops
    b, s, w = x.shape
    x2 = x.reshape(b * s, w)
    xn = ln(x2, ln_w, ln_b, eps) if pre_ln else x2
    ctx = attn(lin(xn, w_qkv, b_qkv), key_bias, b, heads, dropout)
    return lin(ctx, w_o, None).reshape(b, s, w)


def mlp_partial_chain(x, ln_w, ln_b, w1, b1, w2, act: str, eps: float, pre_ln: bool, ops):
    """One rank's MLP sub-block through ``ops``: [LN ->] act(x . W1_local +
    b1_local) . W2_local, with no residual, bias or post-LN; ``w1``: [Il,
    W], ``w2``: [W, Il] (``_mlp_partial_kernel``, fused_block.py:1346-1361:
    h in the io dtype, the down-projection summed in fp32)."""
    ln, lin, _ = ops
    b, s, w = x.shape
    x2 = x.reshape(b * s, w)
    xn = ln(x2, ln_w, ln_b, eps) if pre_ln else x2
    return lin(lin(xn, w1, b1, act=act), w2, None).reshape(b, s, w)


def _reference_block_partial(x, ln_w, ln_b, w_qkv, b_qkv, w_o, heads: int, eps: float,
                             pre_ln: bool, key_bias=None, dropout=None):
    """Plain-torch twin of #11 (JAX ``_reference_block_partial``,
    fused_block.py:1228), the weights in the ``[out, in]`` layout; with the
    attention-probability ``dropout`` of a training forward under tensor
    parallelism, which only the twin takes."""
    return attention_partial_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, heads, eps, key_bias,
                                   pre_ln, PLAIN_OPS, dropout)


def _reference_mlp_partial(x, ln_w, ln_b, w1, b1, w2, act: str, eps: float, pre_ln: bool):
    """Plain-torch twin of #12 (JAX ``_reference_mlp_partial``,
    fused_block.py:1337)."""
    return mlp_partial_chain(x, ln_w, ln_b, w1, b1, w2, act, eps, pre_ln, PLAIN_OPS)


class _Partial(torch.autograd.Function):
    """A partial sub-block under autograd. ``run(kernel, *tensors)`` computes
    it: the kernel chain where ``kernel`` is True and the tensors lie on the
    card, the twin otherwise. The forward runs the kernels; the backward is
    autograd through the twin, recomputed from the saved inputs: the JAX
    backward is the vjp of the twin too (fused_block.py:1325-1334,
    :1403-1410), and no backward kernel exists to port."""

    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        ctx.save_for_backward(*tensors)
        return run(True, *tensors)

    @staticmethod
    def backward(ctx, g):
        tensors, needs = ctx.saved_tensors, ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(tensors, needs)]
            out = ctx.run(False, *leaves)
            wanted = [t for t, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return (None, *(next(grads) if n else None for n in needs))


def _attention_partial(kernel: bool, x, ln_w, ln_b, w_qkv, b_qkv, w_o, key_bias, *,
                       heads: int, eps: float, pre_ln: bool):
    if not (kernel and x.is_cuda):
        return _reference_block_partial(x, ln_w, ln_b, w_qkv, b_qkv, w_o, heads, eps, pre_ln,
                                        key_bias)
    out = attention_partial_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, heads, eps, key_bias,
                                  pre_ln, KERNEL_OPS)
    fused_attention_block_partial.launches += 1
    return out


def _mlp_partial(kernel: bool, x, ln_w, ln_b, w1, b1, w2, *, act: str, eps: float,
                 pre_ln: bool):
    if not (kernel and x.is_cuda):
        return _reference_mlp_partial(x, ln_w, ln_b, w1, b1, w2, act, eps, pre_ln)
    out = mlp_partial_chain(x, ln_w, ln_b, w1, b1, w2, act, eps, pre_ln, KERNEL_OPS)
    fused_mlp_block_partial.launches += 1
    return out


def fused_attention_block_partial(x, ln_w, ln_b, w_qkv, b_qkv, w_o, key_bias, heads: int,
                                  eps: float, pre_ln: bool):
    """#11, one tensor-parallel rank's attention sub-block (JAX
    ``fused_attention_block_partial``, fused_block.py:1309): [LN ->] QKV of
    the ``heads`` local heads -> MHA [+ key bias] -> ctx . Wo_local, with no
    residual, output bias or post-LN. x: [B, S, W]; ``w_qkv``: [3 Wl, W];
    ``b_qkv``: [3 Wl]; ``w_o``: [W, Wl]; ``key_bias``: [B, S] fp32 or None.
    Under autograd; the kernels for CUDA tensors, the twin for CPU tensors."""
    run = functools.partial(_attention_partial, heads=heads, eps=eps, pre_ln=pre_ln)
    return _Partial.apply(run, x, ln_w, ln_b, w_qkv, b_qkv, w_o, key_bias)


def fused_mlp_block_partial(x, ln_w, ln_b, w1, b1, w2, act: str, eps: float, pre_ln: bool):
    """#12, one rank's MLP sub-block (JAX ``fused_mlp_block_partial``,
    fused_block.py:1388): [LN ->] act(x . W1_local + b1_local) . W2_local;
    ``w1``: [Il, W], ``w2``: [W, Il]. Under autograd, as #11."""
    run = functools.partial(_mlp_partial, act=act, eps=eps, pre_ln=pre_ln)
    return _Partial.apply(run, x, ln_w, ln_b, w1, b1, w2)


def _wide_forward(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, eps: float,
                  batch_tile: int):
    """#7 (``batch_tile`` 1) or #8: the pre-LN attention chain, counted in
    ``fused_attention_block_wide.launches`` or ``.launches_batched``."""
    if not x.is_cuda:
        return _reference_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps)
    out = attention_chain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads, eps, None, False,
                          KERNEL_OPS)
    if batch_tile > 1:
        fused_attention_block_wide.launches_batched += 1
    else:
        fused_attention_block_wide.launches += 1
    return out


def fused_attention_block_wide(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int,
                               eps: float = 1e-5, heads_per_chunk: int = 4,
                               interpret: bool = False, batch_tile: int = 1):
    """#7 / #8, ViT pre-LN: x + out_proj(MHA(LN(x))) for W in (1024, 2048]
    (JAX ``fused_attention_block_wide``, fused_block.py:659), under autograd
    with the backward of JAX ``_wide_bwd`` (:687): the one-shot chain up to
    ``gates.ATTN_BWD_MAX_SEQ``, #20 above it. ``heads_per_chunk`` must divide
    ``heads`` and ``batch_tile`` the batch (the JAX asserts, :533 and :615);
    neither changes the arithmetic on the card, and ``interpret`` (Pallas'
    interpret mode) has no counterpart. CPU tensors take the twins."""
    if heads % heads_per_chunk or x.shape[0] % batch_tile:
        raise ValueError(f"heads_per_chunk {heads_per_chunk} must divide heads {heads} and "
                         f"batch_tile {batch_tile} the batch {x.shape[0]}")
    return attention_block_train(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, None, heads, eps, False,
                                 use_kernel=x.is_cuda, route=gates.BWD_ROUTE["attn_pre"],
                                 wide_tile=batch_tile)


def _mlp_chunked(wrapper, x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, chunk: int,
                 tile: int):
    """The MLP chain of #9 / #10, counted in ``wrapper.launches``; the twin
    for CPU tensors."""
    if w1.shape[0] % chunk or x.shape[0] % tile:
        raise ValueError(f"chunk {chunk} must divide the intermediate width {w1.shape[0]} "
                         f"and tile {tile} the batch {x.shape[0]}")
    if not x.is_cuda:
        return _reference_mlp(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln)
    out = mlp_chain(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, KERNEL_OPS)
    wrapper.launches += 1
    return out


def _fused_mlp_tiled_call(x, ln_w, ln_b, w1, b1, w2, b2, act: str, eps: float, post_ln: bool,
                          interpret: bool, chunk: int):
    """#9: the MLP sub-block with the intermediate width in chunks of
    ``chunk`` (JAX ``_fused_mlp_tiled_call``, fused_block.py:931), which
    must divide it (:935). On the card the GEMM's K loop runs over the
    chunks; the result is the one-shot chain's."""
    return _mlp_chunked(_fused_mlp_tiled_call, x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln,
                        chunk, 1)


def _fused_mlp_batched_call(x, ln_w, ln_b, w1, b1, w2, b2, act: str, eps: float,
                            post_ln: bool, interpret: bool, chunk: int, tile: int):
    """#10: #9 with ``tile`` samples a cell (JAX ``_fused_mlp_batched_call``,
    fused_block.py:1041; ``chunk`` divides the intermediate width and
    ``tile`` the batch, :1045). The card's GEMM tiles run over all B*S rows
    at once, so the tile changes no arithmetic."""
    return _mlp_chunked(_fused_mlp_batched_call, x, ln_w, ln_b, w1, b1, w2, b2, act, eps,
                        post_ln, chunk, tile)


def mlp_plan(batch: int, seq: int, width: int, inter: int, esize: int):
    """(chunk, tile) where the JAX dispatch takes #9 (tile 1) or #10, else
    None (#2): ``_mlp_dispatch``'s question (fused_block.py:1109-1119)."""
    if (gates.fits_fused_mlp_oneshot(seq, width) or gates.mlp_oneshot_direct_ok(seq, width)
            or not gates.fits_fused_mlp_tiled(seq, width)):
        return None
    chunk = gates.mlp_chunk_size(width, inter, esize)
    if chunk is None:
        return None
    return chunk, gates.mlp_batch_tile(batch, seq, width, inter, chunk, esize)


def _mlp_dispatch(x, ln_w, ln_b, w1, b1, w2, b2, seed, act: str, eps: float, post_ln: bool,
                  interpret: bool, hid_drop: float):
    """The MLP sub-block's kernel by width (JAX ``_mlp_dispatch``,
    fused_block.py:1104): #2 at one-shot shapes, else #10 where the batch
    tile exceeds 1 and #9 where it is 1. The chunked kernels take no
    dropout (:1113). Where the JAX package has no kernel (S > 640 or W >
    2048) the card runs #2's chain."""
    plan = mlp_plan(x.shape[0], x.shape[1], x.shape[2], w1.shape[0], x.element_size())
    if plan is None:
        return fused_mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, seed, hid_drop)
    if hid_drop > 0.0:
        raise ValueError("the chunked MLP kernels (#9, #10) take no dropout")
    chunk, tile = plan
    if tile > 1:
        return _fused_mlp_batched_call(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln,
                                       interpret, chunk, tile)
    return _fused_mlp_tiled_call(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, interpret,
                                 chunk)


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


def assemble_chunked_attn_weight_grads(x, xn, ctx_h, dqkv_h, g, heads: int, hpc: int,
                                       ln_w, ln_b, w_qkv, eps: float):
    """The weight and LayerNorm gradients from #20's outputs in the per-chunk
    layout (JAX ``assemble_chunked_attn_weight_grads``, fused_block_bwd.py
    :1301, which forms them in XLA): returns (d_ln_w, d_ln_b, dwqkv, dbqkv,
    dwo, dbo), fp32, the weights in the port's ``[out, in]`` layout. Plain
    torch: the chunks are laid back as ``[B*S, 3W]`` and ``[B*S, W]`` and
    the products are those of :func:`attention_weight_grads`."""
    b, n_chunks, s, _ = ctx_h.shape
    w = x.shape[-1]
    chunk = hpc * (w // heads)
    ctx = ctx_h.permute(0, 2, 1, 3).reshape(b * s, w)
    dqkv = dqkv_h.reshape(b, n_chunks, s, 3, chunk).permute(0, 2, 3, 1, 4).reshape(b * s, 3 * w)
    return attention_weight_grads((True,) * 6, False, x, ln_w, w_qkv, g, (None, xn, ctx, dqkv),
                                  eps)


class _AttentionBlock(torch.autograd.Function):
    """The attention sub-block under autograd: forward #1 (#7 / #8 where
    ``wide_tile`` is 1 / above 1); backward #14 (pre-LN) or #16 (post-LN), or
    #13 / #15 with the caller's weight gradients, and #20 for a pre-LN block
    longer than ``gates.ATTN_BWD_MAX_SEQ``; the twins where ``use_kernel``
    is False."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, heads, eps, post_ln,
                seed, attn_drop, hid_drop, use_kernel, route, wide_tile):
        weights = (ln_w, ln_b, w_qkv, b_qkv, w_o, b_o)
        if not use_kernel:
            out = _reference_block(x, *weights, heads, eps, key_bias, post_ln, seed, attn_drop,
                                   hid_drop)
        elif post_ln:
            out = fused_bert_attention_block(x, *weights, key_bias, heads, eps, seed, attn_drop,
                                             hid_drop)
        elif wide_tile:
            out = _wide_forward(x, *weights, heads, eps, wide_tile)
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
            if x.shape[1] > gates.ATTN_BWD_MAX_SEQ:
                full = False   # #20, then the needed weight gradients
                bwd = fbb.attention_bwd_long
            else:
                bwd = (fbb.fused_attention_block_bwd_fullgrad if full
                       else fbb.fused_attention_block_bwd)
            out = bwd(*args) if use_kernel else fbb._attn_bwd_math(*args, full=full)
        if full:
            dx, dwqkv, dbqkv, dwo, dbo, d_ln_w, d_ln_b = out
            grads = (d_ln_w, d_ln_b, dwqkv, dbqkv, dwo, dbo)
        else:
            dx = out[0]
            grads = attention_weight_grads(needs, post_ln, x, ln_w, w_qkv, g, out, eps)
        return (dx, *grads) + (None,) * 10


class _MlpBlock(torch.autograd.Function):
    """The MLP sub-block under autograd: forward #2, or #9 / #10 at the
    widths where ``_mlp_dispatch`` takes them; backward #18, or #17 with the
    caller's weight gradients (#19 for a pre-LN block that ran #9 / #10);
    the twins where ``use_kernel`` is False."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, seed, hid_drop,
                use_kernel, route):
        if use_kernel:
            out = _mlp_dispatch(x, ln_w, ln_b, w1, b1, w2, b2, seed, act, eps, post_ln, False,
                                hid_drop)
        else:
            out = _reference_mlp(x, ln_w, ln_b, w1, b1, w2, b2, act, eps, post_ln, seed,
                                 hid_drop)
        wide = not post_ln and mlp_plan(x.shape[0], x.shape[1], x.shape[2], w1.shape[0],
                                        x.element_size()) is not None
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.config = (act, eps, post_ln, seed, hid_drop, use_kernel, route, wide)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w1, b1, w2, b2 = ctx.saved_tensors
        act, eps, post_ln, seed, hid_drop, use_kernel, route, wide = ctx.config
        g = g.contiguous()
        needs = ctx.needs_input_grad[1:7]
        full = all(needs) and route == "fullgrad"
        args = (x, ln_w, ln_b, w1, b1, w2, b2, seed, g, act, eps, post_ln, hid_drop)
        if use_kernel and wide and not full:
            out = fbb.mlp_bwd_wide(x, ln_w, ln_b, w1, b1, w2, g, act, eps)
        elif use_kernel:
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
                          route: str = "fullgrad", wide_tile: int = 0):
    """The attention sub-block with its backward: pre-LN (ViT, no mask or
    dropout) or post-LN (BERT). ``use_kernel``: the kernels (CUDA tensors)
    or the twins. ``route``: "fullgrad" or "emit", the backward of a block
    whose weights all need gradients (``gates.bwd_route``). ``wide_tile``:
    0 runs #1 forward, 1 #7, above 1 #8 (pre-LN only)."""
    return _AttentionBlock.apply(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, key_bias, heads, eps,
                                 post_ln, seed, attn_drop, hid_drop, use_kernel, route, wide_tile)


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
fused_attention_block_wide.launches = 0
fused_attention_block_wide.launches_batched = 0
_fused_mlp_tiled_call.launches = 0
_fused_mlp_batched_call.launches = 0
fused_attention_block_partial.launches = 0
fused_mlp_block_partial.launches = 0
