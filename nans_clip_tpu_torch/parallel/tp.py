"""Tensor-parallel transformer sub-blocks over a model process group
(counterpart of ``nans_clip_tpu/parallel/tp.py``).

The JAX package runs each sub-block under ``shard_map`` over the mesh's
``model`` axis: every shard computes its heads (or MLP columns) with the
partial kernels and one ``psum`` sums the shards. The port runs one process
a rank (``parallel/mesh.py``) and does the same with ``torch.distributed``:

* the rank slices its weights from the full ones (``mesh.qkv_slice``,
  ``row_slice``, ``column_slice``), runs #11 or #12
  (``ops/fused_block.py``: the partial kernels with ``impl="fused"``, their
  twins with ``impl="xla"`` or ``"plain"``), and one all-reduce over the
  group sums the ranks' partials;
* then, on the reduced value, in the io dtype as the JAX shard body
  (tp.py:99-103, :129-133): ``x + reduced + bias``, the post-LN (BERT; the
  plain ``layer_norm``, which XLA runs in JAX) and the cast. Every rank
  computes the same value.

Gradients follow Megatron's pair of functions: the partial's input passes
through :class:`_CopyToModel` (identity forward, all-reduce backward: each
rank's input gradient covers only its heads) and its output through
:class:`_ReduceFromModel` (all-reduce forward, identity backward: the
upstream gradient is the same on every rank). ``torch.distributed.nn``'s
all-reduce is not used for the second: its backward all-reduces again,
which would multiply the gradient by tp. After the backward, the gradients
of the parameters that the partials consume (the sliced weights and the
pre-LN LayerNorms inside them) hold only the rank's share:
:func:`reduce_partial_grads` sums them over the group (``CLIP.
tp_partial_parameters`` lists them). The output biases, the post-LN
LayerNorms and everything outside the layers run on replicated values and
keep their gradients.

Dropout (a text tower's training forward, JAX bert.py:100-105: under tp > 1
with dropout JAX takes its unfused GSPMD path, so every sub-block here runs
the twins, ``impl="xla"``, and autograd differentiates them). The masks are
those one process draws (``ops/dropout.py``): the attention probabilities'
counter is (sample, global head, query, key), each rank counting its heads
from ``rank * heads / tp``; the hidden dropout after the out projection and
after fc2 is drawn on the replicated value, after the all-reduce and the
bias and before the residual and the post-LN, with the same counter on
every rank. So tp ranks draw exactly the masks tp 1 draws.

Every rank must run the same sub-blocks in the same order, or the
collectives deadlock; the towers do (their layer loops do not branch on the
rank).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops.fused_block import (_reference_block_partial,
                                                 _reference_mlp_partial,
                                                 fused_attention_block_partial,
                                                 fused_mlp_block_partial)
from nans_clip_tpu_torch.ops.layernorm import layer_norm
from nans_clip_tpu_torch.parallel import mesh

IMPLS = ("fused", "xla", "plain")


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' input gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The forward sums the ranks' partials (in their dtype); identity
    backward."""

    @staticmethod
    def forward(ctx, partial, group):
        out = partial.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _setup(x, tp: int, impl: str, group, heads=None, inter=None):
    """The model group and this rank; raises before any collective for a
    bad ``impl``, a head count that tp does not divide, a group of another
    size, and CUDA shapes that the partial kernels do not admit."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if heads is not None:
        mesh.check_heads(heads, tp)
    if impl == "fused" and x.is_cuda:
        gates.admit(gates.fits_partial(x.shape[-1], tp, heads, inter),
                    f"the partial kernels at tp={tp}: width {x.shape[-1]}, heads {heads}, "
                    f"intermediate {inter}")
    group = mesh.model_group(tp) if group is None else group
    size = dist.get_world_size(group)
    if size != tp:
        raise ValueError(f"tp={tp} but the model group has {size} ranks")
    return group, dist.get_rank(group)


def _dropouts(x, impl: str, seed, attn_drop: float, hid_drop: float):
    """The sub-block's (attention, hidden) dropouts drawn with ``seed``, None
    where a rate is 0; raises for the partial kernels, which take none."""
    a_drop, h_drop = drop.sub_block(seed, attn_drop, hid_drop, x.shape[1])
    if impl == "fused" and (a_drop or h_drop):
        raise ValueError("the partial kernels take no dropout: under dropout the TP sub-blocks "
                         "run impl='xla' (JAX's use_fused is False there)")
    return a_drop, h_drop


def rank_attention_dropout(spec: Optional[drop.Dropout], rank: int, local_heads: int):
    """The attention-probability dropout of ``rank``'s heads: the same draw,
    counted from the rank's first global head."""
    return None if spec is None else dataclasses.replace(spec, head0=rank * local_heads)


def _finish(x, partial, bias, ln_w, ln_b, eps: float, post_ln: bool, group, h_drop=None):
    out = _ReduceFromModel.apply(partial, group)
    if drop.active(h_drop):
        b, s, w = out.shape
        out = out + bias.to(out.dtype)
        out = x + out * drop.hidden_multiplier(h_drop, b * s, w, out.device).view(
            b, s, w).to(out.dtype)
    else:
        out = x + out + bias.to(out.dtype)
    if post_ln:
        out = layer_norm(out, ln_w, ln_b, eps)
    return out.to(x.dtype)


def tp_attention_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, tp: int,
                       eps: float = 1e-5, post_ln: bool = False,
                       key_bias: Optional[torch.Tensor] = None, impl: str = "fused",
                       group=None, seed=None, attn_drop: float = 0.0, hid_drop: float = 0.0):
    """TP attention sub-block (JAX ``tp_attention_block``, tp.py:73).
    pre-LN (ViT): ``x + proj(MHA(LN(x))) + b_o``; post-LN (BERT): ``LN(x +
    drop(proj(MHA_drop(x)) + b_o))`` with the additive fp32 [B, S]
    ``key_bias``. The weights are the full ones, ``[out, in]``; this rank
    computes its ``heads / tp`` heads. ``group``: the model group (default
    ``mesh.model_group(tp)``); the rank is the group's. ``seed`` with
    ``attn_drop`` / ``hid_drop`` above 0: the sub-block's dropout (the
    twins only, ``impl="xla"``)."""
    a_drop, h_drop = _dropouts(x, impl, seed, attn_drop, hid_drop)
    group, rank = _setup(x, tp, impl, group, heads=heads)
    wq, bq = mesh.qkv_slice(w_qkv, b_qkv, heads, rank, tp)
    wo = mesh.column_slice(w_o, rank, tp)
    x_in = _CopyToModel.apply(x, group)
    if impl == "fused":
        partial = fused_attention_block_partial(x_in, ln_w, ln_b, wq, bq, wo, key_bias,
                                                heads // tp, eps, not post_ln)
    else:
        partial = _reference_block_partial(x_in, ln_w, ln_b, wq, bq, wo, heads // tp, eps,
                                           not post_ln, key_bias,
                                           rank_attention_dropout(a_drop, rank, heads // tp))
    return _finish(x, partial, b_o, ln_w, ln_b, eps, post_ln, group, h_drop)


def tp_mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, act: str, tp: int, eps: float = 1e-5,
                 post_ln: bool = False, impl: str = "fused", group=None, seed=None,
                 hid_drop: float = 0.0):
    """TP MLP sub-block (JAX ``tp_mlp_block``, tp.py:115): column-split fc1,
    row-split fc2, one all-reduce; ``x + fc2(act(fc1(LN(x)))) + b2`` or
    ``LN(x + drop(fc2(act(fc1(x))) + b2))``, the hidden dropout drawn with
    ``seed`` (the twins only)."""
    _, h_drop = _dropouts(x, impl, seed, 0.0, hid_drop)
    group, rank = _setup(x, tp, impl, group, inter=w1.shape[0])
    w1l, b1l = mesh.row_slice(w1, rank, tp), mesh.row_slice(b1, rank, tp)
    w2l = mesh.column_slice(w2, rank, tp)
    x_in = _CopyToModel.apply(x, group)
    if impl == "fused":
        partial = fused_mlp_block_partial(x_in, ln_w, ln_b, w1l, b1l, w2l, act, eps,
                                          not post_ln)
    else:
        partial = _reference_mlp_partial(x_in, ln_w, ln_b, w1l, b1l, w2l, act, eps,
                                         not post_ln)
    return _finish(x, partial, b2, ln_w, ln_b, eps, post_ln, group, h_drop)


# Elements a bucket of :func:`reduce_partial_grads`: 2^25 fp32 values, 128 MiB.
GRAD_BUCKET = 1 << 25


def reduce_partial_grads(params: Iterable[torch.Tensor], group) -> None:
    """Sum over ``group`` the gradients of ``params`` (the parameters the
    partials consume), in place, in buckets of at most ``GRAD_BUCKET``
    elements, one all-reduce each. Parameters without a gradient (frozen)
    are skipped; every rank holds the same list, so the ranks' buckets
    match."""
    grads = [p.grad for p in params if p.grad is not None]
    i = 0
    while i < len(grads):
        bucket, n = [], 0
        while i < len(grads) and (not bucket or n + grads[i].numel() <= GRAD_BUCKET):
            bucket.append(grads[i])
            n += grads[i].numel()
            i += 1
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))
