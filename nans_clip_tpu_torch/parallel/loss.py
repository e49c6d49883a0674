"""Contrastive InfoNCE loss over the global batch (counterpart of
``nans_clip_tpu/parallel/loss.py:29-65``).

The JAX loss is written over the global batch and lets XLA gather the
features across the mesh. The port gathers them itself: under data
parallelism each rank holds its rows' features and :func:`gather_features`
all-gathers them over the data group, in the global batch's row order, into
the ``[global_B, E]`` features that :func:`clip_loss` takes; on one rank the
batch is the global batch and nothing is gathered. The arithmetic is the
JAX package's: fp32 logits, mean cross entropy both ways with optional
label smoothing (as the LoRA trainer's loss, train_lora.py:96-110), the
in-batch i2t/t2i accuracies (reference training/train.py:109-124), and the
distillation loss ``kd_cosine_loss`` (:68).

Gradients through the gather: every rank computes the same global loss from
the same gathered features, so the backward of :class:`_GatherRows` sums
the ranks' gradients of the gathered tensor (an all-reduce) and keeps this
rank's rows. A rank's features thus receive ``data`` times the gradient of
the loss (each of the ``data`` equal losses contributes it once), and the
train step's mean of the parameter gradients over the data group
(``training/trainer.py``) divides it out once: the mean of ``data`` times
each rank's share is the gradient of the one global loss. ``logit_scale``
takes the same gradient on every rank, which the mean keeps.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


class _GatherRows(torch.autograd.Function):
    """Every rank's rows concatenated in rank order; the backward sums the
    ranks' gradients and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def gather_features(x: torch.Tensor, group, accum: int = 1) -> torch.Tensor:
    """The global batch's rows of the per-rank tensor ``x`` ([accum *
    micro, ...]: microbatch after microbatch, this rank's rows of each):
    all-gathered over ``group`` (None: one rank, ``x`` as it is) and put in
    the global order, microbatch after microbatch, ranks in order within
    each (``parallel/distributed.py::rank_rows``). Differentiable."""
    if group is None:
        return x
    data = dist.get_world_size(group)
    g = _GatherRows.apply(x, group)
    return g.view(data, accum, -1, *x.shape[1:]).transpose(0, 1).reshape(-1, *x.shape[1:])


def _ce(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels, fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * -logp.mean(dim=-1)
    return nll.mean()


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor,
              label_smoothing: float = 0.0) -> Tuple[torch.Tensor, dict]:
    """Symmetric InfoNCE over the batch. Features must be L2-normalised.
    Returns (loss, {"i2t_acc", "t2i_acc"})."""
    logits_per_image = logit_scale * image_features.float() @ text_features.float().T
    logits_per_text = logits_per_image.T
    labels = torch.arange(logits_per_image.shape[0], device=logits_per_image.device)
    loss = (_ce(logits_per_image, labels, label_smoothing)
            + _ce(logits_per_text, labels, label_smoothing)) / 2.0
    metrics = {
        "i2t_acc": (logits_per_image.argmax(dim=-1) == labels).float().mean(),
        "t2i_acc": (logits_per_text.argmax(dim=-1) == labels).float().mean(),
    }
    return loss, metrics


def kd_cosine_loss(teacher_features: torch.Tensor,
                   student_features: torch.Tensor) -> torch.Tensor:
    """1 - mean cosine similarity in fp32. Where the dimensions differ the
    STUDENT is resized bilinearly (half-pixel centres, no antialiasing) to
    the teacher's shape and the cosine is taken in the teacher's dimension,
    as the reference's cosineSimilarityLoss (training/train.py:406-419);
    gradients flow through the student's interpolation."""
    t, s = teacher_features.float(), student_features.float()
    if t.shape != s.shape:
        s = F.interpolate(s[None, None], size=tuple(t.shape), mode="bilinear",
                          align_corners=False)[0, 0]
    cos = (t * s).sum(dim=1) / (torch.linalg.vector_norm(t, dim=1)
                                * torch.linalg.vector_norm(s, dim=1) + 1e-8)
    return 1.0 - cos.mean()
