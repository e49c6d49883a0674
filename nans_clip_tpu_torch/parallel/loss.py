"""Contrastive InfoNCE loss on one device (counterpart of
``nans_clip_tpu/parallel/loss.py:29-65``).

The JAX loss is written over the global batch and lets XLA gather the
features across the mesh. The port runs on one card, so the batch is the
global batch and nothing is gathered; the arithmetic is the JAX package's:
fp32 logits, mean cross entropy both ways with optional label smoothing (as
the LoRA trainer's loss, train_lora.py:96-110), and the in-batch i2t/t2i
accuracies (reference training/train.py:109-124), and the distillation
loss ``kd_cosine_loss`` (:68).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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
