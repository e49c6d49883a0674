"""Activation functions shared by the towers (counterpart of
``nans_clip_tpu/ops/activations.py``): QuickGELU (reference
clip/model.py:180-182) and BERT's exact erf-GELU (modeling_bert.py:39-44)."""

from __future__ import annotations

import torch


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the OpenAI-CLIP GELU approximation."""
    return x * torch.sigmoid(1.702 * x)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU, 0.5 x (1 + erf(x / sqrt(2)))."""
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


ACT2FN = {"quick_gelu": quick_gelu, "gelu": gelu_erf}
