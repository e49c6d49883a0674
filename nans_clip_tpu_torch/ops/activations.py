"""Activation functions shared by the towers (counterpart of
``nans_clip_tpu/ops/activations.py``): QuickGELU (reference
clip/model.py:180-182) and BERT's exact erf-GELU (modeling_bert.py:39-44),
with their derivatives for the backward twins."""

from __future__ import annotations

import torch


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the OpenAI-CLIP GELU approximation."""
    return x * torch.sigmoid(1.702 * x)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU, 0.5 x (1 + erf(x / sqrt(2)))."""
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


ACT2FN = {"quick_gelu": quick_gelu, "gelu": gelu_erf}


def quick_gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d quick_gelu / dh: sig (1 + 1.702 h (1 - sig)), sig = sigmoid(1.702 h)
    (nans_clip_tpu/ops/fused_block_bwd.py:699-701)."""
    sig = torch.sigmoid(1.702 * h)
    return sig * (1.0 + 1.702 * h * (1.0 - sig))


def gelu_erf_grad(h: torch.Tensor) -> torch.Tensor:
    """d gelu / dh: cdf + h * pdf (nans_clip_tpu/ops/fused_block_bwd.py:703-706)."""
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    return cdf + h * (torch.exp(-0.5 * h * h) * 0.3989422804014327)


ACT_GRAD = {"quick_gelu": quick_gelu_grad, "gelu": gelu_erf_grad}


def upcast(t: torch.Tensor) -> torch.Tensor:
    """The accumulation type of the plain twins: fp32, or fp64 for fp64
    inputs (so that a gradient check in fp64 runs the same code)."""
    return t if t.dtype == torch.float64 else t.float()


def plain_dtype(dtype, like: torch.Tensor):
    """The dtype a twin stores for a requested ``dtype``: fp32 (the
    kernels' fp32 intermediates) widens to fp64 for fp64 inputs."""
    return torch.float64 if dtype == torch.float32 and like.dtype == torch.float64 else dtype


def mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` in fp32 from operands in the io dtype: the
    ``preferred_element_type=float32`` contractions the JAX package leaves
    to XLA. One library product with bf16 operands and an fp32 result on
    the card; in fp32 after an exact upcast elsewhere."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return upcast(a) @ upcast(b)
