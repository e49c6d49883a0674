"""Shared model utilities: options and parameter casting (counterpart of
``nans_clip_tpu/models/common.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from nans_clip_tpu_torch.ops import gates


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Knobs threaded through the towers.

    ``attn_impl``: "auto" runs the hand kernels for CUDA tensors and the
    plain-torch twins for CPU tensors; "plain" always runs the twins;
    "kernel" always runs the kernels (CUDA only). See ``ops/gates.py``.
    ``compute_dtype``: None keeps the parameter dtype; "bfloat16" casts the
    parameters (all but ``logit_scale``) and the inputs. The kernels take
    bf16, so a model on the card needs "bfloat16" unless ``attn_impl`` is
    "plain".
    """

    attn_impl: str = "auto"
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        if self.attn_impl not in gates.IMPLS:
            raise ValueError(f"attn_impl must be one of {gates.IMPLS}, got {self.attn_impl!r}")
        if self.compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"unsupported compute_dtype {self.compute_dtype!r}")

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return None if self.compute_dtype is None else getattr(torch, self.compute_dtype)


def cast_module(module: nn.Module, options: ModelOptions) -> nn.Module:
    """Cast every floating parameter except ``logit_scale`` to the compute
    dtype, in place, as ``nans_clip_tpu.models.common.cast_tree`` casts the
    towers (the logit scale stays fp32, as the JAX package reads it)."""
    dtype = options.dtype
    if dtype is None:
        return module
    for name, p in module.named_parameters():
        if p.is_floating_point() and name != "logit_scale":
            p.data = p.data.to(dtype)
    return module
