"""Eval-side model loading (counterpart of ``nans_clip_tpu/eval/model_io.py``):
a reference ``.pt`` checkpoint, or random init from seed 0."""

from __future__ import annotations

import os
from typing import Optional

from nans_clip_tpu_torch.api import CLIPModel, model_from_config
from nans_clip_tpu_torch.configs import CLIPConfig, load_config
from nans_clip_tpu_torch.models.common import ModelOptions, compute_dtype_for


def load_eval_model(vision_model: str, text_model: str, resume: Optional[str],
                    precision: str = "bf16", attn_impl: str = "auto",
                    cfg: Optional[CLIPConfig] = None, device="cuda") -> CLIPModel:
    """A :class:`CLIPModel` from a ``Vision@Text`` pair (or ``cfg``, the
    CLIs' ``--tiny-model`` config) and ``resume``: a reference ``.pt``, or
    empty for the random init. ``precision``: one of ``models.common.PRECISIONS``;
    every value but ``fp32`` runs in bf16, as the JAX ``load_eval_model``
    maps them (``nans_clip_tpu/eval/model_io.py:44``; ``amp`` and ``fp16``
    are bf16 there too, ``training/params.py:79-80``). ``attn_impl``: any
    of ``gates.IMPLS``, the JAX values ``auto|xla|pallas|fused`` included."""
    cfg = cfg or load_config(f"{vision_model}@{text_model}")
    if resume:
        if not os.path.exists(resume):
            raise FileNotFoundError(f"checkpoint {resume} does not exist")
        if os.path.isdir(resume):
            raise NotImplementedError(
                f"{resume} is an Orbax checkpoint directory of the JAX trainer; the port reads "
                "those once the training port (ROADMAP queue 1 item 9) lands. Export a "
                "reference .pt with the JAX package meanwhile")
    options = ModelOptions(attn_impl=attn_impl, compute_dtype=compute_dtype_for(precision))
    return model_from_config(cfg, resume or None, options, seed=0, device=device)
