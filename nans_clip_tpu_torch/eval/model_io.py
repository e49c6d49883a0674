"""Eval-side model loading (counterpart of ``nans_clip_tpu/eval/model_io.py``):
a reference ``.pt`` checkpoint, a checkpoint directory of the port's trainer
(``utils/checkpoint.py``), or random init from seed 0."""

from __future__ import annotations

import os
from typing import Optional

from nans_clip_tpu_torch.api import CLIPModel, model_from_config
from nans_clip_tpu_torch.configs import CLIPConfig, load_config
from nans_clip_tpu_torch.models.common import ModelOptions, compute_dtype_for
from nans_clip_tpu_torch.utils.checkpoint import STATE_FILE, is_checkpoint_dir

# Files at the top of an Orbax checkpoint directory (the JAX trainer's saves)
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def _weights_file(resume: str) -> str:
    """The file that holds ``resume``'s weights: the path itself for a
    ``.pt``, :data:`STATE_FILE` inside a checkpoint directory of the port's
    trainer (its ``state_dict`` is in the reference layout). Any other
    directory raises and says what it is."""
    if not os.path.exists(resume):
        raise FileNotFoundError(f"checkpoint {resume} does not exist")
    if not os.path.isdir(resume):
        return resume
    if is_checkpoint_dir(resume):
        return os.path.join(resume, STATE_FILE)
    if any(os.path.exists(os.path.join(resume, m)) for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{resume} is an Orbax checkpoint directory of the JAX trainer, which this package "
            "does not read: export a reference .pt from the JAX trainer "
            "(--save-torch-format writes <tag>.pt beside each checkpoint) and pass that")
    raise ValueError(f"{resume} is a directory but not a checkpoint of this package's trainer "
                     f"(no {STATE_FILE} in it)")


def load_eval_model(vision_model: str, text_model: str, resume: Optional[str],
                    precision: str = "bf16", attn_impl: str = "auto",
                    cfg: Optional[CLIPConfig] = None, device="cuda") -> CLIPModel:
    """A :class:`CLIPModel` from a ``Vision@Text`` pair (or ``cfg``, the
    CLIs' ``--tiny-model`` config) and ``resume``: a reference ``.pt``, a
    checkpoint directory of the port's trainer (``<logs>/<name>/checkpoints/
    <tag>``), or empty for the random init. ``precision``: one of
    ``models.common.PRECISIONS``; every value but ``fp32`` runs in bf16, as
    the JAX ``load_eval_model`` maps them (``nans_clip_tpu/eval/model_io.py:44``;
    ``amp`` and ``fp16`` are bf16 there too, ``training/params.py:79-80``).
    ``attn_impl``: any of ``gates.IMPLS``, the JAX values
    ``auto|xla|pallas|fused`` included."""
    cfg = cfg or load_config(f"{vision_model}@{text_model}")
    path = _weights_file(resume) if resume else None
    options = ModelOptions(attn_impl=attn_impl, compute_dtype=compute_dtype_for(precision))
    return model_from_config(cfg, path, options, seed=0, device=device)
