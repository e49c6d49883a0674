"""Checkpoints in the reference ``.pt`` layout (the ``.pt`` side of
``nans_clip_tpu/utils/checkpoint.py``, which also writes orbax state).

:func:`save_torch_checkpoint` writes a trained module as ``{"state_dict":
...}`` in fp32 with the reference key names, the file that the port's
``load_from_name`` (and the reference) read back. The training state
(optimizer moments, step) is not saved yet: that comes with the training
CLI (ROADMAP queue 1).
"""

from __future__ import annotations

import os

import torch
from torch import nn


def save_torch_checkpoint(path: str, module: nn.Module) -> None:
    """Write ``module``'s parameters as a reference-layout ``.pt`` (fp32 on
    the CPU), atomically: a temporary file in the same directory, then a
    rename."""
    state = {k: v.detach().to("cpu", torch.float32) for k, v in module.state_dict().items()}
    tmp = f"{path}.tmp"
    torch.save({"state_dict": state}, tmp)
    os.replace(tmp, path)
