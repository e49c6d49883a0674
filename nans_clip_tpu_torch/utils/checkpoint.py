"""Training checkpoints (counterpart of ``nans_clip_tpu/utils/checkpoint.py``)
and the reference ``.pt`` export.

The JAX trainer's semantics (reference training/main.py:201-237,315-346):

* ``save_checkpoint(ckpt_dir, tag, state, meta)`` writes ``ckpt_dir/<tag>/``
  and ``ckpt_dir/<tag>.meta.json`` and points ``ckpt_dir/LATEST`` at the
  tag, which the tag ``epoch_latest`` then follows (:func:`resolve_tag`);
* ``restore_checkpoint`` raises on a missing tag unless ``missing_ok``;
  ``reset_optimizer`` restores the parameters and the step and keeps the
  caller's fresh optimizer, whatever optimizer the checkpoint holds;
* ``torch_format`` also writes ``ckpt_dir/<tag>.pt`` in the reference
  layout, ``{"state_dict": ..., "epoch", "step", "name"}``.

The port's state format (the JAX package saves through Orbax, which needs
JAX): ``<tag>/`` holds one file, :data:`STATE_FILE`, a ``torch.save`` of

    {"format": "nans_clip_tpu_torch.train_state", "version": 1,
     "state_dict": the module's fp32 state dict on the CPU (reference key
                   names, so ``load_torch_state_dict`` reads it as a .pt),
     "optimizer": the optimizer's ``state_dict()``,
     "optimizer_type": the optimizer's class name,
     "step": the optimizer step (int)}

written to a temporary name and renamed, so a reader never sees half a
file.

Across ranks (``parallel/distributed.py``) every rank calls
:func:`save_checkpoint`: a sharded state's parameters and moments are
gathered first (``parallel/fsdp.py::full_state``, into the one-rank
layout), a pipeline stage's then joined with the other stages' layers and
moments (``parallel/pp.py::full_state``, over the pipe group of global
rank 0), global rank 0 alone writes the same files as one process writes,
and every rank waits at a barrier until they are there. Every rank restores
from the files (the checkpoint directory is one they all read) into its
full state, before ``shard_train_state`` cuts it, so a checkpoint written
at one world size resumes at any other.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

STATE_FILE = "state.pt"
FORMAT = "nans_clip_tpu_torch.train_state"


def _cpu_state_dict(module: nn.Module) -> dict:
    """The stored tensors of the module's state dict (none on the meta
    device), fp32 on the CPU."""
    return {k: v.detach().to("cpu", torch.float32) for k, v in module.state_dict().items()
            if not v.is_meta}


def _save_atomic(obj, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_torch_checkpoint(path: str, module: nn.Module, meta: Optional[dict] = None,
                          state_dict: Optional[dict] = None) -> None:
    """Write ``module``'s parameters (or ``state_dict``, the CPU state dict
    of a gathered module) as a reference-layout ``.pt`` (fp32 on the CPU),
    ``{"state_dict": ..., **meta}``, atomically: a temporary file in the
    same directory, then a rename."""
    _save_atomic({"state_dict": _cpu_state_dict(module) if state_dict is None else state_dict,
                  **(meta or {})}, path)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def one_process_state(state) -> Tuple[Optional[dict], Optional[dict]]:
    """(module state dict, optimizer state dict) of ``state`` in one
    process's layout, on the CPU: a sharded state's gathered over its data
    group, a pipeline stage's joined with the other stages' over its pipe
    group. Collective across ranks; only the ranks of global rank 0's pipe
    group get them where the state is a stage's, the others (None, None)."""
    pipe = getattr(state, "pipe", None)
    if getattr(state, "fsdp", None) is None and pipe is None:
        return _cpu_state_dict(state.module), state.optimizer.state_dict()
    from nans_clip_tpu_torch.parallel import pp
    from nans_clip_tpu_torch.parallel.fsdp import full_state
    from nans_clip_tpu_torch.training.trainer import decay_groups, stored_groups
    names = decay_groups(state.module)
    if state.fsdp is not None:
        module_sd, opt_sd = full_state(state.fsdp, state.optimizer, names)
    else:
        module_sd = _cpu_state_dict(state.module)
        opt_sd = pp.one_process_indices(_cpu_optimizer_state(state.optimizer),
                                        stored_groups(state.module), names)
    if pipe is None:
        return module_sd, opt_sd
    if pipe.data_index:
        return None, None
    return pp.full_state(module_sd, opt_sd, pipe)


def _cpu_optimizer_state(optimizer) -> dict:
    sd = optimizer.state_dict()
    return {"state": {k: {key: v.cpu() if torch.is_tensor(v) else v for key, v in st.items()}
                      for k, st in sd["state"].items()},
            "param_groups": sd["param_groups"]}


def save_checkpoint(ckpt_dir: str, tag: str, state, meta: dict,
                    torch_format: bool = False, update_latest: bool = True) -> None:
    """Save a ``TrainState`` (``training/trainer.py``) and ``meta`` under
    ``ckpt_dir/tag``; point LATEST at it unless ``update_latest`` is
    False. Across ranks every rank calls it (module docstring)."""
    module_sd, opt_sd = one_process_state(state)
    if not _distributed() or dist.get_rank() == 0:
        path = os.path.join(ckpt_dir, tag)
        os.makedirs(path, exist_ok=True)
        _save_atomic({"format": FORMAT, "version": 1, "state_dict": module_sd,
                      "optimizer": opt_sd, "optimizer_type": type(state.optimizer).__name__,
                      "step": int(state.step)}, os.path.join(path, STATE_FILE))
        with open(os.path.join(ckpt_dir, f"{tag}.meta.json"), "w") as f:
            json.dump(meta, f)
        if update_latest:
            with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
                f.write(tag)
        if torch_format:
            save_torch_checkpoint(os.path.join(ckpt_dir, f"{tag}.pt"), state.module,
                                  {"epoch": meta.get("epoch", 0), "step": meta.get("step", 0),
                                   "name": meta.get("name", "")}, module_sd)
    if _distributed():
        dist.barrier()


def resolve_tag(ckpt_dir: str, tag: str) -> str:
    """Follow the LATEST pointer when asked for ``epoch_latest``."""
    latest_file = os.path.join(ckpt_dir, "LATEST")
    if tag == "epoch_latest" and os.path.exists(latest_file):
        with open(latest_file) as f:
            return f.read().strip()
    return tag


def is_checkpoint_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, STATE_FILE))


def read_state(path: str, map_location="cpu") -> dict:
    """The saved dict of a checkpoint directory (:data:`STATE_FILE`)."""
    obj = torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                     weights_only=True)
    if not isinstance(obj, dict) or obj.get("format") != FORMAT:
        raise ValueError(f"{path}/{STATE_FILE} is not a train state of this package")
    return obj


def restore_checkpoint(ckpt_dir: str, tag: str, state, reset_optimizer: bool = False,
                       missing_ok: bool = False) -> Tuple[object, Optional[dict]]:
    """Restore into ``state`` (its module's parameters are overwritten in
    place, on their device). Returns (state, meta or None). A missing
    checkpoint raises unless ``missing_ok``: a mistyped --resume tag must
    not train from random init and then overwrite epoch_latest. A sharded
    state, or a pipeline stage's, raises: restore the full state, then
    shard it (``shard_train_state`` takes the stage's slice, at any
    ``pp``)."""
    if getattr(state, "fsdp", None) is not None or getattr(state, "pipe", None) is not None:
        raise ValueError("restore_checkpoint takes the full state: restore, then "
                         "shard_train_state")
    tag = resolve_tag(ckpt_dir, tag)
    path = os.path.join(ckpt_dir, tag)
    if not is_checkpoint_dir(path):
        if missing_ok:
            return state, None
        raise FileNotFoundError(f"checkpoint '{tag}' not found in {ckpt_dir}")
    saved = read_state(path)
    state.module.load_state_dict(saved["state_dict"])
    if not reset_optimizer:
        kind = type(state.optimizer).__name__
        if saved["optimizer_type"] != kind:
            raise ValueError(f"checkpoint '{tag}' holds a {saved['optimizer_type']} state and "
                             f"this run builds a {kind}: pass --reset-optimizer")
        state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    meta = None
    meta_path = os.path.join(ckpt_dir, f"{tag}.meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def latest_exists(ckpt_dir: str, tag: str = "epoch_latest") -> bool:
    return is_checkpoint_dir(os.path.join(ckpt_dir, resolve_tag(ckpt_dir, tag)))
