"""Launching across processes and each rank's rows of the global batch
(counterpart of ``nans_clip_tpu/parallel/distributed.py``).

The JAX package runs one process a host and ``jax.distributed.initialize``
finds the others; the port runs one process a rank, as the reference's
``torch.distributed.launch`` does (run_scripts/*.sh):

* :func:`rendezvous` reads the launcher's environment: the JAX names
  ``COORDINATOR_ADDRESS`` (``host:port``) / ``NUM_PROCESSES`` /
  ``PROCESS_ID`` (``distributed.py:22-47``), or torchrun's ``MASTER_ADDR``
  / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``, and ``LOCAL_RANK`` (the
  rank on its host; the JAX names take ``LOCAL_RANK`` where it is set and
  the rank otherwise, one host).
* :func:`backend_for` is the backend rule, decided before anything runs and
  logged by the CLI: ``gloo`` on the CPU and where the ranks of a host
  outnumber its cards (they share a card: gloo reduces CUDA tensors
  through the host, NCCL refuses two ranks on one device), ``nccl`` where
  each rank has its own card. Nothing falls back to another backend after a
  failure.
* :func:`init_distributed` forms the default group (``parallel/mesh.py::
  init_model_group``) and returns the rank's :class:`Rank`: its device is
  ``cuda:LOCAL_RANK`` (modulo the host's cards where they are shared) or the
  CPU.
* The global batch: the JAX CLI assembles each process's rows as one
  contiguous block of the global batch (``global_batch_from_host_batch``),
  and the train step splits microbatch ``j`` = global rows ``[j * micro,
  (j + 1) * micro)`` over ``data`` (trainer.py:250-265). :func:`rank_rows`,
  the port's counterpart, gives a data rank exactly the rows that JAX's
  device at that data index holds: block ``d`` of every microbatch,
  microbatch after microbatch (:func:`rank_row_index` their indices). The
  port's loader (``data/dataset.py``, ``layout="blocks"``) hands rank ``d``
  block ``d`` of each global loader batch, and a step's loader batches are
  its microbatches, so a rank's host batch already is :func:`rank_rows` of
  the global batch that one process would load: nothing is exchanged
  between ranks, and a step's global batch is the same at every world
  size.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Mapping

import torch

from nans_clip_tpu_torch.parallel import mesh

logger = logging.getLogger(__name__)

JAX_NAMES = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")
TORCHRUN_NAMES = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class Rank:
    """One process of a launch: its rank, the world size, its rank on the
    host, the backend of the default group and its device."""

    rank: int
    world: int
    local_rank: int
    backend: str
    device: torch.device


def launched(env: Mapping[str, str] = os.environ) -> bool:
    """Whether a launcher set a rendezvous of more than this process (or
    any rendezvous by the JAX names, as the JAX CLI reads them)."""
    if env.get("COORDINATOR_ADDRESS") or env.get("NUM_PROCESSES"):
        return True
    return int(env.get("WORLD_SIZE", "1") or 1) > 1


def rendezvous(env: Mapping[str, str] = os.environ):
    """``(init_method, rank, world, local_rank)`` from the launcher's
    environment (module docstring). Raises when neither set of names is
    complete."""
    if env.get("COORDINATOR_ADDRESS") or env.get("NUM_PROCESSES"):
        missing = [k for k in JAX_NAMES if not env.get(k)]
        if missing:
            raise ValueError(f"the JAX rendezvous needs {', '.join(JAX_NAMES)}: {missing} unset")
        rank = int(env["PROCESS_ID"])
        return (f"tcp://{env['COORDINATOR_ADDRESS']}", rank, int(env["NUM_PROCESSES"]),
                int(env.get("LOCAL_RANK", rank)))
    missing = [k for k in TORCHRUN_NAMES if not env.get(k)]
    if missing:
        raise ValueError("--distributed needs a launcher's rendezvous: torchrun's "
                         f"{', '.join(TORCHRUN_NAMES)} (and LOCAL_RANK) or the JAX names "
                         f"{', '.join(JAX_NAMES)}; unset: {missing}")
    return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["RANK"]),
            int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", "0")))


def backend_for(platform: str, local_world: int, cards: int) -> str:
    """The backend rule (module docstring): ``local_world`` ranks on this
    host, ``cards`` CUDA devices on it."""
    if platform == "cpu":
        return "gloo"
    if cards < 1:
        raise RuntimeError("no CUDA device: pass --platform cpu to train on the CPU")
    return "nccl" if local_world <= cards else "gloo"


def init_distributed(platform: str = "cuda", timeout_s: float = 600.0,
                     env: Mapping[str, str] = os.environ) -> Rank:
    """Form the default group from the launcher's environment and return
    this process's :class:`Rank`. ``LOCAL_WORLD_SIZE`` (torchrun sets it)
    counts the host's ranks; without it every rank is taken to be on this
    host."""
    init_method, rank, world, local_rank = rendezvous(env)
    cards = torch.cuda.device_count() if platform == "cuda" else 0
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    backend = backend_for(platform, local_world, cards)
    device = torch.device("cpu") if platform == "cpu" else torch.device("cuda",
                                                                         local_rank % cards)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh.init_model_group(backend, init_method, rank, world, timeout_s)
    logger.info("process group: rank %d/%d, local rank %d, backend %s, device %s", rank, world,
                local_rank, backend, device)
    return Rank(rank, world, local_rank, backend, device)


def rank_row_index(data_index: int, data: int, accum: int, micro_local: int) -> torch.Tensor:
    """The global-batch rows of data rank ``data_index`` (module docstring):
    for each of ``accum`` microbatches of ``data * micro_local`` rows, the
    block of ``micro_local`` rows at ``data_index``; int64 [accum *
    micro_local]."""
    micro = data * micro_local
    return torch.cat([torch.arange(micro_local) + j * micro + data_index * micro_local
                      for j in range(accum)])


def rank_rows(global_batch, data_index: int, data: int, accum: int = 1):
    """Data rank ``data_index``'s rows of a global batch (a tensor or an
    array with the batch first) in the train step's order."""
    b = global_batch.shape[0]
    if b % (data * accum):
        raise ValueError(f"global batch {b} not divisible by data {data} x accum {accum}")
    idx = rank_row_index(data_index, data, accum, b // (data * accum))
    return global_batch[idx] if torch.is_tensor(global_batch) else global_batch[idx.numpy()]

