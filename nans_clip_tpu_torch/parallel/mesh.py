"""The model process group of tensor parallelism, the rank's weight slices,
and a launcher that runs one function in each rank (counterpart of
``nans_clip_tpu/parallel/mesh.py``'s ``model`` axis).

The JAX package lays its devices out as a ``(data, model)`` mesh and lets
``shard_map`` give each model shard its heads and MLP columns. The port runs
one process a rank and joins them in a ``torch.distributed`` process group:

* :func:`init_model_group` forms the default group. The backend is the
  caller's explicit choice and nothing chooses it for them: ``gloo`` on the
  CPU and where the ranks share one card (gloo all-reduces CUDA tensors
  through the host; NCCL refuses two ranks on one device), ``nccl`` where
  each rank has its own card (not yet run: the machine the port is measured
  on has one card).
* :func:`model_group` is the model group of ``ModelOptions.tp``: for now the
  whole default group, world size = tp and data = 1 (data parallelism across
  groups is not ported). It fails fast when ``tp`` differs from the group's
  size, the counterpart of ``_check_tp`` (``nans_clip_tpu/parallel/tp.py:
  43-54``): a rank that sliced for another tp would sum the wrong heads.
* :func:`qkv_slice`, :func:`row_slice` and :func:`column_slice` cut a rank's
  share from the full weights in the torch Linear layout ``[out, in]``:
  its heads of the q|k|v thirds (``_local_qkv``, tp.py:57-70, keeps the
  thirds layout the kernels read), the rows of ``w1``/``b1`` and the
  columns of ``w_o``/``w2``. Column slices are strided and are made
  contiguous. Every rank holds the full weights: the slices are taken on
  each forward (inside autograd in training, so that each rank's gradient
  lands in its slice of the full parameter).
* :func:`run_ranks` spawns ``tp`` processes, forms their group through a
  file rendezvous (no fixed port: two runs at once cannot collide), runs
  ``fn(rank, *args)`` in each and returns their results, failing, never
  hanging, when a rank fails or times out.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def init_model_group(backend: str, init_method: str, rank: int, world_size: int,
                     timeout_s: float = 60.0) -> None:
    """Form the default process group that :func:`model_group` reads.
    ``backend``: "gloo" or "nccl", as the module docstring says; no default.
    ``init_method``: a rendezvous URL (``file://<path>`` or
    ``tcp://localhost:<port>``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dist.init_process_group(backend=backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def model_group(tp: int):
    """The process group of ``ModelOptions.tp`` = ``tp`` ranks. Raises when
    no group is formed or when its size is not ``tp``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"ModelOptions(tp={tp}) needs a process group of {tp} ranks: call "
                           "parallel.mesh.init_model_group first")
    size = dist.get_world_size()
    if size != tp:
        raise ValueError(f"tp={tp} but the model group has {size} ranks")
    return dist.group.WORLD


def check_heads(heads: int, tp: int) -> None:
    """A head count that ``tp`` does not divide raises (tp.py:79)."""
    if heads % tp:
        raise ValueError(f"heads {heads} not divisible by tp {tp}")


def qkv_slice(w_qkv: torch.Tensor, b_qkv: torch.Tensor, heads: int, rank: int, tp: int):
    """Rank ``rank``'s heads of the packed ``[3W, W]`` q|k|v weight and its
    ``[3W]`` bias: ``[3 Wl, W]`` and ``[3 Wl]``, still q|k|v thirds."""
    check_heads(heads, tp)
    w = w_qkv.shape[1]
    dh, hl = w // heads, heads // tp
    heads_of = slice(rank * hl, (rank + 1) * hl)
    wq = w_qkv.view(3, heads, dh, w)[:, heads_of].reshape(3 * hl * dh, w)
    bq = b_qkv.view(3, heads, dh)[:, heads_of].reshape(3 * hl * dh)
    return wq, bq


def row_slice(t: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s share of the first axis (``w1`` [I, W] and ``b1``)."""
    n = t.shape[0] // tp
    return t[rank * n:(rank + 1) * n]


def column_slice(w: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s share of the columns (``w_o`` [W, W], ``w2`` [W, I]),
    contiguous."""
    n = w.shape[1] // tp
    return w[:, rank * n:(rank + 1) * n].contiguous()


def _rank_main(fn, rank, world_size, backend, init_method, timeout_s, args, results):
    try:
        init_model_group(backend, init_method, rank, world_size, timeout_s)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, backend: str, init_file: str,
              args: Sequence = (), timeout_s: float = 600.0) -> List:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes joined by
    :func:`init_model_group` (``backend``; the rendezvous file
    ``init_file``, which must not exist yet); return their results in rank
    order. ``fn`` must be importable by the spawned processes (a module-level
    function) and its result picklable. Raises with the rank's traceback
    when a rank fails, and when the ranks have not all returned within
    ``timeout_s``; every process is stopped before this returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, f"file://{init_file}",
                               min(timeout_s, 60.0), tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {world_size} ranks did not all return within "
                                       f"{timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        results.close()
    return [got[r] for r in range(world_size)]
