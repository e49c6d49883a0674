"""The ``data x tp x pipe`` grid of ranks, the rank's weight slices, the
FSDP and pipeline storage specs, and a launcher that runs one function in
each rank (counterpart of ``nans_clip_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh: the batch
is sharded over ``data`` and ``shard_map`` gives each model shard its heads
and MLP columns. The port runs one process a rank and joins them in
``torch.distributed`` process groups:

* :func:`init_model_group` forms the default group. The backend is the
  caller's explicit choice and nothing chooses it for them: ``gloo`` on the
  CPU and where the ranks share one card (gloo reduces CUDA tensors
  through the host; NCCL refuses two ranks on one device), ``nccl`` where
  each rank has its own card. ``parallel/distributed.py`` forms it from a
  launcher's environment.
* :func:`grid` lays the ``world`` ranks out as JAX lays out its devices,
  ``create_mesh``'s ``reshape(data, model, pipe)``, pipe innermost: rank
  ``(d * tp + m) * pp + s`` has data index ``d``, model index ``m`` and
  stage ``s``, ``data = world / (tp * pp)``; ``tp`` and ``pp`` are
  exclusive, as in JAX. Its model group (:func:`model_group`) holds the
  ``tp`` ranks of one data index, the group of ``ModelOptions.tp``; its pipe
  group (:func:`pipe_group`) the ``pp`` stages of one data index, the group
  of ``ModelOptions.pp`` (``parallel/pp.py``); its data group
  (:func:`data_group`) the ``data`` ranks of one model index and stage, over
  which the batch is split, features are gathered and gradients reduced.
  Every rank forms every subgroup, in one order, on its first call
  (``torch.distributed.new_group`` is collective). A ``tp`` or ``pp`` that
  does not divide the world, or an ``options.data`` other than the grid's,
  raises (the counterpart of ``_check_tp``,
  ``nans_clip_tpu/parallel/tp.py:43-54``): a rank that sliced for another tp
  would sum the wrong heads, a stage for another pp run the wrong layers.
* :func:`qkv_slice`, :func:`row_slice` and :func:`column_slice` cut a rank's
  share from the full weights in the torch Linear layout ``[out, in]``:
  its heads of the q|k|v thirds (``_local_qkv``, tp.py:57-70, keeps the
  thirds layout the kernels read), the rows of ``w1``/``b1`` and the
  columns of ``w_o``/``w2``. Column slices are strided and are made
  contiguous. Every rank holds the full weights: the slices are taken on
  each forward (inside autograd in training, so that each rank's gradient
  lands in its slice of the full parameter).
* :func:`param_spec` is JAX's (mesh.py:80-124) on a leaf's path names and
  shape: the tensor-parallel rules name the ``model`` dimension of ``wo``,
  ``w1``, ``w2`` and ``b1``, and under FSDP the largest dimension that no
  rule names and that ``data`` divides is sharded over ``data``, for every
  leaf of at least ``_FSDP_MIN_SIZE`` elements. ``parallel/fsdp.py`` maps
  the port's parameters to the JAX leaves and applies it.
* :func:`run_ranks` spawns ``world_size`` processes, forms their group
  through a file rendezvous (no fixed port: two runs at once cannot
  collide), runs ``fn(rank, *args)`` in each and returns their results,
  failing, never hanging, when a rank fails or times out.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import queue
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def init_model_group(backend: str, init_method: str, rank: int, world_size: int,
                     timeout_s: float = 60.0) -> None:
    """Form the default process group that :func:`grid` lays out.
    ``backend``: "gloo" or "nccl", as the module docstring says; no default.
    ``init_method``: a rendezvous URL (``file://<path>`` or
    ``tcp://localhost:<port>``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dist.init_process_group(backend=backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the ``data x tp x pipe`` grid and its groups; a
    group is None where its axis is 1 (no collective runs over it).
    ``pipe_ranks``: the global ranks of the pipe group, stage by stage."""

    data: int
    tp: int
    data_index: int
    model_index: int
    model_group: object
    data_group: object
    pp: int = 1
    stage: int = 0
    pipe_group: object = None
    pipe_ranks: Tuple[int, ...] = (0,)


# One grid a (tp, pp, default group): forming a subgroup is collective, so
# each is formed once and found again on every later call.
_GRIDS: dict = {}


def _axis_group(world, size: int, n: int, members, mine: int):
    """This rank's group of the axis of ``n`` ranks: every group of the
    axis formed in one order (``members(i)`` the ranks of group ``i`` of
    ``size / n``), the world itself when the axis spans it, None at 1."""
    if n == 1:
        return None
    if n == size:
        return world
    out = None
    for i in range(size // n):
        g = dist.new_group(members(i))
        if i == mine:
            out = g
    return out


def grid(tp: int, pp: int = 1) -> Grid:
    """The grid of the default group's ranks at ``tp`` ranks a model group
    and ``pp`` stages a pipe group (module docstring). Raises when no group
    is formed, when ``tp`` and ``pp`` are both above 1, or when ``tp * pp``
    does not divide its size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"tp={tp}, pp={pp} needs a process group of {tp * pp} ranks or a "
                           "multiple: call parallel.mesh.init_model_group (or parallel."
                           "distributed.init_distributed) first")
    if tp > 1 and pp > 1:
        raise ValueError("tp > 1 and pp > 1 are mutually exclusive")
    world = dist.group.WORLD
    key = (tp, pp, id(world))
    if key in _GRIDS and _GRIDS[key][0] is world:
        return _GRIDS[key][1]
    size, rank = dist.get_world_size(), dist.get_rank()
    if size % (tp * pp):
        axis = f"tp={tp}" if tp > 1 else f"pp={pp}"
        raise ValueError(f"{axis} but the model group has {size} ranks: a world of {size} "
                         f"ranks is no grid of data x {tp} x {pp}")
    data = size // (tp * pp)
    dm, s = divmod(rank, pp)
    d, m = divmod(dm, tp)
    at = lambda d_, m_, s_: (d_ * tp + m_) * pp + s_
    # the three axes' groups, always in this order on every rank
    model = _axis_group(world, size, tp, lambda i: [at(i // pp, j, i % pp) for j in range(tp)],
                        d * pp + s)
    pipe = _axis_group(world, size, pp, lambda i: [at(i // tp, i % tp, j) for j in range(pp)],
                       d * tp + m)
    data_ = _axis_group(world, size, data,
                        lambda i: [at(j, i // pp, i % pp) for j in range(data)], m * pp + s)
    out = Grid(data, tp, d, m, model, data_, pp=pp, stage=s, pipe_group=pipe,
               pipe_ranks=tuple(at(d, m, j) for j in range(pp)))
    _GRIDS[key] = (world, out)
    return out


def check_grid(tp: int, data: int, pp: int = 1) -> Optional[Grid]:
    """The grid for ``ModelOptions(tp=tp, data=data, pp=pp)``: None for one
    rank (no group needed); raises where the process group is not that
    grid."""
    if tp == 1 and data == 1 and pp == 1:
        return None
    g = grid(tp, pp)
    if g.data != data:
        raise ValueError(f"data={data} but the grid of {g.data * tp * pp} ranks at tp={tp} "
                         f"has a data axis of {g.data}" if pp == 1 else
                         f"data={data} but the grid of {g.data * tp * pp} ranks at tp={tp}, "
                         f"pp={pp} has a data axis of {g.data}")
    return g


def model_group(tp: int):
    """The process group of ``ModelOptions.tp`` = ``tp`` ranks: this
    rank's model group of the grid. Raises when no group is formed or when
    ``tp`` does not divide its size."""
    return grid(tp).model_group


def data_group(tp: int = 1, pp: int = 1):
    """This rank's data group of the grid at ``tp`` and ``pp`` (None when
    the data axis is 1)."""
    return grid(tp, pp).data_group


def pipe_group(pp: int):
    """This rank's pipe group of the grid at ``pp`` stages (None at 1)."""
    return grid(1, pp).pipe_group


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


# Tensor-parallel rules of the JAX package (mesh.py:61-71), keyed on the last
# name of a stacked transformer leaf ([L, in, out] and [L, out]): the entries
# of the dimensions that the model axis splits.
_TP_RULES_3D = {"wo": (None, MODEL_AXIS, None), "w1": (None, None, MODEL_AXIS),
                "w2": (None, MODEL_AXIS, None)}
_TP_RULES_2D = {"b1": (None, MODEL_AXIS)}
# Leaves smaller than this stay replicated under FSDP (JAX mesh.py:77).
_FSDP_MIN_SIZE = 65536


def param_spec(names: Tuple[str, ...], shape: Tuple[int, ...], fsdp: int = 1,
               fsdp_min_size: Optional[int] = None, pp: int = 1) -> tuple:
    """The JAX ``PartitionSpec`` entries (``nans_clip_tpu/parallel/mesh.py:
    80-124``) of a leaf with the JAX path ``names`` and (full) ``shape``:
    ``"model"`` where a tensor-parallel rule splits; under ``pp`` > 1
    ``"pipe"`` on the leading layer dimension of a stacked ``transformer`` /
    ``encoder`` leaf that ``pp`` divides; under ``fsdp`` > 1 ``"data"`` on
    the largest dimension that neither names and that ``fsdp`` divides, for
    a leaf of at least ``fsdp_min_size`` (default ``_FSDP_MIN_SIZE``)
    elements; trailing None entries dropped."""
    name = names[-1]
    spec: tuple = ()
    if len(shape) == 3 and name in _TP_RULES_3D:
        spec = _TP_RULES_3D[name]
    elif len(shape) == 2 and name in _TP_RULES_2D:
        spec = _TP_RULES_2D[name]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if (pp > 1 and len(shape) >= 2 and entries[0] is None
            and ("transformer" in names or "encoder" in names) and shape[0] % pp == 0):
        entries[0] = PIPE_AXIS
    min_size = _FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size
    size = 1
    for n in shape:
        size *= n
    if fsdp > 1 and size >= min_size:
        free = [d for d in range(len(shape)) if entries[d] is None and shape[d] % fsdp == 0]
        if free:
            entries[max(free, key=lambda i: shape[i])] = DATA_AXIS
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


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
