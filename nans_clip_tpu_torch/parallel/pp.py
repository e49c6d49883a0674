"""Pipeline parallelism over the grid's pipe axis, the GPipe schedule
(counterpart of ``nans_clip_tpu/parallel/pp.py``).

The JAX package stores each tower's stacked ``[L, ...]`` layers sharded over
its mesh's ``pipe`` axis and runs the synchronous pipeline as one
``shard_map``: a scan over ``M + pp - 1`` clock steps, the activation one
``ppermute`` hop along the ring a step, the last stage's banked outputs
broadcast back by a masked ``psum``. The port runs one process a stage, the
``pp`` ranks of a pipe group (``parallel/mesh.py::grid``), and does the same
with ``torch.distributed``:

* :func:`pp_transformer` splits the local batch into ``M`` microbatches.
  Stage 0 takes microbatch ``t``, every stage runs its own ``L / pp``
  layers on it and sends the activation one hop on; the last stage's
  outputs reach every rank of the pipe group (one broadcast), so the head
  and the loss run replicated, as JAX's masked ``psum`` gives them. Only the
  rows the head reads travel (``head_rows``). A microbatch's slice of
  ``aux`` (the text tower's key bias) travels with it. Each stage holds its
  microbatches' graphs, as GPipe does.
* The backward is the reverse hop: one ``autograd.Function`` around the
  stage's loop, whose backward runs the microbatches last to first, each
  taking its output gradient from the next stage (the last stage from the
  loss), backpropagating through the stage's layers and sending the input
  gradient one hop back. Every rank computes the same loss, so every rank's
  Function receives the same output gradient; only the last stage's enters
  the pipeline, once. Stage 0's input gradient is broadcast to the pipe
  group, so that every stage backpropagates it through its own copy of the
  embeddings: the replicated parameters (embeddings, ``ln_post``, the
  projections, a ResNet tower) take the one-rank gradient on every stage,
  bit for bit, and the layers take theirs on the stage that stores them.
* The hops: point-to-point ``send`` / ``recv`` over the pipe group. Where
  the backend is gloo (the CPU, ranks that share a card) and the tensor is
  on the card, the hop is staged through host memory explicitly, chosen by
  the backend's name and never by a failure; nothing switches backend. A
  rank that fails or waits past the group's timeout raises, and
  ``mesh.run_ranks`` fails with it.
* :func:`localize` keeps a stage's layers: the other stages' layers of
  each transformer tower go to the meta device (no storage), so a stage
  stores, and its optimizer updates, only its ``L / pp`` layers and the
  replicated rest. :func:`full_state` gathers the stages' parameters and
  optimizer moments back into one process's layout (checkpoints), and
  :func:`stage_optimizer_state` cuts such a state to a stage.

The bubble is GPipe's ``(pp - 1) / (M + pp - 1)`` (:func:`bubble_fraction`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

# The layer stacks of the towers, by module path: a ViT image tower's and
# the text tower's (a ResNet image tower has none and runs whole).
STACKS = ("visual.transformer.resblocks", "bert.encoder.layer")


def pick_microbatches(batch: int, pp: int) -> int:
    """Largest M <= 4 * pp that divides ``batch`` (1 where none does), but
    never below 2 samples a microbatch (JAX ``pick_microbatches``)."""
    cap = min(4 * pp, max(1, batch // 2), batch)
    for m in range(cap, 0, -1):
        if batch % m == 0:
            return m
    return 1


def bubble_fraction(batch: int, pp: int, microbatches: int = 0) -> float:
    """The GPipe idle fraction ``(pp - 1) / (M + pp - 1)`` at the M that
    will run."""
    m = microbatches or pick_microbatches(batch, pp)
    return (pp - 1) / (m + pp - 1)


def pp_kernel_batch(global_batch: int, pp: int, microbatches: int = 0, data: int = 1) -> int:
    """The batch the per-layer kernels see inside the pipeline: the global
    batch over ``data`` ranks and ``M`` microbatches (JAX
    ``pp_kernel_batch``, which reads ``data`` from its ambient mesh)."""
    local = max(1, global_batch // max(1, data))
    m = microbatches or pick_microbatches(local, pp)
    return max(1, local // m)


def stage_layers(n_layers: int, pp: int, stage: int) -> range:
    """The global indices of stage ``stage``'s layers of a stack of
    ``n_layers``; a ``pp`` that does not divide it raises."""
    if n_layers % pp:
        raise ValueError(f"layers {n_layers} not divisible by pp {pp}")
    n = n_layers // pp
    return range(stage * n, (stage + 1) * n)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a hop of ``t`` goes through host memory: gloo and a CUDA
    tensor (module docstring)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def send(t: torch.Tensor, dst: int, group) -> None:
    """Send ``t`` to the global rank ``dst`` of ``group``."""
    t = t.detach().contiguous()
    dist.send(t.cpu() if _staged(t, group) else t, dst, group=group)


def recv(shape, dtype, device, src: int, group) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` received from the global rank
    ``src`` of ``group``, on ``device``."""
    buf = torch.empty(shape, dtype=dtype, device=device)
    if _staged(buf, group):
        host = torch.empty(shape, dtype=dtype)
        dist.recv(host, src, group=group)
        return buf.copy_(host)
    dist.recv(buf, src, group=group)
    return buf


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the global rank ``src`` on every rank of ``group``, in
    place."""
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        return t.copy_(host)
    dist.broadcast(t, src, group=group)
    return t


@dataclasses.dataclass
class _Loop:
    """What one pipeline call needs besides its tensors."""

    stage_fn: Callable
    sizes: Tuple[int, ...]      # the tensors of each layer tuple
    pp: int
    stage: int
    ranks: Tuple[int, ...]      # the pipe group's global ranks, stage by stage
    group: object
    m: int
    head_rows: Optional[int]


def _layers(flat: Sequence[torch.Tensor], sizes) -> List[tuple]:
    out, i = [], 0
    for n in sizes:
        out.append(tuple(flat[i:i + n]))
        i += n
    return out


def _run(loop: _Loop, x: torch.Tensor, aux, layers, keep_graph: bool):
    """The stage's forward over the microbatches: (the output on every
    rank, [(input, output) of each microbatch] where ``keep_graph``)."""
    s, last = loop.stage, loop.pp - 1
    mb = x.shape[0] // loop.m
    rows = x.shape[1] if loop.head_rows is None else loop.head_rows
    outs, graphs = [], []
    for i in range(loop.m):
        sl = slice(i * mb, (i + 1) * mb)
        if s == 0:
            h = x[sl].detach()
        else:
            h = recv((mb, *x.shape[1:]), x.dtype, x.device, loop.ranks[s - 1], loop.group)
        if keep_graph and (s > 0 or x.requires_grad):
            h.requires_grad_()
        out = loop.stage_fn(h, layers, i, None if aux is None else aux[sl]).to(x.dtype)
        if s < last:
            send(out, loop.ranks[s + 1], loop.group)
        else:
            out = out[:, :rows]
            outs.append(out.detach())
        if keep_graph:
            graphs.append((h, out))
    y = torch.cat(outs) if s == last else \
        torch.empty((x.shape[0], rows, *x.shape[2:]), dtype=x.dtype, device=x.device)
    return broadcast(y, loop.ranks[last], loop.group), graphs


class _Pipeline(torch.autograd.Function):
    """The stage's loop, forward and backward (module docstring). Inputs:
    the loop, x (the local batch, equal on every stage), aux, the stage's
    layer tensors."""

    @staticmethod
    def forward(ctx, loop: _Loop, x, aux, *flat):
        ctx.loop = loop
        ctx.x_grad = ctx.needs_input_grad[1]
        leaves = [t.detach().requires_grad_() if ctx.needs_input_grad[3 + i] else t.detach()
                  for i, t in enumerate(flat)]
        xd = x.detach().requires_grad_(ctx.x_grad)
        with torch.enable_grad():
            y, ctx.graphs = _run(loop, xd, aux, _layers(leaves, loop.sizes), True)
        ctx.leaves = leaves
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return y

    @staticmethod
    def backward(ctx, g):
        loop, leaves = ctx.loop, ctx.leaves
        s, last = loop.stage, loop.pp - 1
        live = [i for i, t in enumerate(leaves) if t.requires_grad]
        grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
        x_grads = [None] * loop.m
        mb = g.shape[0] // loop.m
        for i in reversed(range(loop.m)):
            h, out = ctx.graphs[i]
            if s == last:
                go = g[i * mb:(i + 1) * mb]
            else:
                go = recv(out.shape, out.dtype, out.device, loop.ranks[s + 1], loop.group)
            inputs = ([h] if h.requires_grad else []) + [leaves[j] for j in live]
            got = torch.autograd.grad(out, inputs, go, allow_unused=True)
            ctx.graphs[i] = None
            if h.requires_grad:
                gh, got = got[0], got[1:]
                if s > 0:
                    send(gh, loop.ranks[s - 1], loop.group)
                else:
                    x_grads[i] = gh
            for j, gj in zip(live, got):
                if gj is not None:
                    grads[j] = gj if grads[j] is None else grads[j] + gj
        gx = None
        if ctx.x_grad:
            shape, dtype, device = ctx.x_meta
            gx = torch.cat(x_grads) if s == 0 else torch.empty(shape, dtype=dtype, device=device)
            gx = broadcast(gx, loop.ranks[0], loop.group)
        del ctx.graphs, ctx.leaves
        return (None, gx, None, *grads)


def pp_transformer(x: torch.Tensor, layers: Sequence[tuple], stage_fn: Callable, pp: int,
                   microbatches: int = 0, aux: Optional[torch.Tensor] = None,
                   head_rows: Optional[int] = None, grid=None) -> torch.Tensor:
    """Run a tower's stacked layers as a ``pp``-stage pipeline over this
    rank's pipe group (module docstring).

    x: ``[B, S, W]``, the local batch, the same on every stage.
    layers: this stage's ``L / pp`` layer tuples (tensors).
    stage_fn: ``stage_fn(h, layers, mb_index, aux_mb) -> h`` runs the
        stage's layers on one microbatch (``mb_index`` counts from 0 in
        the local batch).
    microbatches: M (0: :func:`pick_microbatches`); the batch must divide.
    aux: ``[B, ...]`` split with the microbatches, or None.
    head_rows: the leading tokens of each sample that the caller reads
        (None: all); the output is ``[B, head_rows, W]``, on every stage.
    grid: the ``mesh.Grid`` (default ``mesh.grid(1, pp)``)."""
    if grid is None:
        from nans_clip_tpu_torch.parallel import mesh
        grid = mesh.grid(1, pp)
    if grid.pp != pp:
        raise ValueError(f"pp={pp} but the grid has {grid.pp} stages")
    b = x.shape[0]
    m = microbatches or pick_microbatches(b, pp)
    if b % m:
        raise ValueError(f"local batch {b} not divisible by microbatches {m}")
    flat = [t for p in layers for t in p]
    if not all(torch.is_tensor(t) for t in flat):
        raise TypeError("pp_transformer takes layers of tensors (no int8 weights)")
    loop = _Loop(stage_fn, tuple(len(p) for p in layers), pp, grid.stage, grid.pipe_ranks,
                 grid.pipe_group, m, head_rows)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in flat)):
        return _Pipeline.apply(loop, x, aux, *flat)
    with torch.no_grad():
        return _run(loop, x, aux, list(layers), False)[0]


# -- stage-local storage -------------------------------------------------


def _stacks(module: nn.Module) -> List[Tuple[str, nn.ModuleList]]:
    out = []
    for path in STACKS:
        m = module
        for part in path.split("."):
            m = getattr(m, part, None)
            if m is None:
                break
        if isinstance(m, nn.ModuleList):
            out.append((path, m))
    return out


def localize(module: nn.Module, pp: int, stage: int) -> None:
    """Keep only stage ``stage``'s layers of each transformer tower: the
    other layers' parameters go to the meta device (module docstring).
    Cached packed weights are dropped."""
    for _, stack in _stacks(module):
        keep = stage_layers(len(stack), pp, stage)
        for i, layer in enumerate(stack):
            if i not in keep:
                layer.to("meta")
    for m in module.modules():
        if hasattr(m, "reset_caches"):
            m.reset_caches()


def is_layer(name: str) -> bool:
    """Whether the parameter ``name`` is a transformer layer's (stored by
    one stage under ``pp`` > 1)."""
    return name.startswith(tuple(p + "." for p in STACKS))


def local_layers(stack: nn.ModuleList, pp: int, stage: int) -> list:
    """The layer modules of ``stack`` that stage ``stage`` runs."""
    return [stack[i] for i in stage_layers(len(stack), pp, stage)]


def stored(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters that this rank stores (not on meta)."""
    return {n: p for n, p in module.named_parameters() if not p.is_meta}


def stage_optimizer_state(full_sd: dict, one_rank_names: Sequence[Sequence[str]],
                          local_names: Sequence[Sequence[str]]) -> dict:
    """The state dict of an optimizer over the parameter groups
    ``local_names`` cut from one process's ``full_sd`` over
    ``one_rank_names`` (the same groups, every parameter)."""
    index = {n: i for i, n in enumerate(n for g in one_rank_names for n in g)}
    flat = [n for g in local_names for n in g]
    state = {k: full_sd["state"][index[n]] for k, n in enumerate(flat)
             if index[n] in full_sd["state"]}
    groups, k = [], 0
    for g, names in zip(full_sd["param_groups"], local_names):
        groups.append({**g, "params": list(range(k, k + len(names)))})
        k += len(names)
    return {"state": state, "param_groups": groups}


def one_process_indices(opt_sd: dict, local_names: Sequence[Sequence[str]],
                        one_rank_names: Sequence[Sequence[str]]) -> dict:
    """A stage optimizer's ``opt_sd`` (over the groups ``local_names``)
    indexed as one process's optimizer over ``one_rank_names``: this
    stage's entries, every group's full ``params`` list (the inverse of
    :func:`stage_optimizer_state`)."""
    index = {n: i for i, n in enumerate(n for g in one_rank_names for n in g)}
    flat = [n for g in local_names for n in g]
    return {"state": {index[flat[k]]: st for k, st in opt_sd["state"].items()},
            "param_groups": [{**g, "params": [index[n] for n in names]}
                             for g, names in zip(opt_sd["param_groups"], one_rank_names)]}


def full_state(module_sd: dict, opt_sd: dict, grid, lead_only: bool = True):
    """(module state dict, optimizer state dict) of one process from the
    stages' ``module_sd`` (this stage's stored tensors, on the CPU) and
    ``opt_sd`` (this stage's entries indexed as in one process's layout,
    every group's full ``params`` list): gathered over the pipe group to
    its stage 0, or to every stage without ``lead_only``. Collective over
    the pipe group; a rank that gets nothing returns (None, None)."""
    mine = (module_sd, opt_sd["state"])
    dst = grid.pipe_ranks[0]
    if lead_only:
        got = [None] * grid.pp if grid.stage == 0 else None
        dist.gather_object(mine, got, dst=dst, group=grid.pipe_group)
        if got is None:
            return None, None
    else:
        got = [None] * grid.pp
        dist.all_gather_object(got, mine, group=grid.pipe_group)
    module_out, state = {}, {}
    for sd, st in got:
        for k, v in sd.items():
            module_out.setdefault(k, v)
        for k, v in st.items():
            state.setdefault(k, v)
    return module_out, {"state": dict(sorted(state.items())),
                        "param_groups": opt_sd["param_groups"]}
