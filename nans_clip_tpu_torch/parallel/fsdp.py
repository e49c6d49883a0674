"""Fully sharded storage of the parameters and the Adam moments over the
data group (counterpart of the JAX package's ``--fsdp``: ``param_spec``
with ``fsdp``, ``nans_clip_tpu/parallel/mesh.py:80-124``, and
``shard_train_state``, ``training/trainer.py:193-222``).

The JAX package shards each leaf of its parameter tree (layers stacked,
kernels ``[in, out]``, q|k|v packed) over ``data`` on the dimension that
``param_spec`` picks, and XLA gathers a leaf where it is used and
reduce-scatters its gradient. The port keeps the same shards:

* :func:`jax_leaves` maps the module's parameters to the JAX leaves: a
  transformer layer's tensors stacked over the layers (the text tower's
  q, k and v weights concatenated into ``wqkv``), torch's ``[out, in]``
  kernels transposed, convolutions from OIHW to HWIO; each :class:`Leaf`
  converts between the torch tensors and the JAX layout. ``mesh.param_spec``
  picks each leaf's sharded dimension, so a rank stores exactly the shard
  its JAX device stores. Under pipeline parallelism (``pp`` > 1) the module
  holds one stage's layers (``parallel/pp.py::localize``: the others on
  the meta device, which no leaf takes): a stacked leaf is the stage's
  ``[L / pp, ...]`` slice, JAX's shard over ``pipe``, and its ``data``
  dimension is the one ``param_spec`` picks for the full ``[L, ...]``
  leaf at that ``pp``.
* :class:`Sharded` holds the rank's shard of every sharded leaf as an fp32
  ``nn.Parameter``, which the optimizer updates (its moments are shards
  too); the module keeps the replicated leaves' tensors and, between
  steps, an empty tensor for each sharded one. :meth:`Sharded.gather`
  all-gathers the shards over the data group into the module's parameters
  before a step's forwards (the kernels see full weights; both passes of an
  accumulated step run on the same gathered weights), :meth:`Sharded.
  reduce_grads` reduce-scatters the gradients into the shards (their mean
  over the data group) and all-reduces the replicated ones, and
  :meth:`Sharded.release` frees the full tensors.
* The reduce-scatter by backend (:func:`reduce_scatter_sum`): NCCL's
  ``reduce_scatter_tensor``; under gloo an all-reduce of the whole flat
  buffer and the rank's slice of it, chosen by the backend's name, not by a
  failure. The gathers and all-reduces are taken by both backends, on CPU
  and CUDA tensors.
* Checkpoints stay those of one rank: :func:`full_state` gathers the
  module's state dict and the optimizer's state into the one-rank layout,
  and :func:`shard_optimizer_state` cuts them back (``utils/checkpoint.py``), so a run
  resumes at any world size.

Collectives go in flat buckets of at most ``tp.GRAD_BUCKET`` elements a
rank, leaves in a fixed order, so that every rank's calls match.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from nans_clip_tpu_torch.parallel import mesh
from nans_clip_tpu_torch.parallel.tp import GRAD_BUCKET

T = (1, 0)
# A transformer layer's tensor -> (JAX path below the tower's stack, the
# permutation of the torch dims that gives the JAX layout, q|k|v part or None)
_VIT_LAYER = {
    "ln_1.weight": (("ln_1", "scale"), None, None), "ln_1.bias": (("ln_1", "bias"), None, None),
    "attn.in_proj_weight": (("attn", "wqkv"), T, None),
    "attn.in_proj_bias": (("attn", "bqkv"), None, None),
    "attn.out_proj.weight": (("attn", "wo"), T, None),
    "attn.out_proj.bias": (("attn", "bo"), None, None),
    "ln_2.weight": (("ln_2", "scale"), None, None), "ln_2.bias": (("ln_2", "bias"), None, None),
    "mlp.c_fc.weight": (("mlp", "w1"), T, None), "mlp.c_fc.bias": (("mlp", "b1"), None, None),
    "mlp.c_proj.weight": (("mlp", "w2"), T, None),
    "mlp.c_proj.bias": (("mlp", "b2"), None, None),
}
_BERT_LAYER = {
    **{f"attention.self.{n}.weight": (("attn", "wqkv"), T, i)
       for i, n in enumerate(("query", "key", "value"))},
    **{f"attention.self.{n}.bias": (("attn", "bqkv"), None, i)
       for i, n in enumerate(("query", "key", "value"))},
    "attention.output.dense.weight": (("attn", "wo"), T, None),
    "attention.output.dense.bias": (("attn", "bo"), None, None),
    "attention.output.LayerNorm.weight": (("attn_ln", "scale"), None, None),
    "attention.output.LayerNorm.bias": (("attn_ln", "bias"), None, None),
    "intermediate.dense.weight": (("mlp", "w1"), T, None),
    "intermediate.dense.bias": (("mlp", "b1"), None, None),
    "output.dense.weight": (("mlp", "w2"), T, None),
    "output.dense.bias": (("mlp", "b2"), None, None),
    "output.LayerNorm.weight": (("mlp_ln", "scale"), None, None),
    "output.LayerNorm.bias": (("mlp_ln", "bias"), None, None),
}
_STACKS = ((re.compile(r"^visual\.transformer\.resblocks\.(\d+)\.(.+)$"),
            ("visual", "transformer"), _VIT_LAYER),
           (re.compile(r"^bert\.encoder\.layer\.(\d+)\.(.+)$"), ("bert", "encoder"), _BERT_LAYER))


@dataclasses.dataclass
class Leaf:
    """One leaf of the JAX parameter tree: its path, the torch parameters
    it is made of (layer by layer, q|k|v parts in order), its JAX shape and
    the dimension sharded over ``data`` (None: replicated)."""

    path: Tuple[str, ...]
    names: List[str]
    shape: Tuple[int, ...]
    perm: Optional[Tuple[int, ...]]
    stacked: bool
    parts: int
    dim: Optional[int] = None

    def to_jax(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The members (torch layout, ``names`` order) as the JAX leaf."""
        ts = [t if self.perm is None else t.permute(self.perm) for t in tensors]
        if self.parts > 1:
            ts = [torch.cat(ts[i:i + self.parts], dim=-1) for i in range(0, len(ts), self.parts)]
        return torch.stack(ts) if self.stacked else ts[0]

    def from_jax(self, full: torch.Tensor) -> List[torch.Tensor]:
        """The JAX leaf as its members, contiguous in the torch layout."""
        per = list(full.unbind(0)) if self.stacked else [full]
        if self.parts > 1:
            per = [p for t in per for p in t.chunk(self.parts, dim=-1)]
        if self.perm is not None:
            inv = tuple(sorted(range(len(self.perm)), key=lambda i: self.perm[i]))
            per = [p.permute(inv) for p in per]
        return [p.contiguous(memory_format=torch.channels_last) if p.dim() == 4
                else p.contiguous() for p in per]

    def shard_shape(self, data: int) -> Tuple[int, ...]:
        if self.dim is None:
            return self.shape
        return tuple(n // data if d == self.dim else n for d, n in enumerate(self.shape))


def jax_leaves(module: nn.Module, data: int = 1,
               fsdp_min_size: Optional[int] = None, pp: int = 1) -> List[Leaf]:
    """The JAX leaves of ``module``'s parameters, in the order of their
    first member in ``named_parameters()``, each with the dimension
    ``mesh.param_spec`` shards over ``data`` (None at ``data`` 1); at ``pp``
    > 1 only the stored ones (not on the meta device), the stacks one
    stage's layers (module docstring)."""
    stacks: Dict[Tuple[str, ...], dict] = {}
    order: List[Tuple[str, ...]] = []
    leaves: Dict[Tuple[str, ...], Leaf] = {}
    for name, p in module.named_parameters():
        if p.is_meta and pp > 1:   # another stage's layer
            continue
        for pattern, prefix, table in _STACKS:
            m = pattern.match(name)
            if m:
                tail, perm, part = table[m.group(2)]
                path = prefix + tail
                if path not in stacks:
                    stacks[path] = {"members": {}, "perm": perm, "parts": 1 if part is None else 3,
                                    "shape": tuple(p.shape)}
                    order.append(path)
                stacks[path]["members"][(int(m.group(1)), part or 0)] = name
                break
        else:
            perm = (2, 3, 1, 0) if p.dim() == 4 else \
                T if p.dim() == 2 and name.endswith("_proj.weight") else None
            shape = tuple(p.shape) if perm is None else tuple(p.shape[i] for i in perm)
            path = tuple(name.split("."))
            leaves[path] = Leaf(path, [name], shape, perm, False, 1)
            order.append(path)
    for path, st in stacks.items():
        keys = sorted(st["members"])
        first, n_layers = keys[0][0], keys[-1][0] - keys[0][0] + 1
        if len(keys) != n_layers * st["parts"] or (pp == 1 and first):
            raise ValueError(f"{'/'.join(path)}: layers {keys} are not a "
                             f"{'full stack' if pp == 1 else 'stage of consecutive layers'}")
        shape = st["shape"] if st["perm"] is None else tuple(st["shape"][i] for i in st["perm"])
        shape = (n_layers, *shape[:-1], shape[-1] * st["parts"])
        leaves[path] = Leaf(path, [st["members"][k] for k in keys], shape, st["perm"], True,
                            st["parts"])
    out = [leaves[p] for p in order]
    for leaf in out:
        full = (leaf.shape[0] * pp, *leaf.shape[1:]) if leaf.stacked else leaf.shape
        spec = mesh.param_spec(leaf.path, full, data, fsdp_min_size, pp)
        leaf.dim = spec.index(mesh.DATA_AXIS) if mesh.DATA_AXIS in spec else None
        if leaf.dim is not None and leaf.parts > 1 and leaf.dim == len(leaf.shape) - 1 \
                and (leaf.shape[-1] // leaf.parts) % data:
            raise ValueError(f"{'/'.join(leaf.path)}: a q|k|v third does not split {data} ways")
    return out


def reduce_scatter_sum(flat: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk of the sum over ``group`` of ``flat`` (``data``
    equal chunks): NCCL's reduce-scatter, or under gloo an all-reduce and
    the rank's slice (module docstring)."""
    data, rank = dist.get_world_size(group), dist.get_rank(group)
    n = flat.numel() // data
    if dist.get_backend(group) == "nccl":
        out = torch.empty(n, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(out, flat, group=group)
        return out
    dist.all_reduce(flat, group=group)
    return flat[rank * n:(rank + 1) * n].clone()


def _buckets(items: Sequence, sizes: Sequence[int]):
    """Consecutive runs of ``items`` of at most ``GRAD_BUCKET`` elements (a
    larger item alone)."""
    run, n = [], 0
    for item, size in zip(items, sizes):
        if run and n + size > GRAD_BUCKET:
            yield run
            run, n = [], 0
        run.append(item)
        n += size
    if run:
        yield run


class Sharded:
    """The rank's shards of a module's sharded leaves (module docstring).
    Built from a module that holds the full parameters (equal on every
    rank); the module's sharded parameters are released on return."""

    def __init__(self, module: nn.Module, group, fsdp_min_size: Optional[int] = None,
                 pp: int = 1):
        self.module, self.group = module, group
        self.data, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self.params = {n: p for n, p in module.named_parameters() if not p.is_meta}
        self.leaves = jax_leaves(module, self.data, fsdp_min_size, pp)
        self.sharded = [leaf for leaf in self.leaves if leaf.dim is not None]
        self.shards: Dict[Tuple[str, ...], nn.Parameter] = {}
        for leaf in self.sharded:
            members = [self.params[n] for n in leaf.names]
            with torch.no_grad():
                shard = self.chunk(leaf, leaf.to_jax([p.detach() for p in members])).clone()
            self.shards[leaf.path] = nn.Parameter(shard, requires_grad=members[0].requires_grad)
        self.release()

    def chunk(self, leaf: Leaf, full: torch.Tensor) -> torch.Tensor:
        return full.chunk(self.data, dim=leaf.dim)[self.rank]

    def leaf_of(self) -> Dict[str, Leaf]:
        return {n: leaf for leaf in self.leaves for n in leaf.names}

    def _gather_flat(self, tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
        """Each rank's copy of ``tensors`` (equal shapes on every rank):
        ``out[r][i]``, in buckets of one all-gather."""
        out = [[] for _ in range(self.data)]
        for run in _buckets(list(tensors), [t.numel() for t in tensors]):
            flat = torch.cat([t.reshape(-1) for t in run])
            got = [torch.empty_like(flat) for _ in range(self.data)]
            dist.all_gather(got, flat, group=self.group)
            for r, g in enumerate(got):
                out[r].extend(part.view_as(t) for part, t in
                              zip(g.split([t.numel() for t in run]), run))
        return out

    def gather_leaves(self, per_leaf: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The full JAX-layout tensors of the sharded leaves from this
        rank's chunks ``per_leaf`` (one a sharded leaf, in order)."""
        got = self._gather_flat(per_leaf)
        return [torch.cat([got[r][i] for r in range(self.data)], dim=leaf.dim)
                for i, leaf in enumerate(self.sharded)]

    @torch.no_grad()
    def gather(self) -> None:
        """The full weights into the module's sharded parameters."""
        fulls = self.gather_leaves([self.shards[leaf.path].detach() for leaf in self.sharded])
        for leaf, full in zip(self.sharded, fulls):
            for name, t in zip(leaf.names, leaf.from_jax(full)):
                self.params[name].data = t

    def release(self) -> None:
        """Free the module's full copies of the sharded parameters (and
        their gradients and any packed-weight cache built from them)."""
        for leaf in self.sharded:
            for name in leaf.names:
                p = self.params[name]
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
                p.grad = None
        for m in self.module.modules():
            if hasattr(m, "reset_caches"):
                m.reset_caches()

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """The mean over the data group of the step's gradients: into each
        trainable shard's ``.grad`` (reduce-scatter) and in place for the
        replicated parameters (all-reduce)."""
        live = [leaf for leaf in self.sharded if self.shards[leaf.path].requires_grad]
        grads = [leaf.to_jax([self.params[n].grad for n in leaf.names]) for leaf in live]
        sizes = [g.numel() for g in grads]
        for run in _buckets(list(range(len(live))), sizes):
            flat = torch.cat([torch.cat([grads[i].chunk(self.data, dim=live[i].dim)[r].reshape(-1)
                                         for i in run]) for r in range(self.data)])
            mine = reduce_scatter_sum(flat, self.group).div_(self.data)
            for i, part in zip(run, mine.split([sizes[i] // self.data for i in run])):
                shard = self.shards[live[i].path]
                shard.grad = part.view(shard.shape).clone()
        del grads
        replicated = [self.params[n] for leaf in self.leaves if leaf.dim is None
                      for n in leaf.names]
        all_reduce_mean(replicated, self.group)

    def grad_norm_sq(self) -> torch.Tensor:
        """The squared norm of the reduced gradient that this rank's stage
        holds, split ``[layers, rest]``: the shards' squares summed over the
        data group, the replicated ones once. Their sum is the global
        squared norm at ``pp`` 1; under ``pp`` > 1 the layers' part is
        summed over the pipe group by the caller."""
        dev = next(iter(self.params.values())).device
        sq = torch.zeros(2, device=dev)
        for leaf in self.sharded:
            g = self.shards[leaf.path].grad
            if g is not None:
                sq[0 if leaf.stacked else 1] += g.float().square().sum()
        dist.all_reduce(sq, group=self.group)
        for leaf in self.leaves:
            if leaf.dim is None:
                for n in leaf.names:
                    g = self.params[n].grad
                    if g is not None:
                        sq[0 if leaf.stacked else 1] += g.float().square().sum()
        return sq

    def optimizer_params(self, names: Sequence[str]) -> List[torch.Tensor]:
        """The tensors the optimizer updates for the torch parameters
        ``names`` (in order): a sharded leaf's shard at its first member,
        nothing at its other members, the parameter itself otherwise."""
        leaf_of, out = self.leaf_of(), []
        for n in names:
            leaf = leaf_of[n]
            if leaf.dim is None:
                out.append(self.params[n])
            elif leaf.names[0] == n:
                out.append(self.shards[leaf.path])
        return out

    def stored_bytes(self) -> int:
        """Bytes of parameters this rank keeps between steps."""
        rep = sum(self.params[n].numel() * self.params[n].element_size()
                  for leaf in self.leaves if leaf.dim is None for n in leaf.names)
        return rep + sum(s.numel() * s.element_size() for s in self.shards.values())


def all_reduce_mean(params: Sequence[torch.Tensor], group) -> None:
    """The mean over ``group`` of the gradients of ``params``, in place, in
    buckets of one all-reduce (parameters without a gradient skipped; every
    rank holds the same list)."""
    grads = [p.grad for p in params if p.grad is not None]
    data = dist.get_world_size(group)
    for run in _buckets(grads, [g.numel() for g in grads]):
        flat = torch.cat([g.reshape(-1) for g in run])
        dist.all_reduce(flat, group=group)
        flat.div_(data)
        for g, part in zip(run, flat.split([g.numel() for g in run])):
            g.copy_(part.view_as(g))


def _is_moment(v) -> bool:
    """A per-element optimizer state (a moment), not a count."""
    return torch.is_tensor(v) and v.dim() > 0


def _units(sharded: Sharded, optimizer: torch.optim.Optimizer):
    """The optimizer's parameters in order, each with its sharded leaf or,
    for a replicated parameter, its name."""
    leaf_by_shard = {id(sharded.shards[leaf.path]): leaf for leaf in sharded.sharded}
    name_of = {id(p): n for n, p in sharded.params.items()}
    return [(p, leaf_by_shard.get(id(p)), name_of.get(id(p)))
            for g in optimizer.param_groups for p in g["params"]]


def full_state(sharded: Sharded, optimizer: torch.optim.Optimizer,
               one_rank_names: Sequence[Sequence[str]]) -> Tuple[dict, dict]:
    """(the module's full state dict, the optimizer's state dict in the
    layout of one rank's optimizer over the parameter groups
    ``one_rank_names``), on the CPU. Collective over the data group; every
    rank gets the same dicts. A pipeline stage's hold its stored
    parameters' entries (``parallel/pp.py::full_state`` joins the
    stages')."""
    sharded.gather()
    module_sd = {k: v.detach().to("cpu", torch.float32)
                 for k, v in sharded.module.state_dict().items() if not v.is_meta}
    sharded.release()
    sd = optimizer.state_dict()
    by_name = {}
    for k, (p, leaf, name) in enumerate(_units(sharded, optimizer)):
        st = sd["state"].get(k)
        if st is None:
            continue
        if leaf is None:
            by_name[name] = {key: v.cpu() if torch.is_tensor(v) else v for key, v in st.items()}
            continue
        members = [dict() for _ in leaf.names]
        for key, v in st.items():
            if _is_moment(v):
                for m, t in zip(members, leaf.from_jax(_gather_one(sharded, leaf, v))):
                    m[key] = t.cpu()
            else:
                for m in members:
                    m[key] = v.cpu().clone() if torch.is_tensor(v) else v
        by_name.update(zip(leaf.names, members))
    index = {n: i for i, n in enumerate(n for g in one_rank_names for n in g)}
    return module_sd, {
        "state": {index[n]: st for n, st in by_name.items()},
        "param_groups": [{**g, "params": [index[n] for n in names]}
                         for g, names in zip(sd["param_groups"], one_rank_names)]}


def shard_optimizer_state(sharded: Sharded, optimizer: torch.optim.Optimizer,
                          full_sd: dict, one_rank_names: Sequence[Sequence[str]]) -> None:
    """Load into ``optimizer`` (over :meth:`Sharded.optimizer_params`) the
    one-rank state dict ``full_sd`` (the layout :func:`full_state` writes):
    each sharded leaf's moments cut to this rank's shard."""
    names = [n for g in one_rank_names for n in g]
    state = {}
    for k, (_, leaf, name) in enumerate(_units(sharded, optimizer)):
        first = name if leaf is None else leaf.names[0]
        st = full_sd["state"].get(names.index(first))
        if st is None:
            continue
        if leaf is None:
            state[k] = st
            continue
        member_st = [full_sd["state"][names.index(n)] for n in leaf.names]
        state[k] = {key: _member_shard(sharded, leaf, [m[key] for m in member_st])
                    if _is_moment(v) else v for key, v in st.items()}
    optimizer.load_state_dict({
        "state": state,
        "param_groups": [{**g, "params": mine["params"]} for g, mine in
                         zip(full_sd["param_groups"], optimizer.state_dict()["param_groups"])]})


def _member_shard(sharded: Sharded, leaf: Leaf, members: Sequence[torch.Tensor]) -> torch.Tensor:
    """This rank's shard of the leaf made of ``members`` (torch layout)."""
    dev = sharded.shards[leaf.path].device
    return sharded.chunk(leaf, leaf.to_jax([m.to(dev) for m in members])).clone()


def _gather_one(sharded: Sharded, leaf: Leaf, v: torch.Tensor) -> torch.Tensor:
    got = sharded._gather_flat([v.contiguous()])
    return torch.cat([got[r][0] for r in range(sharded.data)], dim=leaf.dim)
