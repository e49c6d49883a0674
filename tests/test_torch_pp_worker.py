"""What each rank computes for tests/test_torch_pp.py (no tests here).

``parallel/mesh.py::run_ranks`` runs :func:`run_pp` in 4 spawned processes,
which import the module of their target anew: so this module imports
neither JAX nor the test module, only numpy, torch, the port and
tests/test_torch_dp_worker.py (which imports no JAX either). One world of 4
gloo ranks holds every case: the grids ``data 2 x pipe 2`` (``mesh.grid(1,
2)``), ``pipe 4`` and ``data 2 x tp 2`` are formed on it in turn. Inputs
arrive as numpy arrays (global batches: each rank takes its rows with
``parallel/distributed.py::rank_rows``) and results leave as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.parallel import distributed, mesh
from nans_clip_tpu_torch.parallel import pp as pipe
from nans_clip_tpu_torch.training import trainer
from nans_clip_tpu_torch.utils import checkpoint
from tests.test_torch_dp_worker import _module, _np, _t, named_grads, named_params
from tests.test_torch_dp_worker import moments as dp_moments


def _union(mine: dict, grid) -> dict:
    """The union over the pipe group of every stage's ``mine``."""
    got = [None] * grid.pp
    dist.all_gather_object(got, mine, group=grid.pipe_group)
    out = {}
    for d in got:
        for k, v in d.items():
            out.setdefault(k, v)
    return out


def bare_loop(payload: dict) -> dict:
    """The bare pipeline at 4 stages (tests/test_pp.py:48's case): x, the
    stacked weights ``ws`` and the aux; each stage runs its layer
    ``tanh(h @ w) + h + aux``. The output, x's gradient and every layer's
    gradient of ``sum(out * g)``."""
    g4 = mesh.grid(1, 4)
    x = _t(payload["x"]).requires_grad_()
    ws = [_t(w).requires_grad_() for w in payload["ws"]]
    aux = _t(payload["aux"])
    local = [(ws[i],) for i in pipe.stage_layers(len(ws), 4, g4.stage)]

    def stage_fn(h, layers, mb_index, kb):
        for (w,) in layers:
            h = torch.tanh(h @ w) + h + kb[:, :, None]
        return h

    out = pipe.pp_transformer(x, local, stage_fn, 4, 0, aux=aux, grid=g4)
    (out * _t(payload["gout"])).sum().backward()
    grads = {i: _np(ws[i].grad) for i in pipe.stage_layers(len(ws), 4, g4.stage)}
    return {"out": _np(out), "x_grad": _np(x.grad), "w_grads": _union(grads, g4)}


def towers(case: dict, pp: int) -> dict:
    """The deterministic features of this rank's rows at ``pp`` stages (a
    ``data x pipe`` grid of the 4 ranks), the features of every data
    index's rows gathered."""
    g = mesh.grid(1, pp)
    opts = ModelOptions(attn_impl=case["attn_impl"], pp=pp, data=g.data)
    module = _module(case["cfg"], case["state_dict"])
    pipe.localize(module, pp, g.stage)
    images = distributed.rank_rows(case["images"], g.data_index, g.data)
    texts = distributed.rank_rows(case["texts"], g.data_index, g.data)
    with torch.no_grad():
        img = module.encode_image(_t(images), opts)
        txt = module.encode_text(_t(texts).long(), opts)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (g.data_index, g.stage, _np(img), _np(txt)))
    rows = sorted((d, i, t) for d, s, i, t in out if s == 0)
    every = [(s, i, t) for d, s, i, t in out if d == g.data_index]
    equal = all(np.array_equal(i, every[0][1]) and np.array_equal(t, every[0][2])
                for _, i, t in every)
    return {"image": np.concatenate([r[1] for r in rows]),
            "text": np.concatenate([r[2] for r in rows]), "stages_equal": equal,
            "stored": sum(p.numel() for p in pipe.stored(module).values()),
            "all": sum(p.numel() for p in module.parameters())}


def full_grads(state, grid) -> dict:
    """Every parameter's gradient after the step's reductions, full size,
    the stages' joined."""
    return _union(named_grads(state), grid)


def full_params(state) -> dict:
    """Every parameter (and buffer) in one process's layout, on every rank."""
    if state.pipe is None:
        return named_params(state)
    module_sd, _ = _full(state)
    return {k: _np(v) for k, v in module_sd.items()}


def _full(state):
    from nans_clip_tpu_torch.parallel.fsdp import full_state
    names = trainer.decay_groups(state.module)
    if state.fsdp is not None:
        module_sd, opt_sd = full_state(state.fsdp, state.optimizer, names)
    else:
        module_sd = {k: v.detach().cpu() for k, v in state.module.state_dict().items()
                     if not v.is_meta}
        opt_sd = pipe.one_process_indices(state.optimizer.state_dict(),
                                          trainer.stored_groups(state.module), names)
    return pipe.full_state(module_sd, opt_sd, state.pipe, lead_only=False)


def moments(state) -> dict:
    """{parameter name: (first moment, second moment)} in the one-rank
    layout, the stages' joined."""
    if state.pipe is None:
        return dp_moments(state)
    _, sd = _full(state)
    flat = [n for g in trainer.decay_groups(state.module) for n in g]
    return {flat[i]: (_np(st["exp_avg"]), _np(st["exp_avg_sq"])) for i, st in sd["state"].items()}


def _replicated_equal(state, grid) -> bool:
    """Whether this stage's replicated parameters (no transformer layer)
    equal every other stage's, bit for bit."""
    with trainer.full_weights(state):
        mine = {n: _np(p) for n, p in state.module.named_parameters()
                if not pipe.is_layer(n) and not p.is_meta}
    got = [None] * grid.pp
    dist.all_gather_object(got, mine, group=grid.pipe_group)
    return all(np.array_equal(v, other[n]) for other in got for n, v in mine.items())


def train_run(case: dict, options: ModelOptions, grid, fsdp_on: bool = False,
              ckpt_dir: str = None) -> dict:
    """``case["steps"]`` (default 1) train steps of ``case``'s weights on
    this rank's rows, from ``case["seeds"]`` (None: no generator); with
    ``case["ids_keep"]`` the FLIP tokens of each microbatch replaced by
    those. The loss of each step, the gradients, parameters and moments
    after the last, the bytes this rank stores, and whether the stages'
    replicated parameters are bit-equal. With ``ckpt_dir`` a checkpoint
    ``step_1`` is saved after the first step."""
    cfg, tcfg = case["cfg"], trainer.TrainConfig(**case["tcfg"])
    accum = tcfg.accum_freq
    data, d = (grid.data, grid.data_index) if grid is not None else (1, 0)
    state = trainer.create_train_state(_module(cfg, case["state_dict"]), tcfg, device="cpu")
    state = trainer.shard_train_state(state, tcfg, options, fsdp_on, case.get("fsdp_min_size"))
    step = trainer.make_train_step(cfg, tcfg, options)
    draw = trainer.draw_microbatches
    if case.get("ids_keep") is not None:
        keep = [_t(k) for k in case["ids_keep"]]
        trainer.draw_microbatches = lambda n, *a, **k: [(None, keep[j]) for j in range(n)]
    images = _t(distributed.rank_rows(case["images"], d, data, accum))
    texts = _t(distributed.rank_rows(case["texts"], d, data, accum))
    out = {"losses": []}
    seeds = case.get("seeds") or [None] * case.get("steps", 1)
    try:
        for i, seed in enumerate(seeds):
            state, metrics = step(state, images, texts, seed)
            out["losses"].append(float(metrics["loss"]))
            if ckpt_dir is not None and i == 0:
                checkpoint.save_checkpoint(ckpt_dir, "step_1", state, {"step": 1})
    finally:
        trainer.draw_microbatches = draw
    pipe_grid = state.pipe
    out.update(grads=full_grads(state, pipe_grid) if pipe_grid else named_grads(state),
               params=full_params(state), moments=moments(state),
               stored=sum(p.numel() for p in pipe.stored(state.module).values())
               if state.fsdp is None else state.fsdp.stored_bytes() // 4,
               all=sum(p.numel() for p in state.module.parameters()),
               buffers={k: _np(v) for k, v in state.module.named_buffers()})
    if pipe_grid is not None:
        out["replicated_equal"] = _replicated_equal(state, pipe_grid)
    return out


def run_pp(rank: int, payload: dict) -> dict:
    """Every case of ``payload`` in one of 4 ranks (module docstring)."""
    torch.set_num_threads(1)
    out = {"errors": _errors()}
    out["bare"] = bare_loop(payload["bare"])
    out["towers"] = {pp: towers(payload["towers"][pp], pp) for pp in (2, 4)}
    g2 = mesh.grid(1, 2)
    assert (g2.data_index, g2.stage) == divmod(rank, 2)
    assert mesh.pipe_group(2) is g2.pipe_group and mesh.data_group(1, 2) is g2.data_group
    det = ModelOptions(attn_impl="fused", deterministic=True, data=2, pp=2)
    out["step"] = train_run(payload["step"], det, g2)
    out["fsdp"] = train_run(dict(payload["step"], fsdp_min_size=payload["fsdp_min_size"]),
                            det, g2, fsdp_on=True)
    out["accum"] = train_run(payload["accum"], dataclasses.replace(det, remat=True), g2)
    out["fsdp_clip"] = train_run(dict(payload["clip"], fsdp_min_size=payload["fsdp_min_size"]),
                                 det, g2, fsdp_on=True)
    train = ModelOptions(attn_impl="fused", deterministic=False, data=2, pp=2)
    out["dropout"] = train_run(payload["dropout"], train, g2,
                               ckpt_dir=os.path.join(payload["tmp"], "ckpt"))
    out["rn50"] = {"pp": train_run(payload["rn50"], ModelOptions(attn_impl="xla", data=2, pp=2),
                                   g2)}
    g_tp = mesh.check_grid(2, 2)
    out["rn50"]["tp"] = train_run(payload["rn50"], ModelOptions(attn_impl="xla", data=2, tp=2),
                                  g_tp)
    out["tp_remat"] = train_run(payload["step"], ModelOptions(attn_impl="fused", data=2, tp=2,
                                                              remat=True), g_tp)
    return out


def _errors() -> dict:
    """The messages of the calls that must raise on a world of 4."""
    msgs = {}
    for name, fn in (("pp3", lambda: mesh.check_grid(1, 1, 3)),
                     ("tp_pp", lambda: mesh.grid(2, 2)),
                     ("data", lambda: mesh.check_grid(1, 4, 2))):
        try:
            fn()
        except ValueError as e:
            msgs[name] = str(e)
    return msgs


def one_rank(case: dict, options: ModelOptions) -> dict:
    """``case`` on one process at the global batch (no group)."""
    return train_run(case, dataclasses.replace(options, data=1, pp=1), None)
