"""What each rank computes for tests/test_torch_dp.py (no tests here).

``parallel/mesh.py::run_ranks`` runs :func:`run_data2` and :func:`run_grid`
in spawned processes, which import the module of their target anew: so this
module imports neither JAX nor the test module, only numpy, torch and the
port. Inputs arrive as numpy arrays (global batches: each rank takes its
rows with ``parallel/distributed.py::rank_rows``) and results leave as
numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nans_clip_tpu_torch.data.augment import preprocess_images
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.parallel import distributed, fsdp, mesh
from nans_clip_tpu_torch.parallel.loss import gather_features
from nans_clip_tpu_torch.training import trainer


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy().copy()


def _module(cfg, state_dict):
    module = build_clip(cfg)
    module.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    return module


def named_grads(state) -> dict:
    """Every parameter's gradient after the step's reductions, full size
    (a sharded state's gathered from the shards)."""
    if state.fsdp is None:
        return {n: _np(p.grad) for n, p in state.module.named_parameters()
                if p.grad is not None}
    sh = state.fsdp
    out = {n: _np(sh.params[n].grad) for leaf in sh.leaves if leaf.dim is None
           for n in leaf.names if sh.params[n].grad is not None}
    fulls = sh.gather_leaves([sh.shards[leaf.path].grad for leaf in sh.sharded])
    for leaf, full in zip(sh.sharded, fulls):
        out.update({n: _np(t) for n, t in zip(leaf.names, leaf.from_jax(full))})
    return out


def named_params(state) -> dict:
    with trainer.full_weights(state):
        return {n: _np(p) for n, p in state.module.named_parameters()}


def moments(state) -> dict:
    """{parameter name: (first moment, second moment)} in the one-rank
    layout (a sharded state's gathered by ``fsdp.full_state``)."""
    names = trainer.decay_groups(state.module)
    if state.fsdp is None:
        sd = state.optimizer.state_dict()
    else:
        sd = fsdp.full_state(state.fsdp, state.optimizer, names)[1]
    flat = [n for g in names for n in g]
    return {flat[i]: (_np(st["exp_avg"]), _np(st["exp_avg_sq"])) for i, st in sd["state"].items()}


def train_run(case: dict, options: ModelOptions, data_index: int = 0, data: int = 1,
              fsdp_min_size=None, fsdp_on: bool = False) -> dict:
    """``case["steps"]`` train steps (default 1) of ``case``'s weights on
    this rank's rows of the global batch, from the generator seeds
    ``case["seeds"]`` (None: deterministic); images given raw (uint8) are
    preprocessed with ``case["aug_seed"]``'s augmentation, the rank's rows
    of the draws. The loss and accuracies of each step, then the
    gradients, parameters and moments after the last."""
    cfg, tcfg = case["cfg"], trainer.TrainConfig(**case["tcfg"])
    accum = tcfg.accum_freq
    state = trainer.create_train_state(_module(cfg, case["state_dict"]), tcfg, device="cpu")
    state = trainer.shard_train_state(state, tcfg, options, fsdp_on, fsdp_min_size)
    step = trainer.make_train_step(cfg, tcfg, options)
    images = distributed.rank_rows(case["images"], data_index, data, accum)
    texts = distributed.rank_rows(case["texts"], data_index, data, accum)
    if images.dtype == np.uint8:
        n = case["images"].shape[0]
        rows = None if data == 1 else (n, distributed.rank_row_index(
            data_index, data, accum, n // (data * accum)))
        images = preprocess_images(torch.Generator().manual_seed(case["aug_seed"]), _t(images),
                                   cfg.vision.image_resolution, augment=True, rows=rows)
    out = {"losses": [], "acc": [], "images": _np(torch.as_tensor(images))}
    seeds = case.get("seeds") or [None] * case.get("steps", 1)
    for seed in seeds:
        state, metrics = step(state, images, _t(texts), seed)
        out["losses"].append(float(metrics["loss"]))
        out["acc"].append((float(metrics["i2t_acc"]), float(metrics["t2i_acc"])))
    out.update(grads=named_grads(state), params=named_params(state), moments=moments(state),
               buffers={k: _np(v) for k, v in state.module.named_buffers()})
    if state.fsdp is not None:
        sh = state.fsdp
        out["fsdp"] = {"stored_bytes": sh.stored_bytes(),
                       "full_bytes": 4 * sum(int(np.prod(leaf.shape)) for leaf in sh.leaves),
                       "shards": {"/".join(k): tuple(v.shape) for k, v in sh.shards.items()},
                       "leaf_shapes": {"/".join(leaf.path): leaf.shape for leaf in sh.leaves}}
    return out


def flip_rows(case: dict, data_index: int, data: int) -> np.ndarray:
    """The FLIP tokens this rank's encode takes in microbatch 0 of the
    step drawn from ``case["seeds"][0]``."""
    cfg, tcfg = case["cfg"], trainer.TrainConfig(**case["tcfg"])
    n = case["images"].shape[0] // tcfg.accum_freq
    draws = trainer.draw_microbatches(tcfg.accum_freq, n, cfg.vision.seq_len, tcfg.mask_ratio,
                                      torch.Generator().manual_seed(case["seeds"][0]), True)
    micro = n // data
    return _np(draws[0][1][data_index * micro:(data_index + 1) * micro])


def rn_features(case: dict, data_index: int, data: int) -> np.ndarray:
    """The ResNet tower's training-mode features of this rank's rows,
    gathered over the data group (statistics of the global batch; the
    running ones left as they are)."""
    module = _module(case["cfg"], case["state_dict"])
    opts = ModelOptions(attn_impl="xla", data=data)
    images = _t(distributed.rank_rows(case["images"], data_index, data))
    with torch.no_grad():
        f = module.encode_image(images, opts, bn_train=True, bn_update=False)
        group = mesh.check_grid(1, data).data_group if data > 1 else None
        return _np(gather_features(f, group))


def run_data2(rank: int, payload: dict) -> dict:
    """The data-2 cases of ``payload`` in one rank: ``"jax"`` (the DP and
    FSDP steps at accum 1 and 2), ``"dropout"`` (with FLIP and
    augmentation), ``"rn50"``."""
    torch.set_num_threads(1)
    grid = mesh.check_grid(1, 2)
    assert grid.data_index == rank and grid.model_group is None
    out = {"errors": _errors()}
    if "jax" in payload:
        det = ModelOptions(attn_impl="fused", deterministic=True, data=2)
        for key, on in (("jax", False), ("fsdp", True)):
            out[key] = {accum: train_run(dict(payload["jax"], tcfg={**payload["jax"]["tcfg"],
                                                                    "accum_freq": accum}),
                                         det, rank, 2, payload["fsdp_min_size"], on)
                        for accum in (1, 2)}
    if "dropout" in payload:
        opts = ModelOptions(attn_impl="fused", deterministic=False, data=2)
        out["dropout"] = {name: train_run(c, opts, rank, 2)
                          for name, c in payload["dropout"].items()}
        out["flip"] = {name: flip_rows(c, rank, 2) for name, c in payload["dropout"].items()}
    if "rn50" in payload:
        rn = payload["rn50"]
        out["rn50"] = {"features": rn_features(rn, rank, 2),
                       "train": train_run(rn, ModelOptions(attn_impl="xla", data=2), rank, 2)}
    return out


def _errors() -> dict:
    """The messages of the calls that must raise on a world of 2."""
    msgs = {}
    for name, fn in (("data3", lambda: mesh.check_grid(1, 3)),
                     ("tp4", lambda: mesh.check_grid(4, 1))):
        try:
            fn()
        except ValueError as e:
            msgs[name] = str(e)
    return msgs


def run_grid(rank: int, payload: dict) -> dict:
    """The ``data 2 x tp 2`` step in one of 4 ranks."""
    torch.set_num_threads(1)
    grid = mesh.check_grid(2, 2)
    assert (grid.data_index, grid.model_index) == divmod(rank, 2)
    opts = ModelOptions(attn_impl="fused", tp=2, data=2, deterministic=True)
    return train_run(payload["jax"], opts, grid.data_index, 2)


def one_rank(case: dict, options: ModelOptions) -> dict:
    """``case`` on one process at the global batch (no group)."""
    return train_run(case, dataclasses.replace(options, data=1))
