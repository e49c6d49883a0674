"""What each rank computes for tests/test_torch_tp.py (no tests here).

``parallel/mesh.py::run_ranks`` runs :func:`run_all` in spawned processes,
which import the module of their target anew: so this module imports
neither JAX nor the test module, only numpy, torch and the port. Inputs
arrive as numpy arrays and results leave as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.parallel import mesh
from nans_clip_tpu_torch.parallel.tp import (rank_attention_dropout, reduce_partial_grads,
                                             tp_attention_block, tp_mlp_block)
from nans_clip_tpu_torch.training import trainer


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy().copy()


def _block(case: dict, impl: str, group) -> dict:
    """One TP sub-block forward and backward of ``sum(out * gout)``; the
    parameter gradients after the reduction rule of ``parallel/tp.py``."""
    args = [_t(a).requires_grad_() for a in case["args"]]
    x, params = args[0], args[1:]
    post_ln = case["post_ln"]
    if case["kind"] == "attn":
        out = tp_attention_block(x, *params, case["heads"], 2, 1e-5, post_ln,
                                 _t(case["key_bias"]), impl, group)
        # ln_w, ln_b, w_qkv, b_qkv, w_o are consumed by the partial; b_o is not
        consumed = params[:5]
    else:
        out = tp_mlp_block(x, *params, case["act"], 2, 1e-5, post_ln, impl, group)
        # ln_w, ln_b, w1, b1, w2; b2 is not
        consumed = params[:5]
    (out * _t(case["gout"])).sum().backward()
    if post_ln:
        consumed = consumed[2:]   # the post-LN LayerNorm runs on the reduced value
    reduce_partial_grads(consumed, group)
    return {"out": _np(out), "grads": [_np(a.grad) for a in args]}


def _fail_fast(group) -> dict:
    """The messages of the calls that must raise."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 4, 64).astype(np.float32))
    w = [torch.ones(64), torch.zeros(64), torch.zeros(192, 64), torch.zeros(192),
         torch.zeros(64, 64), torch.zeros(64)]
    msgs = {}
    for name, kw in (("tp_mismatch", dict(heads=4, tp=4)), ("heads", dict(heads=3, tp=2))):
        try:
            tp_attention_block(x, *w, kw["heads"], kw["tp"], impl="xla")
        except ValueError as e:
            msgs[name] = str(e)
    try:
        mesh.model_group(4)
    except ValueError as e:
        msgs["model_group"] = str(e)
    return msgs


def _towers(cfg, state_dict, images, texts) -> dict:
    module = build_clip(cfg)
    module.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    opts = ModelOptions(attn_impl="fused", tp=2)
    with torch.no_grad():
        return {"image": _np(module.encode_image(_t(images), opts)),
                "text": _np(module.encode_text(_t(texts).long(), opts))}


def _train_step(cfg, state_dict, images, texts, tcfg_kw) -> dict:
    module = build_clip(cfg)
    module.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    tcfg = trainer.TrainConfig(**tcfg_kw)
    state = trainer.create_train_state(module, tcfg, device="cpu")
    step = trainer.make_train_step(cfg, tcfg, ModelOptions(attn_impl="fused", tp=2,
                                                           deterministic=True))
    state, metrics = step(state, _t(images), _t(texts), None)
    named = list(state.module.named_parameters())
    return {"loss": float(metrics["loss"]),
            "grads": {n: _np(p.grad) for n, p in named},
            "params": {n: _np(p) for n, p in named}}


def dropout_run(cfg, state_dict, images, texts, tcfg_kw, seed: int, tp: int) -> dict:
    """A text tower with dropout (``deterministic=False`` and a generator
    seeded with ``seed``) at ``tp`` ranks: the text tower's sequence output
    (and, for scale, its output without dropout), then one train step (loss, every gradient, the parameters). tp 1 runs
    in one process without a group."""
    module = build_clip(cfg)
    module.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    opts = ModelOptions(attn_impl="fused", tp=tp, deterministic=False)
    ids = _t(texts).long()
    with torch.no_grad():
        seq = module.bert(ids, (ids != 0).float(), opts, torch.Generator().manual_seed(seed))
        seq_det = module.bert(ids, (ids != 0).float(), ModelOptions(attn_impl="fused", tp=tp))
    tcfg = trainer.TrainConfig(**tcfg_kw)
    state = trainer.create_train_state(module, tcfg, device="cpu")
    step = trainer.make_train_step(cfg, tcfg, opts)
    state, metrics = step(state, _t(images), ids, seed)
    named = list(state.module.named_parameters())
    return {"seq": _np(seq), "seq_det": _np(seq_det), "loss": float(metrics["loss"]),
            "grads": {n: _np(p.grad) for n, p in named},
            "params": {n: _np(p) for n, p in named}}


def attention_masks(rank: int, seed: int, batch: int, heads: int, seq: int) -> np.ndarray:
    """This rank's attention-probability keep multipliers for one draw, as
    its TP sub-block counts them: [B, heads / 2, S, S]."""
    spec = rank_attention_dropout(drop.Dropout(seed, 0.1, drop.STREAM_ATTN), rank, heads // 2)
    return drop.attention_multiplier(spec, batch, heads // 2, seq, "cpu").numpy()


def run_all(rank: int, payload: dict) -> dict:
    """Every multi-process case of tests/test_torch_tp.py in one rank."""
    torch.set_num_threads(1)
    group = mesh.model_group(2)
    assert dist.get_rank(group) == rank
    out = {"blocks": {(name, impl): _block(case, impl, group)
                      for name, case in payload["blocks"].items()
                      for impl in ("fused", "xla")},
           "fail_fast": _fail_fast(group)}
    t = payload["tiny"]
    out["towers"] = _towers(t["cfg"], t["state_dict"], t["images"], t["texts"])
    out["train"] = _train_step(t["cfg"], t["state_dict"], t["images"], t["texts"], t["tcfg"])
    out["dropout"] = {name: dropout_run(c["cfg"], c["state_dict"], c["images"], c["texts"],
                                        c["tcfg"], c["seed"], 2)
                      for name, c in payload["dropout"].items()}
    out["attention_masks"] = attention_masks(rank, 1234, 2, 4, 12)
    return out
