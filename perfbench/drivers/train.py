"""Fine-tuning: a closed loop of the port's train step
(``training/trainer.py::make_train_step`` over ``create_train_state``:
bf16 compute over fp32 masters, AdamW, the text tower's dropout drawn from
each step's seed), one caller, no loader.

The mix's parameters: ``batch`` pairs a step, ``pool`` distinct batches
made at set-up from the seed (as the embedding mix makes them: every row
differs), the recipe (``lr``, ``wd``, ``beta1``, ``beta2``, ``eps``,
``warmup``, ``total_steps``), ``checked_steps`` the steps set-up runs and
the reference follows, ``warmup_steps`` more before the window,
``trace_iters`` steps in the traced sub-window.

Set-up builds one train state, drives it through its first
``checked_steps`` steps with the window's own call and feed (batch i of
the pool, step seed i), reading each step's loss, each leaf's first
gradient from the optimizer's state after step 1 (``exp_avg / (1 -
beta1)``) and each leaf's change after the last. The same state then runs
the window: ``train_pairs_per_s`` is every pair of the steps it ran over
the window's seconds, ``train_peak_gib`` the allocator's peak in it. Once
the window has closed and the state is freed, the reference trains the
seed's weights over the same batches with the same dropout and is
compared leaf by leaf (:func:`compare`).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from perfbench import counts, harness, trace
from perfbench.drivers.embed import make_inputs
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train

SEED_MAX = 2 ** 31 - 1


def step_seed(ctx: harness.Context, i: int) -> int:
    return (harness.subseed(ctx.seed, harness.TAG_STEPS) + i) & 0x7FFF_FFFF_FFFF_FFFF


def text_dropout(cfg: dict, seed: int) -> ref_model.TextDropout:
    """The dropout seeds of a step given ``seed`` (an int generator
    argument of the step): the step draws its text dropout seed from a
    CPU generator seeded with it, the text tower the embedding's seed and
    each layer's two from one seeded with that."""
    step_gen = torch.Generator().manual_seed(seed)
    text_seed = int(torch.randint(0, SEED_MAX, (), generator=step_gen))
    gen = torch.Generator().manual_seed(text_seed)
    embed = int(torch.randint(0, SEED_MAX, (), generator=gen))
    layers = [torch.randint(0, SEED_MAX, (2,), generator=gen).tolist()
              for _ in range(cfg["text_num_hidden_layers"])]
    return ref_model.TextDropout(embed, layers, cfg["text_hidden_dropout_prob"],
                                 cfg["text_attention_probs_dropout_prob"])


def hyper(tr: dict) -> dict:
    return {k: tr[k] for k in ("lr", "wd", "beta1", "beta2", "eps", "warmup", "total_steps")}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    """The largest gap between the program's and the reference's norm of a
    leaf, over that leaf's reference norm or the median leaf's, whichever
    is larger."""
    med = statistics.median(ref[n] for n in names)
    return worst(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def worst(gaps) -> float:
    """The largest gap; infinite if any is NaN (``max`` would pass it by)."""
    gaps = list(gaps)
    return float("inf") if any(g != g for g in gaps) else max(gaps)


def moving_changes(prog: dict, ref: dict) -> tuple:
    """Each leaf's change norm on both sides over the elements whose
    reference first gradient is at least a thousandth of the median leaf's
    root-mean-square gradient: an element whose gradient is nought to
    rounding (the key projection's bias under softmax) moves under Adam by
    round-off alone, a step of the learning rate's size either way. Leaves
    with no such element are left out."""
    grads = ref["grads"]
    med = statistics.median(float(g.float().square().mean().sqrt()) for g in grads.values())
    mine, theirs = {}, {}
    for n, g in grads.items():
        keep = g.abs() >= 1e-3 * med
        if bool(keep.any()):
            mine[n] = float(torch.linalg.vector_norm(prog["change_t"][n].to(g.device)[keep]))
            theirs[n] = float(torch.linalg.vector_norm(ref["change_t"][n][keep]))
    return mine, theirs


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """The three numbers: the largest loss gap over the checked steps, the
    first gradient's and the change's largest leaf gap (the change over
    :func:`moving_changes`' elements). Fills ``prog["change"]`` and
    ``ref["change"]`` with those norms."""
    loss = worst(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    prog["change"], ref["change"] = moving_changes(prog, ref)
    return {"loss_gap": (loss, limits["loss_gap"]),
            "grad_gap": (leaf_gap(prog["grad"], ref["grad"], sorted(ref["grad"])),
                         limits["grad_gap"]),
            "update_gap": (leaf_gap(prog["change"], ref["change"], sorted(ref["change"])),
                           limits["update_gap"])}


def worst_leaves(prog: dict, ref: dict, k: int = 3) -> dict:
    """The ``k`` leaves with the largest gap of each compared norm, with the
    program's and the reference's norms and the median leaf's."""
    out = {}
    for key in ("grad", "change"):
        med = statistics.median(ref[key].values())
        gap = lambda n: abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med, 1e-30)
        out[key] = [(n, prog[key][n], ref[key][n], med)
                    for n in sorted(ref[key], key=gap, reverse=True)[:k]]
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names]).tolist()
    return dict(zip(names, vals))


def changes(params: Dict[str, torch.Tensor], cfg: dict, seed: int,
            to_host: bool = False) -> Dict[str, torch.Tensor]:
    """Each leaf's change from the seed's weights (on the host with
    ``to_host``: kept there through the window)."""
    from perfbench.reference import weights

    start = weights.make(cfg, seed, next(iter(params.values())).device)
    return {n: (params[n].detach() - start[n]).to("cpu" if to_host else start[n].device)
            for n in params}


def reference_run(ctx: harness.Context, images, ids, prec=ref_model.FP32,
                  micro: int = 0) -> dict:
    """The reference's losses, first gradients and change over the checked
    steps, from the seed's weights (``micro`` rows a pass, 0 all)."""
    cfg, tr = ctx.config, ctx.traffic
    k = tr["checked_steps"]
    w = harness.reference_weights(cfg, ctx.seed, ctx.device)
    batches = [(images[i % len(images)].float(), ids[i % len(ids)]) for i in range(k)]
    drops = [text_dropout(cfg, step_seed(ctx, i)) for i in range(k)]
    res = ref_train.run_steps(w, cfg, batches, drops, hyper(tr), prec, micro)
    return {"losses": res["losses"], "grad": norms(res["first_grads"]),
            "grads": res["first_grads"], "change_t": changes(w, cfg, ctx.seed)}


def run(ctx: harness.Context) -> harness.Outcome:
    from nans_clip_tpu_torch.training.trainer import (TrainConfig, create_train_state,
                                                      make_train_step)

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    sync = harness.synchronizer(dev)
    b, pool = tr["batch"], tr["pool"]
    hp = hyper(tr)
    phases = harness.Phases(ctx.t_start)
    phases.mark("imports")
    tcfg = TrainConfig(lr=hp["lr"], wd=hp["wd"], beta1=hp["beta1"], beta2=hp["beta2"],
                       eps=hp["eps"], warmup=hp["warmup"], max_steps=hp["total_steps"])
    state = create_train_state(harness.program_module(cfg, ctx.seed, dev, phases), tcfg, dev)
    step = make_train_step(harness.program_config(cfg), tcfg,
                           harness.compute_options(cfg, deterministic=False))
    phases.mark("model")
    images, ids = make_inputs(ctx)
    phases.mark("inputs")
    names = {p: n for n, p in state.module.named_parameters()}
    losses: List[float] = []

    def call(i: int):
        k = i % pool
        with torch.profiler.record_function("bench.train_step"):
            return step(state, images[k], ids[k], step_seed(ctx, i))[1]["loss"]

    prog = {}
    for i in range(tr["checked_steps"]):
        losses.append(float(call(i)))
        if i == 0:
            b1 = state.optimizer.defaults["betas"][0]
            opt_state = state.optimizer.state  # a leaf it never updated read as no gradient
            prog["grad"] = norms({n: opt_state[p]["exp_avg"] / (1 - b1) if "exp_avg" in
                                  opt_state.get(p, {}) else torch.zeros(()) for p, n in names.items()})
    prog["losses"] = losses
    prog["change_t"] = changes(dict(state.module.named_parameters()), cfg, ctx.seed, True)
    phases.mark("checked_steps")
    n = tr["checked_steps"]
    for _ in range(tr["warmup_steps"]):
        call(n)
        n += 1
    sync()
    phases.mark("warm")
    harness.steady()
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    marks: List = []
    hooks = [state.optimizer.register_step_pre_hook(lambda *a: marks.append(_event())),
             state.optimizer.register_step_post_hook(lambda *a: marks.append(_event()))] \
        if ctx.trace and dev.type == "cuda" else []
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    first = n
    while True:
        call(n)
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps = n - first
    out = harness.Outcome(attempted=steps, failed=0,
                          metrics={"train_pairs_per_s": steps * b / window_s,
                                   "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s},
                          checks={}, memory_peak_bytes=int(max(peak, setup_peak)))
    out.notes.append(phases.line())
    out.observations = {"window_s": window_s, "flops": 3.0 * steps * b * counts.pair_flops(cfg)}
    if marks:
        out.observations["optimizer_ms"] = statistics.mean(
            a.elapsed_time(b) for a, b in zip(marks[0::2], marks[1::2]))
    if ctx.trace:
        out.trace = traced(ctx, out, call, n, sync)
    del state, step
    harness.free(dev)
    ref = reference_run(ctx, images, ids)
    out.checks = compare(prog, ref, ctx.limits)
    out.notes.append(f"losses program {prog['losses']} reference {ref['losses']}")
    out.notes.append(f"worst_leaves {worst_leaves(prog, ref)}")
    return out


def traced(ctx, out, call, n: int, sync):
    """The traced sub-window: ``trace_iters`` steps under the profiler (the
    device and the runtime calls only: a step launches thousands of
    kernels), shortened until the launch check agrees."""
    from nans_clip_tpu_torch.ops import attention

    iters = ctx.traffic["trace_iters"]
    for _ in range(3):
        fwd, bwd = attention.attention.launches, attention.attention_bwd.launches
        bwd_long = attention.attention_bwd.launches_long
        t = trace.profiled(lambda: [call(n + j) for j in range(iters)], sync,
                           host_ops=ctx.traffic["trace_host_ops"])
        n += iters
        pairs = {"attention_fwd_kernel": (attention.attention.launches - fwd,
                                          t.count("attention_fwd_kernel")),
                 "attention_bwd_kernel": (attention.attention_bwd.launches - bwd
                                          - (attention.attention_bwd.launches_long - bwd_long),
                                          t.count("attention_bwd_kernel"))}
        line = t.check_line(pairs)
        out.notes.append(f"trace_check {line}")
        if line["agree"]:
            out.observations["bound_s"] = iters * counts.ops_seconds(
                counts.train_step_ops(ctx.config, ctx.traffic["batch"]))
            return t
        iters = max(1, iters // 2)
    return None


def _event():
    if not torch.cuda.is_available():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def control(ctx: harness.Context, prec: ref_model.Precision, fault: str = None,
            micro: int = 0) -> dict:
    """The numbers this cell compares, with the reference's steps at
    ``prec`` in the program's place; ``fault`` "half_batch": at fp32 on
    the first half of each batch's rows (the loss a mean over the rest)."""
    images, ids = make_inputs(ctx)
    if fault == "half_batch":
        h = ctx.traffic["batch"] // 2
        got = reference_run(ctx, images[:, :h], ids[:, :h], micro=micro)
    elif fault is None:
        got = reference_run(ctx, images, ids, prec, micro)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    harness.free(ctx.device)
    ref = reference_run(ctx, images, ids, micro=micro)
    return {k: v for k, (v, _) in compare(got, ref, ctx.limits).items()}
