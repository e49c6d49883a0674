"""Data-parallel fine-tuning: the port's train step under ``ModelOptions(
data=n)`` (``training/trainer.py``: each rank its rows of the global batch,
the global-batch InfoNCE over gathered features, the gradients averaged
across ranks by ``parallel/fsdp.py::all_reduce_mean``), one process a
card, NCCL between cards (gloo on the CPU).

The mix's parameters: ``data`` ranks, ``batch`` global pairs a step (each
rank ``batch / data``), ``pool`` global batches made by every rank from
the seed (each keeps its rows, ``parallel/distributed.py::rank_rows``),
the recipe, ``checked_steps``, ``warmup_steps``, ``probe_steps`` (timed to
size the window), ``trace_iters``, ``trace_host_ops``.

The ranks are spawned by ``parallel/mesh.py::run_ranks`` with a
rendezvous file in a new directory under ``TMPDIR``. Each builds the same
train state from the seed's weights and runs the checked steps, the
warm-up and the probe; the slowest rank's probe sets the window's step
count (about ``--seconds`` of steps, the same on every rank, since each
step is collective). ``train_pairs_per_s`` is the global pairs of those
steps over the time from a barrier before the first to a barrier after
the last, on rank 0's clock; ``train_peak_gib`` the fullest rank's
allocator peak in the window. Once the ranks have exited, the reference
trains the seed's weights on the global batches, as one process, and is
compared as the one-card cell compares (rank 0's state).
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from perfbench import counts, harness, trace
from perfbench.drivers import train as one
from perfbench.drivers.embed import make_inputs


def _rank(rank: int, spec: dict) -> dict:
    import torch.distributed as dist

    from nans_clip_tpu_torch.parallel.distributed import rank_rows
    from nans_clip_tpu_torch.training.trainer import (TrainConfig, create_train_state,
                                                      make_train_step)

    cfg, tr, data = spec["config"], spec["traffic"], spec["traffic"]["data"]
    dev = torch.device("cuda", rank) if spec["cuda"] else torch.device("cpu")
    if spec["cuda"]:
        torch.cuda.set_device(dev)
    sync = harness.synchronizer(dev)
    ctx = harness.Context(cell={}, config=cfg, traffic=tr, limits={}, seed=spec["seed"],
                          seconds=spec["seconds"], trace=spec["trace"], device=dev,
                          t_start=spec["t_start"])
    phases = harness.Phases(ctx.t_start)
    phases.mark("spawned")
    hp = one.hyper(tr)
    tcfg = TrainConfig(lr=hp["lr"], wd=hp["wd"], beta1=hp["beta1"], beta2=hp["beta2"],
                       eps=hp["eps"], warmup=hp["warmup"], max_steps=hp["total_steps"])
    state = create_train_state(harness.program_module(cfg, ctx.seed, dev, phases), tcfg, dev)
    step = make_train_step(harness.program_config(cfg), tcfg,
                           harness.compute_options(cfg, deterministic=False, data=data))
    images, ids = make_inputs(ctx)          # every rank makes the global pool
    images = torch.stack([rank_rows(images[k], rank, data) for k in range(tr["pool"])])
    ids = torch.stack([rank_rows(ids[k], rank, data) for k in range(tr["pool"])])
    phases.mark("inputs")
    names = {p: n for n, p in state.module.named_parameters()}

    def call(i: int):
        k = i % tr["pool"]
        with torch.profiler.record_function("bench.train_step"):
            return step(state, images[k], ids[k], one.step_seed(ctx, i))[1]["loss"]

    out = {"losses": []}
    for i in range(tr["checked_steps"]):
        out["losses"].append(float(call(i)))
        if i == 0 and rank == 0:
            b1 = state.optimizer.defaults["betas"][0]
            st = state.optimizer.state
            out["grad"] = one.norms({n: st[p]["exp_avg"] / (1 - b1) if "exp_avg" in
                                     st.get(p, {}) else torch.zeros(()) for p, n in names.items()})
    if rank == 0:   # as arrays: a tensor would travel as a handle that dies with the rank
        out["change_t"] = {k: v.numpy() for k, v in one.changes(
            dict(state.module.named_parameters()), cfg, ctx.seed, True).items()}
    n = tr["checked_steps"]
    for _ in range(tr["warmup_steps"]):
        call(n)
        n += 1
    sync()
    t = time.perf_counter()
    for _ in range(tr["probe_steps"]):
        call(n)
        n += 1
    sync()
    step_s = torch.tensor([(time.perf_counter() - t) / tr["probe_steps"]], dtype=torch.float64,
                          device=dev)
    dist.all_reduce(step_s, op=dist.ReduceOp.MAX)
    steps = max(1, int(round(ctx.seconds / float(step_s))))
    phases.mark("warm")
    harness.steady()
    if spec["cuda"]:
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        call(n)
        n += 1
    sync()
    dist.barrier()
    window_s = time.perf_counter() - t0
    out.update(steps=steps, window_s=window_s, setup_s=t0 - ctx.t_start, phases=phases.line(),
               peak=torch.cuda.max_memory_allocated(dev) if spec["cuda"] else 0)
    if ctx.trace:
        iters = tr["trace_iters"]
        if rank == 0:
            from nans_clip_tpu_torch.ops import attention

            fwd = attention.attention.launches
            tr0 = trace.profiled(lambda: [call(n + j) for j in range(iters)], sync,
                                 host_ops=tr["trace_host_ops"])
            out["trace"] = tr0
            out["check"] = tr0.check_line({"attention_fwd_kernel": (
                attention.attention.launches - fwd, tr0.count("attention_fwd_kernel"))})
            nccl = sum(s for name, (_, s) in tr0.kernels.items() if "nccl" in name.lower())
            out["comm_ms"] = 1e3 * nccl / iters
        else:
            for j in range(iters):
                call(n + j)
            sync()
        out["trace_iters"] = iters
    dist.barrier()
    return out


RANK_MAIN = _rank      # the function each spawned rank runs


def run(ctx: harness.Context) -> harness.Outcome:
    from nans_clip_tpu_torch.parallel.mesh import run_ranks

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    data, b = tr["data"], tr["batch"]
    cuda = dev.type == "cuda"
    spec = {"config": cfg, "traffic": tr, "seed": ctx.seed, "seconds": ctx.seconds,
            "trace": ctx.trace, "t_start": ctx.t_start, "cuda": cuda}
    if cuda:    # one build before the ranks start, not one a rank
        from nans_clip_tpu_torch.ops import _build

        _build.build()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        ranks = run_ranks(RANK_MAIN, data, "nccl" if cuda else "gloo",
                          os.path.join(tmp, "rendezvous"), (spec,), timeout_s=330.0)
    r0 = ranks[0]
    steps, window_s = r0["steps"], r0["window_s"]
    peak = max(r["peak"] for r in ranks)
    out = harness.Outcome(attempted=steps, failed=0,
                          metrics={"train_pairs_per_s": steps * b / window_s,
                                   "train_peak_gib": peak / 2 ** 30, "setup_s": r0["setup_s"]},
                          checks={}, memory_peak_bytes=int(peak))
    out.notes.append(r0["phases"])
    out.observations = {"window_s": window_s,
                        "flops": 3.0 * steps * b * counts.pair_flops(cfg), "chips": data}
    if ctx.trace and "trace" in r0:
        out.notes.append(f"trace_check {r0['check']}")
        if r0["check"]["agree"]:
            out.trace = r0["trace"]
            out.observations["bound_s"] = r0["trace_iters"] * counts.ops_seconds(
                counts.train_step_ops(cfg, b // data))
            out.observations["comm_ms"] = r0["comm_ms"]
    if any(r["losses"] != r0["losses"] for r in ranks):
        out.notes.append(f"ranks disagree on the loss: {[r['losses'] for r in ranks]}")
        out.failed = 1
    prog = {"losses": r0["losses"], "grad": r0["grad"],
            "change_t": {k: torch.from_numpy(v) for k, v in r0["change_t"].items()}}
    del ranks, r0
    harness.free(dev)
    images, ids = make_inputs(ctx)
    ref = one.reference_run(ctx, images, ids, micro=b // data)
    out.checks = one.compare(prog, ref, ctx.limits)
    out.notes.append(f"losses program {prog['losses']} reference {ref['losses']}")
    out.notes.append(f"worst_leaves {one.worst_leaves(prog, ref)}")
    return out


def control(ctx: harness.Context, prec, fault: str = None) -> dict:
    """As the one-card cell's control, over the global batch."""
    return one.control(ctx, prec, fault, micro=ctx.traffic["batch"] // ctx.traffic["data"])

