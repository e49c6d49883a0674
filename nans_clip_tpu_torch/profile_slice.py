"""Where the device time of ``get_similarity``, or of a train step, goes,
on one GPU.

    python3 -m nans_clip_tpu_torch.profile_slice [--batch 256] [--iters 5] [--out FILE]
    python3 -m nans_clip_tpu_torch.profile_slice --train [--batch 128] [--iters 3]
    python3 -m nans_clip_tpu_torch.profile_slice --lora [--batch 128] [--accum 4] [--iters 3]
    python3 -m nans_clip_tpu_torch.profile_slice --model ViT-H-14 --train --batch 32 --iters 2
    python3 -m nans_clip_tpu_torch.profile_slice --model RN50 [--train]
    python3 -m nans_clip_tpu_torch.profile_slice --model ViT-L-14-336 --train --batch 32 \
        --attn-impl pallas

Builds ``--model`` (a published name such as ``ViT-H-14`` or a
``Vision@Text`` struct; default ViT-B-16@RoBERTa-wwm-ext-base-chinese) at
random init (seed 0) in bf16 on ``cuda:0`` and runs ``get_similarity`` on
seeded images (at the model's resolution) and texts.
At serving batches (``--batch 1``) the towers run the whole-tower kernel,
whose device time is grouped as ``tower_kernel``. With ``--train`` the fp32
model takes train steps (``training.make_train_step``, bf16 compute, the
text tower's dropout on) on one fixed seeded batch instead; with ``--lora``
the frozen model takes LoRA steps (``training.train_lora.make_lora_step``:
rank 4, ``--batch`` pairs in ``--accum`` microbatches, dropout on).
``--attn-impl`` picks the route (``ModelOptions.attn_impl``; ``pallas``: the
flash attention #22/#23 inside plain-torch layers). It reports, all from one run:

* CUDA-event times of ``encode_image``, ``encode_text`` and
  ``get_similarity`` (with ``--train``: of a train step);
* one ``torch.profiler`` window of ``--iters`` iterations: the host-clock
  time of the window, the device kernels grouped by name (calls and ms per
  iteration, share of device time), the device busy time (the union of the
  kernels' intervals) and the idle share of the window. Training windows
  record the device and the runtime calls only, as the benchmark's train
  cell does: recording a step's thousands of host operators slows the host
  that paces it;
* the port's spans in that window (``utils/profiling.py``: ``train.step``
  and its phases, ``model.encode_*``, ``model.cast``), per iteration and
  by name: host ms, self host ms (less the direct children's), device ms
  (CUDA events at the ends: the device's wall time across the span, its
  waits for a host that paces it included), kernel ms (the device time of
  the kernels, copies and fills whose launching runtime call falls inside
  the span, its children's too: the work the span puts on the device), and
  idle ms: every idle gap of the device whose midpoint falls under a span
  that is the innermost one open there, on the profiler's clock; the idle
  under none is ``outside spans``.

``--out`` also writes the full per-kernel table to a file.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import time
from bisect import bisect_left, bisect_right
from collections import defaultdict
from typing import Optional

import torch

from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.utils import profiling

TEXTS = ["杰尼龟", "妙蛙种子", "小火龙", "皮卡丘", "西湖美景，三月天", "一只可爱的小猫在草地上玩耍"]
HAND_KERNEL = re.compile(
    r"(gemm(_fwd|_bwd)?|attention(_bwd(_dq|_dkv)?)?|layernorm(_bwd)?(_wide)?|colsum|tower"
    r"|flash_(fwd|bwd_dq|bwd_dkv))_kernel"
    r"(<[^>]*>)?")
# The library's kernels (the plain-torch glue), by what they do; the first
# pattern that matches names the group.
LIBRARY_GROUPS = (
    # a ResNet image tower's (--model RN50): cuDNN's kernels and the native ones
    ("batch norms", re.compile(r"batch_norm|bn_fw|bn_bw", re.I)),
    ("pools", re.compile(r"pool", re.I)),
    ("cuDNN convolutions", re.compile(r"fprop|dgrad|wgrad|convolve|conv2d|cudnn|nhwc|nchw", re.I)),
    ("cuBLAS products", re.compile(r"nvjet|gemm|cutlass|xmma|cublas", re.I)),
    ("int64 elementwise", re.compile(r"\blong\b")),   # the twins' Philox masks
    ("reductions", re.compile(r"reduce_kernel")),
    ("AdamW _foreach", re.compile(r"multi_tensor_apply")),
    ("copies and casts", re.compile(r"copy|Memcpy|CatArray", re.I)),
)


def kernel_group(name: str) -> str:
    """The group a device kernel's time is reported under: a hand kernel
    keeps its template arguments (gemm_fwd_kernel<kExt, ...>: a forward
    product, kExt the training epilogue; gemm_bwd_kernel<Dgrad<...>>: the
    input gradient, <Wgrad>: the weight gradient); a library kernel falls in
    the first of ``LIBRARY_GROUPS`` that matches, else "plain torch, other"."""
    hand = HAND_KERNEL.search(name)
    if hand:
        return hand.group(0)
    return next((g for g, pat in LIBRARY_GROUPS if pat.search(name)), "plain torch, other")


def _event_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
OUTSIDE = "outside spans"


def device_ops(events) -> list:
    """(name, start ns, end ns, correlation id) of every kernel, copy and
    fill among the profiler's events (``kineto_results.events()``), on its
    clock: a host span mirrored on the device's timeline is none."""
    out = []
    for e in events:
        if e.device_type().name != "CUDA":
            continue
        if hasattr(e, "activity_type"):
            if e.activity_type() not in DEVICE_KINDS:
                continue
        elif e.is_user_annotation():
            continue
        out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
    return out


def launch_starts(events) -> dict:
    """The host start (ns) of every CUDA runtime or driver call among the
    profiler's events, by correlation id: a launch's id is its device
    operation's."""
    out = {}
    for e in events:
        if e.device_type().name == "CUDA":
            continue
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        if kind in ("cuda_runtime", "cuda_driver") or (kind is None and RUNTIME.match(e.name())):
            out[e.correlation_id()] = e.start_ns()
    return out


def launched_by_span(device, starts, records) -> dict:
    """The device time (ns) of the operations of ``device`` (as
    :func:`device_ops` gives them) summed by the name of each closed span
    whose host interval holds the call that launched them (``starts``, as
    :func:`launch_starts` gives them): a span counts its children's
    launches too, and none of the device's waits between them."""
    launched = sorted((starts[c], b - a) for _, a, b, c in device if c in starts)
    times = [t for t, _ in launched]
    cum = list(itertools.accumulate((d for _, d in launched), initial=0))
    out = defaultdict(int)
    for r in records:
        if r.end_ns is not None:
            out[r.name] += cum[bisect_right(times, r.end_ns)] - cum[bisect_left(times, r.start_ns)]
    return dict(out)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(intervals, lo: int, hi: int) -> list:
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    busy = _union((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def idle_by_span(gaps, records) -> dict:
    """Each gap's length (ns) summed by the name of the innermost closed
    span open at the gap's midpoint (the latest to start among those
    holding it), or :data:`OUTSIDE`."""
    closed = [(r.start_ns, i, r.end_ns, r.name) for i, r in enumerate(records)
              if r.end_ns is not None]
    out = defaultdict(int)
    for a, b in gaps:
        mid = (a + b) // 2
        inner = max((c for c in closed if c[0] <= mid <= c[2]), default=None)
        out[inner[3] if inner else OUTSIDE] += b - a
    return dict(out)


MODEL = "ViT-B-16@RoBERTa-wwm-ext-base-chinese"


def _config(nct, model: str):
    """(struct, config) of a published name or a ``Vision@Text`` struct."""
    from nans_clip_tpu_torch.configs import MODEL_INFO, config_for_name

    if model in MODEL_INFO:
        vision, text, _ = MODEL_INFO[model]
        return f"{vision}@{text}", config_for_name(model)[0]
    return model, nct.load_config(model)


def _train_step(nct, dev, images, b: int, model: str, attn_impl: str):
    """One train step as a closure: the fp32 model at random init (seed 0),
    AdamW, bf16 compute with the text tower's dropout (seeds from a fixed
    generator per step), on one fixed batch of ``b`` pairs."""
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.training import TrainConfig, create_train_state, make_train_step

    cfg = _config(nct, model)[1]
    tcfg = TrainConfig(lr=1e-3, warmup=2, max_steps=100)
    holder = [create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)), tcfg,
                                 device=dev)]
    train = make_train_step(cfg, tcfg, nct.ModelOptions(compute_dtype="bfloat16",
                                                       deterministic=False, attn_impl=attn_impl))
    ids = torch.from_numpy(nct.tokenize([f"{TEXTS[i % len(TEXTS)]}{i}" for i in range(b)]))
    ids = ids.to(dev)

    def step():
        holder[0], metrics = train(holder[0], images, ids, holder[0].step)
        return metrics
    return step


def _lora_step(nct, dev, images, b: int, accum: int, model: str, attn_impl: str):
    """One LoRA step as a closure: the frozen model at random init (seed 0),
    rank-4 adapters (B leaves zero in the warm-up steps), AdamW over the adapters, bf16
    compute with the text tower's dropout, ``b`` pairs in ``accum``
    microbatches."""
    from nans_clip_tpu_torch.models import lora
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.training import train_lora

    cfg = _config(nct, model)[1]
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0)).to(dev)
    adapters = lora.init_lora(torch.Generator().manual_seed(1), module, 4, device=dev)
    holder = [train_lora.create_lora_state(module, adapters, 1e-3, 0.01, device=dev)]
    train, _ = train_lora.make_lora_step(
        cfg, nct.ModelOptions(compute_dtype="bfloat16", attn_impl=attn_impl), 16.0, 0.05, accum)
    ids = torch.from_numpy(nct.tokenize([f"{TEXTS[i % len(TEXTS)]}{i}" for i in range(b)]))
    ids = ids.to(dev)

    def step():
        holder[0], loss, _ = train(holder[0], images, ids, holder[0].step)
        return loss
    return step


def span_table(records, gaps, n: int, launched: Optional[dict] = None) -> dict:
    """The spans' part of the result, per iteration of ``n``: ``spans`` by
    name (calls, host, self, device, kernel and idle ms, then
    :data:`OUTSIDE`'s idle), the idle ms in all, and the share of it under a
    named span. ``launched``: :func:`launched_by_span`'s, None for no
    kernel ms."""
    idle = idle_by_span(gaps, records)
    table = {name: {"calls": t["calls"] / n, "host_ms": t["host_ms"] / n,
                    "self_ms": t["self_ms"] / n,
                    "device_ms": None if t["device_ms"] is None else t["device_ms"] / n,
                    "kernel_ms": None if launched is None else launched.get(name, 0) / 1e6 / n,
                    "idle_ms": idle.get(name, 0) / 1e6 / n}
             for name, t in profiling.span_totals(records).items()}
    table[OUTSIDE] = {"calls": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": None,
                      "kernel_ms": None, "idle_ms": idle.get(OUTSIDE, 0) / 1e6 / n}
    total = sum(idle.values())
    return {"spans": table, "idle_ms": total / 1e6 / n,
            "idle_named_share": 1.0 - idle.get(OUTSIDE, 0) / total if total else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="default 256, or 128 with --train or --lora")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--train", action="store_true", help="profile train steps")
    ap.add_argument("--lora", action="store_true", help="profile LoRA steps")
    ap.add_argument("--accum", type=int, default=4, help="microbatches of a LoRA step")
    ap.add_argument("--model", default=MODEL,
                    help="a published name (ViT-H-14, ...) or a Vision@Text struct")
    ap.add_argument("--attn-impl", default="auto", choices=gates.IMPLS,
                    help="the route, as ModelOptions.attn_impl")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    import nans_clip_tpu_torch as nct

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, n = torch.device("cuda", 0), args.iters
    training = args.train or args.lora
    b = args.batch or (128 if training else 256)
    struct, cfg = _config(nct, args.model)
    gen = torch.Generator().manual_seed(1)
    r = cfg.vision.image_resolution
    images = torch.randn(b, r, r, 3, generator=gen).to(dev)
    if args.lora:
        step = _lora_step(nct, dev, images, b, args.accum, args.model, args.attn_impl)
    elif args.train:
        step = _train_step(nct, dev, images, b, args.model, args.attn_impl)
    else:
        model = nct.create_model(struct, input_resolution=r, seed=0, device=dev,
                                 options=nct.ModelOptions(compute_dtype="bfloat16",
                                                          attn_impl=args.attn_impl))
        ids = torch.from_numpy(nct.tokenize((TEXTS * b)[:b])).to(dev)
        step = lambda: model.get_similarity(images, ids)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if training:
        ev = {"lora_step" if args.lora else "train_step": _event_ms(step, n)}
    else:
        ev = {"encode_image": _event_ms(lambda: model.encode_image(images), n),
              "encode_text": _event_ms(lambda: model.encode_text(ids), n),
              "get_similarity": _event_ms(step, n)}

    activities = [ProfilerActivity.CUDA] + ([] if training else [ProfilerActivity.CPU])
    profiling.clear()
    profiling.reserve()
    with profile(activities=activities) as prof:
        lo, t0 = time.time_ns(), time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        hi = time.time_ns()
    records = profiling.spans()
    events = prof.profiler.kineto_results.events()
    device = device_ops(events)
    if not device:
        raise SystemExit("profile_slice: the profiler recorded no device activity")
    intervals = [(start, end) for _, start, end, _ in device]
    by_name = defaultdict(lambda: [0, 0])
    for name, start, end, _ in device:
        by_name[name][0] += 1
        by_name[name][1] += end - start
    sum_ms = sum(ns for _, ns in by_name.values()) / 1e6 / n
    busy_ms = sum(end - start for start, end in _union(intervals)) / 1e6 / n
    groups = defaultdict(lambda: [0, 0.0])
    lines = []
    for name, (calls, ns) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        ms = ns / 1e6 / n
        lines.append(f"{ms:10.4f} ms {100 * ms / sum_ms:6.2f}% {calls // n:5d} calls  {name}")
        group = kernel_group(name)
        groups[group][0] += calls // n
        groups[group][1] += ms
    result = {
        "device": torch.cuda.get_device_name(0), "model": struct, "batch": b, "iters": n,
        "train": args.train, "attn_impl": args.attn_impl,
        "lora": args.lora, "accum": args.accum if args.lora else 1,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "cuda_event_ms": ev, "profiled_host_ms": host_ms, "kernel_sum_ms": sum_ms,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / host_ms,
        "groups": {k: {"calls": c, "ms": ms, "share": ms / sum_ms}
                   for k, (c, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1])}}
    launched = launched_by_span(device, launch_starts(events), records)
    result.update(span_table(records, idle_gaps(intervals, lo, hi), n, launched))
    for line in lines[:25]:
        print(line)
    print(f"{'span':22s} {'calls':>5s} {'host ms':>9s} {'self ms':>9s} {'device ms':>9s} "
          f"{'kernel ms':>9s} {'idle ms':>9s}  (per iteration)")
    for name, t in result["spans"].items():
        dev_ms, k_ms = ("-" if v is None else f"{v:9.3f}" for v in (t["device_ms"], t["kernel_ms"]))
        print(f"{name:22s} {t['calls']:5g} {t['host_ms']:9.3f} {t['self_ms']:9.3f} "
              f"{dev_ms:>9s} {k_ms:>9s} {t['idle_ms']:9.3f}")
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n" + json.dumps(result, indent=1) + "\n")
    return result


if __name__ == "__main__":
    main()
