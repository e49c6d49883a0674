"""Offline gallery embedding: one caller in a closed loop, work
dispatched ahead, through ``CLIPModel.encode_image`` and ``encode_text``.

The mix's parameters: ``batch`` pairs a call, ``pool`` distinct batches
made at set-up from the seed (preprocessed images as normal fields in the
served dtype; texts of ``text_len`` tokens between [CLS] and [SEP], ids
drawn from the vocabulary past its special tokens, zero-padded to the
configuration's context), ``trace_iters`` calls in the traced
sub-window. Text lengths are one fixed heavy-tailed multiset that each
batch permutes, so every seed does the same work.

The window enqueues batch after batch without waiting, each batch's
features copied into a gallery slot on the device, until ``--seconds``
have passed on the host clock, then waits for the device once:
``embed_pairs_per_s`` is every pair enqueued over that whole time. Once
the window has closed the last ``pool`` batches' features (every slot of
the gallery) are compared with the reference's on the same inputs.
"""

from __future__ import annotations

import time

import torch

from perfbench import counts, harness, trace
from perfbench.reference import model as ref_model

SPECIAL_IDS = 106   # [PAD] .. [MASK] and the first unused ids of the vocabulary


def make_inputs(ctx: harness.Context):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    b, pool, r, s = tr["batch"], tr["pool"], cfg["image_resolution"], cfg["context_length"]
    gen = torch.Generator(dev).manual_seed(harness.subseed(ctx.seed, harness.TAG_INPUTS))
    dtype = getattr(torch, cfg["dtype"])
    images = torch.randn(pool, b, r, r, 3, generator=gen, device=dev).to(dtype)
    lengths = harness.fixed_multiset(tr["text_len"], b)
    order = torch.Generator().manual_seed(harness.subseed(ctx.seed, harness.TAG_ORDER))
    ids = torch.zeros(pool, b, s, dtype=torch.long, device=dev)
    body = torch.randint(SPECIAL_IDS, cfg["vocab_size"], (pool, b, s), generator=gen, device=dev)
    pos = torch.arange(s, device=dev)
    for k in range(pool):
        n = torch.as_tensor(lengths[torch.randperm(b, generator=order).numpy()], device=dev)
        ids[k] = torch.where(pos[None] <= n[:, None], body[k], 0)
        ids[k, :, 0] = 101
        ids[k].scatter_(1, (n + 1)[:, None], 102)
    return images, ids


def run(ctx: harness.Context) -> harness.Outcome:
    from nans_clip_tpu_torch.api import CLIPModel
    from nans_clip_tpu_torch.ops import attention as attn_ops

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    sync = harness.synchronizer(dev)
    b, pool, e = tr["batch"], tr["pool"], cfg["embed_dim"]
    phases = harness.Phases(ctx.t_start)
    phases.mark("imports")
    model = CLIPModel(harness.program_config(cfg), harness.program_module(cfg, ctx.seed, dev, phases),
                      harness.compute_options(cfg))
    phases.mark("model")
    images, ids = make_inputs(ctx)
    phases.mark("inputs")
    gallery = torch.empty(2, pool, b, e, dtype=getattr(torch, cfg["dtype"]), device=dev)

    def call(i: int) -> None:
        k = i % pool
        with torch.profiler.record_function("bench.encode_image"):
            gallery[0, k].copy_(model.encode_image(images[k]))
        with torch.profiler.record_function("bench.encode_text"):
            gallery[1, k].copy_(model.encode_text(ids[k]))

    for i in range(pool):       # warm-up: the one shape of each tower
        call(i)
    sync()
    phases.mark("warm")
    harness.steady()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    n = 0
    while True:
        call(n)
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = harness.Outcome(attempted=n * b, failed=0,
                          metrics={"embed_pairs_per_s": n * b / window_s, "setup_s": setup_s},
                          checks={}, memory_peak_bytes=int(peak))
    out.notes.append(phases.line())
    out.observations = {"window_s": window_s, "flops": n * b * counts.pair_flops(cfg)}
    if ctx.trace:
        iters = tr["trace_iters"]
        for _ in range(3):      # shorten the sub-window until the launch check agrees
            before = attn_ops.attention.launches
            t = trace.profiled(lambda: [call(n + j) for j in range(iters)], sync)
            pairs = {"attention_fwd_kernel": (attn_ops.attention.launches - before,
                                              t.count("attention_fwd_kernel"))}
            line = t.check_line(pairs)
            out.notes.append(f"trace_check {line}")
            if line["agree"]:
                out.trace = t
                out.observations["bound_s"] = iters * counts.ops_seconds(
                    counts.image_ops(cfg, b) + counts.text_ops(cfg, b))
                break
            iters = max(1, iters // 2)
        n += iters
    # the gallery's slots hold the last `pool` batches: slot k, inputs k
    got = gallery.float()
    del model, gallery
    harness.free(dev)
    w = harness.reference_weights(cfg, ctx.seed, dev, cfg["dtype"])
    gaps = {"image": 0.0, "text": 0.0}
    for k in range(pool):
        for j, (tower, x) in enumerate((("image", images[k]), ("text", ids[k]))):
            ref = ref_model.features(w, cfg, tower, x.float() if tower == "image" else x)
            gaps[tower] = max(gaps[tower], harness.max_gap(ref_model.normalize(got[j, k]), ref))
    out.checks = {f"{t}_gap": (v, ctx.limits[f"{t}_gap"]) for t, v in gaps.items()}
    return out


def control(ctx: harness.Context, prec: ref_model.Precision) -> dict:
    """The numbers this cell compares, with the reference at ``prec`` in the
    program's place (the same inputs, every gallery slot)."""
    images, ids = make_inputs(ctx)
    w = harness.reference_weights(ctx.config, ctx.seed, ctx.device, ctx.config["dtype"])
    gaps = {"image_gap": 0.0, "text_gap": 0.0}
    for k in range(ctx.traffic["pool"]):
        for tower, x in (("image", images[k].float()), ("text", ids[k])):
            got = ref_model.features(w, ctx.config, tower, x, prec)
            ref = ref_model.features(w, ctx.config, tower, x)
            gaps[f"{tower}_gap"] = max(gaps[f"{tower}_gap"], harness.max_gap(got, ref))
    return gaps
