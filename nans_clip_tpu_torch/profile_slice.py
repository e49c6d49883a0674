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
  kernels' intervals) and the idle share of the window.

``--out`` also writes the full per-kernel table to a file.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from collections import defaultdict

import torch

from nans_clip_tpu_torch.ops import gates

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


def _union_us(intervals) -> float:
    busy, last = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy


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
    from torch.autograd import DeviceType
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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    # user annotations (Optimizer.step, ...) span kernels already counted
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise SystemExit("profile_slice: the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    sum_ms = sum(us for _, us in by_name.values()) / 1e3 / n
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3 / n
    groups = defaultdict(lambda: [0, 0.0])
    lines = []
    for name, (calls, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        ms = us / 1e3 / n
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
    for line in lines[:25]:
        print(line)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n" + json.dumps(result, indent=1) + "\n")
    return result


if __name__ == "__main__":
    main()
