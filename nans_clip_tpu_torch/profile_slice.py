"""Where the device time of ``get_similarity`` goes, on one GPU.

    python3 -m nans_clip_tpu_torch.profile_slice [--batch 256] [--iters 5] [--out FILE]

Builds ViT-B-16@RoBERTa-wwm-ext-base-chinese at random init (seed 0) in
bf16 on ``cuda:0`` and runs ``get_similarity`` on seeded images and texts.
It reports, all from one run:

* CUDA-event times of ``encode_image``, ``encode_text`` and
  ``get_similarity``;
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

TEXTS = ["杰尼龟", "妙蛙种子", "小火龙", "皮卡丘", "西湖美景，三月天", "一只可爱的小猫在草地上玩耍"]
HAND_KERNEL = re.compile(r"(gemm|attention|layernorm)_kernel(<[^>]*>)?")


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import nans_clip_tpu_torch as nct

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, b, n = torch.device("cuda", 0), args.batch, args.iters
    model = nct.create_model("ViT-B-16@RoBERTa-wwm-ext-base-chinese", seed=0, device=dev,
                             options=nct.ModelOptions(compute_dtype="bfloat16"))
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(b, 224, 224, 3, generator=gen).to(dev)
    ids = torch.from_numpy(nct.tokenize((TEXTS * b)[:b])).to(dev)
    step = lambda: model.get_similarity(images, ids)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    ev = {"encode_image": _event_ms(lambda: model.encode_image(images), n),
          "encode_text": _event_ms(lambda: model.encode_text(ids), n),
          "get_similarity": _event_ms(step, n)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
        # a hand kernel keeps its template arguments: gemm_kernel<true> writes fp32
        hand = HAND_KERNEL.search(name)
        group = hand.group(0) if hand else "plain torch"
        groups[group][0] += calls // n
        groups[group][1] += ms
    result = {
        "device": torch.cuda.get_device_name(0), "batch": b, "iters": n,
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
