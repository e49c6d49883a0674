"""Inference latency benchmark CLI (counterpart of
``nans_clip_tpu/deploy/speed_benchmark.py``; reference
deploy/speed_benchmark.py:88-187 and benchmark_utils.py:11-42).

Times ``encode_image`` and ``encode_text`` one call at a time at each batch
size: on the card with CUDA events around the call and a synchronize after
it, on the CPU (``--device cpu``) with ``time.perf_counter``. Prints one line
a tower and batch, and writes ``{"image@bs{N}": stats, "text@bs{N}": ...}``
to ``--json-output``: mean/std/min/max/median/p95/p99 in ms, ms per sample
and samples/s.

Usage:
  python -m nans_clip_tpu_torch.deploy.speed_benchmark \\
      --vision-model ViT-B-16 --text-model RoBERTa-wwm-ext-base-chinese \\
      [--resume ckpt.pt] [--quantize int8-text] --batch-sizes 1,8,32 --n 50

The ahead-of-time and saved-engine backends of the JAX CLI wait for the
port's ``deploy/aot.py`` and ``deploy/engine.py``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from nans_clip_tpu_torch.models.common import PRECISIONS
from nans_clip_tpu_torch.ops import gates


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="nans_clip_tpu_torch.deploy.speed_benchmark")
    p.add_argument("--vision-model", default="ViT-B-16")
    p.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese")
    p.add_argument("--resume", default=None)
    p.add_argument("--batch-sizes", default="1,8,64,256")
    p.add_argument("--n", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--context-length", type=int, default=52)
    p.add_argument("--precision", default="bf16", choices=PRECISIONS,
                   help="every value but fp32 runs in bf16, as in the JAX package")
    p.add_argument("--attn-impl", default="auto", choices=gates.IMPLS,
                   help="the JAX choices auto|xla|pallas|fused, plus the port's plain|kernel")
    p.add_argument("--json-output", default=None)
    p.add_argument("--quantize", default=None, choices=[None, "int8", "int8-text"],
                   help="weight-only int8 serving (utils/quantize.py): the whole-tower "
                        "kernel streams half the weight bytes; other routes dequantize on "
                        "entry. int8-text quantizes only the text tower")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny-model", action="store_true",
                   help="2-layer debug config (configs.tiny_config)")
    return p.parse_args(argv)


def stats(times_ms):
    t = np.asarray(times_ms)
    return {
        "mean": float(t.mean()), "std": float(t.std()), "min": float(t.min()),
        "max": float(t.max()), "median": float(np.median(t)),
        "p95": float(np.percentile(t, 95)), "p99": float(np.percentile(t, 99)),
    }


def time_call(fn, device: torch.device) -> float:
    """ms of one call: CUDA events and a synchronize on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return 1000.0 * (time.perf_counter() - t0)


def bench_fn(fn, device: torch.device, n: int, warmup: int):
    for _ in range(warmup):
        time_call(fn, device)
    return stats([time_call(fn, device) for _ in range(n)])


def bench_model(model, batch_sizes, n: int, warmup: int, context_length: int = 52,
                label: str = "") -> dict:
    """Latency of both towers of ``model`` at each batch size, on seeded
    inputs (images from RandomState(0); texts [CLS] token [SEP])."""
    dev = model.device
    resolution = model.image_resolution
    rs = np.random.RandomState(0)
    results = {}
    for bs in batch_sizes:
        images = torch.from_numpy(rs.randn(bs, resolution, resolution, 3).astype(np.float32))
        images = images.to(dev)
        texts = torch.zeros(bs, context_length, dtype=torch.long)
        texts[:, 0], texts[:, 1], texts[:, 2] = 101, 768, 102
        texts = texts.to(dev)
        for tower, fn in (("image", lambda: model.encode_image(images)),
                          ("text", lambda: model.encode_text(texts))):
            s = bench_fn(fn, dev, n, warmup)
            s["ms_per_sample"] = s["mean"] / bs
            s["samples_per_sec"] = 1000.0 * bs / s["mean"]
            results[f"{tower}@bs{bs}"] = s
            print(f"[{label or model.cfg.name} {tower} bs={bs}] mean {s['mean']:.3f} ms | "
                  f"p50 {s['median']:.3f} | p95 {s['p95']:.3f} | p99 {s['p99']:.3f} | "
                  f"{s['ms_per_sample']:.4f} ms/sample | {s['samples_per_sec']:.1f}/s",
                  flush=True)
    return results


def main(argv=None):
    args = parse_args(argv)
    from nans_clip_tpu_torch.eval.model_io import load_eval_model

    cfg = None
    if args.tiny_model:
        from nans_clip_tpu_torch.configs import tiny_config
        cfg = tiny_config()
    model = load_eval_model(args.vision_model, args.text_model, args.resume, args.precision,
                            attn_impl=args.attn_impl, cfg=cfg, device=args.device)
    if args.quantize:
        from nans_clip_tpu_torch.utils.quantize import towers_for_mode
        model = model.quantize("int8", towers_for_mode(args.quantize))
    batch_sizes = [int(b) for b in args.batch_sizes.split(",")]
    label = f"{args.vision_model} {args.quantize or args.precision} attn_impl={args.attn_impl}"
    results = bench_model(model, batch_sizes, args.n, args.warmup, args.context_length, label)
    if args.json_output:
        with open(args.json_output, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
