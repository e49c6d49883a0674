"""Time the forward GEMM (``ops/gemm.py::linear``, ``csrc/gemm.cu``) at the
slice's shapes on the card, to compare two versions of the kernel in one
call.

    python3 -m nans_clip_tpu_torch.bench_gemm [--tails]

Prints the card's name and power limit, then one JSON line: for each shape
(M = 256 x 197 image rows; the QKV, out-projection, fc1 + quick-GELU and
fc2 + residual products of ViT-B-16) the mean ms of 20 launches after a
warm-up, by CUDA events, and the TFLOP/s. ``--tails`` adds the forward
shapes with a half-full last N tile that tensor parallelism at tp 4 brings
(N 576 at ViT-B, 960 at ViT-H) and the out-projection without a bias: a
version of the kernel before the tail cannot run them. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

M = 256 * 197
# (name, N, K, act, residual, bias)
SHAPES = [("qkv", 2304, 768, None, False, True), ("out_proj", 768, 768, None, True, True),
          ("fc1", 3072, 768, "quick_gelu", False, True), ("fc2", 768, 3072, None, True, True)]
TAILS = [("qkv_tp4_vit_b", 576, 768, None, False, True),
         ("qkv_tp4_vit_h", 960, 1280, None, False, True),
         ("out_proj_no_bias", 768, 768, None, False, False)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tails", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm: needs a CUDA device")
    from nans_clip_tpu_torch.ops.gemm import linear

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: (torch.randn(*s, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    out = {}
    for name, n, k, act, res, has_bias in SHAPES + (TAILS if args.tails else []):
        a, w = rnd(M, k), rnd(n, k)
        bias = rnd(n) if has_bias else None
        residual = rnd(M, n) if res else None
        fn = lambda: linear(a, w, bias, act=act, residual=residual)
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 20
        out[name] = {"m": M, "n": n, "k": k, "ms": ms, "tflops": 2 * M * n * k / ms / 1e9}
    print(json.dumps({"bench_gemm": out, "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
