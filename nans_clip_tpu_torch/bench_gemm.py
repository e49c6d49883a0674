"""Time the forward GEMM (``ops/gemm.py::linear``, ``csrc/gemm.cu``) at the
slice's shapes on the card, beside one ``F.linear`` call and the bound.

    python3 -m nans_clip_tpu_torch.bench_gemm [--tails] [--train] [--root DIR]

Prints the card's name and power limit, one line a shape, then one JSON
line. Shapes: ViT-B-16's four forward products at M = 256 x 197 image rows
(QKV; out-projection + residual; fc1 + quick-GELU; fc2 + residual) and
ViT-H-14's fc1 at M = 32 x 257. ``--tails`` adds the forward shapes with a
last N tile that is not whole (tensor parallelism at tp 4: N 576 at ViT-B,
960 at ViT-H) and the out-projection without a bias. ``--train`` adds the
training forward's forms at M = 128 x 197 (``kExt`` in gemm.cu: fc1 with its
fp32 pre-activation, the out-projection and fc2 with hidden dropout 0.1 and
an fp32 output, fc2 also with an fp32 residual). For each: the mean ms of 20
launches after a warm-up (CUDA events), TFLOP/s, ``F.linear(a, w, bias)``'s
time (the product and bias alone: a yardstick the port never calls), and the
bound max(bytes / 3.35 TB/s, flops / 989 TFLOP/s), each operand read once and
each output written once.

``--root DIR`` imports ``nans_clip_tpu_torch`` from the checkout DIR (for
example a ``git archive`` of the parent commit), so two versions of the
kernel are timed by the same harness; run parent, change, change, parent in
one chip call. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# (name, M, N, K, act, residual dtype or None, bias, form): form "plain", or
# the training forms "pre" (fc1's fp32 pre-activation) and "drop" (hidden
# dropout 0.1, fp32 output)
SHAPES = [("qkv", 50432, 2304, 768, None, None, True, "plain"),
          ("out_proj", 50432, 768, 768, None, "bf16", True, "plain"),
          ("fc1", 50432, 3072, 768, "quick_gelu", None, True, "plain"),
          ("fc2", 50432, 768, 3072, None, "bf16", True, "plain"),
          ("vit_h_fc1", 8224, 5120, 1280, "quick_gelu", None, True, "plain")]
TAILS = [("qkv_tp4_vit_b", 50432, 576, 768, None, None, True, "plain"),
         ("qkv_tp4_vit_h", 8224, 960, 1280, None, None, True, "plain"),
         ("out_proj_no_bias", 50432, 768, 768, None, None, False, "plain")]
TRAIN = [("train_qkv", 25216, 2304, 768, None, None, True, "plain"),
         ("train_out_proj", 25216, 768, 768, None, "bf16", True, "drop"),
         ("train_fc1", 25216, 3072, 768, "quick_gelu", None, True, "pre"),
         ("train_fc2", 25216, 768, 3072, None, "fp32", True, "drop")]


def bound_ms(m, n, k, residual, form, has_bias):
    """(ms, what bounds it) of one product and its epilogue."""
    out = 4 if form == "drop" else 2
    nbytes = 2 * (m * k + n * k) + (2 * n if has_bias else 0) + out * m * n
    nbytes += {None: 0, "bf16": 2, "fp32": 4}[residual] * m * n
    nbytes += 4 * m * n if form == "pre" else 0
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * n * k / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def use_checkout(root: str) -> None:
    """Import ``nans_clip_tpu_torch`` from the checkout ``root`` from here on
    (``python -m`` has imported this checkout's package already)."""
    for name in [n for n in sys.modules if n.split(".")[0] == "nans_clip_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tails", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--root", default=None, help="checkout to import the port from")
    args = ap.parse_args()
    if args.root:
        use_checkout(args.root)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm: needs a CUDA device")
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.gemm import linear

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"kernels from {linear.__module__} at {sys.modules[linear.__module__].__file__}",
          flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: (torch.randn(*s, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    out = {}
    shapes = SHAPES + (TAILS if args.tails else []) + (TRAIN if args.train else [])
    for name, m, n, k, act, res, has_bias, form in shapes:
        a, w = rnd(m, k), rnd(n, k)
        bias = rnd(n) if has_bias else None
        residual = None if res is None else rnd(m, n).to(
            torch.float32 if res == "fp32" else torch.bfloat16)
        kw = dict(act=act, residual=residual)
        if form == "drop":
            kw.update(dropout=drop.Dropout(7, 0.1, drop.STREAM_HIDDEN, 197),
                      out_dtype=torch.float32)
        if form == "pre":
            kw.update(pre_out=True)
        ms = time_ms(torch, lambda: linear(a, w, bias, **kw))
        lib_ms = time_ms(torch, lambda: F.linear(a, w, bias))
        b_ms, b_by = bound_ms(m, n, k, res, form, has_bias)
        tflops = 2 * m * n * k / ms / 1e9
        print(f"{name}: M {m} N {n} K {k}: {ms:.4f} ms, {tflops:.1f} TFLOP/s; F.linear "
              f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})", flush=True)
        out[name] = {"m": m, "n": n, "k": k, "form": form, "ms": ms, "tflops": tflops,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        del a, w, bias, residual
    print(json.dumps({"bench_gemm": out, "device": torch.cuda.get_device_name(0),
                      "power": smi}), flush=True)


if __name__ == "__main__":
    main()
