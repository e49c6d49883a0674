"""Time the GEMM forms (``ops/gemm.py``, ``csrc/gemm.cu``) at the slice's
shapes on the card, beside one library call and the bound.

    python3 -m nans_clip_tpu_torch.bench_gemm [--tails] [--train] [--bwd] [--root DIR]

Prints the card's name and power limit, one line a shape, then one JSON
line. Shapes: ViT-B-16's four forward products at M = 256 x 197 image rows
(QKV; out-projection + residual; fc1 + quick-GELU; fc2 + residual) and
ViT-H-14's fc1 at M = 32 x 257. ``--tails`` adds the forward shapes with a
last N tile that is not whole (tensor parallelism at tp 4: N 576 at ViT-B,
960 at ViT-H) and the out-projection without a bias. ``--train`` adds the
training forward's forms at M = 128 x 197 (``kExt`` in gemm.cu: fc1 with its
fp32 pre-activation, the out-projection and fc2 with hidden dropout 0.1 and
an fp32 output, fc2 also with an fp32 residual). ``--bwd`` times the
backward forms instead, at the train step's shapes of ViT-B-16 (image M =
128 x 197 = 25,216, text M = 128 x 52 = 6,656), ViT-H-14 (M = 32 x 257 =
8,224, W 1280, I 5120) and ViT-L-14-336 (M = 32 x 577 = 18,464, W 1024, I
4096): the input gradients ``linear_dgrad`` as the backward chains call them
(``ops/fused_block_bwd.py``: dctx = g . Wo; dxn = dqkv . Wqkv in fp32, or
with the residual du in the post-LN text chain; dh = dproj . W2 x act'(h)
in fp32 with its bf16 copy, or in bf16 on the emitting route; dx = dh . W1
in fp32, or + du in the text chain) and the four weight gradients
``linear_wgrad`` (dWqkv, dWo, dW1, dW2: the kernel and its K-split sum). For
each: the mean ms of 20 launches after a warm-up (CUDA events), TFLOP/s,
one library call's time (``F.linear(a, w, bias)``: the product and bias
alone; ``torch.mm(dy, w)``, in fp32 where the form stores fp32;
``torch.mm(dy.T, x, out_dtype=torch.float32)``: yardsticks the port never
calls), and the bound max(bytes / 3.35 TB/s, flops / 989 TFLOP/s), each
operand read once and each output written once. ``--bwd`` also times the
same 20 calls replayed from a CUDA graph (``graph_ms``, the library call's
likewise, and TFLOP/s from it): the device's time without the host's, which
matters where a kernel (the text shapes', ~0.03 ms) takes less than the
wrapper's Python.

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

# the backward forms: (name, M, contraction N, output K, act' or None,
# residual dtype or None, output dtype, bf16 copy) of the input gradient
# dY [M, N] . W [N, K]; (name, M, N, K) of the weight gradient dY[M, N]^T .
# X[M, K]
_W = {"b": (768, 3072), "h": (1280, 5120), "l": (1024, 4096)}
_M = {"b": 25216, "t": 6656, "h": 8224, "l": 18464}


def _bwd_shapes():
    dgrad, wgrad = [], []
    for tower, model in (("b", "b"), ("t", "b"), ("h", "h"), ("l", "l")):
        m, (w, i) = _M[tower], _W[model]
        post = tower == "t"   # RoBERTa-base: post-LN, erf-GELU, the residual du
        p = f"{dict(b='vit_b', t='text_b', h='vit_h', l='vit_l336')[tower]}_"
        dgrad += [(p + "dctx", m, w, w, None, None, "bf16", False),
                  (p + ("dx_qkv_res" if post else "dxn"), m, 3 * w, w, None,
                   "fp32" if post else None, "bf16" if post else "fp32", False),
                  (p + "dh", m, w, i, "gelu" if post else "quick_gelu", None, "fp32", True),
                  (p + ("dx_w1_res" if post else "dx"), m, i, w, None,
                   "fp32" if post else None, "bf16" if post else "fp32", False)]
        if tower == "b":
            dgrad.append((p + "dh_emit", m, w, i, "quick_gelu", None, "bf16", False))
        wgrad += [(p + "dwqkv", m, 3 * w, w), (p + "dwo", m, w, w), (p + "dw1", m, i, w),
                  (p + "dw2", m, w, i)]
    return dgrad, wgrad


BWD_DGRAD, BWD_WGRAD = _bwd_shapes()
_BYTES = {None: 0, "bf16": 2, "fp32": 4}


def dgrad_bound_ms(m, n, k, act, res, out, copy):
    """(ms, what bounds it) of one input gradient with its epilogue."""
    nbytes = 2 * (m * n + n * k) + (_BYTES[out] + _BYTES[res] + (4 if act else 0)
                                    + (2 if copy else 0)) * m * k
    return _bound(nbytes, 2 * m * n * k)


def wgrad_bound_ms(m, n, k):
    """(ms, what bounds it) of one weight gradient: dY and X read once, the
    fp32 dW written once."""
    return _bound(2 * m * (n + k) + 4 * n * k, 2 * m * n * k)


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(m, n, k, residual, form, has_bias):
    """(ms, what bounds it) of one product and its epilogue."""
    out = 4 if form == "drop" else 2
    nbytes = 2 * (m * k + n * k) + (2 * n if has_bias else 0) + out * m * n
    nbytes += {None: 0, "bf16": 2, "fp32": 4}[residual] * m * n
    nbytes += 4 * m * n if form == "pre" else 0
    return _bound(nbytes, 2 * m * n * k)


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


def time_graph_ms(torch, fn, iters=20):
    """The mean ms of ``iters`` calls of ``fn`` captured in one CUDA graph and
    replayed: device time, the host's launch work left out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
    ap.add_argument("--bwd", action="store_true", help="the backward forms instead")
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
    if args.bwd:
        out = bench_bwd(torch, dev, rnd, g)
        print(json.dumps({"bench_gemm_bwd": out, "device": torch.cuda.get_device_name(0),
                          "power": smi}), flush=True)
        return
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


def bench_bwd(torch, dev, rnd, g) -> dict:
    """The input- and weight-gradient forms at BWD_DGRAD and BWD_WGRAD."""
    from nans_clip_tpu_torch.ops.gemm import linear_dgrad, linear_wgrad

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    out = {}
    for name, m, n, k, act, res, odt, copy in BWD_DGRAD:
        dy, w = rnd(m, n), rnd(n, k)
        aux = torch.randn(m, k, generator=g, device=dev) if act else None
        residual = None if res is None else rnd(m, k).to(dtypes[res])
        kern = lambda: linear_dgrad(dy, w, act, aux, residual, dtypes[odt], copy)
        lib = lambda: torch.mm(dy, w, out_dtype=dtypes[odt])
        out[name] = _line(torch, name, "dgrad", m, n, k, kern, lib,
                          dgrad_bound_ms(m, n, k, act, res, odt, copy), "torch.mm")
        del dy, w, aux, residual
    for name, m, n, k in BWD_WGRAD:
        dy, x = rnd(m, n), rnd(m, k)
        out[name] = _line(torch, name, "wgrad", m, n, k, lambda: linear_wgrad(dy, x),
                          lambda: torch.mm(dy.T, x, out_dtype=torch.float32),
                          wgrad_bound_ms(m, n, k), "torch.mm fp32")
        del dy, x
    return out


def _line(torch, name, form, m, n, k, kern, lib, bound, lib_name):
    """Times ``kern`` and the library call ``lib`` eagerly and from a CUDA
    graph; prints and returns the shape's line."""
    ms, lib_ms = time_ms(torch, kern), time_ms(torch, lib)
    graph_ms, lib_graph_ms = time_graph_ms(torch, kern), time_graph_ms(torch, lib)
    b_ms, b_by = bound
    tflops = 2 * m * n * k / graph_ms / 1e9
    print(f"{name}: {form} M {m} N {n} K {k}: {ms:.4f} ms, graph {graph_ms:.4f} ms, "
          f"{tflops:.1f} TFLOP/s; {lib_name} {lib_ms:.4f} ms, graph {lib_graph_ms:.4f} ms "
          f"({graph_ms / lib_graph_ms:.2f}x); bound {b_ms:.4f} ms ({b_by})", flush=True)
    return {"form": form, "m": m, "n": n, "k": k, "ms": ms, "graph_ms": graph_ms,
            "tflops": tflops, "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
            "bound_ms": b_ms, "bound_by": b_by}


if __name__ == "__main__":
    main()
