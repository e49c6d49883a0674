"""Time the LayerNorm backward (``ops/layernorm.py::layer_norm_bwd``,
``csrc/layernorm.cu``, with its column sums through ``csrc/reduce.cu``) on
the card, beside one library call and the bound.

    python3 -m nans_clip_tpu_torch.bench_layernorm [--root DIR]

Prints the card's name and power limit, one line a shape, then one JSON
line. Shapes (rows, width) as the backward chains call the wrapper
(``ops/fused_block_bwd.py``): the pre-LN image form (gin fp32, x bf16, the
residual gradient bf16, dx bf16) with its dgamma/dbeta sums and in its
emitting form (x-hat out, no sums) at ViT-B-16's train step [25,216, 768];
the post-LN text form (gin bf16, x fp32, dx fp32, dproj bf16 under hidden
dropout 0.1, three sums) at RoBERTa-base's [6,656, 768] and
RoBERTa-large's [1,664, 1024]; the pre-LN form with sums at ViT-H-14's
[8,224, 1280] and ViT-L-14-336's [18,464, 1024]. For each: the mean ms of
20 calls replayed from one CUDA graph (``ms``: device time, the wrapper's
Python left out) and called eagerly (``eager_ms``, CUDA events); one
library call (``torch.ops.aten.native_layer_norm_backward`` with dgamma
and dbeta, from ``native_layer_norm``'s mean and rstd, its inputs cast to
fp32 outside the timed window, plus the residual add where the form has
one: a yardstick the port never calls), replayed likewise; and the bound,
bytes / 3.35 TB/s: every input read once and every output written once.

It also times ``ops/reduce.py::column_sum`` beside ``torch.sum(x, 0)`` at
the shapes the chains give it: three [788, 768] fp32 partial planes (the
parent design's LayerNorm partials), the bias gradient of the QKV product
[25,216, 2304] fp32, and the LayerNorm backward's [263, 1536] fp32 partials
of a ViT-B step, which take ``colsum_split_kernel`` (one launch, rows split
across blocks).

``--root DIR`` imports ``nans_clip_tpu_torch`` from the checkout DIR (for
example a ``git archive`` of the parent commit): run parent, change,
change, parent in one chip call. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess

from nans_clip_tpu_torch.bench_gemm import HBM_BYTES_PER_S, time_graph_ms, time_ms, use_checkout

# (name, rows, width, form, emit): form "pre" (image pre-LN) or "post"
# (text post-LN with hidden dropout 0.1); emit: x-hat out and no sums
SHAPES = [("vit_b_image_pre_ln_sums", 25216, 768, "pre", False),
          ("vit_b_image_pre_ln_emit", 25216, 768, "pre", True),
          ("roberta_base_text_post_ln_dropout", 6656, 768, "post", False),
          ("vit_h_14_pre_ln_sums", 8224, 1280, "pre", False),
          ("vit_l_14_336_pre_ln_sums", 18464, 1024, "pre", False),
          ("roberta_large_text_post_ln_dropout", 1664, 1024, "post", False)]
COLSUM_SHAPES = [("ln_partials_3x", 788, 768, 3), ("qkv_bias_grad", 25216, 2304, 1),
                 ("ln_partials_split", 263, 1536, 1)]


def ln_bytes(rows, width, form, emit):
    """Bytes one call must move: gin, x, the residual read; dx, dproj,
    x-hat written; the sums' vectors."""
    per = (4 + 2 + 2 + 2) if form == "pre" else (2 + 4 + 4 + 2)
    if emit:
        per += 2
    sums = 0 if emit else (2 if form == "pre" else 3) * width * 4
    return rows * width * per + width * 2 + sums


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="checkout to import the port from")
    args = ap.parse_args()
    if args.root:
        use_checkout(args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_layernorm: needs a CUDA device")
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.layernorm import layer_norm_bwd
    from nans_clip_tpu_torch.ops.reduce import column_sum

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"kernels from {layer_norm_bwd.__module__}", flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    for name, rows, w, form, emit in SHAPES:
        gamma = (torch.randn(w, generator=g, device=dev) * 0.1 + 1).to(bf16)
        if form == "pre":
            gin = torch.randn(rows, w, generator=g, device=dev)
            x = torch.randn(rows, w, generator=g, device=dev).to(bf16)
            res = torch.randn(rows, w, generator=g, device=dev).to(bf16)
            kw = dict(residual=res, out_dtype=bf16, emit_xhat=emit, sums=not emit)
            eps = 1e-5
        else:
            gin = torch.randn(rows, w, generator=g, device=dev).to(bf16)
            x = torch.randn(rows, w, generator=g, device=dev)
            res = None
            kw = dict(out_dtype=f32, emit_dproj=True,
                      dropout=drop.Dropout(3, 0.1, drop.STREAM_HIDDEN, 52))
            eps = 1e-12
        call = lambda: layer_norm_bwd(gin, x, gamma, eps, **kw)
        ms, eager_ms = time_graph_ms(torch, call), time_ms(torch, call)
        # the yardstick: one library call on fp32 copies, plus the residual add
        g32, x32, gm32 = gin.float(), x.float(), gamma.float()
        bt32 = torch.zeros_like(gm32)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x32, [w], gm32, bt32, eps)
        r32 = None if res is None else res.float()

        def library():
            dx, dgm, dbt = torch.ops.aten.native_layer_norm_backward(
                g32, x32, [w], mean, rstd, gm32, bt32, [True, True, True])
            return dx if r32 is None else dx.add_(r32)

        lib_ms = time_graph_ms(torch, library)
        b_ms = ln_bytes(rows, w, form, emit) / HBM_BYTES_PER_S * 1e3
        print(f"{name}: [{rows}, {w}] {form}-LN{' emit' if emit else ' sums'}: {ms:.4f} ms "
              f"(eager {eager_ms:.4f}); library {lib_ms:.4f} ms; bound {b_ms:.4f} ms (bytes)",
              flush=True)
        out[name] = {"shape": [rows, w], "form": form, "emit": emit, "ms": ms,
                     "eager_ms": eager_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": "bytes"}
        del gin, x, res, g32, x32, r32
    for name, rows, cols, planes in COLSUM_SHAPES:
        xs = [torch.randn(rows, cols, generator=g, device=dev) for _ in range(planes)]
        call = lambda: [column_sum(t) for t in xs]
        ms, eager_ms = time_graph_ms(torch, call), time_ms(torch, call)
        lib_ms = time_graph_ms(torch, lambda: [torch.sum(t, 0) for t in xs])
        b_ms = planes * (rows + 1) * cols * 4 / HBM_BYTES_PER_S * 1e3
        print(f"column_sum {name}: {planes} x [{rows}, {cols}] fp32: {ms:.4f} ms (eager "
              f"{eager_ms:.4f}); torch.sum {lib_ms:.4f} ms; bound {b_ms:.4f} ms (bytes)",
              flush=True)
        out[f"column_sum_{name}"] = {"shape": [planes, rows, cols], "ms": ms, "eager_ms": eager_ms,
                                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": "bytes"}
    print(json.dumps({"bench_layernorm": out, "device": torch.cuda.get_device_name(0),
                      "power": smi}), flush=True)


if __name__ == "__main__":
    main()
