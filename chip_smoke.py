#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nans_clip_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines before the last line:

1. Device: the card's name and power limit, as nvidia-smi reports them.
2. Build: compile ``nans_clip_tpu_torch/csrc/*.cu`` for sm_90a.
3. Kernels: each ported kernel and each hand kernel against its plain-torch
   twin in bf16 at the main path's shapes (ViT-B/16 S=197 and RoBERTa-base
   S=52, W=768, 12 heads, batch 256): max abs error against its bound, and
   CUDA-event times of kernel and twin.
4. Slice: ViT-B-16@RoBERTa-wwm-ext-base-chinese at full depth and width,
   random init from a seeded generator, saved as a reference-layout .pt and
   reloaded through ``load_from_name``; ``get_similarity`` on 256 image/text
   pairs in bf16, with launch counts showing that all 12 layers of each
   tower ran through the kernels, checked against the same model on the
   plain-torch path, and against an fp32 plain run on a small input.

Then one JSON line of per-kernel results and, last, the device line
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
not 0 and no result is printed. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 256
TEXTS = ["杰尼龟", "妙蛙种子", "小火龙", "皮卡丘", "西湖美景，三月天", "一只可爱的小猫在草地上玩耍"]


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _ulps(ref, n: int) -> float:
    """n bf16 ulps at the largest magnitude of ``ref``: bf16 keeps 8
    significant bits, so one rounding flip anywhere in a chain moves an
    output by about one ulp of its magnitude."""
    import math

    top = float(ref.float().abs().max())
    return n * 2.0 ** (math.floor(math.log2(top)) - 7)


def phase_kernels(torch, dev):
    """Every kernel against its twin, bf16, at the slice's shapes."""
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.ops import layer_kernel as lk
    from nans_clip_tpu_torch.ops.attention import attention, attention_plain
    from nans_clip_tpu_torch.ops.gemm import linear, linear_plain
    from nans_clip_tpu_torch.ops.layernorm import layer_norm, row_layer_norm

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    w, inter, heads = 768, 3072, 12

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

    def layer_params(std):
        return dict(ln1_w=rnd(w, std=0.1, mean=1.0), ln1_b=rnd(w, std=0.1),
                    w_qkv=rnd(3 * w, w, std=std), b_qkv=rnd(3 * w, std=0.1),
                    w_o=rnd(w, w, std=std), b_o=rnd(w, std=0.1),
                    ln2_w=rnd(w, std=0.1, mean=1.0), ln2_b=rnd(w, std=0.1),
                    w1=rnd(inter, w, std=std), b1=rnd(inter, std=0.1),
                    w2=rnd(w, inter, std=std / 2), b2=rnd(w, std=0.1))

    def key_bias(s):
        lengths = torch.randint(2, s + 1, (BATCH,), generator=g, device=dev)
        keep = torch.arange(s, device=dev)[None, :] < lengths[:, None]
        return ((1.0 - keep.float()) * -10000.0).contiguous()

    xi = rnd(BATCH, 197, w)
    xt = rnd(BATCH, 52, w)
    kb = key_bias(52)
    pi = layer_params(w ** -0.5)
    pt = layer_params(0.02)
    attn_args = lambda p: (p["ln1_w"], p["ln1_b"], p["w_qkv"], p["b_qkv"], p["w_o"], p["b_o"])
    mlp_args = lambda p: (p["ln2_w"], p["ln2_b"], p["w1"], p["b1"], p["w2"], p["b2"])
    layer_args = lambda p: attn_args(p) + mlp_args(p)
    xi2 = xi.reshape(-1, w)
    qkv = linear(row_layer_norm(xi2, pi["ln1_w"], pi["ln1_b"], 1e-5), pi["w_qkv"], pi["b_qkv"])
    qkv_t = linear(xt.reshape(-1, w), pt["w_qkv"], pt["b_qkv"])

    # (entry name, kernel call, twin call, bf16-ulp bound, JSON fields or None)
    cases = [
        ("fused_attention_block", lambda: fb.fused_attention_block(xi, *attn_args(pi), heads),
         lambda: fb._reference_block(xi, *attn_args(pi), heads, 1e-5), 4,
         ("nans_clip_tpu_torch/ops/fused_block.py", "nans_clip_tpu/ops/fused_block.py:103")),
        ("fused_bert_attention_block",
         lambda: fb.fused_bert_attention_block(xt, *attn_args(pt), kb, heads),
         lambda: fb._reference_block(xt, *attn_args(pt), heads, 1e-12, kb, True), 4, None),
        ("fused_mlp_block", lambda: fb.fused_mlp_block(xi, *mlp_args(pi)),
         lambda: fb._reference_mlp(xi, *mlp_args(pi), "quick_gelu", 1e-5, False), 4,
         ("nans_clip_tpu_torch/ops/fused_block.py", "nans_clip_tpu/ops/fused_block.py:797")),
        ("fused_mlp_block[post-LN, S=52]",
         lambda: fb.fused_mlp_block(xt, *mlp_args(pt), "gelu", 1e-12, True),
         lambda: fb._reference_mlp(xt, *mlp_args(pt), "gelu", 1e-12, True), 4, None),
        ("fused_layer_block",
         lambda: lk.fused_layer_block(xt, *layer_args(pt), heads, 1e-12, "gelu", True, kb),
         lambda: lk.encoder_layer_math(xt, *layer_args(pt), heads, 1e-12, "gelu", True, kb), 4,
         ("nans_clip_tpu_torch/ops/layer_kernel.py", "nans_clip_tpu/ops/layer_kernel.py:116")),
        ("layernorm", lambda: row_layer_norm(xi2, pi["ln1_w"], pi["ln1_b"], 1e-5),
         lambda: layer_norm(xi2, pi["ln1_w"], pi["ln1_b"], 1e-5), 1,
         ("nans_clip_tpu_torch/csrc/layernorm.cu", "nans_clip_tpu/ops/fused_block.py:96")),
        ("gemm", lambda: linear(xi2, pi["w1"], pi["b1"], "quick_gelu"),
         lambda: linear_plain(xi2, pi["w1"], pi["b1"], "quick_gelu"), 1,
         ("nans_clip_tpu_torch/csrc/gemm.cu", "nans_clip_tpu/ops/fused_block.py:809")),
        ("attention", lambda: attention(qkv, None, BATCH, heads),
         lambda: attention_plain(qkv, None, BATCH, heads), 1,
         ("nans_clip_tpu_torch/csrc/attention.cu", "nans_clip_tpu/ops/fused_block.py:164")),
        ("attention[masked, S=52]", lambda: attention(qkv_t, kb, BATCH, heads),
         lambda: attention_plain(qkv_t, kb, BATCH, heads), 1, None),
    ]
    results = {}
    for name, kern, twin, n_ulps, meta in cases:
        got, want = kern(), twin()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        bound = _ulps(want, n_ulps)
        if not (torch.isfinite(got).all() and err <= bound):
            raise AssertionError(f"{name}: max abs err {err} exceeds bound {bound}")
        ms, plain_ms = _time_ms(kern, 10), _time_ms(twin, 3)
        print(f"kernel {name}: max_abs_err {err:.6g} <= bound {bound:.6g} ({n_ulps} bf16 ulp "
              f"of max|twin| {float(want.float().abs().max()):.4g}); {ms:.4f} ms, "
              f"twin {plain_ms:.4f} ms", flush=True)
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms, meta=meta)
    return results


def phase_slice(torch, dev):
    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.ops import layer_kernel as lk
    from nans_clip_tpu_torch.ops.attention import attention
    from nans_clip_tpu_torch.ops.gemm import linear
    from nans_clip_tpu_torch.ops.layernorm import row_layer_norm

    vision, text = "ViT-B-16", "RoBERTa-wwm-ext-base-chinese"
    cfg = nct.load_config(f"{vision}@{text}")
    layers = cfg.vision.layers
    assert layers == cfg.text.num_hidden_layers == 12
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "clip_cn_vit-b-16_random.pt")
        module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
        torch.save({"state_dict": module.state_dict()}, ckpt)
        del module
        load = lambda **kw: nct.load_from_name(
            ckpt, vision_model_name=vision, text_model_name=text, input_resolution=224,
            device=dev, options=nct.ModelOptions(**kw))[0]
        model = load(compute_dtype="bfloat16")
        plain = load(compute_dtype="bfloat16", attn_impl="plain")
        ref32 = load(attn_impl="plain")
    print(f"slice: {cfg.name} built, saved and reloaded in {time.time() - t0:.1f} s", flush=True)

    gen = torch.Generator().manual_seed(1)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen).to(dev)
    ids = torch.from_numpy(nct.tokenize((TEXTS * BATCH)[:BATCH])).to(dev)

    counted = {"fused_attention_block": fb.fused_attention_block,
               "fused_bert_attention_block": fb.fused_bert_attention_block,
               "fused_mlp_block": fb.fused_mlp_block, "fused_layer_block": lk.fused_layer_block,
               "layernorm": row_layer_norm, "gemm": linear, "attention": attention}
    for fn in counted.values():
        fn.launches = 0
    li, lt = model.get_similarity(images, ids)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    expected = {"fused_attention_block": layers, "fused_bert_attention_block": 0,
                "fused_mlp_block": layers, "fused_layer_block": layers,
                "layernorm": 4 * layers, "gemm": 8 * layers, "attention": 2 * layers}
    print(f"slice: launches {json.dumps(launches)}", flush=True)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")

    pli, plt_ = plain.get_similarity(images, ids)
    torch.cuda.synchronize()
    if li.shape != (BATCH, BATCH) or not torch.isfinite(li).all():
        raise AssertionError(f"logits shape {tuple(li.shape)} or non-finite values")
    if not torch.equal(lt, li.T):
        raise AssertionError("logits_per_text is not logits_per_image transposed")
    err = float((li - pli).abs().max())
    # logits are 14.29 x cosine: 0.05 is a cosine difference of 0.0035
    bound = 0.05
    print(f"slice: get_similarity kernel vs plain bf16 max abs err {err:.6g} <= bound {bound}",
          flush=True)
    if err > bound:
        raise AssertionError(f"slice logits differ from the plain path by {err}")

    # Small input against the fp32 plain path: bf16 vs fp32 through 12 layers.
    n = 8
    small32 = ref32.get_similarity(images[:n], ids[:n])[0]
    small16 = model.get_similarity(images[:n], ids[:n])[0]
    err32 = float((small16 - small32).abs().max())
    bound32 = 0.5
    print(f"slice: bf16 kernels vs fp32 plain on {n} pairs max abs err {err32:.6g} "
          f"<= bound {bound32}", flush=True)
    if err32 > bound32:
        raise AssertionError(f"bf16 slice differs from fp32 by {err32}")

    ms = _time_ms(lambda: model.get_similarity(images, ids), 5)
    plain_ms = _time_ms(lambda: plain.get_similarity(images, ids), 2)
    print(f"slice: get_similarity at batch {BATCH}: {ms:.2f} ms, {BATCH / ms * 1e3:.1f} pairs/s; "
          f"plain path {plain_ms:.2f} ms, {BATCH / plain_ms * 1e3:.1f} pairs/s", flush=True)
    return launches


def main() -> int:
    if not (ROOT / "nans_clip_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(nans_clip_tpu_torch/ is missing beside this script)")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    print(_nvidia_smi(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from nans_clip_tpu_torch.ops import _build
    t0 = time.time()
    report = _build.build()
    _build.library()
    regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
    print(f"build: {time.time() - t0:.1f} s, {len(_build.sources())} sources; "
          + " | ".join(regs), flush=True)

    results = phase_kernels(torch, dev)
    launches = phase_slice(torch, dev)

    if any(m == "jax" or m.startswith(("jax.", "nans_clip_tpu.")) for m in sys.modules):
        raise AssertionError("chip_smoke imported JAX or the JAX package")
    kernels = []
    for name, r in results.items():
        if r["meta"] is None:
            continue
        source, replaces = r["meta"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
