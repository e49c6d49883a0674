#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nans_clip_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines before the last line:

1. Device: the card's name and power limit, as nvidia-smi reports them.
2. Build: compile ``nans_clip_tpu_torch/csrc/*.cu`` for sm_90a.
3. Kernels: each ported kernel and each hand kernel against its plain-torch
   twin in bf16 at the batch path's shapes (ViT-B/16 S=197 and RoBERTa-base
   S=52, W=768, 12 heads, batch 256): max abs error against its bound, and
   CUDA-event times of kernel, twin and, where one PyTorch call computes the
   same function, that call (a yardstick only: the port never calls it),
   beside the least time the card could take (its bound). The forward GEMM
   (wgmma + TMA) also at ViT-B's other three products (QKV, out-projection
   and fc2 with their residuals, M 50,432) and in one training form (fc1 at
   M 25,216 with its fp32 pre-activation, hidden dropout 0.1, an fp32
   residual and an fp32 output); the forward attention also at heads of 80
   (32, 16, 257, 80), at S=577 (32, 16, 577, 64) and masked with dropout 0.1
   (128, 12, 52, 64), each with SDPA beside it; the backward forms at ViT-B's
   train shapes (M 25,216): the input gradients dh = dproj . W2 x act'(h)
   (fp32, with its bf16 copy), dctx = g . Wo, dxn = dqkv . Wqkv (fp32) and dx
   = dh . W1 (fp32), and the four weight gradients with their K-split sum,
   each beside one ``torch.mm`` (bound: 2 bf16 ulps for a bf16 output, 1e-5
   of max|twin| for an fp32 one); the attention backward from the
   forward's row statistics at ViT-B's (128, 12, 197, 64), the masked text
   shape with dropout 0.1 (128, 12, 52, 64) and ViT-H-14's (32, 16, 257,
   80), and the long-sequence pair at (32, 16, 577, 64), each beside SDPA's
   backward (dqkv within 1e-2 of max|twin|, the same bits on a second call;
   the pair's launches are counted in a ViT-L-14-336 step, phase 9); the
   LayerNorm backward in the chains' forms (pre-LN image with its sums at
   [25,216, 768], post-LN text with dropout 0.1 at [6,656, 768], pre-LN at
   ViT-H's [8,224, 1280]) beside
   ``native_layer_norm_backward`` on fp32 copies; and ``column_sum`` at the
   QKV bias gradient [25,216, 2304] and at the LayerNorm partials [263,
   1536] beside ``torch.sum``.
4. Tower kernels: the whole-tower kernel, bf16 and int8, in the text form
   (S=52, masked, post-LN) and the image form (S=197, pre-LN), 12 layers,
   W=768, batch 1, 8 and 32, against its twin, with its time, the twin's, its
   bound and the per-layer route's time at the same batch (the evidence of
   ``ops/gates.py::TOWER_MAX_BATCH``).
5. Batch path: ViT-B-16@RoBERTa-wwm-ext-base-chinese at full depth and
   width, random init from a seeded generator, saved as a reference-layout
   .pt and reloaded through ``load_from_name``; ``get_similarity`` on 256
   image/text pairs in bf16, with launch counts showing that all 12 layers
   of each tower ran through the per-layer kernels, checked against the same
   model on the plain-torch path, and against an fp32 plain run.
6. Serving path: the same checkpoint through ``load_from_name`` with the
   default device, then ``CLIPModel.quantize("int8", towers=("text",))``;
   batch-1 ``encode_text`` and ``encode_image`` on both, with launch counts
   showing one tower launch and no per-layer launch each (int8 for the
   quantized text tower); ``speed_benchmark``'s latency at batch 1, 8 and 32
   for both towers in bf16 and int8-text; and the HTTP daemon on 127.0.0.1
   answering 8 concurrent one-text ``/encode_text`` requests.
7. Training: the backward kernels (#14, #16 with attention and hidden
   dropout at 0.1, #18 in both forms) against their twins at the train
   step's shapes (batch 128; image S=197, text S=52), with their times, the
   twin's, the bound and a yardstick (``torch.autograd`` through the same
   sub-block written with ``F.layer_norm``/``F.linear``/SDPA; the port never
   calls it); #1/#2 with dropout against their twins, and the keep masks
   that the kernels draw, read back and held against the twin's. Then
   ViT-B-16@RoBERTa-wwm-ext-base-chinese from a seeded generator takes one
   train step on the plain route and the same step on the kernel route
   (loss and gradient cosines compared), then 7 more on one fixed batch of
   128 pairs through ``make_train_step`` in bf16: the loss of every step,
   step time, pairs/s, peak memory and the launch counts of a step. The
   trained model is saved as a ``.pt``, reloaded through ``load_from_name``
   and its features compared with the trained module's.

8. LoRA finetuning and the rest of the train step: the emitting backward
   kernels (#13, #15 with dropout 0.1, #17 in both forms) against their
   twins at batch 128 and at the LoRA microbatch 32, with a frozen-weight
   autograd yardstick and, beside each, the time of the emitting kernel plus
   library weight gradients against the full-gradient chain (the evidence of
   ``ops/gates.py::BWD_ROUTE``); the whole-layer backward #21 against #18
   then #14 (bit-equal); one full train step at batch 128 on each
   ``bwd_impl`` route (fullgrad, emit, layer, auto), times and agreement, and
   the time of ``auto`` under the table the block times give; the LoRA
   step through ``make_lora_step`` (batch 32 x accum 4, rank 4, dropout on):
   merged-at-init features, kernel against plain route, the loss over 8
   steps, the base weights bit-equal, launch counts, ``save_lora`` ->
   ``load_lora``; then the full step with ``accum_freq=2``, with
   ``mask_ratio=0.5``, with the ViT-H-14@RoBERTa-wwm-ext-large-chinese
   teacher of the repository's distillation preset (full depth, seeded
   weights) and with bf16 Adam moments.
9. The wide towers: #7/#8 (ViT-H widths at S=577, heads of 80), #9/#10
   (ViT-H at S=257 and ViT-L at S=577), #19, #20 (ViT-L-14-336 and ViT-H
   widths at S=577) and #1, #13, #14 at heads of 80, against their twins at
   full width, with a library yardstick; tower.cu at RoBERTa-large's width
   (24 layers, batch 1 and 8); ViT-H-14@RoBERTa-wwm-ext-large-chinese and
   ViT-L-14-336@RoBERTa-wwm-ext-base-chinese at full depth, batch 32: one
   step on the plain and the kernel route compared, then 6 steps (loss,
   step ms, pairs/s, peak memory, launches a step); a ViT-H-width tower at
   336 px cut to 4 layers (#7 forward, #20 at heads of 80 backward);
   ``get_similarity`` of ViT-H-14 at batch 3 (the image tower's per-layer
   route, #1 + #9) and 64 against the plain path.

10. The ``attn_impl="pallas"`` route: the flash attention #22 and its
   backward #23 against their twins at (256, 12, 197, 64), (256, 12, 52, 64)
   with a key bias, (32, 16, 257, 80), (32, 16, 577, 64) and (4, 16, 1024,
   64), with SDPA (forward, and autograd through it) as the yardstick;
   ``flash_attention_block`` (forward and its 7 gradients) at (32, 577,
   1024, 16 heads) and ``pallas_layer_norm`` (#24) at [50,432, 768] and
   [9,232, 1280] against their twins (direct calls); ``get_similarity`` of
   ViT-B-16 at batch 256 from a ``.pt`` through ``load_from_name`` on the
   route against the ``fused`` route (24 launches of #22, none of the fused
   kernels); ViT-L-14-336@RoBERTa-wwm-ext-base-chinese at batch 32, full
   depth, text dropout 0.1: one step on the route against one on the
   ``fused`` route, then 5 steps (loss, step ms, pairs/s, peak memory, 24
   launches each of #22 and #23 a step: the text tower's attention is the
   plain one under dropout, as in JAX).

11. Tensor parallelism (``ModelOptions.tp``): the partial kernels #11 and
   #12 against their twins at a rank's shapes (ViT-B-16 at tp 2 and 4,
   batch 256; RoBERTa-base post-LN, masked, tp 2, batch 256; ViT-H-14 tp 2,
   batch 32: 8 local heads of 80), with the library chain (``F.linear`` +
   SDPA + ``F.linear``, ``F.linear`` + act + ``F.linear``) beside them; the
   tp ranks' partials summed with the residual and bias in one process
   against the unsharded #1 / #2 (tp 2 and 4); then the real path in 2
   spawned ranks on ``cuda:0`` joined by gloo: ``get_similarity`` of
   ViT-B-16@RoBERTa-base at batch 256 with ``tp=2`` against ``tp=1`` on the
   kernel route, the ranks' logits bit-equal, per-rank launch counts (24 of
   #11 and of #12, none of #1/#2/#3), then 4 deterministic train steps at
   batch 128 (the first against one step at tp 1 from the same weights:
   loss and gradient cosines; the loss falls; every rank's parameters
   equal after each step), then 2 steps with the text tower's dropout at
   0.1 (the JAX unfused path under TP: the twins, with the masks one process
   draws) against the same steps at tp 1 from the same weights and seeds
   (loss and gradient cosines; the ranks' parameters bit-equal). Times
   through gloo on one card say nothing of TP scaling.

12. The dequant-ahead int8 tower (#6, ``fused_tower(quant_dma=True)``, a
   direct call no model routes) at batch 1, full depth, at the ViT-B image
   (12 layers, S 197), RoBERTa-base text (12 layers, S 52, masked; also
   batch 8 and 32) and RoBERTa-large text (24 layers, W 1024) shapes:
   against its twin, bit-equal to #5 at one grid, and timed against #5 in
   turns; tower.cu at ViT-H-14's image shape (32 layers, S 257, W 1280,
   heads of 80), bf16 and int8, against its twin and the per-layer route;
   ``get_similarity`` of ViT-H-14@RoBERTa-wwm-ext-large-chinese at batch 1
   from a ``.pt`` through ``load_from_name``, bf16 and int8: one tower
   launch a tower, none of #1/#9, logits within 0.1 of the plain path, and
   its time beside the per-layer image route's (the tower gate closed for
   that arm).

13. The data path and the training CLIs: a split of 1,024 pairs (512
   seeded noise JPEGs of 256 px, two captions each) written with the port's
   ``NPackWriter``; the loader's pairs/s at batch 128, 224 px, on both
   decoders; ``preprocess_images`` at batch 128 with and without
   augmentation; run A, ``training.main.main`` on
   ViT-B-16@RoBERTa-wwm-ext-base-chinese at full width and depth (seed 0,
   batch 128, 6 steps, ``--save-torch-format``, steps 3-5 under
   ``--profile-steps``): each step's loss, data s and batch s, the launches
   of a step (the forward chains, and the backward kernels the default
   route ``gates.BWD_ROUTE`` names: #14, #15, #17), and from the trace the
   device's idle share and the host's time in each span of the CLI's
   loop; ``load_eval_model`` on run A's
   checkpoint directory (features bit-equal to the trained module's); run
   B, 3 steps with a ``step_3`` checkpoint and a resume from it to 6 (losses
   and parameters bit-equal to run A's); ``train_lora.main`` from run A's
   ``.pt``, one epoch at 32 x 4, rank 4 (its ``training_log.csv``, the
   ``load_lora`` round trip, #13/#15/#17 launched); ``bench.py``'s JSON
   line. Each checkpoint directory is deleted once used (run A's, after
   phase 14).

14. The eval pipeline, in phase 13's temporary directory, from run A's
   ``epoch1.pt`` and the LoRA CLI's ``last_lora.npz``, at
   ViT-B-16@RoBERTa-wwm-ext-base-chinese full width and depth, bf16: a raw
   split (1,024 seeded noise JPEGs of 256 px, 2,048 texts, some on two or
   three images, some captions repeated) built by ``build_dataset``;
   ``extract_features.main`` on both towers at batch 64 with
   ``--image-transform pil`` and ``native`` (12 launches of #1 and #2 a
   full image batch, of #3 a text batch; images/s end to end and on the
   device, CUDA events around ``encode_image``; the device's idle share
   over the image extraction from a CUDA-only ``torch.profiler``; texts/s);
   the first image and text batch against the plain route on the card
   (phase 5's bound on the logits); ``make_topk_predictions`` both ways
   against a float64 ranking of the same files (ids may trade ranks only
   where their exact scores differ by less than 1e-6), ``evaluation``,
   ``transform_ir_annotation_to_tr`` and ``evaluation_tr``;
   ``zeroshot_evaluation`` on 8 classes x 16 images with the 183 ``openai``
   templates (the ELEVATER json's rows sum to 1); ``retrieval_suite`` with
   64 distractors (and one file that is not an image) and the adapters,
   both result blocks; one ``{"phase14": "eval", ...}`` line of the rates.

15. The serving backends, from phase 14's checkpoint at ViT-B-16@RoBERTa-
   wwm-ext-base-chinese full width and depth, bf16: ``deploy/aot.py::
   compile_tower`` (a CUDA graph a tower and batch) for both towers at batch
   1, 8, 32 and 64, and the int8 text tower at batch 1, each bit-equal to
   the eager ``encode_*`` (or within the eager tower's own run-to-run
   difference, printed beside it), with the launches of each warm-up and
   capture; ``deploy.engine build`` of both towers at batch 1, 8, 32 and 64
   in a subprocess (seconds, file bytes against the tower's weight bytes),
   ``inspect``, and a cold load of four engines in a fresh process that
   imports no model module and runs no nvcc (the kernel library's mtime
   unchanged), their features against eager; a split of 65 images and 70
   texts through ``extract_features --backend jit`` and ``--backend engine``
   at batch 64 (queue 3 item E: the final partial chunks take tower.cu on
   ``jit`` and a padded 64 on ``engine``; their rows against the same rows
   in a full batch, within the daemon bound 0.01); the HTTP daemon, once
   with per-bucket graphs and once with ``--engine-dir``, on the same texts
   and images in 12 concurrent requests, against both extractions (0.01);
   ``speed_benchmark``'s latency p50/p95/p99 of each tower at batch 1, 8 and
   32 on ``jit``, ``aot`` and ``engine``, on the CUDA events' and the host's
   clock, each block after the card's name and power limit, with the
   device's idle share of each (CUDA-only profiler over 20 calls); one
   ``{"phase15": "serving backends", ...}`` line.

An early line says what the card's machine has for the data path (g++,
jpeglib.h, a linkable libjpeg, PIL): facts for the port of the data loader,
nothing branches on them.

Then one JSON line of per-kernel results (all 24 TPU kernels' ports, with
the library yardstick of the sub-block and tower kernels) and, last, the
device line
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
not 0 and no result is printed. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 256
TEXTS = ["杰尼龟", "妙蛙种子", "小火龙", "皮卡丘", "西湖美景，三月天", "一只可爱的小猫在草地上玩耍"]
VISION, TEXT = "ViT-B-16", "RoBERTa-wwm-ext-base-chinese"
# H100 SXM data sheet: HBM bandwidth and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _data_path_facts() -> str:
    """What the data path's native decoder would need on this machine."""
    import importlib.util
    import shutil

    gxx = shutil.which("g++")
    header = link = False
    if gxx:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "probe.cpp")
            with open(src, "w") as f:
                f.write("#include <cstdio>\n#include <jpeglib.h>\nint main() { "
                        "jpeg_error_mgr e; jpeg_std_error(&e); return 0; }\n")
            run = lambda *args: subprocess.run([gxx, *args], capture_output=True,
                                               timeout=120).returncode == 0
            header = run("-fsyntax-only", src)
            link = header and run(src, "-ljpeg", "-o", os.path.join(tmp, "probe"))
    pil = importlib.util.find_spec("PIL") is not None
    return (f"data path facts: g++ {gxx or 'missing'}; jpeglib.h {'found' if header else 'missing'}; "
            f"libjpeg links: {link}; PIL importable: {pil}")


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


def _check_flash_bwd_plan(b, h, s, dh):
    """nans_flash_bwd_plan reports the launch ops/attention.py::flash_bwd_plan
    computes."""
    import ctypes

    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.ops.attention import flash_bwd_plan

    out = (ctypes.c_int * 6)()
    _build.check(_build.library().nans_flash_bwd_plan(s, dh, out), "nans_flash_bwd_plan")
    p = flash_bwd_plan(b, h, s, dh)
    want = [p["warps"], p["blocks"], p["strips"], p["smem_dq"], p["smem_dkv"], p["dkv_blocks"]]
    if list(out) != want:
        raise AssertionError(f"#23 plan at S={s}, dh={dh}: kernel {list(out)} != {want}")


def _check_tower_plan(tk, mode, b, s, w, dh, grid=None):
    """nans_tower_plan reports the plan ops/tower_kernel.py::tower_plan
    computes (on the co-resident grid unless one is given)."""
    import ctypes

    from nans_clip_tpu_torch.ops import _build

    if grid is None:
        grid = tk.max_grid(0, mode, s, dh)
    out = (ctypes.c_int * 10)()
    _build.check(_build.library().nans_tower_plan(mode, b, s, w, 4 * w, dh, grid, out),
                 "nans_tower_plan")
    p = tk.tower_plan(mode, b, s, w, 4 * w, dh, grid)
    want = [p["ranges"], p["chunks"], p["stages"], *p["ks"], p["part"], p["sem"], p["smem"]]
    if list(out) != want:
        raise AssertionError(f"tower plan (mode {mode}, b={b}, S={s}, W={w}, grid {grid}): "
                             f"kernel {list(out)} != {want}")


def _ulps(ref, n: int) -> float:
    """n bf16 ulps at the largest magnitude of ``ref``: bf16 keeps 8
    significant bits, so one rounding flip anywhere in a chain moves an
    output by about one ulp of its magnitude."""
    top = float(ref.float().abs().max())
    return n * 2.0 ** (math.floor(math.log2(top)) - 7)


def _bound(nbytes: float, flops: float):
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    the operations over the bf16 tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _layer_cost(b, s, w, inter, weight_bytes=2.0):
    """Bytes of one layer's weights (and vectors), and its operations: the
    four products and attention's two."""
    nbytes = (4 * w * w + 2 * w * inter) * weight_bytes + (9 * w + inter) * 2
    flops = 2 * b * s * (4 * w * w + 2 * w * inter) + 4 * b * s * s * w
    return nbytes, flops


def _yard_attention(x, p, heads, eps, post_ln, kb):
    """An attention sub-block in library calls (``F.layer_norm``,
    ``F.linear``, SDPA): a yardstick of time the port never calls."""
    import torch.nn.functional as F

    b, s, w = x.shape
    ln_w, ln_b, wqkv, bqkv, wo, bo = p
    h = x if post_ln else F.layer_norm(x, (w,), ln_w, ln_b, eps)
    q, k, v = F.linear(h, wqkv, bqkv).view(b, s, 3, heads, w // heads).permute(
        2, 0, 3, 1, 4).unbind(0)
    mask = None if kb is None else kb.view(b, 1, 1, s).to(x.dtype)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    out = x + F.linear(ctx.transpose(1, 2).reshape(b, s, w), wo, bo)
    return F.layer_norm(out, (w,), ln_w, ln_b, eps) if post_ln else out


def _yard_mlp(x, p, eps, post_ln):
    """An MLP sub-block in library calls (``F.layer_norm``, ``F.linear``,
    the activation): erf-GELU post-LN, quick-GELU pre-LN."""
    import torch
    import torch.nn.functional as F

    ln_w, ln_b, w1, b1, w2, b2 = p
    w = x.shape[-1]
    h = F.linear(x if post_ln else F.layer_norm(x, (w,), ln_w, ln_b, eps), w1, b1)
    h = F.gelu(h) if post_ln else h * torch.sigmoid(1.702 * h)
    out = x + F.linear(h, w2, b2)
    return F.layer_norm(out, (w,), ln_w, ln_b, eps) if post_ln else out


def _yard_tower(x, kb, layers, heads, eps, post_ln):
    """All layers of a tower in library calls, int8 weights dequantized each
    call (as the kernel reads them each call)."""
    import torch

    from nans_clip_tpu_torch.utils.quantize import dequantize_weight

    for p in layers:
        p = tuple(t if torch.is_tensor(t) else dequantize_weight(t, x.dtype) for t in p)
        x = _yard_mlp(_yard_attention(x, p[:6], heads, eps, post_ln, kb), p[6:], eps, post_ln)
    return x


def phase_kernels(torch, dev):
    """Every kernel of the batch path against its twin, bf16, at its shapes."""
    import torch.nn.functional as F

    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.ops import layer_kernel as lk
    from nans_clip_tpu_torch.ops.attention import attention, attention_plain
    from nans_clip_tpu_torch.ops.gemm import (linear, linear_dgrad, linear_dgrad_plain,
                                              linear_plain, linear_wgrad, linear_wgrad_plain)
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
    h_fc1 = linear(xi2, pi["w1"], pi["b1"], "quick_gelu")

    def sdpa(q3, bias, s, batch=BATCH, nh=heads, dh=64, p=0.0):
        """F.scaled_dot_product_attention on the packed buffer's heads, with
        the same additive key bias (and, with p, its own dropout)."""
        q, k, v = q3.view(batch, s, 3, nh, dh).permute(2, 0, 3, 1, 4).unbind(0)
        mask = None if bias is None else bias.view(batch, 1, 1, s).to(bf)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=p)

    mi, mt = BATCH * 197, BATCH * 52
    attn_cost = lambda m, s: (m * 4 * w * 2 + 4 * w * w * 2, 2 * m * 4 * w * w + 4 * m * s * w)
    mlp_cost = lambda m: (m * 2 * w * 2 + 2 * w * inter * 2, 4 * m * w * inter)

    def gemm_cost(m, n, k, extra=0):
        """Bytes (A, W, bias, a bf16 C, plus ``extra`` a row-column) and
        operations of one forward product."""
        return (2 * (m * k + n * k + n + m * n) + extra * m * n, 2 * m * n * k)

    # the training forward's kExt form (ViT-B batch 128): fc1 with its fp32
    # pre-activation, hidden dropout 0.1, an fp32 residual and an fp32 output
    mtr = 128 * 197
    a_tr = rnd(mtr, w)
    res_tr = torch.randn(mtr, inter, generator=g, device=dev)
    spec_tr = drop.Dropout(5, 0.1, drop.STREAM_HIDDEN, 197)
    kext = dict(residual=res_tr, out_dtype=torch.float32, dropout=spec_tr, pre_out=True)
    both = lambda pair: torch.cat((pair[0].flatten(), pair[1].flatten()))

    # the wide and training attention shapes: heads of 80 at S 257 (ViT-H),
    # S 577 (ViT-L-14-336), RoBERTa-base at batch 128, masked, dropout 0.1
    g_attn = {}
    for key, (b, s_, nh, dh) in {"h": (32, 257, 16, 80), "l": (32, 577, 16, 64),
                                  "d": (128, 52, 12, 64)}.items():
        g_attn[key] = rnd(b * s_, 3 * nh * dh)
    kb_d = key_bias(52)[:128].contiguous()
    drop_d = drop.Dropout(9, 0.1, drop.STREAM_ATTN, 52)
    attn_bytes = lambda b, s_, nh, dh: b * s_ * 4 * nh * dh * 2

    # the backward forms at ViT-B's train shapes (M 25,216): input gradients
    # as ops/fused_block_bwd.py calls them, and the four weight gradients
    f32 = torch.float32
    g_tr, dqkv_tr, dh_tr = rnd(mtr, w), rnd(mtr, 3 * w), rnd(mtr, inter)
    h_pre_tr = torch.randn(mtr, inter, generator=g, device=dev)
    dgrad_kw = dict(act="quick_gelu", aux=h_pre_tr, out_dtype=f32, copy=True)
    dgrad_cost = lambda n, k, out_b, extra=0: (2 * (mtr * n + n * k) + (out_b + extra) * mtr * k,
                                               2 * mtr * n * k)
    wgrad_cost = lambda n, k: (2 * mtr * (n + k) + 4 * n * k, 2 * mtr * n * k)
    mm32 = lambda a, b_: torch.mm(a, b_, out_dtype=f32)

    # the attention backward at the train steps' shapes (ViT-B image batch
    # 128; RoBERTa-base text, masked, dropout 0.1; ViT-H-14 heads of 80; the
    # long pair at ViT-L-14-336's S 577), from the forward's row statistics
    # as the chains call it; SDPA's backward beside it
    from nans_clip_tpu_torch.ops.attention import attention_bwd, attention_bwd_plain
    from nans_clip_tpu_torch.ops.layernorm import layer_norm_bwd, layer_norm_bwd_plain
    from nans_clip_tpu_torch.ops.reduce import column_sum, column_sum_plain
    bwd_in = {"b": (128, 197, 12, 64, rnd(mtr, 3 * w), None, None)}
    for key, (b, s_, nh, dh) in {"h": (32, 257, 16, 80), "l": (32, 577, 16, 64),
                                  "d": (128, 52, 12, 64)}.items():
        bwd_in[key] = (b, s_, nh, dh, g_attn[key], kb_d if key == "d" else None,
                       drop_d if key == "d" else None)
    bwd_calls = {}
    for key, (b, s_, nh, dh, q3, bias, dp) in bwd_in.items():
        d_ctx = rnd(b * s_, nh * dh)
        st = attention(q3, bias, b, nh, dp, stats=True)[1]
        q, k, v = (t.contiguous().requires_grad_() for t in
                   q3.view(b, s_, 3, nh, dh).permute(2, 0, 3, 1, 4).unbind(0))
        mask = None if bias is None else bias.view(b, 1, 1, s_).to(bf)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           dropout_p=0.1 if dp is not None else 0.0)
        go = d_ctx.view(b, s_, nh, dh).transpose(1, 2)
        cost = (b * s_ * (4 * nh * dh * 2 + 3 * nh * dh * 6) + (b * s_ * 4 if bias is not None
                                                                else 0)
                + 2 * b * nh * s_ * 4, 10 * b * nh * s_ * s_ * dh)
        bwd_calls[key] = (
            lambda q3=q3, d_ctx=d_ctx, bias=bias, b=b, nh=nh, dp=dp, st=st:
                attention_bwd(q3, d_ctx, bias, b, nh, dp, stats=st)[0],
            lambda q3=q3, d_ctx=d_ctx, bias=bias, b=b, nh=nh, dp=dp:
                attention_bwd_plain(q3, d_ctx, bias, b, nh, dp)[0],
            lambda o=o, q=q, k=k, v=v, go=go: torch.autograd.grad(o, (q, k, v), go,
                                                                   retain_graph=True),
            cost)

    # the LayerNorm backward as the chains call it: ViT-B's image pre-LN with
    # its sums (M 25,216), RoBERTa-base's post-LN with dropout 0.1 (M 6,656),
    # ViT-H-14's pre-LN at W 1280 (M 8,224); native_layer_norm_backward on
    # fp32 copies (plus the residual add) beside it
    def ln_case(rows, width, post):
        gm = rnd(width, std=0.1, mean=1.0)
        if post:
            gin, x_ = rnd(rows, width), torch.randn(rows, width, generator=g, device=dev)
            kw = dict(out_dtype=f32, emit_dproj=True,
                      dropout=drop.Dropout(5, 0.1, drop.STREAM_HIDDEN, 52))
            eps, res, nbytes = 1e-12, None, rows * width * 12 + 3 * width * 4
        else:
            gin, x_ = torch.randn(rows, width, generator=g, device=dev), rnd(rows, width)
            res = rnd(rows, width)
            kw = dict(residual=res, out_dtype=bf)
            eps, nbytes = 1e-5, rows * width * 10 + 2 * width * 4
        g32, x32, gm32 = gin.float(), x_.float(), gm.float()
        bt32 = torch.zeros_like(gm32)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x32, [width], gm32, bt32, eps)
        r32 = None if res is None else res.float()

        def library():
            dx_ = torch.ops.aten.native_layer_norm_backward(g32, x32, [width], mean, rstd, gm32,
                                                            bt32, [True, True, True])[0]
            return dx_ if r32 is None else dx_.add_(r32)

        kern = lambda: layer_norm_bwd(gin, x_, gm, eps, **kw)
        twin = lambda: layer_norm_bwd_plain(gin, x_, gm, eps, **kw)
        return kern, twin, library, (nbytes + width * 2, 12 * rows * width)

    ln_img, ln_txt, ln_h = ln_case(mtr, w, False), ln_case(128 * 52, w, True), \
        ln_case(32 * 257, 1280, False)
    sums_of = lambda out: torch.cat([t.flatten() for t in out[1:3]])
    post_all = lambda out: torch.cat([out[0].flatten(), out[1], out[2], out[4]])
    bias_grad = torch.randn(mtr, 3 * w, generator=g, device=dev)
    ln_parts = torch.randn(263, 2 * w, generator=g, device=dev)
    # (entry name, kernel call, twin call, bound: bf16 ulps, "fp32" (1e-5 of
    #  max|twin|) or a float (that fraction of max|twin|), JSON fields or None,
    #  library call or None, (bytes, operations))
    cases = [
        ("fused_attention_block", lambda: fb.fused_attention_block(xi, *attn_args(pi), heads),
         lambda: fb._reference_block(xi, *attn_args(pi), heads, 1e-5), 4,
         ("nans_clip_tpu_torch/ops/fused_block.py", "nans_clip_tpu/ops/fused_block.py:103"),
         None, attn_cost(mi, 197)),
        ("fused_bert_attention_block",
         lambda: fb.fused_bert_attention_block(xt, *attn_args(pt), kb, heads),
         lambda: fb._reference_block(xt, *attn_args(pt), heads, 1e-12, kb, True), 4, None,
         None, attn_cost(mt, 52)),
        ("fused_mlp_block", lambda: fb.fused_mlp_block(xi, *mlp_args(pi)),
         lambda: fb._reference_mlp(xi, *mlp_args(pi), "quick_gelu", 1e-5, False), 4,
         ("nans_clip_tpu_torch/ops/fused_block.py", "nans_clip_tpu/ops/fused_block.py:797"),
         None, mlp_cost(mi)),
        ("fused_mlp_block[post-LN, S=52]",
         lambda: fb.fused_mlp_block(xt, *mlp_args(pt), "gelu", 1e-12, True),
         lambda: fb._reference_mlp(xt, *mlp_args(pt), "gelu", 1e-12, True), 4, None,
         None, mlp_cost(mt)),
        ("fused_layer_block",
         lambda: lk.fused_layer_block(xt, *layer_args(pt), heads, 1e-12, "gelu", True, kb),
         lambda: lk.encoder_layer_math(xt, *layer_args(pt), heads, 1e-12, "gelu", True, kb), 4,
         ("nans_clip_tpu_torch/ops/layer_kernel.py", "nans_clip_tpu/ops/layer_kernel.py:116"),
         None, tuple(a + b for a, b in zip(attn_cost(mt, 52), mlp_cost(mt)))),
        ("layernorm", lambda: row_layer_norm(xi2, pi["ln1_w"], pi["ln1_b"], 1e-5),
         lambda: layer_norm(xi2, pi["ln1_w"], pi["ln1_b"], 1e-5), 1,
         ("nans_clip_tpu_torch/csrc/layernorm.cu", "nans_clip_tpu/ops/fused_block.py:96"),
         lambda: F.layer_norm(xi2, (w,), pi["ln1_w"], pi["ln1_b"], 1e-5),
         (mi * w * 4 + 2 * w * 2, 8 * mi * w)),
        ("gemm", lambda: linear(xi2, pi["w1"], pi["b1"], "quick_gelu"),
         lambda: linear_plain(xi2, pi["w1"], pi["b1"], "quick_gelu"), 1,
         ("nans_clip_tpu_torch/csrc/gemm.cu", "nans_clip_tpu/ops/fused_block.py:809"),
         lambda: F.linear(xi2, pi["w1"], pi["b1"]),
         ((mi * w + inter * w + inter + mi * inter) * 2, 2 * mi * inter * w)),
        ("attention", lambda: attention(qkv, None, BATCH, heads),
         lambda: attention_plain(qkv, None, BATCH, heads), 1,
         ("nans_clip_tpu_torch/csrc/attention.cu", "nans_clip_tpu/ops/fused_block.py:164"),
         lambda: sdpa(qkv, None, 197), (mi * 4 * w * 2, 4 * BATCH * 197 * 197 * w)),
        ("attention[masked, S=52]", lambda: attention(qkv_t, kb, BATCH, heads),
         lambda: attention_plain(qkv_t, kb, BATCH, heads), 1, None,
         lambda: sdpa(qkv_t, kb, 52), (mt * 4 * w * 2 + mt * 4, 4 * BATCH * 52 * 52 * w)),
        # the other forward products of the batch path and one training form
        ("gemm[qkv]", lambda: linear(xi2, pi["w_qkv"], pi["b_qkv"]),
         lambda: linear_plain(xi2, pi["w_qkv"], pi["b_qkv"]), 1, None,
         lambda: F.linear(xi2, pi["w_qkv"], pi["b_qkv"]), gemm_cost(mi, 3 * w, w)),
        ("gemm[out_proj + residual]", lambda: linear(xi2, pi["w_o"], pi["b_o"], residual=xi2),
         lambda: linear_plain(xi2, pi["w_o"], pi["b_o"], residual=xi2), 1, None,
         lambda: F.linear(xi2, pi["w_o"], pi["b_o"]), gemm_cost(mi, w, w, 2)),
        ("gemm[fc2 + residual]", lambda: linear(h_fc1, pi["w2"], pi["b2"], residual=xi2),
         lambda: linear_plain(h_fc1, pi["w2"], pi["b2"], residual=xi2), 1, None,
         lambda: F.linear(h_fc1, pi["w2"], pi["b2"]), gemm_cost(mi, w, inter, 2)),
        ("gemm[train fc1: c_pre, dropout 0.1, fp32 residual, M 25,216]",
         lambda: both(linear(a_tr, pi["w1"], pi["b1"], "quick_gelu", **kext)),
         lambda: both(linear_plain(a_tr, pi["w1"], pi["b1"], "quick_gelu", **kext)), 1, None,
         lambda: F.linear(a_tr, pi["w1"], pi["b1"]), gemm_cost(mtr, inter, w, 4 + 4 + 2)),
        ("attention[heads of 80, S=257]", lambda: attention(g_attn["h"], None, 32, 16),
         lambda: attention_plain(g_attn["h"], None, 32, 16), 1, None,
         lambda: sdpa(g_attn["h"], None, 257, 32, 16, 80),
         (attn_bytes(32, 257, 16, 80), 4 * 32 * 257 * 257 * 1280)),
        ("attention[S=577]", lambda: attention(g_attn["l"], None, 32, 16),
         lambda: attention_plain(g_attn["l"], None, 32, 16), 1, None,
         lambda: sdpa(g_attn["l"], None, 577, 32, 16, 64),
         (attn_bytes(32, 577, 16, 64), 4 * 32 * 577 * 577 * 1024)),
        ("attention[masked, dropout 0.1, (128, 12, 52, 64)]",
         lambda: attention(g_attn["d"], kb_d, 128, heads, drop_d),
         lambda: attention_plain(g_attn["d"], kb_d, 128, heads, drop_d), 1, None,
         lambda: sdpa(g_attn["d"], kb_d, 52, 128, heads, 64, 0.1),
         (attn_bytes(128, 52, 12, 64) + 128 * 52 * 4, 4 * 128 * 52 * 52 * w)),
        ("gemm_dgrad", lambda: linear_dgrad(a_tr, pi["w2"], **dgrad_kw)[0],
         lambda: linear_dgrad_plain(a_tr, pi["w2"], **dgrad_kw)[0], "fp32",
         ("nans_clip_tpu_torch/csrc/gemm.cu", "nans_clip_tpu/ops/fused_block_bwd.py:763"),
         lambda: mm32(a_tr, pi["w2"]), dgrad_cost(w, inter, 4, 4 + 2)),
        ("gemm_dgrad[dh copy, bf16]", lambda: linear_dgrad(a_tr, pi["w2"], **dgrad_kw)[1],
         lambda: linear_dgrad_plain(a_tr, pi["w2"], **dgrad_kw)[1], 2, None,
         lambda: torch.mm(a_tr, pi["w2"]), dgrad_cost(w, inter, 4, 4 + 2)),
        ("gemm_dgrad[dctx = g . Wo]", lambda: linear_dgrad(g_tr, pi["w_o"]),
         lambda: linear_dgrad_plain(g_tr, pi["w_o"]), 2, None,
         lambda: torch.mm(g_tr, pi["w_o"]), dgrad_cost(w, w, 2)),
        ("gemm_dgrad[dxn = dqkv . Wqkv, fp32]",
         lambda: linear_dgrad(dqkv_tr, pi["w_qkv"], out_dtype=f32),
         lambda: linear_dgrad_plain(dqkv_tr, pi["w_qkv"], out_dtype=f32), "fp32", None,
         lambda: mm32(dqkv_tr, pi["w_qkv"]), dgrad_cost(3 * w, w, 4)),
        ("gemm_dgrad[dx = dh . W1, fp32]", lambda: linear_dgrad(dh_tr, pi["w1"], out_dtype=f32),
         lambda: linear_dgrad_plain(dh_tr, pi["w1"], out_dtype=f32), "fp32", None,
         lambda: mm32(dh_tr, pi["w1"]), dgrad_cost(inter, w, 4)),
        ("gemm_wgrad", lambda: linear_wgrad(dh_tr, a_tr), lambda: linear_wgrad_plain(dh_tr, a_tr),
         "fp32", ("nans_clip_tpu_torch/csrc/gemm.cu", "nans_clip_tpu/ops/fused_block_bwd.py:909"),
         lambda: mm32(dh_tr.T, a_tr), wgrad_cost(inter, w)),
        ("gemm_wgrad[dWqkv]", lambda: linear_wgrad(dqkv_tr, a_tr),
         lambda: linear_wgrad_plain(dqkv_tr, a_tr), "fp32", None,
         lambda: mm32(dqkv_tr.T, a_tr), wgrad_cost(3 * w, w)),
        ("gemm_wgrad[dWo]", lambda: linear_wgrad(g_tr, a_tr),
         lambda: linear_wgrad_plain(g_tr, a_tr), "fp32", None, lambda: mm32(g_tr.T, a_tr),
         wgrad_cost(w, w)),
        ("gemm_wgrad[dW2]", lambda: linear_wgrad(g_tr, dh_tr),
         lambda: linear_wgrad_plain(g_tr, dh_tr), "fp32", None,
         lambda: mm32(g_tr.T, dh_tr), wgrad_cost(w, inter)),
        # the backward's attention, LayerNorm and column sums (dqkv within
        # 1e-2 of its largest magnitude: a bf16 flip of dS or P_d moves a sum
        # by an ulp of a term; the attention's the same bits on a second call)
        ("attention_bwd", *bwd_calls["b"][:2], 1e-2,
         ("nans_clip_tpu_torch/csrc/attention.cu", "nans_clip_tpu/ops/fused_block_bwd.py:165"),
         *bwd_calls["b"][2:]),
        ("attention_bwd[masked, dropout 0.1, (128, 12, 52, 64)]", *bwd_calls["d"][:2], 1e-2,
         None, *bwd_calls["d"][2:]),
        ("attention_bwd[heads of 80, (32, 16, 257, 80)]", *bwd_calls["h"][:2], 1e-2, None,
         *bwd_calls["h"][2:]),
        ("attention_bwd_long", *bwd_calls["l"][:2], 1e-2,
         ("nans_clip_tpu_torch/csrc/attention.cu", "nans_clip_tpu/ops/fused_block_bwd.py:1163"),
         *bwd_calls["l"][2:]),
        ("layernorm_bwd", lambda: ln_img[0]()[0], lambda: ln_img[1]()[0], 2,
         ("nans_clip_tpu_torch/csrc/layernorm.cu", "nans_clip_tpu/ops/fused_block_bwd.py:101"),
         ln_img[2], ln_img[3]),
        ("layernorm_bwd[dgamma, dbeta]", lambda: sums_of(ln_img[0]()),
         lambda: sums_of(ln_img[1]()), "fp32", None, ln_img[2], ln_img[3]),
        ("layernorm_bwd[post-LN, dropout 0.1, [6656, 768]: dx, sums]",
         lambda: post_all(ln_txt[0]()), lambda: post_all(ln_txt[1]()), "fp32", None, ln_txt[2],
         ln_txt[3]),
        ("layernorm_bwd[W 1280, [8224, 1280]]", lambda: ln_h[0]()[0], lambda: ln_h[1]()[0], 2,
         None, ln_h[2], ln_h[3]),
        ("column_sum", lambda: column_sum(bias_grad), lambda: column_sum_plain(bias_grad),
         "fp32", ("nans_clip_tpu_torch/csrc/reduce.cu",
                  "nans_clip_tpu/ops/fused_block_bwd.py:263"),
         lambda: torch.sum(bias_grad, 0), ((mtr + 1) * 3 * w * 4, mtr * 3 * w)),
        ("column_sum[LayerNorm partials, [263, 1536]]", lambda: column_sum(ln_parts),
         lambda: column_sum_plain(ln_parts), "fp32", None, lambda: torch.sum(ln_parts, 0),
         (264 * 2 * w * 4, 263 * 2 * w)),
    ]
    # the sub-blocks in library calls (no one call computes them): yardsticks
    yards = {"fused_attention_block": lambda: _yard_attention(xi, attn_args(pi), heads, 1e-5,
                                                              False, None),
             "fused_mlp_block": lambda: _yard_mlp(xi, mlp_args(pi), 1e-5, False),
             "fused_layer_block": lambda: _yard_mlp(
                 _yard_attention(xt, attn_args(pt), heads, 1e-12, True, kb), mlp_args(pt),
                 1e-12, True)}
    results = {}
    for name, kern, twin, n_ulps, meta, library, cost in cases:
        got, want = kern(), twin()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        bound = (1e-5 * top if n_ulps == "fp32" else n_ulps * top if isinstance(n_ulps, float)
                 else _ulps(want, n_ulps))
        if not (torch.isfinite(got).all() and err <= bound):
            raise AssertionError(f"{name}: max abs err {err} exceeds bound {bound}")
        if name.startswith("attention_bwd") and not torch.equal(got, kern()):
            raise AssertionError(f"{name}: two calls gave different bits")
        ms, plain_ms = _time_ms(kern, 10), _time_ms(twin, 3)
        library_ms = None if library is None else _time_ms(library, 10)
        yard_ms = _time_ms(yards[name], 10) if name in yards else None
        bound_ms, bound_by = _bound(*cost)
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        if yard_ms is not None:
            lib += f", yardstick {yard_ms:.4f} ms (F.layer_norm/F.linear/SDPA/act)"
        what = ("1e-5" if n_ulps == "fp32" else f"{n_ulps:g}" if isinstance(n_ulps, float)
                else f"{n_ulps} bf16 ulp")
        print(f"kernel {name}: max_abs_err {err:.6g} <= bound {bound:.6g} ({what} "
              f"of max|twin| {top:.4g}); {ms:.4f} ms, "
              f"twin {plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms, meta=meta, library_ms=library_ms,
                             yard_ms=yard_ms, bound_ms=bound_ms, bound_by=bound_by)
    return results


# Bound of the tower kernel against its twin over 12 layers: each layer's
# rounding flips (bf16 roundings of q/k/v, P, ctx, a, h and x at another fp32
# sum order) move an output by about one ulp, and the flips of independent
# layers add like a random walk, sqrt(12) ~ 3.5 ulps; 8 ulps allows twice
# that. The twin's own distance from an fp32 run of the same weights is
# printed beside it for scale.
TOWER_ULPS = 8


def phase_towers(torch, dev):
    """The whole-tower kernel (bf16 and int8) against its twin, both forms,
    batch 1, 8, 32; the per-layer route's time beside it."""
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.ops import layer_kernel as lk
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    from nans_clip_tpu_torch.utils.quantize import dequantize_weight, quantize_weight

    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    n_layers, w, inter, heads = 12, 768, 3072, 12

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

    def layers(std):
        return [(rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(3 * w, w, std=std),
                 rnd(3 * w, std=0.1), rnd(w, w, std=std), rnd(w, std=0.1),
                 rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(inter, w, std=std),
                 rnd(inter, std=0.1), rnd(w, inter, std=std / 2), rnd(w, std=0.1))
                for _ in range(n_layers)]

    def quantized(ls):
        return [tuple(quantize_weight(t) if i in (2, 4, 8, 10) else t for i, t in enumerate(p))
                for p in ls]

    forms = {"text": (layers(0.02), 52, True), "image": (layers(w ** -0.5), 197, False)}
    results = {}
    for form, (bf_layers, s, post_ln) in forms.items():
        eps, act = (1e-12, "gelu") if post_ln else (1e-5, "quick_gelu")
        for quant in (False, True):
            ls = quantized(bf_layers) if quant else bf_layers
            for b in (1, 8, 32):
                x = rnd(b, s, w)
                kb = None
                if post_ln:
                    lengths = torch.randint(2, s + 1, (b,), generator=g, device=dev)
                    keep = torch.arange(s, device=dev)[None, :] < lengths[:, None]
                    kb = ((1.0 - keep.float()) * -10000.0).contiguous()
                args = (x, kb, ls, heads, eps, act, post_ln)
                _check_tower_plan(tk, tk.MODE_INT8 if quant else tk.MODE_BF16, b, s, w, 64)
                table = tk.TowerTable()
                got = tk.fused_tower(*args, table=table)
                want = tk.tower_math(*args)
                f32 = [tuple(t.float() if torch.is_tensor(t) else dequantize_weight(t, torch.float32)
                             for t in p) for p in ls]
                ref32 = tk.tower_math(x.float(), kb, f32, heads, eps, act, post_ln)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                err32 = float((want.float() - ref32).abs().max())
                bound = _ulps(want, TOWER_ULPS)
                name = f"fused_tower{'_int8' if quant else ''}[{form}, b={b}]"
                if not (got.shape == x.shape and torch.isfinite(got).all() and err <= bound):
                    raise AssertionError(f"{name}: max abs err {err} exceeds bound {bound}")

                def per_layer():
                    """Today's route at this batch: int8 weights dequantized on
                    entry, then the per-layer kernels."""
                    y = x
                    for p in ls:
                        p = tuple(t if torch.is_tensor(t) else dequantize_weight(t, bf) for t in p)
                        if post_ln:
                            y = lk.fused_layer_block(y, *p, heads, eps, act, True, kb)
                        else:
                            y = fb.fused_mlp_block(fb.fused_attention_block(y, *p[:6], heads),
                                                   *p[6:])
                    return y

                ms = _time_ms(lambda: tk.fused_tower(*args, table=table), 20)
                plain_ms = _time_ms(lambda: tk.tower_math(*args), 2)
                layer_ms = _time_ms(per_layer, 10)
                yard_ms = _time_ms(lambda: _yard_tower(x, kb, ls, heads, eps, post_ln), 10)
                nbytes, flops = _layer_cost(b, s, w, inter, 1.0 if quant else 2.0)
                if quant:
                    nbytes += (4 * w + 2 * inter) * 4       # the fp32 scales
                bound_ms, bound_by = _bound(n_layers * nbytes + 2 * b * s * w * 2,
                                            n_layers * flops)
                print(f"tower {name}: max_abs_err {err:.6g} <= bound {bound:.6g} ({TOWER_ULPS} "
                      f"bf16 ulp of max|twin| {float(want.float().abs().max()):.4g}; twin vs "
                      f"fp32 {err32:.4g}); {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
                      f"{bound_ms:.4f} ms ({bound_by}), per-layer route {layer_ms:.4f} ms, "
                      f"yardstick {yard_ms:.4f} ms (the layers in F.layer_norm/F.linear/SDPA); "
                      f"grid {tk.max_grid(dev.index, quant, s)} blocks", flush=True)
                results[(form, quant, b)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                                 bound_ms=bound_ms, bound_by=bound_by,
                                                 layer_ms=layer_ms, yard_ms=yard_ms)
    # the gate's evidence: the largest measured batch with the tower no slower
    for form in forms:
        for quant in (False, True):
            ok = [b for b in (1, 8, 32) if results[(form, quant, b)]["ms"]
                  <= results[(form, quant, b)]["layer_ms"]]
            print(f"tower gate evidence [{form}{', int8' if quant else ''}]: tower no slower "
                  f"than the per-layer route at batch {ok or 'none'}", flush=True)
    return results


def _counted():
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.ops import layer_kernel as lk
    from nans_clip_tpu_torch.ops.attention import attention
    from nans_clip_tpu_torch.ops.gemm import linear
    from nans_clip_tpu_torch.ops.layernorm import row_layer_norm

    return {"fused_attention_block": fb.fused_attention_block,
            "fused_bert_attention_block": fb.fused_bert_attention_block,
            "fused_mlp_block": fb.fused_mlp_block, "fused_layer_block": lk.fused_layer_block,
            "layernorm": row_layer_norm, "gemm": linear, "attention": attention}


def _tower_counts():
    from nans_clip_tpu_torch.ops.tower_kernel import fused_tower

    return {"fused_tower": fused_tower.launches, "fused_tower_int8": fused_tower.launches_int8,
            "fused_tower_int8_qdma": fused_tower.launches_qdma}


def _reset_counts():
    from nans_clip_tpu_torch.ops.tower_kernel import fused_tower

    for fn in _counted().values():
        fn.launches = 0
    fused_tower.launches = fused_tower.launches_int8 = fused_tower.launches_qdma = 0


def phase_slice(torch, dev, ckpt):
    import nans_clip_tpu_torch as nct

    cfg = nct.load_config(f"{VISION}@{TEXT}")
    layers = cfg.vision.layers
    assert layers == cfg.text.num_hidden_layers == 12
    load = lambda **kw: nct.load_from_name(
        ckpt, vision_model_name=VISION, text_model_name=TEXT, input_resolution=224,
        device=dev, options=nct.ModelOptions(**kw))[0]
    model = load(compute_dtype="bfloat16")
    plain = load(compute_dtype="bfloat16", attn_impl="plain")
    ref32 = load(attn_impl="plain")

    gen = torch.Generator().manual_seed(1)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen).to(dev)
    ids = torch.from_numpy(nct.tokenize((TEXTS * BATCH)[:BATCH])).to(dev)

    _reset_counts()
    li, lt = model.get_similarity(images, ids)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in _counted().items()}
    launches.update(_tower_counts())
    expected = {"fused_attention_block": layers, "fused_bert_attention_block": 0,
                "fused_mlp_block": layers, "fused_layer_block": layers,
                "layernorm": 4 * layers, "gemm": 8 * layers, "attention": 2 * layers,
                "fused_tower": 0, "fused_tower_int8": 0, "fused_tower_int8_qdma": 0}
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


def phase_serving(torch, ckpt):
    """The serving path at batch 1-32 through the entry points users call."""
    import numpy as np

    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.deploy import speed_benchmark
    from nans_clip_tpu_torch.deploy.server import ClipService, make_server

    model, _ = nct.load_from_name(ckpt, vision_model_name=VISION, text_model_name=TEXT,
                                  input_resolution=224,
                                  options=nct.ModelOptions(compute_dtype="bfloat16"))
    if model.device.type != "cuda":
        raise AssertionError(f"load_from_name's default device is {model.device}, not the card")
    q_text = model.quantize("int8", towers=("text",))
    gen = torch.Generator().manual_seed(3)
    image = torch.randn(1, 224, 224, 3, generator=gen)
    ids = torch.from_numpy(nct.tokenize(TEXTS[:1]))

    # the main path: batch-1 encodes, counted from 0
    _reset_counts()
    feats = {"bf16": (model.encode_text(ids), model.encode_image(image)),
             "int8-text": (q_text.encode_text(ids), q_text.encode_image(image))}
    torch.cuda.synchronize()
    per_layer = {name: fn.launches for name, fn in _counted().items()}
    towers = _tower_counts()
    print(f"serving: batch-1 launches {json.dumps(towers)}, per-layer {json.dumps(per_layer)}",
          flush=True)
    if towers != {"fused_tower": 3, "fused_tower_int8": 1, "fused_tower_int8_qdma": 0} \
            or any(per_layer.values()):
        raise AssertionError("each batch-1 encode must be one tower launch (int8 for the "
                             f"quantized text tower) and no per-layer launch: {towers}, "
                             f"{per_layer}")
    for mode, (txt, img) in feats.items():
        if txt.shape != (1, 512) or img.shape != (1, 512) or not (
                torch.isfinite(txt).all() and torch.isfinite(img).all()):
            raise AssertionError(f"{mode}: features {tuple(txt.shape)}, {tuple(img.shape)}")
    # int8-text against bf16: the same model up to weight rounding (<= half a
    # step of 1/127 of each channel's largest weight); cosine >= 0.99
    cos = float(torch.nn.functional.cosine_similarity(feats["bf16"][0].float(),
                                                      feats["int8-text"][0].float()))
    same_img = torch.equal(feats["bf16"][1], feats["int8-text"][1])
    print(f"serving: int8-text vs bf16 text-feature cosine {cos:.6f} >= 0.99; image features "
          f"equal: {same_img}", flush=True)
    if cos < 0.99 or not same_img:
        raise AssertionError("the int8 text tower drifted, or the image tower changed")

    # latency through speed_benchmark's own functions
    latency = {}
    for label, m in (("bf16", model), ("int8-text", q_text)):
        latency[label] = speed_benchmark.bench_model(m, [1, 8, 32], n=30, warmup=3,
                                                     label=f"{VISION} {label}")

    # the HTTP daemon: 8 concurrent one-text requests
    service = ClipService(model, max_batch=32)
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    texts = [f"{t}{i}" for i, t in enumerate((TEXTS * 2)[:8])]
    results, errors = {}, []

    def post(i):
        try:
            req = urllib.request.Request(url + "/encode_text",
                                         json.dumps({"texts": [texts[i]]}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = np.asarray(json.loads(r.read())["features"], np.float32)
        except Exception as e:  # collected and raised below
            errors.append(e)

    try:
        posts = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in posts:
            t.start()
        for t in posts:
            t.join(180)
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(60)
    if errors or len(results) != 8:
        raise AssertionError(f"HTTP requests failed: {errors}")
    direct = model.encode_text(torch.from_numpy(nct.tokenize(texts))).float()
    direct = (direct / torch.linalg.vector_norm(direct, dim=-1, keepdim=True)).cpu().numpy()
    got = np.concatenate([results[i] for i in range(8)])
    err = float(np.abs(got - direct).max())
    norm_err = float(np.abs(np.linalg.norm(got, axis=-1) - 1.0).max())
    # The daemon pads to a power-of-two bucket and coalesces, so a text goes
    # through another batch than the direct call: another route or K-split,
    # other fp32 sum orders and bf16 flips over 12 layers. Unit features of
    # 512 components are ~0.044 each; 0.01 is a quarter of that.
    bound = 0.01
    print(f"serving: HTTP /encode_text x8 concurrent vs direct encode_text max abs err {err:.6g} "
          f"<= bound {bound}; |norm - 1| {norm_err:.3g}; stats {json.dumps(stats)}; "
          f"health {json.dumps(health)}", flush=True)
    if err > bound or norm_err > 1e-4:
        raise AssertionError("daemon features differ from direct encode_text")
    if stats["requests"]["text"] != 8 or stats["samples"]["text"] != 8 \
            or stats["device_dispatches"] < 1 or stats["errors"] != 0:
        raise AssertionError(f"unexpected /stats {stats}")
    if health.get("status") != "ok" or not health.get("device", "").startswith("cuda"):
        raise AssertionError(f"unexpected /health {health}")
    return towers, latency


TRAIN_BATCH = 128
# Bound of a backward chain against its twin, for each of its outputs: 2e-2 of
# the twin's largest magnitude. The chain rounds the recomputed activations,
# dqkv, dS, P_d, dproj and dh_pre to bf16 as the twin does, but at other fp32
# sum orders; a rounding flip moves a term by one bf16 ulp (2^-8 relative),
# and the flips of the 25,216 rows of a weight gradient add like a random
# walk. The same bound holds the chains in tests/test_torch_cuda.py.
BWD_REL = 2e-2
# Kernel route against the plain route after one train step of the whole
# model: the loss within 1e-2 (the forwards differ by bf16 rounding flips
# through 12 layers; the loss is ~4.85), and every gradient tensor at cosine
# >= 0.99 with its plain twin, except the key-projection biases, whose
# gradient is 0 in exact arithmetic (softmax ignores a shift shared by all
# keys) and so is rounding noise on both routes.
STEP_LOSS_BOUND, GRAD_COS_BOUND = 1e-2, 0.99


def _bwd_cost(b, s, mat: int, vec: int, flops: float, extra_bytes: float = 0.0):
    """(bytes, operations) of one backward chain: x and g read and dx
    written in bf16, ``mat`` + ``vec`` weights read in bf16 and their
    gradients written in fp32."""
    return 3 * b * s * 768 * 2 + (mat + vec) * (2 + 4) + extra_bytes, flops


def phase_training(torch, dev, tmp):
    """Phase 7: the backward kernels, then the one-GPU train step."""
    import copy

    import torch.nn.functional as F

    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
    from nans_clip_tpu_torch.ops.attention import attention
    from nans_clip_tpu_torch.ops.gemm import linear
    from nans_clip_tpu_torch.training import TrainConfig, create_train_state, make_train_step
    from nans_clip_tpu_torch.utils.checkpoint import save_torch_checkpoint

    g = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    b, w, inter, heads = TRAIN_BATCH, 768, 3072, 12

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

    def params(std):
        return (rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(3 * w, w, std=std),
                rnd(3 * w, std=0.1), rnd(w, w, std=std), rnd(w, std=0.1),
                rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(inter, w, std=std),
                rnd(inter, std=0.1), rnd(w, inter, std=std / 2), rnd(w, std=0.1))

    pi, pt = params(w ** -0.5), params(0.02)
    xi, gi = rnd(b, 197, w), rnd(b, 197, w)
    xt, gt = rnd(b, 52, w), rnd(b, 52, w)
    lengths = torch.randint(2, 53, (b,), generator=g, device=dev)
    kb = ((1.0 - (torch.arange(52, device=dev)[None, :] < lengths[:, None]).float())
          * -10000.0).contiguous()
    rate = 0.1

    def yardstick(x, gout, p, s, post_ln, mlp, act=None):
        """torch.autograd through the sub-block written with F.layer_norm,
        F.linear and SDPA, forward and backward (a yardstick of speed only)."""
        xr = x.detach().requires_grad_()
        ps = [t.detach().requires_grad_() for t in p]
        eps = 1e-12 if post_ln else 1e-5
        mask = None if not post_ln else kb.view(b, 1, 1, s).to(bf)

        def run():
            ln = lambda t: F.layer_norm(t, (w,), ps[0], ps[1], eps)
            xn = xr if post_ln else ln(xr)
            if mlp:
                h = F.linear(xn, ps[2], ps[3])
                h = h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else F.gelu(h)
                y = F.linear(h, ps[4], ps[5])
            else:
                q, k, v = F.linear(xn, ps[2], ps[3]).view(b, s, 3, heads, 64).permute(
                    2, 0, 3, 1, 4).unbind(0)
                ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                     dropout_p=rate if post_ln else 0.0)
                y = F.linear(ctx.transpose(1, 2).reshape(b, s, w), ps[4], ps[5])
            out = ln(xr + F.dropout(y, rate)) if post_ln else xr + y
            return torch.autograd.grad(out, [xr, *ps], gout)
        return run

    zero_bo = torch.zeros(w, device=dev, dtype=bf)
    bs_i, bs_t = b * 197, b * 52
    attn_flops = lambda bs, s, n: n * bs * w * w + 12 * bs * s * w
    # (name, kernel call, twin call, yardstick, (bytes, operations), JSON meta)
    cases = [
        ("fused_attention_block_bwd_fullgrad",
         lambda: fbb.fused_attention_block_bwd_fullgrad(xi, *pi[:5], gi, heads, 1e-5),
         lambda: fbb._attn_bwd_math(xi, *pi[:5], gi, heads, 1e-5),
         yardstick(xi, gi, pi[:4] + (pi[4], zero_bo), 197, False, False),
         _bwd_cost(b, 197, 4 * w * w, 6 * w, attn_flops(bs_i, 197, 22)),
         "nans_clip_tpu/ops/fused_block_bwd.py:229"),
        ("fused_bert_attention_block_bwd_fullgrad",
         lambda: fbb.fused_bert_attention_block_bwd_fullgrad(xt, *pt[:6], kb, 1234, gt, heads,
                                                             1e-12, rate, rate),
         lambda: fbb._bert_bwd_math(xt, *pt[:6], kb, 1234, gt, heads, 1e-12, rate, rate),
         yardstick(xt, gt, pt[:6], 52, True, False),
         _bwd_cost(b, 52, 4 * w * w, 6 * w, attn_flops(bs_t, 52, 24), b * 52 * 4),
         "nans_clip_tpu/ops/fused_block_bwd.py:404"),
        ("fused_mlp_block_bwd_fullgrad",
         lambda: fbb.fused_mlp_block_bwd_fullgrad(xi, *pi[6:], None, gi, "quick_gelu", 1e-5,
                                                  False, 0.0),
         lambda: fbb._mlp_bwd_math(xi, *pi[6:], None, gi, "quick_gelu", 1e-5, False, 0.0),
         yardstick(xi, gi, pi[6:], 197, False, True, "quick_gelu"),
         _bwd_cost(b, 197, 2 * w * inter, 4 * w + inter, 10 * bs_i * w * inter),
         "nans_clip_tpu/ops/fused_block_bwd.py:894"),
        ("fused_mlp_block_bwd_fullgrad[post-LN, S=52]",
         lambda: fbb.fused_mlp_block_bwd_fullgrad(xt, *pt[6:], 99, gt, "gelu", 1e-12, True,
                                                  rate),
         lambda: fbb._mlp_bwd_math(xt, *pt[6:], 99, gt, "gelu", 1e-12, True, rate),
         yardstick(xt, gt, pt[6:], 52, True, True, "gelu"),
         _bwd_cost(b, 52, 2 * w * inter, 4 * w + inter, 12 * bs_t * w * inter), None),
    ]
    results = {}
    for name, kern, twin, yard, cost, replaces in cases:
        got, want = kern(), twin()
        torch.cuda.synchronize()
        errs = []
        for i, (a, r) in enumerate(zip(got, want)):
            err, top = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
            if a.shape != r.shape or not torch.isfinite(a).all() or err > BWD_REL * top:
                raise AssertionError(f"{name} output {i}: max abs err {err} exceeds "
                                     f"{BWD_REL} x {top}")
            errs.append(err / max(top, 1e-30))
        if not all(torch.equal(a, r) for a, r in zip(got, kern())):
            raise AssertionError(f"{name}: two calls gave different bits")
        err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, want))
        ms, plain_ms, yard_ms = _time_ms(kern, 5), _time_ms(twin, 2), _time_ms(yard, 5)
        bound_ms, bound_by = _bound(*cost)
        print(f"training kernel {name}: max_abs_err {err:.6g}, largest error over max|twin| "
              f"{max(errs):.4g} <= {BWD_REL} on each of 7 outputs; {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms, yardstick {yard_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {cost[1] / 1e9:.1f} GFLOP, {cost[0] / 1e6:.1f} MB)", flush=True)
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms, yard_ms=yard_ms,
                             bound_ms=bound_ms, bound_by=bound_by, replaces=replaces)

    # #1/#2 with dropout against their twins, and the kernels' keep masks
    args_a = (xt, *pt[:6], kb, heads, 1e-12, 1234, rate, rate)
    got = fb.fused_bert_attention_block(*args_a)
    want = fb._reference_block(xt, *pt[:6], heads, 1e-12, kb, True, 1234, rate, rate)
    got_m = fb.fused_mlp_block(xt, *pt[6:], "gelu", 1e-12, True, 99, rate)
    want_m = fb._reference_mlp(xt, *pt[6:], "gelu", 1e-12, True, 99, rate)
    for name, a, r in (("fused_bert_attention_block", got, want),
                       ("fused_mlp_block[post-LN]", got_m, want_m)):
        err, bound = float((a.float() - r.float()).abs().max()), _ulps(r, 4)
        print(f"training kernel {name} with dropout {rate}: max_abs_err {err:.6g} <= bound "
              f"{bound:.6g} (4 bf16 ulp)", flush=True)
        if not (torch.isfinite(a).all() and err <= bound):
            raise AssertionError(f"{name} with dropout: max abs err {err} exceeds {bound}")
    spec_h = drop.Dropout(77, rate, drop.STREAM_HIDDEN, 52)
    mult = linear(torch.zeros(bs_t, w, device=dev, dtype=bf), pt[4],
                  torch.ones(w, device=dev, dtype=bf), out_dtype=torch.float32, dropout=spec_h)
    same_h = torch.equal(mult, drop.hidden_multiplier(spec_h, bs_t, w, dev))
    # attention: Q = K = 0 and V one-hot over the keys, so ctx[q, d] > 0
    # exactly where the kernel kept P[q, key d]
    spec_a = drop.Dropout(78, rate, drop.STREAM_ATTN)
    qkv = torch.zeros(b, 52, 3, heads, 64, device=dev, dtype=bf)
    qkv[:, :, 2, :, :52] = torch.eye(52, device=dev, dtype=bf)[None, :, None, :]
    kept = attention(qkv.view(bs_t, 3 * w), None, b, heads, spec_a).view(b, 52, heads, 64)
    kept = kept[..., :52].permute(0, 2, 1, 3) > 0
    same_a = torch.equal(kept, drop.attention_multiplier(spec_a, b, heads, 52, dev) > 0)
    keep_h, keep_a = float((mult > 0).float().mean()), float(kept.float().mean())
    print(f"training dropout: keep fraction hidden {keep_h:.5f} ({mult.numel()} draws, gemm.cu), "
          f"attention {keep_a:.5f} ({kept.numel()} draws, attention.cu), against {1 - rate}; "
          f"kernel masks equal the twin's: {same_h and same_a}", flush=True)
    if not (same_h and same_a and abs(keep_h - 0.9) < 2e-3 and abs(keep_a - 0.9) < 2e-3):
        raise AssertionError("the kernels' dropout masks differ from the twin's or keep "
                             "another fraction than 0.9")
    del xi, gi, xt, gt, pi, pt, qkv, mult, kept

    # the train step
    cfg = nct.load_config(f"{VISION}@{TEXT}")
    assert (cfg.text.hidden_dropout_prob, cfg.text.attention_probs_dropout_prob) == (rate, rate)
    gen = torch.Generator().manual_seed(5)
    images = torch.randn(b, 224, 224, 3, generator=gen).to(dev)
    ids = torch.from_numpy(nct.tokenize([f"{TEXTS[i % len(TEXTS)]}{i}" for i in range(b)]))
    ids = ids.to(dev)
    tcfg = TrainConfig(lr=1e-3, warmup=2, max_steps=100)
    t0 = time.time()
    state = create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)), tcfg,
                               device=dev)
    plain_state = create_train_state(copy.deepcopy(state.module), tcfg, device=dev)
    print(f"training: {VISION}@{TEXT} random (seed 0), "
          f"{sum(p.numel() for p in state.module.parameters())} fp32 parameters, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    # bwd_impl="fullgrad": this phase holds #14/#16/#18; phase 8 measures the routes
    kernel_step = make_train_step(cfg, tcfg, nct.ModelOptions(
        compute_dtype="bfloat16", deterministic=False, bwd_impl="fullgrad"))
    plain_step = make_train_step(cfg, tcfg, nct.ModelOptions(
        compute_dtype="bfloat16", attn_impl="plain", deterministic=False, bwd_impl="fullgrad"))

    # the plain route's first step, from the same weights and dropout seeds
    t0 = time.time()
    plain_state, plain_metrics = plain_step(plain_state, images, ids, 7)
    plain_loss = float(plain_metrics["loss"])
    plain_grads = {n: p.grad for n, p in plain_state.module.named_parameters()}
    plain_s = time.time() - t0
    del plain_state

    counted = {"fused_attention_block": fb.fused_attention_block,
               "fused_bert_attention_block": fb.fused_bert_attention_block,
               "fused_mlp_block": fb.fused_mlp_block,
               "fused_attention_block_bwd_fullgrad": fbb.fused_attention_block_bwd_fullgrad,
               "fused_bert_attention_block_bwd_fullgrad":
                   fbb.fused_bert_attention_block_bwd_fullgrad,
               "fused_mlp_block_bwd_fullgrad": fbb.fused_mlp_block_bwd_fullgrad}
    counted.update(_counted())
    from nans_clip_tpu_torch.ops.attention import attention_bwd
    from nans_clip_tpu_torch.ops.gemm import linear_dgrad, linear_wgrad
    from nans_clip_tpu_torch.ops.layernorm import layer_norm_bwd
    from nans_clip_tpu_torch.ops.reduce import column_sum
    for fn in (attention_bwd, linear_dgrad, linear_wgrad, layer_norm_bwd, column_sum):
        counted[fn.__name__] = fn
    n_img, n_txt = cfg.vision.layers, cfg.text.num_hidden_layers
    expected = {"fused_attention_block": n_img, "fused_bert_attention_block": n_txt,
                "fused_mlp_block": n_img + n_txt, "fused_attention_block_bwd_fullgrad": n_img,
                "fused_bert_attention_block_bwd_fullgrad": n_txt,
                "fused_mlp_block_bwd_fullgrad": n_img + n_txt,
                "fused_layer_block": 0, "fused_tower": 0, "fused_tower_int8": 0}

    def counts():
        out = {name: fn.launches for name, fn in counted.items()}
        out.update(_tower_counts())
        return out

    def reset():
        _reset_counts()
        for fn in counted.values():
            fn.launches = 0

    steps = 8
    losses, events = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    for i in range(steps):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, metrics = kernel_step(state, images, ids, 7 if i == 0 else 100 + i)
        ev[1].record()
        events.append(ev)
        losses.append(metrics["loss"])
        if i == 0:
            torch.cuda.synchronize()
            per_step = counts()
            print(f"training: launches of one step {json.dumps(per_step)}", flush=True)
            if any(per_step[k] != v for k, v in expected.items()):
                raise AssertionError(f"launches of one step {per_step}, expected {expected}")
            loss0 = float(metrics["loss"])
            cos = {}
            for n, p in state.module.named_parameters():
                if not n.endswith("key.bias"):
                    cos[n] = float(F.cosine_similarity(p.grad.flatten().double(),
                                                       plain_grads[n].flatten().double(), dim=0))
            worst = min(cos, key=cos.get)
            print(f"training: kernel vs plain route after one step: loss {loss0:.6f} vs "
                  f"{plain_loss:.6f} (|diff| {abs(loss0 - plain_loss):.3g} <= {STEP_LOSS_BOUND}); "
                  f"gradient cosine >= {cos[worst]:.6f} ({worst}) over {len(cos)} tensors, "
                  f"bound {GRAD_COS_BOUND}; plain step {plain_s:.1f} s", flush=True)
            if abs(loss0 - plain_loss) > STEP_LOSS_BOUND or cos[worst] < GRAD_COS_BOUND:
                raise AssertionError("the kernel route's step differs from the plain route's")
            del plain_grads
    torch.cuda.synchronize()
    total = counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(x) for x in losses]
    ms = sum(step_ms[1:]) / (steps - 1)
    print(f"training: batch {b}, {steps} steps, loss {' '.join(f'{x:.5f}' for x in losses)}; "
          f"step ms {' '.join(f'{x:.2f}' for x in step_ms)}; steps 2-{steps} {ms:.2f} ms a step, "
          f"{b / ms * 1e3:.1f} pairs/s; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"logit_scale {float(state.module.logit_scale.detach()):.6f}", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over {steps} steps: {losses}")
    if any(total[k] != steps * v for k, v in per_step.items()):
        raise AssertionError(f"launches over {steps} steps {total} are not {steps} x {per_step}")

    # the .pt round trip
    path = os.path.join(tmp, "trained.pt")
    save_torch_checkpoint(path, state.module)
    loaded, _ = nct.load_from_name(path, vision_model_name=VISION, text_model_name=TEXT,
                                   input_resolution=224, device=dev,
                                   options=nct.ModelOptions(compute_dtype="bfloat16"))
    opts = nct.ModelOptions(compute_dtype="bfloat16")
    with torch.inference_mode():
        mine = (state.module.encode_image(images[:8], opts), state.module.encode_text(ids[:8], opts))
    theirs = (loaded.encode_image(images[:8]), loaded.encode_text(ids[:8]))
    same = all(torch.equal(a, r) for a, r in zip(mine, theirs))
    print(f"training: trained model saved as .pt ({os.path.getsize(path) / 2 ** 20:.1f} MiB) and "
          f"reloaded with load_from_name: features equal {same}", flush=True)
    if not same:
        raise AssertionError("the reloaded model's features differ from the trained module's")
    return results, per_step


LORA_MICRO, LORA_ACCUM = 32, 4


def _cos(a, b) -> float:
    import torch.nn.functional as F

    return float(F.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0))


def phase_lora(torch, dev, tmp):
    """Phase 8: #13, #15, #17, #21, the backward routes, the LoRA step and
    the rest of the train step (accumulation, FLIP, distillation, bf16 Adam
    moments)."""
    import copy

    import torch.nn.functional as F

    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.models import lora
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
    from nans_clip_tpu_torch.ops import layer_bwd as lb
    from nans_clip_tpu_torch.ops.gemm import linear_wgrad
    from nans_clip_tpu_torch.training import TrainConfig, create_train_state, make_train_step
    from nans_clip_tpu_torch.training import train_lora

    g = torch.Generator(device=dev).manual_seed(8)
    bf = torch.bfloat16
    w, inter, heads, rate = 768, 3072, 12, 0.1

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

    def params(std):
        return (rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(3 * w, w, std=std),
                rnd(3 * w, std=0.1), rnd(w, w, std=std), rnd(w, std=0.1),
                rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(inter, w, std=std),
                rnd(inter, std=0.1), rnd(w, inter, std=std / 2), rnd(w, std=0.1))

    pi, pt = params(w ** -0.5), params(0.02)
    all6 = (True,) * 6
    results = {}

    # 1. the emitting kernels at batch 128 and at the LoRA microbatch
    for b in (TRAIN_BATCH, LORA_MICRO):
        xi, gi = rnd(b, 197, w), rnd(b, 197, w)
        xt, gt = rnd(b, 52, w), rnd(b, 52, w)
        lengths = torch.randint(2, 53, (b,), generator=g, device=dev)
        kb = ((1.0 - (torch.arange(52, device=dev)[None, :] < lengths[:, None]).float())
              * -10000.0).contiguous()

        def yardstick(x, gout, p, s, post_ln, mlp, act=None):
            """torch.autograd through the sub-block written with library
            calls, weights frozen: the forward and dx alone."""
            xr = x.detach().requires_grad_()
            eps = 1e-12 if post_ln else 1e-5
            mask = None if not post_ln else kb.view(b, 1, 1, s).to(bf)

            def run():
                ln = lambda t: F.layer_norm(t, (w,), p[0], p[1], eps)
                xn = xr if post_ln else ln(xr)
                if mlp:
                    h = F.linear(xn, p[2], p[3])
                    h = h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else F.gelu(h)
                    y = F.linear(h, p[4], p[5])
                else:
                    q, k, v = F.linear(xn, p[2], p[3]).view(b, s, 3, heads, 64).permute(
                        2, 0, 3, 1, 4).unbind(0)
                    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                         dropout_p=rate if post_ln else 0.0)
                    y = F.linear(ctx.transpose(1, 2).reshape(b, s, w), p[4], p[5])
                out = ln(xr + F.dropout(y, rate)) if post_ln else xr + y
                return torch.autograd.grad(out, [xr], gout)
            return run

        bs_i, bs_t = b * 197, b * 52
        attn_cost = lambda bs, s, n, extra=0.0: (
            bs * w * 2 * 8 + 4 * w * w * 2 + extra, n * bs * w * w + 12 * bs * s * w)
        mlp_cost = lambda bs, n: (bs * (6 * w + 2 * inter) * 2 + 2 * w * inter * 2,
                                  n * bs * w * inter)
        a13 = (xi, *pi[:5], gi, heads, 1e-5)
        a15 = (xt, *pt[:6], kb, 1234, gt, heads, 1e-12, rate, rate)
        a17i = (xi, *pi[6:], None, gi, "quick_gelu", 1e-5, False, 0.0)
        a17t = (xt, *pt[6:], 99, gt, "gelu", 1e-12, True, rate)
        zero_bo = torch.zeros(w, device=dev, dtype=bf)
        # (name, emitting kernel, full-gradient kernel, twin, args, the caller's weight
        #  gradients from what was emitted, yardstick, (bytes, operations), replaces)
        cases = [
            ("fused_attention_block_bwd", fbb.fused_attention_block_bwd,
             fbb.fused_attention_block_bwd_fullgrad, fbb._attn_bwd_math, a13,
             lambda out: fb.attention_weight_grads(all6, False, xi, pi[0], pi[2], gi, out, 1e-5),
             yardstick(xi, gi, pi[:4] + (pi[4], zero_bo), 197, False, False),
             attn_cost(bs_i, 197, 14), "nans_clip_tpu/ops/fused_block_bwd.py:216"),
            ("fused_bert_attention_block_bwd", fbb.fused_bert_attention_block_bwd,
             fbb.fused_bert_attention_block_bwd_fullgrad, fbb._bert_bwd_math, a15,
             lambda out: fb.attention_weight_grads(all6, True, xt, pt[0], pt[2], gt, out, 1e-12),
             yardstick(xt, gt, pt[:6], 52, True, False),
             attn_cost(bs_t, 52, 16, b * 52 * 4), "nans_clip_tpu/ops/fused_block_bwd.py:386"),
            ("fused_mlp_block_bwd", fbb.fused_mlp_block_bwd, fbb.fused_mlp_block_bwd_fullgrad,
             fbb._mlp_bwd_math, a17i, lambda out: fb.mlp_weight_grads(all6, False, gi, out),
             yardstick(xi, gi, pi[6:], 197, False, True, "quick_gelu"),
             mlp_cost(bs_i, 6), "nans_clip_tpu/ops/fused_block_bwd.py:781"),
            ("fused_mlp_block_bwd[post-LN, S=52]", fbb.fused_mlp_block_bwd,
             fbb.fused_mlp_block_bwd_fullgrad, fbb._mlp_bwd_math, a17t,
             lambda out: fb.mlp_weight_grads(all6, True, gt, out),
             yardstick(xt, gt, pt[6:], 52, True, True, "gelu"), mlp_cost(bs_t, 8), None),
        ]
        for name, kern, full, twin, args, wgrads, yard, cost, replaces in cases:
            got, want = kern(*args), twin(*args, full=False)
            torch.cuda.synchronize()
            errs, err = [], 0.0
            for i, (a, r) in enumerate(zip(got, want)):
                e, top = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
                if a.shape != r.shape or a.dtype != bf or not torch.isfinite(a).all() \
                        or e > BWD_REL * top:
                    raise AssertionError(f"{name} b={b} output {i}: max abs err {e} exceeds "
                                         f"{BWD_REL} x {top}")
                errs.append(e / max(top, 1e-30))
                err = max(err, e)
            if not all(torch.equal(a, r) for a, r in zip(got, kern(*args))):
                raise AssertionError(f"{name}: two calls gave different bits")
            del want
            ms = _time_ms(lambda: kern(*args), 5)
            plain_ms = _time_ms(lambda: twin(*args, full=False), 2)
            yard_ms = _time_ms(yard, 5)
            # the route's evidence: emitting kernel + library weight gradients
            # against the full-gradient chain, every weight needing its gradient
            emit_ms = _time_ms(lambda: wgrads(kern(*args)), 5)
            full_ms = _time_ms(lambda: full(*args), 5)
            bound_ms, bound_by = _bound(*cost)
            print(f"lora kernel {name} b={b}: max_abs_err {err:.6g}, largest error over "
                  f"max|twin| {max(errs):.4g} <= {BWD_REL} on each of {len(got)} outputs; "
                  f"{ms:.4f} ms, twin {plain_ms:.4f} ms, yardstick (frozen weights) "
                  f"{yard_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{cost[1] / 1e9:.1f} GFLOP, {cost[0] / 1e6:.1f} MB); with every weight "
                  f"gradient: emit + library products {emit_ms:.4f} ms vs full-gradient chain "
                  f"{full_ms:.4f} ms", flush=True)
            results[(name, b)] = dict(err=err, ms=ms, plain_ms=plain_ms, yard_ms=yard_ms,
                                      bound_ms=bound_ms, bound_by=bound_by, replaces=replaces,
                                      emit_ms=emit_ms, full_ms=full_ms)
            del got

        # 2. the whole-layer backward against #18 then #14
        if b == TRAIN_BATCH:
            xm = fb.fused_attention_block(xi, *pi[:6], heads, 1e-5)
            largs = (xi, *pi[:5], xm, *pi[6:], gi, heads, "quick_gelu", 1e-5)

            def two_calls():
                mlp = fbb.fused_mlp_block_bwd_fullgrad(xm, *pi[6:], None, gi, "quick_gelu", 1e-5,
                                                       False)
                attn = fbb.fused_attention_block_bwd_fullgrad(xi, *pi[:5], mlp[0], heads, 1e-5)
                return attn + mlp[1:]

            got, pair = lb.fused_layer_block_bwd_fullgrad(*largs), two_calls()
            want = lb._layer_bwd_math(*largs)
            torch.cuda.synchronize()
            if len(got) != 13 or not all(torch.equal(a, r) for a, r in zip(got, pair)):
                raise AssertionError("#21 is not bit-equal to #18 followed by #14")
            err, rel = 0.0, 0.0
            for a, r in zip(got, want):
                e, top = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
                if e > BWD_REL * top:
                    raise AssertionError(f"#21: max abs err {e} exceeds {BWD_REL} x {top}")
                err, rel = max(err, e), max(rel, e / max(top, 1e-30))
            del want, pair, got
            ms = _time_ms(lambda: lb.fused_layer_block_bwd_fullgrad(*largs), 5)
            pair_ms = _time_ms(two_calls, 5)
            plain_ms = _time_ms(lambda: lb._layer_bwd_math(*largs), 2)
            cost = (4 * bs_i * w * 2 + (4 * w * w + 2 * w * inter + 10 * w + inter) * 6,
                    22 * bs_i * w * w + 12 * bs_i * 197 * w + 10 * bs_i * w * inter)
            bound_ms, bound_by = _bound(*cost)
            print(f"lora kernel fused_layer_block_bwd_fullgrad b={b}: bit-equal to #18 then #14 "
                  f"on 13 outputs; max_abs_err {err:.6g}, largest error over max|twin| "
                  f"{rel:.4g} <= {BWD_REL}; {ms:.4f} ms, the two calls {pair_ms:.4f} ms, twin "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
            results[("fused_layer_block_bwd_fullgrad", b)] = dict(
                err=err, ms=ms, plain_ms=plain_ms, yard_ms=pair_ms, bound_ms=bound_ms,
                bound_by=bound_by, replaces="nans_clip_tpu/ops/layer_bwd.py:74")
            del xm
        del xi, gi, xt, gt
    del pi, pt
    torch.cuda.empty_cache()

    # the model, once on the CPU, copied to the card for each run
    cfg = nct.load_config(f"{VISION}@{TEXT}")
    b = TRAIN_BATCH
    gen = torch.Generator().manual_seed(5)
    images = torch.randn(b, 224, 224, 3, generator=gen).to(dev)
    ids = torch.from_numpy(nct.tokenize([f"{TEXTS[i % len(TEXTS)]}{i}" for i in range(b)]))
    ids = ids.to(dev)
    base = build_clip(cfg, "cpu", torch.Generator().manual_seed(0)).to(dev)
    opts = lambda **kw: nct.ModelOptions(compute_dtype="bfloat16", deterministic=False, **kw)
    counted = {"fused_attention_block": fb.fused_attention_block,
               "fused_bert_attention_block": fb.fused_bert_attention_block,
               "fused_mlp_block": fb.fused_mlp_block,
               "fused_attention_block_bwd": fbb.fused_attention_block_bwd,
               "fused_bert_attention_block_bwd": fbb.fused_bert_attention_block_bwd,
               "fused_mlp_block_bwd": fbb.fused_mlp_block_bwd,
               "fused_attention_block_bwd_fullgrad": fbb.fused_attention_block_bwd_fullgrad,
               "fused_bert_attention_block_bwd_fullgrad":
                   fbb.fused_bert_attention_block_bwd_fullgrad,
               "fused_mlp_block_bwd_fullgrad": fbb.fused_mlp_block_bwd_fullgrad,
               "fused_layer_block_bwd_fullgrad": lb.fused_layer_block_bwd_fullgrad,
               "wgrad_kernel": linear_wgrad}
    counted.update(_counted())

    def reset():
        _reset_counts()
        for fn in counted.values():
            fn.launches = 0

    def counts():
        out = {name: fn.launches for name, fn in counted.items()}
        out.update(_tower_counts())
        return out

    def timed_steps(step, state, n, *args):
        evs = []
        for _ in range(n):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = step(state, *args)
            ev[1].record()
            evs.append(ev)
        torch.cuda.synchronize()
        return out, [s.elapsed_time(e) for s, e in evs]

    # 3. the route question: one full step on each bwd_impl route
    tcfg = TrainConfig(lr=1e-3, warmup=2, max_steps=100)
    routes, first = ("fullgrad", "emit", "layer", "auto"), {}
    states, steps, layer_launches = {}, {}, None
    for route in routes:
        states[route] = create_train_state(copy.deepcopy(base), tcfg, device=dev)
        steps[route] = make_train_step(cfg, tcfg, opts(bwd_impl=route))
        reset()
        states[route], metrics = steps[route](states[route], images, ids, 7)
        torch.cuda.synchronize()
        c = counts()
        first[route] = (float(metrics["loss"]),
                        {n: p.grad.clone() for n, p in states[route].module.named_parameters()}
                        if route == "fullgrad" else None, c)
        if route != "fullgrad":
            cos = {n: _cos(p.grad, first["fullgrad"][1][n])
                   for n, p in states[route].module.named_parameters()
                   if not n.endswith("key.bias")}
            worst = min(cos, key=cos.get)
            diff = abs(first[route][0] - first["fullgrad"][0])
            print(f"route {route} vs fullgrad after one step from the same weights and seeds: "
                  f"loss {first[route][0]:.6f} vs {first['fullgrad'][0]:.6f} (|diff| {diff:.3g} "
                  f"<= {STEP_LOSS_BOUND}); gradient cosine >= {cos[worst]:.6f} ({worst}), bound "
                  f"{GRAD_COS_BOUND}", flush=True)
            if diff > STEP_LOSS_BOUND or cos[worst] < GRAD_COS_BOUND:
                raise AssertionError(f"route {route} differs from route fullgrad")
    n_img, n_txt = cfg.vision.layers, cfg.text.num_hidden_layers
    from nans_clip_tpu_torch.ops import gates

    def expected_launches(route):
        """Backward launches of one step, from the route's block kinds."""
        layer = route == "layer" or (route == "auto" and gates.LAYER_BWD_ROUTE)
        full = {k: gates.bwd_route(k, route) == "fullgrad" for k in gates.BWD_ROUTE}
        img = 0 if layer else n_img
        return {"fused_layer_block_bwd_fullgrad": n_img - img,
                "fused_attention_block_bwd_fullgrad": img * full["attn_pre"],
                "fused_attention_block_bwd": img * (not full["attn_pre"]),
                "fused_bert_attention_block_bwd_fullgrad": n_txt * full["attn_post"],
                "fused_bert_attention_block_bwd": n_txt * (not full["attn_post"]),
                "fused_mlp_block_bwd_fullgrad": img * full["mlp_pre"] + n_txt * full["mlp_post"],
                "fused_mlp_block_bwd": img * (not full["mlp_pre"])
                + n_txt * (not full["mlp_post"])}

    for route in routes:
        c, want = first[route][2], expected_launches(route)
        if any(c[k] != v for k, v in want.items()) or (route == "emit" and c["wgrad_kernel"]):
            raise AssertionError(f"route {route}: launches {c}, expected {want}")
    layer_launches = first["layer"][2]["fused_layer_block_bwd_fullgrad"]
    del first
    # a fifth arm, timed only: "auto" under the table that the block times at
    # batch 128 above give (fullgrad where the full-gradient chain was no
    # slower than emit + library products)
    kinds = {"fused_attention_block_bwd": "attn_pre", "fused_bert_attention_block_bwd": "attn_post",
             "fused_mlp_block_bwd": "mlp_pre", "fused_mlp_block_bwd[post-LN, S=52]": "mlp_post"}
    from_blocks = {kinds[n]: "fullgrad" if r["full_ms"] <= r["emit_ms"] else "emit"
                   for (n, bb), r in results.items() if bb == TRAIN_BATCH and n in kinds}
    arms = routes + ("blocks",)
    states["blocks"] = create_train_state(copy.deepcopy(base), tcfg, device=dev)
    steps["blocks"] = make_train_step(cfg, tcfg, opts(bwd_impl="auto"))

    def timed_arm(route):
        table = dict(gates.BWD_ROUTE)
        if route == "blocks":
            gates.BWD_ROUTE.update(from_blocks)
        try:
            return timed_steps(steps[route], states[route], 3, images, ids, 100)[1]
        finally:
            gates.BWD_ROUTE.update(table)

    times = {r: [] for r in arms}
    for order in (arms, arms[::-1]):        # in turns, both orders
        for route in order:
            times[route] += timed_arm(route)
    route_ms = {r: sorted(v)[len(v) // 2] for r, v in times.items()}
    print("route question, one train step at batch 128, ms (upper median of 6, in turns): "
          + "; ".join(f"{r} {route_ms[r]:.2f} [{' '.join(f'{x:.1f}' for x in times[r])}]"
                      for r in arms), flush=True)
    best = min(routes, key=route_ms.get)
    print(f"route gate evidence: the fastest full step is {best}; auto is gates.BWD_ROUTE = "
          f"{json.dumps(gates.BWD_ROUTE)} with gates.LAYER_BWD_ROUTE = {gates.LAYER_BWD_ROUTE}; "
          f"the block times' table {json.dumps(from_blocks)} ('blocks') "
          f"{route_ms['blocks']:.2f} ms", flush=True)
    del states, steps
    torch.cuda.empty_cache()

    # 4. the LoRA step: batch 32 x accum 4, rank 4, alpha 16, smoothing 0.05
    alpha, rank = 16.0, 4
    module = copy.deepcopy(base)
    adapters = lora.init_lora(torch.Generator().manual_seed(1), module, rank, device=dev)
    state = train_lora.create_lora_state(module, adapters, lr=1e-3, wd=0.01, device=dev)
    n_lora = lora.count_lora_params(adapters)
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    eval_opts = nct.ModelOptions(compute_dtype="bfloat16")

    def features(ad):
        merged = lora.merge_lora(module, ad, alpha)
        with torch.no_grad():
            return (torch.func.functional_call(module, merged, (images[:8], None, eval_opts)),
                    torch.func.functional_call(module, merged, (None, ids[:8], eval_opts)))

    with torch.no_grad():
        plain_feats = (module.encode_image(images[:8], eval_opts),
                       module.encode_text(ids[:8], eval_opts))
    same0 = all(torch.equal(a, r) for a, r in zip(features(adapters), plain_feats))
    print(f"lora: {n_lora} adapter parameters (rank {rank}) over "
          f"{sum(p.numel() for p in module.parameters())} frozen; merged-at-init features equal "
          f"the base model's: {same0}", flush=True)
    if not same0:
        raise AssertionError("the model merged at init differs from the base model")
    k_step, _ = train_lora.make_lora_step(cfg, nct.ModelOptions(compute_dtype="bfloat16"), alpha,
                                          0.05, LORA_ACCUM)
    p_step, _ = train_lora.make_lora_step(
        cfg, nct.ModelOptions(compute_dtype="bfloat16", attn_impl="plain"), alpha, 0.05,
        LORA_ACCUM)
    blocks = n_img + n_txt
    expected = {"fused_attention_block_bwd": n_img * LORA_ACCUM,
                "fused_bert_attention_block_bwd": n_txt * LORA_ACCUM,
                "fused_mlp_block_bwd": blocks * LORA_ACCUM,
                "fused_attention_block": 2 * LORA_ACCUM * n_img,
                "fused_bert_attention_block": 2 * LORA_ACCUM * n_txt,
                "fused_mlp_block": 2 * LORA_ACCUM * blocks,
                "fused_attention_block_bwd_fullgrad": 0,
                "fused_bert_attention_block_bwd_fullgrad": 0,
                "fused_mlp_block_bwd_fullgrad": 0, "fused_layer_block_bwd_fullgrad": 0,
                "wgrad_kernel": 0, "fused_layer_block": 0, "fused_tower": 0,
                "fused_tower_int8": 0}
    n_steps, losses, step_ms = 8, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    for i in range(n_steps):
        if i == 2:
            # B has left zero: the plain route's step from the same adapters and seeds
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            twin_ad = {t: {m: {n: v.detach().clone().requires_grad_() for n, v in d.items()}
                           for m, d in mods.items()} for t, mods in state.adapters.items()}
            twin = train_lora.create_lora_state(module, twin_ad, lr=1e-3, wd=0.01, device=dev)
            t0 = time.time()
            twin, plain_loss, _ = p_step(twin, images, ids, 100 + i)
            plain_loss = float(plain_loss)
            plain_s = time.time() - t0
            plain_grads = {k: t.grad for k, t in lora._leaves(twin_ad)}
        (state, loss, _), ms = timed_steps(k_step, state, 1, images, ids, 100 + i)
        losses.append(float(loss))
        step_ms += ms
        if i == 0:
            per_step = counts()
            print(f"lora: launches of one step {json.dumps(per_step)}", flush=True)
            if any(per_step[k] != v for k, v in expected.items()):
                raise AssertionError(f"launches of one LoRA step {per_step}, expected {expected}")
        if i == 2:
            cos = {k: _cos(t.grad, plain_grads[k]) for k, t in lora._leaves(state.adapters)}
            worst = min(cos, key=cos.get)
            print(f"lora: kernel vs plain route at step 3 (B nonzero), same adapters and seeds: "
                  f"loss {losses[-1]:.6f} vs {plain_loss:.6f} (|diff| "
                  f"{abs(losses[-1] - plain_loss):.3g} <= {STEP_LOSS_BOUND}); adapter gradient "
                  f"cosine >= {cos[worst]:.6f} ({worst}) over {len(cos)} tensors, bound "
                  f"{GRAD_COS_BOUND}; plain step {plain_s:.1f} s", flush=True)
            if abs(losses[-1] - plain_loss) > STEP_LOSS_BOUND or cos[worst] < GRAD_COS_BOUND:
                raise AssertionError("the LoRA step's kernel route differs from the plain route")
            del twin, twin_ad, plain_grads
    total = counts()
    # the plain route's step launched no kernel, so the totals are the kernel route's
    if any(total[k] != n_steps * v for k, v in per_step.items()):
        raise AssertionError(f"launches over {n_steps} LoRA steps {total} are not {n_steps} x "
                             f"{per_step}")
    frozen = all(torch.equal(p.detach(), before[n]) and p.grad is None
                 for n, p in module.named_parameters())
    pairs = LORA_MICRO * LORA_ACCUM
    ms = sum(step_ms[3:]) / len(step_ms[3:])
    print(f"lora: batch {LORA_MICRO} x accum {LORA_ACCUM}, {n_steps} steps, loss "
          f"{' '.join(f'{x:.5f}' for x in losses)}; step ms "
          f"{' '.join(f'{x:.2f}' for x in step_ms)}; steps 4-{n_steps} {ms:.2f} ms a step, "
          f"{pairs / ms * 1e3:.1f} pairs/s; peak memory {peak / 2 ** 30:.3f} GiB (steps 1-2); "
          f"base weights and logit_scale bit-equal after the steps: {frozen}", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0] or not frozen:
        raise AssertionError(f"the LoRA loss did not fall over {n_steps} steps ({losses}), or a "
                             "frozen weight moved")
    path = os.path.join(tmp, "last_lora.npz")
    lora.save_lora(path, state.adapters, {"rank": rank, "alpha": alpha})
    template = lora.init_lora(torch.Generator().manual_seed(2), module, rank, device=dev)
    loaded, meta = lora.load_lora(path, template)
    same = all(torch.equal(a, r) for a, r in zip(features(state.adapters), features(loaded)))
    moved = not torch.equal(features(state.adapters)[0], plain_feats[0])
    print(f"lora: save_lora ({os.path.getsize(path)} bytes, meta {json.dumps(meta)}) -> "
          f"load_lora: features equal {same}; trained features differ from the base's: {moved}",
          flush=True)
    if not (same and moved):
        raise AssertionError("reloaded adapters give other features, or training moved nothing")
    lora_step = dict(ms=ms, pairs_s=pairs / ms * 1e3, peak=peak, per_step=per_step)
    del state, module, adapters, before
    torch.cuda.empty_cache()

    # 5. the rest of the step: accumulation, FLIP, a teacher, bf16 Adam moments
    def run(tcfg, n, seed, teacher=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st = create_train_state(copy.deepcopy(base), tcfg, device=dev)
        step = make_train_step(cfg, tcfg, opts(), teacher)
        out = []
        for _ in range(n):
            (st, metrics), ms = timed_steps(step, st, 1, images, ids, seed)
            out.append(({k: float(v) for k, v in metrics.items()}, ms[0]))
        grads = {n_: p.grad for n_, p in st.module.named_parameters()}
        return out, grads, torch.cuda.max_memory_allocated() / 2 ** 30

    base_cfg = dict(lr=1e-3, warmup=2, max_steps=100)
    one, g1, peak1 = run(TrainConfig(**base_cfg), 2, None)
    two, g2, peak2 = run(TrainConfig(accum_freq=2, **base_cfg), 2, None)
    cos = {n: _cos(g2[n], g1[n]) for n in g1 if not n.endswith("key.bias")}
    worst = min(cos, key=cos.get)
    diff = abs(one[0][0]["loss"] - two[0][0]["loss"])
    print(f"accum: accum_freq 2 vs 1 at batch {b}, no dropout: loss {two[0][0]['loss']:.6f} vs "
          f"{one[0][0]['loss']:.6f} (|diff| {diff:.3g} <= {STEP_LOSS_BOUND}); second-step "
          f"gradient cosine >= {cos[worst]:.6f} ({worst}), bound {GRAD_COS_BOUND}; step "
          f"{two[1][1]:.2f} vs {one[1][1]:.2f} ms; peak {peak2:.3f} vs {peak1:.3f} GiB",
          flush=True)
    if diff > STEP_LOSS_BOUND or cos[worst] < GRAD_COS_BOUND:
        raise AssertionError("the accumulated step differs from the unaccumulated one")
    del g1, g2
    flip, _, peak_f = run(TrainConfig(mask_ratio=0.5, **base_cfg), 2, 7)
    print(f"flip: mask_ratio 0.5 (S = 99): loss {flip[0][0]['loss']:.6f}, step {flip[1][1]:.2f} "
          f"ms, peak {peak_f:.3f} GiB", flush=True)
    # the teacher that the repository's distillation preset names
    # (run_scripts/muge_finetune_vit-b-16_rbt-base_distillation.sh:10), full depth
    cfg_t = nct.load_config(WIDE_H)
    t_module = build_clip(cfg_t, "cpu", torch.Generator().manual_seed(9)).to(dev)
    teacher = nct.CLIPModel(cfg_t, t_module, nct.ModelOptions(compute_dtype="bfloat16"))
    kd, _, peak_k = run(TrainConfig(distillation=True, **base_cfg), 4, 7, teacher)
    kds = [m["kd_loss"] for m, _ in kd]
    print(f"distillation: {WIDE_H} teacher (seed 9, {cfg_t.vision.layers} + "
          f"{cfg_t.text.num_hidden_layers} layers), kd_loss {' '.join(f'{x:.5f}' for x in kds)}; "
          f"step {kd[-1][1]:.2f} ms, peak {peak_k:.3f} GiB", flush=True)
    del teacher, t_module
    adam, _, peak_a = run(TrainConfig(adam_state_dtype="bfloat16", **base_cfg), 2, 7)
    ref, _, peak_r = run(TrainConfig(**base_cfg), 2, 7)
    print(f"adam_state_dtype bfloat16: loss {adam[0][0]['loss']:.6f} then {adam[1][0]['loss']:.6f} "
          f"(fp32 moments {ref[0][0]['loss']:.6f} then {ref[1][0]['loss']:.6f}); step "
          f"{adam[1][1]:.2f} vs {ref[1][1]:.2f} ms; peak {peak_a:.3f} vs {peak_r:.3f} GiB",
          flush=True)
    finite = all(math.isfinite(m["loss"]) for m, _ in flip + kd + adam)
    if not finite or not all(math.isfinite(x) for x in kds) or not kds[-1] < kds[0] \
            or not peak_a < peak_r:
        raise AssertionError("FLIP, distillation or bf16 Adam moments: a loss is not finite, "
                             "kd_loss did not fall, or bf16 moments saved no memory")
    return results, lora_step, layer_launches, route_ms


WIDE_H = "ViT-H-14@RoBERTa-wwm-ext-large-chinese"
WIDE_L336 = "ViT-L-14-336@RoBERTa-wwm-ext-base-chinese"
WIDE_BATCH = 32
# Bound of the whole-tower kernel against its twin over RoBERTa-large's 24
# layers: the 12-layer bound's random walk, sqrt(24) ~ 4.9 ulps, twice that.
TOWER24_ULPS = 10
# get_similarity of ViT-H-14 (32 + 24 layers) on the kernel route against the
# plain route, both bf16: the 12-layer bound of phase 5 (0.05) grown by the
# random walk of the deeper towers, sqrt(32 / 12) ~ 1.6x, to 0.1.
WIDE_LOGIT_BOUND = 0.1


def _wide_counted():
    """The wrappers whose launches a wide train step or forward counts."""
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.ops import fused_block_bwd as fbb

    out = {"fused_attention_block_wide": fb.fused_attention_block_wide,
           "_fused_mlp_tiled_call": fb._fused_mlp_tiled_call,
           "_fused_mlp_batched_call": fb._fused_mlp_batched_call}
    for name in ("fused_attention_block_bwd", "fused_attention_block_bwd_fullgrad",
                 "fused_attention_block_bwd_chunked", "fused_bert_attention_block_bwd",
                 "fused_bert_attention_block_bwd_fullgrad", "fused_mlp_block_bwd",
                 "fused_mlp_block_bwd_fullgrad", "fused_mlp_block_bwd_chunked"):
        out[name] = getattr(fbb, name)
    out.update(_counted())
    return out


def _wide_counts():
    from nans_clip_tpu_torch.ops import fused_block as fb

    from nans_clip_tpu_torch.ops.attention import attention_bwd

    out = {name: fn.launches for name, fn in _wide_counted().items()}
    out["fused_attention_block_wide[batch_tile>1]"] = \
        fb.fused_attention_block_wide.launches_batched
    out["attention_bwd_long"] = attention_bwd.launches_long
    out.update(_tower_counts())
    return out


def _wide_reset():
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.ops.attention import attention_bwd

    _reset_counts()
    for fn in _wide_counted().values():
        fn.launches = 0
    fb.fused_attention_block_wide.launches_batched = 0
    attention_bwd.launches_long = 0


def _check_launches(what, got, want):
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def phase_wide(torch, dev, ckpt_out=None):
    """Phase 9: the wide towers. The kernels of #7-#10, #19, #20 and #1, #13,
    #14 at heads of 80 against their twins at full width; one train step on
    the plain and the kernel route; 6 steps of ViT-H-14 and of ViT-L-14-336
    at batch 32, full depth; a ViT-H-width tower at 336 px; get_similarity
    of ViT-H-14 at batch 3 (the image tower's per-layer route: #1 + #9) and
    64; tower.cu at RoBERTa-large's width. ``ckpt_out``: where to save the
    untrained ViT-H-14 model as a reference-layout ``.pt`` for phase 12."""
    import copy

    import torch.nn.functional as F

    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.configs import with_resolution
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
    from nans_clip_tpu_torch.ops import gates
    from nans_clip_tpu_torch.ops import layer_kernel as lk
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    from nans_clip_tpu_torch.training import TrainConfig, create_train_state, make_train_step

    t_phase = time.time()
    g = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

    def params(w, inter):
        std = w ** -0.5
        return (rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(3 * w, w, std=std),
                rnd(3 * w, std=0.1), rnd(w, w, std=std), rnd(w, std=0.1),
                rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(inter, w, std=std),
                rnd(inter, std=0.1), rnd(w, inter, std=std / 2), rnd(w, std=0.1))

    def yard_attn(x, gout, p, heads):
        """The pre-LN attention sub-block in library calls (F.layer_norm,
        F.linear, SDPA): the forward alone, or with ``gout`` the forward and
        dx with the weights frozen. A yardstick of speed only."""
        b, s, w = x.shape

        def fwd(xr):
            xn = F.layer_norm(xr, (w,), p[0], p[1], 1e-5)
            q, k, v = F.linear(xn, p[2], p[3]).view(b, s, 3, heads, w // heads).permute(
                2, 0, 3, 1, 4).unbind(0)
            ctx = F.scaled_dot_product_attention(q, k, v)
            return xr + F.linear(ctx.transpose(1, 2).reshape(b, s, w), p[4], p[5])
        if gout is None:
            return lambda: fwd(x)
        xr = x.detach().requires_grad_()
        return lambda: torch.autograd.grad(fwd(xr), [xr], gout)

    def yard_mlp(x, gout, p):
        w = x.shape[-1]

        def fwd(xr):
            h = F.linear(F.layer_norm(xr, (w,), p[0], p[1], 1e-5), p[2], p[3])
            return xr + F.linear(h * torch.sigmoid(1.702 * h), p[4], p[5])
        if gout is None:
            return lambda: fwd(x)
        xr = x.detach().requires_grad_()
        return lambda: torch.autograd.grad(fwd(xr), [xr], gout)

    pH, pL = params(1280, 5120), params(1024, 4096)
    xH, gH = rnd(WIDE_BATCH, 257, 1280), rnd(WIDE_BATCH, 257, 1280)
    xH5, gH5 = rnd(16, 577, 1280), rnd(16, 577, 1280)
    xL, gL = rnd(WIDE_BATCH, 577, 1024), rnd(WIDE_BATCH, 577, 1024)
    zero_bo = torch.zeros(1280, device=dev, dtype=bf)
    hpc_l = gates.attn_bwd_head_chunk(577, 1024, 16)
    hpc_h = gates.attn_bwd_head_chunk(577, 1280, 16) or 1
    chunk_h, chunk_l = gates.mlp_chunk_size(1280, 5120), gates.mlp_chunk_size(1024, 4096)

    def attn_cost(x, w):
        m, s = x.shape[0] * x.shape[1], x.shape[1]
        return m * 2 * w * 2 + (4 * w * w + 6 * w) * 2, 8 * m * w * w + 4 * m * s * w

    def mlp_cost(x, w, inter):
        m = x.shape[0] * x.shape[1]
        return m * 2 * w * 2 + (2 * w * inter + 4 * w + inter) * 2, 4 * m * w * inter

    def attn_bwd_cost(x, w, full):
        """x and g read, dx and what is emitted written (xn, ctx, dqkv: 5W a
        row), the weights read (and their fp32 gradients written, ``full``);
        the recomputed forward, dctx, dxn (and dW) products and attention's
        four products of the backward and two of the recompute."""
        m, s = x.shape[0] * x.shape[1], x.shape[1]
        io = m * w * 2 * (3 + (0 if full else 5))
        wb = (4 * w * w + 6 * w) * (2 + (4 if full else 0))
        return io + wb, (22 if full else 14) * m * w * w + 12 * m * s * w

    def mlp_bwd_cost(x, w, inter):
        m = x.shape[0] * x.shape[1]
        return (m * (7 * w + 2 * inter) * 2 + (2 * w * inter + 2 * w + inter) * 2,
                6 * m * w * inter)

    sub = lambda out, idx: [t for i, t in enumerate(out) if i in idx]
    # (name, kernel call, twin call, yardstick, (bytes, operations), replaces or
    #  None, backward)
    cases = [
        ("fused_attention_block_wide",
         lambda: fb.fused_attention_block_wide(xH5, *pH[:6], 16, 1e-5, 4, False, 1),
         lambda: fb._reference_block(xH5, *pH[:6], 16, 1e-5), yard_attn(xH5, None, pH, 16),
         attn_cost(xH5, 1280), "nans_clip_tpu/ops/fused_block.py:491", False),
        ("fused_attention_block_wide[batch_tile=2]",
         lambda: fb.fused_attention_block_wide(xH5, *pH[:6], 16, 1e-5, 4, False, 2),
         lambda: fb._reference_block(xH5, *pH[:6], 16, 1e-5), yard_attn(xH5, None, pH, 16),
         attn_cost(xH5, 1280), "nans_clip_tpu/ops/fused_block.py:568", False),
        ("_fused_mlp_tiled_call",
         lambda: fb._fused_mlp_tiled_call(xH, *pH[6:], "quick_gelu", 1e-5, False, False,
                                          chunk_h),
         lambda: fb._reference_mlp(xH, *pH[6:], "quick_gelu", 1e-5, False),
         yard_mlp(xH, None, pH[6:]), mlp_cost(xH, 1280, 5120),
         "nans_clip_tpu/ops/fused_block.py:899", False),
        ("_fused_mlp_tiled_call[S=577, W=1024]",
         lambda: fb._fused_mlp_tiled_call(xL, *pL[6:], "quick_gelu", 1e-5, False, False,
                                          chunk_l),
         lambda: fb._reference_mlp(xL, *pL[6:], "quick_gelu", 1e-5, False),
         yard_mlp(xL, None, pL[6:]), mlp_cost(xL, 1024, 4096), None, False),
        ("_fused_mlp_batched_call",
         lambda: fb._fused_mlp_batched_call(xH, *pH[6:], "quick_gelu", 1e-5, False, False,
                                            chunk_h, 2),
         lambda: fb._reference_mlp(xH, *pH[6:], "quick_gelu", 1e-5, False),
         yard_mlp(xH, None, pH[6:]), mlp_cost(xH, 1280, 5120),
         "nans_clip_tpu/ops/fused_block.py:1005", False),
        ("_fused_mlp_batched_call[S=577, W=1024]",
         lambda: fb._fused_mlp_batched_call(xL, *pL[6:], "quick_gelu", 1e-5, False, False,
                                            chunk_l, 2),
         lambda: fb._reference_mlp(xL, *pL[6:], "quick_gelu", 1e-5, False),
         yard_mlp(xL, None, pL[6:]), mlp_cost(xL, 1024, 4096), None, False),
        ("fused_attention_block[dh=80]",
         lambda: fb.fused_attention_block(xH, *pH[:6], 16, 1e-5),
         lambda: fb._reference_block(xH, *pH[:6], 16, 1e-5), yard_attn(xH, None, pH, 16),
         attn_cost(xH, 1280), None, False),
        ("fused_mlp_block_bwd_chunked",
         lambda: fbb.fused_mlp_block_bwd_chunked(xH, *pH[6:11], gH, "quick_gelu", 1e-5, chunk_h,
                                                 2),
         lambda: sub(fbb._mlp_bwd_math(xH, *pH[6:], None, gH, "quick_gelu", 1e-5, False,
                                       full=False), (0, 1, 2, 3, 6)),
         yard_mlp(xH, gH, pH[6:]), mlp_bwd_cost(xH, 1280, 5120),
         "nans_clip_tpu/ops/fused_block_bwd.py:1015", True),
        ("fused_mlp_block_bwd_chunked[S=577, W=1024]",
         lambda: fbb.fused_mlp_block_bwd_chunked(xL, *pL[6:11], gL, "quick_gelu", 1e-5, chunk_l,
                                                 2),
         lambda: sub(fbb._mlp_bwd_math(xL, *pL[6:], None, gL, "quick_gelu", 1e-5, False,
                                       full=False), (0, 1, 2, 3, 6)),
         yard_mlp(xL, gL, pL[6:]), mlp_bwd_cost(xL, 1024, 4096), None, True),
        ("fused_attention_block_bwd_chunked",
         lambda: fbb.fused_attention_block_bwd_chunked(xL, *pL[:5], gL, 16, hpc_l),
         lambda: fbb.per_chunk(fbb._attn_bwd_math(xL, *pL[:5], gL, 16, 1e-5, full=False), 16,
                               hpc_l),
         yard_attn(xL, gL, pL, 16), attn_bwd_cost(xL, 1024, False),
         "nans_clip_tpu/ops/fused_block_bwd.py:1144", True),
        ("fused_attention_block_bwd_chunked[dh=80]",
         lambda: fbb.fused_attention_block_bwd_chunked(xH5, *pH[:5], gH5, 16, hpc_h),
         lambda: fbb.per_chunk(fbb._attn_bwd_math(xH5, *pH[:5], gH5, 16, 1e-5, full=False), 16,
                               hpc_h),
         yard_attn(xH5, gH5, pH, 16), attn_bwd_cost(xH5, 1280, False), None, True),
        ("fused_attention_block_bwd[dh=80]",
         lambda: fbb.fused_attention_block_bwd(xH, *pH[:5], gH, 16),
         lambda: fbb._attn_bwd_math(xH, *pH[:5], gH, 16, 1e-5, full=False),
         yard_attn(xH, gH, pH, 16), attn_bwd_cost(xH, 1280, False), None, True),
        ("fused_attention_block_bwd_fullgrad[dh=80]",
         lambda: fbb.fused_attention_block_bwd_fullgrad(xH, *pH[:5], gH, 16),
         lambda: fbb._attn_bwd_math(xH, *pH[:5], gH, 16, 1e-5),
         yard_attn(xH, gH, pH[:4] + (pH[4], zero_bo), 16), attn_bwd_cost(xH, 1280, True), None,
         True),
    ]
    results = {}
    _wide_reset()
    for name, kern, twin, yard, cost, replaces, bwd in cases:
        got, want = kern(), twin()
        torch.cuda.synchronize()
        if bwd:
            err, rel = 0.0, 0.0
            for i, (a, r) in enumerate(zip(got, want)):
                e, top = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
                if a.shape != r.shape or not torch.isfinite(a).all() or e > BWD_REL * top:
                    raise AssertionError(f"{name} output {i}: max abs err {e} exceeds "
                                         f"{BWD_REL} x {top}")
                err, rel = max(err, e), max(rel, e / max(top, 1e-30))
            if not all(torch.equal(a, r) for a, r in zip(got, kern())):
                raise AssertionError(f"{name}: two calls gave different bits")
            agree = f"largest error over max|twin| {rel:.4g} <= {BWD_REL} on {len(got)} outputs"
        else:
            err, bound = float((got.float() - want.float()).abs().max()), _ulps(want, 4)
            if got.shape != want.shape or not torch.isfinite(got).all() or err > bound:
                raise AssertionError(f"{name}: max abs err {err} exceeds bound {bound}")
            agree = f"<= bound {bound:.6g} (4 bf16 ulp)"
        del got, want
        ms, plain_ms, yard_ms = _time_ms(kern, 5), _time_ms(twin, 2), _time_ms(yard, 5)
        bound_ms, bound_by = _bound(*cost)
        print(f"wide kernel {name}: max_abs_err {err:.6g} {agree}; {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms, yardstick {yard_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {cost[1] / 1e9:.1f} GFLOP, {cost[0] / 1e6:.1f} MB)", flush=True)
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms, yard_ms=yard_ms,
                             bound_ms=bound_ms, bound_by=bound_by, replaces=replaces)
    direct = _wide_counts()
    del xH, gH, xH5, gH5, xL, gL, pH, pL
    torch.cuda.empty_cache()
    print(f"wide: kernels against their twins took {time.time() - t_phase:.1f} s", flush=True)

    # tower.cu at RoBERTa-large's width: 24 layers, batch 1 and 8
    w, inter, s = 1024, 4096, 52
    std = 0.02
    layers = [(rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(3 * w, w, std=std),
               rnd(3 * w, std=0.1), rnd(w, w, std=std), rnd(w, std=0.1),
               rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(inter, w, std=std),
               rnd(inter, std=0.1), rnd(w, inter, std=std / 2), rnd(w, std=0.1))
              for _ in range(24)]
    for b in (1, 8):
        x = rnd(b, s, w)
        lengths = torch.randint(2, s + 1, (b,), generator=g, device=dev)
        kb = ((1.0 - (torch.arange(s, device=dev)[None, :] < lengths[:, None]).float())
              * -10000.0).contiguous()
        args = (x, kb, layers, 16, 1e-12, "gelu", True)
        _check_tower_plan(tk, tk.MODE_BF16, b, s, w, 64)
        table = tk.TowerTable()
        got, want = tk.fused_tower(*args, table=table), tk.tower_math(*args)
        torch.cuda.synchronize()
        err, bound = float((got.float() - want.float()).abs().max()), _ulps(want, TOWER24_ULPS)
        if not (torch.isfinite(got).all() and err <= bound):
            raise AssertionError(f"tower at W=1024, b={b}: max abs err {err} exceeds {bound}")
        def per_layer():
            y = x
            for p in layers:
                y = lk.fused_layer_block(y, *p, 16, 1e-12, "gelu", True, kb)
            return y

        ms = _time_ms(lambda: tk.fused_tower(*args, table=table), 10)
        layer_ms = _time_ms(per_layer, 5)
        print(f"wide tower fused_tower[RoBERTa-large, b={b}]: max_abs_err {err:.6g} <= bound "
              f"{bound:.6g} ({TOWER24_ULPS} bf16 ulp); {ms:.4f} ms, per-layer route "
              f"{layer_ms:.4f} ms", flush=True)
    del layers

    # the train steps
    def build(struct, resolution=None, layers=None):
        cfg = nct.load_config(struct)
        if resolution:
            cfg = with_resolution(cfg, resolution)
        if layers:
            cfg = dataclasses.replace(
                cfg, vision=dataclasses.replace(cfg.vision, layers=layers),
                text=dataclasses.replace(cfg.text, num_hidden_layers=layers))
        return cfg, build_clip(cfg, "cpu", torch.Generator().manual_seed(0))

    def batch_for(cfg, b):
        gen = torch.Generator().manual_seed(11)
        r = cfg.vision.image_resolution
        images = torch.randn(b, r, r, 3, generator=gen).to(dev)
        ids = torch.from_numpy(nct.tokenize([f"{TEXTS[i % len(TEXTS)]}{i}" for i in range(b)]))
        return images, ids.to(dev)

    opts = lambda **kw: nct.ModelOptions(compute_dtype="bfloat16", deterministic=False, **kw)
    # a small rate and the same dropout seed on every step: on one fixed batch
    # the loss then falls step by step (Adam moves every weight by about the
    # rate, coherently, through 24-32 layers)
    tcfg = TrainConfig(lr=2e-5, warmup=2, max_steps=100)

    def expected_step(cfg):
        """Launches of one train step on the auto routes, from the shapes."""
        n_img, n_txt = cfg.vision.layers, cfg.text.num_hidden_layers
        s, w = cfg.vision.seq_len, cfg.vision.width
        wide_attn = not gates.fits_fused(s, w) and gates.fits_fused_wide(s, w)
        plan = fb.mlp_plan(WIDE_BATCH, s, w, 4 * w, 2)
        long_bwd = s > gates.ATTN_BWD_MAX_SEQ
        full_a = gates.BWD_ROUTE["attn_pre"] == "fullgrad" and not long_bwd
        mlp_emit = gates.BWD_ROUTE["mlp_pre"] == "emit"
        txt_full = {k: gates.BWD_ROUTE[k] == "fullgrad" for k in ("attn_post", "mlp_post")}
        return {"fused_attention_block": n_img * (not wide_attn),
                "fused_attention_block_wide": n_img * wide_attn,
                "fused_bert_attention_block": n_txt,
                "fused_mlp_block": n_txt + n_img * (plan is None),
                "_fused_mlp_batched_call": n_img * (plan is not None and plan[1] > 1),
                "_fused_mlp_tiled_call": n_img * (plan is not None and plan[1] == 1),
                "fused_attention_block_bwd_chunked": n_img * long_bwd,
                "fused_attention_block_bwd_fullgrad": n_img * full_a,
                "fused_attention_block_bwd": n_img * (not long_bwd and not full_a),
                "fused_bert_attention_block_bwd_fullgrad": n_txt * txt_full["attn_post"],
                "fused_bert_attention_block_bwd": n_txt * (not txt_full["attn_post"]),
                "fused_mlp_block_bwd_chunked": n_img * (plan is not None and mlp_emit),
                "fused_mlp_block_bwd": n_txt * (not txt_full["mlp_post"])
                + n_img * (plan is None and mlp_emit),
                "fused_mlp_block_bwd_fullgrad": n_txt * txt_full["mlp_post"]
                + n_img * (not mlp_emit),
                "fused_layer_block": 0, "fused_tower": 0, "fused_tower_int8": 0}

    def train(label, cfg, module, b, n_steps):
        """One step on the plain and on the kernel route from the same
        weights and seeds, compared; then ``n_steps`` kernel steps."""
        images, ids = batch_for(cfg, b)
        t0 = time.time()
        plain_state = create_train_state(copy.deepcopy(module).to(dev), tcfg, device=dev)
        plain_state, m = make_train_step(cfg, tcfg, opts(attn_impl="plain"))(
            plain_state, images, ids, 7)
        plain_loss = float(m["loss"])
        plain_grads = {n: p.grad for n, p in plain_state.module.named_parameters()}
        plain_s = time.time() - t0
        del plain_state
        torch.cuda.empty_cache()
        state = create_train_state(module.to(dev), tcfg, device=dev)
        step = make_train_step(cfg, tcfg, opts())
        want = expected_step(cfg)
        losses, events = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _wide_reset()
        for i in range(n_steps):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, metrics = step(state, images, ids, 7)
            ev[1].record()
            events.append(ev)
            losses.append(metrics["loss"])
            if i == 0:
                torch.cuda.synchronize()
                per_step = _wide_counts()
                _check_launches(f"{label}: one step", per_step, want)
                cos = {n: _cos(p.grad, plain_grads[n])
                       for n, p in state.module.named_parameters() if not n.endswith("key.bias")}
                worst = min(cos, key=cos.get)
                diff = abs(float(metrics["loss"]) - plain_loss)
                print(f"{label}: kernel vs plain route after one step: loss "
                      f"{float(metrics['loss']):.6f} vs {plain_loss:.6f} (|diff| {diff:.3g} <= "
                      f"{STEP_LOSS_BOUND}); gradient cosine >= {cos[worst]:.6f} ({worst}) over "
                      f"{len(cos)} tensors, bound {GRAD_COS_BOUND}; plain step {plain_s:.1f} s",
                      flush=True)
                if diff > STEP_LOSS_BOUND or cos[worst] < GRAD_COS_BOUND:
                    raise AssertionError(f"{label}: the kernel route's step differs from the "
                                         "plain route's")
                del plain_grads
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        total, peak = _wide_counts(), torch.cuda.max_memory_allocated()
        step_ms = [a.elapsed_time(e) for a, e in events]
        losses = [float(x) for x in losses]
        ms = sum(step_ms[1:]) / (n_steps - 1)
        nonzero = {k: v for k, v in per_step.items() if v}
        print(f"{label}: batch {b}, {n_steps} steps, loss {' '.join(f'{x:.5f}' for x in losses)}; "
              f"step ms {' '.join(f'{x:.2f}' for x in step_ms)}; steps 2-{n_steps} {ms:.2f} ms a "
              f"step, {b / ms * 1e3:.2f} pairs/s; peak memory (steps 2-{n_steps}) "
              f"{peak / 2 ** 30:.3f} GiB; launches "
              f"a step {json.dumps(nonzero)}", flush=True)
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: the loss did not fall over {n_steps} steps: {losses}")
        if any(total[k] != n_steps * v for k, v in per_step.items()):
            raise AssertionError(f"{label}: launches over {n_steps} steps {total} are not "
                                 f"{n_steps} x {per_step}")
        del state
        torch.cuda.empty_cache()
        return dict(ms=ms, pairs_s=b / ms * 1e3, peak=peak, per_step=per_step, losses=losses)

    steps = {}
    t0 = time.time()
    cfg_h, module_h = build(WIDE_H)
    n_params = sum(p.numel() for p in module_h.parameters())
    print(f"wide: {WIDE_H} random (seed 0), {n_params} fp32 parameters, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    eval_h = copy.deepcopy(module_h)
    steps["ViT-H-14"] = train("train ViT-H-14", cfg_h, module_h, WIDE_BATCH, 6)
    del module_h
    cfg_l, module_l = build(WIDE_L336)
    steps["ViT-L-14-336"] = train("train ViT-L-14-336", cfg_l, module_l, WIDE_BATCH, 6)
    del module_l
    cfg_t, module_t = build(WIDE_H, resolution=336, layers=4)
    steps["ViT-H-width@336px"] = train("train ViT-H-width@336px (4 + 4 layers)", cfg_t,
                                       module_t, WIDE_BATCH, 3)
    del module_t
    torch.cuda.empty_cache()

    # get_similarity of ViT-H-14 at batch 3 and 64 against the plain path (at
    # batch 1 the image tower takes tower.cu: phase 12)
    if ckpt_out is not None:
        t0 = time.time()
        torch.save({"state_dict": eval_h.state_dict()}, ckpt_out)
        print(f"wide: {WIDE_H} random (seed 0) saved in {time.time() - t0:.1f} s", flush=True)
    model = nct.CLIPModel(cfg_h, eval_h.to(dev), nct.ModelOptions(compute_dtype="bfloat16"))
    plain = nct.CLIPModel(cfg_h, model.module, nct.ModelOptions(compute_dtype="bfloat16",
                                                                attn_impl="plain"))
    forward = {}
    for b in (3, 64):
        images, ids = batch_for(cfg_h, b)
        _wide_reset()
        li, lt = model.get_similarity(images, ids)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _wide_counts().items() if v}
        pli = plain.get_similarity(images, ids)[0]
        err = float((li - pli).abs().max())
        ms = _time_ms(lambda: model.get_similarity(images, ids), 5)
        plain_ms = _time_ms(lambda: plain.get_similarity(images, ids), 2)
        print(f"wide get_similarity ViT-H-14 batch {b}: kernel vs plain bf16 max abs err "
              f"{err:.6g} <= bound {WIDE_LOGIT_BOUND}; {ms:.2f} ms ({b / ms * 1e3:.1f} pairs/s), "
              f"plain path {plain_ms:.2f} ms; launches {json.dumps(counts)}", flush=True)
        if li.shape != (b, b) or not torch.isfinite(li).all() or not torch.equal(lt, li.T) \
                or err > WIDE_LOGIT_BOUND:
            raise AssertionError(f"ViT-H-14 get_similarity at batch {b}: shape "
                                 f"{tuple(li.shape)}, error {err}")
        forward[b] = counts
    del model, plain, eval_h
    torch.cuda.empty_cache()
    print(f"wide: phase 9 took {time.time() - t_phase:.1f} s", flush=True)
    return results, steps, forward, direct


# Phase 10, the ``attn_impl="pallas"`` route. #22's output against its twin:
# 2 bf16 ulps of max|twin| (one for o's own rounding, one for P, which the
# card rounds to bf16 before P V and the twin, as the JAX kernel, keeps in
# fp32); its lse (fp32 sums of exact bf16 products in another order): 1e-4 of
# max(1, max|lse|). #23's dq, dk, dv: BWD_REL of max|twin|, as every backward
# chain (P and dS are rounded to bf16 as mma inputs).
FLASH_ULPS, LSE_REL = 2, 1e-4
# (B, H, S, dh, masked): the ViT-B batch path, RoBERTa-base (key bias from
# tokenized lengths), ViT-H, ViT-L-14-336 and MAX_PALLAS_SEQ.
FLASH_SHAPES = [(256, 12, 197, 64, False), (256, 12, 52, 64, True), (32, 16, 257, 80, False),
                (32, 16, 577, 64, False), (4, 16, 1024, 64, False)]
# flash_attention_block at ViT-L-14-336's layer (B, S, W, heads); #24's rows.
FLASH_BLOCK_SHAPE = (32, 577, 1024, 16)
PALLAS_LN_SHAPES = [(50432, 768), (16 * 577, 1280)]
PALLAS_L336 = "ViT-L-14-336@RoBERTa-wwm-ext-base-chinese"
# get_similarity on the pallas route against the fused (kernel) route, both
# bf16, the same weights and inputs: the kernel-vs-plain bound of phase 5.
PALLAS_LOGIT_BOUND = 0.05


def _flash_counts():
    from nans_clip_tpu_torch.ops.attention import flash_bwd, flash_fwd
    from nans_clip_tpu_torch.ops.layernorm import pallas_layer_norm

    return {"attention_pallas": flash_fwd.launches, "attention_pallas_bwd": flash_bwd.launches,
            "pallas_layer_norm": pallas_layer_norm.launches}


def _flash_reset():
    from nans_clip_tpu_torch.ops.attention import flash_bwd, flash_fwd
    from nans_clip_tpu_torch.ops.layernorm import pallas_layer_norm

    flash_fwd.launches = flash_bwd.launches = pallas_layer_norm.launches = 0
    _wide_reset()


def phase_pallas(torch, dev):
    """Phase 10: the ``attn_impl="pallas"`` route. #22 and #23 against their
    twins at five shapes up to S = 1024, ``flash_attention_block`` and
    ``pallas_layer_norm`` (#24) against theirs (direct calls), then
    ``get_similarity`` of ViT-B-16 at batch 256 on the route against the
    ``fused`` route, and ViT-L-14-336 train steps on the route (one against
    the ``fused`` route, then 4)."""
    import copy

    import torch.nn.functional as F

    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.ops import attention as A
    from nans_clip_tpu_torch.ops.layernorm import layer_norm, pallas_layer_norm
    from nans_clip_tpu_torch.training import TrainConfig, create_train_state, make_train_step

    t_phase = time.time()
    g = torch.Generator(device=dev).manual_seed(20)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

    def check(name, got, want, bound):
        err = float((got.float() - want.float()).abs().max())
        if got.shape != want.shape or not torch.isfinite(got).all() or err > bound:
            raise AssertionError(f"{name}: max abs err {err} exceeds bound {bound}")
        return err

    results = {}
    _flash_reset()
    for b, h, s, dh, masked in FLASH_SHAPES:
        tag = f"({b}, {h}, {s}, {dh}){', masked' if masked else ''}"
        # q, k, v as the tower gives them: views of one packed projection
        q, k, v = rnd(b, s, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)
        kb = None
        if masked:
            lengths = torch.randint(2, s + 1, (b,), generator=g, device=dev)
            kb = ((torch.arange(s, device=dev)[None, :] >= lengths[:, None]).float()
                  * -10000.0).contiguous()
        do = rnd(b, h, s, dh)
        _check_flash_bwd_plan(b, h, s, dh)
        o, lse = A.flash_fwd(q, k, v, kb)
        o_t, lse_t = A.attention_pallas_plain(q, k, v, kb)
        grads = A.flash_bwd(q, k, v, kb, o, do, lse)
        grads_t = A.attention_pallas_bwd_plain(q, k, v, kb, o, do, lse)
        torch.cuda.synchronize()
        err_o = check(f"#22 {tag} o", o, o_t, _ulps(o_t, FLASH_ULPS))
        err_l = check(f"#22 {tag} lse", lse, lse_t,
                      LSE_REL * max(1.0, float(lse_t.abs().max())))
        err_g = max(check(f"#23 {tag} {n}", a, r, BWD_REL * float(r.float().abs().max()))
                    for n, a, r in zip(("dq", "dk", "dv"), grads, grads_t))
        if not all(torch.equal(x, y) for x, y in zip(grads, A.flash_bwd(q, k, v, kb, o, do,
                                                                         lse))):
            raise AssertionError(f"#23 {tag}: two calls gave different bits")
        del o_t, lse_t, grads, grads_t
        mask = None if kb is None else kb.view(b, 1, 1, s).to(bf)
        sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask)
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        lout = sdpa(lq, lk, lv)
        io = b * h * s * dh * 2
        fwd_cost = (4 * io + b * h * s * 4 + (b * s * 4 if masked else 0), 4 * b * h * s * s * dh)
        bwd_cost = (8 * io + b * h * s * 4 + (b * s * 4 if masked else 0), 10 * b * h * s * s * dh)
        timing = {
            "fwd": (_time_ms(lambda: A.flash_fwd(q, k, v, kb), 10),
                    _time_ms(lambda: A.attention_pallas_plain(q, k, v, kb), 2),
                    _time_ms(lambda: sdpa(q, k, v), 10), _bound(*fwd_cost)),
            "bwd": (_time_ms(lambda: A.flash_bwd(q, k, v, kb, o, do, lse), 10),
                    _time_ms(lambda: A.attention_pallas_bwd_plain(q, k, v, kb, o, do, lse), 2),
                    _time_ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), do,
                                                         retain_graph=True), 10),
                    _bound(*bwd_cost))}
        for part, err, what in (("fwd", err_o, f"o {err_o:.6g} <= {FLASH_ULPS} bf16 ulp, lse "
                                                f"{err_l:.3g}"),
                                ("bwd", err_g, f"dq/dk/dv {err_g:.6g} <= {BWD_REL} x max|twin|, "
                                               "the same bits twice")):
            ms, plain_ms, lib_ms, (bound_ms, bound_by) = timing[part]
            name = "attention_pallas" if part == "fwd" else "attention_pallas_bwd"
            cost = fwd_cost if part == "fwd" else bwd_cost
            lib = "SDPA" if part == "fwd" else "SDPA backward"
            print(f"pallas kernel {name} {tag}: max_abs_err {what}; {ms:.4f} ms, twin "
                  f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms ({lib}), "
                  f"bound {bound_ms:.4f} ms ({bound_by}; {cost[1] / 1e9:.1f} GFLOP, "
                  f"{cost[0] / 1e6:.1f} MB)", flush=True)
            results[(name, (b, h, s, dh))] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                                  library_ms=lib_ms, bound_ms=bound_ms,
                                                  bound_by=bound_by)
        del q, k, v, do, o, lse, lq, lk, lv, lout
        torch.cuda.empty_cache()
    print(json.dumps({"phase10": "flash kernels", "results": [
        dict(name=n, shape=list(shape), **r) for (n, shape), r in results.items()]}), flush=True)

    # flash_attention_block (direct calls) at ViT-L-14-336's layer shape
    bb, s, w, heads = FLASH_BLOCK_SHAPE
    x, gout = rnd(bb, s, w), rnd(bb, s, w)
    p = (rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(3 * w, w, std=w ** -0.5),
         rnd(3 * w, std=0.1), rnd(w, w, std=w ** -0.5), rnd(w, std=0.1))

    def twin_block(xr, lw, lb, wqkv, bqkv, wo, bo):
        xn = layer_norm(xr, lw, lb, 1e-5)
        qq, kk, vv = (A.split_heads(t, heads) for t in F.linear(xn, wqkv, bqkv).chunk(3, -1))
        return xr + F.linear(A.merge_heads(A.attention_pallas_plain(qq, kk, vv)[0]), wo, bo)

    def yard_block(xr, lw, lb, wqkv, bqkv, wo, bo):
        xn = F.layer_norm(xr, (w,), lw, lb, 1e-5)
        qq, kk, vv = (A.split_heads(t, heads) for t in F.linear(xn, wqkv, bqkv).chunk(3, -1))
        return xr + F.linear(A.merge_heads(F.scaled_dot_product_attention(qq, kk, vv)), wo, bo)

    def fwd_bwd(fn):
        args = [t.detach().requires_grad_() for t in (x, *p)]
        return lambda: (lambda out: (out,) + torch.autograd.grad(out, args, gout))(fn(*args))

    kern = fwd_bwd(lambda *a: A.flash_attention_block(*a, heads, 1e-5))
    twin, yard = fwd_bwd(twin_block), fwd_bwd(yard_block)
    got, want = kern(), twin()
    torch.cuda.synchronize()
    err_f = check("flash_attention_block out", got[0], want[0], _ulps(want[0], 4))
    err_g = max(check(f"flash_attention_block d{n}", a, r, BWD_REL * float(r.float().abs().max()))
                for n, a, r in zip(("x", "ln_w", "ln_b", "wqkv", "bqkv", "wo", "bo"),
                                   got[1:], want[1:]))
    del got, want
    m = bb * s
    cost = (m * w * 2 * 5 + (4 * w * w + 6 * w) * 2 * 2 + bb * heads * s * 4,
            30 * m * w * w + 14 * bb * s * s * w)
    ms, plain_ms, yard_ms = _time_ms(kern, 5), _time_ms(twin, 2), _time_ms(yard, 5)
    bound_ms, bound_by = _bound(*cost)
    print(f"pallas flash_attention_block ({bb}, {s}, {w}, {heads} heads), forward and the 7 "
          f"gradients: max_abs_err out {err_f:.6g} <= 4 bf16 ulp, gradients {err_g:.6g} <= "
          f"{BWD_REL} x max|twin|; {ms:.4f} ms, twin {plain_ms:.4f} ms, library {yard_ms:.4f} "
          f"ms (F.layer_norm/F.linear/SDPA autograd), bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    print(json.dumps({"phase10": "flash_attention_block", "shape": [bb, s, w, heads],
                      "err_out": err_f, "err_grads": err_g, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": yard_ms, "bound_ms": bound_ms, "bound_by": bound_by}),
          flush=True)
    del x, gout, p
    torch.cuda.empty_cache()

    # pallas_layer_norm (#24, direct calls)
    for rows, w in PALLAS_LN_SHAPES:
        x = rnd(rows, w)
        lw, lb = rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1)
        err = check(f"pallas_layer_norm [{rows}, {w}]", pallas_layer_norm(x, lw, lb),
                    layer_norm(x, lw, lb), _ulps(layer_norm(x, lw, lb), 1))
        ms = _time_ms(lambda: pallas_layer_norm(x, lw, lb), 10)
        plain_ms = _time_ms(lambda: layer_norm(x, lw, lb), 3)
        lib_ms = _time_ms(lambda: F.layer_norm(x, (w,), lw, lb, 1e-5), 10)
        bound_ms, bound_by = _bound(2 * rows * w * 2 + 2 * w * 2, 8 * rows * w)
        print(f"pallas kernel pallas_layer_norm [{rows}, {w}]: max_abs_err {err:.6g} <= 1 bf16 "
              f"ulp; {ms:.4f} ms, twin {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
              f"(F.layer_norm), bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        results[("pallas_layer_norm", (rows, w))] = dict(
            err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by)
    direct = _flash_counts()
    print(json.dumps({"phase10": "pallas_layer_norm", "results": [
        dict(shape=list(shape), **r) for (n, shape), r in results.items()
        if n == "pallas_layer_norm"]}), flush=True)
    print(f"pallas: direct-call launches {json.dumps(direct)}; kernels took "
          f"{time.time() - t_phase:.1f} s", flush=True)

    # get_similarity of ViT-B-16 at batch 256 on the route, from a .pt through
    # load_from_name, against the fused route on the same weights and inputs
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "clip_cn_vit-b-16_random.pt")
        cfg = nct.load_config(f"{VISION}@{TEXT}")
        torch.save({"state_dict": build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
                    .state_dict()}, ckpt)
        load = lambda impl: nct.load_from_name(
            ckpt, vision_model_name=VISION, text_model_name=TEXT, input_resolution=224,
            device=dev, options=nct.ModelOptions(compute_dtype="bfloat16", attn_impl=impl))[0]
        model, fused = load("pallas"), load("fused")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen).to(dev)
    ids = torch.from_numpy(nct.tokenize((TEXTS * BATCH)[:BATCH])).to(dev)
    _flash_reset()
    li, lt = model.get_similarity(images, ids)
    torch.cuda.synchronize()
    flash, others = _flash_counts(), {k: v for k, v in _wide_counts().items() if v}
    n_layers = cfg.vision.layers + cfg.text.num_hidden_layers
    if flash["attention_pallas"] != n_layers or flash["attention_pallas_bwd"] or others:
        raise AssertionError(f"pallas get_similarity: launches {flash}, {others}; expected "
                             f"{n_layers} of #22 and none of the fused kernels")
    fli = fused.get_similarity(images, ids)[0]
    feats = [(model.encode_image(images), fused.encode_image(images)),
             (model.encode_text(ids), fused.encode_text(ids))]
    feat_err = [float((a.float() - r.float()).abs().max()) for a, r in feats]
    err = float((li - fli).abs().max())
    if li.shape != (BATCH, BATCH) or not torch.isfinite(li).all() or not torch.equal(lt, li.T) \
            or err > PALLAS_LOGIT_BOUND:
        raise AssertionError(f"pallas get_similarity: shape {tuple(li.shape)}, logits {err} "
                             f"from the fused route")
    ms = _time_ms(lambda: model.get_similarity(images, ids), 5)
    fused_ms = _time_ms(lambda: fused.get_similarity(images, ids), 5)
    print(f"pallas get_similarity ViT-B-16 batch {BATCH}: {ms:.2f} ms, {BATCH / ms * 1e3:.1f} "
          f"pairs/s (fused route {fused_ms:.2f} ms, {BATCH / fused_ms * 1e3:.1f} pairs/s); "
          f"vs fused: logits max abs diff {err:.6g} <= {PALLAS_LOGIT_BOUND}, image features "
          f"{feat_err[0]:.6g}, text features {feat_err[1]:.6g}; launches {json.dumps(flash)}",
          flush=True)
    print(json.dumps({"phase10": "get_similarity", "batch": BATCH, "ms": ms,
                      "pairs_s": BATCH / ms * 1e3, "fused_ms": fused_ms, "logits_diff": err,
                      "image_feature_diff": feat_err[0], "text_feature_diff": feat_err[1],
                      "launches": flash}), flush=True)
    forward = dict(flash)
    del model, fused, images, ids, li, lt, fli, feats
    torch.cuda.empty_cache()

    # ViT-L-14-336 train steps on the route, the preset's text dropout 0.1
    cfg = nct.load_config(PALLAS_L336)
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(11)
    r = cfg.vision.image_resolution
    images = torch.randn(WIDE_BATCH, r, r, 3, generator=gen).to(dev)
    ids = torch.from_numpy(nct.tokenize([f"{TEXTS[i % len(TEXTS)]}{i}"
                                         for i in range(WIDE_BATCH)])).to(dev)
    tcfg = TrainConfig(lr=2e-5, warmup=2, max_steps=100)
    opts = lambda impl: nct.ModelOptions(compute_dtype="bfloat16", deterministic=False,
                                         attn_impl=impl)
    t0 = time.time()
    fused_state = create_train_state(copy.deepcopy(module).to(dev), tcfg, device=dev)
    fused_state, m = make_train_step(cfg, tcfg, opts("fused"))(fused_state, images, ids, 7)
    fused_loss = float(m["loss"])
    fused_grads = {n: p.grad for n, p in fused_state.module.named_parameters()}
    fused_s = time.time() - t0
    del fused_state
    torch.cuda.empty_cache()
    state = create_train_state(module.to(dev), tcfg, device=dev)
    step = make_train_step(cfg, tcfg, opts("pallas"))
    n_steps, losses, events = 5, [], []
    torch.cuda.synchronize()
    _flash_reset()
    for i in range(n_steps):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, metrics = step(state, images, ids, 7)
        ev[1].record()
        events.append(ev)
        losses.append(metrics["loss"])
        if i == 0:
            torch.cuda.synchronize()
            per_step = _flash_counts()
            others = {k: v for k, v in _wide_counts().items() if v}
            n_img = cfg.vision.layers
            if (per_step["attention_pallas"] != n_img or per_step["attention_pallas_bwd"] != n_img
                    or others):
                raise AssertionError(f"pallas step: launches {per_step}, {others}; expected "
                                     f"{n_img} of #22 and #23 (the text tower's attention is "
                                     "the plain one under dropout) and none of the fused kernels")
            cos = {n: _cos(p.grad, fused_grads[n]) for n, p in state.module.named_parameters()
                   if not n.endswith("key.bias")}
            worst = min(cos, key=cos.get)
            diff = abs(float(metrics["loss"]) - fused_loss)
            print(f"pallas train ViT-L-14-336: pallas vs fused route after one step: loss "
                  f"{float(metrics['loss']):.6f} vs {fused_loss:.6f} (|diff| {diff:.3g} <= "
                  f"{STEP_LOSS_BOUND}); gradient cosine >= {cos[worst]:.6f} ({worst}) over "
                  f"{len(cos)} tensors, bound {GRAD_COS_BOUND}; fused step {fused_s:.1f} s",
                  flush=True)
            if diff > STEP_LOSS_BOUND or cos[worst] < GRAD_COS_BOUND:
                raise AssertionError("pallas train: the pallas route's step differs from the "
                                     "fused route's")
            # the allocator keeps its blocks: emptying it here made step 2
            # pay for cudaMalloc again (852-1751 ms against ~420)
            del fused_grads
            torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    total, peak = _flash_counts(), torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(e) for a, e in events]
    losses = [float(x) for x in losses]
    ms = sum(step_ms[1:]) / (n_steps - 1)
    median = sorted(step_ms[1:])[(n_steps - 1) // 2]   # the upper median of steps 2-n
    print(f"pallas train ViT-L-14-336: batch {WIDE_BATCH}, {n_steps} steps, loss "
          f"{' '.join(f'{x:.5f}' for x in losses)}; step ms {' '.join(f'{x:.2f}' for x in step_ms)};"
          f" steps 2-{n_steps} {ms:.2f} ms a step (upper median {median:.2f}), "
          f"{WIDE_BATCH / ms * 1e3:.2f} pairs/s; peak "
          f"memory (steps 2-{n_steps}) {peak / 2 ** 30:.3f} GiB ({peak} bytes); launches a step "
          f"{json.dumps(per_step)}", flush=True)
    print(json.dumps({"phase10": "train ViT-L-14-336", "batch": WIDE_BATCH, "losses": losses,
                      "step_ms": step_ms, "mean_ms": ms, "upper_median_ms": median,
                      "pairs_s": WIDE_BATCH / ms * 1e3, "peak_bytes": peak,
                      "loss_diff_vs_fused": diff, "min_grad_cos_vs_fused": cos[worst],
                      "launches": per_step}), flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"pallas train: the loss did not fall over {n_steps} steps: {losses}")
    if any(total[k] != n_steps * v for k, v in per_step.items()):
        raise AssertionError(f"pallas train: launches {total} are not {n_steps} x {per_step}")
    del state, module, images, ids
    torch.cuda.empty_cache()
    print(f"pallas: phase 10 took {time.time() - t_phase:.1f} s", flush=True)
    return results, direct, forward, per_step


# Phase 11, tensor parallelism. (label, tp, batch, S, W, heads, I, post-LN,
# act): a rank's shapes of the slice's towers and of ViT-H-14.
TP_CASES = [("ViT-B-16 tp 2", 2, 256, 197, 768, 12, 3072, False, "quick_gelu"),
            ("ViT-B-16 tp 4", 4, 256, 197, 768, 12, 3072, False, "quick_gelu"),
            ("RoBERTa-base tp 2", 2, 256, 52, 768, 12, 3072, True, "gelu"),
            ("ViT-H-14 tp 2", 2, 32, 257, 1280, 16, 5120, False, "quick_gelu")]
# #11 / #12 against their twins: 4 bf16 ulps of max|twin|, as #1 / #2 (the
# same chains). The tp ranks' partials summed as the TP path sums them (bf16
# adds of the partials, then + x, then + bias) against the unsharded #1 / #2,
# which sum in fp32 and round once: each partial's rounding and each bf16 add
# moves the result by up to half an ulp, 5 at tp 4; 8 ulps.
PARTIAL_ULPS, TP_SUM_ULPS = 4, 8
# get_similarity at tp 2 against tp 1 on the kernel route, the same weights
# and inputs: phase 5's kernel-vs-plain bound (0.05) doubled, since each of
# the 24 layers rounds its reduced sum and the residual sums in bf16 (the
# fused route keeps them in fp32) and the post-LN runs on the bf16 sum.
TP_LOGIT_BOUND = 0.1
TP_TRAIN_STEPS = 4
# Steps with text dropout under tp 2 against tp 1: each step's loss and
# gradient cosines against tp 1's from the same weights and seed, the bounds
# of phase 7 (STEP_LOSS_BOUND, GRAD_COS_BOUND).
TP_DROPOUT_STEPS = 2


def _tp_counted():
    from nans_clip_tpu_torch.ops import fused_block as fb

    return {"fused_attention_block_partial": fb.fused_attention_block_partial,
            "fused_mlp_block_partial": fb.fused_mlp_block_partial, **_counted()}


def _tp_counts():
    out = {name: fn.launches for name, fn in _tp_counted().items()}
    out.update(_tower_counts())
    return out


def _tp_reset():
    _reset_counts()
    for fn in _tp_counted().values():
        fn.launches = 0


def _tp_rank(rank: int, ckpt: str) -> dict:
    """One rank of phase 11's real path: ``get_similarity`` at ``tp=2`` and
    at ``tp=1``, then the TP train steps."""
    import torch

    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.training import TrainConfig, create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    load = lambda tp: nct.load_from_name(
        ckpt, vision_model_name=VISION, text_model_name=TEXT, input_resolution=224, device=dev,
        options=nct.ModelOptions(compute_dtype="bfloat16", tp=tp))[0]
    model = load(2)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen).to(dev)
    ids = torch.from_numpy(nct.tokenize((TEXTS * BATCH)[:BATCH])).to(dev)
    _tp_reset()
    li, lt = model.get_similarity(images, ids)
    torch.cuda.synchronize()
    out = {"counts": _tp_counts(), "logits": li.cpu().numpy(),
           "transposed": bool(torch.equal(lt, li.T)),
           "ms": _time_ms(lambda: model.get_similarity(images, ids), 3)}
    del model
    # both ranks, so that they reach the train step's collectives together
    ref = load(1)
    out["logits_tp1"] = ref.get_similarity(images, ids)[0].cpu().numpy()
    out["ms_tp1"] = _time_ms(lambda: ref.get_similarity(images, ids), 3)
    del ref
    del images, ids, li, lt
    torch.cuda.empty_cache()

    cfg = nct.load_config(f"{VISION}@{TEXT}")
    tcfg = TrainConfig(lr=1e-3, warmup=2, max_steps=100)
    opts = lambda tp: nct.ModelOptions(tp=tp, deterministic=True, compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(11)
    images = torch.randn(TRAIN_BATCH, 224, 224, 3, generator=gen).to(dev)
    ids = torch.from_numpy(nct.tokenize([f"{TEXTS[i % len(TEXTS)]}{i}"
                                         for i in range(TRAIN_BATCH)])).to(dev)
    # the first step at tp 1 (the kernel route) from the same weights: the
    # TP step's yardstick
    ref = create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)), tcfg,
                             device=dev)
    ref, m1 = make_train_step(cfg, tcfg, opts(1))(ref, images, ids, None)
    out["loss_tp1"] = float(m1["loss"])
    ref_grads = {n: p.grad for n, p in ref.module.named_parameters()}
    del ref, m1
    torch.cuda.empty_cache()
    state = create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)), tcfg,
                               device=dev)
    step = make_train_step(cfg, tcfg, opts(2))
    losses, step_ms, prints = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TP_TRAIN_STEPS):
        if i == 0:
            _tp_reset()
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, metrics = step(state, images, ids, None)
        ev[1].record()
        ev[1].synchronize()
        if i == 0:
            out["step_counts"] = _tp_counts()
            # the key projection's bias gradient is 0 in exact arithmetic
            cos = {n: _cos(p.grad, ref_grads[n]) for n, p in state.module.named_parameters()
                   if not n.endswith("key.bias")}
            out["worst_cos"] = min(cos.items(), key=lambda kv: kv[1])
            del ref_grads
        step_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(metrics["loss"]))
        # the bits of every parameter, summed as int64 a tensor: equal on
        # both ranks when their parameters are
        prints.append([int(p.detach().view(torch.int32).sum(dtype=torch.int64))
                       for p in state.module.parameters()])
    out.update(losses=losses, step_ms=step_ms, fingerprints=prints,
               peak=torch.cuda.max_memory_allocated())
    del state, step
    torch.cuda.empty_cache()

    # text dropout 0.1 under tp 2 (the JAX unfused path under TP: the twins,
    # with the masks one process draws) against tp 1 (the kernel route, whose
    # kernels draw the same masks), each step from the same weights (tp 1's
    # copied from tp 2's) and the same seed
    dopts = lambda tp: nct.ModelOptions(tp=tp, deterministic=False, compute_dtype="bfloat16")
    fresh = lambda: create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)),
                                       tcfg, device=dev)
    ref, ref_step = fresh(), make_train_step(cfg, tcfg, dopts(1))
    state, step = fresh(), make_train_step(cfg, tcfg, dopts(2))
    drop_out = {"losses": [], "losses_tp1": [], "worst_cos": [], "fingerprints": [],
                "step_ms": []}
    for i in range(TP_DROPOUT_STEPS):
        with torch.no_grad():
            for p_ref, p_tp in zip(ref.module.parameters(), state.module.parameters()):
                p_ref.copy_(p_tp)
        ref, m1 = ref_step(ref, images, ids, 100 + i)
        ref_grads = {n: p.grad for n, p in ref.module.named_parameters()}
        if i == 0:
            _tp_reset()
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, m2 = step(state, images, ids, 100 + i)
        ev[1].record()
        ev[1].synchronize()
        if i == 0:
            drop_out["counts"] = _tp_counts()
        cos = {n: _cos(p.grad, ref_grads[n]) for n, p in state.module.named_parameters()
               if not n.endswith("key.bias")}
        drop_out["worst_cos"].append(min(cos.items(), key=lambda kv: kv[1]))
        drop_out["losses"].append(float(m2["loss"]))
        drop_out["losses_tp1"].append(float(m1["loss"]))
        drop_out["step_ms"].append(ev[0].elapsed_time(ev[1]))
        drop_out["fingerprints"].append([int(p.detach().view(torch.int32).sum(dtype=torch.int64))
                                         for p in state.module.parameters()])
        del ref_grads
    out["dropout"] = drop_out
    return out


def phase_tp(torch, dev):
    """Phase 11: #11 / #12 against their twins at a rank's shapes, the tp
    ranks' sum against #1 / #2, then ``get_similarity`` and train steps in 2
    ranks on ``cuda:0`` (gloo)."""
    import torch.nn.functional as F

    import numpy as np

    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.ops import fused_block as fb
    from nans_clip_tpu_torch.parallel import mesh

    t_phase = time.time()
    g = torch.Generator(device=dev).manual_seed(30)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

    def check(name, got, want, n_ulps):
        err, bound = float((got.float() - want.float()).abs().max()), _ulps(want, n_ulps)
        if got.shape != want.shape or not torch.isfinite(got).all() or err > bound:
            raise AssertionError(f"{name}: max abs err {err} exceeds bound {bound}")
        return err, bound

    results = {}
    for label, tp, b, s, w, heads, inter, post_ln, act in TP_CASES:
        eps = 1e-12 if post_ln else 1e-5
        std = 0.02 if post_ln else w ** -0.5
        x = rnd(b, s, w)
        lw, lb = rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1)
        wqkv, bqkv, wo, bo = rnd(3 * w, w, std=std), rnd(3 * w, std=0.1), rnd(w, w, std=std), \
            rnd(w, std=0.1)
        w1, b1, w2, b2 = rnd(inter, w, std=std), rnd(inter, std=0.1), \
            rnd(w, inter, std=std / 2), rnd(w, std=0.1)
        kb = None
        if post_ln:
            lengths = torch.randint(2, s + 1, (b,), generator=g, device=dev)
            kb = ((torch.arange(s, device=dev)[None, :] >= lengths[:, None]).float()
                  * -10000.0).contiguous()
        hl, wl, il, m = heads // tp, w // tp, inter // tp, b * s
        ranks = []
        for r in range(tp):
            wq, bq = mesh.qkv_slice(wqkv, bqkv, heads, r, tp)
            ranks.append((wq, bq, mesh.column_slice(wo, r, tp), mesh.row_slice(w1, r, tp),
                          mesh.row_slice(b1, r, tp), mesh.column_slice(w2, r, tp)))
        wq, bq, wol, w1l, b1l, w2l = ranks[0]
        ln_lib = (lambda t: t) if post_ln else (lambda t: F.layer_norm(t, (w,), lw, lb, eps))
        mask = None if kb is None else kb.view(b, 1, 1, s).to(bf)

        def attn_lib():
            q, k, v = F.linear(ln_lib(x), wq, bq).view(b, s, 3, hl, w // heads).permute(
                2, 0, 3, 1, 4).unbind(0)
            ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            return F.linear(ctx.transpose(1, 2).reshape(b, s, wl), wol)

        act_lib = F.gelu if act == "gelu" else (lambda t: t * torch.sigmoid(1.702 * t))
        with torch.no_grad():
            cases = (
                ("fused_attention_block_partial", "F.linear + SDPA + F.linear",
                 lambda: fb.fused_attention_block_partial(x, lw, lb, wq, bq, wol, kb, hl, eps,
                                                          not post_ln),
                 lambda: fb._reference_block_partial(x, lw, lb, wq, bq, wol, hl, eps, not post_ln,
                                                     kb),
                 attn_lib,
                 (2 * m * w * 2 + 4 * wl * w * 2 + (3 * wl + 2 * w) * 2 + (b * s * 4 if post_ln
                                                                          else 0),
                  2 * m * w * 4 * wl + 4 * b * s * s * wl)),
                ("fused_mlp_block_partial", "F.linear + act + F.linear",
                 lambda: fb.fused_mlp_block_partial(x, lw, lb, w1l, b1l, w2l, act, eps,
                                                    not post_ln),
                 lambda: fb._reference_mlp_partial(x, lw, lb, w1l, b1l, w2l, act, eps, not post_ln),
                 lambda: F.linear(act_lib(F.linear(ln_lib(x), w1l, b1l)), w2l),
                 (2 * m * w * 2 + 2 * il * w * 2 + (il + 2 * w) * 2, 4 * m * w * il)))
            for name, lib_name, kern, twin, lib, cost in cases:
                got, want = kern(), twin()
                torch.cuda.synchronize()
                err, bound = check(f"{name} {label}", got, want, PARTIAL_ULPS)
                del got, want
                ms, plain_ms, lib_ms = _time_ms(kern, 10), _time_ms(twin, 2), _time_ms(lib, 10)
                bound_ms, bound_by = _bound(*cost)
                print(f"tp kernel {name} {label} ({b}, {s}, {w}; {hl} heads of {w // heads}, "
                      f"QKV N {3 * wl}, I {il} a rank): max_abs_err {err:.6g} <= {bound:.6g} "
                      f"({PARTIAL_ULPS} bf16 ulp); {ms:.4f} ms, twin {plain_ms:.4f} ms, library "
                      f"{lib_ms:.4f} ms ({lib_name}{'' if post_ln else ', after F.layer_norm'}), "
                      f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
                results[(name, label)] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                              bound_ms=bound_ms, bound_by=bound_by)
            if not post_ln and w == 768:
                # the ranks' sum, as the TP path forms it, against the unsharded kernels
                parts_a = [fb.fused_attention_block_partial(x, lw, lb, q_, b_, o_, None, hl, eps,
                                                            True) for q_, b_, o_, *_ in ranks]
                parts_m = [fb.fused_mlp_block_partial(x, lw, lb, a_, c_, d_, act, eps, True)
                           for *_, a_, c_, d_ in ranks]
                for name, parts, bias, full in (
                        ("#11 sum vs #1", parts_a, bo,
                         fb.fused_attention_block(x, lw, lb, wqkv, bqkv, wo, bo, heads)),
                        ("#12 sum vs #2", parts_m, b2,
                         fb.fused_mlp_block(x, lw, lb, w1, b1, w2, b2, act, eps))):
                    red = parts[0]
                    for part in parts[1:]:
                        red = red + part
                    err, bound = check(f"{name} {label}", x + red + bias, full, TP_SUM_ULPS)
                    print(f"tp {name} ({label}): the {tp} ranks' partials + x + bias in bf16 vs "
                          f"the unsharded kernel: max abs err {err:.6g} <= {bound:.6g} "
                          f"({TP_SUM_ULPS} bf16 ulp)", flush=True)
                del parts_a, parts_m
        del x, ranks, wqkv, wo, w1, w2
        torch.cuda.empty_cache()
    print(json.dumps({"phase11": "partial kernels", "results": [
        dict(name=n, case=c, **r) for (n, c), r in results.items()]}), flush=True)
    t_kernels = time.time() - t_phase

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "clip_cn_vit-b-16_random.pt")
        cfg = nct.load_config(f"{VISION}@{TEXT}")
        torch.save({"state_dict": build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
                    .state_dict()}, ckpt)
        t0 = time.time()
        ranks = mesh.run_ranks(_tp_rank, 2, "gloo", os.path.join(tmp, "rendezvous"), (ckpt,),
                               timeout_s=480.0)
        t_ranks = time.time() - t0
    n_layers = cfg.vision.layers + cfg.text.num_hidden_layers
    want = {"fused_attention_block_partial": n_layers, "fused_mlp_block_partial": n_layers,
            "fused_attention_block": 0, "fused_bert_attention_block": 0, "fused_mlp_block": 0,
            "fused_layer_block": 0, "fused_tower": 0, "fused_tower_int8": 0}
    for r, out in enumerate(ranks):
        print(f"tp rank {r}: get_similarity launches {json.dumps(out['counts'])}", flush=True)
        got = {k: out["counts"][k] for k in want}
        if got != want or not out["transposed"]:
            raise AssertionError(f"tp rank {r}: launches {got} != {want}")
    if not np.array_equal(ranks[0]["logits"], ranks[1]["logits"]):
        raise AssertionError("tp: the ranks' logits differ")
    li, li1 = ranks[0]["logits"], ranks[0]["logits_tp1"]
    err = float(np.abs(li - li1).max())
    if li.shape != (BATCH, BATCH) or not np.isfinite(li).all() or err > TP_LOGIT_BOUND:
        raise AssertionError(f"tp get_similarity: shape {li.shape}, {err} from tp 1")
    print(f"tp get_similarity ViT-B-16@RoBERTa-base batch {BATCH}, tp 2 in 2 ranks on one card "
          f"(gloo): logits bit-equal on both ranks, {err:.6g} from tp 1 on the kernel route (<= "
          f"{TP_LOGIT_BOUND}); {ranks[0]['ms']:.2f} / {ranks[1]['ms']:.2f} ms a call on rank 0 / 1 "
          f"(tp 1: {ranks[0]['ms_tp1']:.2f} ms; two ranks share the card and gloo all-reduces "
          "through the host: no measure of TP scaling)", flush=True)
    losses = ranks[0]["losses"]
    for i in range(TP_TRAIN_STEPS):
        if ranks[0]["fingerprints"][i] != ranks[1]["fingerprints"][i]:
            raise AssertionError(f"tp train: the ranks' parameters differ after step {i + 1}")
    if ranks[1]["losses"] != losses or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"tp train: losses {losses} / {ranks[1]['losses']}")
    step_counts = ranks[0]["step_counts"]
    loss_diff = abs(losses[0] - ranks[0]["loss_tp1"])
    worst, worst_cos = ranks[0]["worst_cos"]
    print(f"tp train: the first step against the same step at tp 1 (kernel route): loss "
          f"{losses[0]:.6f} vs {ranks[0]['loss_tp1']:.6f} (|diff| {loss_diff:.3g} <= "
          f"{STEP_LOSS_BOUND}); gradient cosine >= {worst_cos:.6f} ({worst}), bound "
          f"{GRAD_COS_BOUND}", flush=True)
    if loss_diff > STEP_LOSS_BOUND or worst_cos < GRAD_COS_BOUND:
        raise AssertionError("tp train: the TP step differs from the tp 1 step")
    if (step_counts["fused_attention_block_partial"] != n_layers
            or step_counts["fused_mlp_block_partial"] != n_layers):
        raise AssertionError(f"tp train: launches a step {step_counts}")
    print(f"tp train ViT-B-16@RoBERTa-base batch {TRAIN_BATCH}, tp 2, deterministic: loss "
          f"{' '.join(f'{x:.5f}' for x in losses)}; parameters equal on both ranks after every "
          f"step; step ms rank 0 {' '.join(f'{x:.1f}' for x in ranks[0]['step_ms'])}, rank 1 "
          f"{' '.join(f'{x:.1f}' for x in ranks[1]['step_ms'])} (gloo on one card); peak "
          f"{ranks[0]['peak'] / 2 ** 30:.3f} GiB a rank; launches a step "
          f"{json.dumps(step_counts)}", flush=True)
    d0 = ranks[0]["dropout"]
    for i in range(TP_DROPOUT_STEPS):
        if d0["fingerprints"][i] != ranks[1]["dropout"]["fingerprints"][i]:
            raise AssertionError(f"tp dropout: the ranks' parameters differ after step {i + 1}")
    d_diffs = [abs(a - b) for a, b in zip(d0["losses"], d0["losses_tp1"])]
    d_worst = min(d0["worst_cos"], key=lambda kv: kv[1])
    print(f"tp train with text dropout 0.1, tp 2 (the twins) vs tp 1 (kernel route), each "
          f"step from the same weights and seed, {TP_DROPOUT_STEPS} steps: worst gradient "
          f"cosine a step {[round(c, 6) for _, c in d0['worst_cos']]}; loss {d0['losses']} vs "
          f"{d0['losses_tp1']} (|diff| <= {max(d_diffs):.3g}, bound {STEP_LOSS_BOUND}); "
          f"gradient cosine >= {d_worst[1]:.6f} ({d_worst[0]}), bound {GRAD_COS_BOUND}; "
          f"parameters equal on both ranks after every step; step ms rank 0 "
          f"{' '.join(f'{x:.1f}' for x in d0['step_ms'])}; launches a step "
          f"{json.dumps(d0['counts'])}", flush=True)
    if ranks[1]["dropout"]["losses"] != d0["losses"] or max(d_diffs) > STEP_LOSS_BOUND \
            or d_worst[1] < GRAD_COS_BOUND or not all(math.isfinite(x) for x in d0["losses"]):
        raise AssertionError("tp dropout: the tp 2 steps differ from tp 1's")
    if (d0["counts"]["fused_attention_block_partial"] != cfg.vision.layers
            or d0["counts"]["fused_mlp_block_partial"] != cfg.vision.layers):
        raise AssertionError(f"tp dropout: launches a step {d0['counts']} (the image tower's "
                             "layers on #11/#12, the text tower's on the twins)")
    print(json.dumps({"phase11": "real path", "logits_vs_tp1": err, "ms": ranks[0]["ms"],
                      "loss_diff_vs_tp1": loss_diff, "min_grad_cos_vs_tp1": worst_cos,
                      "ms_tp1": ranks[0]["ms_tp1"], "losses": losses,
                      "step_ms": [r["step_ms"] for r in ranks], "peak_bytes": ranks[0]["peak"],
                      "launches": ranks[0]["counts"], "step_launches": step_counts,
                      "dropout": {k: d0[k] for k in ("losses", "losses_tp1", "worst_cos",
                                                     "step_ms", "counts")}}), flush=True)
    print(f"tp: phase 11 took {time.time() - t_phase:.1f} s (kernels {t_kernels:.1f} s, the "
          f"2 ranks {t_ranks:.1f} s)", flush=True)
    return results, ranks[0]["counts"]


# Phase 12, #6 and tower.cu at ViT-H's width. (label, layers, S, W, post-LN,
# batches): #6 at the ViT-B image, RoBERTa-base text and RoBERTa-large text
# shapes, full depth. Its bound against the twin is #5's: TOWER_ULPS at 12
# layers, TOWER24_ULPS at 24; against #5 at the same grid it is bit-equal
# (the same bf16 weights, the same K-splits and mma order).
QDMA_CASES = [("ViT-B-16 image", 12, 197, 768, False, (1,)),
              ("RoBERTa-base text", 12, 52, 768, True, (1, 8, 32)),
              ("RoBERTa-large text", 24, 52, 1024, True, (1,))]
# tower.cu over ViT-H-14's 32 image layers: the random walk of the 12-layer
# bound, sqrt(32) ~ 5.7 ulps, twice that.
TOWER32_ULPS = 12
VIT_H = ("ViT-H-14", "RoBERTa-wwm-ext-large-chinese")


def _random_layers(rnd, n_layers, w, inter, std):
    """Seeded bf16 layers in ``encoder_layer_math``'s order, [out, in]."""
    return [(rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(3 * w, w, std=std),
             rnd(3 * w, std=0.1), rnd(w, w, std=std), rnd(w, std=0.1),
             rnd(w, std=0.1, mean=1.0), rnd(w, std=0.1), rnd(inter, w, std=std),
             rnd(inter, std=0.1), rnd(w, inter, std=std / 2), rnd(w, std=0.1))
            for _ in range(n_layers)]


def phase_qdma(torch, dev, ckpt_h):
    """Phase 12: the dequant-ahead int8 tower (#6) against its twin and
    against #5 (bit-equal at #5's grid, and its time) at batch 1 full depth
    and at text batch 8 and 32; tower.cu at ViT-H-14's image shape (32
    layers, 257 / 1280, heads of 80), bf16 and int8, against its twin and the
    per-layer route; ``get_similarity`` of ViT-H-14@RoBERTa-large at batch 1
    from ``ckpt_h`` through ``load_from_name``: one tower launch a tower."""
    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.models import vit
    from nans_clip_tpu_torch.ops import gates
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    from nans_clip_tpu_torch.utils.quantize import dequantize_weight, quantize_weight

    t_phase = time.time()
    g = torch.Generator(device=dev).manual_seed(40)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * std + mean).to(bf)

    def quantized(ls):
        return [tuple(quantize_weight(t) if i in (2, 4, 8, 10) else t for i, t in enumerate(p))
                for p in ls]

    def key_bias(b, s):
        lengths = torch.randint(2, s + 1, (b,), generator=g, device=dev)
        return ((torch.arange(s, device=dev)[None, :] >= lengths[:, None]).float()
                * -10000.0).contiguous()

    def tower_bound(b, s, w, inter, n_layers, weight_bytes):
        nbytes, flops = _layer_cost(b, s, w, inter, weight_bytes)
        if weight_bytes == 1.0:
            nbytes += (4 * w + 2 * inter) * 4       # the fp32 scales
        return _bound(n_layers * nbytes + 2 * b * s * w * 2, n_layers * flops)

    results = {}
    tk.fused_tower.launches_qdma = 0   # #6's direct calls, counted from here
    for label, n_layers, s, w, post_ln, batches in QDMA_CASES:
        inter, heads = 4 * w, w // 64
        eps, act = (1e-12, "gelu") if post_ln else (1e-5, "quick_gelu")
        ls = quantized(_random_layers(rnd, n_layers, w, inter, 0.02 if post_ln else w ** -0.5))
        n_ulps = TOWER_ULPS if n_layers <= 12 else TOWER24_ULPS
        grid5 = tk.max_grid(dev.index, tk.MODE_INT8, s)
        grid6 = tk.max_grid(dev.index, tk.MODE_QDMA, s)
        for b in batches:
            x = rnd(b, s, w)
            kb = key_bias(b, s) if post_ln else None
            args = (x, kb, ls, heads, eps, act, post_ln)
            for mode, grid in ((tk.MODE_QDMA, None), (tk.MODE_INT8, None),
                               (tk.MODE_INT8, min(grid5, grid6))):
                _check_tower_plan(tk, mode, b, s, w, 64, grid)
            table = tk.TowerTable()
            got = tk.fused_tower(*args, table=table, quant_dma=True)
            same6 = tk.fused_tower(*args, table=table, grid=min(grid5, grid6), quant_dma=True)
            same5 = tk.fused_tower(*args, table=table, grid=min(grid5, grid6))
            want = tk.tower_math(*args)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            bound = _ulps(want, n_ulps)
            name = f"fused_tower_int8_qdma[{label}, b={b}]"
            if not (got.shape == x.shape and torch.isfinite(got).all() and err <= bound):
                raise AssertionError(f"{name}: max abs err {err} exceeds bound {bound}")
            if not torch.equal(same6, same5):
                raise AssertionError(f"{name}: not bit-equal to #5 at grid {min(grid5, grid6)}")
            del same6, same5
            run6 = lambda: tk.fused_tower(*args, table=table, quant_dma=True)
            run5 = lambda: tk.fused_tower(*args, table=table)
            # in turns: #6, #5, #5, #6
            t6a, t5a, t5b, t6b = (_time_ms(run6, 20), _time_ms(run5, 20), _time_ms(run5, 20),
                                  _time_ms(run6, 20))
            ms, ms5 = (t6a + t6b) / 2, (t5a + t5b) / 2
            plain_ms = _time_ms(lambda: tk.tower_math(*args), 2)
            yard_ms = _time_ms(lambda: _yard_tower(x, kb, ls, heads, eps, post_ln), 10)
            bound_ms, bound_by = tower_bound(b, s, w, inter, n_layers, 1.0)
            print(f"qdma {name}: max_abs_err {err:.6g} <= bound {bound:.6g} ({n_ulps} bf16 ulp "
                  f"of max|twin| {float(want.float().abs().max()):.4g}); bit-equal to #5 at grid "
                  f"{min(grid5, grid6)}; {ms:.4f} ms ({t6a:.4f}, {t6b:.4f}) vs #5 {ms5:.4f} ms "
                  f"({t5a:.4f}, {t5b:.4f}); twin {plain_ms:.4f} ms, yardstick {yard_ms:.4f} ms "
                  f"(dequantize + F.layer_norm/F.linear/SDPA), bound {bound_ms:.4f} ms "
                  f"({bound_by}); grid #6 {grid6}, #5 {grid5}", flush=True)
            results[("qdma", label, b)] = dict(err=err, ms=ms, ms_int8=ms5, plain_ms=plain_ms,
                                               yard_ms=yard_ms, bound_ms=bound_ms,
                                               bound_by=bound_by, grid=grid6, grid_int8=grid5)
        del ls
    qdma_launches = tk.fused_tower.launches_qdma
    torch.cuda.empty_cache()

    # tower.cu at ViT-H-14's image shape: 32 layers, S 257, W 1280, heads of 80
    n_layers, s, w, inter, heads = 32, 257, 1280, 5120, 16
    bf_layers = _random_layers(rnd, n_layers, w, inter, w ** -0.5)
    for quant in (False, True):
        ls = quantized(bf_layers) if quant else bf_layers
        x = rnd(1, s, w)
        args = (x, None, ls, heads, 1e-5, "quick_gelu", False)
        _check_tower_plan(tk, tk.MODE_INT8 if quant else tk.MODE_BF16, 1, s, w, 80)
        table = tk.TowerTable()
        got, want = tk.fused_tower(*args, table=table), tk.tower_math(*args)
        torch.cuda.synchronize()
        err, bound = float((got.float() - want.float()).abs().max()), _ulps(want, TOWER32_ULPS)
        name = f"fused_tower{'_int8' if quant else ''}[ViT-H-14 image, b=1]"
        if not (got.shape == x.shape and torch.isfinite(got).all() and err <= bound):
            raise AssertionError(f"{name}: max abs err {err} exceeds bound {bound}")

        def per_layer():
            """The route before this tower: the per-layer kernels (#1 + #9),
            int8 weights dequantized on entry."""
            y = x
            for p in ls:
                p = tuple(t if torch.is_tensor(t) else dequantize_weight(t, bf) for t in p)
                y = vit._layer(y, p, heads, True)
            return y

        ms = _time_ms(lambda: tk.fused_tower(*args, table=table), 10)
        layer_ms = _time_ms(per_layer, 5)
        plain_ms = _time_ms(lambda: tk.tower_math(*args), 2)
        yard_ms = _time_ms(lambda: _yard_tower(x, None, ls, heads, 1e-5, False), 5)
        bound_ms, bound_by = tower_bound(1, s, w, inter, n_layers, 1.0 if quant else 2.0)
        mode = tk.MODE_INT8 if quant else tk.MODE_BF16
        print(f"qdma wide tower {name}: max_abs_err {err:.6g} <= bound {bound:.6g} "
              f"({TOWER32_ULPS} bf16 ulp of max|twin| {float(want.float().abs().max()):.4g}); "
              f"{ms:.4f} ms, per-layer route {layer_ms:.4f} ms, twin {plain_ms:.4f} ms, "
              f"yardstick {yard_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); grid "
              f"{tk.max_grid(dev.index, mode, s, 80)} blocks", flush=True)
        results[("vit-h", quant, 1)] = dict(err=err, ms=ms, layer_ms=layer_ms, plain_ms=plain_ms,
                                            yard_ms=yard_ms, bound_ms=bound_ms,
                                            bound_by=bound_by)
    del bf_layers, ls, table, got, want
    torch.cuda.empty_cache()

    # get_similarity of ViT-H-14@RoBERTa-large at batch 1 through load_from_name
    t0 = time.time()
    model = nct.load_from_name(ckpt_h, vision_model_name=VIT_H[0], text_model_name=VIT_H[1],
                               input_resolution=224, device=dev,
                               options=nct.ModelOptions(compute_dtype="bfloat16"))[0]
    print(f"qdma: {VIT_H[0]}@{VIT_H[1]} loaded through load_from_name in "
          f"{time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator().manual_seed(12)
    images = torch.randn(1, 224, 224, 3, generator=gen).to(dev)
    ids = torch.from_numpy(nct.tokenize(TEXTS[:1])).to(dev)
    serving = {}
    for mode, m in (("bf16", model), ("int8", model.quantize())):
        plain = nct.CLIPModel(m.cfg, m.module, nct.ModelOptions(compute_dtype="bfloat16",
                                                                attn_impl="plain"))
        _wide_reset()
        li, lt = m.get_similarity(images, ids)
        torch.cuda.synchronize()
        counts = _wide_counts()
        tower = "fused_tower_int8" if mode == "int8" else "fused_tower"
        others = {k: v for k, v in counts.items() if v and k != tower}
        err = float((li - plain.get_similarity(images, ids)[0]).abs().max())
        print(f"qdma get_similarity {VIT_H[0]} batch 1, {mode}: launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})}; kernel vs plain max abs "
              f"err {err:.6g} <= bound {WIDE_LOGIT_BOUND}", flush=True)
        if counts[tower] != 2 or others:
            raise AssertionError(f"{mode} get_similarity at batch 1: launches {counts}, "
                                 f"expected 2 of {tower} and nothing else")
        if li.shape != (1, 1) or not torch.isfinite(li).all() or not torch.equal(lt, li.T) \
                or err > WIDE_LOGIT_BOUND:
            raise AssertionError(f"{mode} get_similarity at batch 1: error {err}")
        ms = _time_ms(lambda: m.get_similarity(images, ids), 10)
        # the per-layer route's time: the image tower's gate closed for this arm
        saved = gates.TOWER_MAX_WIDTH
        gates.TOWER_MAX_WIDTH = 1024
        try:
            layer_ms = _time_ms(lambda: m.get_similarity(images, ids), 10)
        finally:
            gates.TOWER_MAX_WIDTH = saved
        ms_again = _time_ms(lambda: m.get_similarity(images, ids), 10)
        print(f"qdma get_similarity {VIT_H[0]} batch 1, {mode}: {ms:.3f} / {ms_again:.3f} ms "
              f"(tower route, before / after), per-layer image route {layer_ms:.3f} ms",
              flush=True)
        serving[mode] = dict(err=err, ms=ms, ms_again=ms_again, layer_ms=layer_ms,
                             launches={k: v for k, v in counts.items() if v})
        del plain
    del model
    torch.cuda.empty_cache()
    print(json.dumps({"phase12": "qdma and the ViT-H tower", "results": [
        dict(kind=k, case=c, batch=b, **r) for (k, c, b), r in results.items()],
        "get_similarity": serving, "qdma_launches": qdma_launches}), flush=True)
    print(f"qdma: phase 12 took {time.time() - t_phase:.1f} s", flush=True)
    return results, qdma_launches


DATA_PAIRS, DATA_IMAGES, DATA_SIDE = 1024, 512, 256
CLI_BATCH, CLI_STEPS, CLI_RESUME_AT = 128, 6, 3
CLI_PROFILE = "2:5"   # run A's --profile-steps: the steps after the 2nd to the 5th


def _write_split(root: str, seed: int = 0) -> None:
    """A split of DATA_PAIRS pairs through the port's NPackWriter: DATA_IMAGES
    seeded noise JPEGs of DATA_SIDE pixels (so the loader's 224 resize runs),
    two captions each, built from TEXTS."""
    import io

    import numpy as np
    from PIL import Image

    from nans_clip_tpu_torch.data.npack import NPackWriter, encode_pair

    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    with NPackWriter(os.path.join(root, "imgs.npack")) as wi, \
            NPackWriter(os.path.join(root, "pairs.npack")) as wp:
        for i in range(DATA_IMAGES):
            buf = io.BytesIO()
            Image.fromarray(rs.randint(0, 256, (DATA_SIDE, DATA_SIDE, 3), dtype=np.uint8)).save(
                buf, format="JPEG", quality=90)
            wi.put(i, buf.getvalue())
            for j in range(2):
                k = 2 * i + j
                wp.put(k, encode_pair(i, k, f"{TEXTS[k % len(TEXTS)]}，第{i}张"))


def _cli_counted():
    """The counters of the train step's kernels (phase 7's and phase 8's)."""
    from nans_clip_tpu_torch.ops import fused_block_bwd as fbb

    counted = {fn.__name__: fn for fn in (
        fbb.fused_attention_block_bwd, fbb.fused_bert_attention_block_bwd, fbb.fused_mlp_block_bwd,
        fbb.fused_attention_block_bwd_fullgrad, fbb.fused_bert_attention_block_bwd_fullgrad,
        fbb.fused_mlp_block_bwd_fullgrad)}
    counted.update(_counted())
    return counted


def _cli_reset():
    _reset_counts()
    for fn in _cli_counted().values():
        fn.launches = 0


def _cli_counts():
    out = {name: fn.launches for name, fn in _cli_counted().items()}
    out.update(_tower_counts())
    return out


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _profile_summary(path: str) -> dict:
    """From the CLI's ``--profile-steps`` chrome trace: the window (the
    first host event to the last event), the device's busy time (the union
    of its kernels, copies and sets) and idle share, the host's time in
    each ``cli.*`` span of ``training/main.py``, the device's busy share
    inside the ``cli.train_step`` spans, and the CUDA runtime calls that
    take the host longest."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    span = lambda e: (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
    device = [span(e) for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [span(e) for e in events if e.get("cat") in ("cpu_op", "user_annotation",
                                                        "cuda_runtime", "cuda_driver")]
    if not host:
        return {"device_events": 0, "note": "no host events in the trace"}
    lo = min(a for a, _ in host)
    hi = max(b for _, b in host + device)
    out = {"window_ms": (hi - lo) / 1e3, "device_events": len(device),
           "device_busy_ms": _union_us(device) / 1e3}
    out["device_idle_share"] = 1.0 - out["device_busy_ms"] / out["window_ms"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("cli."):
            spans.setdefault(e["name"], []).append(span(e))
    out["host_ms"] = {k: sum(b - a for a, b in v) / 1e3 for k, v in sorted(spans.items())}
    steps = spans.get("cli.train_step", [])
    if steps and device:
        inside = [(max(a, s0), min(b, s1)) for s0, s1 in steps for a, b in device
                  if a < s1 and b > s0]
        out["device_busy_share_in_train_step"] = (_union_us(inside)
                                                  / sum(b - a for a, b in steps))
    runtime = {}
    for e in events:
        if e.get("cat") == "cuda_runtime":
            n, t = runtime.get(e["name"], (0, 0.0))
            runtime[e["name"]] = (n + 1, t + float(e.get("dur", 0)))
    out["cuda_runtime_top"] = [{"name": k, "calls": n, "ms": t / 1e3} for k, (n, t) in
                               sorted(runtime.items(), key=lambda kv: -kv[1][1])[:5]]
    return out


def _train_records(logs: str, name: str) -> list:
    with open(os.path.join(logs, name, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train"]


def phase_data_cli(torch, dev, tmp):
    """Phase 13: the data path and the two training CLIs at ViT-B-16 full
    width and depth."""
    import shutil

    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch import bench
    from nans_clip_tpu_torch.data.augment import preprocess_images
    from nans_clip_tpu_torch.data.dataset import DataLoader, PairDataset
    from nans_clip_tpu_torch.eval.model_io import load_eval_model
    from nans_clip_tpu_torch.models import lora
    from nans_clip_tpu_torch.ops import gates
    from nans_clip_tpu_torch.training import main as train_main
    from nans_clip_tpu_torch.training import train_lora

    t_phase = time.time()
    split = os.path.join(tmp, "split")
    t0 = time.time()
    _write_split(split)
    print(f"data: {DATA_PAIRS} pairs, {DATA_IMAGES} noise JPEGs of {DATA_SIDE} px written with "
          f"NPackWriter in {time.time() - t0:.2f} s "
          f"({os.path.getsize(os.path.join(split, 'imgs.npack')) / 2 ** 20:.1f} MiB)", flush=True)

    # the loader's pairs/s on both decoders, and preprocess_images on the card
    for exact in (False, True):
        loader = DataLoader(PairDataset(split), batch_size=CLI_BATCH, decode_size=224, seed=0,
                            num_threads=8, exact_decode=exact)
        t0 = time.time()
        n = sum(b.images.shape[0] for b in loader)
        dt = time.time() - t0
        print(f"data: loader {'exact (bicubic)' if exact else 'default (bilinear)'} decode, "
              f"batch {CLI_BATCH}, 224 px, 8 threads: {n / dt:.1f} pairs/s "
              f"({n} pairs, {dt:.3f} s, {len(loader)} batches)", flush=True)
    raw = torch.randint(0, 256, (CLI_BATCH, 224, 224, 3), dtype=torch.uint8,
                        generator=torch.Generator(dev).manual_seed(1), device=dev)
    for augment in (False, True):
        gen = torch.Generator().manual_seed(2)
        ms = _time_ms(lambda: preprocess_images(gen, raw, 224, augment=augment), 10)
        out = preprocess_images(torch.Generator().manual_seed(2), raw, 224, augment=augment)
        if out.shape != (CLI_BATCH, 224, 224, 3) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"preprocess_images(augment={augment}) gave {out.shape}")
        print(f"data: preprocess_images batch {CLI_BATCH}, 224 px, augment {augment}: "
              f"{ms:.3f} ms", flush=True)

    cli = ["--train-data", split, "--vision-model", VISION, "--text-model", TEXT,
           "--batch-size", str(CLI_BATCH), "--warmup", "2", "--log-interval", "1",
           "--num-workers", "8", "--seed", "0"]

    # run A: 6 steps straight on the CLI's default backward route
    # (gates.BWD_ROUTE), steps 3-5 under the profiler
    logs_a = os.path.join(tmp, "logs_a")
    torch.cuda.synchronize()
    _cli_reset()
    t0 = time.time()
    state_a = train_main.main(cli + ["--logs", logs_a, "--name", "A", "--max-steps",
                                     str(CLI_STEPS), "--save-torch-format",
                                     "--profile-steps", CLI_PROFILE])
    torch.cuda.synchronize()
    total = _cli_counts()
    run_a_s = time.time() - t0
    rec_a = _train_records(logs_a, "A")
    losses_a = [r["loss"] for r in rec_a]
    print(f"cli: run A, training.main {VISION}@{TEXT} full width and depth, seed 0, batch "
          f"{CLI_BATCH}, {CLI_STEPS} steps in {run_a_s:.1f} s (build, data, steps, the epoch-end "
          f"save):", flush=True)
    for r in rec_a:
        print(f"cli:   step {r['step']}: loss {r['loss']:.6f}, data {r['data_s']:.4f} s, "
              f"batch {r['batch_s']:.4f} s", flush=True)
    n_img, n_txt = 12, 12
    per_step = {k: v // CLI_STEPS for k, v in total.items()}
    # the CLI's default route, gates.BWD_ROUTE (the image attention on #14,
    # the text attention on #15, every MLP on #17 as measured; phase 7 holds
    # #16/#18 on the fullgrad route)
    full = {k: gates.bwd_route(k, "auto") == "fullgrad" for k in gates.BWD_ROUTE}
    expected = {"fused_attention_block": n_img, "fused_bert_attention_block": n_txt,
                "fused_mlp_block": n_img + n_txt,
                "fused_attention_block_bwd_fullgrad": n_img * full["attn_pre"],
                "fused_attention_block_bwd": n_img * (not full["attn_pre"]),
                "fused_bert_attention_block_bwd_fullgrad": n_txt * full["attn_post"],
                "fused_bert_attention_block_bwd": n_txt * (not full["attn_post"]),
                "fused_mlp_block_bwd_fullgrad": n_img * full["mlp_pre"]
                + n_txt * full["mlp_post"],
                "fused_mlp_block_bwd": n_img * (not full["mlp_pre"])
                + n_txt * (not full["mlp_post"]),
                "fused_layer_block": 0, "fused_tower": 0, "fused_tower_int8": 0}
    print(f"cli: run A backward route (gates.BWD_ROUTE, layer {gates.LAYER_BWD_ROUTE}): "
          f"{json.dumps(gates.BWD_ROUTE)}", flush=True)
    print(f"cli: run A launches of one step {json.dumps(per_step)}", flush=True)
    if (len(losses_a) != CLI_STEPS or not all(math.isfinite(x) for x in losses_a)
            or any(total[k] != CLI_STEPS * v for k, v in expected.items())):
        raise AssertionError(f"run A: losses {losses_a}, launches {total}, expected "
                             f"{CLI_STEPS} x {expected}")
    prof = _profile_summary(os.path.join(logs_a, "A", "profile", "trace.json"))
    print(f"cli: run A profile of steps {CLI_PROFILE} {json.dumps(prof)}", flush=True)

    # load_eval_model on run A's checkpoint directory: the trained module's features
    ckpt_a = os.path.join(logs_a, "A", "checkpoints")
    model = load_eval_model(VISION, TEXT, os.path.join(ckpt_a, "epoch1"), "bf16", device=dev)
    gen = torch.Generator(dev).manual_seed(3)
    images = torch.randn(8, 224, 224, 3, generator=gen, device=dev)
    ids = torch.from_numpy(nct.tokenize(TEXTS + TEXTS[:2])).to(dev)
    opts = nct.ModelOptions(compute_dtype="bfloat16")
    with torch.inference_mode():
        mine = (state_a.module.encode_image(images, opts), state_a.module.encode_text(ids, opts))
    theirs = (model.encode_image(images), model.encode_text(ids))
    same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
    print(f"cli: load_eval_model(run A's checkpoints/epoch1) features equal the trained "
          f"module's in bf16 eval: {same}", flush=True)
    if not same:
        raise AssertionError("load_eval_model's features differ from the trained module's")
    del model
    shutil.rmtree(os.path.join(ckpt_a, "epoch1"))

    # run B: 3 steps with a step checkpoint, then a resume from step_3 to 6
    logs_b = os.path.join(tmp, "logs_b")
    t0 = time.time()
    train_main.main(cli + ["--logs", logs_b, "--name", "B", "--max-steps", str(CLI_RESUME_AT),
                           "--save-step-frequency", str(CLI_RESUME_AT)])
    ckpt_b = os.path.join(logs_b, "B", "checkpoints")
    shutil.rmtree(os.path.join(ckpt_b, "epoch1"))
    state_b = train_main.main(cli + ["--logs", logs_b, "--name", "B", "--max-steps",
                                     str(CLI_STEPS), "--resume", f"step_{CLI_RESUME_AT}"])
    run_b_s = time.time() - t0
    shutil.rmtree(ckpt_b)
    rec_b = _train_records(logs_b, "B")
    losses_b = [r["loss"] for r in rec_b]
    for r in rec_b:   # no profiler: steps 4-5 beside run A's profiled ones
        print(f"cli:   run B step {r['step']}: data {r['data_s']:.4f} s, "
              f"batch {r['batch_s']:.4f} s", flush=True)
    # The kernels give the same bits on a second call (PERF.md section 6), the
    # data order is a function of (seed, epoch), the draws of (seed, step), and
    # the optimizer's moments and count come back whole: nothing may differ.
    diff = [n for (n, a), b in zip(state_a.module.named_parameters(),
                                   state_b.module.parameters()) if not torch.equal(a, b)]
    print(f"cli: run B, {CLI_RESUME_AT} steps + step_{CLI_RESUME_AT} checkpoint + resume to "
          f"{CLI_STEPS} in {run_b_s:.1f} s: losses {' '.join(f'{x:.6f}' for x in losses_b)}; "
          f"steps {CLI_RESUME_AT + 1}-{CLI_STEPS} equal run A's: "
          f"{losses_b[CLI_RESUME_AT:] == losses_a[CLI_RESUME_AT:]}; parameters bit-equal to "
          f"run A's: {not diff} ({len(diff)} tensors differ)", flush=True)
    if losses_b != losses_a or diff:
        raise AssertionError(f"the resumed run differs from run A: losses {losses_b} vs "
                             f"{losses_a}; parameters {diff[:5]}")
    del state_b

    # the LoRA CLI from run A's .pt: one epoch at batch 32 x accum 4, rank 4
    out = os.path.join(tmp, "lora")
    torch.cuda.synchronize()
    _cli_reset()
    t0 = time.time()
    adapters = train_lora.main(["--train-data", split, "--resume",
                                os.path.join(ckpt_a, "epoch1.pt"), "--vision-model", VISION,
                                "--text-model", TEXT, "--batch-size", str(LORA_MICRO),
                                "--accum-freq", str(LORA_ACCUM), "--epochs", "1",
                                "--lora-rank", "4", "--output-dir", out, "--num-threads", "8"])
    torch.cuda.synchronize()
    lora_s = time.time() - t0
    total = _cli_counts()
    n_lora_steps = DATA_PAIRS // (LORA_MICRO * LORA_ACCUM)
    per_step = {k: v // n_lora_steps for k, v in total.items()}
    with open(os.path.join(out, "training_log.csv")) as f:
        rows = f.read().strip().splitlines()
    template = lora.init_lora(torch.Generator().manual_seed(0), state_a.module, rank=4,
                              device=dev)
    back, meta = lora.load_lora(os.path.join(out, "last_lora.npz"), template)
    same = all(torch.equal(a.detach(), b.detach())
               for (_, a), (_, b) in zip(lora._leaves(back), lora._leaves(adapters)))
    print(f"cli: train_lora.main from run A's .pt, {n_lora_steps} steps (batch {LORA_MICRO} x "
          f"accum {LORA_ACCUM}, rank 4) in {lora_s:.1f} s; training_log.csv {rows}; "
          f"load_lora(last_lora.npz) equals the trained adapters: {same} (meta {meta}); "
          f"launches of one step {json.dumps(per_step)}", flush=True)
    emit = {"fused_attention_block_bwd": n_img * LORA_ACCUM,
            "fused_bert_attention_block_bwd": n_txt * LORA_ACCUM,
            "fused_mlp_block_bwd": (n_img + n_txt) * LORA_ACCUM,
            "fused_attention_block_bwd_fullgrad": 0,
            "fused_bert_attention_block_bwd_fullgrad": 0, "fused_mlp_block_bwd_fullgrad": 0}
    if (not same or len(rows) != 2 or rows[0] != "epoch,train_loss,val_loss,lr,is_best"
            or any(total[k] != n_lora_steps * v for k, v in emit.items())):
        raise AssertionError(f"LoRA CLI: round trip {same}, log {rows}, launches {total}, "
                             f"expected {n_lora_steps} x {emit}")
    del state_a   # run A's .pt and the adapters stay for phase 14, which deletes them

    # the bench's JSON line
    result = bench.run(dev)
    print(f"cli: bench {json.dumps(result)}", flush=True)
    if not result["value"] > 0:
        raise AssertionError(f"bench: {result}")
    print(f"cli: phase 13 took {time.time() - t_phase:.1f} s", flush=True)
    return {"losses": losses_a, "run_a_s": run_a_s, "bench": result, "profile": prof,
            "checkpoints": ckpt_a, "lora": os.path.join(out, "last_lora.npz")}


EVAL_IMAGES, EVAL_TEXTS, EVAL_BATCH = 1024, 2048, 64
ZS_CLASSES, ZS_PER_CLASS, N_DISTRACTORS = 8, 16, 64
ZS_LABELS = ["猫", "狗", "鸟", "鱼", "马", "船", "花", "书"]
TOPK_TIE = 1e-6   # two ids may trade ranks where their exact scores differ by less


def _noise_jpeg(rs, side: int = DATA_SIDE) -> bytes:
    """A seeded noise JPEG, as ``_write_split`` makes them."""
    import io

    import numpy as np
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 256, (side, side, 3), dtype=np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def _write_raw_eval_split(root: str, seed: int = 0) -> None:
    """``valid_imgs.tsv`` (EVAL_IMAGES seeded noise JPEGs of DATA_SIDE px) and
    ``valid_texts.jsonl`` (EVAL_TEXTS captions from TEXTS, text k on image k
    mod EVAL_IMAGES; one in 16 on three images, one in 16 on two; one in 64
    repeats the caption before it), the reference's raw layout."""
    import base64

    import numpy as np

    rs = np.random.RandomState(seed)
    with open(os.path.join(root, "valid_imgs.tsv"), "w") as f:
        for i in range(EVAL_IMAGES):
            f.write(f"{i}\t{base64.urlsafe_b64encode(_noise_jpeg(rs)).decode()}\n")
    with open(os.path.join(root, "valid_texts.jsonl"), "w", encoding="utf-8") as f:
        text = ""
        for k in range(EVAL_TEXTS):
            ids = [k % EVAL_IMAGES]
            if k % 16 == 5:
                ids += [(k + 1) % EVAL_IMAGES, (k + 2) % EVAL_IMAGES]
            elif k % 16 == 9:
                ids.append((k + 3) % EVAL_IMAGES)
            if k % 64 != 33:
                text = f"{TEXTS[k % len(TEXTS)]}，第{k}张"
            f.write(json.dumps({"text_id": 10000 + k, "text": text, "image_ids": ids},
                               ensure_ascii=False) + "\n")


def _device_busy_ms(prof, path: str) -> float:
    """The union of the device's kernels, copies and sets in a profile."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return _union_us([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                      if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                                 "gpu_memset")]) / 1e3


class _Timed:
    """Wraps ``module.name`` for a ``with`` block: the host seconds of each
    call (the device synchronised at both ends) and, with ``profile``, the
    device's busy ms under a CUDA-only ``torch.profiler``."""

    def __init__(self, torch, module, name, profile_path=None):
        self.torch, self.module, self.name, self.path = torch, module, name, profile_path
        self.seconds, self.busy_ms = [], []

    def __enter__(self):
        torch, fn = self.torch, getattr(self.module, self.name)

        def timed(*a, **kw):
            prof = None
            if self.path:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            if prof is not None:
                prof.__exit__(None, None, None)
                self.busy_ms.append(_device_busy_ms(prof, self.path))
            return out

        self.fn = fn
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *a):
        setattr(self.module, self.name, self.fn)


class _EncodeEvents:
    """CUDA events around every ``CLIPModel.encode_image`` call of a ``with``
    block: the device's ms inside them."""

    def __init__(self, torch):
        from nans_clip_tpu_torch.api import CLIPModel

        self.torch, self.cls, self.events = torch, CLIPModel, []

    def __enter__(self):
        fn, torch = self.cls.encode_image, self.torch

        def encode_image(model, images):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            out = fn(model, images)
            end.record()
            self.events.append((start, end))
            return out

        self.fn = fn
        self.cls.encode_image = encode_image
        return self

    def __exit__(self, *a):
        self.cls.encode_image = self.fn

    def ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def _check_eval_launches(what, got, image_batches, text_batches):
    """12 launches of #1 and #2 a full image batch, 12 of #3 a text batch
    (a full one, or the zero-shot classifier's 183 prompts of a class), and
    nothing of the tower kernels or the BERT sub-block."""
    want = {"fused_attention_block": 12 * image_batches, "fused_mlp_block": 12 * image_batches,
            "fused_layer_block": 12 * text_batches, "fused_bert_attention_block": 0,
            "fused_tower": 0, "fused_tower_int8": 0}
    print(f"eval: {what} launches {json.dumps({k: got[k] for k in want})}", flush=True)
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _check_topk(path, qkey, gkey, q_ids, q, g_ids, g) -> int:
    """The card's lists against the float64 ranking of the same fp32
    features: equal but for ids trading ranks whose exact scores differ by
    less than TOPK_TIE. Returns the number of such positions."""
    import numpy as np

    scores = q.astype(np.float64) @ g.astype(np.float64).T
    order = np.argsort(-scores, axis=1, kind="stable")[:, :10]
    pos = {int(x): j for j, x in enumerate(g_ids)}
    with open(path) as f:
        got = {r[qkey]: r[gkey] for r in map(json.loads, f)}
    if sorted(got) != sorted(int(x) for x in q_ids):
        raise AssertionError(f"top-k {path}: the queries differ from the feature file's")
    swaps = 0
    for i, qid in enumerate(q_ids.tolist()):
        want = [int(g_ids[j]) for j in order[i]]
        if len(set(got[qid])) != 10:
            raise AssertionError(f"top-k {path}: query {qid} lists {got[qid]}")
        for a, b in zip(got[qid], want):
            if a != b:
                swaps += 1
                if abs(scores[i, pos[a]] - scores[i, pos[b]]) >= TOPK_TIE:
                    raise AssertionError(f"top-k {path}: query {qid} lists {got[qid]}, the "
                                         f"float64 ranking {want}")
    return swaps


def phase_eval(torch, dev, tmp, checkpoints, lora_npz):
    """Phase 14: the eval pipeline at ViT-B-16@RoBERTa-base full width and
    depth, bf16, from phase 13's run A checkpoint and LoRA adapters."""

    import numpy as np

    from nans_clip_tpu_torch.data.npack import NPackReader
    from nans_clip_tpu_torch.eval import (evaluation, evaluation_tr, extract_features,
                                          retrieval_suite, transform_ir_annotation_to_tr,
                                          zeroshot_evaluation)
    from nans_clip_tpu_torch.eval import make_topk_predictions as mtp
    from nans_clip_tpu_torch.eval.model_io import load_eval_model
    from nans_clip_tpu_torch.preprocess import build_dataset

    t_phase = time.time()
    ckpt = os.path.join(checkpoints, "epoch1.pt")
    root = os.path.join(tmp, "eval")
    os.makedirs(root)
    t0 = time.time()
    _write_raw_eval_split(root)
    meta = build_dataset.build_split(root, "valid")
    split = os.path.join(root, "valid")
    texts_jsonl = os.path.join(root, "valid_texts.jsonl")
    print(f"eval: raw split of {EVAL_IMAGES} noise JPEGs of {DATA_SIDE} px and {EVAL_TEXTS} "
          f"texts, built by build_dataset in {time.time() - t0:.2f} s: {json.dumps(meta)}",
          flush=True)
    if meta != {"num_samples": EVAL_TEXTS + 3 * (EVAL_TEXTS // 16), "num_images": EVAL_IMAGES,
                "split": "valid"}:
        raise AssertionError(f"build_dataset: {meta}")

    # 1. extract_features, both towers, pil then native
    n_img_batches, n_txt_batches = EVAL_IMAGES // EVAL_BATCH, EVAL_TEXTS // EVAL_BATCH
    model_args = ["--resume", ckpt, "--vision-model", VISION, "--text-model", TEXT,
                  "--img-batch-size", str(EVAL_BATCH), "--text-batch-size", str(EVAL_BATCH)]
    feats, rates = {}, {}
    for transform in ("pil", "native"):
        img_out = os.path.join(root, f"imgs.{transform}.img_feat.jsonl")
        txt_out = os.path.join(root, f"valid_texts.{transform}.txt_feat.jsonl")
        _reset_counts()
        with _Timed(torch, extract_features, "extract_image_features",
                    os.path.join(root, "trace.json")) as img_t, \
                _Timed(torch, extract_features, "extract_text_features") as txt_t, \
                _EncodeEvents(torch) as enc:
            extract_features.main(model_args + [
                "--extract-image-feats", "--extract-text-feats", "--image-data", split,
                "--text-data", texts_jsonl, "--image-feat-output-path", img_out,
                "--text-feat-output-path", txt_out, "--image-transform", transform])
        counts = {name: fn.launches for name, fn in _counted().items()}
        counts.update(_tower_counts())
        _check_eval_launches(f"extract_features --image-transform {transform}", counts,
                             n_img_batches, n_txt_batches)
        img_s, busy = img_t.seconds[0], img_t.busy_ms[0]
        rates[transform] = {"images_per_s": EVAL_IMAGES / img_s,
                            "device_images_per_s": EVAL_IMAGES / enc.ms() * 1e3,
                            "encode_image_ms": enc.ms(), "image_s": img_s,
                            "device_busy_ms": busy, "idle_share": 1.0 - busy / (img_s * 1e3),
                            "texts_per_s": EVAL_TEXTS / txt_t.seconds[0]}
        print(f"eval: extract_features --image-transform {transform}: {EVAL_IMAGES} images in "
              f"{img_s:.3f} s ({rates[transform]['images_per_s']:.1f} images/s end to end, "
              f"decode included; encode_image {enc.ms():.2f} ms on the device, "
              f"{rates[transform]['device_images_per_s']:.1f} images/s; device busy "
              f"{busy:.2f} ms, idle share {rates[transform]['idle_share']:.4f}); {EVAL_TEXTS} "
              f"texts in {txt_t.seconds[0]:.3f} s ({rates[transform]['texts_per_s']:.1f} "
              f"texts/s)", flush=True)
        feats[transform] = (mtp.load_feats(img_out, "image_id"),
                            mtp.load_feats(txt_out, "text_id"))
    (img_ids, img), (txt_ids, txt) = feats["pil"]
    for (a_ids, a), (b_ids, b) in zip(feats["pil"], feats["native"]):
        if not np.array_equal(a_ids, b_ids) or a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError("extract_features: the pil and native files differ in rows")
    native_err = float(np.abs(feats["pil"][0][1] - feats["native"][0][1]).max())
    native_text_equal = bool(np.array_equal(feats["pil"][1][1], feats["native"][1][1]))
    print(f"eval: pil against native image features max abs diff {native_err:.3g} (the same "
          f"pixels); text features equal: {native_text_equal}", flush=True)
    if img.shape[0] != EVAL_IMAGES or txt.shape != (EVAL_TEXTS, img.shape[1]) \
            or np.abs(np.linalg.norm(img, axis=1) - 1).max() > 1e-5 or not native_text_equal:
        raise AssertionError(f"features: {img.shape} {txt.shape}")

    # the first image and text batch against the plain route on the card
    from nans_clip_tpu_torch.data.dataset import preprocess_text
    from nans_clip_tpu_torch.tokenizer import tokenize

    plain = load_eval_model(VISION, TEXT, ckpt, "bf16", attn_impl="plain", device=dev)
    reader = NPackReader(os.path.join(split, "imgs.npack"))
    _, x = next(extract_features.image_batches(reader, plain.image_resolution, EVAL_BATCH, True,
                                               8, dev))
    reader.close()
    with open(texts_jsonl, encoding="utf-8") as f:
        first = [preprocess_text(json.loads(line)["text"]) for _, line in zip(range(EVAL_BATCH), f)]
    p_img = extract_features._normalized(plain.encode_image(x))
    p_txt = extract_features._normalized(plain.encode_text(tokenize(first)))
    scale = float(plain.module.logit_scale.float().exp())
    k_logits = scale * img[:EVAL_BATCH] @ txt[:EVAL_BATCH].T
    p_logits = scale * p_img @ p_txt.T
    err = float(np.abs(k_logits - p_logits).max())
    err100 = err / scale * 100.0
    bound = 0.05   # phase 5's: logits (14.29 x cosine at this scale) of kernel vs plain bf16
    print(f"eval: first batch (64 images x 64 texts) kernel route vs plain route on the card: "
          f"logits ({scale:.4f} x cosine) max abs err {err:.6g} <= bound {bound}; on 100 x "
          f"cosine {err100:.6g}", flush=True)
    if err > bound:
        raise AssertionError(f"extracted features differ from the plain route by {err}")
    del plain

    # 2. top-k both ways, the scores, and the float64 ranking
    feat_args = ["--image-feats", os.path.join(root, "imgs.pil.img_feat.jsonl"),
                 "--text-feats", os.path.join(root, "valid_texts.pil.txt_feat.jsonl"),
                 "--top-k", "10"]
    preds, preds_tr = os.path.join(root, "topk.jsonl"), os.path.join(root, "topk_tr.jsonl")
    t0 = time.time()
    mtp.main(feat_args + ["--output", preds])
    evaluation.main([texts_jsonl, preds, os.path.join(root, "score.json")])
    annot = transform_ir_annotation_to_tr.transform(texts_jsonl)
    mtp.main(feat_args + ["--tr", "--output", preds_tr])
    evaluation_tr.main([annot, preds_tr, os.path.join(root, "score_tr.json")])
    stages_s = time.time() - t0
    scores = {}
    for name in ("score", "score_tr"):
        with open(os.path.join(root, f"{name}.json")) as f:
            scores[name] = json.load(f)
        if not scores[name]["success"]:
            raise AssertionError(f"{name}: {scores[name]}")
    swaps = _check_topk(preds, "text_id", "image_ids", txt_ids, txt, img_ids, img)
    swaps_tr = _check_topk(preds_tr, "image_id", "text_ids", img_ids, img, txt_ids, txt)
    q, g = torch.from_numpy(txt).to(dev), torch.from_numpy(img).to(dev)
    topk_ms = _time_ms(lambda: mtp.topk_indices(q, g, 10), 20)
    topk_tr_ms = _time_ms(lambda: mtp.topk_indices(g, q, 10), 20)
    print(f"eval: make_topk_predictions both ways + evaluation + transpose + evaluation_tr in "
          f"{stages_s:.2f} s; top-k on the card {EVAL_TEXTS} x {EVAL_IMAGES}: {topk_ms:.4f} ms "
          f"({EVAL_IMAGES} x {EVAL_TEXTS}: {topk_tr_ms:.4f} ms); equal to the float64 ranking "
          f"but for {swaps} / {swaps_tr} positions of ties within {TOPK_TIE}; t2i "
          f"{json.dumps(scores['score']['scoreJson'])}; i2t "
          f"{json.dumps(scores['score_tr']['scoreJson'])}", flush=True)

    # 3. zero-shot on an ImageFolder with the 183 openai templates
    folder = os.path.join(root, "folder")
    rs = np.random.RandomState(5)
    for c in range(ZS_CLASSES):
        os.makedirs(os.path.join(folder, f"c{c}"))
        for j in range(ZS_PER_CLASS):
            with open(os.path.join(folder, f"c{c}", f"{j}.jpg"), "wb") as f:
                f.write(_noise_jpeg(rs))
    labels = os.path.join(root, "labels.txt")
    with open(labels, "w", encoding="utf8") as f:
        f.write("\n".join(ZS_LABELS[:ZS_CLASSES]) + "\n")
    _reset_counts()
    t0 = time.time()
    with _Timed(torch, zeroshot_evaluation, "zero_shot_classifier") as cls_t, \
            _Timed(torch, zeroshot_evaluation, "run") as run_t:
        acc = zeroshot_evaluation.main(["--datapath", folder, "--dataset", "imagenet",
                                        "--label-file", labels, "--resume", ckpt,
                                        "--vision-model", VISION, "--text-model", TEXT,
                                        "--save-dir", os.path.join(root, "zs")])
    zs_s = time.time() - t0
    with open(os.path.join(root, "zs", "imagenet.json")) as f:
        elevater = json.load(f)
    rows = np.asarray(elevater["predictions"][0])
    zs_images = ZS_CLASSES * ZS_PER_CLASS
    counts = {name: fn.launches for name, fn in _counted().items()}
    counts.update(_tower_counts())
    _check_eval_launches("zeroshot_evaluation", counts, zs_images // EVAL_BATCH, ZS_CLASSES)
    print(f"eval: zeroshot_evaluation {ZS_CLASSES} classes x {ZS_PER_CLASS} images, 183 "
          f"templates: top-1 {acc * 100:.2f}% in {zs_s:.2f} s (classifier {cls_t.seconds[0]:.3f} "
          f"s, run {run_t.seconds[0]:.3f} s, {zs_images / run_t.seconds[0]:.1f} images/s); "
          f"ELEVATER json keys {list(elevater)}, num_params {elevater['num_params']}, "
          f"num_visual_params {elevater['num_visual_params']}; rows {rows.shape}, max |sum - 1| "
          f"{float(np.abs(rows.sum(1) - 1).max()):.3g}", flush=True)
    if rows.shape != (zs_images, ZS_CLASSES) or np.abs(rows.sum(1) - 1).max() > 1e-5:
        raise AssertionError(f"zero-shot: rows {rows.shape}")

    # 4. the retrieval suite with distractors and run A's LoRA adapters
    dis = os.path.join(root, "distractors")
    os.makedirs(dis)
    for i in range(N_DISTRACTORS):
        with open(os.path.join(dis, f"d{i:03d}.jpg"), "wb") as f:
            f.write(_noise_jpeg(rs))
    with open(os.path.join(dis, "notes.txt"), "w") as f:
        f.write("not an image")
    t0 = time.time()
    results = retrieval_suite.main(["--data", split, "--resume", ckpt, "--vision-model", VISION,
                                    "--text-model", TEXT, "--lora", lora_npz,
                                    "--distractor-dir", dis, "--batch-size", str(EVAL_BATCH),
                                    "--output", os.path.join(root, "suite.json")])
    suite_s = time.time() - t0
    with open(os.path.join(root, "suite.json")) as f:
        suite = json.load(f)
    for mode in ("zeroshot", "lora"):
        for direction, m in results[mode].items():
            print(f"eval: retrieval_suite {mode} {direction} {json.dumps(m)}", flush=True)
    print(f"eval: retrieval_suite in {suite_s:.2f} s: {suite['num_domain_images']} images + "
          f"{suite['num_distractors']} distractors, {suite['num_texts']} unique texts", flush=True)
    if suite["num_distractors"] != N_DISTRACTORS or suite["num_domain_images"] != EVAL_IMAGES \
            or not all(0.0 <= v <= 100.0 for mode in ("zeroshot", "lora")
                       for m in results[mode].values() for v in m.values()):
        raise AssertionError(f"retrieval suite: {suite}")

    line = {"phase14": "eval", "card": _nvidia_smi(),
            "extract_images_per_s": {t: r["images_per_s"] for t, r in rates.items()},
            "device_images_per_s": {t: r["device_images_per_s"] for t, r in rates.items()},
            "texts_per_s": {t: r["texts_per_s"] for t, r in rates.items()},
            "idle_share": {t: r["idle_share"] for t, r in rates.items()},
            "device_busy_ms": {t: r["device_busy_ms"] for t, r in rates.items()},
            "topk_ms": topk_ms, "topk_tr_ms": topk_tr_ms, "topk_tie_swaps": [swaps, swaps_tr],
            "logits_err": err, "zeroshot_classifier_s": cls_t.seconds[0],
            "zeroshot_images_per_s": zs_images / run_t.seconds[0],
            "retrieval_suite_s": suite_s, "phase_s": time.time() - t_phase}
    print(json.dumps(line), flush=True)
    return line


# Phase 15: a split whose sizes are not multiples of the batch (queue 3 item
# E): the last image chunk (1) and text chunk (6) take tower.cu on jit
BACKEND_IMAGES, BACKEND_TEXTS, BACKEND_BATCH = 65, 70, 64
LATENCY_BATCHES = (1, 8, 32)
ENGINE_BATCHES = (1, 8, 32, 64)
DAEMON_BOUND = 0.01   # phase 6's daemon bound: a quarter of a unit feature's component


def _max_diff(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _held_to_eager(what, got, eager1, eager2):
    """Bit-equality with the eager tower, or the eager tower's own run-to-run
    difference where a kernel has one."""
    run = float((eager1 - eager2).abs().max())
    diff = float((got - eager1).abs().max())
    print(f"backends: {what}: max abs diff against eager {diff:.6g} (eager against eager "
          f"{run:.6g}); bit-equal {bool(diff == 0.0)}", flush=True)
    if diff > run:
        raise AssertionError(f"{what}: {diff} from eager, beyond its run-to-run {run}")
    return diff


def _backend_inputs(torch, tower, batch, seed):
    g = torch.Generator().manual_seed(seed)
    if tower == "image":
        return torch.randn(batch, 224, 224, 3, generator=g)
    ids = torch.randint(103, 20000, (batch, 52), generator=g)
    ids[:, 0], ids[:, 25:] = 101, 0
    ids[:, 24] = 102
    return ids


def _write_backend_split(root: str) -> list:
    """imgs.npack of BACKEND_IMAGES noise JPEGs and texts.jsonl of
    BACKEND_TEXTS captions; returns the texts."""
    import numpy as np

    from nans_clip_tpu_torch.data.npack import NPackWriter

    rs = np.random.RandomState(15)
    with NPackWriter(os.path.join(root, "imgs.npack")) as w:
        for i in range(BACKEND_IMAGES):
            w.put(i, _noise_jpeg(rs))
    texts = [f"{TEXTS[k % len(TEXTS)]}，第{k}条" for k in range(BACKEND_TEXTS)]
    with open(os.path.join(root, "texts.jsonl"), "w", encoding="utf-8") as f:
        for k, t in enumerate(texts):
            f.write(json.dumps({"text_id": k, "text": t}, ensure_ascii=False) + "\n")
    return texts


def _serve_http(service, texts, images_b64):
    """The daemon on 127.0.0.1: texts in 7 and images in 5 concurrent
    requests; (text features, image features, /stats, /health)."""
    import numpy as np

    from nans_clip_tpu_torch.deploy.server import make_server

    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    jobs = [("/encode_text", "texts", i, texts[i::7]) for i in range(7)]
    jobs += [("/encode_image", "images", i, images_b64[i::5]) for i in range(5)]
    results, errors = {}, []

    def post(path, key, i, items):
        try:
            req = urllib.request.Request(url + path, json.dumps({key: items}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                results[(key, i)] = np.asarray(json.loads(r.read())["features"], np.float32)
        except Exception as e:  # collected and raised below
            errors.append(e)

    try:
        posts = [threading.Thread(target=post, args=job) for job in jobs]
        for t in posts:
            t.start()
        for t in posts:
            t.join(600)
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(60)
    if errors or len(results) != len(jobs):
        raise AssertionError(f"HTTP requests failed: {errors}")

    def gather(key, n, parts):
        out = np.zeros((n, service.cfg.embed_dim), np.float32)
        for i in range(parts):
            out[i::parts] = results[(key, i)]
        return out

    return gather("texts", len(texts), 7), gather("images", len(images_b64), 5), stats, health


def _idle_share(torch, fn, calls: int, tmp: str) -> float:
    """1 - the device's busy time (CUDA-only profiler) over the host window
    of ``calls`` calls, the device synchronised at both ends."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    return 1.0 - _device_busy_ms(prof, os.path.join(tmp, "idle.json")) / window_ms


def _cold_worker(root: str, engines: str) -> str:
    """A script that loads engines in a fresh process from the weights and
    inputs saved in ``root/cold.pt`` and saves their features."""
    path = os.path.join(root, "cold.py")
    with open(path, "w") as f:
        f.write(f"""import json, sys, time
import torch
from nans_clip_tpu_torch.deploy.engine import engine_path, load_engine
data = torch.load({os.path.join(root, "cold.pt")!r}, map_location="cuda")
out, secs = {{}}, {{}}
for key, x in data["inputs"].items():
    tower, bs = key.split("@")
    t0 = time.time()
    eng = load_engine(engine_path({engines!r}, tower, int(bs)), data["params"][tower])
    secs[key] = time.time() - t0
    out[key] = eng(x).cpu()
torch.save(out, {os.path.join(root, "cold_out.pt")!r})
bad = sorted(m for m in sys.modules if m.startswith(("nans_clip_tpu_torch.models",
                                                      "nans_clip_tpu_torch.api", "jax")))
print(json.dumps({{"load_s": secs, "model_modules": bad}}))
""")
    return path


def phase_backends(torch, dev, tmp, ckpt):
    """Phase 15: the serving backends (CUDA graphs, engine files, the daemon
    and extract_features on them, latency by backend) at ViT-B-16@RoBERTa-base
    full width and depth, bf16, from phase 14's checkpoint."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    from nans_clip_tpu_torch.data.npack import NPackReader
    from nans_clip_tpu_torch.deploy import aot, speed_benchmark
    from nans_clip_tpu_torch.deploy.engine import engine_path
    from nans_clip_tpu_torch.deploy.server import ClipService
    from nans_clip_tpu_torch.eval import extract_features
    from nans_clip_tpu_torch.eval import make_topk_predictions as mtp
    from nans_clip_tpu_torch.eval.model_io import load_eval_model
    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.tokenizer import tokenize
    from nans_clip_tpu_torch.utils.transform import image_transform

    t_phase = time.time()
    root = os.path.join(tmp, "backends")
    os.makedirs(root)
    model = load_eval_model(VISION, TEXT, ckpt, "bf16", device=dev)
    encode = {"image": model.encode_image, "text": model.encode_text}
    line = {"phase15": "serving backends", "card": _nvidia_smi()}

    # (a) CUDA graphs against eager, and the launches their capture made
    diffs = {}
    for tower in ("image", "text"):
        for bs in LATENCY_BATCHES + (64,):
            x = _backend_inputs(torch, tower, bs, seed=bs).to(dev)
            e1, e2 = aot.normalized(encode[tower](x)), aot.normalized(encode[tower](x))
            _reset_counts()
            run = aot.compile_tower(model, tower, bs)
            counts = {k: v for k, v in {**{n: f.launches for n, f in _counted().items()},
                                        **_tower_counts()}.items() if v}
            diffs[f"{tower}@{bs}"] = _held_to_eager(
                f"compile_tower {tower} batch {bs} (warm-up and capture launched {counts})",
                run(x), e1, e2)
    # (b) the int8 text tower at batch 1 (#5)
    q_model = model.quantize("int8", towers=("text",))
    x = _backend_inputs(torch, "text", 1, seed=1).to(dev)
    e1, e2 = aot.normalized(q_model.encode_text(x)), aot.normalized(q_model.encode_text(x))
    _reset_counts()
    run = aot.compile_tower(q_model, "text", 1)
    if _tower_counts()["fused_tower_int8"] != 3:
        raise AssertionError(f"int8 text graph: {_tower_counts()}")
    diffs["text@1 int8"] = _held_to_eager("compile_tower int8 text batch 1 (#5)", run(x), e1, e2)
    del q_model, run
    line["graph_vs_eager"] = diffs

    # (c) engines: build, inspect, a cold load in a fresh process
    engines = os.path.join(root, "engines")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "nans_clip_tpu_torch.deploy.engine", "build",
                           "--resume", ckpt, "--vision-model", VISION, "--text-model", TEXT,
                           "--towers", "image,text",
                           "--batch-sizes", ",".join(map(str, ENGINE_BATCHES)),
                           "--out-dir", engines], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    build_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"engine build failed:\n{proc.stdout}\n{proc.stderr}")
    params = {t: aot.tower_params(model, t) for t in ("image", "text")}
    weight_bytes = {t: sum(v.numel() * v.element_size() for v in p.values())
                    for t, p in params.items()}
    sizes = {f"{t}@{bs}": os.path.getsize(engine_path(engines, t, bs))
             for t in ("image", "text") for bs in ENGINE_BATCHES}
    print(f"backends: deploy.engine build of {len(sizes)} engines in {build_s:.2f} s (process "
          f"start and checkpoint load included): {'; '.join(proc.stdout.strip().splitlines())}; file "
          f"bytes {json.dumps(sizes)} against weight bytes {json.dumps(weight_bytes)}",
          flush=True)
    if any(sizes[f"{t}@{bs}"] >= weight_bytes[t] / 100 for t in params for bs in ENGINE_BATCHES):
        raise AssertionError("an engine file holds the weights")
    proc = subprocess.run([sys.executable, "-m", "nans_clip_tpu_torch.deploy.engine", "inspect",
                           engine_path(engines, "text", 1)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    print("backends: inspect text_bs1.engine: " + "; ".join(proc.stdout.strip().splitlines()),
          flush=True)
    if proc.returncode != 0 or "capability: 9.0" not in proc.stdout:
        raise AssertionError(f"engine inspect: {proc.stdout} {proc.stderr}")
    cold = [("text", 1), ("image", 1), ("text", 64), ("image", 64)]
    inputs = {f"{t}@{bs}": _backend_inputs(torch, t, bs, seed=100 + bs) for t, bs in cold}
    torch.save({"params": params, "inputs": inputs}, os.path.join(root, "cold.pt"))
    lib_mtime = _build.LIB_PATH.stat().st_mtime_ns
    t0 = time.time()
    proc = subprocess.run([sys.executable, _cold_worker(root, engines)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    cold_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cold engine load failed:\n{proc.stdout}\n{proc.stderr}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    rebuilt = _build.LIB_PATH.stat().st_mtime_ns != lib_mtime
    print(f"backends: cold load in a fresh process ({cold_s:.2f} s in all, import and weights "
          f"included): engine load s {json.dumps(report['load_s'])}; model modules imported "
          f"{report['model_modules']}; kernel library rebuilt: {rebuilt}", flush=True)
    if report["model_modules"] or rebuilt:
        raise AssertionError("the cold load imported the model modules or ran nvcc")
    cold_out = torch.load(os.path.join(root, "cold_out.pt"))
    for key, x in inputs.items():
        tower = key.split("@")[0]
        xd = x.to(dev)
        e1, e2 = aot.normalized(encode[tower](xd)), aot.normalized(encode[tower](xd))
        diffs[f"engine {key}"] = _held_to_eager(f"cold-loaded engine {key}",
                                                cold_out[key].to(dev), e1, e2)
    os.remove(os.path.join(root, "cold.pt"))
    line.update(engine_build_s=build_s, engine_bytes=sizes, weight_bytes=weight_bytes,
                cold_load_s=report["load_s"], cold_process_s=cold_s)

    # (d) item E through extract_features, and the daemon against it
    texts = _write_backend_split(root)
    args = ["--extract-image-feats", "--extract-text-feats", "--image-data", root,
            "--text-data", os.path.join(root, "texts.jsonl"), "--resume", ckpt,
            "--vision-model", VISION, "--text-model", TEXT, "--img-batch-size",
            str(BACKEND_BATCH), "--text-batch-size", str(BACKEND_BATCH)]
    offline = {}
    for backend in ("jit", "engine"):
        img_out = os.path.join(root, f"img.{backend}.jsonl")
        txt_out = os.path.join(root, f"txt.{backend}.jsonl")
        _reset_counts()
        extract_features.main(args + [
            "--backend", backend, "--image-feat-output-path", img_out,
            "--text-feat-output-path", txt_out,
            "--image-artifact", engine_path(engines, "image", BACKEND_BATCH),
            "--text-artifact", engine_path(engines, "text", BACKEND_BATCH)])
        counts = {**{n: f.launches for n, f in _counted().items()}, **_tower_counts()}
        print(f"backends: extract_features --backend {backend}: launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
        if backend == "jit" and counts["fused_tower"] != 2:
            raise AssertionError("the final partial chunks did not take tower.cu on jit")
        offline[backend] = (mtp.load_feats(txt_out, "text_id")[1],
                            mtp.load_feats(img_out, "image_id")[1])
    reader = NPackReader(os.path.join(root, "imgs.npack"))
    raws = [reader.get(k) for k in range(BACKEND_IMAGES)]
    reader.close()
    t = image_transform(224)
    full_img = np.stack([t(Image.open(io.BytesIO(r))) for r in raws[-BACKEND_BATCH:]])
    full = (extract_features._normalized(model.encode_text(tokenize(texts[-BACKEND_BATCH:]))),
            extract_features._normalized(model.encode_image(full_img)))
    tail = {"text": BACKEND_TEXTS % BACKEND_BATCH, "image": BACKEND_IMAGES % BACKEND_BATCH}
    item_e = {b: {"text": _max_diff(txt_f[-tail["text"]:], full[0][-tail["text"]:]),
                  "image": _max_diff(img_f[-tail["image"]:], full[1][-tail["image"]:])}
              for b, (txt_f, img_f) in offline.items()}
    print(f"backends: item E: the final partial chunk ({tail['text']} texts, {tail['image']} "
          f"image) against the same rows in a full batch of {BACKEND_BATCH}: max abs diff "
          f"{json.dumps(item_e)} <= bound {DAEMON_BOUND}", flush=True)
    if max(v for d in item_e.values() for v in d.values()) > DAEMON_BOUND:
        raise AssertionError(f"final partial batch rows: {item_e}")
    images_b64 = [base64.b64encode(r).decode() for r in raws]
    daemon = {}
    for name, kw in (("jit", {}), ("engine", {"engine_dir": engines})):
        service = ClipService(model, max_batch=32, **kw)
        txt_f, img_f, stats, health = _serve_http(service, texts, images_b64)
        daemon[name] = {f"vs extract_features {b}": max(_max_diff(txt_f, o[0]),
                                                        _max_diff(img_f, o[1]))
                        for b, o in offline.items()}
        print(f"backends: daemon ({health['backend']} backend, /stats {json.dumps(stats)}) over "
              f"HTTP, {BACKEND_TEXTS} texts and {BACKEND_IMAGES} images in 12 concurrent "
              f"requests: max abs diff {json.dumps(daemon[name])} <= bound {DAEMON_BOUND}",
              flush=True)
        if health["backend"] != name or max(daemon[name].values()) > DAEMON_BOUND \
                or stats["errors"]:
            raise AssertionError(f"daemon {name}: {daemon[name]} {health} {stats}")
        del service
    line.update(item_e=item_e, daemon=daemon)

    # (e) latency by backend, both clocks, and the device's idle share
    latency, idle = {}, {}
    for backend in ("jit", "aot", "engine"):
        print(f"backends: latency, backend {backend}, {_nvidia_smi()}", flush=True)
        latency[backend] = speed_benchmark.bench_model(
            model, LATENCY_BATCHES, n=50, warmup=5, label=f"{VISION} bf16", backend=backend,
            engine_dir=engines)
        for tower in ("image", "text"):
            for bs in LATENCY_BATCHES:
                x = _backend_inputs(torch, tower, bs, seed=7).to(dev)
                call = speed_benchmark.tower_call(model, tower, bs, backend, engines)
                idle[f"{backend} {tower}@{bs}"] = _idle_share(torch, lambda: call(x), 20, root)
        print(f"backends: device idle share, backend {backend}: "
              f"{json.dumps({k: round(v, 4) for k, v in idle.items() if k.startswith(backend)})}",
              flush=True)
    line["latency"] = {b: {k: {"p50": s["median"], "p95": s["p95"], "p99": s["p99"],
                               "host_p50": s["host"]["median"], "host_p95": s["host"]["p95"],
                               "host_p99": s["host"]["p99"]} for k, s in r.items()}
                       for b, r in latency.items()}
    line["idle_share"] = idle
    line["phase_s"] = time.time() - t_phase
    print(f"backends: phase 15 in {line['phase_s']:.1f} s", flush=True)
    print(json.dumps(line), flush=True)
    return line


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
    print(_data_path_facts(), flush=True)

    from nans_clip_tpu_torch.ops import _build
    t0 = time.time()
    report = _build.build()
    _build.library()
    regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
    print(f"build: {time.time() - t0:.1f} s, {len(_build.sources())} sources; "
          + " | ".join(regs), flush=True)

    results = phase_kernels(torch, dev)
    towers = phase_towers(torch, dev)

    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.models.clip import build_clip

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "clip_cn_vit-b-16_random.pt")
        module = build_clip(nct.load_config(f"{VISION}@{TEXT}"), "cpu",
                            torch.Generator().manual_seed(0))
        torch.save({"state_dict": module.state_dict()}, ckpt)
        del module
        print(f"checkpoint: {VISION}@{TEXT} random (seed 0) saved in {time.time() - t0:.1f} s",
              flush=True)
        launches = phase_slice(torch, dev, ckpt)
        serving_launches, _ = phase_serving(torch, ckpt)
        os.remove(ckpt)
        train_results, train_launches = phase_training(torch, dev, tmp)
        lora_results, lora_step, layer_launches, _ = phase_lora(torch, dev, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_h = os.path.join(tmp, "clip_cn_vit-h-14_random.pt")
        wide_results, wide_steps, wide_forward, wide_direct = phase_wide(torch, dev, ckpt_h)
        pallas_results, pallas_direct, pallas_forward, pallas_step = phase_pallas(torch, dev)
        tp_results, tp_launches = phase_tp(torch, dev)
        qdma_results, qdma_launches = phase_qdma(torch, dev, ckpt_h)
    with tempfile.TemporaryDirectory() as tmp:
        cli = phase_data_cli(torch, dev, tmp)
        phase_eval(torch, dev, tmp, cli["checkpoints"], cli["lora"])
        phase_backends(torch, dev, tmp, os.path.join(cli["checkpoints"], "epoch1.pt"))
        shutil.rmtree(cli["checkpoints"])

    if any(m == "jax" or m.startswith(("jax.", "nans_clip_tpu.")) for m in sys.modules):
        raise AssertionError("chip_smoke imported JAX or the JAX package")
    kernels = []
    # the backward GEMM forms' launches: one train step (phase 7), their main path
    launches.update(gemm_dgrad=train_launches["linear_dgrad"],
                    gemm_wgrad=train_launches["linear_wgrad"],
                    attention_bwd=train_launches["attention_bwd"],
                    layernorm_bwd=train_launches["layer_norm_bwd"],
                    column_sum=train_launches["column_sum"])
    # the long-sequence pair's: a ViT-L-14-336 step (phase 9), its main path
    launches["attention_bwd_long"] = wide_steps["ViT-L-14-336"]["per_step"]["attention_bwd_long"]
    for name, r in results.items():
        if r["meta"] is None:
            continue
        source, replaces = r["meta"]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **({} if r["yard_ms"] is None else {"yardstick_ms": r["yard_ms"]})})
    for name, quant, replaces in (
            ("fused_tower", False, "nans_clip_tpu/ops/tower_kernel.py:36"),
            ("fused_tower_int8", True, "nans_clip_tpu/ops/tower_kernel.py:67")):
        r = towers[("text", quant, 1)]   # the serving path's batch-1 text request
        kernels.append({"name": name, "route": "cuda", "source": "nans_clip_tpu_torch/csrc/tower.cu",
                        "replaces": replaces, "launches": serving_launches[name],
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                        "yardstick_ms": r["yard_ms"]})
    # #6 from its direct calls (no JAX entry point routes it), at the batch-1
    # RoBERTa-base text shape as #5's row
    r = qdma_results[("qdma", "RoBERTa-base text", 1)]
    kernels.append({"name": "fused_tower_int8_qdma", "route": "cuda",
                    "source": "nans_clip_tpu_torch/csrc/tower.cu",
                    "replaces": "nans_clip_tpu/ops/tower_kernel.py:104",
                    "launches": qdma_launches, "path": "direct", "max_abs_err": r["err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None, "yardstick_ms": r["yard_ms"],
                    "int8_inline_ms": r["ms_int8"]})
    for name, r in train_results.items():
        if r["replaces"] is None:
            continue
        # launches: one train step, the main path's run for these kernels
        kernels.append({"name": name, "route": "cuda",
                        "source": "nans_clip_tpu_torch/ops/fused_block_bwd.py",
                        "replaces": r["replaces"], "launches": train_launches[name],
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                        "yardstick_ms": r["yard_ms"]})
    # #13, #15, #17 at the LoRA microbatch, launches of one LoRA step; #21 at
    # batch 128, launches of one train step with bwd_impl="layer"
    for (name, b), r in lora_results.items():
        if r["replaces"] is None or (b != LORA_MICRO and "layer" not in name):
            continue
        layer = "layer" in name
        kernels.append({"name": name, "route": "cuda",
                        "source": "nans_clip_tpu_torch/ops/"
                                  + ("layer_bwd.py" if layer else "fused_block_bwd.py"),
                        "replaces": r["replaces"],
                        "launches": layer_launches if layer else lora_step["per_step"][name],
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                        "yardstick_ms": r["yard_ms"]})
    # #7 from the ViT-H-width tower at 336 px (its main path), #8 from its direct
    # calls (no JAX entry point routes it), #9 from get_similarity at batch 1,
    # #10 and #19 from a ViT-H-14 step, #20 from a ViT-L-14-336 step
    wide_launches = {
        "fused_attention_block_wide": (wide_steps["ViT-H-width@336px"]["per_step"][
            "fused_attention_block_wide"], "train step, ViT-H width at 336 px"),
        "fused_attention_block_wide[batch_tile=2]": (
            wide_direct["fused_attention_block_wide[batch_tile>1]"], "direct"),
        "_fused_mlp_tiled_call": (wide_forward[3]["_fused_mlp_tiled_call"],
                                  "get_similarity ViT-H-14, batch 3"),
        "_fused_mlp_batched_call": (wide_steps["ViT-H-14"]["per_step"]["_fused_mlp_batched_call"],
                                    "train step, ViT-H-14"),
        "fused_mlp_block_bwd_chunked": (wide_steps["ViT-H-14"]["per_step"][
            "fused_mlp_block_bwd_chunked"], "train step, ViT-H-14"),
        "fused_attention_block_bwd_chunked": (wide_steps["ViT-L-14-336"]["per_step"][
            "fused_attention_block_bwd_chunked"], "train step, ViT-L-14-336"),
    }
    for name, r in wide_results.items():
        if r["replaces"] is None:
            continue
        launches, path = wide_launches[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": "nans_clip_tpu_torch/ops/"
                                  + ("fused_block_bwd.py" if "bwd" in name else "fused_block.py"),
                        "replaces": r["replaces"], "launches": launches, "path": path,
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                        "yardstick_ms": r["yard_ms"]})
    # #22 from get_similarity of ViT-B-16 at batch 256 (the batch path's shape),
    # #23 from a ViT-L-14-336 step (the training path's), #24 from its direct calls
    pallas_entries = (
        ("attention_pallas", (256, 12, 197, 64), "nans_clip_tpu_torch/csrc/flash.cu",
         "nans_clip_tpu/ops/attention.py:81", pallas_forward["attention_pallas"],
         "get_similarity ViT-B-16, batch 256, attn_impl=pallas"),
        ("attention_pallas_bwd", (32, 16, 577, 64), "nans_clip_tpu_torch/csrc/flash.cu",
         "nans_clip_tpu/ops/attention.py:96", pallas_step["attention_pallas_bwd"],
         "train step, ViT-L-14-336, attn_impl=pallas"),
        ("pallas_layer_norm", (50432, 768), "nans_clip_tpu_torch/csrc/layernorm.cu",
         "nans_clip_tpu/ops/layernorm.py:32", pallas_direct["pallas_layer_norm"], "direct"))
    for name, shape, source, replaces, launches, path in pallas_entries:
        r = pallas_results[(name, shape)]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches, "path": path, "max_abs_err": r["err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # #11 and #12 at the image tower's rank shape (ViT-B-16, tp 2); launches of
    # one rank's get_similarity at tp 2
    for name, replaces in (
            ("fused_attention_block_partial", "nans_clip_tpu/ops/fused_block.py:1244"),
            ("fused_mlp_block_partial", "nans_clip_tpu/ops/fused_block.py:1346")):
        r = tp_results[(name, "ViT-B-16 tp 2")]
        kernels.append({"name": name, "route": "cuda",
                        "source": "nans_clip_tpu_torch/ops/fused_block.py", "replaces": replaces,
                        "launches": tp_launches[name],
                        "path": "get_similarity ViT-B-16@RoBERTa-base, batch 256, tp 2, rank 0",
                        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    ported = {"fused_attention_block", "fused_mlp_block", "fused_layer_block", "fused_tower",
              "fused_tower_int8", "fused_tower_int8_qdma", "fused_attention_block_bwd",
              "fused_bert_attention_block_bwd", "fused_mlp_block_bwd",
              "fused_attention_block_bwd_fullgrad",
              "fused_bert_attention_block_bwd_fullgrad", "fused_mlp_block_bwd_fullgrad",
              "fused_layer_block_bwd_fullgrad", "gemm_dgrad", "gemm_wgrad", "attention_bwd",
              "attention_bwd_long", "layernorm_bwd", "column_sum", *wide_launches,
              *(name for name, *_ in pallas_entries), "fused_attention_block_partial",
              "fused_mlp_block_partial"}
    if not ported <= {k["name"] for k in kernels} or any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"the twenty-four ported TPU kernels and the backward's hand "
                             f"kernels, each launched on its main path: "
                             f"{[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
