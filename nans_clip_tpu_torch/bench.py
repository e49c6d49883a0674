"""Feature-pair throughput of a published model (ViT-B/16 + RoBERTa-base by
default) in bf16 on the card (counterpart of the repository's root
``bench.py``, which measures the JAX package).

    python -m nans_clip_tpu_torch.bench [--model RN50] [--batch 4096] [--iters 8]
    python -m nans_clip_tpu_torch.bench --device cpu --tiny-model --batch 8

Prints one JSON line ``{"metric", "value", "unit", "detail"}``:
the pairs/s of ``CLIPModel.get_similarity`` on ``--batch`` image/text pairs
(random weights from seed 0; images drawn on the device from a generator
seeded 0; texts of 29 random ids between [CLS] and [SEP], as the root
bench's), timed with CUDA events over ``--iters`` calls after two warm-up
calls. ``detail`` gives the ms a pair and, on the card, the share of the
H100's dense bf16 tensor-core peak (989 TFLOP/s) that the forward's
operations reach.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from nans_clip_tpu_torch import configs
from nans_clip_tpu_torch.api import model_from_config
from nans_clip_tpu_torch.models.common import ModelOptions

BF16_PEAK_TFLOPS = 989.0
BATCH = 4096
ITERS = 8
WARMUP = 2
TEXT_LEN = 52


def _tower_flops(seq: int, width: int, layers: int) -> float:
    """Forward operations of one transformer tower a sample: QKV (6SW^2),
    attention (4S^2W), out-projection (2SW^2), 4x MLP (16SW^2) a layer."""
    return layers * (24.0 * seq * width * width + 4.0 * seq * seq * width)


def resnet_flops(v: configs.ResNetConfig) -> float:
    """Forward operations of one image through a ModifiedResNet: 2 k^2 Cin
    Cout a convolution's output pixel (the stem, then each bottleneck's
    three and its downsample, strided blocks pooling before conv3), and the
    attention pool's four projections and its single-query attention."""
    from nans_clip_tpu_torch.models.resnet import blocks

    def conv(hw, k, cin, cout):
        return 2.0 * hw * hw * k * k * cin * cout

    w, r = v.width, v.image_resolution // 2
    flops = conv(r, 3, 3, w // 2) + conv(r, 3, w // 2, w // 2) + conv(r, 3, w // 2, w)
    r //= 2
    for _, _, inplanes, planes, stride in blocks(v):
        out = r // stride
        flops += conv(r, 1, inplanes, planes) + conv(r, 3, planes, planes)
        flops += conv(out, 1, planes, 4 * planes)
        if stride > 1 or inplanes != 4 * planes:
            flops += conv(out, 1, inplanes, 4 * planes)
        r = out
    c, tokens = v.feature_dim, r * r + 1
    return flops + 2.0 * (1 + 2 * tokens) * c * c + 4.0 * tokens * c + 2.0 * c * v.embed_dim


def pair_flops(cfg: configs.CLIPConfig, text_seq: int = TEXT_LEN) -> float:
    """Forward operations of one (image, text) pair of a CLIP."""
    v, t = cfg.vision, cfg.text
    if cfg.is_resnet:
        img = resnet_flops(v)
    else:
        s_img = (v.image_resolution // v.patch_size) ** 2 + 1
        img = _tower_flops(s_img, v.width, v.layers)
        img += 2.0 * s_img * (3 * v.patch_size ** 2) * v.width + 2.0 * v.width * cfg.embed_dim
    txt = _tower_flops(text_seq, t.hidden_size, t.num_hidden_layers)
    return img + txt + 2.0 * t.hidden_size * cfg.embed_dim


def inputs(cfg: configs.CLIPConfig, batch: int, device: torch.device):
    """(bf16 images [batch, R, R, 3], int64 ids [batch, 52]), seeded."""
    gen = torch.Generator(device).manual_seed(0)
    r = cfg.vision.image_resolution
    images = torch.randn(batch, r, r, 3, generator=gen, device=device).bfloat16()
    texts = torch.zeros(batch, TEXT_LEN, dtype=torch.long, device=device)
    texts[:, 0] = 101
    texts[:, 1:30] = torch.randint(1000, 20000, (batch, 29), generator=gen, device=device)
    texts[:, 30] = 102
    return images, texts


def run(device="cuda", cfg: Optional[configs.CLIPConfig] = None, batch: int = BATCH,
        iters: int = ITERS) -> dict:
    device = torch.device(device)
    cfg = cfg or configs.load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese")
    model = model_from_config(cfg, None, ModelOptions(compute_dtype="bfloat16"), seed=0,
                              device=device)
    images, texts = inputs(cfg, batch, device)
    for _ in range(WARMUP):
        model.get_similarity(images, texts)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            model.get_similarity(images, texts)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            model.get_similarity(images, texts)
        ms = (time.perf_counter() - t0) * 1e3 / iters
    pairs_per_sec = batch / ms * 1e3
    detail = {"ms_per_call": ms, "ms_per_pair": ms / batch, "batch": batch, "iters": iters,
              "device": "cpu"}
    if device.type == "cuda":
        tflops = pairs_per_sec * pair_flops(cfg) / 1e12
        detail.update(device=torch.cuda.get_device_name(device), tflops_per_sec=tflops,
                      pct_of_bf16_peak=100 * tflops / BF16_PEAK_TFLOPS,
                      peak_ref_tflops=BF16_PEAK_TFLOPS)
    return {
        "metric": f"{cfg.name} image+text feature pairs/sec, get_similarity bf16",
        "value": pairs_per_sec,
        "unit": "pairs/sec",
        "detail": detail,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--model", default="ViT-B-16", choices=configs.available_models(),
                   help="a published model name (its Vision@Text pair)")
    p.add_argument("--tiny-model", action="store_true", help="configs.tiny_config()")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    cfg = configs.tiny_config() if args.tiny_model else configs.config_for_name(args.model)[0]
    result = run(args.device, cfg, args.batch, args.iters)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
