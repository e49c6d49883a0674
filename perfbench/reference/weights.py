"""The benchmark's weights: made on the device from the run's seed, by
name and shape in the published Chinese-CLIP state-dict layout (the
reference ``cn_clip`` names, which the port's ``build_clip`` also takes).

One ``torch.randn`` on a generator on the device draws every random
parameter at once (in :func:`layout`'s order); each parameter is then its
slice times its init standard deviation: the published init scheme (the
CLIP ViT scheme, BERT's normal(0, initializer_range)), zero biases, unit
LayerNorms, ``logit_scale`` = ln(1 / 0.07). The program and the
reference are handed the same values; the reference makes them again from
the seed after the program is gone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, std) for a random normal leaf; std None: constant ``fill``
Leaf = Tuple[str, Tuple[int, ...], float, float]


def seq_len(cfg: dict) -> int:
    g = cfg["image_resolution"] // cfg["vision_patch_size"]
    return g * g + 1


def layout(cfg: dict) -> List[Leaf]:
    """(name, shape, std, fill) of every parameter; std 0 means the
    constant ``fill``."""
    w, layers, p = cfg["vision_width"], cfg["vision_layers"], cfg["vision_patch_size"]
    e, h = cfg["embed_dim"], cfg["text_hidden_size"]
    inter, std = cfg["text_intermediate_size"], cfg["text_initializer_range"]
    scale, proj_std, fc_std = w ** -0.5, w ** -0.5 * (2 * layers) ** -0.5, (2 * w) ** -0.5
    one = lambda n, d: [(f"{n}.weight", (d,), 0.0, 1.0), (f"{n}.bias", (d,), 0.0, 0.0)]
    zero = lambda n, d: (n, (d,), 0.0, 0.0)
    out: List[Leaf] = [("text_projection", (h, e), h ** -0.5, 0.0),
                       ("logit_scale", (), 0.0, math.log(1.0 / 0.07)),
                       ("visual.class_embedding", (w,), scale, 0.0),
                       ("visual.positional_embedding", (seq_len(cfg), w), scale, 0.0),
                       ("visual.proj", (w, e), scale, 0.0),
                       ("visual.conv1.weight", (w, 3, p, p), scale, 0.0)]
    out += one("visual.ln_pre", w)
    for i in range(layers):
        b = f"visual.transformer.resblocks.{i}"
        out += one(f"{b}.ln_1", w)
        out += [(f"{b}.attn.in_proj_weight", (3 * w, w), scale, 0.0),
                zero(f"{b}.attn.in_proj_bias", 3 * w),
                (f"{b}.attn.out_proj.weight", (w, w), proj_std, 0.0),
                zero(f"{b}.attn.out_proj.bias", w)]
        out += one(f"{b}.ln_2", w)
        out += [(f"{b}.mlp.c_fc.weight", (4 * w, w), fc_std, 0.0), zero(f"{b}.mlp.c_fc.bias", 4 * w),
                (f"{b}.mlp.c_proj.weight", (w, 4 * w), proj_std, 0.0),
                zero(f"{b}.mlp.c_proj.bias", w)]
    out += one("visual.ln_post", w)
    emb = "bert.embeddings"
    out += [(f"{emb}.word_embeddings.weight", (cfg["vocab_size"], h), std, 0.0),
            (f"{emb}.position_embeddings.weight", (cfg["text_max_position_embeddings"], h),
             std, 0.0),
            (f"{emb}.token_type_embeddings.weight", (cfg["text_type_vocab_size"], h), std, 0.0)]
    out += one(f"{emb}.LayerNorm", h)
    for i in range(cfg["text_num_hidden_layers"]):
        b = f"bert.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            out += [(f"{b}.attention.self.{n}.weight", (h, h), std, 0.0),
                    zero(f"{b}.attention.self.{n}.bias", h)]
        out += [(f"{b}.attention.output.dense.weight", (h, h), std, 0.0),
                zero(f"{b}.attention.output.dense.bias", h)]
        out += one(f"{b}.attention.output.LayerNorm", h)
        out += [(f"{b}.intermediate.dense.weight", (inter, h), std, 0.0),
                zero(f"{b}.intermediate.dense.bias", inter),
                (f"{b}.output.dense.weight", (h, inter), std, 0.0),
                zero(f"{b}.output.dense.bias", h)]
        out += one(f"{b}.output.LayerNorm", h)
    return out


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed & 0xFFFF_FFFF_FFFF_FFFF)


@torch.no_grad()
def fill(tensors: Dict[str, torch.Tensor], cfg: dict, seed: int) -> None:
    """Write the seed's weights into ``tensors`` (name -> tensor of the
    leaf's shape, any floating dtype, all on one device) in place."""
    leaves = layout(cfg)
    if set(tensors) != {name for name, *_ in leaves}:
        missing = {name for name, *_ in leaves} ^ set(tensors)
        raise KeyError(f"the weights' names differ from the published layout: "
                       f"{sorted(missing)[:6]}")
    device = next(iter(tensors.values())).device
    total = sum(math.prod(shape) for _, shape, std, _ in leaves if std)
    flat = torch.randn(total, generator=generator(seed, device), device=device)
    ofs = 0
    for name, shape, std, value in leaves:
        t = tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the layout has {shape}")
        if std:
            n = math.prod(shape)
            t.copy_(flat[ofs:ofs + n].view(shape).mul_(std))
            ofs += n
        else:
            t.fill_(value)


def make(cfg: dict, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The seed's weights as a new dict of ``dtype`` tensors on ``device``."""
    out = {name: torch.empty(shape, device=device, dtype=dtype)
           for name, shape, *_ in layout(cfg)}
    fill(out, cfg, seed)
    return out
