"""LoRA adapters (counterpart of ``nans_clip_tpu/models/lora.py``).

As in the JAX package the adapters are a tree of their own beside the frozen
base model, ``{"visual": {"wo": {"a", "b"}}, "bert": {"wqkv_qv": {"a",
"b"}}}``, with the JAX shapes, so adapter files interchange:

* ViT: the attention out-projection only, ``a`` [L, r, W], ``b`` [L, W, r];
* BERT: the self-attention query (j = 0) and value (j = 1) projections,
  ``a`` [L, 2, r, H], ``b`` [L, 2, H, r];
* ``text_only`` leaves the ViT out.

A is Kaiming-uniform, B zeros (clip/lora.py:39-43), so the model merged at
init equals the base. :func:`merge_lora` gives the effective weights ``W +
(alpha / r) B A`` in the port's ``[out, in]`` layout (the JAX tree holds
``[in, out]``: its delta is this one transposed), keyed by parameter name and
differentiable in the adapters; a forward reads them through
``torch.func.functional_call`` while the module's own parameters stay
frozen. :func:`save_lora` / :func:`load_lora` write and read the JAX
package's ``.npz`` (lora.py:131-146).
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nans_clip_tpu_torch.utils.quantize import tower_quantized


def _kaiming_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """torch ``kaiming_uniform_(a=sqrt(5))`` on an ``[out, in]`` weight:
    uniform in +-sqrt(1 / fan_in)."""
    bound = math.sqrt(1.0 / shape[-1])
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def init_lora(generator: torch.Generator, module: nn.Module, rank: int = 4,
              text_only: bool = False, device=None) -> dict:
    """The adapter tree for a CLIP ``module``: fp32 leaves that require
    gradients, on ``device`` (default: the module's). A is drawn from
    ``generator`` (a CPU generator)."""
    device = device or module.logit_scale.device
    leaf = lambda t: t.to(device).requires_grad_()
    adapters: dict = {}
    if not text_only:
        n, w = module.cfg.vision.layers, module.cfg.vision.width
        adapters["visual"] = {"wo": {"a": leaf(_kaiming_uniform(generator, (n, rank, w))),
                                     "b": leaf(torch.zeros(n, w, rank))}}
    n, h = module.cfg.text.num_hidden_layers, module.cfg.text.hidden_size
    adapters["bert"] = {"wqkv_qv": {"a": leaf(_kaiming_uniform(generator, (n, 2, rank, h))),
                                    "b": leaf(torch.zeros(n, 2, h, rank))}}
    return adapters


def _leaves(adapters: dict) -> Iterator[Tuple[str, torch.Tensor]]:
    """(JAX key string, leaf) in the JAX tree's order (sorted keys)."""
    for tower in sorted(adapters):
        for mod in sorted(adapters[tower]):
            for name in sorted(adapters[tower][mod]):
                yield f"['{tower}']['{mod}']['{name}']", adapters[tower][mod][name]


def adapter_leaves(adapters: dict) -> list:
    return [t for _, t in _leaves(adapters)]


def _infer_rank(adapters: dict) -> int:
    for tower in adapters.values():
        for mod in tower.values():
            return mod["a"].shape[-2]
    raise ValueError("empty adapter tree")


def merge_lora(module: nn.Module, adapters: dict, alpha: float = 16.0,
               rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """{parameter name: effective weight} for every adapted weight of
    ``module``, differentiable in the adapters: ``W + (alpha / r) B A`` in
    W's dtype. Raises on int8-quantized weights (merge first, quantize
    after)."""
    if not adapters:
        return {}
    for tower, name in (("visual", "image"), ("bert", "text")):
        if tower in adapters and tower_quantized(module, name):
            raise ValueError("cannot merge LoRA into int8-quantized weights: merge first, "
                             "then quantize the merged model")
    scale = alpha / (rank or _infer_rank(adapters))
    params = dict(module.named_parameters())
    out = {}

    def add(name, b, a):
        w = params[name]
        out[name] = w.detach() + (scale * (b @ a)).to(w.dtype)

    if "visual" in adapters:
        wo = adapters["visual"]["wo"]
        for i in range(wo["a"].shape[0]):
            add(f"visual.transformer.resblocks.{i}.attn.out_proj.weight", wo["b"][i], wo["a"][i])
    if "bert" in adapters:
        qv = adapters["bert"]["wqkv_qv"]
        for i in range(qv["a"].shape[0]):
            base = f"bert.encoder.layer.{i}.attention.self"
            add(f"{base}.query.weight", qv["b"][i, 0], qv["a"][i, 0])
            add(f"{base}.value.weight", qv["b"][i, 1], qv["a"][i, 1])
    return out


def count_lora_params(adapters: dict) -> int:
    return sum(t.numel() for _, t in _leaves(adapters))


def save_lora(path: str, adapters: dict, meta: Optional[dict] = None) -> None:
    """Adapter-only checkpoint: an ``.npz`` of the flattened tree under the
    JAX package's key strings, with ``__meta__`` as JSON."""
    flat = {key: t.detach().cpu().numpy() for key, t in _leaves(adapters)}
    np.savez(path, __meta__=json.dumps(meta or {}), **flat)


def load_lora(path: str, template: dict) -> Tuple[dict, dict]:
    """Restore adapters into the template's structure, dtype and device.
    Returns (adapters, meta)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"])) if "__meta__" in data else {}
    out: dict = {}
    for tower in template:
        for mod in template[tower]:
            for name, like in template[tower][mod].items():
                t = torch.from_numpy(data[f"['{tower}']['{mod}']['{name}']"])
                out.setdefault(tower, {}).setdefault(mod, {})[name] = \
                    t.to(like.device, like.dtype).requires_grad_()
    return out, meta
