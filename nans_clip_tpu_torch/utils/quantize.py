"""Weight-only int8 for low-latency serving (counterpart of
``nans_clip_tpu/utils/quantize.py``).

At batch 1-32 a tower call is bound by streaming its layer weights, so the
four big matrices of every layer (q|k|v, out-projection, fc1, fc2) can be
held as int8 with one fp32 scale per output channel: half the bytes. The
whole-tower kernel (``ops/tower_kernel.py``) reads them as they are and
dequantizes in shared memory; every other route dequantizes on entry
(``models/vit.py``, ``models/bert.py``). The products stay bf16.

Layout: the port keeps the torch Linear layout ``[out, in]``, so a
quantized weight is :class:`Int8Weight` with ``int8`` ``[out, in]`` and
``scale`` ``[out, 1]`` fp32: the max over the contraction axis (dim -1)
over 127, floored at 1e-12 / 127; ``round`` (half to even, as ``jnp.rint``)
and clip to +-127 in fp32. On the same weights this gives the JAX
package's int8 values and scales bit for bit, transposed. Both are
buffers, so ``cast_module`` (which casts parameters) leaves the scales in
fp32, as ``cast_tree`` does in the JAX package.

``quantize_for_serving`` returns a new ``CLIP`` module; the original is
unchanged, and the two share every tensor that was not quantized.
"""

from __future__ import annotations

import copy
import itertools
from typing import Optional

import torch
from torch import nn

# attribute paths, from one layer module, of its four streamed weights
_VIT_LEAVES = (("attn", "in_proj_weight"), ("attn.out_proj", "weight"),
               ("mlp.c_fc", "weight"), ("mlp.c_proj", "weight"))
_BERT_LEAVES = (("attention.self.query", "weight"), ("attention.self.key", "weight"),
                ("attention.self.value", "weight"), ("attention.output.dense", "weight"),
                ("intermediate.dense", "weight"), ("output.dense", "weight"))


class Int8Weight(nn.Module):
    """A quantized ``[out, in]`` weight: ``int8`` values and fp32 ``scale``
    ``[out, 1]`` per output channel."""

    def __init__(self, int8: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("int8", int8)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.int8.shape


def quantize_weight(w: torch.Tensor) -> Int8Weight:
    """Symmetric per-output-channel int8 of an ``[out, in]`` weight."""
    wf = w.detach().float()
    scale = wf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127)
    return Int8Weight(q.to(torch.int8), scale)


def dequantize_weight(q: Int8Weight, dtype) -> torch.Tensor:
    """``(float(q) * scale)`` rounded once to ``dtype``."""
    return (q.int8.float() * q.scale).to(dtype)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, Int8Weight)


def towers_for_mode(mode: str):
    """A CLI ``--quantize`` mode -> the towers to quantize: ``int8`` = both,
    ``int8-text`` = the text tower only."""
    if mode == "int8":
        return ("text", "image")
    if mode == "int8-text":
        return ("text",)
    raise ValueError(f"unknown quantize mode: {mode!r}")


def _tower_layers(module: nn.Module, tower: str):
    if tower == "image":
        return list(module.visual.transformer.resblocks), _VIT_LEAVES
    return list(module.bert.encoder.layer), _BERT_LEAVES


def _swap(layer: nn.Module, leaves, fn) -> None:
    """Replace each leaf ``owner.name`` of ``layer`` by ``fn(leaf)``."""
    for path, name in leaves:
        owner = layer.get_submodule(path)
        new = fn(getattr(owner, name))
        delattr(owner, name)
        setattr(owner, name, new)


def tower_quantized(module: nn.Module, tower: str) -> bool:
    layers, leaves = _tower_layers(module, tower)
    path, name = leaves[0]
    return is_quantized(getattr(layers[0].get_submodule(path), name))


def quantize_mode(module: nn.Module) -> Optional[str]:
    """The ``--quantize`` mode of a ``CLIP`` module's weights, as engines
    record it: None, ``int8`` (both towers) or ``int8-text``; a module with
    only its image tower quantized has no such mode (``int8-image``)."""
    text, image = tower_quantized(module, "text"), tower_quantized(module, "image")
    if text and image:
        return "int8"
    if text:
        return "int8-text"
    return "int8-image" if image else None


def _sharing_copy(module: nn.Module) -> nn.Module:
    """A deep copy of the module tree that shares every parameter and
    buffer with the original; per-module caches start empty."""
    memo = {id(t): t for t in itertools.chain(module.parameters(), module.buffers())}
    out = copy.deepcopy(module, memo)
    for m in out.modules():
        if hasattr(m, "reset_caches"):
            m.reset_caches()
    return out


@torch.no_grad()
def quantize_for_serving(module: nn.Module, towers=("text", "image")) -> nn.Module:
    """A copy of the ``CLIP`` module whose chosen towers hold int8 weights
    (``"text"`` = the BERT encoder, ``"image"`` = the ViT transformer)."""
    unknown = set(towers) - {"text", "image"}
    if unknown:
        raise ValueError(f"unknown towers: {sorted(unknown)}")
    for tower in towers:
        if tower_quantized(module, tower):
            raise ValueError(f"the {tower} tower is already int8-quantized; quantization is "
                             "not idempotent")
    out = _sharing_copy(module)
    for tower in towers:
        layers, leaves = _tower_layers(out, tower)
        for layer in layers:
            _swap(layer, leaves, lambda w: quantize_weight(w).to(w.device))
    return out


@torch.no_grad()
def dequantize_params(module: nn.Module, dtype=torch.float32) -> nn.Module:
    """Inverse of :func:`quantize_for_serving` up to int8 rounding: a copy
    with dense ``dtype`` weights in place of every :class:`Int8Weight`."""
    out = _sharing_copy(module)
    for tower in ("text", "image"):
        if tower_quantized(out, tower):
            layers, leaves = _tower_layers(out, tower)
            for layer in layers:
                _swap(layer, leaves, lambda q: nn.Parameter(dequantize_weight(q, dtype),
                                                            requires_grad=False))
    return out
