"""The serving path's hand kernels as registered operators, so that
``torch.export`` can trace a tower (``deploy/aot.py``).

The wrappers launch their kernels through ``ctypes`` with the tensors'
``data_ptr()``, which a fake tensor does not have while a program is
traced. So each forward launch on the serving path is also one
``torch.library.custom_op`` under the ``nans_clip::`` namespace:

* ``nans_clip::tower``: ``ops/tower_kernel.py::fused_tower`` (#4 with bf16
  weights, #5 with int8 weights; an ``Int8Weight`` is its ``int8`` and
  ``scale`` tensors in the schema's weight list);
* ``nans_clip::linear``: ``ops/gemm.py::linear`` (forward, no dropout);
* ``nans_clip::attention``: ``ops/attention.py::attention`` (forward, no
  dropout, no statistics);
* ``nans_clip::layer_norm``: ``ops/layernorm.py::row_layer_norm``;
* ``nans_clip::flash_attention``: ``ops/attention.py::flash_context``, the
  forward of the flash attention (#22) under ``attn_impl="pallas"``,
  returning only o, as the merged context ``[B, S, H*dh]``.

The first four carry #1-#3 at batch >= 64 (the chains of
``ops/fused_block.py`` and ``ops/layer_kernel.py``) and #4/#5 at batch <=
32; the fifth carries #22 in every layer of a ``pallas`` tower. Each op has three
implementations: on CUDA tensors it launches the hand kernel through its
wrapper, exactly as an eager call does (and counts the launch there); on
CPU tensors it runs the wrapper's plain twin; its fake gives only the
output's shape and dtype.

The choice: the wrappers (``attention_pallas`` for the fifth) call these
ops only while a program is exported (``torch.compiler.is_exporting()``) and launch directly otherwise, so the
eager paths (the host-bound training loop above all) do not pay for the
dispatcher. An exported program calls the ops; the tower op builds its
pointer table inside its CUDA implementation, cached on the addresses of
its weights (:func:`_tower_table`), as a model's ``TowerTable`` is, for as
long as its user holds it (:func:`keep_tables`: a captured graph, or a
loaded program until its next call).
"""

from __future__ import annotations

import contextlib
import weakref
from typing import List, Optional, Sequence

import torch

from nans_clip_tpu_torch.ops import attention as attn_mod
from nans_clip_tpu_torch.ops import gemm, layernorm, tower_kernel
from nans_clip_tpu_torch.utils.quantize import Int8Weight, is_quantized

NAMESPACE = "nans_clip"
_QUANT_SLOTS = tower_kernel._WEIGHTS   # the positions of the four big weights in a layer


def flatten_layers(layers: Sequence[tuple]) -> List[torch.Tensor]:
    """The tower's layers as the op's weight list: each layer's 12 tensors
    in ``encoder_layer_math``'s order, an ``Int8Weight`` as ``int8`` then
    ``scale`` (16 tensors a layer)."""
    flat = []
    for p in layers:
        for t in p:
            flat.extend((t.int8, t.scale) if is_quantized(t) else (t,))
    return flat


def unflatten_layers(weights: Sequence[torch.Tensor], quant: bool) -> List[tuple]:
    """The inverse of :func:`flatten_layers`."""
    per = 16 if quant else 12
    if len(weights) % per:
        raise ValueError(f"tower: {len(weights)} weights is not a whole number of layers "
                         f"of {per}")
    layers = []
    for i in range(0, len(weights), per):
        it = iter(weights[i:i + per])
        layers.append(tuple(Int8Weight(t, next(it)) if quant and j in _QUANT_SLOTS else t
                            for j, t in zip(range(12), it)))
    return layers


class _Table:
    """A tower's layers and their ``TowerTable``. The layers hold the weights,
    so an address in the table is not reused while it lives."""

    __slots__ = ("layers", "table", "__weakref__")

    def __init__(self, layers, table):
        self.layers, self.table = layers, table


# The pointer tables of the exported towers, keyed on the addresses of their
# weights. The cache holds none of them: each lives as long as one of the
# lists of keep_tables() holds it, as a captured graph's does.
_TABLES: "weakref.WeakValueDictionary[tuple, _Table]" = weakref.WeakValueDictionary()
_KEEPERS: List[list] = []


@contextlib.contextmanager
def keep_tables():
    """Yield a list that collects every pointer table the tower op uses in
    the block. The tables stay built, at their addresses, for as long as the
    list is held: a CUDA graph captured in the block holds it while it may
    replay."""
    kept: list = []
    _KEEPERS.append(kept)
    try:
        yield kept
    finally:
        _KEEPERS.remove(kept)


def _tower_table(weights: Sequence[torch.Tensor], quant: bool):
    """(layers, TowerTable) for the op's weight list, built once for a set of
    addresses while it is kept. Built outside a CUDA graph capture (the
    warm-up's call), the table's host-to-device copy is not part of the
    graph."""
    key = (quant,) + tuple(t.data_ptr() for t in weights)
    entry = _TABLES.get(key)
    if entry is None:
        entry = _TABLES[key] = _Table(unflatten_layers(weights, quant), tower_kernel.TowerTable())
    for kept in _KEEPERS:
        if not any(e is entry for e in kept):
            kept.append(entry)
    return entry.layers, entry.table


@torch.library.custom_op(f"{NAMESPACE}::tower", mutates_args=())
def tower_op(x: torch.Tensor, key_bias: Optional[torch.Tensor], weights: List[torch.Tensor],
             quant: bool, heads: int, eps: float, act: str, post_ln: bool) -> torch.Tensor:
    """All layers of an encoder on x [B, S, W] (``fused_tower``)."""
    layers, table = _tower_table(weights, quant)
    return tower_kernel.fused_tower(x, key_bias, layers, heads, eps, act, post_ln, table)


@tower_op.register_kernel("cpu")
def _tower_cpu(x, key_bias, weights, quant, heads, eps, act, post_ln):
    layers = unflatten_layers(weights, quant)
    return tower_kernel.tower_math(x, key_bias, layers, heads, eps, act, post_ln).clone()


@tower_op.register_fake
def _tower_fake(x, key_bias, weights, quant, heads, eps, act, post_ln):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.custom_op(f"{NAMESPACE}::linear", mutates_args=())
def linear_op(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
              act: Optional[str], residual: Optional[torch.Tensor],
              out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``gemm.linear``'s forward: ``a . w^T + bias``, its activation and
    residual, stored in ``out_dtype``."""
    return gemm.linear(a, w, bias, act, residual, out_dtype)


@linear_op.register_kernel("cpu")
def _linear_cpu(a, w, bias, act, residual, out_dtype):
    return gemm.linear_plain(a, w, bias, act, residual, out_dtype)


@linear_op.register_fake
def _linear_fake(a, w, bias, act, residual, out_dtype):
    return a.new_empty((*a.shape[:-1], w.shape[0]), dtype=out_dtype or a.dtype)


@torch.library.custom_op(f"{NAMESPACE}::attention", mutates_args=())
def attention_op(qkv: torch.Tensor, key_bias: Optional[torch.Tensor], batch: int,
                 heads: int) -> torch.Tensor:
    """``attention``'s forward on a packed ``[B*S, 3W]`` buffer; ctx ``[B*S, W]``."""
    return attn_mod.attention(qkv, key_bias, batch, heads)


@attention_op.register_kernel("cpu")
def _attention_cpu(qkv, key_bias, batch, heads):
    return attn_mod.attention_plain(qkv, key_bias, batch, heads)


@attention_op.register_fake
def _attention_fake(qkv, key_bias, batch, heads):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1] // 3))


@torch.library.custom_op(f"{NAMESPACE}::layer_norm", mutates_args=())
def layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                  out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``row_layer_norm``: LayerNorm over the last axis, fp32 statistics."""
    return layernorm.row_layer_norm(x, weight, bias, eps, out_dtype)


@layer_norm_op.register_kernel("cpu")
def _layer_norm_cpu(x, weight, bias, eps, out_dtype):
    return layernorm.layer_norm(x, weight, bias, eps, out_dtype)


@layer_norm_op.register_fake
def _layer_norm_fake(x, weight, bias, eps, out_dtype):
    # the kernel stores bf16; the CPU twin the requested dtype, else x's
    dtype = out_dtype or (torch.bfloat16 if x.is_cuda else x.dtype)
    return torch.empty_like(x, dtype=dtype, memory_format=torch.contiguous_format)


@torch.library.custom_op(f"{NAMESPACE}::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       key_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """#22's o for q/k/v ``[B, H, S, dh]`` (read through their strides, as
    the views of the QKV product arrive) and an fp32 ``key_bias`` ``[B, S]``
    or None, as the merged context ``[B, S, H*dh]``, contiguous."""
    return attn_mod.flash_context(q, k, v, key_bias)   # the twin, merged, on CPU tensors


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, key_bias):
    b, h, s, dh = q.shape
    return q.new_empty((b, s, h * dh))


def tower(x, key_bias, layers, heads, eps, act, post_ln):
    """``fused_tower``'s export branch: the layers flattened into the op's
    weight list."""
    return tower_op(x, key_bias, flatten_layers(layers), is_quantized(layers[0][2]), heads,
                    float(eps), act, bool(post_ln))
