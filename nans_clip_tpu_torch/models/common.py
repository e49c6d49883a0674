"""Shared model utilities: options and parameter casting (counterpart of
``nans_clip_tpu/models/common.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.utils.quantize import Int8Weight, is_quantized


# The JAX CLIs' --precision values (training/params.py:79-80,
# deploy/server.py, eval/model_io.py:44).
PRECISIONS = ("amp", "fp16", "bf16", "fp32")


def compute_dtype_for(precision: str) -> Optional[str]:
    """``ModelOptions.compute_dtype`` for a --precision value: every value
    but ``fp32`` runs in bf16, as ``nans_clip_tpu/eval/model_io.py:44``
    maps them (``amp`` and ``fp16`` too: the TPU has no fp16 path, and the
    card's kernels take bf16)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return None if precision == "fp32" else "bfloat16"


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Knobs threaded through the towers.

    ``attn_impl``: "auto" runs the hand kernels for CUDA tensors and the
    plain-torch twins for CPU tensors; "plain" always runs the twins;
    "kernel" always runs the kernels (CUDA only). The JAX package's values
    are taken too: "fused" runs what "auto" runs, "xla" what "plain" runs,
    and "pallas" its flash-attention route: each layer is LayerNorm, the
    projections and the MLP in plain torch around the flash attention
    (kernels #22/#23 on CUDA tensors, their twins on CPU tensors; the plain
    attention above ``gates.MAX_PALLAS_SEQ`` or under attention dropout, as
    in JAX), and no sub-block, whole-layer or whole-tower kernel. See
    ``ops/gates.py``.
    ``compute_dtype``: None keeps the parameter dtype; "bfloat16" casts the
    parameters (all but ``logit_scale``) and the inputs. The kernels take
    bf16, so a model on the card needs "bfloat16" unless ``attn_impl`` is
    "plain" or "xla". For inference ``cast_module`` casts the parameters
    once, in place; for training the parameters stay fp32 masters and each
    forward casts them (:meth:`cast`, as ``cast_tree`` runs inside the JAX
    towers), so gradients reach the fp32 parameters through the cast.
    ``deterministic``: False is the training forward: dropout where the
    tower has it, and every layer through the autograd Functions.
    ``bwd_impl``: the backward of a block whose weights all need gradients:
    "fullgrad" (kernels #14/#16/#18), "emit" (#13/#15/#17 and library
    products for the weight gradients), "layer" (#21 for the image tower's
    layers, "fullgrad" elsewhere) or "auto", the routes measured on the
    card (``ops/gates.py``). A block with a frozen weight takes the
    emitting kernels whatever this says.
    ``tp``: the number of tensor-parallel ranks. Above 1 every layer of both
    towers runs the sub-blocks of ``parallel/tp.py`` (the partial kernels
    #11/#12 on each rank's heads and MLP columns, one all-reduce a
    sub-block) before any other route, in a process group of ``tp`` ranks
    that the caller formed (``parallel/mesh.py::init_model_group``); the
    rank is the group's model group (``mesh.model_group``). A text tower
    with dropout under ``tp`` > 1 runs the sub-blocks' twins with the masks
    one process draws.
    ``data``: the number of data-parallel ranks, the other axis of the
    ``data x tp`` grid of the process group (``mesh.grid``). Above 1 the
    train step splits each microbatch over the data group, gathers the
    features for the global-batch loss and reduces the gradients
    (``training/trainer.py``), and a ResNet tower's training BatchNorm
    normalises with the statistics of the global microbatch.
    ``remat``: each transformer layer of a forward with autograd is
    rematerialised (``torch.utils.checkpoint``, the JAX ``jax.checkpoint``
    around one layer): its activations are recomputed in the backward
    instead of stored. A ResNet tower takes none, as in JAX.
    ``pp``: the number of pipeline stages, the third axis of the ``data x
    tp x pipe`` grid (``mesh.grid``; exclusive with ``tp`` > 1, as the JAX
    towers assert). Above 1 each transformer tower runs its layers as the
    GPipe loop of ``parallel/pp.py`` over this rank's pipe group, each
    stage on its own ``L / pp`` layers, the local batch split into
    ``pp_microbatches`` microbatches (0: ``pp.pick_microbatches``); the
    tower's output reaches every stage.
    """

    attn_impl: str = "auto"
    compute_dtype: Optional[str] = None
    deterministic: bool = True
    bwd_impl: str = "auto"
    tp: int = 1
    data: int = 1
    remat: bool = False
    pp: int = 1
    pp_microbatches: int = 0

    def __post_init__(self):
        if self.attn_impl not in gates.IMPLS:
            raise ValueError(f"attn_impl must be one of {gates.IMPLS}, got {self.attn_impl!r}")
        if self.bwd_impl not in gates.BWD_IMPLS:
            raise ValueError(f"bwd_impl must be one of {gates.BWD_IMPLS}, got "
                             f"{self.bwd_impl!r}")
        for axis in ("tp", "data", "pp"):
            n = getattr(self, axis)
            if not isinstance(n, int) or isinstance(n, bool) or n < 1:
                raise ValueError(f"{axis} must be a positive int, got {n!r}")
        if self.tp > 1 and self.pp > 1:
            raise ValueError("tp > 1 and pp > 1 are mutually exclusive")
        if not isinstance(self.pp_microbatches, int) or self.pp_microbatches < 0:
            raise ValueError(f"pp_microbatches must be an int >= 0, got "
                             f"{self.pp_microbatches!r}")
        if self.compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"unsupported compute_dtype {self.compute_dtype!r}")

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return None if self.compute_dtype is None else getattr(torch, self.compute_dtype)

    def cast(self, t):
        """``t`` in the compute dtype when it is a floating tensor (a no-op
        for parameters already cast in place, and for int8 weights)."""
        dtype = self.dtype
        if dtype is None or not torch.is_tensor(t) or not t.is_floating_point():
            return t
        return t.to(dtype)


def remat_layer(fn, x, *args, options: ModelOptions):
    """``fn(x, *args)``, one layer; under ``options.remat`` with autograd
    on, rematerialised: ``torch.utils.checkpoint`` (non-reentrant) stores
    the layer's inputs and recomputes its forward in the backward. No RNG
    state is stashed: the layers draw from no global generator (the dropout
    masks are a function of each layer's seeds, ``ops/dropout.py``), so the
    recompute draws the forward's masks."""
    if options.remat and torch.is_grad_enabled():
        return checkpoint(fn, x, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(x, *args)


def cast_module(module: nn.Module, options: ModelOptions) -> nn.Module:
    """Cast every floating parameter except ``logit_scale`` to the compute
    dtype, in place, as ``nans_clip_tpu.models.common.cast_tree`` casts the
    towers (the logit scale stays fp32, as the JAX package reads it)."""
    dtype = options.dtype
    if dtype is None:
        return module
    for name, p in module.named_parameters():
        if p.is_floating_point() and name != "logit_scale":
            p.data = p.data.to(dtype)
    return module


# A layer's tensors by name, in ``encoder_layer_math``'s order (both towers).
LAYER_KEYS = ("ln_1.weight", "ln_1.bias", "qkv.weight", "qkv.bias", "out.weight", "out.bias",
              "ln_2.weight", "ln_2.bias", "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")


def layer_entries(layers, ln32: bool = False) -> dict:
    """``{"layers.{i}.{key}": tensor}`` for a tower's layer tuples; an
    ``Int8Weight`` is two entries, ``{key}.int8`` and ``{key}.scale``.
    ``ln32``: the LayerNorms in fp32, as the plain ``layer_norm`` of the
    ``pallas`` layers reads them (so an exported forward casts none)."""
    out = {}
    for i, p in enumerate(layers):
        for key, t in zip(LAYER_KEYS, p):
            if ln32 and key.startswith("ln_"):
                t = t.float()
            if is_quantized(t):
                out[f"layers.{i}.{key}.int8"], out[f"layers.{i}.{key}.scale"] = t.int8, t.scale
            else:
                out[f"layers.{i}.{key}"] = t
    return out


def layers_from(w: dict, n_layers: int) -> list:
    """The layer tuples of :func:`layer_entries`' dict ``w``."""
    def leaf(name):
        if name in w:
            return w[name]
        return Int8Weight(w[f"{name}.int8"], w[f"{name}.scale"])

    return [tuple(leaf(f"layers.{i}.{key}") for key in LAYER_KEYS) for i in range(n_layers)]
