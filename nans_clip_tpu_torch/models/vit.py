"""Vision Transformer tower (counterpart of ``nans_clip_tpu/models/vit.py``).

Modules and parameters are named after the reference ``VisualTransformer``
(clip/model.py:230-287), so a reference state dict loads as it is. The
computation follows the JAX tower:

* the patch embedding is one reshape and one matmul (a stride == kernel
  convolution is a per-patch projection), flattening each patch in the
  JAX package's ``(p, p, 3)`` order (vit.py:96-98) against the reference
  OIHW kernel transposed to HWIO;
* CLS and positional embeddings, ``ln_pre``, the pre-LN layers with
  QuickGELU, ``ln_post`` on the CLS token and ``proj``.

The layers run as ``ops/gates.py`` routes them. Under tensor parallelism
(``options.tp`` > 1), before any other route, every layer is the two TP
sub-blocks of ``parallel/tp.py`` (the JAX branch, vit.py:145-169): the
partial kernels #11/#12 where ``gates.tp_impls`` says "fused", their twins
otherwise (``attn_impl="pallas"`` included, as in JAX), in inference and in
training alike; int8 weights are dequantized on entry. Under ``attn_impl="pallas"``
each layer is the JAX tower's unfused branch (vit.py:327-338), LayerNorm,
projections and MLP in plain torch around the flash attention of
``ops/attention.py`` (#22, and #23 in training): :func:`_pallas_layer`.
Otherwise: at serving batches all of
them in one launch of the whole-tower kernel (``ops/tower_kernel.py``),
otherwise each through the sub-block kernels (``ops/fused_block.py``), or
through the twins for CPU tensors. The sub-block kernels are those the JAX
tower names (``vit.py:190-338``): attention #1 where ``gates.fits_fused``
holds and #7 where only ``gates.fits_fused_wide`` does (ViT-H widths at
S = 577), the MLP by ``_mlp_dispatch`` (#2, or #10 / #9 at W > 768). The
JAX tower routes its inference forwards at the wide widths through XLA;
the card has no such route and runs the kernels there too. The tower's int8 weights
(``utils/quantize.py``) stream as they are into the tower kernel and are
dequantized on entry everywhere else. A training forward
(``options.deterministic`` False) runs every layer through the autograd
Functions (kernels #1 / #7 and #2 / #10 / #9 forward; backward #14 and
#18, #13 and #17 where a weight is frozen or ``options.bwd_impl`` routes
there, #20 above ``gates.ATTN_BWD_MAX_SEQ`` and #19 after #9 / #10, or the
whole-layer #21 of ``ops/layer_bwd.py``), never the tower kernel
(``vit.py:258-271``). The parameters are cast to the compute dtype on each
forward (``ModelOptions.cast``). Images are NHWC ``[B, R, R, 3]``. FLIP
random masking (``vit.py:74-81``) is split in two so that a caller can feed
the kept tokens: :func:`draw_ids_keep` draws them from a ``torch.Generator``,
:func:`gather_kept` gathers them after the positional embedding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nans_clip_tpu_torch.configs import VisionConfig
from nans_clip_tpu_torch.models.common import ModelOptions, layer_entries, layers_from
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops.activations import quick_gelu, upcast
from nans_clip_tpu_torch.ops.attention import mha
from nans_clip_tpu_torch.ops.fused_block import (_mlp_dispatch, _reference_block,
                                                 _reference_mlp, attention_block_train,
                                                 fused_attention_block,
                                                 fused_attention_block_wide, mlp_block_train)
from nans_clip_tpu_torch.ops.layer_bwd import fused_layer_train
from nans_clip_tpu_torch.ops.layernorm import layer_norm
from nans_clip_tpu_torch.ops.tower_kernel import TowerTable, fused_tower
from nans_clip_tpu_torch.parallel.mesh import model_group
from nans_clip_tpu_torch.parallel.tp import tp_attention_block, tp_mlp_block
from nans_clip_tpu_torch.utils.quantize import dequantize_weight, is_quantized


def patch_weight(weight: torch.Tensor) -> torch.Tensor:
    """The OIHW conv kernel ``[W, 3, p, p]`` as the patch projection's
    ``[p*p*3, W]`` matrix (HWIO, flattened)."""
    w, _, p, _ = weight.shape
    return weight.permute(2, 3, 1, 0).reshape(p * p * 3, w)


def embed_patches(images: torch.Tensor, w_flat: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, R, R, 3] NHWC -> [B, g*g, W] through the ``patch_weight`` matrix."""
    b, r = images.shape[0], images.shape[1]
    g = r // patch
    x = images.reshape(b, g, patch, g, patch, 3).permute(0, 1, 3, 2, 4, 5).reshape(
        b, g * g, patch * patch * 3)
    return x @ w_flat


class PatchEmbed(nn.Module):
    """Holds the reference conv kernel ``[W, 3, p, p]`` (OIHW); the forward
    is :func:`embed_patches` on its :func:`patch_weight`."""

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))


class MultiheadAttentionParams(nn.Module):
    """The parameter layout of ``nn.MultiheadAttention`` (q|k|v rows in
    ``in_proj_weight``), without its forward: the kernels compute it."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadAttentionParams(width)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = Mlp(width)

    def weights(self) -> tuple:
        """The layer in ``encoder_layer_math``'s order; the four big weights
        are tensors or ``Int8Weight``s."""
        attn, mlp = self.attn, self.mlp
        return (self.ln_1.weight, self.ln_1.bias, attn.in_proj_weight, attn.in_proj_bias,
                attn.out_proj.weight, attn.out_proj.bias, self.ln_2.weight, self.ln_2.bias,
                mlp.c_fc.weight, mlp.c_fc.bias, mlp.c_proj.weight, mlp.c_proj.bias)

    def tp_partial_parameters(self) -> tuple:
        """The parameters that the partial sub-blocks consume under tensor
        parallelism (their gradients are per-rank shares): both pre-LN
        LayerNorms, the sliced weights and b_qkv / b1."""
        attn, mlp = self.attn, self.mlp
        return (self.ln_1.weight, self.ln_1.bias, attn.in_proj_weight, attn.in_proj_bias,
                attn.out_proj.weight, self.ln_2.weight, self.ln_2.bias, mlp.c_fc.weight,
                mlp.c_fc.bias, mlp.c_proj.weight)


# Heads a chunk of #7 in the JAX tower (vit.py:313-317).
WIDE_HEADS_PER_CHUNK = 4


def wide_tile(seq: int, width: int) -> int:
    """1 where the JAX tower runs #7 (only ``fits_fused_wide`` holds), else
    0 (#1)."""
    return int(not gates.fits_fused(seq, width) and gates.fits_fused_wide(seq, width))


def _pallas_layer(x: torch.Tensor, p: tuple, heads: int) -> torch.Tensor:
    """The JAX tower's layer under ``attn_impl="pallas"`` (vit.py:327-338):
    ``x + mha(LN(x))`` with the flash attention (#22/#23, their twins on
    CPU tensors), then the plain quick-GELU MLP; LayerNorm and the products
    in plain torch, as XLA runs them in JAX, and autograd through all of it
    in training."""
    x = x + mha(layer_norm(x, p[0], p[1], 1e-5), *p[2:6], heads, impl="pallas")
    h = quick_gelu(F.linear(layer_norm(x, p[6], p[7], 1e-5), p[8], p[9]))
    return x + F.linear(h, p[10], p[11])


def _layer(x: torch.Tensor, p: tuple, heads: int, use_kernel: bool) -> torch.Tensor:
    if not use_kernel:
        x = _reference_block(x, *p[:6], heads, 1e-5)
        return _reference_mlp(x, *p[6:], "quick_gelu", 1e-5, False)
    if wide_tile(x.shape[1], x.shape[2]):
        x = fused_attention_block_wide(x, *p[:6], heads, 1e-5, WIDE_HEADS_PER_CHUNK)
    else:
        x = fused_attention_block(x, *p[:6], heads, 1e-5)
    return _mlp_dispatch(x, *p[6:], None, "quick_gelu", 1e-5, False, False, 0.0)


def _tp_layers(x: torch.Tensor, layers, heads: int, options: ModelOptions) -> torch.Tensor:
    """Every layer through the TP sub-blocks of ``parallel/tp.py`` (JAX
    vit.py:145-169), each rank on its heads and MLP columns."""
    group = model_group(options.tp)
    a_impl, m_impl = gates.tp_impls(x, options.attn_impl)
    for p in layers:
        p = tuple(dequantize_weight(t, x.dtype) if is_quantized(t) else t for t in p)
        x = tp_attention_block(x, *p[:6], heads, options.tp, 1e-5, impl=a_impl, group=group)
        x = tp_mlp_block(x, *p[6:], "quick_gelu", options.tp, 1e-5, impl=m_impl, group=group)
    return x


def run_layers(x: torch.Tensor, layers, heads: int, options: ModelOptions,
               table: Optional[TowerTable] = None) -> torch.Tensor:
    """The tower's layers on x [B, S, W] as ``ops/gates.py`` routes them
    (the module docstring); ``table`` caches the tower kernel's pointer
    table."""
    w = x.shape[2]
    if options.tp > 1:
        return _tp_layers(x, layers, heads, options)
    if options.deterministic and gates.tower_route(x, options.attn_impl, "image", heads, 4 * w,
                                                   is_quantized(layers[0][2]), options.tp):
        return fused_tower(x, None, layers, heads, 1e-5, "quick_gelu", False, table)
    use_kernel = gates.use_kernel(x, options.attn_impl)
    pallas = gates.pallas_route(options.attn_impl)
    route_a = gates.bwd_route("attn_pre", options.bwd_impl)
    route_m = gates.bwd_route("mlp_pre", options.bwd_impl)
    for p in layers:
        p = tuple(dequantize_weight(t, x.dtype) if is_quantized(t) else t for t in p)
        if pallas:
            x = _pallas_layer(x, p, heads)
        elif options.deterministic:
            x = _layer(x, p, heads, use_kernel)
        elif gates.layer_bwd_route(options.bwd_impl, p, x.shape[1], w, heads, 4 * w):
            x = fused_layer_train(x, *p, heads, "quick_gelu", 1e-5, use_kernel)
        else:
            x = attention_block_train(x, *p[:6], None, heads, 1e-5, False,
                                      use_kernel=use_kernel, route=route_a,
                                      wide_tile=wide_tile(x.shape[1], w))
            x = mlp_block_train(x, *p[6:], "quick_gelu", 1e-5, False,
                                use_kernel=use_kernel, route=route_m)
    return x


def embed(images: torch.Tensor, w_flat: torch.Tensor, cls: torch.Tensor, pos: torch.Tensor,
          patch: int) -> torch.Tensor:
    """Patch tokens after the CLS token, plus the positional embedding:
    [B, 1 + g*g, W], the weights in the images' dtype."""
    x = embed_patches(images, w_flat, patch)
    b, w = x.shape[0], x.shape[2]
    x = torch.cat([cls.expand(b, 1, w), x], dim=1)
    return x + pos


def head(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
         proj: torch.Tensor) -> torch.Tensor:
    """``ln_post`` on the CLS token, then ``proj``: [B, embed_dim]."""
    return layer_norm(x.select(1, 0), ln_w, ln_b, 1e-5) @ proj


def draw_ids_keep(batch: int, seq_len: int, mask_ratio: float,
                  generator: torch.Generator) -> torch.Tensor:
    """The FLIP tokens to keep, [B, int((L - 1) (1 - mask_ratio))] int64
    positions in 1..L-1 (0 is CLS, always kept), on the generator's device:
    the first positions of a stable argsort of uniform noise (vit.py:77-79)."""
    len_keep = int((seq_len - 1) * (1 - mask_ratio))
    noise = torch.rand(batch, seq_len - 1, generator=generator, device=generator.device)
    return torch.argsort(noise, dim=1, stable=True)[:, :len_keep] + 1


def gather_kept(x: torch.Tensor, ids_keep: torch.Tensor) -> torch.Tensor:
    """CLS and the kept tokens of ``x`` [B, L, W] (vit.py:80-81)."""
    idx = ids_keep.to(x.device)[:, :, None].expand(-1, -1, x.shape[-1])
    return torch.cat([x[:, :1, :], torch.gather(x, 1, idx)], dim=1)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width) for _ in range(layers)])


class VisualTransformer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = PatchEmbed(w, cfg.patch_size)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.seq_len, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = Transformer(w, cfg.layers)
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))
        self.tower_table = TowerTable()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The CLIP init scheme of ``nans_clip_tpu.models.vit.init_vit``."""
        w, layers = self.cfg.width, self.cfg.layers
        scale = w ** -0.5
        proj_std = (w ** -0.5) * ((2 * layers) ** -0.5)
        fc_std = (2 * w) ** -0.5
        for p in (self.conv1.weight, self.class_embedding, self.positional_embedding, self.proj):
            p.normal_(0.0, scale, generator=generator)
        for ln in (m for m in self.modules() if isinstance(m, nn.LayerNorm)):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        for blk in self.transformer.resblocks:
            blk.attn.in_proj_weight.normal_(0.0, scale, generator=generator)
            blk.attn.out_proj.weight.normal_(0.0, proj_std, generator=generator)
            blk.mlp.c_fc.weight.normal_(0.0, fc_std, generator=generator)
            blk.mlp.c_proj.weight.normal_(0.0, proj_std, generator=generator)
            for bias in (blk.attn.in_proj_bias, blk.attn.out_proj.bias, blk.mlp.c_fc.bias,
                         blk.mlp.c_proj.bias):
                bias.zero_()

    def forward(self, images: torch.Tensor, options: ModelOptions = ModelOptions(),
                mask_ratio: float = 0.0, generator: Optional[torch.Generator] = None,
                ids_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images: [B, R, R, 3] NHWC. Returns [B, embed_dim]. FLIP masking:
        ``ids_keep`` (from :func:`draw_ids_keep`) when given, else drawn from
        ``generator`` when ``mask_ratio`` > 0."""
        cast = options.cast
        images = images.to(options.dtype or self.proj.dtype)
        x = embed(images, patch_weight(cast(self.conv1.weight)),
                  cast(self.class_embedding).to(images.dtype),
                  cast(self.positional_embedding).to(images.dtype), self.cfg.patch_size)
        if ids_keep is None and mask_ratio > 0:
            if generator is None:
                raise ValueError("mask_ratio > 0 requires a generator")
            ids_keep = draw_ids_keep(x.shape[0], x.shape[1], mask_ratio, generator)
        if ids_keep is not None:
            x = gather_kept(x, ids_keep)
        x = layer_norm(x, cast(self.ln_pre.weight), cast(self.ln_pre.bias), 1e-5)
        layers = [tuple(cast(t) for t in blk.weights()) for blk in self.transformer.resblocks]
        x = run_layers(x, layers, self.cfg.heads, options, self.tower_table)
        return head(x, cast(self.ln_post.weight), cast(self.ln_post.bias), cast(self.proj))

    def serving_weights(self, options: ModelOptions) -> dict:
        """The tensors of an inference forward, by name, in the compute
        dtype and in the layout the forward reads (the patch projection
        flattened; ``ln_pre`` and ``ln_post``, which the plain ``layer_norm``
        reads in fp32, in fp32): the inputs of :func:`serve`."""
        cast = options.cast
        ln = lambda t: upcast(cast(t))
        w = {"conv1": patch_weight(cast(self.conv1.weight)),
             "class_embedding": cast(self.class_embedding),
             "positional_embedding": cast(self.positional_embedding),
             "ln_pre.weight": ln(self.ln_pre.weight), "ln_pre.bias": ln(self.ln_pre.bias)}
        w.update(layer_entries([tuple(cast(t) for t in blk.weights())
                                for blk in self.transformer.resblocks]))
        w.update({"ln_post.weight": ln(self.ln_post.weight),
                  "ln_post.bias": ln(self.ln_post.bias), "proj": cast(self.proj)})
        return w


def serve(cfg: VisionConfig, w: dict, images: torch.Tensor, options: ModelOptions,
          table: Optional[TowerTable] = None) -> torch.Tensor:
    """The inference forward of :meth:`VisualTransformer.forward` (no FLIP
    masking) from its :meth:`~VisualTransformer.serving_weights` ``w``: the
    same functions on the same values, with no cast or reshape of a weight.
    images: [B, R, R, 3] NHWC; returns [B, embed_dim]."""
    images = images.to(w["proj"].dtype)
    x = embed(images, w["conv1"], w["class_embedding"], w["positional_embedding"],
              cfg.patch_size)
    x = layer_norm(x, w["ln_pre.weight"], w["ln_pre.bias"], 1e-5)
    x = run_layers(x, layers_from(w, cfg.layers), cfg.heads, options, table)
    return head(x, w["ln_post.weight"], w["ln_post.bias"], w["proj"])
