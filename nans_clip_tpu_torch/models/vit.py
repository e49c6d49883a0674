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

Each layer runs through the ported kernels (``ops/fused_block.py``) or
their twins, as ``ops/gates.py`` routes. Images are NHWC ``[B, R, R, 3]``.
FLIP random masking waits for the training port.
"""

from __future__ import annotations

import torch
from torch import nn

from nans_clip_tpu_torch.configs import VisionConfig
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops.fused_block import (_reference_block, _reference_mlp,
                                                 fused_attention_block, fused_mlp_block)
from nans_clip_tpu_torch.ops.layernorm import layer_norm


class PatchEmbed(nn.Module):
    """Holds the reference conv kernel ``[W, 3, p, p]`` (OIHW)."""

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, R, R, 3] NHWC -> [B, g*g, W]."""
        w, _, p, _ = self.weight.shape
        b, r = images.shape[0], images.shape[1]
        g = r // p
        x = images.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
        return x @ self.weight.permute(2, 3, 1, 0).reshape(p * p * 3, w)


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

    def forward(self, x: torch.Tensor, heads: int, use_kernel: bool) -> torch.Tensor:
        attn, mlp = self.attn, self.mlp
        attn_fn = fused_attention_block if use_kernel else _reference_block
        mlp_fn = fused_mlp_block if use_kernel else _reference_mlp
        x = attn_fn(x, self.ln_1.weight, self.ln_1.bias, attn.in_proj_weight, attn.in_proj_bias,
                    attn.out_proj.weight, attn.out_proj.bias, heads, 1e-5)
        return mlp_fn(x, self.ln_2.weight, self.ln_2.bias, mlp.c_fc.weight, mlp.c_fc.bias,
                      mlp.c_proj.weight, mlp.c_proj.bias, "quick_gelu", 1e-5, False)


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

    def forward(self, images: torch.Tensor, options: ModelOptions = ModelOptions()) -> torch.Tensor:
        """images: [B, R, R, 3] NHWC. Returns [B, embed_dim]."""
        images = images.to(self.proj.dtype)
        b, w = images.shape[0], self.cfg.width
        x = self.conv1(images)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        x = layer_norm(x, self.ln_pre.weight, self.ln_pre.bias, 1e-5)
        use_kernel = gates.use_kernel(x, options.attn_impl)
        for blk in self.transformer.resblocks:
            x = blk(x, self.cfg.heads, use_kernel)
        x = layer_norm(x[:, 0, :], self.ln_post.weight, self.ln_post.bias, 1e-5)
        return x @ self.proj
