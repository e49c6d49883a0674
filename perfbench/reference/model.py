"""Chinese-CLIP's towers in plain fp32 PyTorch, from the published
description (cn_clip/clip/model.py and modeling_bert.py):

- image: a ViT. The patch embedding is the stride-p convolution (as an
  unfold and a product with the OIHW kernel), the class token and the
  positional embedding, ``ln_pre``, pre-LN layers (``x + attn(ln_1(x))``,
  ``x + c_proj(QuickGELU(c_fc(ln_2(x))))``, the heads of
  ``nn.MultiheadAttention``: q|k|v rows of ``in_proj_weight``), then
  ``ln_post`` on the class token and ``proj``; LayerNorm eps 1e-5;
- text: a BERT. Word, position and token-type-0 embeddings and their
  LayerNorm (eps 1e-12), post-LN layers (``LN(x + dense(attn(x)))``,
  ``LN(x + fc2(GELU(fc1(x))))``, erf GELU) whose scores take the additive
  key bias ``(1 - mask) * -10000`` with mask = ids != 0 ([PAD]), no
  pooler; the [CLS] state times ``text_projection``.

The training forward takes ``drops``: the text tower's dropout (the
embedding output, the attention probabilities and each sub-block's
output), as :mod:`perfbench.reference.philox` defines its masks.

Every product goes through a :class:`Precision`: fp32 (TF32 off, see
``reference.precise``), or, for the control, fp8 (E4M3 operands with one
scale a tensor, E5M2 gradients, fp32 accumulation).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference import philox


def _quant(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to an fp8 format, scaled by one factor a tensor so that
    its largest magnitude is the format's largest value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x.float() * scale).clamp(-top, top).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _quant(a, torch.float8_e4m3fn), _quant(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _quant(g, torch.float8_e5m2)
        return torch.matmul(g8, b8.transpose(-1, -2)), torch.matmul(a8.transpose(-1, -2), g8)


class Precision:
    """The arithmetic of the reference's products: ``"fp32"`` or ``"fp8"``."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {name!r}")
        self.name = name

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(a, b)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        y = self.matmul(x, w.t())
        return y if b is None else y + b


FP32 = Precision("fp32")


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, w = x.shape
    return x.view(b, s, h, w // h).transpose(1, 2)


def _attention(q, k, v, heads: int, prec: Precision, bias=None, keep=None):
    """Scaled dot-product attention over ``heads`` heads: [B, S, W] each.
    ``bias``: an additive [B, S] key bias; ``keep``: [B, H, S, S] dropout
    multipliers of the probabilities."""
    q, k, v = (_heads(t, heads) for t in (q, k, v))
    scores = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias[:, None, None, :]
    p = torch.softmax(scores, dim=-1)
    if keep is not None:
        p = p * keep
    ctx = prec.matmul(p, v)
    b, h, s, dh = ctx.shape
    return ctx.transpose(1, 2).reshape(b, s, h * dh)


def encode_image(w: Dict[str, torch.Tensor], cfg: dict, images: torch.Tensor,
                 prec: Precision = FP32) -> torch.Tensor:
    """images: [B, R, R, 3] NHWC, normalised. Unnormalised features [B, E]."""
    p, width = cfg["vision_patch_size"], cfg["vision_width"]
    heads = width // cfg["vision_head_width"]
    x = images.float().permute(0, 3, 1, 2)
    cols = F.unfold(x, kernel_size=p, stride=p).transpose(1, 2)          # [B, L, 3pp]
    x = prec.matmul(cols, w["visual.conv1.weight"].reshape(width, -1).t())
    cls = w["visual.class_embedding"].expand(x.shape[0], 1, width)
    x = torch.cat([cls, x], dim=1) + w["visual.positional_embedding"]
    ln = lambda t, n: F.layer_norm(t, (width,), w[f"{n}.weight"], w[f"{n}.bias"], 1e-5)
    x = ln(x, "visual.ln_pre")
    for i in range(cfg["vision_layers"]):
        b = f"visual.transformer.resblocks.{i}"
        y = ln(x, f"{b}.ln_1")
        q, k, v = prec.linear(y, w[f"{b}.attn.in_proj_weight"],
                              w[f"{b}.attn.in_proj_bias"]).chunk(3, dim=-1)
        x = x + prec.linear(_attention(q, k, v, heads, prec), w[f"{b}.attn.out_proj.weight"],
                            w[f"{b}.attn.out_proj.bias"])
        y = prec.linear(ln(x, f"{b}.ln_2"), w[f"{b}.mlp.c_fc.weight"], w[f"{b}.mlp.c_fc.bias"])
        y = y * torch.sigmoid(1.702 * y)
        x = x + prec.linear(y, w[f"{b}.mlp.c_proj.weight"], w[f"{b}.mlp.c_proj.bias"])
    return prec.matmul(ln(x[:, 0], "visual.ln_post"), w["visual.proj"])


class TextDropout:
    """The dropout of one training forward of the text tower: the
    embedding's seed and each layer's two (attention sub-block, MLP)."""

    def __init__(self, embed_seed: int, layer_seeds: Sequence[Sequence[int]],
                 hidden_rate: float, attn_rate: float, sample0: int = 0):
        self.embed_seed, self.layer_seeds = embed_seed, [tuple(s) for s in layer_seeds]
        self.hidden_rate, self.attn_rate = hidden_rate, attn_rate
        self.sample0 = sample0      # the batch's first row in the masks' sample count

    def at(self, sample0: int) -> "TextDropout":
        return TextDropout(self.embed_seed, self.layer_seeds, self.hidden_rate,
                           self.attn_rate, sample0)


def encode_text(w: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
                prec: Precision = FP32, drops: Optional[TextDropout] = None) -> torch.Tensor:
    """ids: [B, S] int. Unnormalised features [B, E]."""
    h, eps = cfg["text_hidden_size"], cfg["text_layer_norm_eps"]
    heads = cfg["text_num_attention_heads"]
    ids = ids.long()
    bsz, s = ids.shape
    dev = ids.device
    e = "bert.embeddings"
    x = (w[f"{e}.word_embeddings.weight"][ids] + w[f"{e}.position_embeddings.weight"][:s]
         + w[f"{e}.token_type_embeddings.weight"][0])
    ln = lambda t, n: F.layer_norm(t, (h,), w[f"{n}.weight"], w[f"{n}.bias"], eps)
    x = ln(x, f"{e}.LayerNorm")
    hid = lambda seed, stream: philox.hidden(seed, stream, drops.hidden_rate, bsz, s, h, dev,
                                             drops.sample0)
    if drops is not None:
        x = x * hid(drops.embed_seed, philox.EMBED)
    bias = (1.0 - (ids != 0).float()) * -10000.0
    for i in range(cfg["text_num_hidden_layers"]):
        b = f"bert.encoder.layer.{i}"
        sa = f"{b}.attention.self"
        q, k, v = (prec.linear(x, w[f"{sa}.{n}.weight"], w[f"{sa}.{n}.bias"])
                   for n in ("query", "key", "value"))
        keep = None
        if drops is not None:
            seed_a, seed_m = drops.layer_seeds[i]
            keep = philox.attention(seed_a, drops.attn_rate, bsz, heads, s, dev, drops.sample0)
        a = prec.linear(_attention(q, k, v, heads, prec, bias, keep),
                        w[f"{b}.attention.output.dense.weight"],
                        w[f"{b}.attention.output.dense.bias"])
        if drops is not None:
            a = a * hid(seed_a, philox.HIDDEN)
        x = ln(x + a, f"{b}.attention.output.LayerNorm")
        y = F.gelu(prec.linear(x, w[f"{b}.intermediate.dense.weight"],
                               w[f"{b}.intermediate.dense.bias"]))
        y = prec.linear(y, w[f"{b}.output.dense.weight"], w[f"{b}.output.dense.bias"])
        if drops is not None:
            y = y * hid(seed_m, philox.HIDDEN)
        x = ln(x + y, f"{b}.output.LayerNorm")
    return prec.matmul(x[:, 0], w["text_projection"])


def normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@torch.no_grad()
def features(w, cfg: dict, tower: str, x: torch.Tensor, prec: Precision = FP32,
             block: int = 64) -> torch.Tensor:
    """L2-normalised fp32 features of ``x`` through ``tower``, ``block``
    rows at a time."""
    fn = encode_image if tower == "image" else encode_text
    return torch.cat([normalize(fn(w, cfg, x[i:i + block], prec))
                      for i in range(0, x.shape[0], block)])
