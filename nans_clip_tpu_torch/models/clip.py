"""Dual-tower CLIP container (counterpart of ``nans_clip_tpu/models/clip.py``).

Reference ``CLIP`` semantics (clip/model.py:290-431): ``encode_image`` runs
the ViT tower; ``encode_text`` builds the padding mask from ``PAD_ID``,
runs BERT and projects the [CLS] state through ``text_projection``;
``forward`` returns L2-normalised features and ``exp(logit_scale)``;
``get_similarity`` returns both-way scaled logits in fp32.
``logit_scale`` initialises to ``ln(1/0.07)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nans_clip_tpu_torch.configs import CLIPConfig
from nans_clip_tpu_torch.models.bert import BertModel
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.models.vit import VisualTransformer

PAD_ID = 0  # vocab.txt line 1 is [PAD]


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        if cfg.is_resnet:
            raise NotImplementedError("the ResNet vision tower is not ported yet")
        self.cfg = cfg
        self.visual = VisualTransformer(cfg.vision)
        self.bert = BertModel(cfg.text)
        self.text_projection = nn.Parameter(torch.empty(cfg.text.hidden_size, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.visual.init_weights(generator)
        self.bert.init_weights(generator)
        self.text_projection.normal_(0.0, self.cfg.text.hidden_size ** -0.5, generator=generator)
        self.logit_scale.fill_(math.log(1.0 / 0.07))

    def encode_image(self, images: torch.Tensor,
                     options: ModelOptions = ModelOptions()) -> torch.Tensor:
        """images: [B, R, R, 3] NHWC. Unnormalised features [B, E]."""
        return self.visual(images, options)

    def encode_text(self, text_ids: torch.Tensor,
                    options: ModelOptions = ModelOptions()) -> torch.Tensor:
        """text_ids: [B, S] int. Unnormalised features [B, E]."""
        attn_mask = (text_ids != PAD_ID).float()
        seq = self.bert(text_ids, attn_mask, options)
        return seq[:, 0, :] @ self.text_projection.to(seq.dtype)

    def forward(self, images: Optional[torch.Tensor], texts: Optional[torch.Tensor],
                options: ModelOptions = ModelOptions()):
        if images is None and texts is None:
            raise ValueError("forward needs images, texts or both")
        if images is None:
            return self.encode_text(texts, options)
        if texts is None:
            return self.encode_image(images, options)
        img = normalize(self.encode_image(images, options))
        txt = normalize(self.encode_text(texts, options))
        return img, txt, self.logit_scale.float().exp()

    def get_similarity(self, images: torch.Tensor, texts: torch.Tensor,
                       options: ModelOptions = ModelOptions()):
        img = normalize(self.encode_image(images, options))
        txt = normalize(self.encode_text(texts, options))
        logits_per_image = self.logit_scale.float().exp() * img.float() @ txt.float().T
        return logits_per_image, logits_per_image.T


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True).to(x.dtype)


def build_clip(cfg: CLIPConfig, device="cpu",
               generator: Optional[torch.Generator] = None) -> CLIP:
    """An fp32 CLIP on ``device``: random init from ``generator`` when one
    is given, else uninitialised storage for a state dict to fill. The
    modules are built on the meta device first, so construction draws
    nothing from the global RNG."""
    with torch.device("meta"):
        model = CLIP(cfg)
    model = model.to_empty(device=device)
    if generator is not None:
        model.init_weights(generator)
    return model
