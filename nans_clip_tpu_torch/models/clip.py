"""Dual-tower CLIP container (counterpart of ``nans_clip_tpu/models/clip.py``).

Reference ``CLIP`` semantics (clip/model.py:290-431): ``encode_image`` runs
the ViT tower; ``encode_text`` builds the padding mask from ``PAD_ID``,
runs BERT and projects the [CLS] state through ``text_projection``;
``forward`` returns L2-normalised features and ``exp(logit_scale)``;
``get_similarity`` returns both-way scaled logits in fp32.
``logit_scale`` initialises to ``ln(1/0.07)``. A training forward passes
``ModelOptions(deterministic=False)`` and a ``torch.Generator`` for the text
tower's dropout (the vision tower has none). ``ModelOptions(tp=n)`` runs
both towers tensor-parallel in the caller's process group of n ranks
(``parallel/tp.py``); every rank holds the full weights and computes the
same features.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nans_clip_tpu_torch.configs import CLIPConfig
from nans_clip_tpu_torch.models.bert import BertModel
from nans_clip_tpu_torch.models.bert import serve as bert_serve
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.models.vit import VisualTransformer
from nans_clip_tpu_torch.models.vit import serve as vit_serve

PAD_ID = 0  # vocab.txt line 1 is [PAD]


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        if cfg.is_resnet:
            raise NotImplementedError("the ResNet vision tower (RN50) is not ported yet "
                                      "(ROADMAP.md queue 1 item 5)")
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

    def tp_partial_parameters(self) -> list:
        """The parameters whose gradients are per-rank shares under tensor
        parallelism (``parallel/tp.py::reduce_partial_grads`` sums them),
        in a fixed order: every layer of the image tower, then of the text
        tower."""
        return [t for layer in (*self.visual.transformer.resblocks, *self.bert.encoder.layer)
                for t in layer.tp_partial_parameters()]

    def encode_image(self, images: torch.Tensor, options: ModelOptions = ModelOptions(),
                     mask_ratio: float = 0.0, generator: Optional[torch.Generator] = None,
                     ids_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images: [B, R, R, 3] NHWC. Unnormalised features [B, E]. FLIP
        masking as :meth:`VisualTransformer.forward`."""
        return self.visual(images, options, mask_ratio, generator, ids_keep)

    def encode_text(self, text_ids: torch.Tensor, options: ModelOptions = ModelOptions(),
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """text_ids: [B, S] int. Unnormalised features [B, E]. ``generator``
        draws the dropout of a training forward."""
        attn_mask = (text_ids != PAD_ID).float()
        seq = self.bert(text_ids, attn_mask, options, generator)
        return seq[:, 0, :] @ self.text_projection.to(seq.dtype)

    def forward(self, images: Optional[torch.Tensor], texts: Optional[torch.Tensor],
                options: ModelOptions = ModelOptions(),
                generator: Optional[torch.Generator] = None):
        if images is None and texts is None:
            raise ValueError("forward needs images, texts or both")
        if images is None:
            return self.encode_text(texts, options, generator)
        if texts is None:
            return self.encode_image(images, options)
        img = normalize(self.encode_image(images, options))
        txt = normalize(self.encode_text(texts, options, generator))
        return img, txt, self.logit_scale.float().exp()

    def get_similarity(self, images: torch.Tensor, texts: torch.Tensor,
                       options: ModelOptions = ModelOptions()):
        img = normalize(self.encode_image(images, options))
        txt = normalize(self.encode_text(texts, options))
        logits_per_image = self.logit_scale.float().exp() * img.float() @ txt.float().T
        return logits_per_image, logits_per_image.T


TOWERS = ("image", "text")


def serving_weights(module: CLIP, tower: str, options: ModelOptions) -> dict:
    """The tensors of ``tower``'s inference forward, by name (the inputs of
    :func:`serve`): ``VisualTransformer.serving_weights``, or
    ``BertModel.serving_weights`` with ``text_projection``."""
    if tower == "image":
        return module.visual.serving_weights(options)
    if tower != "text":
        raise ValueError(f"tower must be one of {TOWERS}, got {tower!r}")
    w = module.bert.serving_weights(options)
    w["text_projection"] = options.cast(module.text_projection)
    return w


def serve(cfg: CLIPConfig, tower: str, w: dict, x: torch.Tensor,
          options: ModelOptions) -> torch.Tensor:
    """``encode_image`` / ``encode_text`` (deterministic, tp 1) from
    :func:`serving_weights`: unnormalised features [B, E]. x: images [B, R,
    R, 3] NHWC, or text ids [B, S]."""
    if options.tp > 1 or not options.deterministic:
        raise ValueError("serve runs the deterministic forward at tp 1")
    if tower == "image":
        return vit_serve(cfg.vision, w, x, options)
    if tower != "text":
        raise ValueError(f"tower must be one of {TOWERS}, got {tower!r}")
    seq = bert_serve(cfg.text, w, x, (x != PAD_ID).float(), options)
    return seq.select(1, 0) @ w["text_projection"]


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
