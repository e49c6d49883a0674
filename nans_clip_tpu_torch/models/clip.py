"""Dual-tower CLIP container (counterpart of ``nans_clip_tpu/models/clip.py``).

Reference ``CLIP`` semantics (clip/model.py:290-431): ``encode_image`` runs
the ViT tower, or the ModifiedResNet (``cfg.is_resnet``: RN50,
``models/resnet.py``) on its running BatchNorm statistics unless
``bn_train`` asks for a training forward's batch statistics;
``encode_text`` builds the padding mask from ``PAD_ID``, runs BERT and
projects the [CLS] state through ``text_projection``; ``forward`` returns
L2-normalised features and ``exp(logit_scale)``; ``get_similarity`` returns
both-way scaled logits in fp32. ``logit_scale`` initialises to
``ln(1/0.07)``. A training forward passes ``ModelOptions(deterministic=
False)`` and a ``torch.Generator`` for the text tower's dropout (the vision
tower has none). ``ModelOptions(tp=n)`` runs both towers tensor-parallel in
the caller's process group of n ranks (``parallel/tp.py``); every rank holds
the full weights and computes the same features. ``ModelOptions(pp=n)``
runs each transformer tower as a pipeline of n stages (``parallel/pp.py``);
every stage computes the same features. A ResNet image tower takes no FLIP
masking (``mask_ratio`` and ``ids_keep`` do nothing, as in JAX) and runs
whole on every rank under ``tp`` or ``pp`` > 1, its parameters replicated,
as the JAX package runs it (its ``param_spec`` names no ResNet leaf); only
the text tower is split. Under a ``torch.profiler`` session the towers
record the spans ``model.encode_image`` and ``model.encode_text``
(``utils/profiling.py``), numbered by call.
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
from nans_clip_tpu_torch.models.resnet import ModifiedResNet
from nans_clip_tpu_torch.models.resnet import serve as resnet_serve
from nans_clip_tpu_torch.models.vit import VisualTransformer
from nans_clip_tpu_torch.models.vit import serve as vit_serve
from nans_clip_tpu_torch.utils import profiling
from nans_clip_tpu_torch.utils.profiling import span

PAD_ID = 0  # vocab.txt line 1 is [PAD]


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = ModifiedResNet(cfg.vision) if cfg.is_resnet else \
            VisualTransformer(cfg.vision)
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
        in a fixed order: every layer of a ViT image tower, then of the text
        tower (a ResNet tower runs whole on every rank: its gradients are
        the one-rank gradients already)."""
        image = () if self.cfg.is_resnet else tuple(self.visual.transformer.resblocks)
        return [t for layer in (*image, *self.bert.encoder.layer)
                for t in layer.tp_partial_parameters()]

    def encode_image(self, images: torch.Tensor, options: ModelOptions = ModelOptions(),
                     mask_ratio: float = 0.0, generator: Optional[torch.Generator] = None,
                     ids_keep: Optional[torch.Tensor] = None, bn_train: bool = False,
                     bn_update: bool = True) -> torch.Tensor:
        """images: [B, R, R, 3] NHWC. Unnormalised features [B, E]. FLIP
        masking as :meth:`VisualTransformer.forward` (a ViT tower); BatchNorm
        mode ``bn_train`` / ``bn_update`` as :meth:`ModifiedResNet.forward`
        (a ResNet tower)."""
        with span("model.encode_image"):
            if self.cfg.is_resnet:
                return self.visual(images, options, bn_train, bn_update)
            return self.visual(images, options, mask_ratio, generator, ids_keep)

    def encode_text(self, text_ids: torch.Tensor, options: ModelOptions = ModelOptions(),
                    generator: Optional[torch.Generator] = None,
                    sample0: int = 0) -> torch.Tensor:
        """text_ids: [B, S] int. Unnormalised features [B, E]. ``generator``
        draws the dropout of a training forward, its masks counting samples
        from ``sample0`` (a data-parallel rank's first row of the global
        microbatch)."""
        with span("model.encode_text"):
            attn_mask = (text_ids != PAD_ID).float()
            seq = self.bert(text_ids, attn_mask, options, generator, sample0, head_rows=1)
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


def batch_stats(module: CLIP) -> dict:
    """The image tower's BatchNorm running statistics by name (the live
    buffers): empty for a ViT tower."""
    return dict(module.visual.named_buffers()) if module.cfg.is_resnet else {}


def serving_weights(module: CLIP, tower: str, options: ModelOptions) -> dict:
    """The tensors of ``tower``'s inference forward, by name (the inputs of
    :func:`serve`): the image tower's ``serving_weights``, or
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
    """``encode_image`` / ``encode_text`` (deterministic, tp 1, pp 1) from
    :func:`serving_weights`: unnormalised features [B, E]. x: images [B, R,
    R, 3] NHWC, or text ids [B, S]."""
    if options.tp > 1 or options.pp > 1 or not options.deterministic:
        raise ValueError("serve runs the deterministic forward at tp 1 and pp 1")
    if tower == "image":
        serve_image = resnet_serve if cfg.is_resnet else vit_serve
        return serve_image(cfg.vision, w, x, options)
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
    nothing from the global RNG. On the card it also reserves the span
    recorder's CUDA events (once a process), so that a profiled window
    around the model makes none."""
    with torch.device("meta"):
        model = CLIP(cfg)
    model = model.to_empty(device=device)
    if torch.device(device).type == "cuda":
        profiling.reserve()
    if generator is not None:
        model.init_weights(generator)
    return model
