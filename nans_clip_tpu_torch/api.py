"""Public API (counterpart of ``nans_clip_tpu/api.py``): ``load_from_name``,
``load``, ``create_model``, ``available_models``, ``tokenize``,
``image_transform`` and :class:`CLIPModel`, the reference ``cn_clip.clip``
surface (clip/utils.py:14-216; clip/model.py:390-431).

Published checkpoints are looked up under ``~/.cache/clip`` (or
``download_root``); nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from nans_clip_tpu_torch.configs import (CLIPConfig, MODEL_CKPT_FILES, MODEL_INFO,
                                         available_models, load_config, with_resolution)
from nans_clip_tpu_torch.models.clip import CLIP, build_clip
from nans_clip_tpu_torch.models.common import ModelOptions, cast_module
from nans_clip_tpu_torch.tokenizer import tokenize
from nans_clip_tpu_torch.utils.torch_interop import load_torch_state_dict
from nans_clip_tpu_torch.utils.transform import image_transform

__all__ = ["load_from_name", "load", "tokenize", "image_transform",
           "available_models", "CLIPModel", "create_model"]


class CLIPModel:
    """Bundles (config, module, options); inference only. Inputs may be
    numpy arrays or tensors and are moved to the module's device."""

    def __init__(self, cfg: CLIPConfig, module: CLIP, options: ModelOptions = ModelOptions()):
        self.cfg = cfg
        self.options = options
        self.module = cast_module(module, options).eval()

    @property
    def device(self) -> torch.device:
        return self.module.logit_scale.device

    @property
    def image_resolution(self) -> int:
        return self.cfg.vision.image_resolution

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, device=self.device)

    def _texts(self, texts) -> torch.Tensor:
        return torch.as_tensor(texts, device=self.device).long()

    @torch.inference_mode()
    def encode_image(self, images) -> torch.Tensor:
        """images: [B, R, R, 3] NHWC float. Unnormalised features [B, E]."""
        return self.module.encode_image(self._images(images), self.options)

    @torch.inference_mode()
    def encode_text(self, texts) -> torch.Tensor:
        """texts: [B, context_length] int ids. Unnormalised features [B, E]."""
        return self.module.encode_text(self._texts(texts), self.options)

    @torch.inference_mode()
    def get_similarity(self, images, texts) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both-way scaled cosine logits, fp32."""
        return self.module.get_similarity(self._images(images), self._texts(texts), self.options)

    @torch.inference_mode()
    def forward(self, images, texts):
        return self.module(self._images(images), self._texts(texts), self.options)


def _load_weights(module: CLIP, state_dict: dict) -> None:
    """Copy a normalised reference state dict in. Every parameter must be
    present; extra keys (buffers of other reference versions) are ignored."""
    result = module.load_state_dict(state_dict, strict=False)
    if result.missing_keys:
        raise KeyError(f"checkpoint lacks {len(result.missing_keys)} parameters, "
                       f"e.g. {result.missing_keys[:5]}")


def create_model(model_name: str, checkpoint_path: Optional[str] = None,
                 input_resolution: Optional[int] = None,
                 options: ModelOptions = ModelOptions(), seed: int = 0,
                 device="cpu") -> CLIPModel:
    """Build a model from a ``Vision@Text`` struct: weights from a reference
    ``.pt`` when given, else random init from a generator seeded by ``seed``."""
    cfg = load_config(model_name)
    if input_resolution:
        cfg = with_resolution(cfg, input_resolution)
    if checkpoint_path:
        module = build_clip(cfg, device)
        _load_weights(module, load_torch_state_dict(checkpoint_path))
    else:
        module = build_clip(cfg, "cpu", torch.Generator().manual_seed(seed)).to(device)
    return CLIPModel(cfg, module, options)


def load_from_name(name: str, download_root: Optional[str] = None,
                   vision_model_name: Optional[str] = None,
                   text_model_name: Optional[str] = None,
                   input_resolution: Optional[int] = None,
                   options: ModelOptions = ModelOptions(), device="cpu"):
    """Reference clip/utils.py:106-127. ``name`` is a published model name
    (its ``.pt`` must already be in ``download_root``, default
    ``~/.cache/clip``) or a reference ``.pt`` path together with the tower
    names and resolution. Returns (CLIPModel, preprocess_fn)."""
    if name in MODEL_INFO:
        root = download_root or os.path.expanduser("~/.cache/clip")
        model_path = os.path.join(root, MODEL_CKPT_FILES[name])
        if not os.path.isfile(model_path):
            raise FileNotFoundError(
                f"checkpoint for {name} not found at {model_path}; nothing is downloaded: "
                f"place {MODEL_CKPT_FILES[name]} in {root} or pass download_root")
        vision, text, resolution = MODEL_INFO[name]
        struct = f"{vision}@{text}"
    elif os.path.isfile(name):
        if not (vision_model_name and text_model_name and input_resolution):
            raise ValueError("Please specify 'vision_model_name', 'text_model_name' "
                             "and 'input_resolution'")
        model_path = name
        struct = f"{vision_model_name}@{text_model_name}"
        resolution = input_resolution
    else:
        raise RuntimeError(f"Model {name} not found; available models = {available_models()}")
    model = create_model(struct, model_path, input_resolution=resolution, options=options,
                         device=device)
    return model, image_transform(resolution)


def load(model: CLIPModel, clip_path: Optional[str] = None,
         bert_path: Optional[str] = None) -> CLIPModel:
    """Initialise the towers from separate CLIP and BERT state dicts
    (reference clip/utils.py:130-142): ``visual.*`` and ``logit_scale`` from
    the first, ``bert.*`` from the second."""
    merged = {}
    if clip_path:
        merged.update({k: v for k, v in load_torch_state_dict(clip_path).items()
                       if k.startswith("visual") or k == "logit_scale"})
    if bert_path:
        merged.update({k: v for k, v in load_torch_state_dict(bert_path).items()
                       if k.startswith("bert")})
    own = model.module.state_dict()
    unknown = sorted(set(merged) - set(own))
    if unknown:
        raise KeyError(f"keys not in the model: {unknown[:5]}")
    model.module.load_state_dict(merged, strict=False)
    return model
