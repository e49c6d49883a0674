"""Public API (counterpart of ``nans_clip_tpu/api.py``): ``load_from_name``,
``load``, ``create_model``, ``available_models``, ``tokenize``,
``image_transform`` and :class:`CLIPModel`, the reference ``cn_clip.clip``
surface (clip/utils.py:14-216; clip/model.py:390-431).

Published checkpoints are looked up under ``~/.cache/clip`` (or
``download_root``); nothing is downloaded. ``load_from_name`` also takes an
HF ``save_pretrained`` snapshot directory (``utils/hf_interop.py``), and
every loader takes an HF-layout state dict. A checkpoint of another grid
than the model's (a 224 px ``.pt`` at ``input_resolution=336``) loads with
its positional embedding resized. Models are built on the card
(``device="cuda"``) unless the caller names another device; without a card
that default raises.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from nans_clip_tpu_torch.configs import (CLIPConfig, MODEL_CKPT_FILES, MODEL_INFO,
                                         available_models, load_config, with_resolution)
from nans_clip_tpu_torch.models.clip import CLIP, build_clip
from nans_clip_tpu_torch.models.common import ModelOptions, cast_module
from nans_clip_tpu_torch.parallel.mesh import model_group
from nans_clip_tpu_torch.tokenizer import tokenize
from nans_clip_tpu_torch.utils.torch_interop import (fit_pos_embed, load_torch_state_dict,
                                                     merge_pretrained)
from nans_clip_tpu_torch.utils.transform import image_transform

__all__ = ["load_from_name", "load", "tokenize", "image_transform",
           "available_models", "CLIPModel", "create_model", "model_from_config"]


class CLIPModel:
    """Bundles (config, module, options); inference only. Inputs may be
    numpy arrays or tensors and are moved to the module's device. With
    ``options.tp`` > 1 every rank of the caller's model group builds the
    same model (``parallel/mesh.py::init_model_group`` first) and gets the
    same results; a group of another size raises here."""

    def __init__(self, cfg: CLIPConfig, module: CLIP, options: ModelOptions = ModelOptions()):
        if options.tp > 1:
            model_group(options.tp)
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

    def quantize(self, mode: str = "int8", towers=("text", "image")) -> "CLIPModel":
        """Weight-only int8 serving copy (``utils/quantize.py``): the
        whole-tower kernel then streams half the weight bytes a call; routes
        other than the tower kernel dequantize on entry. A ResNet image tower
        (RN50) stays in the compute dtype, as the JAX package leaves it.
        Returns a NEW model that shares every tensor it did not quantize;
        ``self`` is unchanged."""
        if mode != "int8":
            raise ValueError(f"unsupported quantize mode: {mode!r}")
        from nans_clip_tpu_torch.utils.quantize import quantize_for_serving
        return CLIPModel(self.cfg, quantize_for_serving(self.module, towers), self.options)

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
    """Copy a normalised reference state dict in, its positional embedding
    resized to the module's grid. Every parameter must be present; extra
    keys (buffers of other reference versions) are ignored."""
    result = module.load_state_dict(fit_pos_embed(state_dict, module), strict=False)
    if result.missing_keys:
        raise KeyError(f"checkpoint lacks {len(result.missing_keys)} parameters, "
                       f"e.g. {result.missing_keys[:5]}")


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by default; pass "
                           "device='cpu' to run the plain-torch path on the CPU")
    return device


def create_model(model_name: str, checkpoint_path: Optional[str] = None,
                 input_resolution: Optional[int] = None,
                 options: ModelOptions = ModelOptions(), seed: int = 0,
                 device="cuda") -> CLIPModel:
    """Build a model from a ``Vision@Text`` struct: weights from a reference
    ``.pt`` when given, else random init from a generator seeded by ``seed``."""
    cfg = load_config(model_name)
    if input_resolution:
        cfg = with_resolution(cfg, input_resolution)
    return model_from_config(cfg, checkpoint_path, options, seed, device)


def model_from_config(cfg: CLIPConfig, checkpoint_path: Optional[str] = None,
                      options: ModelOptions = ModelOptions(), seed: int = 0,
                      device="cuda") -> CLIPModel:
    """:func:`create_model` for a :class:`CLIPConfig` in hand."""
    device = _device(device)
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
                   options: ModelOptions = ModelOptions(), device="cuda"):
    """Reference clip/utils.py:106-127. ``name`` is a published model name
    (its ``.pt`` must already be in ``download_root``, default
    ``~/.cache/clip``), an HF ``save_pretrained`` snapshot directory (its
    ``config.json`` gives the architecture; ``input_resolution`` resizes the
    positional embedding), or a reference ``.pt`` path together with the
    tower names and resolution. Returns (CLIPModel, preprocess_fn)."""
    if name in MODEL_INFO:
        root = download_root or os.path.expanduser("~/.cache/clip")
        model_path = os.path.join(root, MODEL_CKPT_FILES[name])
        if not os.path.isfile(model_path):
            raise FileNotFoundError(
                f"checkpoint for {name} not found at {model_path}; nothing is downloaded: "
                f"place {MODEL_CKPT_FILES[name]} in {root} or pass download_root")
        vision, text, resolution = MODEL_INFO[name]
        struct = f"{vision}@{text}"
    elif os.path.isdir(name) and os.path.isfile(os.path.join(name, "config.json")):
        import json

        from nans_clip_tpu_torch.utils.hf_interop import config_from_hf, load_hf_checkpoint
        if vision_model_name or text_model_name:
            raise ValueError(
                "vision_model_name/text_model_name cannot override an HF snapshot "
                f"directory — its architecture comes from {os.path.join(name, 'config.json')}. "
                "Drop them, or pass a bare .pt file to pick the architecture explicitly.")
        with open(os.path.join(name, "config.json")) as f:
            cfg = config_from_hf(json.load(f))
        if input_resolution:
            cfg = with_resolution(cfg, input_resolution)
        state_dict, cfg = load_hf_checkpoint(name, cfg)
        module = build_clip(cfg, _device(device))
        _load_weights(module, state_dict)
        return CLIPModel(cfg, module, options), image_transform(cfg.vision.image_resolution)
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
    (reference clip/utils.py:130-142; either may be in the HF layout):
    ``visual.*`` and ``logit_scale`` from the first, ``bert.*`` from the
    second (``utils/torch_interop.py::merge_pretrained``)."""
    merge_pretrained(model.module, load_torch_state_dict(clip_path) if clip_path else None,
                     load_torch_state_dict(bert_path) if bert_path else None)
    return model
