"""Model configuration dataclasses + the named-model registry.

Counterpart of ``nans_clip_tpu/configs.py``. The model JSONs are read in
place from ``nans_clip_tpu/model_configs/``; that directory is located on
disk beside this package, so the JAX package is never imported.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple, Union

CONFIG_DIR = Path(__file__).resolve().parent.parent / "nans_clip_tpu" / "model_configs"


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """ViT vision tower (reference clip/model.py:230-287)."""

    embed_dim: int
    image_resolution: int
    layers: int
    width: int
    patch_size: int
    head_width: int = 64

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid_size * self.grid_size + 1


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """ModifiedResNet vision tower (reference clip/model.py:106-168).
    Parsed so every published config loads; the tower itself is not
    ported yet."""

    embed_dim: int
    image_resolution: int
    layers: Tuple[int, int, int, int]
    width: int
    head_width: int = 64

    @property
    def heads(self) -> int:
        return self.width * 32 // self.head_width

    @property
    def feature_dim(self) -> int:
        return self.width * 32


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """BERT text tower (reference clip/configuration_bert.py:25-86)."""

    vocab_size: int = 21128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    vision: Union[VisionConfig, ResNetConfig]
    text: TextConfig
    name: str = ""

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision, ResNetConfig)


# Published model zoo: name -> (vision-config file, text-config file, resolution)
# (reference clip/utils.py:27-48).
MODEL_INFO = {
    "ViT-B-16": ("ViT-B-16", "RoBERTa-wwm-ext-base-chinese", 224),
    "ViT-L-14": ("ViT-L-14", "RoBERTa-wwm-ext-base-chinese", 224),
    "ViT-L-14-336": ("ViT-L-14-336", "RoBERTa-wwm-ext-base-chinese", 336),
    "ViT-H-14": ("ViT-H-14", "RoBERTa-wwm-ext-large-chinese", 224),
    "RN50": ("RN50", "RBT3-chinese", 224),
}

# Checkpoint file names of the published models (reference clip/utils.py:19-25).
MODEL_CKPT_FILES = {
    "ViT-B-16": "clip_cn_vit-b-16.pt",
    "ViT-L-14": "clip_cn_vit-l-14.pt",
    "ViT-L-14-336": "clip_cn_vit-l-14-336.pt",
    "ViT-H-14": "clip_cn_vit-h-14.pt",
    "RN50": "clip_cn_rn50.pt",
}


def available_models():
    return list(MODEL_INFO.keys())


def _load_json(name: str) -> dict:
    path = CONFIG_DIR / f"{name.replace('/', '-')}.json"
    if not path.exists():
        raise FileNotFoundError(f"no model config named {name!r} under {CONFIG_DIR}")
    with open(path) as f:
        return json.load(f)


def tiny_config() -> CLIPConfig:
    """2-layer, 64-wide debug CLIP (the JAX package's ``tiny_config``)."""
    return CLIPConfig(
        embed_dim=64,
        vision=VisionConfig(embed_dim=64, image_resolution=32, layers=2,
                            width=64, patch_size=16, head_width=32),
        text=TextConfig(hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128),
        name="tiny")


def load_config(struct: str) -> CLIPConfig:
    """Build a :class:`CLIPConfig` from a ``Vision@Text`` struct string,
    e.g. ``load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese")``."""
    vision_name, text_name = struct.split("@")
    v = _load_json(vision_name)
    t = _load_json(text_name)

    embed_dim = v["embed_dim"]
    layers = v["vision_layers"]
    if isinstance(layers, str):
        layers = tuple(json.loads(layers))
    if isinstance(layers, (list, tuple)):
        vision: Union[VisionConfig, ResNetConfig] = ResNetConfig(
            embed_dim=embed_dim,
            image_resolution=v["image_resolution"],
            layers=tuple(layers),
            width=v["vision_width"],
            head_width=v.get("vision_head_width", 64),
        )
    else:
        vision = VisionConfig(
            embed_dim=embed_dim,
            image_resolution=v["image_resolution"],
            layers=layers,
            width=v["vision_width"],
            patch_size=v["vision_patch_size"],
            head_width=v.get("vision_head_width", 64),
        )

    text = TextConfig(
        vocab_size=t["vocab_size"],
        hidden_size=t["text_hidden_size"],
        num_hidden_layers=t["text_num_hidden_layers"],
        num_attention_heads=t["text_num_attention_heads"],
        intermediate_size=t["text_intermediate_size"],
        hidden_act=t["text_hidden_act"],
        hidden_dropout_prob=t["text_hidden_dropout_prob"],
        attention_probs_dropout_prob=t["text_attention_probs_dropout_prob"],
        max_position_embeddings=t["text_max_position_embeddings"],
        type_vocab_size=t["text_type_vocab_size"],
        initializer_range=t["text_initializer_range"],
    )
    return CLIPConfig(embed_dim=embed_dim, vision=vision, text=text, name=struct)


def config_for_name(name: str) -> Tuple[CLIPConfig, int]:
    """Resolve a published model name to (config, input_resolution)."""
    if name not in MODEL_INFO:
        raise KeyError(f"Model {name} not found; available models = {available_models()}")
    vision_name, text_name, resolution = MODEL_INFO[name]
    return load_config(f"{vision_name}@{text_name}"), resolution


def with_resolution(cfg: CLIPConfig, image_resolution: int) -> CLIPConfig:
    """Return a config with a different input resolution."""
    if cfg.vision.image_resolution == image_resolution:
        return cfg
    vision = dataclasses.replace(cfg.vision, image_resolution=image_resolution)
    return dataclasses.replace(cfg, vision=vision)
