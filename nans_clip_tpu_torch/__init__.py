"""nans_clip_tpu_torch: the PyTorch/CUDA port of ``nans_clip_tpu``.

Chinese-CLIP feature extraction (ViT image tower, Chinese BERT text tower)
on one NVIDIA H100, with the JAX package's TPU kernels replaced by kernels
written by hand for Hopper (``csrc/``, built by ``ops/_build.py`` on first
use). Imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from nans_clip_tpu_torch.api import (CLIPModel, available_models, create_model,
                                     image_transform, load, load_from_name)
from nans_clip_tpu_torch.configs import CLIPConfig, config_for_name, load_config, tiny_config
from nans_clip_tpu_torch.models import ModelOptions
from nans_clip_tpu_torch.tokenizer import get_tokenizer, tokenize

__all__ = [
    "CLIPModel", "available_models", "create_model", "image_transform", "load",
    "load_from_name", "CLIPConfig", "config_for_name", "load_config", "tiny_config",
    "ModelOptions", "get_tokenizer", "tokenize", "__version__",
]
