"""nans_clip_tpu_torch: the PyTorch/CUDA port of ``nans_clip_tpu``.

Chinese-CLIP feature extraction (ViT image tower, Chinese BERT text tower)
on one NVIDIA H100, with the JAX package's TPU kernels replaced by kernels
written by hand for Hopper (``csrc/``, built by ``ops/_build.py`` on first
use). Imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

import importlib

# the public names, imported on first use: a process that only loads an
# engine (deploy/engine.py) does not import the model-building modules
_EXPORTS = {
    "CLIPModel": "api", "available_models": "api", "create_model": "api",
    "image_transform": "api", "load": "api", "load_from_name": "api",
    "CLIPConfig": "configs", "config_for_name": "configs", "load_config": "configs",
    "tiny_config": "configs", "ModelOptions": "models", "get_tokenizer": "tokenizer",
    "tokenize": "tokenizer",
}

__all__ = [*_EXPORTS, "__version__"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
