"""Eval side (counterpart of ``nans_clip_tpu/eval``): model loading, the
recall scorer, the zero-shot templates; the CLIs are modules of their own."""

from nans_clip_tpu_torch.eval.evaluation import compute_score, recall_at_ks
from nans_clip_tpu_torch.eval.model_io import load_eval_model
from nans_clip_tpu_torch.eval.templates import (imagenet_classnames, imagenet_templates,
                                                templates_for_dataset)

__all__ = ["compute_score", "recall_at_ks", "load_eval_model",
           "imagenet_classnames", "imagenet_templates", "templates_for_dataset"]
