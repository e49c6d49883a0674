"""The one-GPU contrastive train step (counterpart of
``nans_clip_tpu/training/trainer.py``).

What the JAX trainer does, on one card:

* ``TrainConfig`` with the JAX fields and defaults;
* AdamW with the reference's weight-decay exclusion (:func:`no_decay_mask`:
  a parameter whose reference name holds ``bn``, ``ln``, ``bias`` or
  ``logit_scale`` is not decayed, training/main.py:147-166), a cosine
  schedule with linear warmup (:func:`cosine_with_warmup`,
  training/scheduler.py:10-20), optional global-norm clipping with optax's
  rule, ``freeze_vision`` (the vision tower takes no gradient and no
  update) and the ``logit_scale`` clamp to [0, ln 100]
  (training/train.py:261-262);
* one step: both towers' features with ``ModelOptions(deterministic=
  False)`` (dropout in the text tower when a generator is given), the
  contrastive loss (``parallel/loss.py``), the backward through the
  sub-block Functions (kernels #14, #16, #18), the optimizer update.

``torch.optim.AdamW`` computes optax's ``adamw``: decoupled decay
(``p -= lr * wd * p``), bias-corrected moments and ``eps`` added outside
the square root (``mu_hat / (sqrt(nu_hat) + eps)``); the learning rate of
step t (counted from 0) is ``schedule(t)``, as optax's count. The
parameters are fp32 masters; each forward casts them to the compute dtype
(``ModelOptions.cast``). The state is updated in place (torch's optimizer
owns its moments) and returned, so a caller writes
``state, metrics = step(state, images, texts, generator)`` as with JAX.

Not ported yet (each raises ``NotImplementedError``; ROADMAP.md queue 1,
item 9): gradient accumulation (``accum_freq > 1``), FLIP masking
(``mask_ratio > 0``), distillation, and Adam moments in another dtype
(``adam_state_dtype``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from nans_clip_tpu_torch.api import _device
from nans_clip_tpu_torch.configs import CLIPConfig
from nans_clip_tpu_torch.models.clip import normalize
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.parallel.loss import clip_loss

LOGIT_SCALE_MAX = math.log(100.0)
# Substrings of a reference parameter name that exempt it from weight decay
# (training/main.py:147; case-sensitive, so BERT's "LayerNorm.weight" decays).
NO_DECAY = ("bn", "ln", "bias", "logit_scale")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 5e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    wd: float = 0.001
    warmup: int = 100
    max_steps: int = 1000
    mask_ratio: float = 0.0
    accum_freq: int = 1
    freeze_vision: bool = False
    label_smoothing: float = 0.0
    distillation: bool = False
    kd_loss_weight: float = 0.5
    grad_norm_clip: Optional[float] = None
    skip_scheduler: bool = False
    adam_state_dtype: Optional[str] = None


@dataclasses.dataclass
class TrainState:
    step: int
    module: nn.Module
    optimizer: torch.optim.Optimizer


def _check_supported(tcfg: TrainConfig) -> None:
    todo = {"accum_freq > 1": tcfg.accum_freq > 1, "mask_ratio > 0": tcfg.mask_ratio > 0,
            "distillation": tcfg.distillation, "adam_state_dtype": tcfg.adam_state_dtype}
    for what, asked in todo.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported to the GPU trainer yet "
                                      "(ROADMAP.md queue 1, item 9)")


def no_decay_mask(module: nn.Module) -> Dict[str, bool]:
    """{parameter name: True where weight decay must NOT apply}, by the
    reference's case-sensitive substring rule on its names (the JAX
    package's ``no_decay_mask`` reproduces the same rule on its tree)."""
    return {name: any(s in name for s in NO_DECAY) for name, _ in module.named_parameters()}


def cosine_with_warmup(base_lr: float, warmup: int, total_steps: int,
                       skip_decay: bool = False) -> Callable[[int], float]:
    """The learning rate of a step: linear warmup, then cosine decay to 0 at
    ``total_steps`` (or constant with ``skip_decay``)."""

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * (step + 1) / max(warmup, 1)
        if skip_decay:
            return base_lr
        e, es = step - warmup, max(total_steps - warmup, 1)
        return 0.5 * (1 + math.cos(math.pi * e / es)) * base_lr

    return schedule


def make_optimizer(tcfg: TrainConfig, module: nn.Module) -> torch.optim.AdamW:
    """AdamW over the parameters that take gradients, in two groups: decayed
    and not (:func:`no_decay_mask`)."""
    mask = no_decay_mask(module)
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    groups = [{"params": [p for n, p in named if not mask[n]], "weight_decay": tcfg.wd},
              {"params": [p for n, p in named if mask[n]], "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=tcfg.lr, betas=(tcfg.beta1, tcfg.beta2), eps=tcfg.eps)


def create_train_state(module: nn.Module, tcfg: TrainConfig, device="cuda") -> TrainState:
    """Move the fp32 ``module`` to ``device`` (the card unless the caller
    names another; without a card that default raises) and build its
    optimizer. ``freeze_vision`` takes the vision tower out of the
    gradient and the update."""
    _check_supported(tcfg)
    module = module.to(_device(device)).float().train()
    if tcfg.freeze_vision:
        module.visual.requires_grad_(False)
    return TrainState(step=0, module=module, optimizer=make_optimizer(tcfg, module))


def _clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm: scale every gradient by max / norm when the
    global norm reaches max."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def make_train_step(cfg: CLIPConfig, tcfg: TrainConfig, options: ModelOptions) -> Callable:
    """Build the train step ``step(state, images, texts, generator=None) ->
    (state, {"loss", "i2t_acc", "t2i_acc", "logit_scale"})``. ``images``:
    [B, R, R, 3] NHWC, ``texts``: [B, S] ids (tensors or arrays, moved to the
    module's device); ``generator``: a ``torch.Generator`` (or an int seed)
    drawing the text tower's dropout, None for none. The metrics are 0-d
    tensors on the device; ``logit_scale`` is its value before the update."""
    _check_supported(tcfg)
    del cfg  # the module carries its configuration
    train_options = dataclasses.replace(options, deterministic=False)
    schedule = cosine_with_warmup(tcfg.lr, tcfg.warmup, tcfg.max_steps, tcfg.skip_scheduler)

    def step(state: TrainState, images, texts,
             generator: Union[torch.Generator, int, None] = None):
        module, opt = state.module, state.optimizer
        dev = module.logit_scale.device
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        if options.deterministic:
            generator = None          # no dropout, as the JAX deterministic forward
        images = torch.as_tensor(images, device=dev)
        texts = torch.as_tensor(texts, device=dev).long()
        for group in opt.param_groups:
            group["lr"] = schedule(state.step)
        opt.zero_grad(set_to_none=True)
        img = normalize(module.encode_image(images, train_options))
        txt = normalize(module.encode_text(texts, train_options, generator))
        logit_scale = module.logit_scale.detach().clone()
        loss, metrics = clip_loss(img, txt, module.logit_scale.float().exp(),
                                  tcfg.label_smoothing)
        loss.backward()
        if tcfg.grad_norm_clip:
            _clip_by_global_norm(module.parameters(), tcfg.grad_norm_clip)
        opt.step()
        with torch.no_grad():
            module.logit_scale.clamp_(0.0, LOGIT_SCALE_MAX)
        state.step += 1
        return state, {"loss": loss.detach(), **metrics, "logit_scale": logit_scale}

    return step


def make_eval_step(cfg: CLIPConfig, options: ModelOptions) -> Callable:
    """In-batch validation loss and accuracies: ``eval_step(module, images,
    texts) -> {"loss", "i2t_acc", "t2i_acc"}``, deterministic, no gradient."""
    del cfg
    eval_options = dataclasses.replace(options, deterministic=True)

    @torch.no_grad()
    def eval_step(module: nn.Module, images, texts):
        dev = module.logit_scale.device
        img = normalize(module.encode_image(torch.as_tensor(images, device=dev), eval_options))
        txt = normalize(module.encode_text(torch.as_tensor(texts, device=dev).long(),
                                           eval_options))
        loss, metrics = clip_loss(img, txt, module.logit_scale.float().exp())
        return {"loss": loss, **metrics}

    return eval_step
