"""LoRA finetuning (counterpart of ``nans_clip_tpu/training/train_lora.py``).

* the base model and ``logit_scale`` are frozen; only the adapter tree
  (``models/lora.py``) is optimized, AdamW with decay on every adapter
  (train_lora.py:144-152, :172);
* InfoNCE with label smoothing (train_lora.py:96-110);
* gradient accumulation keeps the full negatives: the two-pass protocol of
  ``training/trainer.py::accumulate_backward``, the gradient of the JAX
  scan (train_lora.py:82-99);
* the train forward has BERT's dropout on (the reference trains in
  ``model.train()``), ``eval_step`` is deterministic.

The adapted weights reach the towers through
``torch.func.functional_call``; the frozen weights need no gradient, so the
sub-block Functions run the emitting backward kernels (#13, #15, #17) and
form only the two weight gradients the adapters ask for (the image tower's
``dwo``, the text tower's ``dwqkv``).

:func:`parse_args` takes the JAX CLI's flags, and ``--platform cpu|cuda``
(default: the card). :func:`main` is the JAX CLI's loop
(train_lora.py:126-233): the base model from ``--resume`` (a reference
``.pt`` or a checkpoint directory of the port's trainer) in fp32, the
adapters from a generator seeded by ``--seed``, ``PairDataset`` /
``DataLoader`` batches of ``batch_size x accum_freq`` pairs, the warmup-ratio
cosine schedule, ``training_log.csv`` (``epoch,train_loss,val_loss,lr,
is_best``) and ``best_lora.npz`` / ``last_lora.npz`` in ``--output-dir``.
Each step's text dropout is drawn from a generator seeded by ``(--seed,
step)``, as in ``training/main.py``.

Usage:
  python -m nans_clip_tpu_torch.training.train_lora \
      --train-data DIR/train --val-data DIR/valid --resume ckpt.pt \
      --vision-model ViT-B-16 --text-model RoBERTa-wwm-ext-base-chinese \
      --lora-rank 4 --lora-alpha 16 --epochs 30
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Callable, Optional, Union

import torch
from torch import nn
from torch.func import functional_call

from nans_clip_tpu_torch import configs
from nans_clip_tpu_torch.api import _device
from nans_clip_tpu_torch.data.augment import preprocess_images
from nans_clip_tpu_torch.data.dataset import DataLoader, PairDataset
from nans_clip_tpu_torch.eval.model_io import load_eval_model
from nans_clip_tpu_torch.models.clip import normalize
from nans_clip_tpu_torch.models.common import ModelOptions, compute_dtype_for
from nans_clip_tpu_torch.models.lora import (adapter_leaves, count_lora_params, init_lora,
                                             merge_lora, save_lora)
from nans_clip_tpu_torch.parallel import distributed
from nans_clip_tpu_torch.parallel.loss import clip_loss
from nans_clip_tpu_torch.training.trainer import (accumulate_backward, cosine_with_warmup,
                                                  draw_microbatches, platform_device, seeded,
                                                  step_seeds)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train-data", required=True)
    p.add_argument("--val-data", default=None)
    p.add_argument("--resume", default=None,
                   help="base model checkpoint (.pt); required unless --tiny-model")
    p.add_argument("--tiny-model", action="store_true",
                   help="2-layer 64-wide debug config (configs.tiny_config); --resume optional")
    p.add_argument("--vision-model", default="ViT-B-16")
    p.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese")
    p.add_argument("--output-dir", default="./lora_output")
    p.add_argument("--lora-rank", type=int, default=4)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--text-only", action="store_true")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--accum-freq", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=0.01)
    p.add_argument("--warmup-ratio", type=float, default=0.1)
    p.add_argument("--label-smoothing", type=float, default=0.05)
    p.add_argument("--context-length", type=int, default=52)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--num-threads", type=int, default=8)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="where to train: the card (default) or the CPU")
    p.add_argument("--distributed", action="store_true",
                   help="refused: LoRA finetuning runs on one rank")
    return p.parse_args(argv)


@dataclasses.dataclass
class LoraState:
    """What a LoRA run carries: the frozen base ``module``, the adapter
    tree and its optimizer (the JAX step threads ``base_params, adapters,
    opt_state``)."""

    step: int
    module: nn.Module
    adapters: dict
    optimizer: torch.optim.Optimizer


def create_lora_state(module: nn.Module, adapters: dict, lr: float = 1e-4, wd: float = 0.01,
                      device="cuda") -> LoraState:
    """Freeze the fp32 ``module`` (every parameter, ``logit_scale``
    included) on ``device`` (the card unless the caller names another) and
    build AdamW over the adapters, decay on all of them (optax.adamw's
    defaults: betas 0.9/0.999, eps 1e-8)."""
    module = module.to(_device(device)).float().requires_grad_(False)
    device = module.logit_scale.device     # "cuda" resolved to its index
    for t in adapter_leaves(adapters):
        if t.device != device:
            raise ValueError(f"adapters on {t.device}, the model on {device}: pass "
                             "init_lora the same device")
    opt = torch.optim.AdamW(adapter_leaves(adapters), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)
    return LoraState(step=0, module=module, adapters=adapters, optimizer=opt)


def make_lora_step(cfg, options: ModelOptions, alpha: float, label_smoothing: float, accum: int,
                   schedule: Optional[Callable[[int], float]] = None):
    """``(train_step, eval_step)``. ``train_step(state, images, texts,
    generator=None) -> (state, loss, metrics)`` updates ``state.adapters``
    in place; ``generator`` (a ``torch.Generator`` or an int seed) draws
    the text tower's dropout, None for none. ``eval_step(state, images,
    texts) -> loss`` is deterministic and takes no gradient. ``schedule``:
    the learning rate of a step (counted from 0), else the optimizer's.
    Tensor, data and pipeline parallelism (``options.tp``, ``data`` or
    ``pp`` > 1) raise: the JAX LoRA trainer has no mesh, and nothing here would gather
    the ranks' features or reduce their adapter gradients."""
    del cfg  # the module carries its configuration
    if options.tp > 1:
        raise NotImplementedError("LoRA finetuning under tensor parallelism (tp > 1) is not "
                                  "supported")
    for axis, n in (("data", options.data), ("pp", options.pp)):
        if n > 1:
            raise NotImplementedError(f"LoRA finetuning runs on one rank: {axis}={n} is not "
                                      "supported (the JAX LoRA trainer has no mesh)")
    train_opts = dataclasses.replace(options, deterministic=False)
    eval_opts = dataclasses.replace(options, deterministic=True)
    accum = max(accum, 1)

    def closures(module, weights, seeds, opts):
        """(encode, loss_fn) over ``weights`` ({parameter name: tensor}
        standing in for the module's own) for accumulate_backward."""

        def encode(j, im, tx):
            return (functional_call(module, weights, (im, None, opts)),
                    functional_call(module, weights, (None, tx, opts, seeded(seeds[j]))))

        def loss_fn(img_f, txt_f):
            return clip_loss(normalize(img_f), normalize(txt_f),
                             module.logit_scale.float().exp(), label_smoothing)

        return encode, loss_fn

    def train_step(state: LoraState, images, texts,
                   generator: Union[torch.Generator, int, None] = None):
        module, opt = state.module, state.optimizer
        dev = module.logit_scale.device
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        images = torch.as_tensor(images, device=dev)
        texts = torch.as_tensor(texts, device=dev).long()
        b = images.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum_freq {accum}")
        seeds = [seed for seed, _ in draw_microbatches(accum, b // accum, 0, 0.0, generator,
                                                       generator is not None)]
        if schedule is not None:
            for group in opt.param_groups:
                group["lr"] = schedule(state.step)
        opt.zero_grad(set_to_none=True)
        # The merged weights enter the towers as leaves: the microbatches'
        # gradients add up in them, then one backward carries the sums
        # through W + (alpha / r) B A into the adapters.
        merged = merge_lora(module, state.adapters, alpha)
        leaves = {k: v.detach().requires_grad_() for k, v in merged.items()}
        encode, loss_fn = closures(module, leaves, seeds, train_opts)
        loss, metrics = accumulate_backward(encode, images, texts, accum, loss_fn)
        names = [k for k in merged if leaves[k].grad is not None]
        torch.autograd.backward([merged[k] for k in names], [leaves[k].grad for k in names])
        opt.step()
        state.step += 1
        return state, loss, metrics

    @torch.no_grad()
    def eval_step(state: LoraState, images, texts):
        dev = state.module.logit_scale.device
        images = torch.as_tensor(images, device=dev)
        texts = torch.as_tensor(texts, device=dev).long()
        merged = merge_lora(state.module, state.adapters, alpha)
        encode, loss_fn = closures(state.module, merged, [None], eval_opts)
        return loss_fn(*encode(0, images, texts))[0]

    return train_step, eval_step


def main(argv=None):
    args = parse_args(argv)
    if args.distributed or distributed.launched():
        raise ValueError("LoRA finetuning runs on one rank (the JAX LoRA trainer has no mesh): "
                         "launch one process without --distributed")
    if not (args.resume or args.tiny_model):
        raise SystemExit("--resume is required unless --tiny-model")
    device = platform_device(args.platform)
    os.makedirs(args.output_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")

    # the base weights in fp32, as the JAX CLI holds them; the forward casts
    base = load_eval_model(args.vision_model, args.text_model, args.resume, "fp32",
                           cfg=configs.tiny_config() if args.tiny_model else None,
                           device=device)
    cfg, module = base.cfg, base.module
    if cfg.is_resnet:
        raise SystemExit("LoRA targets transformer towers (ViT models); a ResNet image tower "
                         f"({args.vision_model}) has none")
    options = ModelOptions(compute_dtype=compute_dtype_for(args.precision))
    adapters = init_lora(torch.Generator().manual_seed(args.seed), module, rank=args.lora_rank,
                         text_only=args.text_only, device=device)
    n_lora = count_lora_params(adapters)
    n_total = sum(p.numel() for p in module.parameters())
    logging.info("LoRA params: %d (%.4f%% of %d)", n_lora, 100.0 * n_lora / n_total, n_total)

    resolution = cfg.vision.image_resolution
    loader = DataLoader(PairDataset(args.train_data), batch_size=args.batch_size * args.accum_freq,
                        decode_size=resolution, context_length=args.context_length,
                        shuffle=True, seed=args.seed, num_threads=args.num_threads)
    val_loader = None
    if args.val_data:
        val_loader = DataLoader(PairDataset(args.val_data), batch_size=args.batch_size,
                                decode_size=resolution, context_length=args.context_length,
                                shuffle=True, seed=args.seed, num_threads=args.num_threads)
    total_steps = loader.num_batches * args.epochs
    warmup_steps = max(1, int(total_steps * args.warmup_ratio))
    schedule = cosine_with_warmup(args.lr, warmup_steps, total_steps)
    state = create_lora_state(module, adapters, lr=args.lr, wd=args.wd, device=device)
    train_step, eval_step = make_lora_step(cfg, options, args.lora_alpha, args.label_smoothing,
                                           args.accum_freq, schedule)

    def on_device(batch):
        images = torch.from_numpy(batch.images).to(device)
        return (preprocess_images(None, images, resolution),
                torch.from_numpy(batch.texts).to(device))

    log_path = os.path.join(args.output_dir, "training_log.csv")
    with open(log_path, "w") as f:
        f.write("epoch,train_loss,val_loss,lr,is_best\n")
    best_val = float("inf")
    step = 0
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        # the losses add up on the device: one host read an epoch
        loss_sum, nb = None, 0
        for batch in loader:
            im, tx = on_device(batch)
            state, loss, _ = train_step(state, im, tx, step_seeds(args.seed, step)[0])
            loss_sum = loss if loss_sum is None else loss_sum + loss
            nb += 1
            step += 1
        train_loss = float(loss_sum) / nb if nb else float("nan")

        val_loss = float("nan")
        if val_loader is not None:
            vsum, vn = None, 0
            for batch in val_loader:
                v = eval_step(state, *on_device(batch))
                vsum = v if vsum is None else vsum + v
                vn += 1
            val_loss = float(vsum) / vn if vn else float("nan")

        is_best = val_loss < best_val if val_loader is not None else True
        if is_best:
            best_val = val_loss if val_loader is not None else train_loss
            save_lora(os.path.join(args.output_dir, "best_lora.npz"), state.adapters,
                      {"epoch": epoch, "val_loss": val_loss, "rank": args.lora_rank,
                       "alpha": args.lora_alpha})
        lr_now = float(schedule(step))
        with open(log_path, "a") as f:
            f.write(f"{epoch},{train_loss:.6f},{val_loss:.6f},{lr_now:.8f},{int(is_best)}\n")
        logging.info("epoch %d | train %.4f | val %.4f | lr %.2e | best=%s", epoch, train_loss,
                     val_loss, lr_now, is_best)

    save_lora(os.path.join(args.output_dir, "last_lora.npz"), state.adapters,
              {"epoch": args.epochs - 1, "rank": args.lora_rank, "alpha": args.lora_alpha})
    logging.info("done. best val loss %.4f; adapters in %s", best_val, args.output_dir)
    return state.adapters


if __name__ == "__main__":
    main()
