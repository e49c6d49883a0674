"""Training entry point (counterpart of ``nans_clip_tpu/training/main.py``):
one process a rank, each on its card (or the CPU with ``--platform cpu``),
the JAX CLI's flags (``training/params.py``) and its loop:

* ``--distributed``, or a launcher's rendezvous in the environment
  (torchrun's names or the JAX CLI's, ``parallel/distributed.py``), forms
  the process group of ``world`` ranks before anything else, with the
  backend of ``distributed.backend_for`` (logged): ``nccl`` where each rank
  has its own card, ``gloo`` on the CPU and where ranks share a card. The
  ranks are a ``data x tp x pipe`` grid, ``data = world / (--tp x --pp)``
  (``parallel/mesh.py``; ``--tp`` and ``--pp`` exclusive); ``--fsdp``
  stores the parameters and the Adam moments sharded over ``data``
  (``--fsdp-min-size``); ``--pp`` runs each transformer tower as a GPipe
  pipeline of that many stages, each storing its own layers, the local
  batch in ``--pp-microbatches`` microbatches (0: auto; the bubble is
  logged, as the JAX CLI logs it); one process without a launcher is the
  grid 1 x 1 x 1;
* ``--grad-checkpointing`` rematerialises each transformer layer in the
  backward (``ModelOptions.remat``);
* the pair dataset and loader (``data/``), images preprocessed and
  augmented on the device (``data/augment.py``), the train step of
  ``training/trainer.py``;
* the global batch is ``--batch-size`` x the data axis (the JAX rule,
  main.py:200-216); the loader of data rank ``d`` takes block ``d`` of
  each global batch (``layout="blocks"``; the ranks of a model group load
  the same rows), so a step's global batch, and the draws made for it, are
  those of one process at the same global batch, at any world size;
* checkpoints (``utils/checkpoint.py``) every ``--save-step-frequency``
  steps and at each epoch's end, auto-resume from ``epoch_latest`` or
  ``--resume TAG``, ``--reset-optimizer``, ``--reset-data-offset``, and
  the elastic ``epoch_samples`` offset, as the JAX CLI computes them;
* validation weighted by samples, over the global batch; SIGTERM/SIGINT
  finish the step, save ``preempt_step_N`` and return: after each step
  group the ranks agree on whether any of them was signalled (an all-reduce
  of a flag), so all stop at the same step and none waits in a collective
  its peers left; ``--dist-timeout`` bounds every collective, so a rank
  that raises fails the others within it;
* the log file, ``metrics.jsonl``, the profile and the checkpoint files
  come from rank 0 (every rank joins a checkpoint's gathers and its
  barrier, ``utils/checkpoint.py``);
* ``--steps-per-call K`` runs K single steps a group, the log, validation
  and save cadences rounded up to the group's end as in JAX (the
  trajectory equals K = 1);
* ``--profile-steps START:END`` writes a ``torch.profiler`` chrome trace to
  ``<logs>/<name>/profile``; the host's parts of a step are spans named
  ``cli.data_wait`` (the loader), ``cli.to_device``, ``cli.preprocess``,
  ``cli.train_step`` (the step's launches) and ``cli.metrics`` (the wait
  for the step's metrics on the host), recorded by ``utils/profiling.py::
  span`` with the step's own spans inside ``cli.train_step``
  (``train.step`` and its phases, ``training/trainer.py``; the towers'
  ``model.*``);
* ``--vision-model RN50`` trains the ModifiedResNet tower
  (``models/resnet.py``): its BatchNorm running statistics update each
  step and are saved and restored with the checkpoints; FLIP masking does
  nothing there (the JAX CLI's note is logged); cuDNN runs deterministic
  algorithms, so a resume stays bit-equal;
* every logged step and validation is also a JSON line of
  ``<logs>/<name>/metrics.jsonl`` (loss, accuracies, logit scale, data s:
  the time the step waited for the loader, batch s: the step's time until
  its metrics reached the host).

Each step draws its text dropout and augmentation from generators seeded by
``(--seed, global step)`` (``trainer.step_seeds``), so a resumed run draws what
an uninterrupted one draws; the JAX CLI restarts its key from ``--seed`` at
each launch. The epoch-end save after a ``--max-steps`` break records the
epoch as complete (``epoch_batch`` 0), as the JAX CLI does.

Example (one card):
  python -m nans_clip_tpu_torch.training.main \\
      --train-data DATADIR/train --val-data DATADIR/valid \\
      --vision-model ViT-B-16 --text-model RoBERTa-wwm-ext-base-chinese \\
      --batch-size 128 --max-epochs 3 --lr 5e-5 --warmup 100

Example (8 cards of one host, global batch 8 x 128; ``--fsdp`` and ``--tp 2``
or ``--pp 2`` optional):
  torchrun --nproc-per-node 8 -m nans_clip_tpu_torch.training.main --distributed \\
      --train-data DATADIR/train --batch-size 128 --fsdp
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import signal
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nans_clip_tpu_torch import configs
from nans_clip_tpu_torch.api import CLIPModel, model_from_config
from nans_clip_tpu_torch.data.augment import preprocess_images
from nans_clip_tpu_torch.data.dataset import DataLoader, PairDataset
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions, compute_dtype_for
from nans_clip_tpu_torch.parallel import distributed, mesh
from nans_clip_tpu_torch.parallel.pp import bubble_fraction, pick_microbatches
from nans_clip_tpu_torch.training.params import parse_args
from nans_clip_tpu_torch.training.trainer import (TrainConfig, create_train_state,
                                                  full_weights, make_eval_step,
                                                  make_train_step, platform_device,
                                                  shard_train_state, step_seeds)
from nans_clip_tpu_torch.utils import profiling
from nans_clip_tpu_torch.utils.checkpoint import (latest_exists, restore_checkpoint,
                                                  save_checkpoint)
from nans_clip_tpu_torch.utils.torch_interop import load_torch_state_dict, merge_pretrained

NO_OP_FLAGS = ("use_bn_sync", "use_flash_attention", "gather_with_grad", "skip_aggregate")


def setup_logging(log_dir: str, name: str, rank: int = 0) -> str:
    """Rank 0 logs INFO to a file and the stream; another rank only its
    warnings and errors, to the stream, marked with its rank."""
    ts = time.strftime("%Y-%m-%d-%H-%M-%S")
    log_path = os.path.join(log_dir, name, f"out_{ts}.log")
    if rank:
        logging.basicConfig(level=logging.WARNING, handlers=[logging.StreamHandler()],
                            format=f"%(asctime)s | rank {rank} | %(levelname)s | %(message)s",
                            force=True)
        return log_path
    os.makedirs(os.path.join(log_dir, name), exist_ok=True)
    logging.basicConfig(level=logging.INFO,
                        handlers=[logging.FileHandler(log_path), logging.StreamHandler()],
                        format="%(asctime)s | %(levelname)s | %(message)s", force=True)
    return log_path


def refuse_unported(args) -> None:
    """Flag pairs the JAX CLI refuses too: a ``ValueError``, never a silent
    ignore."""
    if args.tp > 1 and args.pp > 1:
        raise ValueError("--tp and --pp are exclusive")


def build_model(args) -> Tuple[configs.CLIPConfig, torch.nn.Module, ModelOptions]:
    """(cfg, fp32 module on the CPU, train options): random init from a
    generator seeded by ``--seed``, then the pretrained towers of
    ``--clip-weight-path`` / ``--bert-weight-path`` when given."""
    cfg = (configs.tiny_config() if args.tiny_model
           else configs.load_config(f"{args.vision_model}@{args.text_model}"))
    options = ModelOptions(attn_impl=args.attn_impl,
                           compute_dtype=compute_dtype_for(args.precision),
                           deterministic=False, remat=args.grad_checkpointing)
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(args.seed))
    if args.clip_weight_path or args.bert_weight_path:
        clip_sd = load_torch_state_dict(args.clip_weight_path) if args.clip_weight_path \
            else None
        bert_sd = load_torch_state_dict(args.bert_weight_path) if args.bert_weight_path \
            else None
        merge_pretrained(module, clip_sd, bert_sd)
        logging.info("loaded pretrained weights (clip=%s, bert=%s)",
                     args.clip_weight_path, args.bert_weight_path)
    return cfg, module, options


# The reference's published ModelScope teachers (training/main.py:253-259):
# the two CN-CLIP ones map to their architecture; TEAM and RLEG are other
# architectures and are refused.
MODELSCOPE_TEACHERS = {
    "damo/multi-modal_clip-vit-huge-patch14_zh": "ViT-H-14@RoBERTa-wwm-ext-large-chinese",
    "damo/multi-modal_clip-vit-large-patch14_zh": "ViT-L-14@RoBERTa-wwm-ext-base-chinese",
}
OUT_OF_FAMILY_TEACHERS = {
    "damo/multi-modal_team-vit-large-patch14_multi-modal-similarity",
    "damo/multi-modal_rleg-vit-large-patch14",
}


def resolve_teacher_config(name: str) -> configs.CLIPConfig:
    """Registry config of a teacher name: a ``Vision@Text`` struct, or one
    of the CN-CLIP ModelScope ids; TEAM and RLEG raise."""
    if name in OUT_OF_FAMILY_TEACHERS:
        raise NotImplementedError(
            f"teacher {name!r} is not a CN-CLIP architecture (TEAM/RLEG remap a non-CLIP "
            "image encoder, reference training/main.py:253-259); use damo/multi-modal_clip-"
            "vit-{huge,large}-patch14_zh or any registry struct name")
    return configs.load_config(MODELSCOPE_TEACHERS.get(name, name))


def build_teacher(args, device) -> Optional[CLIPModel]:
    """The frozen distillation teacher (``--distillation``): random init
    from seed 0, or ``--teacher-weight-path``'s ``.pt``."""
    if not args.distillation:
        return None
    if not args.teacher_model_name:
        raise ValueError("--distillation needs --teacher-model-name")
    t_cfg = resolve_teacher_config(args.teacher_model_name)
    options = ModelOptions(attn_impl=args.attn_impl,
                           compute_dtype=compute_dtype_for(args.precision))
    return model_from_config(t_cfg, args.teacher_weight_path, options, seed=0, device=device)


def _waited(loader):
    """The loader's batches, each wait for one a ``cli.data_wait`` span."""
    batches = iter(loader)
    try:
        while True:
            with profiling.span("cli.data_wait"):
                batch = next(batches, None)
            if batch is None:
                return
            yield batch
    finally:
        batches.close()


def _metrics_line(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def start_ranks(args):
    """(this process's ``distributed.Rank`` or None, its device): the
    process group of a launch with ``--distributed`` or a launcher's
    rendezvous, else one process on ``--platform``'s device."""
    if args.distributed or distributed.launched():
        rank = distributed.init_distributed(args.platform, args.dist_timeout)
        return rank, rank.device
    for flag, n in (("tp", args.tp), ("pp", args.pp)):
        if n > 1:
            raise ValueError(f"--{flag} {n} needs a grid of data x {n} ranks: launch a "
                             f"multiple of {n} processes with --distributed")
    return None, platform_device(args.platform)


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    ranks, device = start_ranks(args)
    try:
        return _main(args, ranks, device)
    finally:
        if ranks is not None and dist.is_initialized():
            dist.destroy_process_group()


def _main(args, ranks, device):
    rank = ranks.rank if ranks is not None else 0
    lead = rank == 0
    log_path = setup_logging(args.logs, args.name, rank)
    for flag in NO_OP_FLAGS:
        if getattr(args, flag):
            logging.warning("--%s is a no-op here", flag.replace("_", "-"))
    logging.info("device: %s", torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu")
    grid = mesh.check_grid(args.tp, ranks.world // (args.tp * args.pp), args.pp) \
        if ranks is not None else None
    data = grid.data if grid is not None else 1
    data_index = grid.data_index if grid is not None else 0
    if ranks is not None:
        logging.info("ranks: %d (data %d x tp %d x pp %d), backend %s, fsdp %s", ranks.world,
                     data, args.tp, args.pp, ranks.backend, args.fsdp)
    if args.pp > 1:
        # the JAX CLI's line (main.py:173-183); the local batch of a stage is
        # --batch-size, a rank's rows of each microbatch of the step
        m = args.pp_microbatches or pick_microbatches(args.batch_size, args.pp)
        logging.info("pipeline: pp=%d microbatches=%d (%d samples each) GPipe bubble=%.1f%% "
                     "- raise --pp-microbatches to shrink it if the per-microbatch kernels "
                     "stay row-filled", args.pp, m, args.batch_size // m,
                     100 * bubble_fraction(args.batch_size, args.pp, m))

    cfg, module, options = build_model(args)
    options = dataclasses.replace(options, tp=args.tp, data=data, pp=args.pp,
                                  pp_microbatches=args.pp_microbatches)
    resolution = cfg.vision.image_resolution
    run_dir = os.path.join(args.logs, args.name)
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    if lead:
        with open(os.path.join(run_dir, f"params_{time.strftime('%Y%m%d%H%M%S')}.txt"),
                  "w") as f:
            for k in sorted(vars(args)):
                f.write(f"{k}: {getattr(args, k)}\n")
    if args.mask_ratio > 0 and cfg.is_resnet:
        logging.info("Note: mask_ratio > 0 (FLIP) only functions for ViT towers.")
    if cfg.is_resnet:
        # a resumed run equals an uninterrupted one bit for bit only if
        # cuDNN's convolution backward adds in a fixed order
        torch.backends.cudnn.deterministic = True

    # data ------------------------------------------------------------------
    if not args.train_data:
        raise ValueError("--train-data is required")
    global_micro = args.batch_size * data
    shard = dict(process_index=data_index, process_count=data, layout="blocks")
    train_loader = DataLoader(
        PairDataset(args.train_data), batch_size=args.batch_size, decode_size=resolution,
        context_length=args.context_length, shuffle=True, seed=args.seed,
        num_threads=args.num_workers, exact_decode=args.exact_decode, **shard)
    val_loader = None
    if args.val_data:
        val_loader = DataLoader(
            PairDataset(args.val_data), batch_size=args.valid_batch_size,
            decode_size=resolution, context_length=args.context_length, shuffle=True,
            seed=args.seed, num_threads=args.valid_num_workers, exact_decode=args.exact_decode,
            **shard)
    # this rank's rows of a step's global batch, for the augmentation draws
    rows = None if data == 1 else (
        global_micro * args.accum_freq,
        distributed.rank_row_index(data_index, data, args.accum_freq, args.batch_size))

    num_batches = train_loader.num_batches
    steps_per_epoch = num_batches // args.accum_freq
    max_steps_explicit = args.max_steps is not None
    if max_steps_explicit:
        args.max_epochs = math.ceil(args.max_steps * args.accum_freq / num_batches)
    else:
        args.max_steps = steps_per_epoch * args.max_epochs
    logging.info("train: %d pairs, %d batches/epoch, %d steps total",
                 train_loader.num_samples, num_batches, args.max_steps)

    tcfg = TrainConfig(
        lr=args.lr, beta1=args.beta1, beta2=args.beta2, eps=args.eps, wd=args.wd,
        warmup=args.warmup, max_steps=args.max_steps, mask_ratio=args.mask_ratio,
        accum_freq=args.accum_freq, freeze_vision=args.freeze_vision,
        label_smoothing=args.label_smoothing, distillation=args.distillation,
        kd_loss_weight=args.kd_loss_weight, grad_norm_clip=args.grad_norm_clip,
        skip_scheduler=args.skip_scheduler,
        adam_state_dtype=(None if args.adam_state_dtype in (None, "float32")
                          else args.adam_state_dtype))
    teacher = build_teacher(args, device)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    state = create_train_state(module, tcfg, device=device)
    del module

    # auto-resume (reference main.py:201-237)
    start_epoch, start_step, start_off = 0, 0, None
    resume_tag = args.resume or ("epoch_latest" if latest_exists(ckpt_dir) else None)
    if resume_tag:
        state, meta = restore_checkpoint(ckpt_dir, resume_tag, state,
                                         reset_optimizer=args.reset_optimizer)
        if meta:
            # epoch and step come back only with the data offset
            # (reference main.py:223-225)
            if not args.reset_data_offset:
                start_epoch = meta.get("epoch", 0)
                start_step = meta.get("step", state.step)
                start_off = meta.get("epoch_batch")
                saved_samples = meta.get("epoch_samples")
                if saved_samples is not None:
                    # the sample offset is topology-free: steps at this run's batch
                    start_off = saved_samples // (global_micro * args.accum_freq)
                if not max_steps_explicit:
                    # the epoch budget counts the steps taken at their own rate
                    off = (start_off if start_off is not None
                           else max(0, start_step - start_epoch * steps_per_epoch))
                    args.max_steps = max(start_step, (
                        start_step - off
                        + max(0, args.max_epochs - start_epoch) * steps_per_epoch))
            logging.info("resumed from %s (epoch %d, step %d)", resume_tag, start_epoch,
                         start_step)

    state = shard_train_state(state, tcfg, options, args.fsdp, args.fsdp_min_size)
    train_step = make_train_step(cfg, tcfg, options, teacher=teacher)
    eval_step = make_eval_step(cfg, options)
    spc = max(1, args.steps_per_call)

    def to_device(images, texts):
        return torch.from_numpy(images).to(device), torch.from_numpy(texts).to(device)

    def run_validation(epoch):
        if val_loader is None:
            return
        tot = {"loss": 0.0, "i2t_acc": 0.0, "t2i_acc": 0.0}
        n = 0
        with full_weights(state):
            for batch in val_loader:
                im, tx = to_device(batch.images, batch.texts)
                m = eval_step(state.module, preprocess_images(None, im, resolution), tx)
                gb = batch.images.shape[0] * data   # the global batch's metrics
                for k in tot:
                    tot[k] += float(m[k]) * gb
                n += gb
        if n != val_loader.num_samples:
            raise AssertionError((n, val_loader.num_samples))
        logging.info("VALID epoch %d | loss %.4f | i2t %.2f%% | t2i %.2f%% | %d samples",
                     epoch, tot["loss"] / n, 100 * tot["i2t_acc"] / n,
                     100 * tot["t2i_acc"] / n, n)
        if lead:
            _metrics_line(metrics_path, {"kind": "valid", "epoch": epoch, "step": step,
                                         "samples": n, **{k: v / n for k, v in tot.items()}})

    # Preemption: on SIGTERM/SIGINT finish the step, checkpoint, return.
    preempted = {"flag": False}

    def _handle(signum, frame):
        logging.warning("signal %s received - checkpointing and exiting", signum)
        preempted["flag"] = True

    previous = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, _handle)

    def stop_agreed() -> bool:
        """Whether any rank was signalled: the same answer on every rank."""
        if ranks is None:
            return preempted["flag"]
        flag = torch.tensor([float(preempted["flag"])], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    profile_range = None
    profiler = None
    profile_dir = os.path.join(run_dir, "profile")
    if args.profile_steps and lead:
        lo, hi = args.profile_steps.split(":")
        profile_range = (int(lo), int(hi))

    def stop_profiler():
        nonlocal profiler
        if profiler is not None:
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            logging.info("profiler trace written to %s", profile_dir)
            profiling.clear()
            profiler = None

    step = start_step

    def crossed(interval, n):
        # did (step - n, step] cross a multiple of interval?
        return bool(interval and interval > 0 and (step // interval) > ((step - n) // interval))

    def step_meta(epoch, epoch_steps):
        return {"epoch": epoch, "step": step, "name": args.name, "epoch_batch": epoch_steps,
                "epoch_samples": epoch_steps * args.accum_freq * global_micro}

    def run_group(groups, i, epoch, epoch_steps, data_time):
        """The group's optimizer steps, then the bookkeeping at its end.
        Returns (epoch_steps, stop reason or None)."""
        nonlocal state, step, profile_range, profiler
        n = len(groups)
        t0 = time.time()
        if profile_range and profiler is None and step <= profile_range[0] < step + n:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiling.reserve()
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        for im, tx, dropout_seed in groups:
            with profiling.span("cli.train_step"):
                state, metrics = train_step(state, im, tx, dropout_seed)
        step += n
        epoch_steps += n
        if profile_range and profiler is not None and step >= profile_range[1]:
            stop_profiler()
            profile_range = None

        if crossed(args.log_interval, n):
            with profiling.span("cli.metrics"):
                metrics = {k: float(v) for k, v in metrics.items()}   # the last step's
            batch_time = (time.time() - t0) / n
            logging.info(
                "Epoch %d [%d/%d] | loss %.6f | i2t %.2f%% | t2i %.2f%% | data %.3fs | "
                "batch %.3fs | logit_scale %.3f | gbs %d", epoch, i + 1, num_batches,
                metrics["loss"], 100 * metrics["i2t_acc"], 100 * metrics["t2i_acc"],
                data_time, batch_time, metrics["logit_scale"], global_micro * args.accum_freq)
            if lead:
                _metrics_line(metrics_path, {"kind": "train", "epoch": epoch, "step": step,
                                             **metrics, "data_s": data_time,
                                             "batch_s": batch_time})
        if crossed(args.valid_step_interval, n):
            run_validation(epoch)
        if crossed(args.save_step_frequency, n):
            save_checkpoint(ckpt_dir, f"step_{step}", state, step_meta(epoch, epoch_steps),
                            args.save_torch_format)
        if stop_agreed():
            stop_profiler()
            save_checkpoint(ckpt_dir, f"preempt_step_{step}", state,
                            step_meta(epoch, epoch_steps), args.save_torch_format)
            logging.info("preemption checkpoint saved at step %d", step)
            return epoch_steps, "preempt"
        if step >= args.max_steps:
            return epoch_steps, "max_steps"
        return epoch_steps, None

    try:
        for epoch in range(start_epoch, args.max_epochs):
            # mid-epoch resume: skip the batches already trained
            if epoch == start_epoch and start_off is not None:
                resume_off = start_off
            elif epoch == start_epoch:
                resume_off = step - epoch * steps_per_epoch
            else:
                resume_off = 0
            train_loader.set_epoch(epoch, start_batch=max(0, resume_off) * args.accum_freq)
            epoch_steps = max(0, resume_off)
            micro_buf, group_buf = [], []
            stop = None
            t_data = time.time()
            data_time = 0.0
            for i, batch in enumerate(_waited(train_loader)):
                data_time += time.time() - t_data
                micro_buf.append(batch)
                if len(micro_buf) < args.accum_freq:
                    t_data = time.time()
                    continue
                images = np.concatenate([b.images for b in micro_buf])
                texts = np.concatenate([b.texts for b in micro_buf])
                micro_buf = []
                with profiling.span("cli.to_device"):
                    im, tx = to_device(images, texts)
                dropout_seed, aug_seed = step_seeds(args.seed, step + len(group_buf))
                with profiling.span("cli.preprocess"):
                    im = preprocess_images(torch.Generator().manual_seed(aug_seed), im,
                                           resolution, augment=args.use_augment, rows=rows)
                group_buf.append((im, tx, dropout_seed))
                # a full group, or what remains of the step budget
                if len(group_buf) < min(spc, args.max_steps - step):
                    t_data = time.time()
                    continue
                groups, group_buf = group_buf, []
                epoch_steps, stop = run_group(groups, i, epoch, epoch_steps, data_time)
                data_time = 0.0
                if stop == "preempt":
                    return state
                if stop == "max_steps":
                    break
                t_data = time.time()
            if group_buf and stop is None:
                # an epoch tail shorter than a group
                epoch_steps, stop = run_group(group_buf, num_batches - 1, epoch, epoch_steps,
                                              data_time)
                group_buf = []
                if stop == "preempt":
                    return state

            if (epoch + 1) % args.valid_epoch_interval == 0:
                run_validation(epoch)
            meta = {"epoch": epoch + 1, "step": step, "name": args.name, "epoch_batch": 0,
                    "epoch_samples": 0}
            tag = (f"epoch{epoch + 1}" if (epoch + 1) % args.save_epoch_frequency == 0
                   else "epoch_latest")
            save_checkpoint(ckpt_dir, tag, state, meta, args.save_torch_format)
            if step >= args.max_steps:
                break
    finally:
        stop_profiler()
        for sig, handler in previous.items():
            signal.signal(sig, handler)

    logging.info("done: %d steps. log: %s", step, log_path)
    return state


if __name__ == "__main__":
    main()
