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
  autograd Functions (kernels #14, #16, #18, or as
  ``ModelOptions.bwd_impl`` routes), the optimizer update;
* gradient accumulation with the full global negatives
  (``accum_freq > 1``, :func:`accumulate_backward`): the reference's
  two-pass protocol (training/train.py:206-253), whose gradient the JAX
  scan with ``jax.checkpoint`` equals (trainer.py:7-13, :249-291). Pass 1
  encodes each microbatch without a graph; the global loss on the
  concatenated features gives their gradients and ``logit_scale``'s; pass
  2 encodes each microbatch again with a graph and backpropagates its
  slice. Each microbatch's dropout seed and FLIP tokens are drawn once and
  used in both passes, as ``fold_in(rng, j)`` gives the JAX scan one stream
  a microbatch;
* FLIP masking (``mask_ratio > 0``; ``models/vit.py``), drawn from the
  step's generator; a ResNet image tower takes none, as in JAX;
* a ResNet image tower's BatchNorm (``models/resnet.py``): a train step
  normalises with batch statistics and folds them into the running ones
  once a microbatch, in microbatch order (the JAX scan's carry,
  trainer.py:233-290): in the two-pass protocol pass 1 updates them and
  pass 2 normalises with the same batch statistics and updates nothing.
  ``freeze_vision`` runs it on the running statistics and leaves them
  bit-equal (:229-233); the eval step and a teacher read the running
  statistics;
* distillation: a frozen teacher :class:`~nans_clip_tpu_torch.api.CLIPModel`
  encodes the images without a graph, microbatched like the student, and
  ``kd_loss_weight * kd_cosine_loss`` joins the loss (:328-347);
* ``adam_state_dtype``: both Adam moments stored in that dtype, their EMAs
  computed in fp32 (:class:`CompactAdamW`, ``_scale_by_adam_compact``
  :134-168 in the chain order of :178-182);
* tensor parallelism (``ModelOptions.tp`` > 1): each rank of its model
  group holds the whole module and the same rows, runs its heads and MLP
  columns (``parallel/tp.py``), and after the backward the gradients that
  are per-rank shares are summed over the group (``reduce_partial_grads``
  of ``CLIP.tp_partial_parameters``);
* data parallelism (``ModelOptions.data`` > 1, the other axis of the
  ``data x tp`` grid, ``parallel/mesh.py``): a rank's ``images`` and
  ``texts`` are its rows of the global batch (``parallel/distributed.py::
  rank_rows``: block ``d`` of every global microbatch). Microbatch ``j`` is
  JAX's, global rows ``[j * micro, (j + 1) * micro)`` split over ``data``
  (trainer.py:250-265). Every rank draws what one process draws for the
  global microbatch, from the same generator, and keeps its rows: the FLIP
  tokens, and the text dropout's masks through the sample offset
  ``sample0 = d * micro / data`` (``ops/dropout.py``, the kernels take it).
  The features of every microbatch are gathered over the data group for
  the global-batch loss (``parallel/loss.py::gather_features``; in the
  two-pass accumulation pass 1's features, and pass 2 backpropagates the
  rank's rows of their gradient), a ResNet tower's BatchNorm takes the
  global microbatch's statistics (``models/resnet.py``), and after the
  backward the gradients are averaged over the data group in flat buckets
  (``parallel/fsdp.py::all_reduce_mean``; DDP's per-parameter hooks would
  fire in both passes of an accumulated step). Clipping and AdamW then run
  as on one card, so every rank's parameters stay equal;
* FSDP (:func:`shard_train_state`, the JAX ``--fsdp``): the parameters
  and the optimizer's moments are stored as the rank's shards of the JAX
  leaves (``parallel/fsdp.py``); a step gathers the full weights before its
  forwards, reduce-scatters the gradients into the shards, clips by the
  norm over the shards and updates the shards. :func:`full_weights`
  gathers them for a caller (validation, checkpoints);
* pipeline parallelism (``ModelOptions.pp`` > 1, the pipe axis of the
  ``data x tp x pipe`` grid): :func:`shard_train_state` keeps a stage's
  layers (``parallel/pp.py::localize``: the other stages' layers on the
  meta device) and builds the optimizer over what the stage stores, its
  state cut from one process's (``pp.stage_optimizer_state``; under
  ``--fsdp`` the stage's leaves are then sharded over its data group). The
  stages of a pipe group take the same rows and draws; each tower runs its
  layers as the GPipe loop (``parallel/pp.py``), every stage computes the
  same loss, and the stage's gradients are reduced over its data group as
  above. Clipping takes the global norm: the layers' squares summed over
  the pipe group, the replicated rest counted once;
* rematerialisation (``ModelOptions.remat``): each transformer layer's
  activations recomputed in the backward (``models/common.py::
  remat_layer``).

Both CLIs (``training/main.py``, ``training/train_lora.py``) also take
from here the device ``--platform`` names (:func:`platform_device`) and
each step's seeds (:func:`step_seeds`).

``torch.optim.AdamW`` computes optax's ``adamw``: decoupled decay
(``p -= lr * wd * p``), bias-corrected moments and ``eps`` added outside
the square root (``mu_hat / (sqrt(nu_hat) + eps)``); the learning rate of
the optimizer's step t (counted from 0) is ``schedule(t)``, as optax's
count: t is kept in the optimizer's first parameter group (``"count"``),
so it is saved and restored with the optimizer, and a fresh optimizer
starts it at 0 (a resume with ``--reset-optimizer`` re-warms, as in JAX).
The
parameters are fp32 masters; each forward casts them to the compute dtype
(``ModelOptions.cast``). The state is updated in place (torch's optimizer
owns its moments) and returned, so a caller writes
``state, metrics = step(state, images, texts, generator)`` as with JAX.

Under a ``torch.profiler`` session a step records the spans of
``utils/profiling.py``: ``train.step`` (its ``id`` the step number), and
inside it ``train.prepare`` (device copies, draws, the schedule,
``zero_grad``, FSDP's gather), ``train.forward`` (the towers and the loss;
a teacher's features too), ``train.backward``, ``train.grad_sync`` (only
with a TP, data or pipe group or FSDP) and ``train.optimizer`` (clipping,
``opt.step``, the clamp); the towers add ``model.*`` spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from nans_clip_tpu_torch.api import _device
from nans_clip_tpu_torch.configs import CLIPConfig
from nans_clip_tpu_torch.models.clip import normalize
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.models.vit import draw_ids_keep
from nans_clip_tpu_torch.parallel import fsdp as fsdp_lib
from nans_clip_tpu_torch.parallel import pp as pp_lib
from nans_clip_tpu_torch.parallel.loss import clip_loss, gather_features, kd_cosine_loss
from nans_clip_tpu_torch.parallel.mesh import check_grid
from nans_clip_tpu_torch.parallel.tp import reduce_partial_grads
from nans_clip_tpu_torch.utils.profiling import span

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
    """``fsdp``: the rank's shards where the state is sharded
    (:func:`shard_train_state`), else None; ``pipe``: the rank's grid where
    it stores one pipeline stage, else None."""

    step: int
    module: nn.Module
    optimizer: torch.optim.Optimizer
    fsdp: Optional[fsdp_lib.Sharded] = None
    pipe: Optional[object] = None


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


class CompactAdamW(torch.optim.Optimizer):
    """AdamW with both moments stored in ``state_dtype`` (JAX
    ``_scale_by_adam_compact`` followed by ``add_decayed_weights`` and the
    learning rate): each step reads the moments up to fp32, forms the EMAs
    and the bias-corrected update ``m_hat / (sqrt(v_hat) + eps)`` in fp32,
    applies ``p -= lr * (update + weight_decay * p)`` and stores the moments
    rounded back. Halves (bf16) the optimizer's memory. The parameters are
    the fp32 masters. Tensors go through each operation together
    (``torch._foreach_*``), ``CHUNK`` elements' worth at a time, so that the
    two fp32 temporaries a chunk stay far below what the moments save."""

    CHUNK = 1 << 24

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, state_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.state_dtype = state_dtype

    def load_state_dict(self, state_dict):
        """The base class casts floating state to the parameters' dtype:
        put the moments back in ``state_dtype`` (exact, they were saved in
        it)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for key in ("mu", "nu"):
                if key in st:
                    st[key] = st[key].to(self.state_dtype)

    def _chunks(self, params):
        chunk, size = [], 0
        for p in params:
            if chunk and size + p.numel() > self.CHUNK:
                yield chunk
                chunk, size = [], 0
            chunk.append(p)
            size += p.numel()
        if chunk:
            yield chunk

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CompactAdamW.step takes no closure")
        for group in self.param_groups:
            live = [p for p in group["params"] if p.grad is not None]
            if any(p.dtype != torch.float32 for p in live):
                raise TypeError("CompactAdamW updates fp32 parameters")
            for params in self._chunks(live):
                self._update(group, params)

    def _update(self, group, params):
        b1, b2 = group["betas"]
        for p in params:
            st = self.state[p]
            if not st:
                st["step"] = 0
                st["mu"] = torch.zeros_like(p, dtype=self.state_dtype)
                st["nu"] = torch.zeros_like(p, dtype=self.state_dtype)
            st["step"] += 1
        states = [self.state[p] for p in params]
        mus, nus = [st["mu"] for st in states], [st["nu"] for st in states]
        grads = [p.grad.float() for p in params]
        mu, nu = ([torch.empty_like(p) for p in params] for _ in range(2))
        torch._foreach_copy_(mu, mus)
        torch._foreach_copy_(nu, nus)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        torch._foreach_copy_(mus, mu)
        torch._foreach_copy_(nus, nu)
        # in place from here: nu becomes the denominator, mu the update
        torch._foreach_div_(nu, [1 - b2 ** st["step"] for st in states])
        torch._foreach_sqrt_(nu)
        torch._foreach_add_(nu, group["eps"])
        torch._foreach_div_(mu, [1 - b1 ** st["step"] for st in states])
        torch._foreach_div_(mu, nu)
        if group["weight_decay"]:
            torch._foreach_add_(mu, params, alpha=group["weight_decay"])
        torch._foreach_add_(params, mu, alpha=-group["lr"])


def decay_groups(module: nn.Module) -> Tuple[List[str], List[str]]:
    """The names of the parameters that take gradients: (decayed, not
    decayed) by :func:`no_decay_mask`, in ``named_parameters()`` order, the
    optimizer's two groups."""
    mask = no_decay_mask(module)
    named = [n for n, p in module.named_parameters() if p.requires_grad]
    return [n for n in named if not mask[n]], [n for n in named if mask[n]]


def stored_groups(module: nn.Module) -> Tuple[List[str], List[str]]:
    """:func:`decay_groups` of the parameters this rank stores (a pipeline
    stage's: none on the meta device), the groups of its optimizer."""
    stored = pp_lib.stored(module)
    return tuple([n for n in names if n in stored] for names in decay_groups(module))


def make_optimizer(tcfg: TrainConfig, module: nn.Module,
                   sharded: Optional[fsdp_lib.Sharded] = None) -> torch.optim.Optimizer:
    """AdamW over the stored parameters that take gradients, in two groups:
    decayed and not (:func:`stored_groups`); :class:`CompactAdamW` where
    ``adam_state_dtype`` is set. With ``sharded``, over its shards in place
    of the sharded parameters."""
    params = dict(module.named_parameters())
    pick = (lambda names: [params[n] for n in names]) if sharded is None \
        else sharded.optimizer_params
    decayed, rest = stored_groups(module)
    groups = [{"params": pick(decayed), "weight_decay": tcfg.wd},
              {"params": pick(rest), "weight_decay": 0.0}]
    kw = dict(lr=tcfg.lr, betas=(tcfg.beta1, tcfg.beta2), eps=tcfg.eps)
    if tcfg.adam_state_dtype:
        return CompactAdamW(groups, state_dtype=getattr(torch, tcfg.adam_state_dtype), **kw)
    return torch.optim.AdamW(groups, **kw)


def create_train_state(module: nn.Module, tcfg: TrainConfig, device="cuda") -> TrainState:
    """Move the fp32 ``module`` to ``device`` (the card unless the caller
    names another; without a card that default raises) and build its
    optimizer. ``freeze_vision`` takes the vision tower out of the
    gradient and the update."""
    module = module.to(_device(device)).float().train()
    if tcfg.freeze_vision:
        module.visual.requires_grad_(False)
    return TrainState(step=0, module=module, optimizer=make_optimizer(tcfg, module))


def shard_train_state(state: TrainState, tcfg: TrainConfig, options: ModelOptions,
                      fsdp: bool = False, fsdp_min_size: Optional[int] = None) -> TrainState:
    """The state as this rank stores it: under ``options.pp`` > 1 its
    stage's layers and the replicated rest (module docstring); under
    ``fsdp`` its parameters and optimizer moments as this rank's shards over
    the data group (``parallel/fsdp.py``; JAX ``shard_train_state``). The
    optimizer's state (fresh, or restored from a one-rank checkpoint) is
    cut to them. ``state`` as it is at one rank, at ``pp`` 1 without
    ``fsdp`` or a data axis of 1, and when it is stored so already. Every
    rank calls it with equal parameters."""
    grid = check_grid(options.tp, options.data, options.pp)
    module = state.module
    fsdp_on = fsdp and grid is not None and grid.data_group is not None
    stored_so = state.fsdp is not None or state.pipe is not None
    if stored_so or not (options.pp > 1 or fsdp_on):
        return state
    full_sd, names = state.optimizer.state_dict(), decay_groups(module)
    if options.pp > 1:
        pp_lib.localize(module, options.pp, grid.stage)
    sharded = None
    if fsdp_on:
        sharded = fsdp_lib.Sharded(module, grid.data_group, fsdp_min_size, options.pp)
        opt = make_optimizer(tcfg, module, sharded)
        fsdp_lib.shard_optimizer_state(sharded, opt, full_sd, names)
    else:
        opt = make_optimizer(tcfg, module)
        opt.load_state_dict(pp_lib.stage_optimizer_state(full_sd, names, stored_groups(module)))
    return TrainState(step=state.step, module=module, optimizer=opt, fsdp=sharded,
                      pipe=grid if options.pp > 1 else None)


def train_state_shardings(state: TrainState, options: ModelOptions,
                          fsdp_min_size: Optional[int] = None) -> List[fsdp_lib.Leaf]:
    """The JAX leaves of the state's stored parameters, each with the
    dimension FSDP shards over the data axis of ``options`` (None:
    replicated); the moments follow their parameters (JAX
    ``train_state_shardings``)."""
    return fsdp_lib.jax_leaves(state.module, options.data, fsdp_min_size, options.pp)


@contextlib.contextmanager
def full_weights(state: TrainState):
    """The module's full weights for the duration where the state is
    sharded (gathered on entry, released on exit; collective over the data
    group), a no-op otherwise."""
    if state.fsdp is None:
        yield
        return
    state.fsdp.gather()
    try:
        yield
    finally:
        state.fsdp.release()


def _clip_by_global_norm(params, max_norm: float, norm_sq=None) -> None:
    """optax.clip_by_global_norm: scale every gradient by max / norm when the
    global norm reaches max. ``norm_sq``: the squared norm where the
    gradients of ``params`` are shards (FSDP)."""
    grads = [p.grad for p in params if p.grad is not None]
    if norm_sq is None:
        norm_sq = sum(g.float().square().sum() for g in grads)
    norm = torch.sqrt(norm_sq)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def _stage_norm_sq(module: nn.Module) -> torch.Tensor:
    """``[layers, rest]``: the squared norms of the gradients of this
    stage's transformer layers and of the replicated rest."""
    sq = torch.zeros(2, device=module.logit_scale.device)
    for name, p in module.named_parameters():
        if p.grad is not None:
            sq[0 if pp_lib.is_layer(name) else 1] += p.grad.float().square().sum()
    return sq


def draw_microbatches(n_micro: int, micro: int, seq_len: int, mask_ratio: float,
                      generator: Optional[torch.Generator],
                      dropout: bool) -> List[Tuple[Optional[int], Optional[torch.Tensor]]]:
    """What each microbatch of a step draws, once: ``(seed of its text
    dropout or None, its FLIP ids_keep or None)``. Both passes of an
    accumulated step encode microbatch j from the same pair."""
    if mask_ratio > 0 and generator is None:
        raise ValueError("mask_ratio > 0 requires a generator")
    draws = []
    for _ in range(n_micro):
        ids_keep = draw_ids_keep(micro, seq_len, mask_ratio, generator) if mask_ratio > 0 \
            else None
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                 device=generator.device)) if dropout else None
        draws.append((seed, ids_keep))
    return draws


def seeded(seed: Optional[int]) -> Optional[torch.Generator]:
    return None if seed is None else torch.Generator().manual_seed(seed)


def platform_device(platform: str) -> torch.device:
    """The device ``--platform`` names; the default, the card, raises
    without one. The training and eval CLIs take it."""
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CLIs run on the card by default; pass "
                           "--platform cpu to run on the CPU")
    return torch.device(platform)


def step_seeds(seed: int, step: int) -> Tuple[int, int]:
    """(text dropout seed, augmentation seed) of global step ``step``: a
    function of ``(seed, step)`` alone, so a resumed run draws as an
    uninterrupted one."""
    a, b = np.random.SeedSequence([seed, step]).generate_state(2)
    return int(a) & 0x7FFFFFFF, int(b) & 0x7FFFFFFF


def accumulate_backward(encode: Callable, images: torch.Tensor, texts: torch.Tensor,
                        accum: int, loss_fn: Callable):
    """Backpropagate ``loss_fn(image features, text features) -> (loss,
    metrics)`` of the whole batch into whatever ``encode(j, images_j,
    texts_j) -> (image features, text features)`` (unnormalised) and
    ``loss_fn`` depend on, ``accum`` microbatches at a time. ``accum`` <= 1
    is one forward and one backward. Otherwise the two-pass protocol: the
    features of every microbatch without a graph, one loss on their
    concatenation (full global negatives), then each microbatch encoded
    again with a graph and its slice of the feature gradients
    backpropagated; gradients add up in ``.grad``. ``encode`` must give
    microbatch j the same dropout and masking on both calls. Returns the
    detached loss and the metrics.

    The spans ``train.forward`` and ``train.backward`` split the work
    (``utils/profiling.py``): at ``accum`` <= 1 the forward and the loss,
    then ``loss.backward()``; otherwise the feature pass and the loss are
    the forward, and the loss's backward with the re-encoded passes the
    backward (those passes' forwards are counted there)."""
    if accum <= 1:
        with span("train.forward"):
            loss, metrics = loss_fn(*encode(0, images, texts))
        with span("train.backward"):
            loss.backward()
        return loss.detach(), metrics
    b = images.shape[0]
    micro = b // accum
    if micro * accum != b:
        raise ValueError(f"batch {b} not divisible by accum_freq {accum}")
    chunks = [(images[j * micro:(j + 1) * micro], texts[j * micro:(j + 1) * micro])
              for j in range(accum)]
    with span("train.forward"):
        with torch.no_grad():
            feats = [encode(j, *chunk) for j, chunk in enumerate(chunks)]
        img_f = torch.cat([f[0] for f in feats]).requires_grad_()
        txt_f = torch.cat([f[1] for f in feats]).requires_grad_()
        del feats
        loss, metrics = loss_fn(img_f, txt_f)
    with span("train.backward"):
        loss.backward()
        for j, chunk in enumerate(chunks):
            sl = slice(j * micro, (j + 1) * micro)
            pairs = [(f, g[sl]) for f, g in zip(encode(j, *chunk), (img_f.grad, txt_f.grad))
                     if f.requires_grad]
            if pairs:
                torch.autograd.backward([f for f, _ in pairs], [g for _, g in pairs])
    return loss.detach(), metrics


def teacher_features(teacher, images: torch.Tensor, accum: int) -> torch.Tensor:
    """The frozen teacher's image features without a graph, microbatched
    like the student (trainer.py:328-344): of this rank's rows, which the
    loss gathers with the student's. ``teacher``: a ``CLIPModel``."""
    with torch.no_grad():
        chunks = images.chunk(max(accum, 1)) if accum > 1 else (images,)
        return torch.cat([teacher.module.encode_image(c, teacher.options) for c in chunks])


def make_train_step(cfg: CLIPConfig, tcfg: TrainConfig, options: ModelOptions,
                    teacher=None) -> Callable:
    """Build the train step ``step(state, images, texts, generator=None) ->
    (state, {"loss", "i2t_acc", "t2i_acc", "logit_scale"[, "kd_loss"]})``.
    ``images``: [B, R, R, 3] NHWC, ``texts``: [B, S] ids (tensors or arrays,
    moved to the module's device): the batch, or under ``options.data`` > 1
    this rank's rows of the global batch (module docstring); ``generator``:
    a ``torch.Generator`` (or an int seed, equal on every rank) drawing the
    text tower's dropout and the FLIP tokens, None for none. ``teacher``: a
    frozen ``CLIPModel`` for ``tcfg.distillation`` (the JAX
    ``(teacher_cfg, teacher_params)``). The metrics are those of the global
    batch, 0-d tensors on the device, equal on every rank; ``logit_scale``
    is its value before the update."""
    del cfg  # the module carries its configuration
    grid = check_grid(options.tp, options.data, options.pp)
    tp_group = grid.model_group if grid is not None else None
    data_group = grid.data_group if grid is not None else None
    pipe_group = grid.pipe_group if grid is not None else None
    data_index = grid.data_index if grid is not None else 0
    train_options = dataclasses.replace(options, deterministic=False)
    schedule = cosine_with_warmup(tcfg.lr, tcfg.warmup, tcfg.max_steps, tcfg.skip_scheduler)
    accum = max(tcfg.accum_freq, 1)
    # a frozen vision tower keeps its running statistics (JAX trainer.py:229-233)
    bn_train = not tcfg.freeze_vision

    def step(state: TrainState, images, texts,
             generator: Union[torch.Generator, int, None] = None):
        with span("train.step", state.step):
            return run(state, images, texts, generator)

    def run(state: TrainState, images, texts, generator):
        module, opt, sharded = state.module, state.optimizer, state.fsdp
        with span("train.prepare"):
            resnet = module.cfg.is_resnet
            dev = module.logit_scale.device
            if isinstance(generator, int):
                generator = torch.Generator().manual_seed(generator)
            images = torch.as_tensor(images, device=dev)
            texts = torch.as_tensor(texts, device=dev).long()
            b = images.shape[0]
            if b % accum:
                raise ValueError(f"batch {b} not divisible by accum_freq {accum}")
            micro = b // accum   # this rank's rows of a microbatch
            rows = slice(data_index * micro, (data_index + 1) * micro)
            # what one process draws for the global microbatch; this rank
            # keeps its rows. No dropout from a deterministic forward, as in
            # JAX; FLIP still draws (a ViT tower only)
            draws = [(seed, None if keep is None else keep[rows]) for seed, keep in
                     draw_microbatches(accum, micro * options.data,
                                       0 if resnet else module.cfg.vision.seq_len,
                                       0.0 if resnet else tcfg.mask_ratio, generator,
                                       generator is not None and not options.deterministic)]
            count = opt.param_groups[0].get("count", 0)
            for group in opt.param_groups:
                group["lr"] = schedule(count)
            opt.zero_grad(set_to_none=True)
            if sharded is not None:
                sharded.gather()
            logit_scale = module.logit_scale.detach().clone()
        t_feats = None
        if tcfg.distillation and teacher is not None:
            with span("train.forward"):
                t_feats = gather_features(teacher_features(teacher, images, accum), data_group,
                                          accum)

        updated = set()   # the microbatches whose BatchNorm statistics are folded in

        def encode(j, im, tx):
            seed, ids_keep = draws[j]
            bn_update = j not in updated
            updated.add(j)
            return (module.encode_image(im, train_options, ids_keep=ids_keep, bn_train=bn_train,
                                        bn_update=bn_update),
                    module.encode_text(tx, train_options, seeded(seed), rows.start))

        def loss_fn(img_f, txt_f):
            img_f = gather_features(img_f, data_group, accum)
            txt_f = gather_features(txt_f, data_group, accum)
            loss, metrics = clip_loss(normalize(img_f), normalize(txt_f),
                                      module.logit_scale.float().exp(), tcfg.label_smoothing)
            if t_feats is not None:
                kd = kd_cosine_loss(t_feats, img_f)
                loss = loss + tcfg.kd_loss_weight * kd
                metrics = {**metrics, "kd_loss": kd.detach()}
            return loss, metrics

        loss, metrics = accumulate_backward(encode, images, texts, accum, loss_fn)
        norm_sq = None
        if grid is not None or sharded is not None:
            with span("train.grad_sync"):
                norm_sq = sync_grads(module, sharded)
        with span("train.optimizer"):
            if tcfg.grad_norm_clip:
                _clip_by_global_norm([p for g in opt.param_groups for p in g["params"]],
                                     tcfg.grad_norm_clip, norm_sq)
            opt.step()
            if sharded is not None:
                sharded.release()
            opt.param_groups[0]["count"] = count + 1
            with torch.no_grad():
                module.logit_scale.clamp_(0.0, LOGIT_SCALE_MAX)
        state.step += 1
        return state, {"loss": loss, **metrics, "logit_scale": logit_scale}

    def sync_grads(module, sharded):
        """Sum the TP partials, then average (reduce-scatter under FSDP) over
        the data group; returns the squared global gradient norm where
        clipping needs the ranks' parts (FSDP, pipe), else None."""
        if tp_group is not None:
            reduce_partial_grads(module.tp_partial_parameters(), tp_group)
        norm_sq = None
        if sharded is not None:
            sharded.reduce_grads()
            if tcfg.grad_norm_clip:
                norm_sq = sharded.grad_norm_sq()
        elif data_group is not None:
            fsdp_lib.all_reduce_mean(list(module.parameters()), data_group)
        if tcfg.grad_norm_clip and pipe_group is not None:
            norm_sq = _stage_norm_sq(module) if norm_sq is None else norm_sq
            layers = norm_sq[0].clone()
            torch.distributed.all_reduce(layers, group=pipe_group)
            norm_sq = layers + norm_sq[1]
        elif norm_sq is not None:
            norm_sq = norm_sq.sum()
        return norm_sq

    return step


def make_eval_step(cfg: CLIPConfig, options: ModelOptions) -> Callable:
    """In-batch validation loss and accuracies: ``eval_step(module, images,
    texts) -> {"loss", "i2t_acc", "t2i_acc"}``, deterministic, no gradient;
    under ``options.data`` > 1 over the global batch (each rank's rows
    gathered, the metrics equal on every rank). A sharded state's module
    needs :func:`full_weights` around it."""
    del cfg
    eval_options = dataclasses.replace(options, deterministic=True)
    grid = check_grid(options.tp, options.data, options.pp)
    data_group = grid.data_group if grid is not None else None

    @torch.no_grad()
    def eval_step(module: nn.Module, images, texts):
        dev = module.logit_scale.device
        img = module.encode_image(torch.as_tensor(images, device=dev), eval_options)
        txt = module.encode_text(torch.as_tensor(texts, device=dev).long(), eval_options)
        img, txt = gather_features(img, data_group), gather_features(txt, data_group)
        loss, metrics = clip_loss(normalize(img), normalize(txt), module.logit_scale.float().exp())
        return {"loss": loss, **metrics}

    return eval_step
