"""Activation rematerialisation (``ModelOptions.remat``, ``--grad-checkpointing``;
``models/common.py::remat_layer`` around one layer of ``models/vit.py`` and
``models/bert.py``) on the CPU, fp32.

* Remat against no remat in the port: two train steps of ``tiny_config()``
  on each route (``fused``: the sub-block Functions' twins; ``pallas``: the
  flash route's twins; ``xla``: plain torch), with and without text dropout
  0.1: the losses, every gradient and the parameters bit-equal. Each
  dropout mask is drawn again in the recompute from the layer's seeds, the
  forward's bits (every mask key more often than without remat, its bits
  the same every time).
* What remat does: each layer's forward runs again in the backward, and the
  tensors the forward saves for the backward shrink on the plain route.
* Against JAX ``make_train_step`` with ``remat=True`` (one device, accum 1
  and 2): the loss 1e-4, each gradient 1e-4 of its largest magnitude,
  the parameters after AdamW 5e-4 plus 2 * lr where the gradient is below
  1e-6 (tests/test_torch_dp.py's tolerances).
* The tiny RN tower with remat: the ResNet takes none (as in JAX), the text
  tower's layers do; bit-equal to no remat.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import pytest
import torch

from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.parallel import clip_loss as jclip_loss
from nans_clip_tpu.training import trainer as jtrainer
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.models import vit
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.training import trainer
from tests.test_trainer import TINY

from test_torch_dp import TCFG, _as_port, _batch, _check_grads, _check_params, _mesh
from test_torch_resnet import tiny_rn_config

torch.set_num_threads(2)


def _steps(cfg, options, seeds, accum=1, state_dict=None):
    """Two train steps from seed-0 weights (or ``state_dict``): (losses,
    gradients, parameters) after the last."""
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    if state_dict is not None:
        module.load_state_dict(state_dict)
    tcfg = trainer.TrainConfig(**TCFG, accum_freq=accum)
    state = trainer.create_train_state(module, tcfg, device="cpu")
    step = trainer.make_train_step(cfg, tcfg, options)
    images, texts = _batch(8, res=cfg.vision.image_resolution)
    images, texts = torch.from_numpy(images), torch.from_numpy(texts)
    losses = []
    for seed in seeds:
        state, metrics = step(state, images, texts, seed)
        losses.append(float(metrics["loss"]))
    return (losses, {n: p.grad.clone() for n, p in state.module.named_parameters()},
            {n: p.detach().clone() for n, p in state.module.named_parameters()})


def _bit_equal(a, b):
    assert a[0] == b[0]
    for i in (1, 2):
        assert a[i].keys() == b[i].keys()
        for name, t in a[i].items():
            assert torch.equal(t, b[i][name]), name


def _record_masks(monkeypatch):
    """Every keep mask drawn: (seed, stream, sample0, shape) -> digests."""
    seen = {}
    orig = drop.multiplier

    def multiplier(spec, *idx):
        out = orig(spec, *idx)
        key = (spec.seed, spec.stream, spec.sample0, tuple(out.shape))
        seen.setdefault(key, []).append(hashlib.sha1(out.numpy().tobytes()).hexdigest())
        return out
    monkeypatch.setattr(drop, "multiplier", multiplier)
    return seen


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("impl", ["fused", "pallas", "xla"])
def test_remat_is_bit_equal(impl, dropout, monkeypatch):
    """Remat against no remat: two steps bit-equal; with dropout every
    mask drawn again in the recompute, with the forward's bits."""
    cfg = tconfigs.tiny_config()
    seeds = [5, 6] if dropout else [None, None]
    opts = ModelOptions(attn_impl=impl, deterministic=False)
    masks = _record_masks(monkeypatch)
    plain = _steps(cfg, opts, seeds)
    once = {k: v for k, v in masks.items()}
    masks.clear()
    _bit_equal(_steps(cfg, dataclasses.replace(opts, remat=True), seeds), plain)
    assert bool(once) == dropout
    # the embedding dropout is outside the layers: drawn once
    layers = {k for k in masks if k[1] != drop.STREAM_EMBED}
    assert {k for k in once if k[1] != drop.STREAM_EMBED} == layers
    for key in layers:
        # drawn again in the recompute (the twins' backward draws too), the
        # same bits every time
        assert len(masks[key]) > len(once[key]), key
        assert len(set(masks[key])) == 1 and set(masks[key]) == set(once[key]), key


def test_remat_recomputes_and_saves_less(monkeypatch):
    """Each layer's forward runs once more in the backward; on the plain
    route the forward saves fewer bytes for the backward."""
    cfg = tconfigs.tiny_config()
    calls = {"n": 0}
    orig_block = vit.attention_block_train

    def counted(*a, **k):
        calls["n"] += 1
        return orig_block(*a, **k)
    monkeypatch.setattr(vit, "attention_block_train", counted)
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    images = torch.from_numpy(_batch(8)[0])
    saved = {}
    for remat in (False, True):
        opts = ModelOptions(attn_impl="xla", deterministic=False, remat=remat)
        calls["n"] = 0
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            feats = module.encode_image(images, opts)
        forward_calls = calls["n"]
        feats.sum().backward()
        saved[remat] = total[0]
        assert forward_calls == cfg.vision.layers or remat is False
        assert calls["n"] == forward_calls * (2 if remat else 1)
    assert saved[True] < saved[False], saved


def _jax_remat_step(params, images, texts, accum):
    """JAX's one-device step with ``remat=True``: (loss, parameters after,
    the gradient it took)."""
    tcfg = jtrainer.TrainConfig(**TCFG, accum_freq=accum)
    opts = JOptions(attn_impl="xla", deterministic=True, remat=True)
    rng = jax.random.PRNGKey(3)
    with jax.set_mesh(_mesh(1)):
        state = jtrainer.create_train_state(jax.tree.map(jnp.copy, params), {}, tcfg)
        step = jtrainer.make_train_step(TINY, tcfg, opts, constrain=False)
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(texts), rng)

    def loss_fn(p):
        img_f, txt_f, _ = jtrainer._encode_all(p, TINY, opts, jnp.asarray(images),
                                               jnp.asarray(texts), rng, tcfg, {},
                                               constrain=False)
        scale = jnp.exp(p["logit_scale"].astype(jnp.float32))
        return jclip_loss(jclip.normalize(img_f), jclip.normalize(txt_f), scale,
                          constrain=False)[0]

    return float(metrics["loss"]), state.params, jax.jit(jax.grad(loss_fn))(params)


@pytest.mark.parametrize("accum", [1, 2])
def test_remat_step_matches_jax(accum):
    """One step with remat against JAX's with ``remat=True``."""
    cfg = tconfigs.CLIPConfig(embed_dim=TINY.embed_dim,
                              vision=tconfigs.VisionConfig(**dataclasses.asdict(TINY.vision)),
                              text=tconfigs.TextConfig(**dataclasses.asdict(TINY.text)),
                              name=TINY.name)
    params, _ = jax.jit(jclip.init_clip, static_argnums=1)(jax.random.PRNGKey(0), TINY)
    images, texts = _batch(8)
    loss, after, grads = _jax_remat_step(params, images, texts, accum)
    grads = _as_port(grads, cfg)
    losses, got_grads, got_params = _steps(
        cfg, ModelOptions(attn_impl="fused", deterministic=True, remat=True), [None], accum,
        {k: torch.from_numpy(v) for k, v in _as_port(params, cfg).items()})
    assert abs(losses[0] - loss) <= 1e-4
    _check_grads({k: v.numpy() for k, v in got_grads.items()}, grads)
    _check_params({k: v.numpy() for k, v in got_params.items()}, _as_port(after, cfg), grads)


def test_rn_remat_is_bit_equal():
    """The tiny RN tower: remat takes the text tower's layers only and
    changes no bit."""
    cfg = tiny_rn_config()
    opts = ModelOptions(attn_impl="xla", deterministic=False)
    plain = _steps(cfg, opts, [5, 6])
    _bit_equal(_steps(cfg, dataclasses.replace(opts, remat=True), [5, 6]), plain)
