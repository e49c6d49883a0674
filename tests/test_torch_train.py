"""The port's train step (nans_clip_tpu_torch/training/trainer.py) against
the JAX package's make_train_step on the CPU, fp32, with the text tower's
dropout rates set to 0 in both configurations (the two draw different random
bits), at tiny_config, at ViT-B-16 / RoBERTa-base widths cut to 2 layers,
and at two tiny configurations of the wide towers' shapes (an image tower of
W 160 with two heads of 80, as ViT-H's; and one at 336 pixels, patch 14, W
128: S = 577, where the attention backward takes #20's long-sequence route),
for 2 steps; tiny_config and the S = 577 case also on the
``attn_impl="pallas"`` route (the flash attention, #22/#23's twins against
the JAX kernels in interpret mode). Identical weights are carried across by
state_dict_from_jax_params, which also maps the JAX gradient tree (it has
the parameters' structure) so that gradients compare name by name. Each
step's gradients are compared at the same parameters: the JAX gradient is
taken at the port's parameters of that step (params_from_state_dict),
since near-zero gradients let the two trajectories part by up to 2 * lr an
element (below).

Tolerances: the loss within 1e-5; each gradient tensor within 1e-4 of its
largest magnitude (fp32 sums in another order through 2 layers a tower;
3e-4 at S = 577 (5e-4 on its pallas case, GRAD_REL), whose attention rows
and LayerNorm-gradient columns sum 2.9 times as many terms as at S = 197,
and whose smallest gradients, 1e-4 in magnitude at init, are such sums
that nearly cancel),
except BERT's key biases, whose gradient is 0 in exact arithmetic (softmax
ignores a shift shared by all keys) and is held to below 1e-8 on both sides;
parameters within 1e-6 plus what the gradients' own differences allow a
step: 2 * lr on elements whose gradient is below 1e-6 in magnitude (Adam's
first step moves an element by lr * g / (|g| + eps), close to lr * sign(g),
so a gradient near 0 whose sign the sum order decides moves it by up to
2 * lr either way), else lr * min(2, 4 * r) with r the element's relative
difference between the gradients the two updates took (Adam's update
m_hat / (sqrt(v_hat) + eps) changes by about 2 r for a relative change r
of its gradients; 4 r allows twice that). The bounds add up over the
steps, as the moments carry them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.parallel import clip_loss as jclip_loss
from nans_clip_tpu.training import trainer as jtrainer
from nans_clip_tpu.utils.torch_interop import params_from_state_dict
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.parallel.loss import clip_loss
from nans_clip_tpu_torch.training import trainer
from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params

torch.set_num_threads(2)

LR = 1e-3


def _no_dropout(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))


def _port_cfg(jcfg):
    v, t = jcfg.vision, jcfg.text
    return tconfigs.CLIPConfig(embed_dim=jcfg.embed_dim,
                               vision=tconfigs.VisionConfig(**dataclasses.asdict(v)),
                               text=tconfigs.TextConfig(**dataclasses.asdict(t)), name=jcfg.name)


def _batch(jcfg, b, seed):
    rs = np.random.RandomState(seed)
    r = jcfg.vision.image_resolution
    images = rs.randn(b, r, r, 3).astype(np.float32)
    texts = np.zeros((b, 52), np.int32)
    texts[:, 0] = 101
    texts[:, 1:12] = rs.randint(1000, 20000, (b, 11))
    texts[:, 12] = 102
    texts[0, 6:12] = 0                     # one shorter text: the key bias matters
    return images, texts


def _as_port(tree, cfg):
    return state_dict_from_jax_params(jax.tree.map(np.asarray, tree), cfg)


def _jax_grads(params, jcfg, options, images, texts, rng):
    """The gradient make_train_step takes (its loss_fn without a teacher)."""
    def loss_fn(p):
        img_rng, txt_rng = jax.random.split(rng)
        img = jclip.encode_image(p, jcfg, images, options, rng=img_rng)
        txt = jclip.encode_text(p, jcfg, texts, options, rng=txt_rng)
        scale = jnp.exp(p["logit_scale"].astype(jnp.float32))
        return jclip_loss(jclip.normalize(img), jclip.normalize(txt), scale,
                          constrain=False)[0]
    return jax.grad(loss_fn)(params)


def _tiny_vision(**vision):
    cfg = jconfigs.tiny_config()
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **vision))


CASES = {
    "tiny": lambda: jconfigs.tiny_config(),
    "base-width-2-layers": lambda: dataclasses.replace(
        jconfigs.load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese"),
        vision=dataclasses.replace(jconfigs.load_config(
            "ViT-B-16@RoBERTa-wwm-ext-base-chinese").vision, layers=2),
        text=dataclasses.replace(jconfigs.load_config(
            "ViT-B-16@RoBERTa-wwm-ext-base-chinese").text, num_hidden_layers=2)),
}


# The wide towers' shapes at tiny sizes (heads of 80; S = 577).
WIDE_CASES = {
    "tiny-heads-of-80": lambda: _tiny_vision(width=160, head_width=80),
    "tiny-336px-S577": lambda: _tiny_vision(width=128, head_width=64, image_resolution=336,
                                             patch_size=14),
}
# The attn_impl="pallas" route (the flash attention #22/#23, the JAX towers'
# unfused layers) on both sides, JAX's kernels in interpret mode.
PALLAS_CASES = {"tiny-pallas": CASES["tiny"],
                "tiny-336px-S577-pallas": WIDE_CASES["tiny-336px-S577"]}
# On the pallas route at S = 577 the gradient of the last layer's c_proj
# bias (4.1e-5 in magnitude at init: a sum over 2,308 rows that nearly
# cancels) differs from JAX's by 3.7e-4 of its magnitude (this test's
# report at 3e-4); the JAX package's own xla and pallas routes differ on it
# at the same order: 5e-4 for that case.
GRAD_REL = {"tiny-336px-S577": 3e-4, "tiny-336px-S577-pallas": 5e-4}


@pytest.mark.parametrize("case", list(CASES) + list(WIDE_CASES) + list(PALLAS_CASES))
def test_train_steps_match_jax(case, monkeypatch):
    jcfg = _no_dropout({**CASES, **WIDE_CASES, **PALLAS_CASES}[case]())
    cfg = _port_cfg(jcfg)
    batch = 4 if case.startswith("tiny") else 2
    impl = "pallas" if case in PALLAS_CASES else "auto"
    if impl == "pallas":
        from nans_clip_tpu.ops import attention as jattn
        orig = jattn.attention_pallas
        monkeypatch.setattr(jattn, "attention_pallas",
                            lambda q, k, v, key_bias=None, block_q=128, interpret=False:
                            orig(q, k, v, key_bias, block_q, interpret=True))
    tcfg_j = jtrainer.TrainConfig(lr=LR, warmup=2, max_steps=10, wd=0.1)
    tcfg = trainer.TrainConfig(lr=LR, warmup=2, max_steps=10, wd=0.1)
    options_j = JOptions(deterministic=False, attn_impl=impl)
    params, _ = jclip.init_clip(jax.random.PRNGKey(3), jcfg)
    module = build_clip(cfg)
    module.load_state_dict(_as_port(params, cfg))
    state_t = trainer.create_train_state(module, tcfg, device="cpu")
    step_t = trainer.make_train_step(cfg, tcfg, ModelOptions(deterministic=False, attn_impl=impl))
    state_j = jtrainer.create_train_state(jax.tree.map(jnp.copy, params), {}, tcfg_j)
    step_j = jtrainer.make_train_step(jcfg, tcfg_j, options_j, constrain=False)

    slack = {}
    for i in range(2):
        images, texts = _batch(jcfg, batch, i)
        rng = jax.random.PRNGKey(100 + i)
        at = params_from_state_dict({k: v.detach().numpy()
                                     for k, v in state_t.module.state_dict().items()}, jcfg)[0]
        grads_j = _as_port(_jax_grads(at, jcfg, options_j, images, texts, rng), cfg)
        taken_j = grads_j if i == 0 else _as_port(
            _jax_grads(state_j.params, jcfg, options_j, images, texts, rng), cfg)
        state_j, metrics_j = step_j(state_j, jnp.asarray(images), jnp.asarray(texts), rng)
        state_t, metrics_t = step_t(state_t, torch.from_numpy(images),
                                    torch.from_numpy(texts), torch.Generator().manual_seed(i))
        assert abs(float(metrics_t["loss"]) - float(metrics_j["loss"])) <= 1e-5, i
        for key in ("i2t_acc", "t2i_acc", "logit_scale"):
            assert abs(float(metrics_t[key]) - float(metrics_j[key])) <= 1e-6, key
        params_j = _as_port(state_j.params, cfg)
        for name, p in state_t.module.named_parameters():
            g, gj = p.grad, grads_j[name]
            if name.endswith("self.key.bias"):
                assert max(float(g.abs().max()), float(gj.abs().max())) <= 1e-8, (i, name)
            else:
                assert float((g - gj).abs().max()) <= GRAD_REL.get(case, 1e-4) * float(
                    gj.abs().max()), (i, name)
            gt = taken_j[name]
            r = (g - gt).abs() / gt.abs().clamp_min(1e-30)
            slack[name] = slack.get(name, 0.0) + torch.where(
                gt.abs() < 1e-6, 2 * LR, LR * torch.clamp(4 * r, max=2.0))
            assert bool(((p.detach() - params_j[name]).abs() <= 1e-6 + slack[name]).all()), \
                (i, name)
    assert state_t.step == int(state_j.step) == 2


def test_decay_mask_matches_jax():
    jcfg = jconfigs.tiny_config()
    params, _ = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    mask = jtrainer.no_decay_mask(params)
    full = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    want = {k: bool(v.flatten()[0]) for k, v in _as_port(full, _port_cfg(jcfg)).items()}
    got = trainer.no_decay_mask(build_clip(_port_cfg(jcfg)))
    assert got == want
    assert sum(got.values()) and not all(got.values())


def test_schedule_and_loss_match_jax():
    sched_j = jtrainer.cosine_with_warmup(1e-3, 5, 50)
    sched_t = trainer.cosine_with_warmup(1e-3, 5, 50)
    for s in (0, 3, 5, 20, 49, 60):
        assert abs(sched_t(s) - float(sched_j(s))) <= 1e-9
    assert trainer.cosine_with_warmup(1e-3, 5, 50, skip_decay=True)(30) == 1e-3
    rs = np.random.RandomState(0)
    a, b = rs.randn(6, 16).astype(np.float32), rs.randn(6, 16).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    for smooth in (0.0, 0.1):
        lj, mj = jclip_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(14.3), smooth,
                            constrain=False)
        lt, mt = clip_loss(torch.from_numpy(a), torch.from_numpy(b), torch.tensor(14.3), smooth)
        assert abs(float(lt) - float(lj)) <= 1e-5
        assert float(mt["i2t_acc"]) == float(mj["i2t_acc"])


def test_unported_options_raise_and_eval_step_runs():
    """Accumulation, FLIP, distillation and adam_state_dtype are ported
    (tests/test_torch_accum.py holds them against JAX): nothing in the
    trainer refuses them any more. Then freeze_vision, clipping and the
    eval step."""
    cfg = tconfigs.tiny_config()
    for kw in (dict(accum_freq=2), dict(mask_ratio=0.5), dict(distillation=True),
               dict(adam_state_dtype="bfloat16")):
        tcfg = trainer.TrainConfig(**kw)
        assert callable(trainer.make_train_step(cfg, tcfg, ModelOptions()))
        trainer.create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)),
                                   tcfg, "cpu")
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    state = trainer.create_train_state(module, trainer.TrainConfig(freeze_vision=True,
                                                                   grad_norm_clip=1.0), "cpu")
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    images, texts = _batch(jconfigs.tiny_config(), 4, 0)
    step = trainer.make_train_step(cfg, trainer.TrainConfig(freeze_vision=True,
                                                            grad_norm_clip=1.0),
                                   ModelOptions(deterministic=False))
    state, metrics = step(state, images, texts, 0)
    after = dict(module.named_parameters())
    assert all(torch.equal(before[n], after[n]) for n in before if n.startswith("visual."))
    assert not torch.equal(before["text_projection"], after["text_projection"])
    out = trainer.make_eval_step(cfg, ModelOptions())(module, images, texts)
    assert set(out) == {"loss", "i2t_acc", "t2i_acc"} and bool(torch.isfinite(out["loss"]))


def test_trained_checkpoint_round_trips(tmp_path):
    """A trained module saved by save_torch_checkpoint reloads through the
    API's .pt path (model_from_config, as load_from_name) with the same
    features, bit for bit."""
    from nans_clip_tpu_torch.api import model_from_config
    from nans_clip_tpu_torch.utils.checkpoint import save_torch_checkpoint

    cfg = tconfigs.tiny_config()
    tcfg = trainer.TrainConfig(lr=1e-3, warmup=1)
    state = trainer.create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)),
                                       tcfg, "cpu")
    images, texts = _batch(jconfigs.tiny_config(), 4, 0)
    state, _ = trainer.make_train_step(cfg, tcfg, ModelOptions(deterministic=False))(
        state, images, texts, 0)
    path = str(tmp_path / "trained.pt")
    save_torch_checkpoint(path, state.module)
    loaded = model_from_config(cfg, path, device="cpu")
    with torch.no_grad():
        mine = (state.module.encode_image(torch.from_numpy(images)),
                state.module.encode_text(torch.from_numpy(texts).long()))
    theirs = (loaded.encode_image(images), loaded.encode_text(texts))
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tconfigs.tiny_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)),
                                   trainer.TrainConfig())


# -- the ResNet image tower (tiny RN: ref_loader.TINY_RN_KWARGS) ---------------

def _jax_rn_step(jcfg, tcfg_j):
    """``fn(params, stats, images, texts, rng) -> (loss, gradients, new
    running statistics)`` that make_train_step takes at (params, stats): its
    _encode_all (the scan over microbatches, the statistics in its carry) and
    the contrastive loss."""
    options = JOptions(deterministic=False)

    def step(params, stats, images, texts, rng):
        def loss_fn(p):
            img, txt, new_stats = jtrainer._encode_all(p, jcfg, options, images, texts, rng,
                                                       tcfg_j, stats, constrain=False)
            scale = jnp.exp(p["logit_scale"].astype(jnp.float32))
            return jclip_loss(jclip.normalize(img), jclip.normalize(txt), scale,
                              constrain=False)[0], new_stats
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, grads, new_stats
    return jax.jit(step)


@pytest.mark.parametrize("accum", [1, 2])
def test_rn_train_steps_match_jax(accum, monkeypatch):
    """Two steps of the tiny RN CLIP against make_train_step (batch 8; with
    accum_freq 2, two microbatches of 4): the loss within 1e-5, each gradient
    within 1e-4 of its largest magnitude and the running statistics after the
    step within 1e-5, the JAX side taken at the port's parameters and
    statistics of that step (as above); the running statistics update once a
    microbatch, in order, as the JAX scan's carry. The JAX stem pads as the
    reference (tests/test_torch_resnet.py)."""
    from test_torch_resnet import jax_tiny_rn, padded_stem, port_cfg

    padded_stem(monkeypatch)
    jcfg = _no_dropout(jax_tiny_rn())
    cfg = port_cfg(jcfg)
    tcfg_j = jtrainer.TrainConfig(lr=LR, warmup=2, max_steps=10, wd=0.1, accum_freq=accum)
    tcfg = trainer.TrainConfig(lr=LR, warmup=2, max_steps=10, wd=0.1, accum_freq=accum)
    params, stats = jax.jit(jclip.init_clip, static_argnums=1)(jax.random.PRNGKey(5), jcfg)
    module = build_clip(cfg)
    module.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                                      jax.tree.map(np.asarray, stats)))
    state_t = trainer.create_train_state(module, tcfg, device="cpu")
    step_t = trainer.make_train_step(cfg, tcfg, ModelOptions(deterministic=False))
    state_j = jtrainer.create_train_state(jax.tree.map(jnp.copy, params), stats, tcfg_j)
    step_j = jtrainer.make_train_step(jcfg, tcfg_j, JOptions(deterministic=False),
                                      constrain=False)
    grad_fn = _jax_rn_step(jcfg, tcfg_j)
    before = {n: b.clone() for n, b in module.visual.named_buffers()}
    for i in range(2):
        images, texts = _batch(jcfg, 8, 10 + i)
        rng = jax.random.PRNGKey(200 + i)
        at, at_stats = params_from_state_dict(
            {k: v.detach().numpy() for k, v in state_t.module.state_dict().items()}, jcfg)
        loss_j, grads_j, stats_j = grad_fn(at, at_stats, jnp.asarray(images),
                                           jnp.asarray(texts), rng)
        loss_j, grads_j = float(loss_j), _as_port(grads_j, cfg)
        state_j, metrics_j = step_j(state_j, jnp.asarray(images), jnp.asarray(texts), rng)
        state_t, metrics_t = step_t(state_t, torch.from_numpy(images), torch.from_numpy(texts),
                                    torch.Generator().manual_seed(i))
        assert abs(float(metrics_t["loss"]) - loss_j) <= 1e-5, i
        assert abs(float(metrics_t["loss"]) - float(metrics_j["loss"])) <= 1e-5, i
        for name, p in state_t.module.named_parameters():
            g, gj = p.grad, grads_j[name]
            # the attention pool's key bias, as BERT's: 0 in exact arithmetic
            if name.endswith(("self.key.bias", "attnpool.k_proj.bias")):
                assert max(float(g.abs().max()), float(gj.abs().max())) <= 1e-8, (i, name)
            else:
                assert float((g - gj).abs().max()) <= 1e-4 * float(gj.abs().max()), (i, name)
        want = state_dict_from_jax_params(jax.tree.map(np.asarray, at), cfg,
                                          jax.tree.map(np.asarray, stats_j))
        got = dict(state_t.module.visual.named_buffers())
        assert set(f"visual.{n}" for n in got) == {k for k in want if "running_" in k}
        for name, buf in got.items():
            assert float((buf - want[f"visual.{name}"]).abs().max()) <= 1e-5, (i, name)
            assert not torch.equal(buf, before[name]), (i, name)   # every BatchNorm moved
        before = {n: b.clone() for n, b in got.items()}
    assert state_t.step == int(state_j.step) == 2


def test_rn_freeze_vision_freezes_bn_stats():
    """freeze_vision: the running statistics and the visual parameters stay
    bit-equal over two steps with accum_freq 2 (JAX
    tests/test_trainer.py::test_freeze_vision_freezes_bn_stats), while the
    text tower trains."""
    from test_torch_resnet import tiny_rn_config

    cfg = tiny_rn_config()
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, buf in module.visual.named_buffers():
            buf.uniform_(0.5, 1.5) if name.endswith("var") else buf.uniform_(-0.5, 0.5)
    tcfg = trainer.TrainConfig(lr=1e-3, warmup=1, max_steps=10, freeze_vision=True, accum_freq=2)
    state = trainer.create_train_state(module, tcfg, "cpu")
    before = {k: v.clone() for k, v in module.state_dict().items()}
    step = trainer.make_train_step(cfg, tcfg, ModelOptions(deterministic=False))
    for i in range(2):
        _, texts = _batch(jconfigs.tiny_config(), 8, i)
        images = np.random.RandomState(i).randn(8, 64, 64, 3).astype(np.float32)
        state, _ = step(state, images, texts, i)
    after = module.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before if k.startswith("visual."))
    assert not torch.equal(before["text_projection"], after["text_projection"])


def test_rn_decay_mask_matches_jax():
    """Leaf for leaf on the RN names, the reference quirk included: every
    bn{j}.weight is exempt and downsample.1.weight is decayed
    (tests/test_trainer.py::test_no_decay_mask_downsample_bn_decayed)."""
    from test_torch_resnet import jax_tiny_rn, port_cfg

    jcfg = jax_tiny_rn()
    params = jax.eval_shape(lambda k: jclip.init_clip(k, jcfg)[0], jax.random.PRNGKey(0))
    mask = jtrainer.no_decay_mask(params)
    full = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    want = {k: bool(v.flatten()[0]) for k, v in _as_port(full, port_cfg(jcfg)).items()}
    got = trainer.no_decay_mask(build_clip(port_cfg(jcfg)))
    assert got == {k: v for k, v in want.items() if "running_" not in k}
    assert got["visual.layer1.0.bn1.weight"] and got["visual.bn2.weight"]
    assert not got["visual.layer1.0.downsample.1.weight"]
    assert got["visual.layer1.0.downsample.1.bias"]
