"""What the port's train step does beyond the plain contrastive step
(nans_clip_tpu_torch/training/trainer.py): gradient accumulation with the
full negatives, FLIP masking, distillation and Adam moments in bf16, against
the JAX package on the CPU, fp32, the text tower's dropout at 0 in both
configurations (the two draw different random bits).

Tolerances are those of tests/test_torch_train.py: the loss within 1e-5; each
gradient tensor within 1e-4 of its largest magnitude, BERT's key biases (0 in
exact arithmetic) below 1e-8 on both sides; parameters within 1e-6 plus
Adam's sensitivity to the gradients' own differences (2 * lr where the
gradient is below 1e-6, else lr * min(2, 4 r) for a relative difference r of
the gradients the two updates took), added up over the steps."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.parallel import loss as jloss
from nans_clip_tpu.training import trainer as jtrainer
from nans_clip_tpu.utils.torch_interop import params_from_state_dict
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.api import CLIPModel
from nans_clip_tpu_torch.models import vit
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.parallel.loss import kd_cosine_loss
from nans_clip_tpu_torch.training import trainer

from test_torch_train import CASES, _as_port, _batch, _no_dropout, _port_cfg

torch.set_num_threads(2)

LR = 1e-3


def _pair(jcfg, seed=3):
    """The same random model in both packages."""
    cfg = _port_cfg(jcfg)
    params, _ = jclip.init_clip(jax.random.PRNGKey(seed), jcfg)
    module = build_clip(cfg)
    module.load_state_dict(_as_port(params, cfg))
    return cfg, params, module


def _jax_grads(params, jcfg, tcfg_j, images, texts, rng, teacher=None):
    """The gradient make_train_step takes: its loss_fn, through _encode_all."""
    options = JOptions(deterministic=False)

    def loss_fn(p):
        img_f, txt_f, _ = jtrainer._encode_all(p, jcfg, options, images, texts, rng, tcfg_j, {},
                                               constrain=False)
        scale = jnp.exp(p["logit_scale"].astype(jnp.float32))
        loss = jloss.clip_loss(jclip.normalize(img_f), jclip.normalize(txt_f), scale,
                               label_smoothing=tcfg_j.label_smoothing, constrain=False)[0]
        if teacher is not None:
            t = jclip.encode_image(teacher[1], teacher[0], images, JOptions())
            loss = loss + tcfg_j.kd_loss_weight * jloss.kd_cosine_loss(
                jax.lax.stop_gradient(t), img_f)
        return loss
    return jax.grad(loss_fn)(params)


def _check_grads(module, grads_j, tag):
    for name, p in module.named_parameters():
        g, gj = p.grad, grads_j[name]
        if name.endswith("self.key.bias"):
            assert max(float(g.abs().max()), float(gj.abs().max())) <= 1e-8, (tag, name)
        else:
            assert float((g - gj).abs().max()) <= 1e-4 * float(gj.abs().max()), (tag, name)


def _run_steps(jcfg, batch, kw, steps=2, teacher_j=None, teacher_t=None, patch_ids=None):
    """``steps`` steps of make_train_step in both packages from the same
    weights; the loss, every gradient and the parameters compared."""
    cfg, params, module = _pair(jcfg)
    tcfg_j = jtrainer.TrainConfig(lr=LR, warmup=2, max_steps=10, wd=0.1, **kw)
    tcfg = trainer.TrainConfig(lr=LR, warmup=2, max_steps=10, wd=0.1, **kw)
    state_t = trainer.create_train_state(module, tcfg, device="cpu")
    step_t = trainer.make_train_step(cfg, tcfg, ModelOptions(deterministic=False), teacher_t)
    state_j = jtrainer.create_train_state(jax.tree.map(jnp.copy, params), {}, tcfg_j)
    step_j = jtrainer.make_train_step(jcfg, tcfg_j, JOptions(deterministic=False), teacher_j,
                                      constrain=False)
    slack = {}
    for i in range(steps):
        images, texts = _batch(jcfg, batch, i)
        rng = jax.random.PRNGKey(100 + i)
        if patch_ids is not None:
            patch_ids(rng, batch)
        at = params_from_state_dict({k: v.detach().numpy()
                                     for k, v in state_t.module.state_dict().items()}, jcfg)[0]
        grads_j = _as_port(_jax_grads(at, jcfg, tcfg_j, images, texts, rng, teacher_j), cfg)
        taken_j = grads_j if i == 0 else _as_port(
            _jax_grads(state_j.params, jcfg, tcfg_j, images, texts, rng, teacher_j), cfg)
        state_j, metrics_j = step_j(state_j, jnp.asarray(images), jnp.asarray(texts), rng)
        state_t, metrics_t = step_t(state_t, torch.from_numpy(images), torch.from_numpy(texts),
                                    torch.Generator().manual_seed(i))
        assert set(metrics_t) == set(metrics_j)
        assert abs(float(metrics_t["loss"]) - float(metrics_j["loss"])) <= 1e-5, i
        for key in set(metrics_j) - {"loss"}:
            assert abs(float(metrics_t[key]) - float(metrics_j[key])) <= 1e-6, key
        _check_grads(state_t.module, grads_j, i)
        params_j = _as_port(state_j.params, cfg)
        for name, p in state_t.module.named_parameters():
            gt = taken_j[name]
            r = (p.grad - gt).abs() / gt.abs().clamp_min(1e-30)
            slack[name] = slack.get(name, 0.0) + torch.where(
                gt.abs() < 1e-6, 2 * LR, LR * torch.clamp(4 * r, max=2.0))
            assert bool(((p.detach() - params_j[name]).abs() <= 1e-6 + slack[name]).all()), \
                (i, name)
    return state_t


@pytest.mark.parametrize("case", list(CASES))
def test_accumulated_steps_match_jax(case):
    """accum_freq = 2: the two-pass protocol against the JAX scan."""
    jcfg = _no_dropout(CASES[case]())
    state = _run_steps(jcfg, 4 if case == "tiny" else 2, dict(accum_freq=2))
    assert state.step == 2


def test_accumulation_gives_the_unaccumulated_gradient():
    """With no dropout the accumulated gradient is the whole batch's (1e-5 of
    each tensor's largest magnitude: the same terms summed a microbatch at a
    time), label smoothing on; a batch that accum_freq does not divide
    raises."""
    jcfg = _no_dropout(jconfigs.tiny_config())
    cfg = _port_cfg(jcfg)
    images, texts = _batch(jcfg, 8, 0)
    grads = {}
    for accum in (1, 2, 4):
        module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
        tcfg = trainer.TrainConfig(lr=LR, accum_freq=accum, label_smoothing=0.1)
        state = trainer.create_train_state(module, tcfg, device="cpu")
        step = trainer.make_train_step(cfg, tcfg, ModelOptions(deterministic=False))
        state, metrics = step(state, images, texts, 0)
        grads[accum] = ({n: p.grad.clone() for n, p in module.named_parameters()},
                        float(metrics["loss"]))
    for accum in (2, 4):
        assert abs(grads[accum][1] - grads[1][1]) <= 1e-6
        for n, g in grads[accum][0].items():
            ref = grads[1][0][n]
            assert float((g - ref).abs().max()) <= 1e-5 * max(float(ref.abs().max()), 1e-3), n
    with pytest.raises(ValueError, match="not divisible"):
        step(state, images[:6], texts[:6], 0)


def test_accumulation_reuses_each_microbatch_draws():
    """Dropout 0.1 and FLIP on: accumulate_backward's gradient is that of one
    graph over the same per-microbatch seeds and kept tokens, which it can
    only be if pass 2 redraws what pass 1 drew (1e-5 of the largest
    magnitude); another step seed gives another loss."""
    jcfg = jconfigs.tiny_config()
    cfg = _port_cfg(jcfg)
    images, texts = _batch(jcfg, 8, 1)
    images, texts = torch.from_numpy(images), torch.from_numpy(texts).long()
    opts = ModelOptions(deterministic=False)
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    tcfg = trainer.TrainConfig(lr=LR, accum_freq=4, mask_ratio=0.5)
    state = trainer.create_train_state(module, tcfg, device="cpu")
    step = trainer.make_train_step(cfg, tcfg, opts)
    state, metrics = step(state, images, texts, 11)
    got = {n: p.grad.clone() for n, p in module.named_parameters()}

    module2 = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    draws = trainer.draw_microbatches(4, 2, cfg.vision.seq_len, 0.5,
                                      torch.Generator().manual_seed(11), True)
    feats = [(module2.encode_image(images[2 * j:2 * j + 2], opts, ids_keep=ids),
              module2.encode_text(texts[2 * j:2 * j + 2], opts, trainer.seeded(seed)))
             for j, (seed, ids) in enumerate(draws)]
    from nans_clip_tpu_torch.models.clip import normalize
    from nans_clip_tpu_torch.parallel.loss import clip_loss
    loss = clip_loss(normalize(torch.cat([f[0] for f in feats])),
                     normalize(torch.cat([f[1] for f in feats])),
                     module2.logit_scale.float().exp())[0]
    loss.backward()
    assert abs(float(loss.detach()) - float(metrics["loss"])) <= 1e-6
    for n, p in module2.named_parameters():
        assert float((got[n] - p.grad).abs().max()) <= 1e-5 * max(float(p.grad.abs().max()),
                                                                   1e-3), n
    module3 = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    state3 = trainer.create_train_state(module3, tcfg, device="cpu")
    assert float(step(state3, images, texts, 12)[1]["loss"]) != float(metrics["loss"])
    with pytest.raises(ValueError, match="generator"):
        step(state3, images, texts, None)


def _jax_ids_keep(rng, n, seq_len, mask_ratio):
    """ids_keep as nans_clip_tpu/models/vit.py:77-79 computes them."""
    len_keep = int((seq_len - 1) * (1 - mask_ratio))
    noise = jax.random.uniform(rng, (n, seq_len - 1))
    return np.array(jnp.argsort(noise, axis=1)[:, :len_keep] + 1)


def test_flip_masking_matches_jax(monkeypatch):
    """The same kept tokens in both packages: the image features agree
    (1e-5), and so does a train step with mask_ratio = 0.5."""
    jcfg = _no_dropout(dataclasses.replace(
        jconfigs.tiny_config(), vision=dataclasses.replace(jconfigs.tiny_config().vision,
                                                           image_resolution=64)))
    cfg, params, module = _pair(jcfg)
    seq_len = jcfg.vision.seq_len
    assert seq_len == 17
    images, _ = _batch(jcfg, 4, 0)
    rng = jax.random.PRNGKey(7)
    ids = _jax_ids_keep(rng, 4, seq_len, 0.5)
    want = np.asarray(jclip.encode_image(params, jcfg, jnp.asarray(images), JOptions(),
                                         mask_ratio=0.5, rng=rng))
    with torch.no_grad():
        got = module.encode_image(torch.from_numpy(images), ModelOptions(),
                                  ids_keep=torch.from_numpy(ids)).numpy()
        full = module.encode_image(torch.from_numpy(images), ModelOptions()).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got - full).max() > 1e-3

    def patch(rng, n):
        """The step's draw replaced by what the JAX step draws from rng."""
        img_rng, _ = jax.random.split(rng)
        keep = torch.from_numpy(_jax_ids_keep(img_rng, n, seq_len, 0.5))
        monkeypatch.setattr(trainer, "draw_ids_keep", lambda *a, **k: keep)

    _run_steps(jcfg, 4, dict(mask_ratio=0.5), steps=1, patch_ids=patch)


def test_draw_ids_keep():
    g = torch.Generator().manual_seed(0)
    ids = vit.draw_ids_keep(3, 197, 0.5, g)
    assert ids.shape == (3, 98) and ids.dtype == torch.int64
    assert int(ids.min()) >= 1 and int(ids.max()) <= 196
    assert all(len(set(row.tolist())) == 98 for row in ids)
    assert torch.equal(ids, vit.draw_ids_keep(3, 197, 0.5, torch.Generator().manual_seed(0)))
    assert not torch.equal(ids, vit.draw_ids_keep(3, 197, 0.5, g))
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).view(2, 5, 3)
    kept = vit.gather_kept(x, torch.tensor([[3, 1], [2, 4]]))
    assert torch.equal(kept[:, 0], x[:, 0])
    assert torch.equal(kept[0, 1:], x[0, [3, 1]]) and torch.equal(kept[1, 1:], x[1, [2, 4]])
    module = build_clip(tconfigs.tiny_config(), "cpu", torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator"):
        module.encode_image(torch.zeros(1, 32, 32, 3), ModelOptions(), mask_ratio=0.5)


@pytest.mark.parametrize("dims", [(16, 16), (16, 24), (24, 16)])
def test_kd_cosine_loss_matches_jax(dims):
    """Equal dimensions, and the student resized up and down to the
    teacher's (1e-6), with the gradient through the resize (1e-6)."""
    rs = np.random.RandomState(0)
    t, s = rs.randn(6, dims[0]).astype(np.float32), rs.randn(6, dims[1]).astype(np.float32)
    want, gwant = jax.value_and_grad(lambda s_: jloss.kd_cosine_loss(jnp.asarray(t), s_))(
        jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_()
    got = kd_cosine_loss(torch.from_numpy(t), st)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    assert np.abs(st.grad.numpy() - np.asarray(gwant)).max() <= 1e-6


@pytest.mark.parametrize("accum", [1, 2])
def test_distillation_step_matches_jax(accum):
    """One step with a frozen teacher of another seed: loss, kd_loss, every
    gradient and the parameters; the teacher does not move."""
    jcfg = _no_dropout(jconfigs.tiny_config())
    cfg = _port_cfg(jcfg)
    t_params, _ = jclip.init_clip(jax.random.PRNGKey(77), jcfg)
    t_module = build_clip(cfg)
    t_module.load_state_dict(_as_port(t_params, cfg))
    teacher = CLIPModel(cfg, t_module)
    before = {n: p.detach().clone() for n, p in t_module.named_parameters()}
    _run_steps(jcfg, 4, dict(distillation=True, kd_loss_weight=0.7, accum_freq=accum), steps=1,
               teacher_j=(jcfg, t_params), teacher_t=teacher)
    for n, p in t_module.named_parameters():
        assert torch.equal(p.detach(), before[n]) and p.grad is None


def test_compact_adam_matches_jax():
    """CompactAdamW against the JAX chain with adam_state_dtype (clip ->
    _scale_by_adam_compact -> add_decayed_weights -> learning rate) over 4
    steps of given gradients: bf16 moments within one bf16 ulp (2^-8
    relative: the EMA in fp32 at another operation order, then rounded),
    parameters within 1e-6 + 4 * lr * 2^-8 (an ulp of either moment moves
    the update by at most 2^-8 of its size, which is at most ~1)."""
    import optax

    rs = np.random.RandomState(0)
    params = {"w": rs.randn(5, 7).astype(np.float32), "bias": rs.randn(7).astype(np.float32)}
    tcfg_j = jtrainer.TrainConfig(lr=LR, warmup=0, max_steps=100, wd=0.1, skip_scheduler=True,
                                  adam_state_dtype="bfloat16")
    tx = jtrainer.make_optimizer(tcfg_j, params)
    pj = jax.tree.map(jnp.asarray, params)
    sj = tx.init(pj)
    pt = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = trainer.CompactAdamW([{"params": [pt["w"]], "weight_decay": 0.1},
                                {"params": [pt["bias"]], "weight_decay": 0.0}], lr=LR)
    for i in range(4):
        grads = {k: (rs.randn(*v.shape) * 10.0 ** rs.randint(-3, 1)).astype(np.float32)
                 for k, v in params.items()}
        updates, sj = tx.update(jax.tree.map(jnp.asarray, grads), sj, pj)
        pj = optax.apply_updates(pj, updates)
        for k in pt:
            pt[k].grad = torch.from_numpy(grads[k])
        opt.step()
        adam = [s for s in jax.tree.leaves(sj, is_leaf=lambda x: isinstance(
            x, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)][0]
        for k in pt:
            st = opt.state[pt[k]]
            assert st["mu"].dtype == st["nu"].dtype == torch.bfloat16
            for ours, theirs in ((st["mu"], adam.mu[k]), (st["nu"], adam.nu[k])):
                theirs = np.asarray(theirs.astype(jnp.float32))
                assert (np.abs(ours.float().numpy() - theirs)
                        <= 2.0 ** -8 * np.abs(theirs) + 1e-30).all(), (i, k)
            assert np.abs(pt[k].detach().numpy() - np.asarray(pj[k])).max() \
                <= 1e-6 + 4 * LR * 2.0 ** -8, (i, k)


def test_adam_state_dtype_in_the_train_step():
    """create_train_state builds CompactAdamW for adam_state_dtype, with the
    decay mask's two groups; a step stores bf16 moments and the loss falls
    over 4 steps on one batch."""
    cfg = tconfigs.tiny_config()
    tcfg = trainer.TrainConfig(lr=LR, warmup=1, adam_state_dtype="bfloat16")
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    state = trainer.create_train_state(module, tcfg, device="cpu")
    assert isinstance(state.optimizer, trainer.CompactAdamW)
    assert [g["weight_decay"] for g in state.optimizer.param_groups] == [tcfg.wd, 0.0]
    step = trainer.make_train_step(cfg, tcfg, ModelOptions(deterministic=False))
    images, texts = _batch(jconfigs.tiny_config(), 4, 0)
    losses = []
    for _ in range(4):
        state, metrics = step(state, images, texts, None)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert all(st["mu"].dtype == torch.bfloat16 for st in state.optimizer.state.values())
    plain = trainer.create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)),
                                       trainer.TrainConfig(), device="cpu")
    assert type(plain.optimizer) is torch.optim.AdamW
