"""The port's LoRA path (nans_clip_tpu_torch/models/lora.py,
training/train_lora.py, utils/torch_interop.py::lora_from_jax) against the
JAX package's, on the CPU in fp32 with the text tower's dropout at 0 (the two
packages draw different random bits).

Weights come from init_clip and cross through state_dict_from_jax_params;
adapters come from numpy seeds, B away from zero so that A's gradient is not
0, and cross through lora_from_jax. Tolerances: merged weights within 1e-6
(one fp32 product and sum); the loss within 1e-5; each adapter gradient
within 1e-4 of its largest magnitude (fp32 sums in another order through the
layers); adapters after a step within 1e-6 plus Adam's sensitivity to those
gradient differences, lr * min(2, 4 r) for a relative difference r of the
gradients the two updates took, 2 * lr where the gradient is below 1e-6 (as
tests/test_torch_train.py derives it)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.models import lora as jlora
from nans_clip_tpu.training import train_lora as jtl
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.models import lora
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.training import train_lora
from nans_clip_tpu_torch.utils.torch_interop import lora_from_jax, state_dict_from_jax_params

from test_torch_train import CASES, _batch, _no_dropout, _port_cfg

torch.set_num_threads(2)

LR, WD, ALPHA, SMOOTH = 1e-3, 0.01, 16.0, 0.05


def _adapters_np(jcfg, rank, seed, text_only=False):
    """The JAX adapter tree from a numpy seed, B nonzero."""
    rs = np.random.RandomState(seed)
    r = lambda *sh: (0.05 * rs.randn(*sh)).astype(np.float32)
    n, h = jcfg.text.num_hidden_layers, jcfg.text.hidden_size
    out = {"bert": {"wqkv_qv": {"a": r(n, 2, rank, h), "b": r(n, 2, h, rank)}}}
    if not text_only:
        n, w = jcfg.vision.layers, jcfg.vision.width
        out["visual"] = {"wo": {"a": r(n, rank, w), "b": r(n, w, rank)}}
    return out


def _setup(case, seed=3):
    jcfg = _no_dropout(CASES[case]())
    cfg = _port_cfg(jcfg)
    params, _ = jclip.init_clip(jax.random.PRNGKey(seed), jcfg)
    module = build_clip(cfg)
    module.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return jcfg, cfg, params, module


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(adapters, grad=False):
    return {k: (t.grad if grad else t.detach()).numpy() for k, t in lora._leaves(adapters)}


@pytest.mark.parametrize("text_only", [False, True])
def test_merge_lora_matches_jax(text_only):
    jcfg, cfg, params, module = _setup("tiny")
    ad_np = _adapters_np(jcfg, 4, 0, text_only)
    merged_j = jlora.merge_lora(params, jax.tree.map(jnp.asarray, ad_np), ALPHA)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, merged_j), cfg)
    got = lora.merge_lora(module, lora_from_jax(ad_np), ALPHA)
    expected = 2 * jcfg.text.num_hidden_layers + (0 if text_only else jcfg.vision.layers)
    assert len(got) == expected
    base = dict(module.named_parameters())
    for name, w in got.items():
        assert float((w.detach() - want[name]).abs().max()) <= 1e-6, name
        assert not torch.equal(w.detach(), base[name].detach()), name   # B is not zero
    # every weight that the adapters do not touch is the base's on the JAX side too
    for name, w in base.items():
        if name not in got:
            assert torch.equal(w.detach(), want[name]), name
    assert lora.count_lora_params(lora_from_jax(ad_np)) == jlora.count_lora_params(ad_np)


def test_init_lora_merges_to_the_base_model():
    """A Kaiming-uniform within +-sqrt(1 / fan_in) from the explicit
    generator, B zero: the merged weights equal the base's bit for bit;
    text_only leaves the ViT out; the tree has the JAX tree's shapes."""
    jcfg, cfg, params, module = _setup("tiny")
    ad = lora.init_lora(torch.Generator().manual_seed(5), module, rank=4, device="cpu")
    again = lora.init_lora(torch.Generator().manual_seed(5), module, rank=4, device="cpu")
    ad_j = jlora.init_lora(jax.random.PRNGKey(0), params, rank=4)
    assert {k: v.shape for k, v in _flat(ad_j).items()} == \
        {k: v.shape for k, v in _flat_t(ad).items()}
    for (k, t), (_, u) in zip(lora._leaves(ad), lora._leaves(again)):
        assert torch.equal(t, u) and t.requires_grad and t.dtype == torch.float32
        if k.endswith("['a']"):
            bound = (1.0 / t.shape[-1]) ** 0.5
            top = float(t.detach().abs().max())
            assert 0.9 * bound < top <= bound
        else:
            assert not t.detach().any()
    base = dict(module.named_parameters())
    for name, w in lora.merge_lora(module, ad, ALPHA).items():
        assert torch.equal(w.detach(), base[name].detach())
    only = lora.init_lora(torch.Generator().manual_seed(5), module, rank=2, text_only=True,
                          device="cpu")
    assert set(only) == {"bert"} and lora._infer_rank(only) == 2


def test_merge_lora_refuses_int8_weights():
    from nans_clip_tpu_torch.utils.quantize import quantize_for_serving

    _, _, _, module = _setup("tiny")
    ad = lora.init_lora(torch.Generator().manual_seed(0), module, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        lora.merge_lora(quantize_for_serving(module, ("text",)), ad)
    assert lora.merge_lora(module, {}) == {}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_lora_steps_match_jax(case, accum):
    """Two steps of make_lora_step in both packages from the same base and
    adapters: the loss, the adapter gradients (the JAX gradient taken at the
    port's adapters of that step, so jax.grad through merge_lora is what
    merge_lora's backward is held against) and the adapters after each step;
    the base weights and logit_scale do not move."""
    jcfg, cfg, params, module = _setup(case)
    batch = 4 if case == "tiny" else 2
    ad_np = _adapters_np(jcfg, 4, 1)
    tx = optax.adamw(LR, weight_decay=WD)
    ad_j = jax.tree.map(jnp.asarray, ad_np)
    opt_j = tx.init(ad_j)
    step_j, eval_j = jtl.make_lora_step(jcfg, JOptions(), ALPHA, SMOOTH, accum, tx)
    state = train_lora.create_lora_state(module, lora_from_jax(ad_np), LR, WD, device="cpu")
    step_t, eval_t = train_lora.make_lora_step(cfg, ModelOptions(), ALPHA, SMOOTH, accum)
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    assert not any(p.requires_grad for p in module.parameters())

    def grads_j(adapters, images, texts, rng):
        def loss_fn(a):
            p = jlora.merge_lora(params, a, ALPHA)
            opts = JOptions(deterministic=False)
            if accum == 1:
                fi = jclip.encode_image(p, jcfg, images, opts)
                ft = jclip.encode_text(p, jcfg, texts, opts, rng=rng)
            else:
                m = images.shape[0] // accum
                fi = jnp.concatenate([jclip.encode_image(p, jcfg, images[j * m:(j + 1) * m], opts)
                                      for j in range(accum)])
                ft = jnp.concatenate([jclip.encode_text(p, jcfg, texts[j * m:(j + 1) * m], opts,
                                                        rng=jax.random.fold_in(rng, j))
                                      for j in range(accum)])
            from nans_clip_tpu.parallel import clip_loss
            scale = jnp.exp(params["logit_scale"].astype(jnp.float32))
            return clip_loss(jclip.normalize(fi), jclip.normalize(ft), scale,
                             label_smoothing=SMOOTH, constrain=False)[0]
        return jax.grad(loss_fn)(adapters)

    slack = {}
    for i in range(2):
        images, texts = _batch(jcfg, batch, 10 + i)
        rng = jax.random.PRNGKey(200 + i)
        at = jax.tree.map(jnp.asarray, _unflat(_flat_t(state.adapters), ad_np))
        g_at = _flat(grads_j(at, jnp.asarray(images), jnp.asarray(texts), rng))
        g_taken = g_at if i == 0 else _flat(grads_j(ad_j, jnp.asarray(images),
                                                    jnp.asarray(texts), rng))
        ad_j, opt_j, loss_j, _ = step_j(params, ad_j, opt_j, jnp.asarray(images),
                                        jnp.asarray(texts), rng)
        state, loss_t, metrics_t = step_t(state, images, texts, i)
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5, i
        assert set(metrics_t) == {"i2t_acc", "t2i_acc"}
        got_g, got_p, want_p = _flat_t(state.adapters, grad=True), _flat_t(state.adapters), \
            _flat(ad_j)
        for key, g in got_g.items():
            assert np.abs(g - g_at[key]).max() <= 1e-4 * np.abs(g_at[key]).max(), (i, key)
            gt = g_taken[key]
            r = np.abs(g - gt) / np.maximum(np.abs(gt), 1e-30)
            slack[key] = slack.get(key, 0.0) + np.where(np.abs(gt) < 1e-6, 2 * LR,
                                                        LR * np.minimum(4 * r, 2.0))
            assert (np.abs(got_p[key] - want_p[key]) <= 1e-6 + slack[key]).all(), (i, key)
    images, texts = _batch(jcfg, batch, 99)
    assert abs(float(eval_t(state, images, texts))
               - float(eval_j(params, ad_j, jnp.asarray(images), jnp.asarray(texts)))) <= 1e-4
    assert state.step == 2
    for n, p in module.named_parameters():
        assert torch.equal(p.detach(), before[n]) and p.grad is None, n


def _unflat(flat, template):
    """A nested tree shaped as ``template`` from {JAX key string: array}."""
    return {t: {m: {n: flat[f"['{t}']['{m}']['{n}']"] for n in template[t][m]}
                for m in template[t]} for t in template}


def test_lora_step_dropout_and_eval():
    """The train forward drops out (tiny_config's text dropout is 0.1): two
    seeds give two losses, one seed the same loss; eval_step is
    deterministic; a batch that accum does not divide raises; the schedule
    sets the step's learning rate."""
    jcfg = jconfigs.tiny_config()
    assert jcfg.text.hidden_dropout_prob == 0.1
    cfg = _port_cfg(jcfg)
    images, texts = _batch(jcfg, 4, 0)

    def first_loss(seed, accum=2, schedule=None):
        module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
        ad = lora_from_jax(_adapters_np(jcfg, 4, 2))
        state = train_lora.create_lora_state(module, ad, LR, WD, device="cpu")
        step, ev = train_lora.make_lora_step(cfg, ModelOptions(), ALPHA, SMOOTH, accum, schedule)
        e0 = float(ev(state, images, texts))
        state, loss, _ = step(state, images, texts, seed)
        return float(loss), e0, state

    a, e_a, _ = first_loss(1)
    b, e_b, _ = first_loss(1)
    c, _, _ = first_loss(2)
    none, e_none, _ = first_loss(None)
    assert a == b and a != c and e_a == e_b == e_none
    assert abs(none - e_none) <= 1e-6      # no generator: no dropout, the eval forward
    with pytest.raises(ValueError, match="not divisible"):
        first_loss(1, accum=3)
    _, _, state = first_loss(1, schedule=lambda t: 0.5 * (t + 1))
    assert state.optimizer.param_groups[0]["lr"] == 0.5


def test_lora_npz_interchanges_with_jax(tmp_path):
    """An .npz written by each package is read by the other: same keys,
    same arrays, same meta."""
    jcfg, cfg, params, module = _setup("tiny")
    ad_np = _adapters_np(jcfg, 4, 3)
    meta = {"epoch": 3, "rank": 4, "alpha": 16.0}
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    lora.save_lora(ours, lora_from_jax(ad_np), meta)
    jlora.save_lora(theirs, jax.tree.map(jnp.asarray, ad_np), meta)
    assert sorted(np.load(ours).files) == sorted(np.load(theirs).files)
    template_j = jlora.init_lora(jax.random.PRNGKey(0), params, rank=4)
    back_j, meta_j = jlora.load_lora(ours, template_j)
    template_t = lora.init_lora(torch.Generator().manual_seed(0), module, rank=4, device="cpu")
    back_t, meta_t = lora.load_lora(theirs, template_t)
    assert meta_j == meta_t == meta
    want = _flat(ad_np)
    for key, arr in _flat(back_j).items():
        np.testing.assert_array_equal(arr, want[key])
    for key, t in lora._leaves(back_t):
        np.testing.assert_array_equal(t.detach().numpy(), want[key])
        assert t.requires_grad
    # reloaded adapters give the same features
    opts = ModelOptions()
    images, texts = _batch(jcfg, 2, 0)
    f = lambda ad: torch.func.functional_call(
        module, lora.merge_lora(module, ad, ALPHA), (torch.from_numpy(images), None, opts))
    with torch.no_grad():
        assert torch.equal(f(lora_from_jax(ad_np)), f(back_t))


def test_parse_args_takes_the_jax_flags_and_main_waits_for_the_data_path():
    """The JAX flags, and --platform (the card by default). main() runs the
    data path now (tests/test_torch_cli.py holds it against JAX); without a
    base checkpoint or --tiny-model it stops, as the JAX CLI does."""
    argv = ["--train-data", "d", "--lora-rank", "8", "--text-only", "--accum-freq", "2"]
    ours, theirs = vars(train_lora.parse_args(argv)), vars(jtl.parse_args(argv))
    assert ours.pop("platform") == "cuda"
    assert ours.pop("distributed") is False   # the port's, refused: LoRA runs on one rank
    assert ours == theirs
    assert (ours["batch_size"], ours["accum_freq"], ours["lora_rank"]) == (32, 2, 8)
    with pytest.raises(SystemExit, match="--resume is required"):
        train_lora.main(argv)


def test_lora_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    module = build_clip(tconfigs.tiny_config(), "cpu", torch.Generator().manual_seed(0))
    ad = lora.init_lora(torch.Generator().manual_seed(0), module, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lora.create_lora_state(module, ad)
