"""Pipeline parallelism of the port's training (``parallel/pp.py``, the pipe
axis of ``parallel/mesh.py``'s grid, the stage-local storage of
``training/trainer.py`` and ``parallel/fsdp.py``, the pipelined towers of
``models/vit.py`` and ``models/bert.py``, the stages' checkpoint of
``utils/checkpoint.py``) and a ResNet tower replicated under tp / pp, on the
CPU, fp32, against the JAX package and against the port's one-rank step.

Ranks: one set of 4 gloo processes runs every case
(``tests/test_torch_pp_worker.py``, which imports no JAX): the grids ``data
2 x pipe 2``, ``pipe 4`` and ``data 2 x tp 2`` of one world. JAX runs on
``create_mesh(..., pipe=...)`` of the 8 CPU devices (tests/conftest.py) at
tests/test_pp.py's TINY shapes, and its oracle for a train step is the
one-device step.

* The helpers (``pick_microbatches``, ``bubble_fraction``,
  ``pp_kernel_batch``) equal JAX's over a grid of batches and ``pp``.
* The bare loop at 4 stages with an aux against a plain loop, forward and
  gradient (tests/test_pp.py:48's case).
* The towers at pp 2 (``data 2 x pipe 2``) and pp 4 (TINY4: 4 layers a
  tower) against JAX's pipelined towers; every stage's features equal;
  each stage stores its ``L / pp`` layers and the replicated rest.
* The train step at ``data 2 x pipe 2`` against JAX's one-device step, and
  with ``--fsdp`` (``fsdp_min_size`` 1024); ``accum_freq`` 2 with FLIP 0.5
  and remat (tests/test_pp.py:287; the FLIP tokens JAX draws fed to the
  port); the stages' replicated parameters bit-equal after each. Remat at
  ``data 2 x tp 2`` against the same JAX step.
* Text dropout at pp 2 (``data 2 x pipe 2``) against one rank of the port:
  each microbatch's masks keyed by its global first row; clipping by the
  global norm across the stages (with and without --fsdp) likewise.
* RN50 (the tiny RN tower) at pp 2 and at tp 2 against JAX's global-batch
  step: the ResNet runs whole on every rank.
* A checkpoint written at pp 2 resumes in one process and continues the
  pp 2 run.

Tolerances (tests/test_torch_dp.py's): the loss 1e-4 against JAX, 1e-5
against one rank of the port; each gradient 1e-4 of its largest magnitude
(BERT's key bias, 0 in exact arithmetic, below 1e-8); features 1e-4 of
their largest magnitude; the parameters after one AdamW step 5e-4, plus 2 *
lr where the reference gradient is below 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.parallel import create_mesh, shard_batch, shard_params
from nans_clip_tpu.parallel import pp as jpp
from nans_clip_tpu.training import trainer as jtrainer
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.parallel import mesh
from nans_clip_tpu_torch.parallel import pp as tpp
from nans_clip_tpu_torch.training import trainer
from nans_clip_tpu_torch.utils import checkpoint
from tests import test_torch_pp_worker as worker
from tests.test_trainer import TINY

from test_torch_dp import (TCFG, _as_port, _batch, _check_grads, _check_params, _jax_grads,
                           _jax_step, _mesh, _rn_case)
from test_torch_resnet import _stats_sd, padded_stem

torch.set_num_threads(2)

FSDP_MIN = 1024
TINY4 = dataclasses.replace(TINY, vision=dataclasses.replace(TINY.vision, layers=4),
                            text=dataclasses.replace(TINY.text, num_hidden_layers=4))
FEAT_REL = 1e-4
DROPOUT_SEEDS = [5, 6]
# a clip norm below the gradients' global norm, so that clipping scales them
CLIP_TCFG = dict(TCFG, grad_norm_clip=0.1)


def _port_cfg(jcfg):
    return tconfigs.CLIPConfig(embed_dim=jcfg.embed_dim,
                               vision=tconfigs.VisionConfig(**dataclasses.asdict(jcfg.vision)),
                               text=tconfigs.TextConfig(**dataclasses.asdict(jcfg.text)),
                               name=jcfg.name)


def _jax_ids_keep(rng, n, seq_len, mask_ratio):
    """ids_keep as nans_clip_tpu/models/vit.py:77-79 computes them."""
    len_keep = int((seq_len - 1) * (1 - mask_ratio))
    noise = jax.random.uniform(rng, (n, seq_len - 1))
    return np.array(jnp.argsort(noise, axis=1)[:, :len_keep] + 1)


def _jax_towers(jcfg, params, images, texts, pipe):
    """JAX's pipelined towers on ``create_mesh(data=8 / pipe, pipe=pipe)``."""
    mesh_ = create_mesh(data=8 // pipe, model=1, pipe=pipe)
    opts = JOptions(attn_impl="xla", pp=pipe)
    with jax.set_mesh(mesh_):
        p = shard_params(params, mesh_)
        img = jclip.encode_image(p, jcfg, shard_batch(jnp.asarray(images), mesh_), opts)
        txt = jclip.encode_text(p, jcfg, shard_batch(jnp.asarray(texts), mesh_), opts)
    return np.asarray(img), np.asarray(txt)


def _jax_accum_step(params, images, texts):
    """JAX's one-device step at accum 2 with FLIP 0.5 and remat, its grads
    and (loss, parameters after)."""
    tcfg = jtrainer.TrainConfig(**TCFG, accum_freq=2, mask_ratio=0.5)
    opts = JOptions(attn_impl="xla", deterministic=True, remat=True)
    with jax.set_mesh(_mesh(1)):
        state = jtrainer.create_train_state(jax.tree.map(jnp.copy, params), {}, tcfg)
        step = jtrainer.make_train_step(TINY, tcfg, opts, constrain=False)
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(texts),
                              jax.random.PRNGKey(3))

    def loss_fn(p):
        img_f, txt_f, _ = jtrainer._encode_all(p, TINY, opts, jnp.asarray(images),
                                               jnp.asarray(texts), jax.random.PRNGKey(3), tcfg,
                                               {}, constrain=False)
        scale = jnp.exp(p["logit_scale"].astype(jnp.float32))
        from nans_clip_tpu.parallel import clip_loss
        return clip_loss(jclip.normalize(img_f), jclip.normalize(txt_f), scale,
                         constrain=False)[0]

    grads = jax.jit(jax.grad(loss_fn))(params)
    return float(metrics["loss"]), state, grads


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    """The JAX side here, then every case in one world of 4 gloo ranks."""
    cfg = _port_cfg(TINY)
    params, _ = jax.jit(jclip.init_clip, static_argnums=1)(jax.random.PRNGKey(0), TINY)
    params4, _ = jax.jit(jclip.init_clip, static_argnums=1)(jax.random.PRNGKey(1), TINY4)
    images, texts = _batch()
    jax_side = {"grads": _as_port(_jax_grads(TINY, params, jnp.asarray(images),
                                             jnp.asarray(texts))[1], cfg)}
    loss, state = _jax_step(TINY, params, images, texts, 1, _mesh(1))
    jax_side["step"] = dict(loss=loss, params=_as_port(state.params, cfg))

    # FLIP at accum 2: the tokens JAX's scan draws for each microbatch of 8
    img_rng = jax.random.split(jax.random.PRNGKey(3))[0]
    ids = [_jax_ids_keep(jax.random.fold_in(img_rng, j), 8, TINY.vision.seq_len, 0.5)
           for j in range(2)]
    loss, state, grads = _jax_accum_step(params, images, texts)
    jax_side["accum"] = dict(loss=loss, params=_as_port(state.params, cfg),
                             grads=_as_port(grads, cfg))

    towers = {}
    for pipe, jcfg, p in ((2, TINY, params), (4, TINY4, params4)):
        b_images, b_texts = _batch(8, seed=4)
        b_texts[3, 4:12] = 0
        jax_side[("towers", pipe)] = _jax_towers(jcfg, p, b_images, b_texts, pipe)
        pcfg = _port_cfg(jcfg)
        towers[pipe] = dict(cfg=pcfg, state_dict=_as_port(p, pcfg), images=b_images,
                            texts=b_texts, attn_impl="fused")

    jcfg, rparams, rstats, rn = _rn_case()
    with pytest.MonkeyPatch.context() as mp:
        padded_stem(mp)
        (loss, (_, new_stats)), rgrads = _jax_grads(
            jcfg, rparams, jnp.asarray(rn["images"]), jnp.asarray(rn["texts"]), rstats)
    jax_side["rn50"] = dict(loss=float(loss),
                            stats={k: np.asarray(v) for k, v in _stats_sd(new_stats).items()},
                            grads={k: v for k, v in _as_port(rgrads, rn["cfg"]).items()
                                   if "running_" not in k})

    rs = np.random.RandomState(0)
    bare = dict(x=rs.randn(8, 12, 16).astype(np.float32),
                ws=[(0.3 * rs.randn(16, 16)).astype(np.float32) for _ in range(4)],
                aux=rs.randn(8, 12).astype(np.float32),
                gout=rs.randn(8, 12, 16).astype(np.float32))
    tiny = dict(cfg=cfg, state_dict=_as_port(params, cfg), images=images, texts=texts,
                tcfg=TCFG)
    dropout_module = build_clip(tconfigs.tiny_config(), "cpu", torch.Generator().manual_seed(1))
    tmp = tmp_path_factory.mktemp("pp")
    payload = {"bare": bare, "towers": towers, "step": tiny, "fsdp_min_size": FSDP_MIN,
               "accum": dict(tiny, tcfg=dict(TCFG, accum_freq=2, mask_ratio=0.5), seeds=[3],
                             ids_keep=ids),
               "dropout": dict(cfg=tconfigs.tiny_config(),
                               state_dict={k: v.numpy() for k, v in
                                           dropout_module.state_dict().items()},
                               images=images, texts=texts, tcfg=CLIP_TCFG,
                               seeds=DROPOUT_SEEDS),
               "clip": dict(tiny, tcfg=CLIP_TCFG),
               "rn50": rn, "tmp": str(tmp)}
    ranks = mesh.run_ranks(worker.run_pp, 4, "gloo", str(tmp / "rendezvous"), (payload,),
                           timeout_s=400.0)
    return jax_side, ranks, payload


def test_helpers_match_jax():
    """``pick_microbatches``, ``bubble_fraction`` and ``pp_kernel_batch`` (the
    last with the data size the JAX one reads from its mesh)."""
    for batch in (1, 2, 3, 5, 6, 8, 12, 16, 30, 64, 128, 256):
        for pp in (2, 4, 8):
            assert tpp.pick_microbatches(batch, pp) == jpp.pick_microbatches(batch, pp)
            for m in (0, 1, 2):
                assert tpp.bubble_fraction(batch, pp, m) == jpp.bubble_fraction(batch, pp, m)
    for data, pp in ((1, 2), (2, 2), (4, 2), (2, 4), (1, 8)):
        with jax.set_mesh(create_mesh(data=data, model=1, pipe=pp,
                                      devices=jax.devices()[:data * pp])):
            for gb in (8, 16, 24, 128):
                for m in (0, 2):
                    assert tpp.pp_kernel_batch(gb, pp, m, data) == jpp.pp_kernel_batch(gb, pp, m)
    assert list(tpp.stage_layers(12, 2, 1)) == list(range(6, 12))
    with pytest.raises(ValueError, match="not divisible by pp"):
        tpp.stage_layers(12, 5, 0)


def test_bare_loop_matches_plain_loop(pp_run):
    """4 stages, an aux: the output and the gradients of x and of each
    layer against the plain loop (fp32, 1e-5)."""
    _, ranks, payload = pp_run
    bare = payload["bare"]
    x = torch.from_numpy(bare["x"]).requires_grad_()
    ws = [torch.from_numpy(w).requires_grad_() for w in bare["ws"]]
    kb = torch.from_numpy(bare["aux"])[:, :, None]
    h = x
    for w in ws:
        h = torch.tanh(h @ w) + h + kb
    (h * torch.from_numpy(bare["gout"])).sum().backward()
    for r in ranks:
        got = r["bare"]
        np.testing.assert_allclose(got["out"], h.detach().numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["x_grad"], x.grad.numpy(), atol=1e-5, rtol=1e-5)
        assert sorted(got["w_grads"]) == [0, 1, 2, 3]
        for i, w in enumerate(ws):
            np.testing.assert_allclose(got["w_grads"][i], w.grad.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pipe", [2, 4])
def test_towers_match_jax(pp_run, pipe):
    """Both towers at ``pipe`` stages against JAX's pipelined towers; every
    stage's features equal; a stage stores its layers and the rest."""
    jax_side, ranks, payload = pp_run
    want_i, want_t = jax_side[("towers", pipe)]
    case = payload["towers"][pipe]
    for r in ranks:
        got = r["towers"][pipe]
        assert got["stages_equal"]
        for a, w in ((got["image"], want_i), (got["text"], want_t)):
            assert float(np.abs(a - w).max()) <= FEAT_REL * float(np.abs(w).max())
        assert got["all"] == _numel(case["cfg"])
        assert got["stored"] == _stage_numel(case["cfg"], pipe)


def _numel(cfg, layers_only: bool = False) -> int:
    module = build_clip(cfg)
    return sum(p.numel() for n, p in module.named_parameters()
               if tpp.is_layer(n) or not layers_only)


def _stage_numel(cfg, pipe: int) -> int:
    """What one stage stores: the replicated rest and its L / pp layers."""
    layers = _numel(cfg, True)
    return _numel(cfg) - layers + layers // pipe


def _check_replicated(ranks, key):
    for r in ranks:
        assert r[key]["replicated_equal"], key


@pytest.mark.parametrize("case", ["step", "fsdp"])
def test_pipe2_step_matches_jax(pp_run, case):
    """``data 2 x pipe 2`` (with --fsdp: the stage's leaves sharded over its
    data group) against JAX's one-device step: the loss, every gradient,
    the parameters after AdamW, equal on all 4 ranks; each rank stores its
    stage's layers (over 2 data ranks under FSDP)."""
    jax_side, ranks, _ = pp_run
    ref = jax_side["step"]
    for r in ranks:
        got = r[case]
        assert abs(got["losses"][0] - ref["loss"]) <= 1e-4
        _check_grads(got["grads"], jax_side["grads"])
        _check_params(got["params"], ref["params"], jax_side["grads"])
        stage = _stage_numel(_port_cfg(TINY), 2)
        assert got["stored"] == stage if case == "step" else got["stored"] < stage
    for r in ranks[1:]:
        for name, p in ranks[0][case]["params"].items():
            np.testing.assert_array_equal(p, r[case]["params"][name], err_msg=name)
    _check_replicated(ranks, case)


def test_tp2_remat_step_matches_jax(pp_run):
    """Remat under tensor parallelism (``data 2 x tp 2``: each layer's TP
    sub-blocks and their all-reduces recomputed in the backward) against
    JAX's one-device step."""
    jax_side, ranks, _ = pp_run
    ref = jax_side["step"]
    for r in ranks:
        got = r["tp_remat"]
        assert abs(got["losses"][0] - ref["loss"]) <= 1e-4
        _check_grads(got["grads"], jax_side["grads"])
        _check_params(got["params"], ref["params"], jax_side["grads"])


def test_pipe2_accum_flip_remat_matches_jax(pp_run):
    """``accum_freq`` 2, FLIP 0.5 (JAX's tokens) and remat at ``data 2 x
    pipe 2`` against JAX's one-device step with ``remat=True``."""
    jax_side, ranks, _ = pp_run
    ref = jax_side["accum"]
    for r in ranks:
        got = r["accum"]
        assert abs(got["losses"][0] - ref["loss"]) <= 1e-4
        _check_grads(got["grads"], ref["grads"])
        _check_params(got["params"], ref["params"], ref["grads"])
    _check_replicated(ranks, "accum")


def test_pipe2_text_dropout_matches_one_rank(pp_run):
    """Two steps with text dropout 0.1 at ``data 2 x pipe 2`` against one
    rank of the port: the masks of each microbatch are those one process
    draws at its global rows."""
    _, ranks, payload = pp_run
    one = worker.one_rank(payload["dropout"], ModelOptions(attn_impl="fused",
                                                           deterministic=False))
    for r in ranks:
        got = r["dropout"]
        assert np.abs(np.array(got["losses"]) - np.array(one["losses"])).max() <= 1e-5
        _check_grads(got["grads"], one["grads"])
    _check_replicated(ranks, "dropout")


def test_pipe2_clipping_matches_one_rank(pp_run):
    """Clipping by the global norm at ``data 2 x pipe 2`` with --fsdp (the
    layers' squares summed over the pipe group, the rest once) against one
    rank: the loss, the clipped gradients (their norm the clip's), the
    parameters."""
    _, ranks, payload = pp_run
    one = worker.one_rank(payload["clip"], ModelOptions(attn_impl="fused", deterministic=True))
    norm = float(np.sqrt(sum(float(np.square(g, dtype=np.float64).sum())
                             for g in one["grads"].values())))
    assert abs(norm - CLIP_TCFG["grad_norm_clip"]) <= 1e-5
    for r in ranks:
        got = r["fsdp_clip"]
        assert abs(got["losses"][0] - one["losses"][0]) <= 1e-5
        _check_grads(got["grads"], one["grads"])
        _check_params(got["params"], one["params"], one["grads"])
    _check_replicated(ranks, "fsdp_clip")


@pytest.mark.parametrize("axis", ["pp", "tp"])
def test_rn50_replicated_matches_jax(pp_run, axis):
    """The tiny RN tower at ``data 2 x pipe 2`` and ``data 2 x tp 2``: the
    ResNet runs whole on every rank, the text tower is split; the loss, the
    gradients and the running statistics against JAX's global-batch step,
    the ResNet's parameters and statistics equal on every rank."""
    jax_side, ranks, _ = pp_run
    ref = jax_side["rn50"]
    for r in ranks:
        got = r["rn50"][axis]
        assert abs(got["losses"][0] - ref["loss"]) <= 1e-4
        _check_grads(got["grads"], ref["grads"])
        stats = {k: v for k, v in got["buffers"].items() if "running_" in k}
        assert set(stats) == {f"visual.{k}" for k in ref["stats"]}
        for k, v in stats.items():
            want = ref["stats"][k[len("visual."):]]
            assert float(np.abs(v - want).max()) <= 1e-5 * float(np.abs(want).max()), k
    for r in ranks[1:]:
        for name, p in ranks[0]["rn50"][axis]["params"].items():
            if name.startswith("visual."):
                np.testing.assert_array_equal(p, r["rn50"][axis]["params"][name], err_msg=name)


def test_pipe2_checkpoint_resumes_at_pp1(pp_run):
    """``step_1`` written at ``data 2 x pipe 2`` holds one process's
    state (every parameter and moment); restored in one process, its second
    step continues the pp 2 run (the loss 1e-5; the parameters as against
    JAX, the same gradients summed in another order)."""
    _, ranks, payload = pp_run
    case = payload["dropout"]
    ckpt = f"{payload['tmp']}/ckpt"
    saved = checkpoint.read_state(f"{ckpt}/step_1")
    module = build_clip(case["cfg"])
    assert saved["state_dict"].keys() == module.state_dict().keys()
    n_trainable = sum(1 for p in module.parameters())
    assert len(saved["optimizer"]["state"]) == n_trainable
    tcfg = trainer.TrainConfig(**case["tcfg"])
    state = trainer.create_train_state(module, tcfg, device="cpu")
    state, _ = checkpoint.restore_checkpoint(ckpt, "step_1", state)
    step = trainer.make_train_step(case["cfg"], tcfg, ModelOptions(attn_impl="fused",
                                                                   deterministic=False))
    state, metrics = step(state, torch.from_numpy(case["images"]),
                          torch.from_numpy(case["texts"]), DROPOUT_SEEDS[1])
    got = ranks[0]["dropout"]
    assert abs(float(metrics["loss"]) - got["losses"][1]) <= 1e-5
    grads = {n: p.grad.numpy() for n, p in state.module.named_parameters()}
    _check_grads(got["grads"], grads)
    _check_params({n: p.detach().numpy() for n, p in state.module.named_parameters()},
                  got["params"], grads)


def test_grid_errors(pp_run):
    """On a world of 4: a pp that does not divide it, tp with pp, and a data
    axis that is not the grid's raise with a message."""
    _, ranks, _ = pp_run
    for r in ranks:
        assert "pp=3 but the model group has 4 ranks" in r["errors"]["pp3"]
        assert "mutually exclusive" in r["errors"]["tp_pp"]
        assert "data=4 but the grid of 4 ranks at tp=1, pp=2 has a data axis of 2" in \
            r["errors"]["data"]


def test_options_and_storage_rules():
    """``ModelOptions`` refuses tp with pp; ``localize`` keeps a stage's
    layers and puts the others on the meta device; the stage's optimizer
    state is cut from one process's and joined back."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        ModelOptions(tp=2, pp=2)
    with pytest.raises(ValueError, match="pp_microbatches"):
        ModelOptions(pp=2, pp_microbatches=-1)
    cfg = tconfigs.tiny_config()
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    tpp.localize(module, 2, 1)
    blocks, layers = module.visual.transformer.resblocks, module.bert.encoder.layer
    assert all(p.is_meta for p in blocks[0].parameters())
    assert not any(p.is_meta for p in blocks[1].parameters())
    assert all(p.is_meta for p in layers[0].parameters())
    assert not any(p.is_meta for n, p in module.named_parameters() if not tpp.is_layer(n))
    names = trainer.decay_groups(module)
    local = trainer.stored_groups(module)
    flat = [n for g in names for n in g]
    full_sd = {"state": {i: {"exp_avg": torch.full((1,), float(i))} for i in range(len(flat))},
               "param_groups": [{"lr": 1.0, "params": []}, {"lr": 2.0, "params": []}]}
    cut = tpp.stage_optimizer_state(full_sd, names, local)
    assert [len(g["params"]) for g in cut["param_groups"]] == [len(g) for g in local]
    back = tpp.one_process_indices(cut, local, names)
    for k, st in back["state"].items():
        assert float(st["exp_avg"]) == k and flat[k] in sum(local, [])
    assert back["param_groups"][1]["params"] == [flat.index(n) for n in names[1]]
