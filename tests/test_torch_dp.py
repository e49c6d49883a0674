"""The data axis of the port's training (``parallel/mesh.py``'s grid,
``parallel/distributed.py``, ``parallel/loss.py::gather_features``,
``parallel/fsdp.py``, the data-parallel step of ``training/trainer.py``,
the synced BatchNorm of ``models/resnet.py`` and the sample offset of
``ops/dropout.py``) on the CPU, fp32, against the JAX package's mesh step
and against the port's one-rank step.

Ranks: one pair of gloo processes runs every data-2 case and one set of 4
runs the ``data 2 x tp 2`` grid (``tests/test_torch_dp_worker.py``, which
imports no JAX); each rank takes its rows of the global batch
(``distributed.rank_rows``). JAX runs the same global batch on
``create_mesh(data=2)`` (``create_mesh(data=2, model=2)`` for the grid) of
the 8 CPU devices (tests/conftest.py).

* The DP step against JAX, deterministic, accum 1 and 2, at
  tests/test_trainer.py's TINY: the loss, every gradient after the
  reduction, the parameters after AdamW; both ranks' parameters bit-equal.
  The grid and FSDP (``fsdp_min_size`` 1024, so that most leaves shard, as
  tests/test_fsdp.py:64) the same way; FSDP's moments, gathered into the
  one-rank layout, against the DP step's.
* FSDP's shards against JAX ``param_spec``: every leaf of
  ViT-B-16@RoBERTa-base and RN50@RBT3 built on the meta device, its JAX
  shape, sharded dimension and shard shape.
* Against one rank with text dropout, FLIP and augmentation:
  tests/test_torch_dp_drop.py.
* RN50 (the tiny RN tower, random BatchNorm, the JAX stem padded as
  tests/test_torch_resnet.py pads it) at data 2 against JAX's global-batch
  statistics: the training-mode features, one step's loss and the running
  statistics after it, equal on both ranks.

Tolerances (tests/test_torch_tp.py's): the loss 1e-4 against JAX (1e-5
against one rank, the same arithmetic in another order); each gradient
1e-4 of its largest magnitude, except the key biases (BERT's and the ResNet
pool's), whose gradient is 0 in exact arithmetic (a shift shared by all
keys) and is held below 1e-8 on both sides; the parameters
after one AdamW step 5e-4, plus 2 * lr on elements whose reference gradient
is below 1e-6 (Adam's first step moves an element by lr * g / (|g| + eps));
FSDP's moments 1e-6 of the DP step's (the same gradients, reduced in
another order). RN50: features within 1e-5 of their largest magnitude, the
running statistics within 1e-5 of theirs.
"""

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
from nans_clip_tpu.parallel import create_mesh, shard_batch, shard_params
from nans_clip_tpu.parallel.mesh import param_shardings
from nans_clip_tpu.training import trainer as jtrainer
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.data.dataset import DataLoader
from nans_clip_tpu_torch.models.clip import CLIP
from nans_clip_tpu_torch.parallel import distributed, fsdp, mesh
from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params
from tests import test_torch_dp_worker as worker
from tests.test_trainer import TINY

from test_torch_resnet import _random_bn, _stats_sd, jax_tiny_rn, padded_stem, port_cfg

torch.set_num_threads(2)

TCFG = dict(lr=1e-3, warmup=1, max_steps=10)
FSDP_MIN = 1024


def _batch(b=16, seed=0, res=32):
    rs = np.random.RandomState(seed)
    images = rs.randn(b, res, res, 3).astype(np.float32)
    texts = np.zeros((b, 52), np.int32)
    texts[:, 0] = 101
    texts[:, 1:12] = rs.randint(1000, 20000, (b, 11))
    texts[:, 12] = 102
    texts[0, 6:12] = 0                     # one shorter text: the key bias matters
    return images, texts


def _as_port(tree, cfg, stats=None):
    return {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, tree), cfg,
        None if stats is None else jax.tree.map(np.asarray, stats)).items()}


def _mesh(data, model=1):
    return create_mesh(data=data, model=model, devices=jax.devices()[:data * model])


def _jax_step(jcfg, params, images, texts, accum, mesh_, fsdp_on=False, stats=None):
    """One JAX ``make_train_step`` on ``mesh_``: (loss, parameters after)."""
    tcfg = jtrainer.TrainConfig(**TCFG, accum_freq=accum)
    xla = JOptions(attn_impl="xla", deterministic=True)
    with jax.set_mesh(mesh_):
        p = jax.tree.map(jnp.copy, params)
        sh = None
        if fsdp_on:
            p = shard_params(p, mesh_, fsdp=True, fsdp_min_size=FSDP_MIN)
        state = jtrainer.create_train_state(p, stats or {}, tcfg)
        if fsdp_on:
            state = jtrainer.shard_train_state(state, mesh_, fsdp=True, fsdp_min_size=FSDP_MIN)
            sh = jtrainer.train_state_shardings(state, mesh_, fsdp=True,
                                                fsdp_min_size=FSDP_MIN)
        step = jtrainer.make_train_step(jcfg, tcfg, xla, state_shardings=sh)
        state, metrics = step(state, shard_batch(jnp.asarray(images), mesh_),
                              shard_batch(jnp.asarray(texts), mesh_), jax.random.PRNGKey(3))
        return float(metrics["loss"]), state


def _jax_grads(jcfg, params, images, texts, stats=None):
    """The loss's gradient (and, with ``stats``, the training-mode features
    and the new statistics of the global batch) in one jitted call."""
    xla = JOptions(attn_impl="xla", deterministic=True)

    def loss_fn(p):
        new_stats = None
        if stats is None:
            img = jclip.encode_image(p, jcfg, images, xla)
        else:
            img, new_stats = jclip.encode_image(p, jcfg, images, xla, batch_stats=stats,
                                                training=True)
        txt = jclip.encode_text(p, jcfg, texts, xla)
        scale = jnp.exp(p["logit_scale"].astype(jnp.float32))
        loss = jclip_loss(jclip.normalize(img), jclip.normalize(txt), scale, constrain=False)[0]
        return loss, (img, new_stats)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def _rn_case():
    """The tiny RN tower with random BatchNorm, its JAX tree and stats."""
    jcfg = jax_tiny_rn()
    params, stats = jax.jit(jclip.init_clip, static_argnums=1)(jax.random.PRNGKey(2), jcfg)
    rs = np.random.RandomState(5)
    params = {**params, "visual": _random_bn(params["visual"], rs)}
    stats = _random_bn(stats, rs)
    cfg = port_cfg(jcfg)
    images, texts = _batch(8, seed=6, res=jcfg.vision.image_resolution)
    case = dict(cfg=cfg, state_dict=_as_port(params, cfg, stats), images=images, texts=texts,
                tcfg=dict(TCFG))
    return jcfg, params, stats, case


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The JAX side here, then the data-2 ranks, the grid's ranks and the
    one-rank references."""
    cfg = tconfigs.CLIPConfig(embed_dim=TINY.embed_dim,
                              vision=tconfigs.VisionConfig(**dataclasses.asdict(TINY.vision)),
                              text=tconfigs.TextConfig(**dataclasses.asdict(TINY.text)),
                              name=TINY.name)
    params, _ = jax.jit(jclip.init_clip, static_argnums=1)(jax.random.PRNGKey(0), TINY)
    images, texts = _batch()
    jax_side = {"grads": _as_port(_jax_grads(TINY, params, jnp.asarray(images),
                                             jnp.asarray(texts))[1], cfg)}
    # JAX's FSDP step is its DP step's arithmetic: FSDP at accum 2 is held
    # against the DP step there
    for accum, fsdp_on in ((1, False), (2, False), (1, True)):
        loss, state = _jax_step(TINY, params, images, texts, accum, _mesh(2), fsdp_on)
        jax_side[("fsdp" if fsdp_on else "jax", accum)] = dict(
            loss=loss, params=_as_port(state.params, cfg))
    jax_side[("fsdp", 2)] = jax_side[("jax", 2)]
    loss, state = _jax_step(TINY, params, images, texts, 1, _mesh(2, 2))
    jax_side["grid"] = dict(loss=loss, params=_as_port(state.params, cfg))

    # RN50: one global forward's features, loss, gradient and statistics
    # (JAX's mesh step computes the same batch statistics, over the global
    # batch)
    jcfg, rparams, rstats, rn = _rn_case()
    with pytest.MonkeyPatch.context() as mp:
        padded_stem(mp)
        (loss, (feats, new_stats)), rgrads = _jax_grads(
            jcfg, rparams, jnp.asarray(rn["images"]), jnp.asarray(rn["texts"]), rstats)
    jax_side["rn50"] = dict(features=np.asarray(feats), loss=float(loss),
                            stats={k: np.asarray(v) for k, v in _stats_sd(new_stats).items()},
                            grads={k: v for k, v in _as_port(rgrads, rn["cfg"]).items()
                                   if "running_" not in k})

    tiny = dict(cfg=cfg, state_dict=_as_port(params, cfg), images=images, texts=texts,
                tcfg=TCFG)
    payload = {"jax": tiny, "fsdp_min_size": FSDP_MIN, "rn50": rn}
    rdv = tmp_path_factory.mktemp("rendezvous")
    ranks = mesh.run_ranks(worker.run_data2, 2, "gloo", str(rdv / "data2"), (payload,),
                           timeout_s=300.0)
    grid = mesh.run_ranks(worker.run_grid, 4, "gloo", str(rdv / "grid"), ({"jax": tiny},),
                          timeout_s=300.0)
    return jax_side, ranks, grid


def _check_grads(got: dict, want: dict, rel: float = 1e-4):
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        if name.endswith(("self.key.bias", "attnpool.k_proj.bias")):
            assert max(float(np.abs(g).max()), float(np.abs(w).max())) <= 1e-8, name
        else:
            assert float(np.abs(g - w).max()) <= rel * float(np.abs(w).max()), name


def _check_params(got: dict, want: dict, grads: dict):
    for name, p in got.items():
        slack = np.where(np.abs(grads[name]) < 1e-6, 2 * TCFG["lr"], 0.0)
        assert (np.abs(p - want[name]) <= 5e-4 + slack).all(), name


def _ranks_equal(ranks, key="params"):
    for name, p in ranks[0][key].items():
        for r in ranks[1:]:
            np.testing.assert_array_equal(p, r[key][name], err_msg=name)


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_step_matches_jax(dp_run, accum):
    """A data-2 step against JAX ``make_train_step`` on ``create_mesh(data=2)``."""
    jax_side, ranks, *_ = dp_run
    ref = jax_side[("jax", accum)]
    for r in ranks:
        got = r["jax"][accum]
        assert abs(got["losses"][0] - ref["loss"]) <= 1e-4
        _check_grads(got["grads"], jax_side["grads"])
        _check_params(got["params"], ref["params"], jax_side["grads"])
    _ranks_equal([r["jax"][accum] for r in ranks])


def test_grid_step_matches_jax(dp_run):
    """``data 2 x tp 2`` in 4 ranks against JAX on ``create_mesh(data=2, model=2)``."""
    jax_side, _, grid, *_ = dp_run
    ref = jax_side["grid"]
    for r in grid:
        assert abs(r["losses"][0] - ref["loss"]) <= 1e-4
        _check_grads(r["grads"], jax_side["grads"])
        _check_params(r["params"], ref["params"], jax_side["grads"])
    _ranks_equal(grid)


@pytest.mark.parametrize("accum", [1, 2])
def test_fsdp_step_matches_jax(dp_run, accum):
    """A data-2 FSDP step against JAX's FSDP step (``fsdp_min_size`` 1024):
    the loss, the gradients gathered from the shards, the parameters; its
    moments, gathered into the one-rank layout, against the DP step's; the
    shards stored in place of the full parameters."""
    jax_side, ranks, *_ = dp_run
    ref = jax_side[("fsdp", accum)]
    for r in ranks:
        got, dp = r["fsdp"][accum], r["jax"][accum]
        assert abs(got["losses"][0] - ref["loss"]) <= 1e-4
        _check_grads(got["grads"], jax_side["grads"])
        _check_params(got["params"], ref["params"], jax_side["grads"])
        assert set(got["moments"]) == set(dp["moments"])
        for name, (m, v) in got["moments"].items():
            dm, dv = dp["moments"][name]
            assert float(np.abs(m - dm).max()) <= 1e-6 * max(float(np.abs(dm).max()), 1e-30) \
                + 1e-12, name
            assert float(np.abs(v - dv).max()) <= 1e-6 * max(float(np.abs(dv).max()), 1e-30) \
                + 1e-18, name
        info = got["fsdp"]
        assert info["shards"] and info["stored_bytes"] < 0.6 * info["full_bytes"]
        for path, shape in info["shards"].items():
            full = info["leaf_shapes"][path]
            assert int(np.prod(shape)) * 2 == int(np.prod(full)), path
    _ranks_equal([r["fsdp"][accum] for r in ranks])


@pytest.mark.parametrize("data,min_size", [(2, None), (4, None), (2, FSDP_MIN)])
@pytest.mark.parametrize("struct", ["ViT-B-16@RoBERTa-wwm-ext-base-chinese",
                                    "RN50@RBT3-chinese"])
def test_fsdp_leaves_match_jax_param_spec(struct, data, min_size):
    """Every leaf of the published model, built on the meta device: the JAX
    path and shape the port assembles its parameters into, the dimension
    it shards over ``data`` and the shard's shape, against JAX
    ``param_shardings(fsdp=True)`` on ``create_mesh(data)``."""
    with torch.device("meta"):
        module = CLIP(tconfigs.load_config(struct))
    leaves = fsdp.jax_leaves(module, data, min_size)
    jcfg = jconfigs.load_config(struct)
    params, _ = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    sh = param_shardings(params, _mesh(data), fsdp=True, fsdp_min_size=min_size)
    want = {}
    for path, node in jax.tree_util.tree_leaves_with_path(sh):
        names = tuple(k.key if hasattr(k, "key") else f"{k.idx}" for k in path)
        want[names] = node
    shapes = {tuple(k.key if hasattr(k, "key") else f"{k.idx}" for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert len(leaves) == len(want)
    named = sum(len(leaf.names) for leaf in leaves)
    assert named == len(list(module.parameters()))
    sharded = 0
    for leaf in leaves:
        key = _jax_key(leaf.path)
        node = want[key]
        assert leaf.shape == tuple(shapes[key]), key
        spec = tuple(node.spec)
        assert leaf.dim == (spec.index("data") if "data" in spec else None), (key, spec)
        assert leaf.shard_shape(data) == tuple(node.shard_shape(shapes[key])), key
        sharded += leaf.dim is not None
    assert sharded > 0


_BERT_EMBEDDINGS = {"word_embeddings": ("word",), "position_embeddings": ("position",),
                    "token_type_embeddings": ("token_type",), "LayerNorm": ("ln",)}


def _jax_key(path):
    """The JAX tree path of a port leaf: the stacked transformer leaves
    carry theirs; elsewhere the module names map to the JAX tree's."""
    p = list(path)
    if tuple(p[:2]) in (("visual", "transformer"), ("bert", "encoder")):
        return tuple(p)
    if p[:2] == ["bert", "embeddings"]:
        p = p[:2] + list(_BERT_EMBEDDINGS[p[2]]) + p[3:]
        if p[2] == "ln":
            p[-1] = "scale" if p[-1] == "weight" else p[-1]
        else:
            p = p[:-1]
        return tuple(p)
    if p[0] == "visual" and len(p) > 2:
        if "downsample" in p:
            i = p.index("downsample")
            p[i + 1] = "conv" if p[i + 1] == "0" else "bn"
        if p[-1] == "weight":
            conv = p[-2].startswith("conv") or p[-2].endswith("_proj")
            p[-1] = "kernel" if conv else "scale"
        if p[1] == "attnpool" and p[2].endswith("_proj"):
            p[2] = p[2][0]
    return tuple(p)


def test_rn50_synced_batchnorm_matches_jax(dp_run):
    """The tiny RN tower at data 2: the training-mode features over the
    global batch, one step's loss and gradients, and the running statistics
    after it against JAX's global-batch statistics; the statistics equal on
    both ranks."""
    jax_side, ranks, *_ = dp_run
    ref = jax_side["rn50"]
    scale = float(np.abs(ref["features"]).max())
    for r in ranks:
        got = r["rn50"]
        assert float(np.abs(got["features"] - ref["features"]).max()) <= 1e-5 * scale
        assert abs(got["train"]["losses"][0] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        _check_grads(got["train"]["grads"], ref["grads"])
        stats = {k: v for k, v in got["train"]["buffers"].items() if "running_" in k}
        assert set(stats) == {f"visual.{k}" for k in ref["stats"]}
        for k, v in stats.items():
            want = ref["stats"][k[len("visual."):]]
            assert float(np.abs(v - want).max()) <= 1e-5 * float(np.abs(want).max()), k
    _ranks_equal([r["rn50"]["train"] for r in ranks], "buffers")


def test_grid_errors(dp_run):
    """On a world of 2: a data axis or a tp that is not the grid's raises
    with a message."""
    _, ranks, *_ = dp_run
    for r in ranks:
        assert "data=3 but the grid of 2 ranks at tp=1 has a data axis of 2" in r["errors"][
            "data3"]
        assert "tp=4 but the model group has 2 ranks" in r["errors"]["tp4"]


def test_rank_rows_and_loader_blocks():
    """``rank_rows`` is block d of every microbatch; the ``blocks`` loader's
    processes' batches concatenate into one process's, the ``strided`` one
    keeps the JAX loader's order."""
    g = np.arange(24)
    assert distributed.rank_rows(g, 1, 2, 2).tolist() == [*range(6, 12), *range(18, 24)]
    assert distributed.rank_rows(torch.arange(8), 0, 2).tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="not divisible"):
        distributed.rank_rows(g, 0, 5, 1)

    class Records:
        def __len__(self):
            return 37

    one = DataLoader(Records(), batch_size=8, seed=3)._indices().reshape(-1, 8)
    blocks = [DataLoader(Records(), batch_size=4, seed=3, process_index=p, process_count=2,
                         layout="blocks")._indices().reshape(-1, 4) for p in range(2)]
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1), one)
    strided = DataLoader(Records(), batch_size=4, seed=3, process_index=1, process_count=2)
    np.testing.assert_array_equal(strided._indices(), one.reshape(-1)[1::2])
    with pytest.raises(ValueError, match="layout"):
        DataLoader(Records(), batch_size=4, layout="rows")


def test_rendezvous_and_backend_rule():
    """The launcher's names (torchrun's and the JAX CLI's) and the backend
    rule; a missing name raises."""
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": "29999", "RANK": "1", "WORLD_SIZE": "2",
           "LOCAL_RANK": "1"}
    assert distributed.rendezvous(env) == ("tcp://localhost:29999", 1, 2, 1)
    assert distributed.launched(env) and not distributed.launched({"WORLD_SIZE": "1"})
    jenv = {"COORDINATOR_ADDRESS": "localhost:1234", "NUM_PROCESSES": "4", "PROCESS_ID": "3"}
    assert distributed.rendezvous(jenv) == ("tcp://localhost:1234", 3, 4, 3)
    with pytest.raises(ValueError, match="PROCESS_ID"):
        distributed.rendezvous({"NUM_PROCESSES": "2"})
    with pytest.raises(ValueError, match="rendezvous"):
        distributed.rendezvous({})
    assert distributed.backend_for("cpu", 2, 0) == "gloo"
    assert distributed.backend_for("cuda", 1, 1) == "nccl"
    assert distributed.backend_for("cuda", 8, 8) == "nccl"
    assert distributed.backend_for("cuda", 2, 1) == "gloo"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.backend_for("cuda", 1, 0)
