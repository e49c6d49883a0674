"""The port's ModifiedResNet image tower (nans_clip_tpu_torch/models/resnet.py)
against the JAX package's (nans_clip_tpu/models/resnet.py and models/clip.py)
on the CPU in fp32, from the same weights and seeded numpy inputs.

The JAX tower's stem convolution (3x3, stride 2) pads with XLA's ``SAME``,
which on an even input pads 0 rows before and 1 after; the reference's
``nn.Conv2d(3, width // 2, 3, stride=2, padding=1)``, which the port
follows, pads 1 on each side. Every comparison of a whole tower therefore
runs the JAX side with its ``conv2d`` wrapped, inside the test, to pad a 3x3
kernel ``((1, 1), (1, 1))`` (the same as ``SAME`` at stride 1);
``test_stem_follows_the_reference_padding`` shows the one difference.

BatchNorm weights, biases and running statistics are drawn at random (the
init's bn3 scale of 0 would hide a block's residual branch). Tolerances:
features and logits within 1e-4 of the reference's largest magnitude; running
statistics within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.models import resnet as jres
from nans_clip_tpu.utils.torch_interop import state_dict_from_params
from nans_clip_tpu_torch import configs
from nans_clip_tpu_torch.models import resnet
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.utils.torch_interop import (_resnet_to_sd, load_torch_state_dict,
                                                     state_dict_from_jax_params)

from ref_loader import TINY_RN_KWARGS, tiny_config

torch.set_num_threads(2)

FEAT_REL = 1e-4
STATS_ATOL = 1e-5
# RN50 at full depth in training mode, batch statistics over 2 images: fp32
# alone moves either package's features from the same tower run in fp64 by
# up to 1.2e-4 of max|ref| at this test's seed (the port 1.15e-4, JAX 0.80e-4;
# a BatchNorm channel whose batch variance is near 0 divides its rounding by
# sqrt(var + 1e-5)), so the two are held to the sum of those, 2e-4
FULL_TRAIN_REL = 2e-4
RN50 = "RN50@RBT3-chinese"


def jax_tiny_rn():
    return tiny_config(TINY_RN_KWARGS)


def port_cfg(jcfg):
    """The port's CLIPConfig of a JAX one (ViT or ResNet)."""
    v = jcfg.vision
    vision = (configs.ResNetConfig if isinstance(v, jconfigs.ResNetConfig) else
              configs.VisionConfig)(**dataclasses.asdict(v))
    return configs.CLIPConfig(embed_dim=jcfg.embed_dim, vision=vision,
                             text=configs.TextConfig(**dataclasses.asdict(jcfg.text)),
                             name=jcfg.name)


def tiny_rn_config():
    """The port's config of ``ref_loader.TINY_RN_KWARGS``: layers (1, 1, 1, 1),
    width 8, 64 px, heads of 32 in the pool, a 2-layer 64-wide text tower."""
    return port_cfg(jax_tiny_rn())


def serve_tiny_rn(monkeypatch, module):
    """Make the CLIs that load through ``eval/model_io.py`` (and the training
    CLI) build ``tiny_rn_config()`` for ``--vision-model RN50``."""
    real = configs.load_config
    pick = lambda struct: tiny_rn_config() if struct.startswith("RN50@") else real(struct)
    monkeypatch.setattr(module, "load_config", pick)


def padded_stem(monkeypatch):
    """The JAX tower with its 3x3 convolutions padded 1 on each side."""
    orig = jres.conv2d

    def conv2d(x, kernel, stride=1, padding="SAME"):
        if kernel.shape[0] == 3 and padding == "SAME":
            padding = ((1, 1), (1, 1))
        return orig(x, kernel, stride, padding)
    monkeypatch.setattr(jres, "conv2d", conv2d)


def _random_bn(tree, rs):
    """A params or stats tree with every BatchNorm leaf redrawn: scales and
    variances in [0.5, 1.5), biases and means in [-0.5, 0.5)."""
    def draw(path, a):
        key = str(path[-1])
        if any(k in key for k in ("scale", "var")):
            return (rs.rand(*a.shape) + 0.5).astype(np.float32)
        if any(k in key for k in ("'bias'", "mean")) and "bn" in jax.tree_util.keystr(path):
            return (rs.rand(*a.shape) - 0.5).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _tower(vcfg, seed=0):
    """(JAX params, JAX stats, the port's tower with the same values)."""
    params, stats = jax.jit(jres.init_resnet, static_argnums=1)(jax.random.PRNGKey(seed), vcfg)
    rs = np.random.RandomState(seed + 1)
    params, stats = _random_bn(params, rs), _random_bn(stats, rs)
    sd = {}
    _resnet_to_sd(params, stats, lambda key, a, transpose=False: sd.__setitem__(
        key[len("visual."):], torch.from_numpy(np.array(a.T if transpose else a, np.float32))))
    with torch.device("meta"):
        tower = resnet.ModifiedResNet(configs.ResNetConfig(**dataclasses.asdict(vcfg)))
    tower = tower.to_empty(device="cpu")
    tower.load_state_dict(sd)
    return params, stats, tower


def _stats_sd(stats):
    """{port buffer name: array} of a JAX stats tree."""
    out = {}

    def put(name, st):
        out[f"{name}.running_mean"], out[f"{name}.running_var"] = st["mean"], st["var"]

    for i in (1, 2, 3):
        put(f"bn{i}", stats[f"bn{i}"])
    for stage in range(1, 5):
        for i, bs in enumerate(stats[f"layer{stage}"]):
            for key, st in bs.items():
                put(f"layer{stage}.{i}." + ("downsample.1" if key == "downsample_bn" else key),
                    st)
    return out


def _close(got, want, rel=FEAT_REL):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _check_stats(tower, stats):
    want = _stats_sd(stats)
    got = {k: v for k, v in tower.state_dict().items() if "running_" in k}
    assert set(got) == set(want)
    for k in want:
        assert float(np.abs(got[k].numpy() - np.asarray(want[k])).max()) <= STATS_ATOL, k


# -- blocks and the pool ------------------------------------------------------

BLOCKS = {"stride1": (32, 8, 1), "stride1-downsample": (16, 8, 1),
          "stride2-downsample": (16, 8, 2)}


@pytest.mark.parametrize("bn_train", [False, True], ids=["running", "batch"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_bottleneck_matches_jax(block, bn_train):
    inplanes, planes, stride = BLOCKS[block]
    p, s = jres.init_bottleneck(jax.random.PRNGKey(1), inplanes, planes, stride)
    rs = np.random.RandomState(2)
    p, s = _random_bn(p, rs), _random_bn(s, rs)
    assert ("downsample" in p) == (block != "stride1")
    x = rs.randn(3, 8, 8, inplanes).astype(np.float32)
    want, new_s = jres.bottleneck(jnp.asarray(x), p, s, stride, bn_train, None)

    conv = lambda k: torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    w = {}
    for j in (1, 2, 3):
        w[f"b.conv{j}.weight"] = conv(p[f"conv{j}"]["kernel"])
    bns = [(f"bn{j}", p[f"bn{j}"], s[f"bn{j}"]) for j in (1, 2, 3)]
    if "downsample" in p:
        w["b.downsample.0.weight"] = conv(p["downsample"]["conv"]["kernel"])
        bns.append(("downsample.1", p["downsample"]["bn"], s["downsample_bn"]))
    for key, bp, bs in bns:
        w.update({f"b.{key}.weight": t(bp["scale"]), f"b.{key}.bias": t(bp["bias"]),
                  f"b.{key}.running_mean": t(bs["mean"]), f"b.{key}.running_var": t(bs["var"])})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resnet.bottleneck(xt, w, "b", stride, bn_train, True).permute(0, 2, 3, 1)
    _close(got, want)
    new_s = dict(new_s, **({"downsample.1": new_s.pop("downsample_bn")} if "downsample" in p
                           else {}))
    for key, _, bs in bns:
        for field, name in (("mean", "running_mean"), ("var", "running_var")):
            diff = float(np.abs(w[f"b.{key}.{name}"].numpy() - np.asarray(new_s[key][field])).max())
            assert diff <= STATS_ATOL, (key, field, diff)
            if not bn_train:
                assert np.array_equal(w[f"b.{key}.{name}"].numpy(), np.asarray(bs[field]))


def test_attention_pool_matches_jax():
    c, embed, heads = 64, 32, 4
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 3, c).astype(np.float32)
    std = c ** -0.5
    p = {"positional_embedding": rs.randn(10, c).astype(np.float32) * std}
    for name, out in (("q", c), ("k", c), ("v", c), ("c", embed)):
        p[name] = {"kernel": rs.randn(c, out).astype(np.float32) * std,
                   "bias": rs.randn(out).astype(np.float32) * 0.1}
    want = jres.attention_pool(jnp.asarray(x), p, heads)
    w = {"attnpool.positional_embedding": torch.from_numpy(p["positional_embedding"])}
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("c", "c_proj")):
        w[f"attnpool.{theirs}.weight"] = torch.from_numpy(p[ours]["kernel"].T.copy())
        w[f"attnpool.{theirs}.bias"] = torch.from_numpy(p[ours]["bias"])
    got = resnet.attention_pool(torch.from_numpy(x).permute(0, 3, 1, 2), w, heads)
    _close(got, want)


# -- the whole tower ----------------------------------------------------------

TOWERS = {"tiny": lambda: jax_tiny_rn().vision,
          "rn50-full-width": lambda: jconfigs.load_config(RN50).vision}


@pytest.mark.parametrize("bn_train", [False, True], ids=["inference", "training"])
@pytest.mark.parametrize("case", list(TOWERS))
def test_tower_matches_jax(case, bn_train, monkeypatch):
    """The tiny config and RN50's full widths (layers [3, 4, 6, 3], width 64,
    2,048 features, 32 heads, embed 1024) at batch 2 and their resolution."""
    padded_stem(monkeypatch)
    vcfg = TOWERS[case]()
    params, stats, tower = _tower(vcfg)
    r = vcfg.image_resolution
    x = np.random.RandomState(4).randn(2, r, r, 3).astype(np.float32)
    want, new_stats = jax.jit(lambda p, s, im: jres.resnet_features(p, s, im, vcfg,
                                                                    training=bn_train))(
        params, stats, jnp.asarray(x))
    with torch.no_grad():
        got = tower(torch.from_numpy(x), bn_train=bn_train)
    assert got.shape == (2, vcfg.embed_dim)
    _close(got, want, FULL_TRAIN_REL if bn_train and case != "tiny" else FEAT_REL)
    _check_stats(tower, new_stats)


def test_stem_follows_the_reference_padding():
    """The port's stride-2 stem equals ``nn.Conv2d(3, w // 2, 3, stride=2,
    padding=1, bias=False)`` on the same weight, and differs from the JAX
    tower's unpatched ``SAME`` stem, which pads 0 before and 1 after."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 64, 64, 3).astype(np.float32)
    k = rs.randn(3, 3, 3, 4).astype(np.float32)
    weight = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resnet.conv(xt, weight.to(memory_format=torch.channels_last), 2)
    ref = torch.nn.Conv2d(3, 4, 3, stride=2, padding=1, bias=False)
    with torch.no_grad():
        ref.weight.copy_(weight)
        assert torch.allclose(got, ref(xt), atol=1e-5, rtol=0)
    same = np.asarray(jres.conv2d(jnp.asarray(x), jnp.asarray(k), stride=2))
    assert same.shape == tuple(got.permute(0, 2, 3, 1).shape)
    assert float(np.abs(got.permute(0, 2, 3, 1).numpy() - same).max()) > 1.0


# -- the CLIP, the state dict ---------------------------------------------------

def _tiny_clip(seed=0):
    """(JAX cfg, params, stats, the port's CLIP with the same values)."""
    jcfg = jax_tiny_rn()
    params, stats = jax.jit(jclip.init_clip, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    rs = np.random.RandomState(seed + 7)
    params = jax.tree.map(np.asarray, params)
    params["visual"] = _random_bn(params["visual"], rs)
    stats = _random_bn(stats, rs)
    module = build_clip(port_cfg(jcfg))
    module.load_state_dict(state_dict_from_jax_params(params, module.cfg, stats))
    return jcfg, params, stats, module


def test_similarity_matches_jax(monkeypatch):
    padded_stem(monkeypatch)
    jcfg, params, stats, module = _tiny_clip()
    rs = np.random.RandomState(6)
    images = rs.randn(3, 64, 64, 3).astype(np.float32)
    texts = np.zeros((3, 52), np.int64)
    texts[:, 0], texts[:, 1:9], texts[:, 9] = 101, rs.randint(1000, 20000, (3, 8)), 102
    want = jax.jit(lambda p, s, im, tx: jclip.get_similarity(p, jcfg, im, tx, batch_stats=s))(
        params, stats, jnp.asarray(images), jnp.asarray(texts))
    with torch.no_grad():
        got = module.get_similarity(torch.from_numpy(images), torch.from_numpy(texts))
    for g, w in zip(got, want):
        _close(g, w)


def test_state_dict_round_trip(tmp_path):
    """JAX (params, stats) -> the port -> ``state_dict()`` equals the JAX
    export ``state_dict_from_params`` key for key; a reference-style ``.pt``
    whose BatchNorms carry ``num_batches_tracked`` loads strictly, through
    ``load_torch_state_dict``, ``model_from_config`` and ``api.load``."""
    from nans_clip_tpu_torch.api import load, model_from_config

    jcfg, params, stats, module = _tiny_clip(seed=1)
    want = state_dict_from_params(params, jcfg, stats)
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v, np.float32)), k
    sd = {f"module.{k}": v for k, v in got.items()}
    for k in list(got):
        if k.endswith("running_var"):
            sd[f"module.{k[:-len('running_var')]}num_batches_tracked"] = torch.tensor(7)
    path = str(tmp_path / "rn.pt")
    torch.save({"state_dict": sd}, path)
    fresh = build_clip(module.cfg)
    fresh.load_state_dict(load_torch_state_dict(path), strict=True)
    loaded = model_from_config(module.cfg, path, device="cpu")
    # api.load: the image tower, its statistics included, from the .pt
    merged = load(model_from_config(module.cfg, device="cpu"), clip_path=path)
    assert all(torch.equal(merged.module.state_dict()[k], v) for k, v in got.items()
               if k.startswith("visual."))
    for m in (fresh, loaded.module):
        assert all(torch.equal(m.state_dict()[k], v) for k, v in got.items())
    images = np.random.RandomState(8).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        assert torch.equal(loaded.encode_image(images),
                           module.encode_image(torch.from_numpy(images)))


def test_init_and_modes():
    """``init_weights`` resets the running statistics (the modules are built
    on the meta device, whose ``to_empty`` leaves garbage); the default mode
    reads them and leaves them, whatever ``module.training`` says; a training
    forward updates them only with ``bn_update``; a ResNet runs whole under
    tensor parallelism (no share of it per rank) and ignores FLIP masking."""
    cfg = tiny_rn_config()
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0)).train()
    bufs = dict(module.visual.named_buffers())
    assert all(float(b.abs().max()) == 0.0 for n, b in bufs.items() if n.endswith("mean"))
    assert all(bool((b == 1).all()) for n, b in bufs.items() if n.endswith("var"))
    assert all(not m.weight.detach().any() for n, m in module.visual.named_modules()
               if n.endswith(".bn3"))
    assert module.visual.conv2.weight.is_contiguous(memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.RandomState(9).randn(4, 64, 64, 3).astype(np.float32))
    before = {n: b.clone() for n, b in bufs.items()}
    with torch.no_grad():
        a = module.encode_image(x)
        b = module.encode_image(x, mask_ratio=0.5, generator=torch.Generator())
        module.encode_image(x, bn_train=True, bn_update=False)
        assert all(torch.equal(before[n], bufs[n]) for n in bufs)
        module.encode_image(x, bn_train=True)
    assert torch.equal(a, b)
    assert not all(torch.equal(before[n], bufs[n]) for n in bufs)
    # under tp (and pp) the ResNet runs whole on every rank, as in JAX: the
    # same features, and no parameter of it is a per-rank share
    with torch.no_grad():
        assert torch.equal(module.encode_image(x, ModelOptions(tp=2)), module.encode_image(x))
    shares = {id(t) for t in module.tp_partial_parameters()}
    assert shares == {id(t) for layer in module.bert.encoder.layer
                      for t in layer.tp_partial_parameters()}
    assert not shares & {id(t) for t in module.visual.parameters()}


def test_quantize_leaves_the_resnet_tower():
    """``quantize("int8")`` quantizes the text tower only, as the JAX
    ``quantize_for_serving`` leaves a ResNet tower; its mode is then
    ``int8-text``."""
    from nans_clip_tpu_torch.api import model_from_config
    from nans_clip_tpu_torch.utils.quantize import quantize_mode

    model = model_from_config(tiny_rn_config(), device="cpu")
    q = model.quantize("int8")
    assert quantize_mode(q.module) == "int8-text" and quantize_mode(model.module) is None
    assert all(a is b for a, b in zip(model.module.visual.parameters(),
                                      q.module.visual.parameters()))
    images = np.random.RandomState(10).randn(2, 64, 64, 3).astype(np.float32)
    assert torch.equal(q.encode_image(images), model.encode_image(images))
