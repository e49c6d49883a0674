"""The port's whole-tower twin (``ops/tower_kernel.py::tower_math``) and its
int8 serving mode (``utils/quantize.py``, ``CLIPModel.quantize``) against
the JAX package on the CPU.

Inputs come from numpy seeds. fp32 on both sides:
- the twins against the JAX tower kernel in interpret mode: atol = rtol =
  2e-5, the tolerance of ``tests/test_tower_kernel.py`` (three layers of fp32
  sum-order differences);
- the quantizer: exact (atol 0), int8 values and scales;
- whole quantized models: 2e-4 on features, as ``tests/test_torch_slice.py``
  (two layers a tower and the final projections)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu.ops.tower_kernel import fused_tower as jfused_tower
from nans_clip_tpu.utils import quantize as jq
from nans_clip_tpu_torch.models.common import ModelOptions, cast_module
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops import tower_kernel as tk
from nans_clip_tpu_torch.utils import quantize as tq

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
ORDER = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wo", "bo", "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
LINEAR = ("wqkv", "wo", "w1", "w2")


def _stacked(L, W, I, seed):
    """The JAX test's stacked layer params ([L, in, out] weights)."""
    rs = np.random.RandomState(seed)
    f = lambda *sh: (0.1 * rs.randn(*sh)).astype(np.float32)
    return dict(ln1_s=(1.0 + 0.1 * rs.randn(L, W)).astype(np.float32), ln1_b=f(L, W),
                wqkv=f(L, W, 3 * W), bqkv=f(L, 3 * W), wo=f(L, W, W), bo=f(L, W),
                ln2_s=(1.0 + 0.1 * rs.randn(L, W)).astype(np.float32), ln2_b=f(L, W),
                w1=f(L, W, I), b1=f(L, I), w2=f(L, I, W), b2=f(L, W))


def _port_layers(p, quantize=False):
    """The same params as the port's per-layer tuples ([out, in] weights)."""
    layers = []
    for l in range(p["wqkv"].shape[0]):
        layer = []
        for k in ORDER:
            t = torch.from_numpy(np.ascontiguousarray(p[k][l].T if k in LINEAR else p[k][l]))
            layer.append(tq.quantize_weight(t) if quantize and k in LINEAR else t)
        layers.append(tuple(layer))
    return layers


def _case(post_ln, B, S, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, 128).astype(np.float32)
    kb = None
    if post_ln:
        mask = np.ones((B, S), np.float32)
        mask[:, S - 3:] = 0.0
        mask[0, 4:] = 0.0
        kb = (1.0 - mask) * -10000.0
    return x, kb


# (post_ln, act, B, S): the shapes of tests/test_tower_kernel.py:38-41
CASES = [(False, "quick_gelu", 2, 12), (True, "gelu", 3, 10)]


@pytest.mark.parametrize("post_ln,act,B,S", CASES)
def test_tower_twin_matches_pallas(post_ln, act, B, S):
    p = _stacked(3, 128, 512, seed=0)
    x, kb = _case(post_ln, B, S, 7)
    ref = jfused_tower(jnp.asarray(x), None if kb is None else jnp.asarray(kb).reshape(B, 1, S),
                       *(jnp.asarray(p[k]) for k in ORDER), 4, 1e-5, act, post_ln,
                       interpret=True)
    out = tk.fused_tower(torch.from_numpy(x), None if kb is None else torch.from_numpy(kb),
                         _port_layers(p), 4, 1e-5, act, post_ln)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("post_ln,act,B,S", CASES)
def test_int8_tower_twin_matches_pallas(post_ln, act, B, S):
    """JAX's quantized tower kernel (_tower_kernel_q) on its quantized leaves
    against the port's twin on the port's own quantization of the same
    weights."""
    p = _stacked(3, 128, 512, seed=5)
    x, kb = _case(post_ln, B, S, 11)
    qp = {k: (jq.quantize_weight(jnp.asarray(p[k])) if k in LINEAR else jnp.asarray(p[k]))
          for k in ORDER}
    ref = jfused_tower(jnp.asarray(x), None if kb is None else jnp.asarray(kb).reshape(B, 1, S),
                       *(qp[k] for k in ORDER), 4, 1e-5, act, post_ln, interpret=True)
    layers = _port_layers(p, quantize=True)
    assert all(tq.is_quantized(layer[i]) for layer in layers for i in (2, 4, 8, 10))
    out = tk.fused_tower(torch.from_numpy(x), None if kb is None else torch.from_numpy(kb),
                         layers, 4, 1e-5, act, post_ln)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(96, 160), (3 * 64, 64), (7, 33)])
def test_quantize_weight_equals_jax(shape):
    """Bit for bit: the port quantizes [out, in] over in, JAX [in, out] over
    in. Includes a zero row (the 1e-12 floor) and exact .5 ties."""
    rs = np.random.RandomState(shape[0])
    w = rs.randn(*shape).astype(np.float32)      # port layout [out, in]
    w[0] = 0.0
    w[1, :4] = [127.0, 0.5, -0.5, 1.5]           # scale 1: ties round to even
    jw = jq.quantize_weight(jnp.asarray(w.T))
    q = tq.quantize_weight(torch.from_numpy(w))
    assert q.int8.dtype == torch.int8 and q.scale.dtype == torch.float32
    assert q.scale.shape == (shape[0], 1)
    np.testing.assert_array_equal(q.int8.numpy(), np.asarray(jw["int8"]).T)
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jw["scale"]).T)
    np.testing.assert_array_equal(tq.dequantize_weight(q, torch.float32).numpy(),
                                  np.asarray(jq.dequantize_weight(jw, jnp.float32)).T)


def test_gate_predicate():
    assert gates.fits_tower(52, 768, 12, 3072) and gates.fits_tower(197, 768, 12, 3072)
    assert gates.fits_tower(640, 1024, 16, 4096)
    assert not gates.fits_tower(641, 768, 12, 3072)     # S: a head's K and V in shared memory
    assert not gates.fits_tower(52, 800, 12, 3200)      # W % 64
    assert gates.fits_tower(257, 1280, 16, 5120)        # ViT-H-14: heads of 80, 5 pairs a thread
    assert not gates.fits_tower(257, 1280, 20, 5120)    # W 1280 at heads of 64: 4 pairs a thread
    assert not gates.fits_tower(257, 1536, 16, 6144)    # W > 1280 (heads of 96 too)
    assert not gates.fits_tower(52, 128, 4, 512)        # heads of 32
    assert not gates.fits_tower(52, 768, 12, 3040)      # I % 64
    assert set(gates.TOWER_MAX_BATCH) == {(t, q) for t in ("text", "image")
                                          for q in ("bf16", "int8")}
    assert all(b in (1, 8, 32) for b in gates.TOWER_MAX_BATCH.values())
    # CPU tensors never take the kernel route: they run the twins
    x = torch.zeros(1, 52, 768)
    for quant in (False, True):
        assert not gates.tower_route(x, "auto", "text", 12, 3072, quant)
        assert not gates.tower_route(x, "plain", "text", 12, 3072, quant)
    with pytest.raises(ValueError, match="CUDA"):
        gates.tower_route(x, "kernel", "text", 12, 3072, False)


def _tower_shapes():
    """(S, W, heads, I) of every published tower the tower kernel takes."""
    from nans_clip_tpu_torch.configs import load_config
    shapes = set()
    for name in ("ViT-B-16", "ViT-B-32", "ViT-L-14", "ViT-L-14-336", "ViT-H-14"):
        v = load_config(f"{name}@RBT3-chinese").vision
        shapes.add((v.seq_len, v.width, v.heads, 4 * v.width))
    for name in ("RoBERTa-wwm-ext-base-chinese", "RoBERTa-wwm-ext-large-chinese", "RBT3-chinese"):
        t = load_config(f"ViT-B-16@{name}").text
        shapes.add((52, t.hidden_size, t.num_attention_heads, t.intermediate_size))
    return sorted(sh for sh in shapes if gates.fits_tower(*sh))


@pytest.mark.parametrize("grid", [132, 264])
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("s,w,heads,inter", _tower_shapes())
def test_tower_k_splits(s, w, heads, inter, b, grid):
    """tower.cu's plan for every product of every published tower: each
    (channel tile, token range, split) unit is taken once, in the order the
    kernel walks them, and the splits cut K into slices of at least
    MIN_KSTEPS_PER_SPLIT stages, at most MAX_SPLITS; the token ranges cover
    M once, each within the plan's chunks; a split product never takes a
    second round of units (qkv and fc1 never more than half the grid); the
    row stages that add out's and fc2's partial rows hold them in shared
    memory; the partial sums and counters the wrapper
    allocates hold every split plane and tile; the ring and the staged output
    tile fit the shared memory."""
    m, dh = b * s, w // heads
    for mode in (tk.MODE_BF16, tk.MODE_INT8):
        p = tk.tower_plan(mode, b, s, w, inter, dh, grid)
        bounds = [r * m // p["ranges"] for r in range(p["ranges"] + 1)]
        assert bounds[0] == 0 and bounds[-1] == m
        lengths = [e - a for a, e in zip(bounds, bounds[1:])]
        assert min(lengths) >= 1 and max(lengths) <= p["chunks"] * tk.CHUNK
        assert p["chunks"] <= gates.TOWER_MAX_CHUNKS
        one = max(n for n, _ in p["products"]) // gates.TOWER_TILE * -(-m // tk.CHUNK) <= grid
        assert p["ranges"] == -(-m // ((1 if one else gates.TOWER_MAX_CHUNKS) * tk.CHUNK))
        for i, ((n, k), ks, tiles) in enumerate(zip(p["products"], p["ks"], p["tiles"])):
            assert tiles == n // gates.TOWER_TILE * p["ranges"] and n % gates.TOWER_TILE == 0
            steps = k // gates.TOWER_KSTEP
            assert 1 <= ks <= tk.MAX_SPLITS and (ks == 1 or steps // ks >= tk.MIN_KSTEPS_PER_SPLIT)
            assert ks == 1 or tiles * ks <= (grid // 2 if i in tk.HANDOVER else grid)
            seen = {}
            for u in range(tiles * ks):
                tile, split = u // ks, u % ks
                seen.setdefault(tile, []).append(
                    (split * steps // ks, (split + 1) * steps // ks))
            assert sorted(seen) == list(range(tiles))
            for slices in seen.values():   # the splits of a tile cut K once, in order
                assert [a for a, _ in slices] == [0] + [e for _, e in slices[:-1]]
                assert slices[-1][1] == steps
            if ks > 1:
                assert p["part"] >= ks * m * n
            assert p["sem"] >= 1 + tiles
        assert p["part"] == max([1] + [ks * m * n for ks, (n, _) in zip(p["ks"], p["products"])
                                       if ks > 1])
        ring = tk.RING_BYTES[mode == tk.MODE_INT8]
        slot = (64 * 64 if mode == tk.MODE_INT8 else tk.BOX) + p["chunks"] * tk.BOX
        assert 2 <= p["stages"] <= tk.MAX_STAGES and p["stages"] * slot <= ring
        assert p["chunks"] * tk.CHUNK * (gates.TOWER_TILE + 4) * 4 <= ring
        assert max(p["ks"][1], p["ks"][3]) * w * 4 <= p["smem"]   # the row stages' partial rows
        assert p["smem"] <= gates.SMEM_PER_BLOCK


def _tiny128():
    from nans_clip_tpu import configs as C
    return C.CLIPConfig(
        embed_dim=64,
        vision=C.VisionConfig(embed_dim=64, image_resolution=32, layers=2, width=128,
                              patch_size=16, head_width=32),
        text=C.TextConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=512),
        name="tiny128")


def _models(seed=1):
    """The same random weights in a JAX CLIPModel and the port's."""
    import dataclasses

    from nans_clip_tpu.api import CLIPModel as JModel
    from nans_clip_tpu.models import ModelOptions as JOptions
    from nans_clip_tpu.models.clip import init_clip
    from nans_clip_tpu_torch import configs as tconfigs
    from nans_clip_tpu_torch.api import CLIPModel
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params

    jcfg = _tiny128()
    params, stats = init_clip(jax.random.PRNGKey(seed), jcfg)
    cfg = tconfigs.CLIPConfig(embed_dim=jcfg.embed_dim,
                              vision=tconfigs.VisionConfig(**dataclasses.asdict(jcfg.vision)),
                              text=tconfigs.TextConfig(**dataclasses.asdict(jcfg.text)),
                              name=jcfg.name)
    module = build_clip(cfg)
    module.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return (JModel(jcfg, params, stats, JOptions(attn_impl="fused")),
            CLIPModel(cfg, module, ModelOptions()))


def _inputs(b=3):
    rs = np.random.RandomState(0)
    images = rs.randn(b, 32, 32, 3).astype(np.float32)
    texts = np.zeros((b, 52), np.int32)
    texts[:, 0] = 101
    texts[:, 1:12] = rs.randint(1000, 20000, (b, 11))
    texts[:, 12] = 102
    texts[0, 6:12] = 0
    return images, texts


def test_clipmodel_quantize_matches_jax():
    """CLIPModel.quantize("int8") equals the JAX quantized CLIPModel (which
    routes its int8 tower kernel at this width) on the same weights, and
    leaves the original model unchanged."""
    jm, tm = _models()
    images, texts = _inputs()
    before_img, before_txt = tm.encode_image(images), tm.encode_text(texts)
    jq_model, tq_model = jm.quantize(), tm.quantize()
    assert tq.tower_quantized(tq_model.module, "text") and tq.tower_quantized(tq_model.module,
                                                                              "image")
    np.testing.assert_allclose(tq_model.encode_image(images).numpy(),
                               np.asarray(jq_model.encode_image(images)), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tq_model.encode_text(texts).numpy(),
                               np.asarray(jq_model.encode_text(texts)), atol=2e-4, rtol=2e-4)
    # the original: not quantized, same features, sharing what was not quantized
    assert not tq.tower_quantized(tm.module, "text")
    assert not tq.tower_quantized(tm.module, "image")
    assert torch.equal(tm.encode_image(images), before_img)
    assert torch.equal(tm.encode_text(texts), before_txt)
    assert tq_model.module.text_projection is tm.module.text_projection
    assert tq_model.module.bert.encoder.layer[0].attention.output.LayerNorm.weight is \
        tm.module.bert.encoder.layer[0].attention.output.LayerNorm.weight
    with pytest.raises(ValueError, match="unsupported"):
        tm.quantize("int4")


def test_quantize_errors_modes_and_scales():
    _, tm = _models(seed=2)
    text_only = tm.quantize("int8", towers=("text",))
    assert tq.tower_quantized(text_only.module, "text")
    assert not tq.tower_quantized(text_only.module, "image")
    with pytest.raises(ValueError, match="already int8-quantized"):
        text_only.quantize("int8", towers=("text",))
    with pytest.raises(ValueError, match="unknown towers"):
        tm.quantize("int8", towers=("vision",))
    assert tq.towers_for_mode("int8") == ("text", "image")
    assert tq.towers_for_mode("int8-text") == ("text",)
    with pytest.raises(ValueError, match="unknown quantize mode"):
        tq.towers_for_mode("int4")
    # cast_module casts parameters; the int8 values and fp32 scales are buffers
    q = tm.quantize().module
    cast_module(q, ModelOptions(compute_dtype="bfloat16"))
    w = q.bert.encoder.layer[0].output.dense.weight
    assert w.int8.dtype == torch.int8 and w.scale.dtype == torch.float32
    assert q.visual.transformer.resblocks[0].attn.in_proj_weight.scale.dtype == torch.float32
    assert q.bert.encoder.layer[0].output.dense.bias.dtype == torch.bfloat16
    assert q.text_projection.dtype == torch.bfloat16
    # and back: dequantize_params gives dense weights within half a step
    dq = tq.dequantize_params(tm.quantize().module)
    assert not tq.tower_quantized(dq, "text") and not tq.tower_quantized(dq, "image")
    ref = tm.module.bert.encoder.layer[0].intermediate.dense.weight
    got = dq.bert.encoder.layer[0].intermediate.dense.weight
    assert float((got - ref).detach().abs().max()) <= float(ref.detach().abs().max()) / 127


def test_quantized_model_dequantizes_on_entry_off_the_tower_route():
    """Off the tower route (CPU here) the int8 towers equal the same model
    with the dequantized weights, exactly."""
    _, tm = _models(seed=3)
    q = tm.quantize()
    from nans_clip_tpu_torch.api import CLIPModel
    dq = CLIPModel(q.cfg, tq.dequantize_params(q.module), q.options)
    images, texts = _inputs(2)
    assert torch.equal(q.encode_image(images), dq.encode_image(images))
    assert torch.equal(q.encode_text(texts), dq.encode_text(texts))


def test_create_model_needs_a_card_by_default(monkeypatch):
    """The port runs on the card unless the caller names another device:
    without CUDA, the default raises instead of quietly using the CPU."""
    from nans_clip_tpu_torch import api, configs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.model_from_config(configs.tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.create_model("ViT-B-16@RBT3-chinese")
    m = api.model_from_config(configs.tiny_config(), device="cpu")
    assert m.device.type == "cpu"
