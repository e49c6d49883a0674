"""The ``attn_impl="pallas"`` route of the port against the JAX package on
the CPU, fp32: the twins of the flash attention kernels #22 (``_fwd_kernel``:
o and lse) and #23 (``_bwd_kernel``) against the Pallas kernels in interpret
mode, the autograd Function against ``jax.grad``, ``mha``,
``flash_attention_block`` and ``pallas_layer_norm`` (#24) against their JAX
functions, the towers under ``pallas`` against the JAX towers under
``pallas``, and the ``attn_impl`` / ``--precision`` values and the
whole-layer backward's route against the JAX package's.

The JAX towers call ``attention_pallas`` without ``interpret``; each test
that runs them replaces that module attribute with one that forces
interpret mode, as ``tests/test_parity_reference.py:80-103`` does. Nothing
in the JAX package changes.

Tolerances are the JAX package's own tests' (``tests/test_ops.py``): the
forward 2e-5, gradients atol 5e-5 / rtol 5e-4, LayerNorm 1e-5 (fp32 sums in
another order); the towers 2e-4, as ``tests/test_torch_slice.py``."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.ops import attention as jattn
from nans_clip_tpu.ops import fused_block as jfb
from nans_clip_tpu.ops import layer_bwd as jlayer_bwd
from nans_clip_tpu.ops.layernorm import pallas_layer_norm as jpallas_layer_norm
from nans_clip_tpu_torch.models.common import PRECISIONS, ModelOptions, compute_dtype_for
from nans_clip_tpu_torch.ops import attention as A
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops.layernorm import pallas_layer_norm
from tests.test_torch_slice import _cut, _setup
from tests.test_torch_wide import PUBLISHED

torch.set_num_threads(2)

T = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-5, rtol=5e-4)

# (B, H, S, dh, masked): tests/test_ops.py:18-38's shapes, a padded
# multi-block one (S = 130 -> two 128-row blocks) and ViT-L-14-336's S.
SHAPES = [(2, 4, 52, 64, True), (2, 12, 197, 64, True), (1, 16, 80, 80, True),
          (2, 4, 197, 64, False), (1, 2, 130, 64, False), (1, 2, 577, 64, False)]


@pytest.fixture
def interpret(monkeypatch):
    """The JAX towers' ``attention_pallas`` in interpret mode."""
    orig = jattn.attention_pallas

    def forced(q, k, v, key_bias=None, block_q=128, interpret=False):
        return orig(q, k, v, key_bias, block_q, interpret=True)
    monkeypatch.setattr(jattn, "attention_pallas", forced)


def _qkv(shape, seed):
    b, h, s, dh, masked = shape
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, s, dh).astype(np.float32) for _ in range(3))
    bias = None
    if masked:
        lens = np.linspace(s // 2, s, b).astype(np.int32)
        bias = np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -10000.0).astype(np.float32)
    return q, k, v, bias


def _jax_fwd(q, k, v, bias, block_q=128):
    """``_flash_fwd_call`` as ``attention_pallas`` pads for it: (o, lse)
    unpadded."""
    b, _, s, _ = q.shape
    sp = -(-s // block_q) * block_q
    pad4 = ((0, 0), (0, 0), (0, sp - s), (0, 0))
    bias = np.zeros((b, s), np.float32) if bias is None else bias
    bias_p = jnp.pad(jnp.asarray(bias), ((0, 0), (0, sp - s)), constant_values=jattn.NEG_INF)
    o, lse = jattn._flash_fwd_call(*(jnp.pad(jnp.asarray(t), pad4) for t in (q, k, v)),
                                   bias_p[:, None, :], block_q, True)
    return np.asarray(o)[:, :, :s], np.asarray(lse)[:, :, 0, :s]


@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_twin_matches_pallas(shape):
    q, k, v, bias = _qkv(shape, 0)
    o_j, lse_j = _jax_fwd(q, k, v, bias)
    o, lse = A.attention_pallas_plain(T(q), T(k), T(v), None if bias is None else T(bias))
    np.testing.assert_allclose(o.numpy(), o_j, **FWD)
    np.testing.assert_allclose(lse.numpy(), lse_j, **FWD)
    assert lse.shape == shape[:3]


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_twin_matches_pallas(shape):
    """#23's twin from the same o and lse as ``_flash_bwd_call``; the
    padded rows carry do = 0, as the JAX vjp gives them."""
    q, k, v, bias = _qkv(shape, 1)
    b, h, s, dh, _ = shape
    do = np.random.RandomState(2).randn(b, h, s, dh).astype(np.float32)
    sp = -(-s // 128) * 128
    pad4 = ((0, 0), (0, 0), (0, sp - s), (0, 0))
    bias0 = np.zeros((b, s), np.float32) if bias is None else bias
    bias_p = jnp.pad(jnp.asarray(bias0), ((0, 0), (0, sp - s)),
                     constant_values=jattn.NEG_INF)[:, None, :]
    qp, kp, vp, dop = (jnp.pad(jnp.asarray(t), pad4) for t in (q, k, v, do))
    o_p, lse_p = jattn._flash_fwd_call(qp, kp, vp, bias_p, 128, True)
    grads_j = jattn._flash_bwd_call(qp, kp, vp, bias_p, o_p, dop, lse_p, True)
    o, lse = np.asarray(o_p)[:, :, :s], np.asarray(lse_p)[:, :, 0, :s]
    grads = A.attention_pallas_bwd_plain(T(q), T(k), T(v), None if bias is None else T(bias),
                                         T(o), T(do), T(lse))
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, :s], **GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(2, 4, 52, 64, True), (1, 2, 130, 64, False)])
def test_function_grads_match_jax_grad(shape):
    """The autograd Function (#22 forward, #23 backward) against
    ``jax.grad`` of ``sum(sin(attention_pallas))`` (tests/test_ops.py:41-80)."""
    q, k, v, bias = _qkv(shape, 3)
    jb = None if bias is None else jnp.asarray(bias)

    def f(q, k, v):
        return jnp.sum(jnp.sin(jattn.attention_pallas(q, k, v, jb, interpret=True)))
    g_j = jax.grad(f, (0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    ts = [T(t).requires_grad_() for t in (q, k, v)]
    out = A.attention_pallas(*ts, None if bias is None else T(bias))
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(float(torch.sin(out).sum().detach()), float(f(q, k, v)),
                               rtol=1e-5)
    for name, t, want in zip(("q", "k", "v"), ts, g_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD, err_msg=name)


def test_masked_keys_get_zero_attention():
    """tests/test_ops.py:83-95: with keys 40.. masked for sample 0, changing
    k/v at key 45 leaves sample 0's output and changes sample 1's."""
    rs = np.random.RandomState(0)
    q, k, v = (T(rs.randn(2, 2, 52, 64)) for _ in range(3))
    bias = torch.zeros(2, 52)
    bias[0, 40:] = -10000.0
    out1 = A.attention_pallas(q, k, v, bias)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 45] = 99.0
    v2[:, :, 45] = -99.0
    out2 = A.attention_pallas(q, k2, v2, bias)
    np.testing.assert_allclose(out1[0].numpy(), out2[0].numpy(), atol=1e-5)
    assert float((out1[1] - out2[1]).abs().max()) > 1e-3


def test_mha_matches_jax(interpret):
    """``mha(impl="pallas")`` and ``impl="xla"`` against the JAX ``mha``
    (tests/test_ops.py:112-124); the port's weights are in the Linear
    layout, the transposes of the JAX params."""
    rs = np.random.RandomState(4)
    d, heads = 64, 4
    p = {"wqkv": rs.randn(d, 3 * d) * 0.1, "bqkv": rs.randn(3 * d) * 0.1,
         "wo": rs.randn(d, d) * 0.1, "bo": rs.randn(d) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rs.randn(2, 52, d).astype(np.float32)
    bias = np.zeros((2, 52), np.float32)
    bias[1, 30:] = -10000.0
    for impl in ("pallas", "xla"):
        want = jattn.mha(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, heads,
                         jnp.asarray(bias), impl=impl)
        got = A.mha(T(x), T(p["wqkv"].T), T(p["bqkv"]), T(p["wo"].T), T(p["bo"]), heads,
                    T(bias), impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD, err_msg=impl)


def test_flash_attention_block_matches_jax():
    """Values and all 7 gradients against the JAX ``flash_attention_block``
    in interpret mode at tests/test_ops.py:127-161's shape and tolerances."""
    b, s, w, heads = 2, 130, 128, 2
    rs = np.random.RandomState(5)
    args = [rs.randn(b, s, w), 1.0 + 0.1 * rs.randn(w), 0.1 * rs.randn(w),
            0.1 * rs.randn(w, 3 * w), 0.1 * rs.randn(3 * w), 0.1 * rs.randn(w, w),
            0.1 * rs.randn(w)]
    args = [a.astype(np.float32) for a in args]

    def ours_j(*a):
        return jnp.sum(jnp.sin(jattn.flash_attention_block(*a, heads, 1e-5, 128, True)))
    want = ours_j(*(jnp.asarray(a) for a in args))
    g_j = jax.grad(ours_j, tuple(range(7)))(*(jnp.asarray(a) for a in args))
    # the port takes wqkv and wo in the Linear layout
    ts = [T(a.T if i in (3, 5) else a).requires_grad_() for i, a in enumerate(args)]
    out = torch.sin(A.flash_attention_block(*ts, heads, 1e-5, 128)).sum()
    out.backward()
    np.testing.assert_allclose(float(out), float(want), rtol=1e-5)
    for i, (name, t, gj) in enumerate(zip("x scale bias wqkv bqkv wo bo".split(), ts, g_j)):
        got = t.grad.numpy().T if i in (3, 5) else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(gj), **GRAD, err_msg=name)


def test_pallas_layer_norm_matches_jax():
    rs = np.random.RandomState(6)
    x = rs.randn(3, 100, 512).astype(np.float32)
    scale = (rs.randn(512) * 0.1 + 1.0).astype(np.float32)
    bias = (rs.randn(512) * 0.1).astype(np.float32)
    want = jpallas_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                              interpret=True)
    got = pallas_layer_norm(T(x), T(scale), T(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        pallas_layer_norm(T(x), T(scale), T(bias), block_rows=0)


@pytest.mark.parametrize("case", ["tiny", "base-width-2-layers"])
def test_pallas_towers_match_jax(case, interpret):
    """The towers with ``attn_impl="pallas"`` against the JAX towers with
    ``attn_impl="pallas"`` (both running the flash attention: the port's
    twins, JAX's kernel in interpret mode), features at 2e-4."""
    if case == "tiny":
        jcfg = jconfigs.tiny_config()
    else:
        jcfg = _cut(jconfigs.load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese"), 2)
    params, model, images, ids = _setup(jcfg, batch=2, seed=8)
    opts = ModelOptions(attn_impl="pallas")
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images), opts)
        txt = model.encode_text(torch.from_numpy(ids).long(), opts)
    jopts = JOptions(attn_impl="pallas")
    np.testing.assert_allclose(img.numpy(), np.asarray(
        jclip.encode_image(params, jcfg, images, jopts)), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(txt.numpy(), np.asarray(
        jclip.encode_text(params, jcfg, ids, jopts)), atol=2e-4, rtol=2e-4)


def test_every_attn_impl_value_is_accepted(tmp_path):
    from nans_clip_tpu_torch import configs as tconfigs
    from nans_clip_tpu_torch.deploy import server, speed_benchmark
    from nans_clip_tpu_torch.eval.model_io import load_eval_model

    for impl in ("auto", "xla", "pallas", "fused", "plain", "kernel"):
        assert ModelOptions(attn_impl=impl).attn_impl == impl
        m = load_eval_model("", "", None, "fp32", attn_impl=impl, cfg=tconfigs.tiny_config(),
                            device="cpu")
        assert m.options.attn_impl == impl
        for cli in (server, speed_benchmark):
            assert cli.parse_args(["--attn-impl", impl]).attn_impl == impl
    with pytest.raises(ValueError, match="attn_impl"):
        ModelOptions(attn_impl="flash")
    with pytest.raises(SystemExit):
        speed_benchmark.parse_args(["--attn-impl", "flash"])


def test_every_precision_value_maps_as_jax():
    """``amp|fp16|bf16|fp32``: every value but fp32 runs in bf16
    (nans_clip_tpu/eval/model_io.py:44), through ``load_eval_model`` and
    both CLIs."""
    from nans_clip_tpu_torch import configs as tconfigs
    from nans_clip_tpu_torch.deploy import server, speed_benchmark
    from nans_clip_tpu_torch.eval.model_io import load_eval_model

    assert set(PRECISIONS) == {"amp", "fp16", "bf16", "fp32"}
    for precision in PRECISIONS:
        want = None if precision == "fp32" else "bfloat16"
        assert compute_dtype_for(precision) == want
        m = load_eval_model("", "", None, precision, cfg=tconfigs.tiny_config(), device="cpu")
        assert m.options.compute_dtype == want
        for cli in (server, speed_benchmark):
            assert cli.parse_args(["--precision", precision]).precision == precision
    with pytest.raises(ValueError, match="precision"):
        compute_dtype_for("int4")


def test_xla_and_fused_equal_plain_and_auto_on_the_cpu():
    """On CPU tensors ``xla`` runs what ``plain`` runs and ``fused`` what
    ``auto`` runs: bit-equal features."""
    jcfg = jconfigs.tiny_config()
    _, model, images, ids = _setup(jcfg, batch=3, seed=9)
    feats = {}
    with torch.no_grad():
        for impl in ("plain", "xla", "auto", "fused"):
            opts = ModelOptions(attn_impl=impl)
            feats[impl] = (model.encode_image(torch.from_numpy(images), opts),
                           model.encode_text(torch.from_numpy(ids).long(), opts))
    for a, b in (("xla", "plain"), ("fused", "auto")):
        assert all(torch.equal(x, y) for x, y in zip(feats[a], feats[b])), (a, b)


def test_routes_of_each_impl():
    x = torch.zeros(2, 3)
    for impl in ("auto", "plain", "xla", "pallas", "fused"):
        assert not gates.use_kernel(x, impl)
        assert gates.pallas_route(impl) == (impl == "pallas")
    assert gates.pallas_attention_route(x, "pallas", gates.MAX_PALLAS_SEQ, False)
    assert not gates.pallas_attention_route(x, "pallas", gates.MAX_PALLAS_SEQ + 1, False)
    assert not gates.pallas_attention_route(x, "pallas", 52, True)
    assert not gates.pallas_attention_route(x, "fused", 52, False)
    assert gates.MAX_PALLAS_SEQ == 1024 == jattn.MAX_PALLAS_SEQ
    with pytest.raises(ValueError, match="attn_impl"):
        gates.pallas_attention_route(x, "flash", 52, False)


@pytest.mark.parametrize("with_dropout", [False, True])
def test_fused_attention_routes_as_jax(with_dropout, monkeypatch):
    """Under ``pallas`` the flash attention runs up to S = 1024 with no
    attention dropout; above, or under dropout, the plain attention, as
    ``fused_attention`` routes (nans_clip_tpu/ops/attention.py:337-341)."""
    from nans_clip_tpu_torch.ops import dropout as drop

    calls = []
    monkeypatch.setattr(A, "attention_pallas", lambda *a, **k: calls.append("flash") or a[0])
    monkeypatch.setattr(A, "attention_xla", lambda *a, **k: calls.append("plain") or a[0])
    spec = drop.Dropout(3, 0.1, drop.STREAM_ATTN) if with_dropout else None
    for s in (52, 1024, 1025):
        q = torch.zeros(1, 1, s, 64)
        A.fused_attention(q, q, q, None, "pallas", spec)
    assert calls == (["plain"] * 3 if with_dropout else ["flash", "flash", "plain"])


def test_layer_bwd_route_matches_the_jax_gate():
    """``bwd_impl="layer"`` takes #21 only where the JAX tower would
    (nans_clip_tpu/models/vit.py:266-271: #1, the one-shot MLP and
    ``fits_layer_bwd_fullgrad``), at every published shape; the wide layers
    (ViT-L, ViT-H, S = 577) take the sub-block Functions."""
    w_train = [torch.zeros(1, requires_grad=True)]
    published = sorted(set(PUBLISHED) | {(50, 768, 12)})
    for (s, w, h), impl in itertools.product(published, ("layer", "auto", "fullgrad")):
        jax_takes = (jfb.fits_fused(s, w) and jfb.fits_fused_mlp(s, w)
                     and jlayer_bwd.fits_layer_bwd_fullgrad(s, w, h, 4 * w))
        asked = impl == "layer" or (impl == "auto" and gates.LAYER_BWD_ROUTE)
        assert gates.layer_bwd_route(impl, w_train, s, w, h, 4 * w) == (asked and jax_takes), \
            (s, w, h, impl)
        for esize in (2, 4):
            assert gates.fits_layer_bwd_fullgrad(s, w, h, 4 * w, esize) == \
                jlayer_bwd.fits_layer_bwd_fullgrad(s, w, h, 4 * w, esize)
    assert gates.layer_bwd_route("layer", w_train, 197, 768, 12, 3072)
    for s, w in ((257, 1024), (577, 1024), (257, 1280)):
        assert not gates.layer_bwd_route("layer", w_train, s, w, 16, 4 * w)
    frozen = [torch.zeros(1)]
    assert not gates.layer_bwd_route("layer", frozen, 197, 768, 12, 3072)


def test_pallas_train_forward_uses_the_function():
    """A training forward on the route differentiates through #23's twin:
    the image tower's gradients under ``pallas`` equal ``plain``'s within
    fp32 noise, and the flash Function is on the graph."""
    from nans_clip_tpu_torch import configs as tconfigs
    from nans_clip_tpu_torch.models.clip import build_clip

    cfg = tconfigs.tiny_config()
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
    images = torch.randn(2, cfg.vision.image_resolution, cfg.vision.image_resolution, 3,
                         generator=torch.Generator().manual_seed(1))
    grads = {}
    for impl in ("plain", "pallas"):
        module.zero_grad()
        out = module.encode_image(images, ModelOptions(attn_impl=impl, deterministic=False))
        if impl == "pallas":
            seen, todo = {}, [out.grad_fn]
            while todo:
                fn = todo.pop()
                if fn is not None and id(fn) not in seen:
                    seen[id(fn)] = type(fn).__name__
                    todo.extend(f for f, _ in fn.next_functions)
            assert sum(n == "_FlashAttentionBackward" for n in seen.values()) == \
                cfg.vision.layers
        out.square().sum().backward()
        grads[impl] = {n: p.grad.clone() for n, p in module.visual.named_parameters()
                       if p.grad is not None}
    for n, g in grads["plain"].items():
        torch.testing.assert_close(grads["pallas"][n], g, atol=1e-5 * float(g.abs().max()) + 1e-7,
                                   rtol=1e-4)


def test_flash_wrappers_refuse_what_the_kernel_does_not_take():
    """On a CPU tensor the wrappers take their twins; the admission checks
    that guard the card's kernels are exercised through their helper."""
    q = torch.zeros(1, 2, 8, 48)
    with pytest.raises(ValueError, match="head dim"):
        A._admit_flash("flash fwd", q, q, q, None)
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        A._admit_flash("flash fwd", q, q, q, None)
    with pytest.raises(ValueError, match="block_q"):
        A.attention_pallas(q, q, q, None, block_q=0)
    assert A._strided_ok(torch.zeros(2, 8, 3, 2, 64)[:, :, 0].permute(0, 2, 1, 3))
    assert not A._strided_ok(torch.zeros(2, 2, 8, 64).transpose(-1, -2))
    o, lse = A.flash_fwd(q, q, q)
    assert o.shape == q.shape and lse.shape == (1, 2, 8)
