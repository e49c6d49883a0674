"""The wide towers' kernels and routing against the JAX package on the CPU.

The port's twins of #7/#8 (``fused_attention_block_wide``), #9/#10
(``_fused_mlp_tiled_call`` / ``_fused_mlp_batched_call``), #19
(``fused_mlp_block_bwd_chunked``) and #20 (``fused_attention_block_bwd_chunked``
with ``assemble_chunked_attn_weight_grads``) against the Pallas kernels in
interpret mode, fp32, at the sizes of the JAX package's own tests
(tests/test_fused_block.py:85-113, test_fused_mlp.py:73-116,
test_fused_bwd.py:238-316) and with their tolerances: forwards 3e-5 to 5e-5,
the gradients of #7 atol 5e-5 / rtol 5e-4 (fp32 sums in another order), the
chunked backwards 2e-3 of max(|ref|, 1). Then the port's gate counterparts
against the JAX gates at every published shape, the features of ViT-H-14 +
RoBERTa-large widths cut to 2 layers against the JAX model (2e-4, as
tests/test_torch_slice.py). Two train steps of a ViT-H-shaped tiny
configuration (heads of 80) and of a 336-pixel one (S = 577) against JAX
``make_train_step`` are cases of tests/test_torch_train.py."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.ops import fused_block as jfb
from nans_clip_tpu.ops import fused_block_bwd as jfbb
from nans_clip_tpu_torch.ops import fused_block as fb
from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
from nans_clip_tpu_torch.ops import gates
from tests.test_torch_slice import _assert_slice_matches, _cut, _setup

torch.set_num_threads(2)

INTERPRET = True
T = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))


def _attn_args(seed, b, s, w):
    """JAX layout ([in, out] weights) as numpy."""
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, w), 1.0 + 0.1 * rs.randn(w), 0.1 * rs.randn(w),
            0.1 * rs.randn(w, 3 * w), 0.1 * rs.randn(3 * w), 0.1 * rs.randn(w, w),
            0.1 * rs.randn(w)]


def _mlp_args(seed, b, s, w, i):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, w), 1.0 + 0.1 * rs.randn(w), 0.1 * rs.randn(w),
            0.1 * rs.randn(w, i), 0.1 * rs.randn(i), 0.1 * rs.randn(i, w), 0.1 * rs.randn(w)]


def _jax(args):
    return [jnp.asarray(a, jnp.float32) for a in args]


def _port(args):
    """The port's layout: torch Linear weights [out, in]."""
    x, lw, lb, w1, b1, w2, b2 = args
    return [T(x), T(lw), T(lb), T(w1.T), T(b1), T(w2.T), T(b2)]


@pytest.mark.parametrize("batch_tile", [1, 2])
def test_wide_attention_matches_pallas(batch_tile):
    """#7 (forward and every gradient, test_fused_block.py:85-101) and #8
    (forward, :104-113): (2, 36, 160), two heads of 80."""
    args = _attn_args(2 + batch_tile, 2, 36, 160)
    ref = jfb.fused_attention_block_wide(*_jax(args), 2, 1e-5, 1, INTERPRET, batch_tile)
    pt = [t.requires_grad_() for t in _port(args)]
    out = fb.fused_attention_block_wide(*pt, 2, 1e-5, 1, False, batch_tile)
    tol = 3e-5 if batch_tile > 1 else 5e-5
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol)
    if batch_tile > 1:
        return
    loss = lambda fn: lambda *a: jnp.sum(jnp.sin(fn(*a)))
    want = jax.grad(loss(lambda *a: jfb.fused_attention_block_wide(*a, 2, 1e-5, 1, INTERPRET)),
                    argnums=tuple(range(7)))(*_jax(args))
    got = torch.autograd.grad(torch.sin(out).sum(), pt)
    for i, (a, r) in enumerate(zip(got, want)):
        a = a.T if i in (3, 5) else a
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=5e-5, rtol=5e-4)


def test_wide_attention_checks_its_arguments():
    pt = _port(_attn_args(0, 2, 36, 160))
    with pytest.raises(ValueError, match="heads_per_chunk"):
        fb.fused_attention_block_wide(*pt, 2, 1e-5, 4)
    with pytest.raises(ValueError, match="batch_tile"):
        fb.fused_attention_block_wide(*pt, 2, 1e-5, 1, False, 3)


@pytest.mark.parametrize("act,post_ln,tile", [("quick_gelu", False, 1), ("gelu", True, 1),
                                              ("quick_gelu", False, 2), ("gelu", True, 2)])
def test_chunked_mlp_matches_pallas(act, post_ln, tile):
    """#9 (chunk 256, test_fused_mlp.py:73) and #10 (tile 2, :109-116) at
    (2, 36, 256, I 1024)."""
    args = _mlp_args(1 + tile, 2, 36, 256, 1024)
    if tile > 1:
        ref = jfb._fused_mlp_batched_call(*_jax(args), act, 1e-5, post_ln, INTERPRET, 256, tile)
        out = fb._fused_mlp_batched_call(*_port(args), act, 1e-5, post_ln, False, 256, tile)
    else:
        ref = jfb._fused_mlp_tiled_call(*_jax(args), act, 1e-5, post_ln, INTERPRET, 256)
        out = fb._fused_mlp_tiled_call(*_port(args), act, 1e-5, post_ln, False, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)
    with pytest.raises(ValueError, match="chunk"):
        fb._fused_mlp_tiled_call(*_port(args), act, 1e-5, post_ln, False, 384)


def _close_rel(got, want, what):
    for name, a, r in zip(what, got, want):
        a, r = np.asarray(a), np.asarray(r)
        err, mag = float(np.abs(a - r).max()), max(float(np.abs(r).max()), 1.0)
        assert a.shape == r.shape and err < 2e-3 * mag, (name, err, mag)


def test_chunked_mlp_bwd_matches_pallas():
    """#19 at (4, 20, 128, I 512), chunk 128, tile 2 (test_fused_bwd.py
    :238-280): its five outputs against the Pallas kernel's, and the weight
    gradients formed from them against JAX's vjp of the reference block."""
    b, s, w, i = 4, 20, 128, 512
    args = _mlp_args(3, b, s, w, i)
    g = np.random.RandomState(4).randn(b, s, w)
    x, lw, lb, w1, b1, w2, _ = _jax(args)
    want = jfbb.fused_mlp_block_bwd_chunked(x, lw, lb, w1, b1, w2, jnp.asarray(g, jnp.float32),
                                            "quick_gelu", 1e-5, 128, 2, INTERPRET)
    px, plw, plb, pw1, pb1, pw2, _ = _port(args)
    got = fbb.fused_mlp_block_bwd_chunked(px, plw, plb, pw1, pb1, pw2, T(g), "quick_gelu", 1e-5,
                                          128, 2)
    _close_rel(got, want, ("dx", "xn", "h", "dh_pre", "dxn"))
    _, vjp = jax.vjp(lambda *a: jfb._reference_mlp(*a, act="quick_gelu", eps=1e-5,
                                                  post_ln=False), *_jax(args))
    ref = vjp(jnp.asarray(g, jnp.float32))
    dx, xn, h, dh_pre, dxn = got
    mean = px.mean(-1, keepdim=True)
    xhat = (px - mean) * torch.rsqrt((px - mean).square().mean(-1, keepdim=True) + 1e-5)
    flat = lambda t: t.reshape(-1, t.shape[-1])
    ours = (dx, (dxn * xhat).sum((0, 1)), dxn.sum((0, 1)), (flat(dh_pre).T @ flat(xn)).T,
            dh_pre.sum((0, 1)), (flat(T(g)).T @ flat(h)).T, T(g).sum((0, 1)))
    _close_rel(ours, ref, ("dx", "d_scale", "d_bias", "dw1", "db1", "dw2", "db2"))
    with pytest.raises(ValueError, match="tile"):
        fbb.fused_mlp_block_bwd_chunked(px, plw, plb, pw1, pb1, pw2, T(g), "quick_gelu", 1e-5,
                                        128, 3)


@pytest.mark.parametrize("w,heads,hpc", [(128, 4, 2), (160, 2, 1)])
def test_chunked_attention_bwd_matches_pallas(w, heads, hpc):
    """#20 at (2, 20, 128), 4 heads in chunks of 2 (test_fused_bwd.py
    :283-316), and at heads of 80 (W 160, 2 heads, chunks of 1): the four
    outputs in JAX's per-chunk layout against the Pallas kernel's, and
    ``assemble_chunked_attn_weight_grads`` against JAX's vjp."""
    b, s = 2, 20
    args = _attn_args(5, b, s, w)
    g = np.random.RandomState(6).randn(b, s, w)
    x, lw, lb, wqkv, bqkv, wo, _ = _jax(args)
    gj = jnp.asarray(g, jnp.float32)
    want = jfbb.fused_attention_block_bwd_chunked(x, lw, lb, wqkv, bqkv, wo, gj, heads, hpc,
                                                  1e-5, INTERPRET)
    px, plw, plb, pwqkv, pbqkv, pwo, _ = _port(args)
    got = fbb.fused_attention_block_bwd_chunked(px, plw, plb, pwqkv, pbqkv, pwo, T(g), heads,
                                                hpc, 1e-5)
    _close_rel(got, want, ("dx", "xn", "ctx_h", "dqkv_h"))
    _, vjp = jax.vjp(lambda *a: jfb._reference_block(*a, heads=heads, eps=1e-5), *_jax(args))
    ref = vjp(gj)
    d_lw, d_lb, dwqkv, dbqkv, dwo, dbo = fb.assemble_chunked_attn_weight_grads(
        px, got[1], got[2], got[3], T(g), heads, hpc, plw, plb, pwqkv, 1e-5)
    _close_rel((got[0], d_lw, d_lb, dwqkv.T, dbqkv, dwo.T, dbo), ref,
               ("dx", "d_scale", "d_bias", "dwqkv", "dbqkv", "dwo", "dbo"))
    with pytest.raises(ValueError, match="hpc"):
        fbb.fused_attention_block_bwd_chunked(px, plw, plb, pwqkv, pbqkv, pwo, T(g), heads, 3)


# Every published tower: (seq, width, heads) of the image towers at their
# resolutions and of the text towers at 52 tokens.
PUBLISHED = [(197, 768, 12), (257, 1024, 16), (577, 1024, 16), (257, 1280, 16),
             (577, 1280, 16), (52, 768, 12), (52, 1024, 16)]
BATCHES = [1, 2, 8, 16, 32, 64, 128, 256]


def test_gates_answer_as_the_jax_gates():
    for (s, w, h), b in itertools.product(PUBLISHED, BATCHES):
        i = 4 * w
        for esize in (2, 4):
            assert gates.fits_fused(s, w) == jfb.fits_fused(s, w)
            assert gates.fits_fused_wide(s, w) == jfb.fits_fused_wide(s, w)
            assert gates.fits_fused_mlp_oneshot(s, w) == jfb.fits_fused_mlp_oneshot(s, w)
            assert gates.mlp_oneshot_direct_ok(s, w) == jfb.mlp_oneshot_direct_ok(s, w)
            assert gates.fits_fused_mlp_tiled(s, w) == jfb.fits_fused_mlp_tiled(s, w)
            chunk = gates.mlp_chunk_size(w, i, esize)
            assert chunk == jfb.mlp_chunk_size(w, i, esize)
            if chunk is not None:
                assert gates.mlp_batch_tile(b, s, w, i, chunk, esize) == \
                    jfb.mlp_batch_tile(b, s, w, i, chunk, esize)
            assert gates.fused_mlp_routable(b, s, w, i, esize) == \
                jfb.fused_mlp_routable(b, s, w, i, esize)
        assert gates.attn_bwd_head_chunk(s, w, h) == jfbb.attn_bwd_head_chunk(s, w, h)
        assert gates.mlp_bwd_chunk_tile(b, s, w, i) == jfbb.mlp_bwd_chunk_tile(b, s, w, i)
    assert gates.attn_bwd_head_chunk(577, 1024, 16) == 4
    assert gates.mlp_batch_tile(32, 257, 1280, 5120, 512) == 2
    # the kernels each wide block names (vit.py:190-338)
    assert gates.fits_fused(257, 1280) and gates.fits_fused(577, 1024)
    assert not gates.fits_fused(577, 1280) and gates.fits_fused_wide(577, 1280)
    assert fb.mlp_plan(32, 257, 1280, 5120, 2) == (512, 2)
    assert fb.mlp_plan(1, 257, 1280, 5120, 2) == (512, 1)
    assert fb.mlp_plan(32, 52, 1024, 4096, 2) is None and fb.mlp_plan(8, 197, 768, 3072, 2) is None


def test_vit_h_and_roberta_large_widths_match_jax():
    """ViT-H-14 (W 1280, heads of 80, S 257) + RoBERTa-wwm-ext-large (W
    1024) cut to 2 layers, batch 2: the JAX parameters, carried across by
    ``state_dict_from_jax_params``, give the JAX features."""
    jcfg = _cut(jconfigs.load_config("ViT-H-14@RoBERTa-wwm-ext-large-chinese"), 2)
    assert jcfg.vision.head_width == 80 and jcfg.text.hidden_size == 1024
    _assert_slice_matches(jcfg, *_setup(jcfg, batch=2, seed=7))


@pytest.mark.parametrize("name", ["ViT-L-14", "ViT-L-14-336", "ViT-H-14"])
def test_wide_names_build(name, tmp_path, monkeypatch):
    """``load_from_name`` and ``create_model`` resolve each wide published
    name to its towers and resolution, and the module they build has the
    JAX model's parameter count (built on the meta device here: ViT-H-14's
    fp32 weights alone take 3.8 GB)."""
    from nans_clip_tpu.models import clip as jclip
    from nans_clip_tpu_torch import api
    from nans_clip_tpu_torch import configs as tconfigs
    from nans_clip_tpu_torch.models.clip import CLIP

    built = []

    def model_from_config(cfg, checkpoint_path=None, options=None, seed=0, device="cuda"):
        with torch.device("meta"):
            built.append((cfg, checkpoint_path, CLIP(cfg)))
        return built[-1]

    monkeypatch.setattr(api, "model_from_config", model_from_config)
    (tmp_path / tconfigs.MODEL_CKPT_FILES[name]).write_bytes(b"")
    api.load_from_name(name, download_root=str(tmp_path), device="cpu")
    vision, text, resolution = tconfigs.MODEL_INFO[name]
    api.create_model(f"{vision}@{text}", input_resolution=resolution, device="cpu")
    (cfg, path, module), (cfg2, _, _) = built
    assert cfg == cfg2 and path.endswith(tconfigs.MODEL_CKPT_FILES[name])
    assert cfg.vision.image_resolution == resolution and cfg.vision.seq_len == (
        577 if resolution == 336 else 257)
    jcfg = jconfigs.with_resolution(jconfigs.load_config(f"{vision}@{text}"), resolution)
    shapes = jax.eval_shape(lambda k: jclip.init_clip(k, jcfg)[0], jax.random.PRNGKey(0))
    assert sum(p.numel() for p in module.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
