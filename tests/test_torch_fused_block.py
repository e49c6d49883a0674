"""The port's sub-block twins (nans_clip_tpu_torch/ops/fused_block.py)
against the JAX Pallas kernels they port, run in interpret mode on the CPU.

Inputs come from numpy (RandomState) and go into both packages; weights are
[in, out] on the JAX side and the torch Linear layout [out, in] on the port
side. fp32, atol = rtol = 5e-5: the tolerance the JAX package's own kernel
tests use (only the order of fp32 sums differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu.ops import fused_block as jfb
from nans_clip_tpu_torch.ops import fused_block as tfb
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops.attention import attention, attention_plain
from nans_clip_tpu_torch.ops.gemm import linear, linear_plain
from nans_clip_tpu_torch.ops.layernorm import layer_norm, row_layer_norm

torch.set_num_threads(2)

TOL = dict(atol=5e-5, rtol=5e-5)
SHAPES = [(2, 52, 64, 4), (4, 24, 128, 2)]   # (B, S, W, heads)


def _args(seed, b, s, w, inter):
    rs = np.random.RandomState(seed)
    r = lambda *sh: (0.1 * rs.randn(*sh)).astype(np.float32)
    return dict(x=rs.randn(b, s, w).astype(np.float32),
                ln_s=1.0 + r(w), ln_b=r(w),
                wqkv=r(w, 3 * w), bqkv=r(3 * w), wo=r(w, w), bo=r(w),
                w1=r(w, inter), b1=r(inter), w2=r(inter, w), b2=r(w))


def _t(a, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def _key_bias(b, s):
    mask = np.ones((b, s), np.float32)
    mask[0, s // 3:] = 0.0        # ragged padding: each row its own length
    mask[-1, s - 2:] = 0.0
    return (1.0 - mask) * -10000.0


@pytest.mark.parametrize("b,s,w,heads", SHAPES)
def test_attention_pre_ln_matches_pallas(b, s, w, heads):
    a = _args(0, b, s, w, 4 * w)
    ref = jfb.fused_attention_block(
        jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wo"], a["bo"],
        heads, 1e-5, interpret=True)
    out = tfb.fused_attention_block(
        _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]),
        _t(a["wo"], True), _t(a["bo"]), heads, 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("b,s,w,heads", SHAPES)
def test_attention_post_ln_masked_matches_pallas(b, s, w, heads):
    a = _args(1, b, s, w, 4 * w)
    kb = _key_bias(b, s)
    ref = jfb.fused_bert_attention_block(
        jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wo"], a["bo"],
        jnp.asarray(kb), heads, 1e-12, interpret=True)
    out = tfb.fused_bert_attention_block(
        _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]),
        _t(a["wo"], True), _t(a["bo"]), _t(kb), heads, 1e-12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("b,s,w,heads", SHAPES)
@pytest.mark.parametrize("act,eps,post_ln", [("quick_gelu", 1e-5, False), ("gelu", 1e-12, True)])
def test_mlp_matches_pallas(b, s, w, heads, act, eps, post_ln):
    a = _args(2, b, s, w, 4 * w)
    ref = jfb.fused_mlp_block(jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["w1"], a["b1"],
                              a["w2"], a["b2"], act, eps, post_ln, True)
    out = tfb.fused_mlp_block(_t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["w1"], True),
                              _t(a["b1"]), _t(a["w2"], True), _t(a["b2"]), act, eps, post_ln)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_wrappers_take_twins_on_cpu():
    """CPU tensors go to the plain versions, bit for bit."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(6, 128).astype(np.float32))
    w = torch.from_numpy(rs.randn(384, 128).astype(np.float32))
    bias = torch.from_numpy(rs.randn(384).astype(np.float32))
    g = torch.ones(128)
    assert torch.equal(row_layer_norm(x, g, g, 1e-5), layer_norm(x, g, g, 1e-5))
    assert torch.equal(linear(x, w, bias, "gelu"), linear_plain(x, w, bias, "gelu"))
    qkv = linear(x, w, bias)
    assert torch.equal(attention(qkv, None, 2, 2), attention_plain(qkv, None, 2, 2))


def test_routing_gate():
    x = torch.zeros(2, 3)
    assert not gates.use_kernel(x, "auto")
    assert not gates.use_kernel(x, "plain")
    with pytest.raises(ValueError):
        gates.use_kernel(x, "kernel")
    # the JAX values: "fused" runs what "auto" runs (the twins on CPU
    # tensors), "xla" and "pallas" never the sub-block kernels
    for impl in ("fused", "xla", "pallas"):
        assert not gates.use_kernel(x, impl)
    with pytest.raises(ValueError):
        gates.use_kernel(x, "flash")

