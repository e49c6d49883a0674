"""The port's backward twins (nans_clip_tpu_torch/ops/fused_block_bwd.py)
against the JAX Pallas backward kernels they port, run in interpret mode on
the CPU, and the port's dropout (ops/dropout.py).

Inputs come from numpy (RandomState) and go into both packages, called as
tests/test_fused_bwd.py calls the JAX kernels; weights are [in, out] on the
JAX side and [out, in] on the port side, so the port's weight gradients are
compared transposed. fp32, dropout rate 0 (the JAX kernels' dropout needs
the TPU's PRNG). Tolerance: 1e-3 * max(|ref|, 1) for attention and 2e-3 *
max(|ref|, 1) for the MLP, the JAX tests' own bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu.ops import fused_block_bwd as jbwd
from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.ops import fused_block as tfb
from nans_clip_tpu_torch.ops import fused_block_bwd as tbwd

torch.set_num_threads(2)

INTERPRET = jax.default_backend() != "tpu"
NAMES = ("dx", "dW_a", "db_a", "dW_b", "db_b", "d_ln_w", "d_ln_b")


def _args(seed, b, s, w, inter):
    rs = np.random.RandomState(seed)
    r = lambda *sh: (0.1 * rs.randn(*sh)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[0, s // 3:] = 0.0
    mask[-1, s - 2:] = 0.0
    return dict(x=rs.randn(b, s, w).astype(np.float32), ln_s=1.0 + r(w), ln_b=r(w),
                wqkv=r(w, 3 * w), bqkv=r(3 * w), wo=r(w, w), bo=r(w),
                w1=r(w, inter), b1=r(inter), w2=r(inter, w), b2=r(w),
                kb=(1.0 - mask) * -10000.0, g=rs.randn(b, s, w).astype(np.float32))


def _t(a, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def _compare(ours, ref, rel):
    """ours: the port's outputs; ref: the JAX kernel's, weight gradients
    [in, out] and vectors [1, N]."""
    for name, a, b in zip(NAMES, ours, ref):
        b = np.asarray(b)
        b = b.T if name.startswith("dW") else b.reshape(a.shape)
        err = float(np.abs(a.numpy() - b).max())
        assert err < rel * max(float(np.abs(b).max()), 1.0), (name, err)


@pytest.mark.parametrize("s", [52, 24])
def test_attention_bwd_twin_matches_pallas(s):
    """#14 (pre-LN) twin against _bwd_fullgrad_kernel."""
    a = _args(0, 4, s, 64, 256)
    ref = jbwd.fused_attention_block_bwd_fullgrad(
        jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wo"],
        jnp.asarray(a["g"]), 4, 1e-5, INTERPRET)
    ours = tbwd.fused_attention_block_bwd_fullgrad(
        _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]),
        _t(a["wo"], True), _t(a["g"]), 4, 1e-5)
    _compare(ours, ref, 1e-3)


@pytest.mark.parametrize("s", [52, 24])
def test_bert_attention_bwd_twin_matches_pallas(s):
    """#16 (post-LN, key-masked) twin against _bert_bwd_fullgrad_kernel."""
    a = _args(1, 4, s, 64, 256)
    ref = jbwd.fused_bert_attention_block_bwd_fullgrad(
        jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wo"], a["bo"],
        jnp.asarray(a["kb"]), None, jnp.asarray(a["g"]), 4, 1e-12, 0.0, 0.0, INTERPRET)
    ours = tbwd.fused_bert_attention_block_bwd_fullgrad(
        _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]),
        _t(a["wo"], True), _t(a["bo"]), _t(a["kb"]), None, _t(a["g"]), 4, 1e-12)
    _compare(ours, ref, 1e-3)


@pytest.mark.parametrize("s", [52, 24])
@pytest.mark.parametrize("act,post_ln", [("quick_gelu", False), ("gelu", True)])
def test_mlp_bwd_twin_matches_pallas(s, act, post_ln):
    """#18, both forms, twin against _mlp_bwd_fullgrad_kernel."""
    a = _args(2, 4, s, 64, 256)
    ref = jbwd.fused_mlp_block_bwd_fullgrad(
        jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["w1"], a["b1"], a["w2"], a["b2"], None,
        jnp.asarray(a["g"]), act, 1e-5, post_ln, 0.0, INTERPRET)
    ours = tbwd.fused_mlp_block_bwd_fullgrad(
        _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["w1"], True), _t(a["b1"]),
        _t(a["w2"], True), _t(a["b2"]), None, _t(a["g"]), act, 1e-5, post_ln)
    _compare(ours, ref, 2e-3)


def _gradcheck_inputs(seed, inter):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, std=0.3: (torch.randn(*s, generator=g, dtype=torch.float64)
                             * std).requires_grad_()
    b, s, w = 2, 5, 8
    x = r(b, s, w, std=1.0)
    ln_w = (1.0 + 0.1 * torch.randn(w, generator=g, dtype=torch.float64)).requires_grad_()
    return x, ln_w, r(w), (r(3 * w, w), r(3 * w), r(w, w), r(w)), (r(inter, w), r(inter),
                                                                   r(w, inter), r(w))


def test_dropout_backward_redraws_the_forward_mask():
    """The autograd Functions with attention and hidden dropout at 0.1 pass
    gradcheck in fp64: the backward's analytic gradient matches finite
    differences of the forward, which it can only do with the same masks."""
    x, ln_w, ln_b, attn, mlp = _gradcheck_inputs(0, 16)
    kb = torch.zeros(2, 5)
    kb[0, 3:] = -10000.0
    f_attn = lambda *a: tfb.attention_block_train(a[0], a[1], a[2], *a[3:], kb, 2, 1e-5, True,
                                                  1234, 0.1, 0.1, use_kernel=False)
    assert torch.autograd.gradcheck(f_attn, (x, ln_w, ln_b, *attn))
    f_mlp = lambda *a: tfb.mlp_block_train(a[0], a[1], a[2], *a[3:], "gelu", 1e-5, True, 99,
                                           0.1, use_kernel=False)
    assert torch.autograd.gradcheck(f_mlp, (x, ln_w, ln_b, *mlp))


def test_pre_ln_functions_pass_gradcheck():
    x, ln_w, ln_b, attn, mlp = _gradcheck_inputs(1, 16)
    f_attn = lambda *a: tfb.attention_block_train(a[0], a[1], a[2], *a[3:], None, 2, 1e-5,
                                                  False, use_kernel=False)
    assert torch.autograd.gradcheck(f_attn, (x, ln_w, ln_b, *attn))
    f_mlp = lambda *a: tfb.mlp_block_train(a[0], a[1], a[2], *a[3:], "quick_gelu", 1e-5, False,
                                           use_kernel=False)
    assert torch.autograd.gradcheck(f_mlp, (x, ln_w, ln_b, *mlp))


def test_dropout_keep_fraction():
    """10^6 draws at rate 0.1 keep 0.9 of them: the dropped fraction lies in
    0.1 +- 0.002 (the binomial sd is 0.0003)."""
    spec = drop.Dropout(20260, 0.1, drop.STREAM_HIDDEN, 1000)
    m = drop.hidden_multiplier(spec, 1000, 1000, "cpu")
    dropped = float((m == 0).float().mean())
    assert abs(dropped - 0.1) <= 0.002, dropped
    assert torch.all((m == 0) | (m == torch.tensor(1 / 0.9, dtype=torch.float32)))


def test_dropout_masks_follow_the_seed():
    a = lambda seed: drop.attention_multiplier(drop.Dropout(seed, 0.1, drop.STREAM_ATTN),
                                               2, 3, 52, "cpu")
    assert torch.equal(a(7), a(7))
    assert not torch.equal(a(7), a(8))
    h = lambda stream: drop.hidden_multiplier(drop.Dropout(7, 0.1, stream, 52), 104, 64, "cpu")
    assert not torch.equal(h(drop.STREAM_HIDDEN), h(drop.STREAM_EMBED))
    # the forward twin draws the same mask on every call with one seed
    x, ln_w, ln_b, attn, _ = _gradcheck_inputs(2, 16)
    run = lambda seed: tfb._reference_block(x.detach(), ln_w.detach(), ln_b.detach(),
                                            *(t.detach() for t in attn), 2, 1e-5, None, True,
                                            seed, 0.1, 0.1)
    assert torch.equal(run(5), run(5)) and not torch.equal(run(5), run(6))


def test_philox_known_answers():
    """Word 0 of Philox4x32-10 for the Random123 known-answer vectors."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    f = 0xFFFFFFFF
    assert int(drop.philox_word0(t(0), t(0), t(0), t(0), 0, 0)) == 0x6627E8D5
    assert int(drop.philox_word0(t(f), t(f), t(f), t(f), f, f)) == 0x408F276D
    assert int(drop.philox_word0(t(0x243F6A88), t(0x85A308D3), t(0x13198A2E), t(0x03707344),
                                 0xA4093822, 0x299F31D0)) == 0xD16CFE09
