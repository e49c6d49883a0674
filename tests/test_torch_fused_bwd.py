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


# --- the emitting forms (#13, #15, #17), the whole-layer backward (#21) and
# the routing by needs_input_grad ---------------------------------------------

def _compare_emitted(names, ours, ref, rel):
    """Every emitted tensor, same shape on both sides, within rel *
    max(|ref|, 1)."""
    assert len(ours) == len(ref) == len(names)
    for name, a, b in zip(names, ours, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, (name, a.shape, b.shape)
        err = float(np.abs(a.numpy() - b).max())
        assert err < rel * max(float(np.abs(b).max()), 1.0), (name, err)


@pytest.mark.parametrize("s", [52, 24])
def test_attention_bwd_emit_twin_matches_pallas(s):
    """#13 twin against _bwd_kernel: (dx, xn, ctx, dqkv)."""
    a = _args(3, 4, s, 64, 256)
    ref = jbwd.fused_attention_block_bwd(
        jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wo"],
        jnp.asarray(a["g"]), 4, 1e-5, INTERPRET)
    ours = tbwd.fused_attention_block_bwd(
        _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]),
        _t(a["wo"], True), _t(a["g"]), 4, 1e-5)
    _compare_emitted(("dx", "xn", "ctx", "dqkv"), ours, ref, 1e-3)


@pytest.mark.parametrize("s", [52, 24])
def test_bert_attention_bwd_emit_twin_matches_pallas(s):
    """#15 twin against _bert_bwd_kernel: (dx, dqkv, ctx, dproj, uhat)."""
    a = _args(4, 4, s, 64, 256)
    ref = jbwd.fused_bert_attention_block_bwd(
        jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wo"], a["bo"],
        jnp.asarray(a["kb"]), None, jnp.asarray(a["g"]), 4, 1e-12, 0.0, 0.0, INTERPRET)
    ours = tbwd.fused_bert_attention_block_bwd(
        _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]),
        _t(a["wo"], True), _t(a["bo"]), _t(a["kb"]), None, _t(a["g"]), 4, 1e-12)
    _compare_emitted(("dx", "dqkv", "ctx", "dproj", "uhat"), ours, ref, 1e-3)


@pytest.mark.parametrize("s", [52, 24])
@pytest.mark.parametrize("act,post_ln", [("quick_gelu", False), ("gelu", True)])
def test_mlp_bwd_emit_twin_matches_pallas(s, act, post_ln):
    """#17 twin, both forms, against _mlp_bwd_kernel: (dx, xn, h, dh_pre,
    dproj, lnstat, dxn); lnstat is x-hat pre-LN and u-hat post-LN."""
    a = _args(5, 4, s, 64, 256)
    ref = jbwd.fused_mlp_block_bwd(
        jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["w1"], a["b1"], a["w2"], a["b2"], None,
        jnp.asarray(a["g"]), act, 1e-5, post_ln, 0.0, INTERPRET)
    ours = tbwd.fused_mlp_block_bwd(
        _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["w1"], True), _t(a["b1"]),
        _t(a["w2"], True), _t(a["b2"]), None, _t(a["g"]), act, 1e-5, post_ln)
    _compare_emitted(("dx", "xn", "h", "dh_pre", "dproj", "lnstat", "dxn"), ours, ref, 2e-3)


def test_layer_bwd_twin_matches_pallas():
    """#21 twin against fused_layer_block_bwd_fullgrad in interpret mode (13
    outputs, 2e-3 * max(|ref|, 1) as tests/test_layer_bwd.py), and bit-equal
    to the twins of #18 then #14."""
    from nans_clip_tpu.ops import fused_block as jfb
    from nans_clip_tpu.ops import layer_bwd as jlb
    from nans_clip_tpu_torch.ops import layer_bwd as tlb

    a = _args(6, 4, 24, 128, 512)
    xm = np.array(jfb._reference_block(jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["wqkv"],
                                         a["bqkv"], a["wo"], a["bo"], heads=4, eps=1e-5))
    rs = np.random.RandomState(60)
    ln2_s, ln2_b = (1.0 + 0.1 * rs.randn(128)).astype(np.float32), \
        (0.1 * rs.randn(128)).astype(np.float32)
    ref = jlb.fused_layer_block_bwd_fullgrad(
        jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wo"],
        jnp.asarray(xm), ln2_s, ln2_b, a["w1"], a["b1"], a["w2"], a["b2"], jnp.asarray(a["g"]),
        4, "quick_gelu", 1e-5, INTERPRET)
    t_attn = (_t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]), _t(a["wo"], True))
    t_mlp = (_t(ln2_s), _t(ln2_b), _t(a["w1"], True), _t(a["b1"]), _t(a["w2"], True),
             _t(a["b2"]))
    ours = tlb.fused_layer_block_bwd_fullgrad(_t(a["x"]), *t_attn, _t(xm), *t_mlp, _t(a["g"]), 4,
                                              "quick_gelu", 1e-5)
    names = ("dx", "dW_qkv", "db_qkv", "dW_o", "db_o", "d_ln1_w", "d_ln1_b", "dW_1", "db_1",
             "dW_2", "db_2", "d_ln2_w", "d_ln2_b")
    assert len(ours) == len(ref) == 13
    for name, o, r in zip(names, ours, ref):
        r = np.asarray(r)
        r = r.T if name.startswith("dW") else r.reshape(o.shape)
        err = float(np.abs(o.numpy() - r).max())
        assert err < 2e-3 * max(float(np.abs(r).max()), 1.0), (name, err)
    mlp = tbwd.fused_mlp_block_bwd_fullgrad(_t(xm), *t_mlp, None, _t(a["g"]), "quick_gelu", 1e-5,
                                            False)
    attn = tbwd.fused_attention_block_bwd_fullgrad(_t(a["x"]), *t_attn, mlp[0], 4, 1e-5)
    for o, r in zip(ours, attn + mlp[1:]):
        assert torch.equal(o, r)


def test_layer_train_function_matches_sub_block_functions():
    """fused_layer_train (forward #1 then #2, backward #21) gives the output
    and every gradient of the two sub-block Functions, bit for bit, and
    raises when a weight of the layer is frozen."""
    from nans_clip_tpu_torch.ops import layer_bwd as tlb

    a = _args(7, 2, 24, 64, 256)
    mk = lambda: [t.clone().requires_grad_() for t in (
        _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]),
        _t(a["wo"], True), _t(a["bo"]), _t(a["ln_s"]) * 0.9, _t(a["ln_b"]) + 0.1,
        _t(a["w1"], True), _t(a["b1"]), _t(a["w2"], True), _t(a["b2"]))]
    p1, p2 = mk(), mk()
    y1 = tlb.fused_layer_train(*p1, 4, "quick_gelu", 1e-5, use_kernel=False)
    xm = tfb.attention_block_train(*p2[:7], None, 4, 1e-5, False, use_kernel=False)
    y2 = tfb.mlp_block_train(xm, *p2[7:], "quick_gelu", 1e-5, False, use_kernel=False)
    assert torch.equal(y1, y2)
    g = _t(a["g"])
    y1.backward(g)
    y2.backward(g)
    for u, v in zip(p1, p2):
        assert torch.equal(u.grad, v.grad)
    p3 = mk()
    p3[5].requires_grad_(False)
    with pytest.raises(RuntimeError, match="frozen"):
        tlb.fused_layer_train(*p3, 4, "quick_gelu", 1e-5, use_kernel=False).backward(g)


@pytest.mark.parametrize("post_ln", [False, True])
def test_frozen_weights_take_the_emitting_backward(post_ln, monkeypatch):
    """needs_input_grad routing: with every weight frozen but one the
    Functions run the emitting chains (full=False), launch no
    weight-gradient stage and no column sum, return None for every frozen
    weight, and give dx and the one needed gradient of the full route
    (1e-5 of the largest magnitude: the same fp32 terms in another order).
    With every weight needing its gradient, route "emit" matches route
    "fullgrad" the same way."""
    a = _args(8, 2, 24, 64, 256)
    kb = _t(a["kb"]) if post_ln else None
    eps, act = (1e-12, "gelu") if post_ln else (1e-5, "quick_gelu")
    attn_w = lambda: [_t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]),
                      _t(a["wo"], True), _t(a["bo"])]
    mlp_w = lambda: [_t(a["ln_s"]), _t(a["ln_b"]), _t(a["w1"], True), _t(a["b1"]),
                     _t(a["w2"], True), _t(a["b2"])]
    g = _t(a["g"])

    calls = []
    plain = tbwd.PLAIN_OPS
    spy = lambda name, fn: (lambda *args, **kw: (calls.append(name), fn(*args, **kw))[1])
    monkeypatch.setattr(tbwd, "PLAIN_OPS", plain._replace(
        wgrad=spy("wgrad", plain.wgrad), colsum=spy("colsum", plain.colsum)))

    def run(block, weights, needed, route):
        x = _t(a["x"]).requires_grad_()
        ws = [w.clone().requires_grad_(i in needed) for i, w in enumerate(weights())]
        if block == "attn":
            y = tfb.attention_block_train(x, *ws, kb, 4, eps, post_ln, use_kernel=False,
                                          route=route)
        else:
            y = tfb.mlp_block_train(x, *ws, act, eps, post_ln, use_kernel=False, route=route)
        y.backward(g)
        return x.grad, [w.grad for w in ws]

    close = lambda u, v: float((u - v).abs().max()) <= 1e-5 * max(float(v.abs().max()), 1.0)
    everything = range(6)
    for block, weights, one in (("attn", attn_w, 4 if not post_ln else 2), ("mlp", mlp_w, 2)):
        calls.clear()
        dx_full, grads_full = run(block, weights, everything, "fullgrad")
        assert "wgrad" in calls
        calls.clear()
        dx_emit, grads_emit = run(block, weights, everything, "emit")
        assert not calls, calls
        assert close(dx_emit, dx_full)
        for u, v in zip(grads_emit, grads_full):
            assert close(u, v)
        calls.clear()
        dx_one, grads_one = run(block, weights, (one,), "fullgrad")
        assert not calls, calls
        assert torch.equal(dx_one, dx_emit)
        assert [gr is None for gr in grads_one] == [i != one for i in range(6)]
        assert torch.equal(grads_one[one], grads_emit[one])
        calls.clear()
        dx_none, grads_none = run(block, weights, (), "fullgrad")
        assert not calls and torch.equal(dx_none, dx_emit) and all(gr is None for gr in grads_none)


def test_emitting_functions_pass_gradcheck():
    """Route "emit" in fp64: the caller's weight gradients with #13/#15/#17's
    dx match finite differences, dropout on in the post-LN forms."""
    x, ln_w, ln_b, attn, mlp = _gradcheck_inputs(3, 16)
    kb = torch.zeros(2, 5)
    kb[1, 4:] = -10000.0
    fns = [
        lambda *a: tfb.attention_block_train(a[0], a[1], a[2], *a[3:], None, 2, 1e-5, False,
                                             use_kernel=False, route="emit"),
        lambda *a: tfb.attention_block_train(a[0], a[1], a[2], *a[3:], kb, 2, 1e-5, True, 1234,
                                             0.1, 0.1, use_kernel=False, route="emit"),
    ]
    for fn in fns:
        assert torch.autograd.gradcheck(fn, (x, ln_w, ln_b, *attn))
    for act, post_ln, seed, rate in (("quick_gelu", False, None, 0.0), ("gelu", True, 99, 0.1)):
        fn = lambda *a: tfb.mlp_block_train(a[0], a[1], a[2], *a[3:], act, 1e-5, post_ln, seed,
                                            rate, use_kernel=False, route="emit")
        assert torch.autograd.gradcheck(fn, (x, ln_w, ln_b, *mlp))
