"""The port's whole-layer twin (nans_clip_tpu_torch/ops/layer_kernel.py)
against the JAX whole-layer Pallas kernel, run in interpret mode on the CPU.
fp32, atol = rtol = 5e-5 (the JAX kernel tests' tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu.ops import layer_kernel as jlk
from nans_clip_tpu_torch.ops import layer_kernel as tlk

torch.set_num_threads(2)

TOL = dict(atol=5e-5, rtol=5e-5)


def _args(seed, b, s, w, inter):
    rs = np.random.RandomState(seed)
    r = lambda *sh: (0.1 * rs.randn(*sh)).astype(np.float32)
    return dict(x=rs.randn(b, s, w).astype(np.float32),
                ln1_s=1.0 + r(w), ln1_b=r(w), wqkv=r(w, 3 * w), bqkv=r(3 * w),
                wo=r(w, w), bo=r(w), ln2_s=1.0 + r(w), ln2_b=r(w),
                w1=r(w, inter), b1=r(inter), w2=r(inter, w), b2=r(w))


ORDER = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wo", "bo", "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
LINEAR = {"wqkv", "wo", "w1", "w2"}


@pytest.mark.parametrize("b,s,w,heads", [(2, 52, 64, 4), (4, 24, 128, 2)])
@pytest.mark.parametrize("post_ln", [False, True])
def test_layer_twin_matches_pallas(b, s, w, heads, post_ln):
    a = _args(0, b, s, w, 4 * w)
    act = "gelu" if post_ln else "quick_gelu"
    eps = 1e-12 if post_ln else 1e-5
    kb = None
    if post_ln:
        mask = np.ones((b, s), np.float32)
        mask[0, s // 2:] = 0.0
        mask[-1, 5:] = 0.0
        kb = (1.0 - mask) * -10000.0
    ref = jlk.fused_layer_block(
        jnp.asarray(a["x"]), *(a[k] for k in ORDER), heads, eps, act, post_ln,
        key_bias=None if kb is None else jnp.asarray(kb), interpret=True)
    params = [torch.from_numpy(np.ascontiguousarray(a[k].T if k in LINEAR else a[k]))
              for k in ORDER]
    out = tlk.fused_layer_block(torch.from_numpy(a["x"]), *params, heads, eps, act, post_ln,
                                None if kb is None else torch.from_numpy(kb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
