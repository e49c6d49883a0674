"""The dequant-ahead int8 tower (#6, ``fused_tower(quant_dma=True)``), the
whole-tower twin at heads of 80 and the whole-tower routing against the JAX
package on the CPU.

Inputs come from numpy seeds; weights are carried across in the JAX layout
and quantized on each side by its own ``quantize_weight`` (bit-equal, see
``tests/test_torch_tower.py``). fp32 on both sides. Tolerances:

- the twins against the JAX tower kernels in interpret mode (#6 with
  ``quant_dma=True``; #4 and #5 at heads of 80): atol = rtol = 2e-5, the
  tolerance of ``tests/test_quantize.py``'s qdma test (a few layers of fp32
  sum-order differences);
- gates and routes: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu.ops import fused_block as jfb
from nans_clip_tpu.ops import tower_kernel as jtk
from nans_clip_tpu.utils import quantize as jq
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops import tower_kernel as tk
from nans_clip_tpu_torch.utils import quantize as tq
from tests.test_torch_tower import LINEAR, ORDER, _port_layers, _stacked

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(B, S, W, masked, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, W).astype(np.float32)
    kb = None
    if masked:
        mask = np.ones((B, S), np.float32)
        mask[:, S - 3:] = 0.0
        kb = (1.0 - mask) * -10000.0
    return x, kb


def _jax_tower(x, kb, p, heads, act, post_ln, quant, quant_dma=False):
    """JAX ``fused_tower`` in interpret mode on the stacked params ``p``,
    the four weights quantized by JAX's ``quantize_weight`` when ``quant``."""
    B, S, _ = x.shape
    leaves = {k: (jq.quantize_weight(jnp.asarray(p[k])) if quant and k in LINEAR
                  else jnp.asarray(p[k])) for k in ORDER}
    return np.asarray(jtk.fused_tower(
        jnp.asarray(x), None if kb is None else jnp.asarray(kb).reshape(B, 1, S),
        *(leaves[k] for k in ORDER), heads, 1e-5, act, post_ln, interpret=True,
        quant_dma=quant_dma))


# (post_ln, act, masked): tests/test_quantize.py:305-309
FORMS = [(False, "quick_gelu", False), (True, "gelu", True)]


@pytest.mark.parametrize("post_ln,act,masked", FORMS)
def test_qdma_twin_matches_pallas(post_ln, act, masked):
    """``fused_tower(quant_dma=True)`` on CPU tensors (the twin: #5's) against
    JAX ``_tower_kernel_q_dma`` in interpret mode at tests/test_quantize.py's
    shapes: B 2, S 12, W 128, I 512, 4 heads, 3 layers."""
    B, S, W, I, heads = 2, 12, 128, 512, 4
    p = _stacked(3, W, I, seed=6)
    x, kb = _inputs(B, S, W, masked, 13)
    ref = _jax_tower(x, kb, p, heads, act, post_ln, quant=True, quant_dma=True)
    layers = _port_layers(p, quantize=True)
    before = (tk.fused_tower.launches, tk.fused_tower.launches_int8,
              tk.fused_tower.launches_qdma)
    out = tk.fused_tower(torch.from_numpy(x), None if kb is None else torch.from_numpy(kb),
                         layers, heads, 1e-5, act, post_ln, quant_dma=True)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the twin is #5's: the same function, bit for bit on the CPU
    inline = tk.fused_tower(torch.from_numpy(x), None if kb is None else torch.from_numpy(kb),
                            layers, heads, 1e-5, act, post_ln)
    assert torch.equal(out, inline)
    # CPU tensors launch nothing
    assert (tk.fused_tower.launches, tk.fused_tower.launches_int8,
            tk.fused_tower.launches_qdma) == before


# Every published tower at 1 sample: (seq, width) of the image towers at
# their resolutions and of the text towers at 52 tokens, and ViT-H's width.
QDMA_SHAPES = [(197, 768), (50, 768), (257, 1024), (52, 768), (52, 1024), (257, 1280),
               (12, 128), (12, 640)]


def test_qdma_gate_matches_jax():
    """``gates.fits_tower_qdma`` against JAX ``tower_qdma_tile`` by width:
    W 1280 refused; ViT-B (197, 768) and (257, 1024) admitted. (S 577 at W
    1024, which the JAX VMEM budget refused, is taken on the card: the
    buffers live in device memory.)"""
    for s, w in QDMA_SHAPES:
        assert gates.fits_tower_qdma(w) == (jtk.tower_qdma_tile(1, s, w, 4 * w) >= 1), (s, w)
    assert not gates.fits_tower_qdma(1280)
    assert gates.fits_tower_qdma(768) and gates.fits_tower_qdma(1024)
    assert jtk.tower_qdma_tile(1, 577, 1024, 4096) == 0 and gates.fits_tower_qdma(1024)


def test_qdma_refusal_and_bf16_weights():
    """int8 weights at W 1280 are refused on every device, as the JAX
    assertion refuses them (same message head; JAX's bf16 activations, since
    in fp32 its plain tower's VMEM budget refuses W 1280 first); bf16 weights with
    ``quant_dma=True`` take #4's twin, as JAX's ``if quant and quant_dma``."""
    rs = np.random.RandomState(3)
    w, inter, heads = 1280, 5120, 16
    x = torch.from_numpy(rs.randn(1, 4, w).astype(np.float32))
    layer = tuple(torch.from_numpy((0.02 * rs.randn(*shape)).astype(np.float32))
                  for shape in ((w,), (w,), (3 * w, w), (3 * w,), (w, w), (w,), (w,), (w,),
                                (inter, w), (inter,), (w, inter), (w,)))
    qlayer = tuple(tq.quantize_weight(t) if i in (2, 4, 8, 10) else t
                   for i, t in enumerate(layer))
    with pytest.raises(ValueError, match="qdma cell does not exist at b=1 s=4 w=1280"):
        tk.fused_tower(x, None, [qlayer], heads, 1e-5, "quick_gelu", False, quant_dma=True)
    p = {k: np.ascontiguousarray(layer[i].numpy().T if k in LINEAR else layer[i].numpy())[None]
         for i, k in enumerate(ORDER)}
    with pytest.raises(AssertionError, match="qdma cell does not exist at b=1 s=4 w=1280"):
        jtk.fused_tower(jnp.asarray(x.numpy(), jnp.bfloat16), None,
                        *(jq.quantize_weight(jnp.asarray(p[k])) if k in LINEAR
                          else jnp.asarray(p[k]) for k in ORDER),
                        heads, 1e-5, "quick_gelu", False, interpret=True, quant_dma=True)
    # bf16 (here fp32) weights: #4's twin, with or without the flag
    got = tk.fused_tower(x, None, [layer], heads, 1e-5, "quick_gelu", False, quant_dma=True)
    assert torch.equal(got, tk.tower_math(x, None, [layer], heads, 1e-5, "quick_gelu", False))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("post_ln,act,masked", FORMS)
def test_dh80_tower_twin_matches_pallas(post_ln, act, masked, quant):
    """The whole-tower twin at heads of 80 (the tower.cu instance that serves
    ViT-H-14's image tower) against JAX ``fused_tower`` in interpret mode: W
    640, 8 heads of 80, I 2560, 2 layers, S 12, bf16 (here fp32) and int8
    weights. (JAX needs W % 128 == 0, which no smaller dh-80 width meets.)"""
    B, S, W, I, heads = 2, 12, 640, 2560, 8
    p = _stacked(2, W, I, seed=21)
    for k in LINEAR:   # std 0.1 at the fan-in of 128 of the JAX tests, scaled to this one's
        p[k] = (p[k] * np.sqrt(128.0 / p[k].shape[1])).astype(np.float32)
    x, kb = _inputs(B, S, W, masked, 17)
    ref = _jax_tower(x, kb, p, heads, act, post_ln, quant)
    out = tk.fused_tower(torch.from_numpy(x), None if kb is None else torch.from_numpy(kb),
                         _port_layers(p, quantize=quant), heads, 1e-5, act, post_ln)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("name", [n for n in tconfigs.MODEL_INFO if not n.startswith("RN")])
def test_tower_route_matches_jax(name, monkeypatch):
    """For every published ViT model, image and text tower, bf16 and int8, at
    batch 1: the port's ``gates.tower_route`` holds exactly where the JAX
    ``_tower_route`` holds (vit.py:121-130, bert.py:107-118) on the kernel
    route (``use_kernel`` taken as True: it needs a CUDA tensor). ViT-H-14's
    image tower now takes it."""
    vision, text, resolution = tconfigs.MODEL_INFO[name]
    cfg = tconfigs.with_resolution(tconfigs.load_config(f"{vision}@{text}"), resolution)
    v, t = cfg.vision, cfg.text
    monkeypatch.setattr(gates, "use_kernel", lambda x, impl: True)
    towers = (("image", v.seq_len, v.width, v.heads, 4 * v.width, True),
              ("text", 52, t.hidden_size, t.num_attention_heads, t.intermediate_size,
               t.hidden_act == "gelu" and jfb.fits_fused(52, t.hidden_size)))
    for tower, s, w, heads, inter, jax_form in towers:
        x = torch.empty(1, s, w, dtype=torch.bfloat16)
        for quant in (False, True):
            want = jax_form and jtk.fits_tower(1, s, w, inter, 2, quant=quant)
            assert gates.tower_route(x, "auto", tower, heads, inter, quant) == want, \
                (name, tower, quant)
    if name == "ViT-H-14":
        assert gates.tower_route(torch.empty(1, 257, 1280, dtype=torch.bfloat16), "auto",
                                 "image", 16, 5120, True)
