"""Kernel tests that need an NVIDIA GPU (Hopper, sm_90a) and nvcc; they skip
elsewhere. This file imports neither jax nor the JAX package, so on a
machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel chain is held against its plain-torch twin in bf16 at small
shapes. Bound: 4 bf16 ulps at the largest output magnitude (one rounding
flip in a chain moves an output by about one ulp)."""

import math

import pytest
import torch

from nans_clip_tpu_torch.ops import fused_block as fb
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops import layer_kernel as lk
from nans_clip_tpu_torch.ops.attention import attention
from nans_clip_tpu_torch.ops.gemm import linear
from nans_clip_tpu_torch.ops.layernorm import row_layer_norm

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(dev, w, inter, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, std=0.1, mean=0.0: (torch.randn(*s, generator=g, device=dev) * std
                                       + mean).to(torch.bfloat16)
    return [r(w, mean=1.0), r(w), r(3 * w, w, std=w ** -0.5), r(3 * w), r(w, w, std=w ** -0.5),
            r(w), r(w, mean=1.0), r(w), r(inter, w, std=w ** -0.5), r(inter),
            r(w, inter, std=inter ** -0.5), r(w)], r


def _close(got, want, n_ulps=4):
    top = float(want.float().abs().max())
    bound = n_ulps * 2.0 ** (math.floor(math.log2(top)) - 7)
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= bound


@pytest.mark.parametrize("b,s,w", [(3, 52, 128), (2, 197, 768), (2, 7, 128)])
def test_sub_blocks_match_twins(dev, b, s, w):
    heads = w // 64
    p, r = _params(dev, w, 4 * w, 0)
    x = r(b, s, w, std=1.0)
    kb = torch.zeros(b, s, device=dev)
    kb[0, s // 2:] = -10000.0
    attn, mlp = p[:6], p[6:]
    _close(fb.fused_attention_block(x, *attn, heads), fb._reference_block(x, *attn, heads, 1e-5))
    _close(fb.fused_bert_attention_block(x, *attn, kb, heads),
           fb._reference_block(x, *attn, heads, 1e-12, kb, True))
    _close(fb.fused_mlp_block(x, *mlp), fb._reference_mlp(x, *mlp, "quick_gelu", 1e-5, False))
    _close(fb.fused_mlp_block(x, *mlp, "gelu", 1e-12, True),
           fb._reference_mlp(x, *mlp, "gelu", 1e-12, True))
    _close(lk.fused_layer_block(x, *p, heads, 1e-12, "gelu", True, kb),
           lk.encoder_layer_math(x, *p, heads, 1e-12, "gelu", True, kb))


def test_long_sequence_attention(dev):
    """S = 577 (ViT-L/14 at 336 px): K and V of a head fill 166 KB of
    shared memory."""
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn(2 * 577, 3 * 1024, generator=g, device=dev).to(torch.bfloat16)
    from nans_clip_tpu_torch.ops.attention import attention_plain
    _close(attention(qkv, None, 2, 16), attention_plain(qkv, None, 2, 16), 1)


def test_unadmitted_inputs_raise(dev):
    x = torch.randn(4, 96, device=dev)
    w = torch.randn(128, 96, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        linear(x, w, torch.zeros(128, device=dev))
    with pytest.raises(ValueError, match="N="):
        linear(x.bfloat16(), w[:100].bfloat16(), torch.zeros(100, device=dev).bfloat16())
    with pytest.raises(ValueError, match="N=192"):   # tiny_config's width 64
        linear(x[:, :64].bfloat16().contiguous(), torch.zeros(192, 64, device=dev).bfloat16(),
               torch.zeros(192, device=dev).bfloat16())
    with pytest.raises(ValueError, match="width"):
        row_layer_norm(torch.randn(4, 2048, device=dev).bfloat16(),
                       torch.ones(2048, device=dev).bfloat16(),
                       torch.zeros(2048, device=dev).bfloat16(), 1e-5)
    qkv = torch.randn(8, 3 * 96, device=dev).bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        attention(qkv, None, 2, 1)


def test_routing_on_the_card(dev):
    assert gates.use_kernel(torch.zeros(1, device=dev, dtype=torch.bfloat16), "auto")
    for impl in ("auto", "kernel"):   # fp32 on the card reaches the twins only as "plain"
        with pytest.raises(ValueError, match="compute_dtype='bfloat16'"):
            gates.use_kernel(torch.zeros(1, device=dev), impl)
    assert not gates.use_kernel(torch.zeros(1, device=dev), "plain")
    assert not gates.use_kernel(torch.zeros(1, device=dev, dtype=torch.bfloat16), "plain")


def test_tiny_model_kernels_match_plain(dev):
    """A whole tiny-width model (W=128, two heads of 64) through the kernels
    against the plain path; launch counts show every layer went through."""
    import dataclasses

    from nans_clip_tpu_torch import configs
    from nans_clip_tpu_torch.api import CLIPModel
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.models.common import ModelOptions

    tiny = configs.tiny_config()
    cfg = dataclasses.replace(
        tiny, vision=dataclasses.replace(tiny.vision, width=128, head_width=64),
        text=dataclasses.replace(tiny.text, hidden_size=128, num_attention_heads=2,
                                 intermediate_size=512))
    models = [CLIPModel(cfg, build_clip(cfg, "cpu", torch.Generator().manual_seed(0)).to(dev),
                        ModelOptions(attn_impl=impl, compute_dtype="bfloat16"))
              for impl in ("kernel", "plain")]
    g = torch.Generator().manual_seed(0)
    images = torch.randn(3, 32, 32, 3, generator=g)
    ids = torch.zeros(3, 52, dtype=torch.long)
    ids[:, :5] = torch.randint(1, 1000, (3, 5), generator=g)
    fb.fused_attention_block.launches = lk.fused_layer_block.launches = 0
    li, _ = models[0].get_similarity(images, ids)
    assert fb.fused_attention_block.launches == 2 and lk.fused_layer_block.launches == 2
    pli, _ = models[1].get_similarity(images, ids)
    assert float((li - pli).abs().max()) <= 0.05
