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
    # N need only be a multiple of 64 in the forward form (tiny_config's
    # QKV width 192 runs); 160 is not
    x64 = x[:, :64].bfloat16().contiguous()
    assert linear(x64, torch.zeros(192, 64, device=dev).bfloat16(),
                  torch.zeros(192, device=dev).bfloat16()).shape == (4, 192)
    with pytest.raises(ValueError, match="N=160"):
        linear(x64, torch.zeros(160, 64, device=dev).bfloat16(),
               torch.zeros(160, device=dev).bfloat16())
    with pytest.raises(ValueError, match="width"):
        row_layer_norm(torch.randn(4, 4096, device=dev).bfloat16(),
                       torch.ones(4096, device=dev).bfloat16(),
                       torch.zeros(4096, device=dev).bfloat16(), 1e-5)
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
    # a batch above every tower gate, so each layer takes the per-layer kernels
    b = max(gates.TOWER_MAX_BATCH.values()) + 1
    g = torch.Generator().manual_seed(0)
    images = torch.randn(b, 32, 32, 3, generator=g)
    ids = torch.zeros(b, 52, dtype=torch.long)
    ids[:, :5] = torch.randint(1, 1000, (b, 5), generator=g)
    fb.fused_attention_block.launches = lk.fused_layer_block.launches = 0
    li, _ = models[0].get_similarity(images, ids)
    assert fb.fused_attention_block.launches == 2 and lk.fused_layer_block.launches == 2
    pli, _ = models[1].get_similarity(images, ids)
    assert float((li - pli).abs().max()) <= 0.05


# -- the whole-tower kernel (tower.cu) -----------------------------------------

def _tower_layers(dev, n_layers, w, seed, quantize):
    from nans_clip_tpu_torch.utils.quantize import quantize_weight
    layers = []
    for layer in range(n_layers):
        p, _ = _params(dev, w, 4 * w, seed + layer)
        layers.append(tuple(quantize_weight(t) if quantize and i in (2, 4, 8, 10) else t
                            for i, t in enumerate(p)))
    return layers


def _tower_case(dev, b, s, w, post_ln, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, s, w, generator=g, device=dev).to(torch.bfloat16)
    kb = None
    if post_ln:
        lengths = torch.randint(2, s + 1, (b,), generator=g, device=dev)
        keep = torch.arange(s, device=dev)[None, :] < lengths[:, None]
        kb = ((1.0 - keep.float()) * -10000.0).contiguous()
    return x, kb


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("n_layers,b,s,w", [(2, 3, 37, 128), (2, 1, 197, 768), (2, 2, 52, 768)])
def test_tower_matches_twin(dev, n_layers, b, s, w, post_ln, quantize):
    """Both forms, bf16 and int8, small and full width. Bound: 4 bf16 ulps
    (two layers, each a chain whose rounding flips move an output by about
    one ulp)."""
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    layers = _tower_layers(dev, n_layers, w, 3, quantize)
    x, kb = _tower_case(dev, b, s, w, post_ln)
    args = (x, kb, layers, w // 64, 1e-12 if post_ln else 1e-5,
            "gelu" if post_ln else "quick_gelu", post_ln)
    before = (tk.fused_tower.launches, tk.fused_tower.launches_int8)
    got = tk.fused_tower(*args)
    want = tk.tower_math(*args)
    torch.cuda.synchronize()
    _close(got, want, 4)
    assert (tk.fused_tower.launches - before[0], tk.fused_tower.launches_int8 - before[1]) == \
        ((0, 1) if quantize else (1, 0))


def test_tower_admission_raises(dev):
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    layers = _tower_layers(dev, 1, 128, 0, False)
    x = torch.zeros(1, 641, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="S=641"):
        tk.fused_tower(x, None, layers, 2, 1e-5, "quick_gelu", False)
    p, _ = _params(dev, 96, 384, 0)   # W = 96: not a multiple of 64
    with pytest.raises(ValueError, match="W=96"):
        tk.fused_tower(torch.zeros(1, 8, 96, device=dev, dtype=torch.bfloat16), None, [tuple(p)],
                       1, 1e-5, "quick_gelu", False)
    with pytest.raises(ValueError, match="dtype"):
        tk.fused_tower(torch.zeros(1, 8, 128, device=dev), None, layers, 2, 1e-5, "quick_gelu",
                       False)


def test_tower_oversized_grid_raises(dev):
    """A grid beyond co-residency is refused by the cooperative launch and
    raises; it never runs (its barrier would wait forever)."""
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    layers = _tower_layers(dev, 1, 128, 0, False)
    x, _ = _tower_case(dev, 1, 52, 128, False)
    grid = tk.max_grid(torch.cuda.current_device(), False, 52)
    with pytest.raises(RuntimeError, match="CooperativeLaunchTooLarge"):
        tk.fused_tower(x, None, layers, 2, 1e-5, "quick_gelu", False, grid=grid + 1)
    torch.cuda.synchronize()
    _close(tk.fused_tower(x, None, layers, 2, 1e-5, "quick_gelu", False, grid=grid),
           tk.tower_math(x, None, layers, 2, 1e-5, "quick_gelu", False), 4)


@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("n_layers,b,s,w", [(1, 1, 52, 128), (2, 3, 37, 128), (3, 1, 197, 768),
                                            (2, 2, 52, 768), (2, 1, 52, 1024), (2, 8, 52, 768)])
def test_qdma_tower_matches_int8_and_twin(dev, n_layers, b, s, w, post_ln):
    """The dequant-ahead instance (#6): bit-equal to #5 at the same grid (the
    same bf16 weights, K-splits and mma order), within 4 bf16 ulps of the
    twin at its own grid; one layer (the prologue alone) included, and batch
    8, where the attention stage leaves no block idle."""
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    layers = _tower_layers(dev, n_layers, w, 5, True)
    x, kb = _tower_case(dev, b, s, w, post_ln)
    args = (x, kb, layers, w // 64, 1e-12 if post_ln else 1e-5,
            "gelu" if post_ln else "quick_gelu", post_ln)
    idx = torch.cuda.current_device()
    grid = min(tk.max_grid(idx, tk.MODE_INT8, s), tk.max_grid(idx, tk.MODE_QDMA, s))
    before = (tk.fused_tower.launches_int8, tk.fused_tower.launches_qdma)
    got = tk.fused_tower(*args, quant_dma=True)
    same6 = tk.fused_tower(*args, grid=grid, quant_dma=True)
    same5 = tk.fused_tower(*args, grid=grid)
    torch.cuda.synchronize()
    assert torch.equal(same6, same5)
    _close(got, tk.tower_math(*args), 4)
    assert (tk.fused_tower.launches_int8 - before[0], tk.fused_tower.launches_qdma - before[1]) \
        == (1, 2)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("post_ln", [False, True])
@pytest.mark.parametrize("b,s,w", [(2, 37, 640), (1, 257, 1280)])
def test_tower_heads_of_80_matches_twin(dev, b, s, w, post_ln, quantize):
    """tower.cu's dh-80 instance (ViT-H-14's image tower at W 1280; 5 column
    pairs a thread in the row stages), bf16 and int8, 2 layers, against the
    twin: 4 bf16 ulps, as the dh-64 instance."""
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    layers = _tower_layers(dev, 2, w, 9, quantize)
    x, kb = _tower_case(dev, b, s, w, post_ln)
    args = (x, kb, layers, w // 80, 1e-12 if post_ln else 1e-5,
            "gelu" if post_ln else "quick_gelu", post_ln)
    _close(tk.fused_tower(*args), tk.tower_math(*args), 4)
    if quantize:   # #6: W <= 1024 (the JAX rule) and heads of 64 (its only instance)
        with pytest.raises(ValueError, match="qdma cell does not exist" if w > 1024
                           else "heads of 64 only"):
            tk.fused_tower(*args, quant_dma=True)


def test_batch_1_encodes_route_one_tower_launch(dev):
    """A tiny-width model (heads of 64) at batch 1: each encode is one tower
    launch and no per-layer launch; its int8 copy makes int8 launches."""
    import dataclasses

    from nans_clip_tpu_torch import configs
    from nans_clip_tpu_torch.api import model_from_config
    from nans_clip_tpu_torch.models.common import ModelOptions
    from nans_clip_tpu_torch.ops import tower_kernel as tk

    tiny = configs.tiny_config()
    cfg = dataclasses.replace(
        tiny, vision=dataclasses.replace(tiny.vision, width=128, head_width=64),
        text=dataclasses.replace(tiny.text, hidden_size=128, num_attention_heads=2,
                                 intermediate_size=512))
    model = model_from_config(cfg, device=dev, options=ModelOptions(compute_dtype="bfloat16"))
    plain = model_from_config(cfg, device=dev, options=ModelOptions(attn_impl="plain",
                                                                  compute_dtype="bfloat16"))
    g = torch.Generator().manual_seed(0)
    images = torch.randn(1, 32, 32, 3, generator=g)
    ids = torch.zeros(1, 52, dtype=torch.long)
    ids[:, :5] = torch.randint(1, 1000, (1, 5), generator=g)
    counted = (fb.fused_attention_block, fb.fused_mlp_block, lk.fused_layer_block, linear,
               attention, row_layer_norm)
    for quantized in (False, True):
        m, p = (model.quantize(), plain.quantize()) if quantized else (model, plain)
        for fn in counted:
            fn.launches = 0
        tk.fused_tower.launches = tk.fused_tower.launches_int8 = 0
        img, txt = m.encode_image(images), m.encode_text(ids)
        towers = tk.fused_tower.launches_int8 if quantized else tk.fused_tower.launches
        assert towers == 2 and sum(fn.launches for fn in counted) == 0
        assert float((img - p.encode_image(images)).abs().max()) <= 0.05
        assert float((txt - p.encode_text(ids)).abs().max()) <= 0.05


# -- training: the backward kernels and dropout --------------------------------

def _rel_err(got, want):
    """Max abs difference over the largest magnitude of ``want``."""
    top = max(float(want.float().abs().max()), 1e-30)
    assert torch.isfinite(got).all()
    return float((got.float() - want.float()).abs().max()) / top


def _rnd(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda *s, std=1.0: (torch.randn(*s, generator=g, device=dev) * std).to(torch.bfloat16)


def test_gemm_forms_match_twins(dev):
    """Forward epilogues (pre-activation copy, fp32 residual, dropout), the
    input gradient (act' epilogue, bf16 copy) and the K-split weight
    gradient against their twins. Bounds: 2 bf16 ulps for bf16 outputs, 1e-5
    of the largest magnitude for fp32 ones (fp32 sums in another order)."""
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.gemm import (linear_dgrad, linear_dgrad_plain, linear_plain,
                                              linear_wgrad, linear_wgrad_plain)
    r = _rnd(dev, 5)
    a, w, bias = r(300, 256), r(384, 256, std=0.1), r(384)
    res32 = torch.randn(300, 384, device=dev)
    spec = drop.Dropout(11, 0.1, drop.STREAM_HIDDEN, 100)
    got, pre = linear(a, w, bias, act="quick_gelu", pre_out=True)
    want, want_pre = linear_plain(a, w, bias, act="quick_gelu", pre_out=True)
    _close(got, want, 2)
    assert _rel_err(pre, want_pre) <= 1e-5
    kw = dict(act="gelu", residual=res32, out_dtype=torch.float32, dropout=spec)
    assert _rel_err(linear(a, w, bias, **kw), linear_plain(a, w, bias, **kw)) <= 1e-5
    # the kernel's keep multipliers are the twin's, bit for bit
    ones = torch.ones(384, device=dev, dtype=torch.bfloat16)
    mult = linear(torch.zeros_like(a), w, ones, out_dtype=torch.float32, dropout=spec)
    assert torch.equal(mult, drop.hidden_multiplier(spec, 300, 384, dev))
    dy, h_pre = r(300, 384), torch.randn(300, 256, device=dev)
    got, got16 = linear_dgrad(dy, w, "gelu", h_pre, out_dtype=torch.float32, copy=True)
    want, want16 = linear_dgrad_plain(dy, w, "gelu", h_pre, out_dtype=torch.float32, copy=True)
    assert _rel_err(got, want) <= 1e-5
    _close(got16, want16, 2)
    res = torch.randn(300, 256, device=dev)
    _close(linear_dgrad(dy, w, residual=res), linear_dgrad_plain(dy, w, residual=res), 2)
    # the bf16 copy is the value before the residual
    got, got16 = linear_dgrad(dy, w, residual=res, copy=True)
    _close(got, linear_dgrad_plain(dy, w, residual=res), 2)
    assert torch.equal(got16, linear_dgrad(dy, w))
    for m, n, k in ((300, 384, 256), (6656, 768, 768)):
        dy, x = r(m, n), r(m, k)
        got = linear_wgrad(dy, x)
        assert got.shape == (n, k) and _rel_err(got, linear_wgrad_plain(dy, x)) <= 1e-5
        assert torch.equal(got, linear_wgrad(dy, x))   # fixed summation order


def test_layernorm_bwd_and_colsum_match_twins(dev):
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.layernorm import layer_norm_bwd, layer_norm_bwd_plain
    from nans_clip_tpu_torch.ops.reduce import column_sum, column_sum_plain
    r = _rnd(dev, 6)
    rows, w = 2 * 197, 768
    x, g, gamma = r(rows, w), r(rows, w), r(w, std=0.1) + 1
    dxn = torch.randn(rows, w, device=dev)
    got = layer_norm_bwd(dxn, x, gamma, 1e-5, residual=g, out_dtype=torch.bfloat16)
    want = layer_norm_bwd_plain(dxn, x, gamma, 1e-5, residual=g, out_dtype=torch.bfloat16)
    _close(got[0], want[0], 2)
    for a, b in zip(got[1:3], want[1:3]):
        assert _rel_err(a, b) <= 1e-5
    u = torch.randn(rows, w, device=dev)
    spec = drop.Dropout(3, 0.1, drop.STREAM_HIDDEN, 197)
    kw = dict(out_dtype=torch.float32, emit_dproj=True, dropout=spec)
    got, want = layer_norm_bwd(g, u, gamma, 1e-12, **kw), layer_norm_bwd_plain(g, u, gamma,
                                                                               1e-12, **kw)
    for i in (0, 1, 2, 4):
        assert _rel_err(got[i], want[i]) <= 1e-5
    _close(got[3], want[3], 2)
    # the emitting form: x-hat in bf16, no sums, the same dx and dproj bits
    kw.update(emit_xhat=True, sums=False)
    emit, want = layer_norm_bwd(g, u, gamma, 1e-12, **kw), layer_norm_bwd_plain(g, u, gamma,
                                                                                1e-12, **kw)
    assert len(emit) == 6 and emit[1] is emit[2] is emit[4] is None
    assert torch.equal(emit[0], got[0]) and torch.equal(emit[3], got[3])
    assert emit[5].dtype == torch.bfloat16
    _close(emit[5], want[5], 2)
    big = torch.randn(25216, 2304, device=dev)
    assert _rel_err(column_sum(big), column_sum_plain(big)) <= 1e-5
    assert torch.equal(column_sum(big), column_sum(big))


@pytest.mark.parametrize("b,s,masked,rate", [(3, 52, True, 0.1), (2, 197, False, 0.0),
                                             (2, 7, True, 0.0)])
def test_attention_bwd_matches_twin(dev, b, s, masked, rate):
    """The forward with probability dropout and the backward against their
    twins. Bounds: 2 bf16 ulps for ctx; dqkv within 1e-2 of its largest
    magnitude (a bf16 rounding flip of dS or P_d moves a sum by one bf16
    ulp of a term)."""
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.attention import attention_bwd, attention_bwd_plain, \
        attention_plain
    r = _rnd(dev, 7)
    heads = 12
    qkv, dctx = r(b * s, 3 * 768), r(b * s, 768)
    kb = None
    if masked:
        kb = torch.zeros(b, s, device=dev)
        kb[0, s // 2:] = -10000.0
    spec = drop.Dropout(5, rate, drop.STREAM_ATTN)
    _close(attention(qkv, kb, b, heads, spec), attention_plain(qkv, kb, b, heads, spec), 2)
    got, got16 = attention_bwd(qkv, dctx, kb, b, heads, spec)
    want, _ = attention_bwd_plain(qkv, dctx, kb, b, heads, spec)
    assert _rel_err(got, want) <= 1e-2
    assert torch.equal(got16, got.to(torch.bfloat16))


@pytest.mark.parametrize("b,s,w", [(3, 52, 128), (2, 197, 768)])
def test_bwd_chains_match_twins(dev, b, s, w):
    """#14, #16 (dropout 0.1) and #18 (both forms) against their twins; each
    gradient within 2e-2 of its largest magnitude (bf16 rounding flips of
    the recomputed activations, dqkv, dS, dproj and dh_pre), and the same
    bits on a second call."""
    from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
    p, r = _params(dev, w, 4 * w, 8)
    x, g = r(b, s, w, std=1.0), r(b, s, w, std=1.0)
    kb = torch.zeros(b, s, device=dev)
    kb[0, s // 2:] = -10000.0
    heads = w // 64
    cases = [
        (fbb.fused_attention_block_bwd_fullgrad, fbb._attn_bwd_math,
         (x, *p[:5], g, heads, 1e-5)),
        (fbb.fused_bert_attention_block_bwd_fullgrad, fbb._bert_bwd_math,
         (x, *p[:6], kb, 1234, g, heads, 1e-12, 0.1, 0.1)),
        (fbb.fused_mlp_block_bwd_fullgrad, fbb._mlp_bwd_math,
         (x, *p[6:], None, g, "quick_gelu", 1e-5, False, 0.0)),
        (fbb.fused_mlp_block_bwd_fullgrad, fbb._mlp_bwd_math,
         (x, *p[6:], 99, g, "gelu", 1e-12, True, 0.1)),
    ]
    for kernel, twin, args in cases:
        got, want = kernel(*args), twin(*args)
        assert [t.shape for t in got] == [t.shape for t in want]
        for a, bb in zip(got, want):
            assert _rel_err(a, bb) <= 2e-2, (kernel.__name__, a.shape)
        assert all(torch.equal(a, bb) for a, bb in zip(got, kernel(*args)))


def test_train_step_kernel_matches_plain(dev):
    """A tiny-width model (W=128, heads of 64) takes one train step on the
    kernel route and one on the plain route from the same weights: the
    losses agree and every gradient points the same way. Gradients that are
    zero in exact arithmetic (the key biases: softmax ignores a shift shared
    by all keys) are bf16 noise on both routes; a tensor whose plain
    gradient stays below 1e-4 of the largest gradient is not compared."""
    import dataclasses

    from nans_clip_tpu_torch import configs
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.models.common import ModelOptions
    from nans_clip_tpu_torch.training import TrainConfig, create_train_state, make_train_step

    tiny = configs.tiny_config()
    cfg = dataclasses.replace(
        tiny, vision=dataclasses.replace(tiny.vision, width=128, head_width=64),
        text=dataclasses.replace(tiny.text, hidden_size=128, num_attention_heads=2,
                                 intermediate_size=512))
    tcfg = TrainConfig(lr=1e-3, warmup=1, max_steps=10)
    g = torch.Generator().manual_seed(0)
    images = torch.randn(8, 32, 32, 3, generator=g)
    ids = torch.zeros(8, 52, dtype=torch.long)
    ids[:, :9] = torch.randint(1, 1000, (8, 9), generator=g)
    out = {}
    for impl in ("kernel", "plain"):
        state = create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)),
                                   tcfg, device=dev)
        step = make_train_step(cfg, tcfg, ModelOptions(attn_impl=impl, compute_dtype="bfloat16",
                                                       deterministic=False))
        state, metrics = step(state, images, ids, 7)
        grads = {n: p.grad.clone() for n, p in state.module.named_parameters()}
        out[impl] = (float(metrics["loss"]), grads)
    assert abs(out["kernel"][0] - out["plain"][0]) <= 1e-2
    top = max(float(g.abs().max()) for g in out["plain"][1].values())
    for n, gk in out["kernel"][1].items():
        gp = out["plain"][1][n]
        if float(gp.abs().max()) < 1e-4 * top:
            continue
        cos = torch.nn.functional.cosine_similarity(gk.flatten().double(),
                                                    gp.flatten().double(), dim=0)
        assert float(cos) >= 0.99, (n, float(cos))


@pytest.mark.parametrize("b,s,w", [(3, 52, 128), (2, 197, 768), (2, 99, 128)])
def test_emitting_bwd_chains_match_twins(dev, b, s, w):
    """#13, #15 (dropout 0.1) and #17 (both forms) against their twins:
    every emitted tensor in bf16 within 2e-2 of its largest magnitude (the
    bound of the full-gradient chains), the same bits on a second call, and
    dx bit-equal to the full-gradient chain's (the same kernels in the same
    order form it). S = 99 is the FLIP sequence at mask_ratio 0.5."""
    from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
    p, r = _params(dev, w, 4 * w, 9)
    x, g = r(b, s, w, std=1.0), r(b, s, w, std=1.0)
    kb = torch.zeros(b, s, device=dev)
    kb[0, s // 2:] = -10000.0
    heads = w // 64
    cases = [
        (fbb.fused_attention_block_bwd, fbb.fused_attention_block_bwd_fullgrad,
         fbb._attn_bwd_math, (x, *p[:5], g, heads, 1e-5), 4),
        (fbb.fused_bert_attention_block_bwd, fbb.fused_bert_attention_block_bwd_fullgrad,
         fbb._bert_bwd_math, (x, *p[:6], kb, 1234, g, heads, 1e-12, 0.1, 0.1), 5),
        (fbb.fused_mlp_block_bwd, fbb.fused_mlp_block_bwd_fullgrad, fbb._mlp_bwd_math,
         (x, *p[6:], None, g, "quick_gelu", 1e-5, False, 0.0), 7),
        (fbb.fused_mlp_block_bwd, fbb.fused_mlp_block_bwd_fullgrad, fbb._mlp_bwd_math,
         (x, *p[6:], 99, g, "gelu", 1e-12, True, 0.1), 7),
    ]
    for kernel, full, twin, args, n_out in cases:
        before = kernel.launches
        got, want = kernel(*args), twin(*args, full=False)
        assert kernel.launches == before + 1 and len(got) == n_out
        for a, bb in zip(got, want):
            assert a.shape == bb.shape and a.dtype == torch.bfloat16
            assert _rel_err(a, bb) <= 2e-2, (kernel.__name__, a.shape)
        assert all(torch.equal(a, bb) for a, bb in zip(got, kernel(*args)))
        assert torch.equal(got[0], full(*args)[0])


def test_layer_bwd_equals_the_two_chains(dev):
    """#21 is bit-equal to #18 followed by #14, and within 2e-2 of its
    twin on each of its 13 outputs."""
    from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
    from nans_clip_tpu_torch.ops import layer_bwd as lb
    b, s, w = 2, 197, 768
    p, r = _params(dev, w, 4 * w, 10)
    x, g = r(b, s, w, std=1.0), r(b, s, w, std=1.0)
    xm = fb.fused_attention_block(x, *p[:6], w // 64, 1e-5)
    args = (x, *p[:5], xm, *p[6:], g, w // 64, "quick_gelu", 1e-5)
    before = lb.fused_layer_block_bwd_fullgrad.launches
    got = lb.fused_layer_block_bwd_fullgrad(*args)
    assert lb.fused_layer_block_bwd_fullgrad.launches == before + 1 and len(got) == 13
    mlp = fbb.fused_mlp_block_bwd_fullgrad(xm, *p[6:], None, g, "quick_gelu", 1e-5, False)
    attn = fbb.fused_attention_block_bwd_fullgrad(x, *p[:5], mlp[0], w // 64, 1e-5)
    assert all(torch.equal(a, bb) for a, bb in zip(got, attn + mlp[1:]))
    for a, bb in zip(got, lb._layer_bwd_math(*args)):
        assert _rel_err(a, bb) <= 2e-2


def test_lora_step_kernel_matches_plain(dev):
    """A W=128 model takes LoRA steps (accum 2, dropout on) on the kernel
    route and on the plain route from the same adapters and seeds: the
    losses agree within 1e-2 and each adapter gradient at cosine >= 0.99
    (B away from zero); the kernel route launches #13/#15/#17 and no
    weight-gradient kernel; the base weights stay bit-equal."""
    import dataclasses

    from nans_clip_tpu_torch import configs
    from nans_clip_tpu_torch.models import lora
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.models.common import ModelOptions
    from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
    from nans_clip_tpu_torch.ops.gemm import linear_wgrad
    from nans_clip_tpu_torch.training import train_lora

    tiny = configs.tiny_config()
    cfg = dataclasses.replace(
        tiny, vision=dataclasses.replace(tiny.vision, width=128, head_width=64),
        text=dataclasses.replace(tiny.text, hidden_size=128, num_attention_heads=2,
                                 intermediate_size=512))
    g = torch.Generator().manual_seed(0)
    images = torch.randn(8, 32, 32, 3, generator=g)
    ids = torch.zeros(8, 52, dtype=torch.long)
    ids[:, :9] = torch.randint(1, 1000, (8, 9), generator=g)
    out = {}
    for impl in ("kernel", "plain"):
        module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0))
        ad = lora.init_lora(torch.Generator().manual_seed(1), module, 4, device=dev)
        with torch.no_grad():
            for k, t in lora._leaves(ad):
                if k.endswith("['b']"):     # B away from zero, the same on both routes
                    t.copy_(0.05 * torch.randn(t.shape,
                                               generator=torch.Generator().manual_seed(2)))
        state = train_lora.create_lora_state(module, ad, 1e-3, 0.01, device=dev)
        before = {n: p.detach().clone() for n, p in module.named_parameters()}
        step, _ = train_lora.make_lora_step(cfg, ModelOptions(attn_impl=impl,
                                                              compute_dtype="bfloat16"),
                                            16.0, 0.05, 2)
        counts = [fn.launches for fn in (fbb.fused_attention_block_bwd,
                                         fbb.fused_bert_attention_block_bwd,
                                         fbb.fused_mlp_block_bwd, linear_wgrad)]
        state, loss, _ = step(state, images, ids, 7)
        delta = [fn.launches - c for fn, c in zip(
            (fbb.fused_attention_block_bwd, fbb.fused_bert_attention_block_bwd,
             fbb.fused_mlp_block_bwd, linear_wgrad), counts)]
        assert delta == ([4, 4, 8, 0] if impl == "kernel" else [0, 0, 0, 0])
        assert all(torch.equal(p.detach(), before[n]) for n, p in module.named_parameters())
        out[impl] = (float(loss), {k: t.grad.clone() for k, t in lora._leaves(ad)})
    assert abs(out["kernel"][0] - out["plain"][0]) <= 1e-2
    for k, gk in out["kernel"][1].items():
        cos = torch.nn.functional.cosine_similarity(gk.flatten().double(),
                                                    out["plain"][1][k].flatten().double(), dim=0)
        assert float(cos) >= 0.99, (k, float(cos))


@pytest.mark.parametrize("w", [1280, 2048])
def test_wide_layernorm_matches_twin(dev, w):
    """Rows above 1024 (one block a row): the forward from bf16 and fp32,
    the backward in every form, against the twins."""
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.layernorm import layer_norm, layer_norm_bwd, layer_norm_bwd_plain
    r = _rnd(dev, 11)
    rows = 2 * 257
    x, g, gamma, beta = r(rows, w), r(rows, w), r(w, std=0.1) + 1, r(w, std=0.1)
    _close(row_layer_norm(x, gamma, beta, 1e-5), layer_norm(x, gamma, beta, 1e-5), 1)
    u = torch.randn(rows, w, device=dev)
    _close(row_layer_norm(u, gamma, beta, 1e-12),
           layer_norm(u, gamma, beta, 1e-12, out_dtype=torch.bfloat16), 1)
    dxn = torch.randn(rows, w, device=dev)
    got = layer_norm_bwd(dxn, x, gamma, 1e-5, residual=g, out_dtype=torch.bfloat16)
    want = layer_norm_bwd_plain(dxn, x, gamma, 1e-5, residual=g, out_dtype=torch.bfloat16)
    _close(got[0], want[0], 2)
    for a, b in zip(got[1:3], want[1:3]):
        assert _rel_err(a, b) <= 1e-5
    spec = drop.Dropout(3, 0.1, drop.STREAM_HIDDEN, 257)
    kw = dict(out_dtype=torch.float32, emit_dproj=True, dropout=spec)
    got = layer_norm_bwd(g, u, gamma, 1e-12, **kw)
    want = layer_norm_bwd_plain(g, u, gamma, 1e-12, **kw)
    for i in (0, 1, 2, 4):
        assert _rel_err(got[i], want[i]) <= 1e-5
    _close(got[3], want[3], 2)
    kw.update(emit_xhat=True, sums=False)
    emit = layer_norm_bwd(g, u, gamma, 1e-12, **kw)
    assert torch.equal(emit[0], got[0]) and torch.equal(emit[3], got[3])
    _close(emit[5], layer_norm_bwd_plain(g, u, gamma, 1e-12, **kw)[5], 2)


@pytest.mark.parametrize("s,w,heads", [(257, 1280, 16), (577, 1280, 16), (577, 1024, 16),
                                       (640, 1280, 16), (330, 128, 2)])
def test_wide_attention_matches_twin(dev, s, w, heads):
    """Heads of 80 and sequences above the one-shot backward's 320: the
    forward, and the backward from the forward's row statistics (one-shot
    up to S = 320, the long-sequence pair above) within 1e-2 of dqkv's
    largest magnitude, the same bits on a second call and without the
    statistics given (one forward forms them)."""
    from nans_clip_tpu_torch.ops.attention import attention_bwd, attention_bwd_plain, \
        attention_plain
    r = _rnd(dev, 12)
    b = 2
    qkv, dctx = r(b * s, 3 * w), r(b * s, w)
    ctx, st = attention(qkv, None, b, heads, stats=True)
    _close(ctx, attention_plain(qkv, None, b, heads), 2)
    got, got16 = attention_bwd(qkv, dctx, None, b, heads, stats=st)
    want, _ = attention_bwd_plain(qkv, dctx, None, b, heads)
    assert _rel_err(got, want) <= 1e-2
    assert torch.equal(got16, got.to(torch.bfloat16))
    assert torch.equal(attention_bwd(qkv, dctx, None, b, heads, stats=st)[0], got)
    assert torch.equal(attention_bwd(qkv, dctx, None, b, heads)[0], got)
    if s > gates.ATTN_BWD_MAX_SEQ:
        kb = torch.zeros(b, s, device=dev)
        with pytest.raises(ValueError, match="no key bias"):
            attention_bwd(qkv, dctx, kb, b, heads)


def test_wide_chains_match_twins(dev):
    """#7, #8, #9, #10, #19 and #20 at ViT-H widths (W 1280, heads of 80,
    I 5120) and S = 577, batch 2, against their twins; each backward output
    within 2e-2 of its largest magnitude and the same bits on a second
    call."""
    from nans_clip_tpu_torch.ops import fused_block_bwd as fbb
    w, s, b, heads = 1280, 577, 2, 16
    p, r = _params(dev, w, 4 * w, 13)
    x, g = r(b, s, w, std=1.0), r(b, s, w, std=1.0)
    for tile in (1, 2):
        _close(fb.fused_attention_block_wide(x, *p[:6], heads, 1e-5, 4, False, tile),
               fb._reference_block(x, *p[:6], heads, 1e-5))
    mlp_ref = fb._reference_mlp(x, *p[6:], "quick_gelu", 1e-5, False)
    _close(fb._fused_mlp_tiled_call(x, *p[6:], "quick_gelu", 1e-5, False, False, 512), mlp_ref)
    _close(fb._fused_mlp_batched_call(x, *p[6:], "quick_gelu", 1e-5, False, False, 512, 2),
           mlp_ref)
    mlp = (x, *p[6:11], g, "quick_gelu", 1e-5)
    attn = (x, *p[:5], g, heads, 1e-5)
    cases = [(lambda: fbb.fused_mlp_block_bwd_chunked(*mlp, 512, 2),
              lambda: [t for i, t in enumerate(fbb._mlp_bwd_math(
                  x, *p[6:], None, g, "quick_gelu", 1e-5, False, 0.0, full=False))
                  if i in (0, 1, 2, 3, 6)]),
             (lambda: fbb.attention_bwd_long(*attn),
              lambda: fbb._attn_bwd_math(*attn, full=False))]
    for kernel, twin in cases:
        got, want = kernel(), twin()
        for a, bb in zip(got, want):
            assert a.shape == bb.shape and _rel_err(a, bb) <= 2e-2
        assert all(torch.equal(a, bb) for a, bb in zip(got, kernel()))
    _, _, ctx_h, dqkv_h = fbb.fused_attention_block_bwd_chunked(x, *p[:5], g, heads, 4)
    _, _, ctx, dqkv = got
    assert torch.equal(ctx_h[:, 1], ctx[:, :, 320:640])
    assert torch.equal(dqkv_h[:, 1, :, 320:640], dqkv[:, :, 1280 + 320:1280 + 640])


def test_wide_text_tower_matches_twin(dev):
    """tower.cu at RoBERTa-large's width (W 1024, 16 heads of 64, I 4096,
    S 52, post-LN, masked), 2 layers, batch 1 and 8, against its twin."""
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    w, s = 1024, 52
    layers = [_params(dev, w, 4 * w, 20 + i)[0] for i in range(2)]
    r = _rnd(dev, 14)
    for b in (1, 8):
        x = r(b, s, w, std=1.0)
        kb = torch.zeros(b, s, device=dev)
        kb[0, s // 2:] = -10000.0
        args = (x, kb, layers, 16, 1e-12, "gelu", True)
        _close(tk.fused_tower(*args), tk.tower_math(*args), 4)


# The attn_impl="pallas" route: #22 (o within 2 bf16 ulps of max|twin|: P is
# rounded to bf16 before P V on the card, kept fp32 by the twin; lse within
# 1e-4 of max(1, max|lse|)) and #23 (dq, dk, dv within 2e-2 of max|twin|, the
# same bits twice), the bounds of chip_smoke.py phase 10.
@pytest.mark.parametrize("b,h,s,dh,masked", [(3, 2, 52, 64, True), (2, 2, 197, 64, False),
                                             (2, 2, 257, 80, True), (1, 4, 577, 64, False),
                                             (1, 2, 1024, 64, True), (1, 2, 577, 80, False)])
def test_flash_attention_matches_twins(dev, b, h, s, dh, masked):
    from nans_clip_tpu_torch.ops import attention as A
    r = _rnd(dev, 30)
    q, k, v = r(b, s, 3, h, dh, std=1.0).permute(2, 0, 3, 1, 4).unbind(0)
    kb = None
    if masked:
        kb = torch.zeros(b, s, device=dev)
        kb[0, s // 3:] = -10000.0
    o, lse = A.flash_fwd(q, k, v, kb)
    o_t, lse_t = A.attention_pallas_plain(q, k, v, kb)
    _close(o, o_t, 2)
    assert float((lse - lse_t).abs().max()) <= 1e-4 * max(1.0, float(lse_t.abs().max()))
    do = r(b, h, s, dh, std=1.0)
    got = A.flash_bwd(q, k, v, kb, o, do, lse)
    for a, t in zip(got, A.attention_pallas_bwd_plain(q, k, v, kb, o, do, lse)):
        assert a.shape == t.shape and _rel_err(a, t) <= 2e-2
    assert all(torch.equal(a, t) for a, t in zip(got, A.flash_bwd(q, k, v, kb, o, do, lse)))
    # the Function: autograd through attention_pallas takes #23
    qs = [t.detach().requires_grad_() for t in (q, k, v)]
    out = A.attention_pallas(*qs, kb)
    assert torch.equal(out, o)
    out.backward(do)
    assert all(torch.equal(t.grad, a) for t, a in zip(qs, got))


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("s", [1, 15, 17, 64, 129, 1025])
def test_flash_fwd_edges_match_twin(dev, s, dh):
    """#22 at the edges of its tiles (a strip shorter than 16 rows, a last
    key tile of one 16-key step, S past MAX_PALLAS_SEQ), with one sample's
    keys all masked and q, k, v strided views of one packed projection: o
    within 2 bf16 ulps of max|twin|, lse within 1e-4 of max(1, max|lse|),
    the same bits on a second call."""
    from nans_clip_tpu_torch.ops import attention as A
    r = _rnd(dev, 40 + s)
    b, h = 2, 3
    q, k, v = r(b, s, 3, h, dh, std=1.0).permute(2, 0, 3, 1, 4).unbind(0)
    for kb in (None, torch.cat([torch.zeros(1, s, device=dev),
                                torch.full((1, s), -10000.0, device=dev)]).contiguous()):
        o, lse = A.flash_fwd(q, k, v, kb)
        o_t, lse_t = A.attention_pallas_plain(q, k, v, kb)
        _close(o, o_t, 2)
        assert float((lse - lse_t).abs().max()) <= 1e-4 * max(1.0, float(lse_t.abs().max()))
        o2, lse2 = A.flash_fwd(q, k, v, kb)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_attention_block_matches_twin(dev):
    """flash_attention_block, forward and the 7 gradients, against autograd
    through the same block with the flash twin (4 bf16 ulps; 2e-2 of
    max|twin| for the gradients)."""
    import torch.nn.functional as F

    from nans_clip_tpu_torch.ops import attention as A
    from nans_clip_tpu_torch.ops.layernorm import layer_norm
    b, s, w, heads = 2, 130, 128, 2
    p, r = _params(dev, w, 4 * w, 31)
    x, g = r(b, s, w, std=1.0), r(b, s, w, std=1.0)

    def twin(xr, lw, lb, wqkv, bqkv, wo, bo):
        qq, kk, vv = (A.split_heads(t, heads) for t in
                      F.linear(layer_norm(xr, lw, lb, 1e-5), wqkv, bqkv).chunk(3, -1))
        return xr + F.linear(A.merge_heads(A.attention_pallas_plain(qq, kk, vv)[0]), wo, bo)

    outs = []
    for fn in (lambda *a: A.flash_attention_block(*a, heads), twin):
        args = [t.detach().requires_grad_() for t in (x, *p[:6])]
        out = fn(*args)
        outs.append((out, *torch.autograd.grad(out, args, g)))
    _close(outs[0][0], outs[1][0], 4)
    for a, t in zip(outs[0][1:], outs[1][1:]):
        assert a.shape == t.shape and _rel_err(a, t) <= 2e-2


@pytest.mark.parametrize("rows,w", [(300, 768), (77, 1280), (5, 2048)])
def test_pallas_layer_norm_matches_twin(dev, rows, w):
    from nans_clip_tpu_torch.ops.layernorm import layer_norm, pallas_layer_norm
    r = _rnd(dev, 32)
    x, lw, lb = r(rows, w, std=1.0), (r(w, std=0.1) + 1.0).to(torch.bfloat16), r(w, std=0.1)
    before = pallas_layer_norm.launches
    _close(pallas_layer_norm(x, lw, lb), layer_norm(x, lw, lb), 1)
    assert pallas_layer_norm.launches == before + 1
    with pytest.raises(ValueError):
        pallas_layer_norm(x.float(), lw, lb)


def test_pallas_route_on_the_card(dev):
    """Under attn_impl="pallas" a bf16 model runs #22 in every layer of both
    towers and no fused kernel, within bf16 noise of the fused route; an
    fp32 CUDA tensor raises."""
    import dataclasses

    from nans_clip_tpu_torch import configs
    from nans_clip_tpu_torch.api import CLIPModel
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.models.common import ModelOptions
    from nans_clip_tpu_torch.ops import attention as A

    with pytest.raises(ValueError, match="compute_dtype='bfloat16'"):
        gates.pallas_attention_route(torch.zeros(1, device=dev), "pallas", 52, False)
    tiny = configs.tiny_config()
    cfg = dataclasses.replace(
        tiny, vision=dataclasses.replace(tiny.vision, width=128, head_width=64),
        text=dataclasses.replace(tiny.text, hidden_size=128, num_attention_heads=2,
                                 intermediate_size=512))
    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(0)).to(dev)
    models = {impl: CLIPModel(cfg, module, ModelOptions(attn_impl=impl, compute_dtype="bfloat16"))
              for impl in ("pallas", "fused")}
    g = torch.Generator().manual_seed(0)
    images = torch.randn(4, 32, 32, 3, generator=g)
    ids = torch.zeros(4, 52, dtype=torch.long)
    ids[:, :9] = torch.randint(1000, 2000, (4, 9), generator=g)
    before = A.flash_fwd.launches
    li = models["pallas"].get_similarity(images, ids)[0]
    assert A.flash_fwd.launches - before == cfg.vision.layers + cfg.text.num_hidden_layers
    assert float((li - models["fused"].get_similarity(images, ids)[0]).abs().max()) <= 0.05


@pytest.mark.parametrize("n,k", [(384, 256), (576, 768), (960, 1280), (192, 64)])
def test_gemm_n_tail_and_no_bias(dev, n, k):
    """The forward GEMM at N a multiple of 64 but not of 128 (the local QKV
    widths of tp 4: 576 at ViT-B, 960 at ViT-H) and without a bias, against
    its twin, 300 ragged rows: 2 bf16 ulps."""
    from nans_clip_tpu_torch.ops.gemm import linear_plain
    r = _rnd(dev, 6)
    a, w, bias = r(300, k), r(n, k, std=k ** -0.5), r(n)
    for b_ in (bias, None):
        _close(linear(a, w, b_), linear_plain(a, w, b_), 2)
        _close(linear(a, w, b_, act="quick_gelu"), linear_plain(a, w, b_, act="quick_gelu"), 2)
    res = r(300, n)
    _close(linear(a, w, None, residual=res), linear_plain(a, w, None, residual=res), 2)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("post_ln", [False, True])
def test_partial_kernels_match_twins(dev, tp, post_ln):
    """#11 and #12 at a rank's shapes (W 256, 4 heads of 64, I 1024) against
    their twins (4 bf16 ulps), and the tp ranks' partials summed with the
    residual and the output bias against the unsharded #1 / #2 (pre-LN; 8
    ulps: two chains' roundings); the backward (autograd through the twin)
    runs on the card."""
    from nans_clip_tpu_torch.parallel import mesh
    b, s, w, heads, inter = 2, 52, 256, 4, 1024
    p, r = _params(dev, w, inter, 3)
    x = r(b, s, w, std=1.0)
    kb = torch.zeros(b, s, device=dev)
    kb[0, s // 2:] = -10000.0
    key_bias = kb if post_ln else None
    eps = 1e-12 if post_ln else 1e-5
    act = "gelu" if post_ln else "quick_gelu"
    attn_sum = mlp_sum = 0
    for rank in range(tp):
        wq, bq = mesh.qkv_slice(p[2], p[3], heads, rank, tp)
        wo = mesh.column_slice(p[4], rank, tp)
        w1, b1 = mesh.row_slice(p[8], rank, tp), mesh.row_slice(p[9], rank, tp)
        w2 = mesh.column_slice(p[10], rank, tp)
        before = fb.fused_attention_block_partial.launches
        a = fb.fused_attention_block_partial(x, p[0], p[1], wq, bq, wo, key_bias, heads // tp,
                                             eps, not post_ln)
        assert fb.fused_attention_block_partial.launches == before + 1
        _close(a, fb._reference_block_partial(x, p[0], p[1], wq, bq, wo, heads // tp, eps,
                                              not post_ln, key_bias))
        m = fb.fused_mlp_block_partial(x, p[6], p[7], w1, b1, w2, act, eps, not post_ln)
        _close(m, fb._reference_mlp_partial(x, p[6], p[7], w1, b1, w2, act, eps, not post_ln))
        attn_sum = attn_sum + a.float()
        mlp_sum = mlp_sum + m.float()
    if not post_ln:
        _close((x.float() + attn_sum + p[5].float()).bfloat16(),
               fb.fused_attention_block(x, *p[:6], heads), 8)
        _close((x.float() + mlp_sum + p[11].float()).bfloat16(),
               fb.fused_mlp_block(x, *p[6:]), 8)
    leaves = [t.detach().clone().requires_grad_() for t in (x, p[0], p[1], wq, bq, wo)]
    out = fb.fused_attention_block_partial(*leaves, key_bias, heads // tp, eps, not post_ln)
    out.float().square().sum().backward()
    assert all(t.grad is None or torch.isfinite(t.grad).all() for t in leaves)


# -- the forward GEMM (wgmma + TMA) and the forward attention, redesigned ------

@pytest.mark.parametrize("n", [64, 192, 576, 768, 3072])
@pytest.mark.parametrize("m", [1, 7, 128, 1576, 50432])
def test_gemm_forward_forms_match_twin(dev, m, n):
    """The forward GEMM at K in {32, 96, 768, 3072}, each form against its
    twin within 1 bf16 ulp of max|twin| (the phase-1 bound of chip_smoke.py):
    the plain product with a bias, quick-GELU and erf-GELU, a bf16 residual
    without a bias, an fp32 output; the training forms (fp32 pre-activation,
    hidden dropout 0.1, fp32 residual, fp32 output) within 1e-5 of the
    largest magnitude (fp32 sums in another order); and every form gives the
    same bits on a second call."""
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.gemm import linear_plain
    r = _rnd(dev, m + n)
    for k in (32, 96, 768, 3072):
        a, w, bias = r(m, k), r(n, k, std=k ** -0.5), r(n)
        res = r(m, n)
        res32 = torch.randn(m, n, device=dev)
        forms = [dict(bias=bias), dict(bias=bias, act="quick_gelu"), dict(bias=bias, act="gelu"),
                 dict(bias=None, residual=res), dict(bias=bias, out_dtype=torch.float32)]
        for kw in forms:
            kw = dict(kw)
            b_ = kw.pop("bias")
            got = linear(a, w, b_, **kw)
            _close(got, linear_plain(a, w, b_, **kw), 1)
            assert torch.equal(got, linear(a, w, b_, **kw))
        spec = drop.Dropout(3, 0.1, drop.STREAM_HIDDEN, 1 if m < 7 else m)
        kw = dict(act="quick_gelu", residual=res32, out_dtype=torch.float32, dropout=spec,
                  pre_out=True)
        got, pre = linear(a, w, bias, **kw)
        want, want_pre = linear_plain(a, w, bias, **kw)
        assert _rel_err(got, want) <= 1e-5 and _rel_err(pre, want_pre) <= 1e-5
        got2, pre2 = linear(a, w, bias, **kw)
        assert torch.equal(got, got2) and torch.equal(pre, pre2)


def test_gemm_plan_matches_the_kernel(dev):
    """ops/gemm.py::gemm_plan computes the launch nans_gemm_plan reports."""
    import ctypes
    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.ops.gemm import gemm_plan
    out = (ctypes.c_int * 10)()
    for m, n, k in ((50432, 3072, 768), (1, 64, 32), (8224, 960, 1280), (25216, 768, 3072)):
        assert _build.library().nans_gemm_plan(m, n, k, out) == 0
        p = gemm_plan(m, n, k, out[7])
        assert list(out) == [*p["tile"], p["stages"], p["threads"], p["smem"], p["cluster"],
                             out[7], p["units"], p["grid"]]


# -- the backward GEMM forms (wgmma + TMA, MN-major operands) ------------------

def _dgrad_forms(every):
    """(output dtype, act', residual dtype, copy) of the input gradient:
    every combination, or the backward chains' forms
    (ops/fused_block_bwd.py)."""
    if not every:
        return [(torch.bfloat16, None, None, False), (torch.float32, None, None, False),
                (torch.float32, "quick_gelu", None, True), (torch.bfloat16, "quick_gelu", None,
                                                            False),
                (torch.float32, "gelu", None, True), (torch.bfloat16, None, torch.float32, True)]
    return [(out, act, res, copy) for out in (torch.bfloat16, torch.float32)
            for act in (None, "quick_gelu", "gelu")
            for res in (None, torch.bfloat16, torch.float32) for copy in (False, True)]


@pytest.mark.parametrize("k", [128, 768, 1280, 5120])
@pytest.mark.parametrize("m", [1, 31, 300, 8224, 25253])
def test_gemm_dgrad_matches_twin(dev, m, k):
    """The input gradient dY [m, n] . W [n, k] at contractions n in {32, 96,
    768, 3072} (a half-filled last stage at 32 and 96) and output widths k
    from one 128-column tile to 5120, ragged m: every epilogue (bf16 or fp32
    output, act' of quick-GELU or erf-GELU, a bf16 or fp32 residual, the
    bf16 copy) where the product is small, the chains' forms elsewhere;
    against its twin within 2 bf16 ulps of max|twin| (bf16) or 1e-5 of the
    largest magnitude (fp32: sums in another order), the same bits on a
    second call."""
    from nans_clip_tpu_torch.ops.gemm import linear_dgrad, linear_dgrad_plain
    r = _rnd(dev, m * 7 + k)
    for n in (32, 96, 768, 3072):
        dy, w = r(m, n), r(n, k, std=n ** -0.5)
        aux = torch.randn(m, k, device=dev) * 2
        res = {torch.bfloat16: r(m, k), torch.float32: torch.randn(m, k, device=dev)}
        for out, act, rdt, copy in _dgrad_forms(m * n * k <= 2 ** 27):
            kw = dict(act=act, aux=aux if act else None, residual=res.get(rdt),
                      out_dtype=out, copy=copy)
            got, want = linear_dgrad(dy, w, **kw), linear_dgrad_plain(dy, w, **kw)
            again = linear_dgrad(dy, w, **kw)
            if not copy:
                got, want, again = (got, None), (want, None), (again, None)
            if out == torch.float32:
                assert _rel_err(got[0], want[0]) <= 1e-5, (n, out, act, rdt, copy)
            else:
                _close(got[0], want[0], 2)
            if copy:
                assert got[1].dtype == torch.bfloat16
                _close(got[1], want[1], 2)
            assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.parametrize("n,k", [(128, 128), (768, 768), (2304, 768), (768, 3072),
                                 (1280, 5120), (384, 640)])
@pytest.mark.parametrize("m", [1, 33, 1000, 6656, 25216])
def test_gemm_wgrad_matches_twin(dev, m, n, k):
    """The weight gradient dY^T . X with its K-split sum at ragged M (1 to
    25,216 rows), N and K from one 128 x 128 output tile to 1280 x 5120 (384
    x 640: an odd count of 128-row tiles, a half 256-column tile), against
    its twin within 1e-5 of the largest magnitude; the same bits on a second
    call (the slices are a function of the shape, summed in order)."""
    from nans_clip_tpu_torch.ops.gemm import linear_wgrad, linear_wgrad_plain
    r = _rnd(dev, m + n + k)
    dy, x = r(m, n), r(m, k)
    got = linear_wgrad(dy, x)
    assert got.shape == (n, k) and got.dtype == torch.float32
    assert _rel_err(got, linear_wgrad_plain(dy, x)) <= 1e-5
    assert torch.equal(got, linear_wgrad(dy, x))


@pytest.mark.parametrize("m,per", [(1000, 3), (4000, 5), (777, 1), (64, 1), (6656, 7)])
def test_gemm_wgrad_slices_end_on_odd_ktiles(dev, m, per):
    """The kernel's partials with slices of an odd count of 32-row k-tiles,
    so that each slice ends (and the next begins) halfway through a 64-row
    stage: each partial against the twin over its own rows, 1e-5 of its
    largest magnitude."""
    from nans_clip_tpu_torch.ops import _build
    n, k = 256, 384
    r = _rnd(dev, m + per)
    dy, x = r(m, n), r(m, k)
    splits = -(-(-(-m // 32)) // per)
    part = torch.empty((splits, n, k), dtype=torch.float32, device=dev)
    err = _build.library().nans_gemm_wgrad(dy.data_ptr(), x.data_ptr(), part.data_ptr(), m, n, k,
                                           splits, per, _build.stream_ptr(dev))
    _build.check(err, "nans_gemm_wgrad")
    for z in range(splits):
        lo, hi = z * per * 32, min(m, (z + 1) * per * 32)
        assert _rel_err(part[z], dy[lo:hi].float().T @ x[lo:hi].float()) <= 1e-5, z


def test_gemm_bwd_plans_match_the_kernel(dev):
    """ops/gemm.py::dgrad_plan and ::wgrad_plan compute the launches
    nans_gemm_dgrad_plan and nans_gemm_wgrad_plan report."""
    import ctypes
    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.ops.gemm import dgrad_plan, wgrad_plan
    out = (ctypes.c_int * 10)()
    lib = _build.library()
    for m, n, k in ((25216, 768, 3072), (1, 128, 128), (8224, 5120, 1280), (6656, 2304, 768),
                    (300, 384, 640)):
        assert lib.nans_gemm_dgrad_plan(m, k, n, out) == 0   # dA [m, k] = dY [m, n] . W
        p = dgrad_plan(m, n, k, out[7])
        assert list(out) == [*p["tile"], p["stages"], p["threads"], p["smem"], p["cluster"],
                             out[7], p["units"], p["grid"]]
        p = wgrad_plan(m, n, k)
        assert lib.nans_gemm_wgrad_plan(m, n, k, p["splits"], p["per"], out) == 0
        p = wgrad_plan(m, n, k, out[7])
        assert list(out) == [*p["tile"], p["stages"], p["threads"], p["smem"], p["cluster"],
                             out[7], p["units"], p["grid"]]


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("s", [1, 15, 16, 52, 197, 257, 577, 640])
def test_attention_forward_matches_twin(dev, s, dh):
    """The forward attention at every S the one-pass and two-pass forms
    take, heads of 64 and 80, against its twin within 1 bf16 ulp of
    max|twin|: without a key bias, with padding masked (one sample's keys
    all masked), and with probability dropout 0.1 and the mask; the same
    bits on a second call; and the launch plan as nans_attention_plan
    reports it, every field, at these units and at ViT-B-16's batch 256."""
    import ctypes
    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.attention import attention_plain, attention_plan
    r = _rnd(dev, s * dh)
    b, heads = 3, 4
    qkv = r(b * s, 3 * heads * dh)
    lengths = torch.tensor([s, max(1, s // 3), 0], device=dev)   # sample 2: all masked
    kb = ((1.0 - (torch.arange(s, device=dev)[None] < lengths[:, None]).float())
          * -10000.0).contiguous()
    spec = drop.Dropout(8, 0.1, drop.STREAM_ATTN, s)
    for key_bias, dp in ((None, None), (kb, None), (kb, spec)):
        got = attention(qkv, key_bias, b, heads, dp)
        _close(got, attention_plain(qkv, key_bias, b, heads, dp), 1)
        assert torch.equal(got, attention(qkv, key_bias, b, heads, dp))
    out = (ctypes.c_int * 7)()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for batch, h in ((b, heads), (256, 12)):
        assert _build.library().nans_attention_plan(batch, h, s, dh, sms, out) == 0
        p = attention_plan(batch, s, h, dh, sms)
        assert list(out) == [p["key_tiles"], p["warps"], p["smem"], p["strips"], p["blocks"],
                             p["stages"], p["blocks_per_sm"]]


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("s", [100, 197, 256])
def test_attention_walk_over_many_units_matches_twin(dev, s, dh):
    """The walk (8 to 16 key tiles) where each block takes many (head,
    sample) units through several stages, refilled as units finish (more
    units than the card has SMs, some blocks one unit more than others):
    ctx against its twin within 1 bf16 ulp of max|twin|, masked, with
    probability dropout 0.1 and the statistics; the same bits on a second
    call and with a stream of other work before it."""
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.attention import attention_plain, attention_plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, heads = 2 * sms // 3 + 1, 6
    p = attention_plan(b, s, heads, dh, sms)
    assert p["key_tiles"] > 4 and p["units_per_block"] >= 4 and p["stages"] >= 2
    r = _rnd(dev, 7 * s + dh)
    qkv = r(b * s, 3 * heads * dh)
    lengths = torch.randint(1, s + 1, (b,), device=dev, generator=torch.Generator(
        device=dev).manual_seed(s))
    kb = ((1.0 - (torch.arange(s, device=dev)[None] < lengths[:, None]).float())
          * -10000.0).contiguous()
    spec = drop.Dropout(11, 0.1, drop.STREAM_ATTN, s)
    ctx, st = attention(qkv, kb, b, heads, spec, stats=True)
    _close(ctx, attention_plain(qkv, kb, b, heads, spec), 1)
    _, want_st = attention_plain(qkv, kb, b, heads, spec, stats=True)
    for i in (0, 1):
        assert _rel_err(st[i], want_st[i]) <= 1e-6
    r(4096, 4096).float().sum()   # other work ahead on the stream
    again, st2 = attention(qkv, kb, b, heads, spec, stats=True)
    assert torch.equal(again, ctx) and torch.equal(st2, st)
    assert torch.equal(attention(qkv, kb, b, heads, spec), ctx)


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("s", [7, 52, 197, 257, 320])
def test_attention_stats_and_one_shot_bwd_match_twins(dev, s, dh):
    """The forward's row statistics (``stats=True``) against the twin's: m
    and l within 1e-6 of their magnitude (the scores' fp32 sums run in
    another order than torch's, so m, a selected score, may move by an ulp);
    ctx the same bits as without them. The one-shot backward from those
    statistics against its twin, without a key bias, masked, and masked
    with probability dropout 0.1: dqkv within 1e-2 of its largest
    magnitude, the bf16 form the fp32 form rounded, the same bits on a
    second call and without the statistics given (one forward forms
    them)."""
    from nans_clip_tpu_torch.ops import dropout as drop
    from nans_clip_tpu_torch.ops.attention import attention_bwd, attention_bwd_plain, \
        attention_plain
    r = _rnd(dev, 100 + s * dh)
    b, heads = 3, 4
    qkv, dctx = r(b * s, 3 * heads * dh), r(b * s, heads * dh)
    lengths = torch.tensor([s, max(1, s // 3), max(1, s - 2)], device=dev)
    kb = ((1.0 - (torch.arange(s, device=dev)[None] < lengths[:, None]).float())
          * -10000.0).contiguous()
    spec = drop.Dropout(8, 0.1, drop.STREAM_ATTN, s)
    for key_bias, dp in ((None, None), (kb, None), (kb, spec)):
        ctx, st = attention(qkv, key_bias, b, heads, dp, stats=True)
        assert st.shape == (2, b, heads, s) and st.dtype == torch.float32
        assert torch.equal(ctx, attention(qkv, key_bias, b, heads, dp))
        _, want_st = attention_plain(qkv, key_bias, b, heads, dp, stats=True)
        for i in (0, 1):
            assert _rel_err(st[i], want_st[i]) <= 1e-6
        got, got16 = attention_bwd(qkv, dctx, key_bias, b, heads, dp, stats=st)
        want, _ = attention_bwd_plain(qkv, dctx, key_bias, b, heads, dp)
        assert _rel_err(got, want) <= 1e-2
        assert torch.equal(got16, got.to(torch.bfloat16))
        assert torch.equal(attention_bwd(qkv, dctx, key_bias, b, heads, dp, stats=st)[0], got)
        assert torch.equal(attention_bwd(qkv, dctx, key_bias, b, heads, dp)[0], got)


def test_attention_bwd_plan_matches_the_kernel(dev):
    """ops/attention.py::attention_bwd_plan computes the launch
    nans_attention_bwd_plan reports."""
    import ctypes
    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.ops.attention import attention_bwd_plan
    out = (ctypes.c_int * 4)()
    for s in (1, 7, 16, 17, 52, 77, 128, 197, 257, 320):
        for dh in (64, 80):
            for dp in (False, True):
                assert _build.library().nans_attention_bwd_plan(s, dh, int(dp), out) == 0
                p = attention_bwd_plan(2, s, 12, dh, dp)
                assert list(out) == [p["warps"], p["smem"], p["strips"], p["rounds"]]


def test_attention_bwd_long_plan_matches_the_kernel(dev):
    """ops/attention.py::attention_bwd_long_plan computes the launch
    nans_attention_bwd_long_plan reports."""
    import ctypes
    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.ops.attention import attention_bwd_long_plan
    out = (ctypes.c_int * 5)()
    for s in (321, 330, 400, 513, 577, 592, 625, 640):
        for dh in (64, 80):
            assert _build.library().nans_attention_bwd_long_plan(s, dh, out) == 0
            p = attention_bwd_long_plan(2, s, 16, dh)
            assert list(out) == [p["warps"], p["rounds"], p["strips"], p["smem_dq"],
                                 p["smem_dkv"]]


def test_flash_fwd_plan_matches_the_kernel(dev):
    """ops/attention.py::flash_fwd_plan computes the launch
    nans_flash_fwd_plan reports."""
    import ctypes
    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.ops.attention import flash_fwd_plan
    out = (ctypes.c_int * 4)()
    for s in (1, 15, 16, 17, 52, 128, 129, 197, 257, 577, 1024, 1025, 4096):
        for dh in (64, 80):
            assert _build.library().nans_flash_fwd_plan(s, dh, out) == 0
            p = flash_fwd_plan(2, 12, s, dh)
            assert list(out) == [p["warps"], p["blocks"], p["strips"], p["smem"]]


def test_flash_bwd_plan_matches_the_kernel(dev):
    """ops/attention.py::flash_bwd_plan computes the launch
    nans_flash_bwd_plan reports."""
    import ctypes
    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.ops.attention import flash_bwd_plan
    out = (ctypes.c_int * 6)()
    for s in (1, 16, 17, 52, 64, 65, 197, 257, 449, 577, 1024, 1100):
        for dh in (64, 80):
            assert _build.library().nans_flash_bwd_plan(s, dh, out) == 0
            p = flash_bwd_plan(2, 12, s, dh)
            assert list(out) == [p["warps"], p["blocks"], p["strips"], p["smem_dq"],
                                 p["smem_dkv"], p["dkv_blocks"]]


def test_tower_plan_matches_the_kernel(dev):
    """ops/tower_kernel.py::tower_plan computes the plan nans_tower_plan
    reports, at the published towers' shapes, batch 1, 8 and 32, on the
    card's co-resident grid and on 132 blocks."""
    import ctypes
    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.ops import tower_kernel as tk
    out = (ctypes.c_int * 10)()
    idx = torch.cuda.current_device()
    for s, w, dh in ((197, 768, 64), (52, 768, 64), (257, 1024, 64), (52, 1024, 64),
                     (257, 1280, 80), (50, 768, 64)):
        for mode in (tk.MODE_BF16, tk.MODE_INT8):
            for grid in (tk.max_grid(idx, mode, s, dh), 132):
                for b in (1, 8, 32):
                    assert _build.library().nans_tower_plan(mode, b, s, w, 4 * w, dh, grid,
                                                            out) == 0
                    p = tk.tower_plan(mode, b, s, w, 4 * w, dh, grid)
                    assert list(out) == [p["ranges"], p["chunks"], p["stages"], *p["ks"],
                                         p["part"], p["sem"], p["smem"]]


def _ln_bwd_cases(dev, rows, w, seed):
    """The forms the chains call, as layer_norm_bwd keyword sets: (gin, x,
    keyword arguments, fp32 output) for pre-LN with sums, emitting x-hat,
    and neither; post-LN with dropout 0.1, with sums and emitting x-hat."""
    from nans_clip_tpu_torch.ops import dropout as drop
    r = _rnd(dev, seed)
    dxn, x, g = torch.randn(rows, w, device=dev), r(rows, w), r(rows, w)
    u = torch.randn(rows, w, device=dev) * 3 + 1
    spec = drop.Dropout(3, 0.1, drop.STREAM_HIDDEN, rows // 2)
    pre = dict(residual=g, out_dtype=torch.bfloat16)
    post = dict(out_dtype=torch.float32, emit_dproj=True, dropout=spec)
    return [(dxn, x, 1e-5, dict(pre)), (dxn, x, 1e-5, dict(pre, emit_xhat=True, sums=False)),
            (dxn, x, 1e-5, dict(pre, sums=False)), (g, u, 1e-12, dict(post)),
            (g, u, 1e-12, dict(post, emit_xhat=True, sums=False))]


@pytest.mark.parametrize("rows,w", [(2 * 197, 768), (2 * 52, 1024), (2 * 257, 1280),
                                    (2 * 37, 2048), (2 * 19, 128)])
def test_layernorm_bwd_every_form_matches_twin(dev, rows, w):
    """The LayerNorm backward in every form the chains call, at one warp a
    row (W <= 1024) and a pair of warps (1280, 2048), against the twin: a
    bf16 dx within 2 bf16 ulps, fp32 outputs (dx, the sums) within 1e-5 of
    their largest magnitude, dproj and x-hat within 2 ulps; dx and dproj of
    the emitting and the summing instances equal bit for bit; two calls
    equal; and the launch plan as nans_layernorm_bwd_plan reports it."""
    import ctypes
    from nans_clip_tpu_torch.ops import _build
    from nans_clip_tpu_torch.ops.layernorm import (_sms, layer_norm_bwd, layer_norm_bwd_plain,
                                                   layernorm_bwd_plan)
    gamma = _rnd(dev, 5)(w, std=0.1) + 1
    outs = []
    for gin, x, eps, kw in _ln_bwd_cases(dev, rows, w, w + rows):
        got = layer_norm_bwd(gin, x, gamma, eps, **kw)
        want = layer_norm_bwd_plain(gin, x, gamma, eps, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is None:
                continue
            if a.dtype == torch.float32:
                assert _rel_err(a, b) <= 1e-5
            else:
                _close(a, b, 2)
        again = layer_norm_bwd(gin, x, gamma, eps, **kw)
        assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
        outs.append(got)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][0], outs[2][0])
    assert torch.equal(outs[3][0], outs[4][0]) and torch.equal(outs[3][3], outs[4][3])
    out = (ctypes.c_int * 4)()
    for n in (1, 7, rows, 6656, 25216):
        assert _build.library().nans_layernorm_bwd_plan(n, w, _sms(0), out) == 0
        p = layernorm_bwd_plan(n, w, _sms(0))
        assert list(out) == [p["grid"], p["rows_per_block"], p["warps_per_row"],
                             p["chunks_per_lane"]]


def test_column_sum_forms_match_twin(dev):
    """column_sum's three launches (a thread a column up to 64 rows; the
    warps over every 8th row of fp32 up to 512; a first pass over chunks
    above) against the twin within 1e-5 of the largest magnitude, the same
    bits on a second call."""
    from nans_clip_tpu_torch.ops.reduce import column_sum, column_sum_plain
    for rows, cols, dt in ((5, 768, torch.bfloat16), (64, 2304, torch.float32),
                           (263, 2304, torch.float32), (300, 768, torch.bfloat16),
                           (512, 100, torch.float32), (6656, 768, torch.bfloat16)):
        x = torch.randn(rows, cols, device=dev).to(dt)
        got = column_sum(x)
        assert got.shape == (cols,) and _rel_err(got, column_sum_plain(x)) <= 1e-5
        assert torch.equal(got, column_sum(x))


# -- serving backends: CUDA graphs and engines ---------------------------------


def _serving_model(dev, cfg):
    from nans_clip_tpu_torch.api import model_from_config
    from nans_clip_tpu_torch.models.common import ModelOptions

    return model_from_config(cfg, seed=0, device=dev, options=ModelOptions(
        compute_dtype="bfloat16"))


def _serving_cfgs():
    import dataclasses

    from nans_clip_tpu_torch import configs

    base = configs.load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese")
    base2 = dataclasses.replace(base, vision=dataclasses.replace(base.vision, layers=2),
                                text=dataclasses.replace(base.text, num_hidden_layers=2))
    # tiny_config at the kernels' head width (64), as the tests above take it
    tiny = configs.tiny_config()
    tiny = dataclasses.replace(
        tiny, vision=dataclasses.replace(tiny.vision, width=128, head_width=64),
        text=dataclasses.replace(tiny.text, hidden_size=128, num_attention_heads=2,
                                 intermediate_size=512))
    return {"tiny": tiny, "base2": base2}


def _serving_input(cfg, tower, batch, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    if tower == "image":
        r = cfg.vision.image_resolution
        return torch.randn(batch, r, r, 3, generator=g).to(dev)
    ids = torch.randint(103, 20000, (batch, 52), generator=g)
    ids[:, 0], ids[:, 20:] = 101, 0
    ids[:, 19] = 102
    return ids.to(dev)


@pytest.mark.parametrize("name", ["tiny", "base2"])
@pytest.mark.parametrize("tower", ["image", "text"])
@pytest.mark.parametrize("batch", [1, 64])
def test_graph_replay_equals_eager(dev, name, tower, batch):
    """``compile_tower``'s CUDA graph gives the eager tower's bits."""
    from nans_clip_tpu_torch.deploy import aot

    cfg = _serving_cfgs()[name]
    model = _serving_model(dev, cfg)
    x = _serving_input(cfg, tower, batch, dev)
    run = aot.compile_tower(model, tower, batch)
    assert run.graph is not None and run.batch_size == batch
    eager = aot.normalized((model.encode_image if tower == "image" else model.encode_text)(x))
    assert torch.equal(run(x), eager)
    assert torch.equal(run(x.cpu()), eager)   # a host input is copied in


def test_engine_roundtrip_on_the_card(dev, tmp_path):
    from nans_clip_tpu_torch.deploy import aot, engine

    cfg = _serving_cfgs()["base2"]
    model = _serving_model(dev, cfg)
    for tower in ("image", "text"):
        for batch in (1, 64):
            program = aot.export_tower(cfg, model.options, tower, aot.tower_params(model, tower),
                                       aot.example_input(cfg, tower, batch, device=dev))
            ops = {str(n.target) for n in program.graph.nodes if "nans_clip" in str(n.target)}
            assert ops == ({"nans_clip.tower.default"} if batch == 1 else
                           {"nans_clip.linear.default", "nans_clip.attention.default",
                            "nans_clip.layer_norm.default"})
            path = engine.save_engine(str(tmp_path / f"{tower}{batch}.engine"), program, batch)
            header = engine.read_header(path)
            assert header["device_type"] == "cuda" and header["capability"] == "9.0"
            eng = engine.load_engine(path, aot.tower_params(model, tower))
            assert eng.graph is not None
            x = _serving_input(cfg, tower, batch, dev, seed=1)
            assert torch.equal(eng(x), aot.compile_tower(model, tower, batch)(x))


def test_engine_keeps_its_pointer_table_among_other_engines(dev, tmp_path):
    """Nine text engines at batch 1 (the tower op), each bound to its own
    ``tower_params`` (freshly packed q|k|v: new addresses, a new pointer
    table): the first one's graph still replays the eager bits after the
    others are loaded and the freed memory is written over."""
    from nans_clip_tpu_torch.deploy import aot, engine

    cfg = _serving_cfgs()["base2"]
    model = _serving_model(dev, cfg)
    program = aot.export_tower(cfg, model.options, "text", aot.tower_params(model, "text"),
                               aot.example_input(cfg, "text", 1, device=dev))
    path = engine.save_engine(str(tmp_path / "text_bs1.engine"), program, 1)
    x = _serving_input(cfg, "text", 1, dev, seed=3)
    want = aot.compile_tower(model, "text", 1)(x)
    engines = [engine.load_engine(path, aot.tower_params(model, "text")) for _ in range(9)]
    assert all(len(e.tables) == 1 for e in engines)
    junk = [torch.full((1 << 16,), -1, dtype=torch.int64, device=dev) for _ in range(64)]
    torch.cuda.synchronize()
    assert torch.equal(engines[0](x), want) and torch.equal(engines[-1](x), want)
    del junk


def test_failed_capture_raises(dev):
    """A capture that fails raises: nothing falls back to an eager run."""
    from nans_clip_tpu_torch.deploy import aot

    def syncs(x):
        y = x * 2
        y.sum().item()   # a host sync: illegal while a stream is capturing
        return y

    with pytest.raises(RuntimeError, match="capture .* failed"):
        aot.graphed(syncs, torch.ones(4, device=dev))


def test_graph_pool_is_renewed_after_its_graphs_are_gone(dev):
    """A model's graphs share one memory pool; once they are all freed the
    allocator releases it, and the next capture takes a new one."""
    import gc

    from nans_clip_tpu_torch.deploy import aot

    cfg = _serving_cfgs()["tiny"]
    model = _serving_model(dev, cfg)
    x = _serving_input(cfg, "text", 2, dev)
    first = aot.compile_tower(model, "text", 2)
    want = first(x)
    del first
    gc.collect()
    again = aot.compile_tower(model, "text", 2)       # the pool of `first` is released
    both = aot.compile_tower(model, "text", 4)        # shares `again`'s pool
    assert torch.equal(again(x), want)
    assert both(torch.cat([x, x])).shape == (4, cfg.embed_dim)


@pytest.mark.parametrize("host_ops", [False, True])
def test_span_holds_its_kernel_on_the_profiler_clock(dev, host_ops):
    """A span around one product, synchronised inside it, holds the
    product's kernel as CUPTI stamps it: the span's host clock is the
    profiler's, for device events too. With the device activity alone (as
    the benchmark's train cell traces) the recorder still turns on, its
    pool, reserved before the session, makes no event inside it, the span's
    CUDA events read the kernel's time, and the kernel goes under the span
    whose runtime call launched it."""
    from torch.profiler import ProfilerActivity, profile

    from nans_clip_tpu_torch.profile_slice import device_ops, launch_starts, launched_by_span
    from nans_clip_tpu_torch.utils.profiling import SpanRecorder

    a = torch.randn(4096, 4096, device=dev)
    torch.mm(a, a)
    torch.cuda.synchronize()
    rec = SpanRecorder(pool_events=8)
    rec.reserve()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        for _ in range(3):
            with rec.span("card.mm"):
                torch.mm(a, a)
                torch.cuda.synchronize()
    assert rec._made == 8
    events = prof.profiler.kineto_results.events()
    kernels = device_ops(events)
    spans = rec.spans()
    assert len(kernels) == len(spans) == 3, (kernels, spans)
    for (name, start, end, _), s in zip(kernels, spans):
        inside_us = ((start - s.start_ns) * 1e-3, (s.end_ns - end) * 1e-3)
        assert min(inside_us) >= 0, (name, inside_us, s)
        # the end event is stamped by the device a few microseconds after its record call
        assert 0.5 * (end - start) * 1e-6 <= s.device_ms <= s.host_ms + 0.05, (name, start, end, s)
    launched = launched_by_span(kernels, launch_starts(events), spans)
    assert launched == {"card.mm": sum(end - start for _, start, end, _ in kernels)}
