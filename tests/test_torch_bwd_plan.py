"""The launch plans of the one-shot attention backward
(``ops/attention.py::attention_bwd_plan``), of the long-sequence pair
(``attention_bwd_long_plan``), of the flash forward #22 (``flash_fwd_plan``)
and backward #23 (``flash_bwd_plan``) and of the LayerNorm backward
(``ops/layernorm.py::layernorm_bwd_plan``),
the plain Python functions their wrappers call, at every shape of the
published towers (ViT-B-16, ViT-B-32, ViT-L-14, ViT-L-14-336 and ViT-H-14
images, RoBERTa-wwm-ext-base, -large and RBT3 texts at 52 tokens; batches 1
to 256) and at the edges of each kernel's range: each plan stays within the
232,448 bytes of shared memory a block may have and covers its strips or
rows exactly once, in order. Then the row statistics that the attention
backward takes from the forward: the twin's backward from given statistics
equals its own recomputation bit for bit (S 37, and S 577 for the long
pair), and the chains that hand them over still match the JAX Pallas
backward kernels in interpret mode, at tests/test_torch_fused_bwd.py's
bounds. Runs on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu.ops import fused_block_bwd as jbwd
from nans_clip_tpu_torch.configs import load_config
from nans_clip_tpu_torch.ops import dropout as drop
from nans_clip_tpu_torch.ops import fused_block_bwd as tbwd
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops.attention import (ATTN_BWD_LONG_MAX_WARPS, ATTN_BWD_MAX_WARPS,
                                               attention_bwd_long_plan, attention_bwd_plain,
                                               attention_bwd_plan, attention_plain,
                                               flash_bwd_plan, flash_fwd_plan)
from nans_clip_tpu_torch.ops.layernorm import layer_norm_bwd_plain, layernorm_bwd_plan

torch.set_num_threads(2)

TEXT_SEQ = 52
BATCHES = (1, 8, 32, 128, 256)
VISION = ("ViT-B-16", "ViT-B-32", "ViT-L-14", "ViT-L-14-336", "ViT-H-14")
TEXT = ("RoBERTa-wwm-ext-base-chinese", "RoBERTa-wwm-ext-large-chinese", "RBT3-chinese")


def _tower(name):
    """(seq, width, heads) of a published tower."""
    if name in VISION:
        v = load_config(f"{name}@RBT3-chinese").vision
        return v.seq_len, v.width, v.heads
    t = load_config(f"ViT-B-16@{name}").text
    return TEXT_SEQ, t.hidden_size, t.num_attention_heads


def _owned_once(strips, warps, rounds):
    """Warp i takes strips i, i + warps, ...: every strip has exactly one
    (warp, round), and no warp takes more than ``rounds``."""
    owner = {}
    for w in range(warps):
        taken = list(range(w, strips, warps))
        assert len(taken) <= rounds
        for t in taken:
            assert t not in owner
            owner[t] = w
    return sorted(owner) == list(range(strips))


def _attn_shapes():
    shapes = {(s, w // h) for s, w, h in map(_tower, VISION + TEXT)
              if s <= gates.ATTN_BWD_MAX_SEQ}
    return sorted(shapes | {(gates.ATTN_BWD_MAX_SEQ, 64), (gates.ATTN_BWD_MAX_SEQ, 80)})


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("s,dh", _attn_shapes())
def test_attention_bwd_plan_fits_and_owns_each_strip_once(s, dh, dropout):
    p = attention_bwd_plan(128, s, 12, dh, dropout)
    assert p["strips"] * 16 >= s > (p["strips"] - 1) * 16
    assert p["smem"] <= gates.SMEM_PER_BLOCK
    assert 1 <= p["warps"] <= ATTN_BWD_MAX_WARPS[dh] and p["threads"] == 32 * p["warps"]
    # the fewest rounds the most warps allow, and no warp fewer than needed
    assert p["rounds"] == -(-p["strips"] // ATTN_BWD_MAX_WARPS[dh])
    assert p["warps"] * p["rounds"] >= p["strips"] > (p["warps"] - 1) * p["rounds"]
    assert _owned_once(p["strips"], p["warps"], p["rounds"])   # query strips, then key strips
    assert p["blocks_per_sm"] >= 1 and p["grid"] == (12, 128)


def test_attention_bwd_plan_two_blocks_an_sm_at_vit_b():
    """ViT-B-16's image attention (S 197, heads of 64): 13 strips, 7 warps
    in 2 rounds, and two blocks share an SM."""
    p = attention_bwd_plan(128, 197, 12, 64)
    assert (p["strips"], p["warps"], p["rounds"]) == (13, 7, 2)
    assert p["blocks_per_sm"] >= 2 and 2 * (p["smem"] + 1024) <= gates.SMEM_PER_SM


def test_attention_bwd_plan_heads_of_80_at_vit_h():
    """ViT-H-14's image attention (S 257, heads of 80): one block an SM at
    178 KB, its 17 strips on 9 warps in 2 rounds."""
    p = attention_bwd_plan(32, 257, 16, 80)
    assert (p["strips"], p["warps"], p["rounds"], p["blocks_per_sm"]) == (17, 9, 2, 1)


def _long_shapes():
    """S above the one-shot backward's reach: the published towers' (ViT-L-14-336's
    577 at heads of 64) and the pair's range at heads of 64 and 80."""
    shapes = {(s, w // h) for s, w, h in map(_tower, VISION + TEXT)
              if s > gates.ATTN_BWD_MAX_SEQ}
    edges = (gates.ATTN_BWD_MAX_SEQ + 1, 577, gates.ATTN_BWD_LONG_MAX_SEQ)
    return sorted(shapes | {(s, dh) for s in edges for dh in gates.HEAD_DIMS})


@pytest.mark.parametrize("s,dh", _long_shapes())
def test_attention_bwd_long_plan_fits_and_owns_each_strip_once(s, dh):
    p = attention_bwd_long_plan(32, s, 16, dh)
    assert p["strips"] * 16 >= s > (p["strips"] - 1) * 16
    assert max(p["smem_dq"], p["smem_dkv"]) <= gates.SMEM_PER_BLOCK
    most = ATTN_BWD_LONG_MAX_WARPS[dh]
    assert 1 <= p["warps"] <= most and p["threads"] == 32 * p["warps"]
    assert p["rounds"] == -(-p["strips"] // most)
    assert p["warps"] * p["rounds"] >= p["strips"] > (p["warps"] - 1) * p["rounds"]
    # query strips in the dQ kernel, key strips in the dK/dV kernel
    assert _owned_once(p["strips"], p["warps"], p["rounds"])
    assert p["grid"] == (16, 32)


def test_attention_bwd_long_plan_at_vit_l_336():
    """ViT-L-14-336's image attention (S 577, heads of 64): 37 strips on 13
    warps in 3 rounds, the head's K and V in 153,920 bytes; at heads of 80
    (#20 at ViT-H width) 10 warps in 4 rounds."""
    p = attention_bwd_long_plan(32, 577, 16, 64)
    assert (p["strips"], p["warps"], p["rounds"], p["smem_dq"]) == (37, 13, 3, 153920)
    p = attention_bwd_long_plan(16, 577, 16, 80)
    assert (p["strips"], p["warps"], p["rounds"]) == (37, 10, 4)


def _flash_shapes():
    seqs = {s for s, _, _ in map(_tower, VISION + TEXT)} | {1, 15, 16, 17, 1024, 1025, 4096}
    return sorted((s, dh) for s in seqs for dh in gates.HEAD_DIMS)


@pytest.mark.parametrize("s,dh", _flash_shapes())
def test_flash_fwd_plan_covers_each_strip_once(s, dh):
    """#22: warp i of block x takes strip x * warps + i; every strip has
    exactly one (block, warp), every block at least one strip, on the fewest
    blocks; two blocks fit an SM's shared memory."""
    p = flash_fwd_plan(4, 12, s, dh)
    assert p["strips"] * 16 >= s > (p["strips"] - 1) * 16
    assert 1 <= p["warps"] <= gates.FLASH_MAX_WARPS and p["threads"] == 32 * p["warps"]
    assert p["blocks"] == -(-p["strips"] // gates.FLASH_MAX_WARPS)
    taken = [x * p["warps"] + i for x in range(p["blocks"]) for i in range(p["warps"])]
    assert [t for t in taken if t < p["strips"]] == list(range(p["strips"]))
    assert (p["blocks"] - 1) * p["warps"] < p["strips"]
    assert 2 * (p["smem"] + 1024) <= gates.SMEM_PER_SM
    assert p["grid"] == (p["blocks"], 12, 4)


# chip_smoke.py phase 10's sequences (FLASH_SHAPES) and the edges of a tile
FLASH_BWD_SEQS = (52, 197, 257, 577, 1024, 1, 16, 17, 64, 65, 1100)


@pytest.mark.parametrize("dh", gates.HEAD_DIMS)
@pytest.mark.parametrize("s", FLASH_BWD_SEQS)
def test_flash_bwd_plan_covers_each_strip_once(s, dh):
    """#23: in both kernels warp i of block x owns strip x * warps + i (of
    the queries in the dQ kernel, of the keys in the dK/dV kernel): every
    16-row strip has exactly one (block, warp), on the fewest blocks of at
    most FLASH_MAX_WARPS warps; each kernel's shared memory (its own rows,
    the ring of streamed tiles) fits a block, whatever S is."""
    p = flash_bwd_plan(4, 12, s, dh)
    assert p["strips"] * 16 >= s > (p["strips"] - 1) * 16
    assert 1 <= p["warps"] <= gates.FLASH_MAX_WARPS and p["threads"] == 32 * p["warps"]
    assert p["blocks"] == -(-p["strips"] // gates.FLASH_MAX_WARPS)
    owner = {}
    for x in range(p["blocks"]):
        for i in range(p["warps"]):
            strip = x * p["warps"] + i
            if strip < p["strips"]:
                assert strip not in owner
                owner[strip] = (x, i)
    assert sorted(owner) == list(range(p["strips"]))
    assert (p["blocks"] - 1) * p["warps"] < p["strips"]   # no block without a strip
    stages = min(gates.FLASH_STAGES, -(-s // gates.FLASH_BLOCK_K))
    own = 2 * p["warps"] * 16 * dh * 2   # Q and dO rows (dQ), K and V rows (dK/dV)
    ring = stages * 2 * gates.FLASH_BLOCK_K * dh * 2
    assert p["smem_dq"] == own + ring + stages * gates.FLASH_BLOCK_K * 4
    assert p["smem_dkv"] == own + ring + stages * 2 * gates.FLASH_BLOCK_K * 4
    assert max(p["smem_dq"], p["smem_dkv"]) <= gates.SMEM_PER_BLOCK
    assert p["dkv_blocks"] == (2 if dh == 64 and -(-s // gates.FLASH_BLOCK_K)
                               < gates.FLASH_DKV_ONE_BLOCK_TILES else 1)
    assert 2 * (p["smem_dkv"] + 1024) <= gates.SMEM_PER_SM or p["dkv_blocks"] == 1
    assert p["grid"] == (p["blocks"], 12, 4)


def _ln_shapes():
    return sorted({(b * s, w) for s, w, _ in map(_tower, VISION + TEXT) for b in BATCHES})


def _rows_of(p, rows):
    """The rows each block's slots take, in the order the kernel takes them."""
    out = []
    for blk in range(p["grid"]):
        r0 = blk * p["rows_per_block"]
        out.extend(range(r0, min(rows, r0 + p["rows_per_block"])))
    return out


@pytest.mark.parametrize("planes", [2, 3])
@pytest.mark.parametrize("rows,w", _ln_shapes())
def test_layernorm_bwd_plan_covers_each_row_once(rows, w, planes):
    p = layernorm_bwd_plan(rows, w, gates.H100_SMS, planes)
    assert p["grid"] <= 2 * gates.H100_SMS and p["threads"] == 256
    assert _rows_of(p, rows) == list(range(rows))
    # the last block is not empty: every block writes its partials
    assert (p["grid"] - 1) * p["rows_per_block"] < rows
    assert p["partials"] == (p["grid"], planes, w)
    assert p["warps_per_row"] == (1 if w <= 1024 else 2)
    assert p["chunks_per_lane"] * 32 * 8 * p["warps_per_row"] >= w
    assert p["chunks_per_lane"] <= 4


@pytest.mark.parametrize("rows,w,sms", [(394, 768, 132), (1000, 1280, 7), (77, 128, 132)])
def test_layernorm_bwd_partials_sum_as_the_twin(rows, w, sms):
    """The plan's per-block column partials, summed in block order as the
    wrapper sums them (one column sum over [grid, planes * W]), give the
    twin's dgamma, dbeta and dproj sums within 1e-5."""
    rs = np.random.RandomState(rows)
    gin = torch.from_numpy(rs.randn(rows, w).astype(np.float32)).bfloat16()
    x = torch.from_numpy(rs.randn(rows, w).astype(np.float32))
    gamma = torch.from_numpy(1 + 0.1 * rs.randn(w).astype(np.float32)).bfloat16()
    seq = rows // 2 if rows % 2 == 0 else rows
    spec = drop.Dropout(3, 0.1, drop.STREAM_HIDDEN, seq)
    dx, dgm, dbt, dproj, dps = layer_norm_bwd_plain(gin, x, gamma, 1e-12,
                                                    out_dtype=torch.float32, emit_dproj=True,
                                                    dropout=spec)
    p = layernorm_bwd_plan(rows, w, sms, 3)
    xf = x.float()
    xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        (xf - xf.mean(-1, keepdim=True)).square().mean(-1, keepdim=True) + 1e-12)
    g = gin.float()
    dm = dx * drop.hidden_multiplier(spec, rows, w, dx.device)     # dproj before its rounding
    terms = torch.stack([g * xhat, g, dm], dim=1)                  # [rows, 3, W]
    part = torch.zeros(p["partials"])
    for blk in range(p["grid"]):
        r0 = blk * p["rows_per_block"]
        part[blk] = terms[r0:r0 + p["rows_per_block"]].sum(0)
    total = part.view(p["grid"], -1).sum(0).view(-1, w)
    for got, want in zip(total, (dgm, dbt, dps)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("masked,rate", [(False, 0.0), (True, 0.0), (True, 0.1)])
def test_attention_bwd_twin_from_stats_equals_recomputation(masked, rate):
    """The twin's backward from the forward twin's row statistics equals the
    same backward with P recomputed, bit for bit; the forward's ctx is the
    same with and without the statistics."""
    rs = np.random.RandomState(7)
    b, s, heads, dh = 3, 37, 2, 64
    qkv = torch.from_numpy(rs.randn(b * s, 3 * heads * dh).astype(np.float32))
    dctx = torch.from_numpy(rs.randn(b * s, heads * dh).astype(np.float32))
    kb = None
    if masked:
        kb = torch.zeros(b, s)
        kb[0, s // 3:] = -10000.0
    dp = drop.Dropout(5, rate, drop.STREAM_ATTN, s) if rate else None
    ctx, st = attention_plain(qkv, kb, b, heads, dp, stats=True)
    assert st.shape == (2, b, heads, s) and st.dtype == torch.float32
    assert torch.equal(ctx, attention_plain(qkv, kb, b, heads, dp))
    for got, want in zip(attention_bwd_plain(qkv, dctx, kb, b, heads, dp, stats=st),
                         attention_bwd_plain(qkv, dctx, kb, b, heads, dp)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dh", [64, 80])
def test_attention_bwd_twin_from_stats_equals_recomputation_long(dh):
    """The same at S 577, the long pair's sequence (ViT-L-14-336): the twin
    that the pair is held against gives the same bits from the forward's
    statistics as from its own."""
    rs = np.random.RandomState(dh)
    b, s, heads = 1, 577, 2
    qkv = torch.from_numpy(rs.randn(b * s, 3 * heads * dh).astype(np.float32))
    dctx = torch.from_numpy(rs.randn(b * s, heads * dh).astype(np.float32))
    _, st = attention_plain(qkv, None, b, heads, stats=True)
    for got, want in zip(attention_bwd_plain(qkv, dctx, None, b, heads, stats=st),
                         attention_bwd_plain(qkv, dctx, None, b, heads)):
        assert torch.equal(got, want)


def _args(seed, b, s, w):
    rs = np.random.RandomState(seed)
    r = lambda *sh: (0.1 * rs.randn(*sh)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[0, s // 3:] = 0.0
    return dict(x=rs.randn(b, s, w).astype(np.float32), ln_s=1.0 + r(w), ln_b=r(w),
                wqkv=r(w, 3 * w), bqkv=r(3 * w), wo=r(w, w), bo=r(w),
                kb=(1.0 - mask) * -10000.0, g=rs.randn(b, s, w).astype(np.float32))


def _t(a, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


@pytest.mark.parametrize("post_ln", [False, True])
def test_chains_with_forward_stats_match_pallas(post_ln):
    """#14 and #16's twins, which hand the forward recompute's row
    statistics to the attention backward, against the JAX kernels in
    interpret mode at S 37 (a ragged last strip), heads of 64: every output
    within 1e-3 * max(|ref|, 1)."""
    a = _args(3, 2, 37, 128)
    if post_ln:
        ref = jbwd.fused_bert_attention_block_bwd_fullgrad(
            jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wo"], a["bo"],
            jnp.asarray(a["kb"]), None, jnp.asarray(a["g"]), 2, 1e-12, 0.0, 0.0, True)
        ours = tbwd.fused_bert_attention_block_bwd_fullgrad(
            _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]),
            _t(a["wo"], True), _t(a["bo"]), _t(a["kb"]), None, _t(a["g"]), 2, 1e-12)
    else:
        ref = jbwd.fused_attention_block_bwd_fullgrad(
            jnp.asarray(a["x"]), a["ln_s"], a["ln_b"], a["wqkv"], a["bqkv"], a["wo"],
            jnp.asarray(a["g"]), 2, 1e-5, True)
        ours = tbwd.fused_attention_block_bwd_fullgrad(
            _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"], True), _t(a["bqkv"]),
            _t(a["wo"], True), _t(a["g"]), 2, 1e-5)
    for i, (mine, theirs) in enumerate(zip(ours, ref)):
        theirs = np.asarray(theirs)
        theirs = theirs.T if i in (1, 3) else theirs.reshape(mine.shape)
        err = float(np.abs(mine.numpy() - theirs).max())
        assert err < 1e-3 * max(float(np.abs(theirs).max()), 1.0), (i, err)
