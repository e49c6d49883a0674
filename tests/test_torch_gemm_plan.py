"""The launch plans of the GEMM's three forms (``ops/gemm.py::gemm_plan``,
``dgrad_plan``, ``wgrad_plan``) and the forward attention
(``ops/attention.py::attention_plan``), the plain Python functions their
wrappers call, at every product and attention shape of the published
towers: ViT-B-16, ViT-B-32, ViT-L-14, ViT-L-14-336 and ViT-H-14 images,
RoBERTa-wwm-ext-base, -large and RBT3 texts at 52 tokens (RN50's text tower
is RBT3; its ResNet image tower is not ported and runs no product here), the
forward at tp 1, 2 and 4 where tensor parallelism admits the tower, the
backward products at tp 1, batches 1 to 256. Each plan admits its shape,
stays within the 232,448 bytes of shared memory a block may have, and
covers its output exactly once; the weight gradient's slices fall where
``wgrad_splits`` puts them. Runs on the CPU: the plans are arithmetic on
shapes."""

import pytest

from nans_clip_tpu_torch.configs import load_config
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.ops.attention import ATTN_ONE_PASS_TILES, attention_plan
from nans_clip_tpu_torch.ops.gemm import dgrad_plan, gemm_plan, wgrad_plan, wgrad_splits

TEXT_SEQ = 52
BATCHES = (1, 8, 32, 128, 256)
VISION = ("ViT-B-16", "ViT-B-32", "ViT-L-14", "ViT-L-14-336", "ViT-H-14")
TEXT = ("RoBERTa-wwm-ext-base-chinese", "RoBERTa-wwm-ext-large-chinese", "RBT3-chinese")


def _tower(name):
    """(seq, width, heads, intermediate) of a published tower."""
    if name in VISION:
        v = load_config(f"{name}@RBT3-chinese").vision
        return v.seq_len, v.width, v.heads, 4 * v.width
    t = load_config(f"ViT-B-16@{name}").text
    return TEXT_SEQ, t.hidden_size, t.num_attention_heads, t.intermediate_size


def _products(width, inter, tp):
    """(N, K) of the four forward products of one rank: QKV, out-projection,
    fc1, fc2 (tp 1: the whole layer; tp > 1: #11/#12's partial products)."""
    return [(3 * width // tp, width), (width, width // tp), (inter // tp, width),
            (width, inter // tp)]


def _cases():
    for name in VISION + TEXT:
        seq, width, heads, inter = _tower(name)
        for tp in (1, 2, 4):
            if tp > 1 and not (gates.fits_partial(width, tp, heads=heads)
                               and gates.fits_partial(width, tp, inter=inter)):
                continue
            yield pytest.param(name, tp, id=f"{name}-tp{tp}")


def _intervals(n, block, count):
    """The clipped [start, end) of ``count`` tiles of ``block`` over ``n``."""
    return [(i * block, min((i + 1) * block, n)) for i in range(count)]


def _covers_once(n, block, count):
    spans = _intervals(n, block, count)
    return (spans[0][0] == 0 and spans[-1][1] == n
            and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            and all(lo < hi for lo, hi in spans))


def test_every_published_tower_has_a_case():
    ids = [c.id for c in _cases()]
    for name in VISION + TEXT:
        assert f"{name}-tp1" in ids
    # the TP widths the partial kernels take (gates.fits_partial)
    assert "ViT-B-16-tp4" in ids and "ViT-H-14-tp2" in ids and "RBT3-chinese-tp2" in ids


@pytest.mark.parametrize("name,tp", list(_cases()))
def test_gemm_plan_covers_every_product(name, tp):
    seq, width, heads, inter = _tower(name)
    bm, bn, bk = gemm_plan(1, 64, 32)["tile"]
    for batch in BATCHES:
        m = batch * seq
        for n, k in _products(width, inter, tp):
            # the wrapper's admission of the shape
            assert n % gates.GEMM_FWD_N_MULTIPLE == 0 and k % gates.GEMM_K_MULTIPLE == 0
            for clusters in (66, 57, 1):
                p = gemm_plan(m, n, k, clusters)
                assert p["smem"] <= gates.SMEM_PER_BLOCK
                assert p["smem"] >= p["stages"] * (bm + bn) * bk * 2
                assert p["stages"] >= 4 and p["box_a"] == (bk, bm)
                assert p["box_w"][1] * p["cluster"] == bn   # the cluster's parts make W's box
                # the persistent clusters visit every work unit once
                n_cl = p["grid"] // p["cluster"]
                assert p["grid"] % p["cluster"] == 0 and 1 <= n_cl <= clusters
                walk = sorted(u for c in range(n_cl) for u in range(c, p["units"], n_cl))
                assert walk == list(range(p["units"]))
                # a unit's CTAs take M tiles cluster * (u // tiles_n) + r
                tiles = sorted((p["cluster"] * (u // p["tiles_n"]) + r, u % p["tiles_n"])
                               for u in walk for r in range(p["cluster"]))
                real = [t for t in tiles if t[0] < p["tiles_m"]]
                assert real == sorted((i, j) for i in range(p["tiles_m"])
                                      for j in range(p["tiles_n"]))
                assert len(tiles) - len(real) < p["tiles_n"] * p["cluster"]
                # the tiles' rows and columns partition M and N
                assert _covers_once(m, bm, p["tiles_m"]) and _covers_once(n, bn, p["tiles_n"])
                # a last N tile holds whole 64-column groups, a last stage
                # zero-fills at most half its 64-deep K
                assert (n - (p["tiles_n"] - 1) * bn) % 64 == 0
                assert 0 <= p["k_steps"] * bk - k <= bk - gates.GEMM_K_MULTIPLE


def _bwd_products(width, inter):
    """(dY's width N, the weight's other width K) of the four backward
    products of a layer: the input gradient dY [M, N] . W [N, K] and the
    weight gradient dW [N, K] = dY^T . X, for the QKV projection, the
    out-projection, fc1 and fc2."""
    return [(3 * width, width), (width, width), (inter, width), (width, inter)]


def _walk(units, n_cl):
    return sorted(u for c in range(n_cl) for u in range(c, units, n_cl))


@pytest.mark.parametrize("name", VISION + TEXT)
def test_dgrad_plan_covers_every_product(name):
    seq, width, _, inter = _tower(name)
    bm, bn, bk = dgrad_plan(1, 32, 128)["tile"]
    for batch in BATCHES:
        m = batch * seq
        for n, k in _bwd_products(width, inter):
            # the wrapper's admission: output width k, contraction n
            assert k % gates.GEMM_N_MULTIPLE == 0 and n % gates.GEMM_K_MULTIPLE == 0
            for clusters in (66, 57, 1):
                p = dgrad_plan(m, n, k, clusters)
                assert p["smem"] <= gates.SMEM_PER_BLOCK
                assert p["smem"] >= p["stages"] * (bm + bn) * bk * 2 and p["stages"] >= 4
                assert p["box_a"] == (bk, bm)
                # W's stage: boxes side by side along its columns, each CTA
                # loading its share into both
                assert p["box_b"][0] * p["boxes_b"] == bn and p["box_b"][1] == bk
                assert p["boxes_b"] % p["cluster"] == 0
                n_cl = p["grid"] // p["cluster"]
                assert p["grid"] % p["cluster"] == 0 and 1 <= n_cl <= clusters
                walk = _walk(p["units"], n_cl)
                assert walk == list(range(p["units"]))
                tiles = sorted((p["cluster"] * (u // p["tiles_n"]) + r, u % p["tiles_n"])
                               for u in walk for r in range(p["cluster"]))
                real = [t for t in tiles if t[0] < p["tiles_m"]]
                assert real == sorted((i, j) for i in range(p["tiles_m"])
                                      for j in range(p["tiles_n"]))
                assert len(tiles) - len(real) < p["tiles_n"] * p["cluster"]
                assert _covers_once(m, bm, p["tiles_m"]) and _covers_once(k, bn, p["tiles_n"])
                # a last output tile holds whole 64-column boxes; a last
                # stage zero-fills at most half its 64-deep contraction
                assert (k - (p["tiles_n"] - 1) * bn) % p["box_b"][0] == 0
                assert 0 <= p["k_steps"] * bk - n <= bk - gates.GEMM_K_MULTIPLE


@pytest.mark.parametrize("name", VISION + TEXT)
def test_wgrad_plan_covers_every_product(name):
    seq, width, _, inter = _tower(name)
    for batch in BATCHES:
        m = batch * seq
        for n, k in _bwd_products(width, inter):
            assert n % gates.GEMM_N_MULTIPLE == 0 and k % gates.GEMM_N_MULTIPLE == 0
            for clusters in (66, 57, 1):
                p = wgrad_plan(m, n, k, clusters)
                bm, bn, bk = p["tile"]
                assert p["smem"] <= gates.SMEM_PER_BLOCK
                # the slices: per 32-row k-tiles each, where wgrad_splits
                # puts them, partitioning the M rows in order
                ktiles = -(-m // 32)
                per = -(-ktiles // wgrad_splits(m, n, k))
                assert p["per"] == per and p["splits"] == -(-ktiles // per)
                assert p["slices"] == [(z * per * 32, min(m, (z + 1) * per * 32))
                                       for z in range(p["splits"])]
                assert _covers_once(m, per * 32, p["splits"])
                # a slice runs its 64-row stages from its first row; where it
                # ends halfway through one, its last stage takes 2 k16 steps
                for (lo, hi), st, steps in zip(p["slices"], p["slice_stages"],
                                               p["last_steps"]):
                    kts = -(-(hi - lo) // 32)
                    assert st == -(-kts // 2) and steps == (2 if kts % 2 else 4)
                    assert (st - 1) * bk + steps * 16 >= hi - lo > (st - 1) * bk
                assert p["splits"] == 1 or per >= 16
                # every (dW row tile, column tile, slice) exactly once
                n_cl = p["grid"] // p["cluster"]
                assert p["grid"] % p["cluster"] == 0 and 1 <= n_cl <= clusters
                walk = _walk(p["units"], n_cl)
                assert walk == list(range(p["units"]))
                assert p["pairs"] * p["cluster"] >= p["tiles_n"] == n // bm
                tiles = sorted((p["cluster"] * (u % p["pairs"]) + r,
                                u // p["pairs"] % p["tiles_k"],
                                u // (p["pairs"] * p["tiles_k"]))
                               for u in walk for r in range(p["cluster"]))
                real = [t for t in tiles if t[0] < p["tiles_n"]]
                assert real == sorted((i, j, z) for i in range(p["tiles_n"])
                                      for j in range(p["tiles_k"])
                                      for z in range(p["splits"]))
                assert _covers_once(n, bm, p["tiles_n"]) and _covers_once(k, bn, p["tiles_k"])
                assert (k - (p["tiles_k"] - 1) * bn) % p["box"][0] == 0
                assert p["box"] == (64, bk)


@pytest.mark.parametrize("m,n,k", [(25216, 2304, 768), (25216, 768, 768), (6656, 3072, 768),
                                   (8224, 1280, 5120), (18464, 1024, 4096), (1, 128, 128),
                                   (100000, 128, 128)])
def test_wgrad_splits_is_a_function_of_the_shape(m, n, k):
    """The slice count depends on the shape alone (so the fixed-order sum of
    the partials gives the same bits on every call) and keeps each slice at
    least 16 k-tiles deep."""
    s = wgrad_splits(m, n, k)
    assert s == wgrad_splits(m, n, k) and 1 <= s <= max(1, -(-m // 32) // 16)
    p = wgrad_plan(m, n, k)
    assert p["splits"] == s


def _attention_work(p, batch, heads):
    """Each (unit, strip) the plan's blocks and warps take, in taking order:
    a unit is head ``u % heads`` of sample ``u // heads``. The walk's block
    ``j`` takes units ``j``, ``j + blocks``, ... and its warps draw the
    block's strips in order (unit by unit); a block a (head, sample) gives
    warp ``i`` strips ``i``, ``i + warps``, ..."""
    units, strips = batch * heads, p["strips"]
    if p["key_tiles"] > 4:
        return [(u, g % strips) for j in range(p["blocks"])
                for u_k, u in enumerate(range(j, units, p["blocks"]))
                for g in range(u_k * strips, (u_k + 1) * strips)]
    return [(h + heads * b, t) for b in range(batch) for h in range(heads)
            for w in range(p["warps"]) for t in range(w, strips, p["warps"])]


def _attention_fits_an_sm(p, dh):
    """The plan's blocks an SM fit its shared memory (a block's 1 KB
    reserve each) and registers (the walk at 128 a thread at dh 64 and 168
    at dh 80, the block a (head, sample) of 4 key tiles at 128, four an
    SM)."""
    regs = 128 if p["key_tiles"] <= 4 or dh == 64 else 168
    return (p["smem"] <= gates.SMEM_PER_BLOCK
            and p["blocks_per_sm"] * (p["smem"] + 1024) <= gates.SMEM_PER_SM
            and (p["key_tiles"] == 0 or p["blocks_per_sm"] * p["threads"] * regs
                 <= gates.REGS_PER_SM))


@pytest.mark.parametrize("name,tp", list(_cases()))
def test_attention_plan_covers_every_head(name, tp):
    seq, width, heads, _ = _tower(name)
    dh = width // heads
    assert dh in gates.HEAD_DIMS and seq <= gates.MAX_SEQ
    for batch in BATCHES:
        h = heads // tp
        p = attention_plan(batch, seq, h, dh)
        assert p["strips"] * 16 >= seq > (p["strips"] - 1) * 16
        assert _attention_fits_an_sm(p, dh)
        # every (head, sample) unit taken once, and every strip of it once
        work = _attention_work(p, batch, h)
        assert sorted(work) == [(u, t) for u in range(batch * h) for t in range(p["strips"])]
        assert p["blocks"] == (min(batch * h, gates.H100_SMS) if p["key_tiles"] > 4
                               else batch * h)
        if p["key_tiles"] > 4:
            # the walk: one block an SM; its warps and stages as many as its
            # units use, the stages in what the warps' Q buffers leave
            assert p["key_tiles"] in ATTN_ONE_PASS_TILES and p["key_tiles"] >= p["strips"]
            assert p["grid"] == (p["blocks"],) and p["blocks_per_sm"] == 1
            assert p["units_per_block"] == -(-batch * h // p["blocks"])
            assert 1 <= p["warps"] <= min(16 if dh == 64 else 12,
                                          p["units_per_block"] * p["strips"])
            assert 1 <= p["stages"] <= min(8, p["units_per_block"])
        else:
            # a block a (head, sample); every warp at least one strip (each
            # passes the block barrier once)
            assert p["grid"] == (h, batch) and p["stages"] == 0
            assert 1 <= p["warps"] <= p["strips"]
            assert p["rounds"] == -(-p["strips"] // p["warps"])
            if p["key_tiles"]:
                assert p["key_tiles"] == 4 >= p["strips"] and p["warps"] <= 4
                assert p["blocks_per_sm"] == 4
            else:
                assert p["strips"] > ATTN_ONE_PASS_TILES[-1] and p["warps"] <= 8


@pytest.mark.parametrize("seq", [1, 15, 16, 17, 52, 197, 256, 257, 577, 640])
@pytest.mark.parametrize("dh", gates.HEAD_DIMS)
def test_attention_plan_fits_every_admitted_length(seq, dh):
    """Every S the wrapper admits, at both head dims, at a few units (one a
    block) and at many (24 a block): a block a (head, sample) in one pass up
    to 64 keys and in two above 256 (640 at dh 80 is the tightest: 227,840
    bytes with 4 warps), the walk between; shared memory within a block's
    and the plan's blocks within an SM's."""
    for batch, heads in ((2, 4), (256, 12)):
        p = attention_plan(batch, seq, heads, dh)
        s_pad = p["strips"] * 16
        qbuf = p["warps"] * 2 * 16 * dh * 2
        assert _attention_fits_an_sm(p, dh)
        assert (p["key_tiles"] > 0) == (seq <= 256)
        assert (p["key_tiles"] > 4) == (64 < seq <= 256)
        assert sorted(_attention_work(p, batch, heads)) == [
            (u, t) for u in range(batch * heads) for t in range(p["strips"])]
        if p["key_tiles"] > 4:
            stage = 2 * s_pad * dh * 2 + s_pad * 4
            assert p["smem"] == 256 + p["stages"] * stage + qbuf
            # as many stages as fit, up to 8 and the block's units
            assert (p["stages"] == min(8, p["units_per_block"])
                    or p["smem"] + stage > gates.SMEM_PER_BLOCK)
        else:
            assert p["smem"] == 2 * s_pad * dh * 2 + s_pad * 4 + qbuf
            assert p["rounds"] * p["warps"] >= p["strips"] > (p["rounds"] - 1) * p["warps"]
        if (seq, dh) == (640, 80):
            assert p["smem"] == 227840 and p["warps"] == 4
        if seq == 197:
            assert p["key_tiles"] == 13
            if (batch, dh) == (256, 64):
                # ViT-B-16 at batch 256: 16 warps, three units staged
                assert p["warps"] == 16 and p["stages"] == 3 and p["blocks"] == gates.H100_SMS
