"""Tensor parallelism of the port (``nans_clip_tpu_torch/parallel/tp.py``,
``parallel/mesh.py``, the partial kernels' twins in ``ops/fused_block.py``)
against the JAX package on the CPU, fp32.

* In this process, no process group: the twins of #11 / #12 and their
  gradients against the JAX Pallas partials in interpret mode, at
  tests/test_tp.py's shapes ([8, 24, 64], 4 heads, 2 a rank; MLP I 256, 128 a
  rank), on the weights of each rank as the port's slicing helpers cut them
  from the full weights that JAX's ``_local_qkv`` slices (the slices are
  compared too); the routing (``gates.tp_impls``) and the admission of the
  partial kernels (``gates.fits_partial``) at every published shape; the
  fail-fast errors that need no group.
* In 2 spawned processes joined by gloo (``tests/test_torch_tp_worker.py``,
  run once for the whole module): ``tp_attention_block`` / ``tp_mlp_block``
  against the JAX unsharded oracle and the JAX TP path (``impl="fused"``,
  interpret mode, on the 8-device CPU mesh), every input and parameter
  gradient (after the reduction rule) against ``jax.grad`` of the oracle;
  tests/test_tp.py's TINY towers at ``tp=2`` against the JAX unsharded
  towers; one deterministic TP train step against JAX's one-device step:
  the loss, every gradient before the optimizer, then the parameters, and
  the parameters equal on both ranks; the mismatched-tp errors; and a text
  tower with dropout 0.1 under tp 2 (JAX's unfused path under TP, the twins
  with one process's masks) at ``tiny_config()`` and at RoBERTa-base widths
  cut to 2 layers, against tp 1 with the same generator seed: the text
  tower's output, one train step's loss and every gradient, the ranks'
  parameters bit-equal, and the ranks' attention masks concatenated over
  heads equal to tp 1's.

Tolerances: outputs 5e-5 (tests/test_tp.py's bound: fp32 sums in another
order); gradients 5e-4 of max(|JAX gradient|, 1) for the sub-blocks; the
towers atol 5e-5, rtol 5e-4 (test_tp.py:95-98); the train step's loss
1e-4 and each gradient 1e-4 of its largest magnitude, except BERT's key
biases, whose gradient is 0 in exact arithmetic (softmax ignores a shift
shared by all keys) and is held below 1e-8 on both sides, as in
tests/test_torch_train.py; the parameters after one AdamW step 5e-4
(test_tp.py:131), plus 2 * lr on elements whose JAX gradient is below 1e-6
in magnitude: Adam's first step moves an element by lr * g / (|g| + eps),
so two gradients of 1e-8 that the sum order gives opposite signs move it
apart by up to 2 * lr (one element of a BERT LayerNorm scale does: 9.8e-9
here against -2.5e-8 in JAX, 1.2e-3 apart after the step), as
tests/test_torch_train.py allows. Dropout under tp 2 against tp 1: the text
tower's output within 1e-5 and the loss within 1e-5 (fp32, the same masks:
only sum orders differ), each gradient within 1e-4 of its largest magnitude
(the key biases as above), the masks exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.ops import fused_block as jfb
from nans_clip_tpu.parallel import clip_loss as jclip_loss
from nans_clip_tpu.parallel import create_mesh
from nans_clip_tpu.parallel.mesh import MODEL_AXIS
from nans_clip_tpu.parallel.tp import _local_qkv
from nans_clip_tpu.parallel.tp import tp_attention_block as jtp_attention_block
from nans_clip_tpu.parallel.tp import tp_mlp_block as jtp_mlp_block
from nans_clip_tpu.training import trainer as jtrainer
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.models.bert import BertModel
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.ops import fused_block as fb
from nans_clip_tpu_torch.ops import gates
from nans_clip_tpu_torch.parallel import mesh
from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params
from tests import test_torch_tp_worker as worker
from tests.test_trainer import TINY

torch.set_num_threads(2)

W, HEADS, INTER, TP = 64, 4, 256, 2


def _attn_args(post_ln: bool, seed: int = 0):
    """x, ln scale, ln bias, wqkv [W, 3W], bqkv, wo [W, W], bo (the JAX
    layout) and a key bias [8, 24] or None (tests/test_tp.py:28-50)."""
    rs = np.random.RandomState(seed)
    args = (rs.randn(8, 24, W), 1.0 + 0.1 * rs.randn(W), 0.1 * rs.randn(W),
            0.1 * rs.randn(W, 3 * W), 0.1 * rs.randn(3 * W), 0.1 * rs.randn(W, W),
            0.1 * rs.randn(W))
    key_bias = None
    if post_ln:
        mask = np.ones((8, 24), np.float32)
        mask[:, 18:] = 0.0
        key_bias = (1.0 - mask) * -10000.0
    return [a.astype(np.float32) for a in args], key_bias


def _mlp_args(seed: int = 1):
    """x, ln scale, ln bias, w1 [W, I], b1, w2 [I, W], b2 (tests/test_tp.py:57-65)."""
    rs = np.random.RandomState(seed)
    args = (rs.randn(8, 24, W), 1.0 + 0.1 * rs.randn(W), 0.1 * rs.randn(W),
            0.1 * rs.randn(W, INTER), 0.1 * rs.randn(INTER), 0.1 * rs.randn(INTER, W),
            0.1 * rs.randn(W))
    return [a.astype(np.float32) for a in args]


def _torch_layout(kind: str, args):
    """The JAX ``[in, out]`` weights as the port's ``[out, in]``."""
    x, s, b, w_a, b_a, w_b, b_b = args
    return [x, s, b, w_a.T.copy(), b_a, w_b.T.copy(), b_b]


def _gout(seed: int):
    return np.random.RandomState(seed).randn(8, 24, W).astype(np.float32)


# (kind, post_ln / act): pre-LN unmasked and post-LN masked attention,
# quick-GELU pre-LN and erf-GELU post-LN MLP, as tests/test_tp.py
CASES = {"attn-pre": ("attn", False, None), "attn-post-masked": ("attn", True, None),
         "mlp-quick_gelu-pre": ("mlp", False, "quick_gelu"),
         "mlp-gelu-post": ("mlp", True, "gelu")}


def _jax_local_qkv(wqkv, bqkv, tp):
    """Every rank's ``_local_qkv`` slice: [tp, W, 3 Wl], [tp, 3 Wl]."""
    return jax.vmap(lambda _: _local_qkv(jnp.asarray(wqkv), jnp.asarray(bqkv), HEADS, tp)[:2],
                    axis_name=MODEL_AXIS)(jnp.arange(tp))


@pytest.mark.parametrize("tp", [2, 4])
def test_slices_match_jax(tp):
    """The port's slicing helpers cut the same weights as JAX's
    ``_local_qkv`` and shard specs (wo / w2 rows, w1 / b1 columns of the
    JAX layout)."""
    (_, _, _, wqkv, bqkv, wo, _), _ = _attn_args(False)
    _, _, _, w1, b1, w2, _ = _mlp_args()
    jw, jb = _jax_local_qkv(wqkv, bqkv, tp)
    for r in range(tp):
        wq, bq = mesh.qkv_slice(torch.from_numpy(wqkv.T.copy()), torch.from_numpy(bqkv),
                                HEADS, r, tp)
        np.testing.assert_array_equal(wq.numpy(), np.asarray(jw[r]).T)
        np.testing.assert_array_equal(bq.numpy(), np.asarray(jb[r]))
        n, i = W // tp, INTER // tp
        np.testing.assert_array_equal(mesh.column_slice(torch.from_numpy(wo.T.copy()), r,
                                                        tp).numpy(), wo[r * n:(r + 1) * n].T)
        np.testing.assert_array_equal(mesh.row_slice(torch.from_numpy(w1.T.copy()), r,
                                                     tp).numpy(), w1[:, r * i:(r + 1) * i].T)
        np.testing.assert_array_equal(mesh.row_slice(torch.from_numpy(b1), r, tp).numpy(),
                                      b1[r * i:(r + 1) * i])
        np.testing.assert_array_equal(mesh.column_slice(torch.from_numpy(w2.T.copy()), r,
                                                        tp).numpy(), w2[r * i:(r + 1) * i].T)
        assert mesh.column_slice(torch.from_numpy(w2.T.copy()), r, tp).is_contiguous()


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_partial_twins_match_jax_pallas(case, rank):
    """``_reference_block_partial`` / ``_reference_mlp_partial`` and the
    autograd wrappers (``fused_*_partial``: the twin forward on CPU tensors,
    autograd through the twin backward) against the JAX Pallas partials in
    interpret mode on rank ``rank``'s weights, forward and gradients."""
    kind, post_ln, act = CASES[case]
    gout = _gout(7)
    if kind == "attn":
        (x, s, b, wqkv, bqkv, wo, _), key_bias = _attn_args(post_ln)
        jw, jb = _jax_local_qkv(wqkv, bqkv, TP)
        wl = W // TP
        jargs = [x, s, b, np.asarray(jw[rank]), np.asarray(jb[rank]), wo[rank * wl:(rank + 1) * wl]]
        kb = None if key_bias is None else jnp.asarray(key_bias)
        jfn = lambda *a: jfb.fused_attention_block_partial(*a, kb, HEADS // TP, 1e-5,
                                                           not post_ln, True)
        wq, bq = mesh.qkv_slice(torch.from_numpy(wqkv.T.copy()), torch.from_numpy(bqkv), HEADS,
                                rank, TP)
        targs = [torch.from_numpy(a) for a in (x, s, b)] + [
            wq, bq, mesh.column_slice(torch.from_numpy(wo.T.copy()), rank, TP)]
        tkb = None if key_bias is None else torch.from_numpy(key_bias)
        twin = lambda *a: fb._reference_block_partial(*a, HEADS // TP, 1e-5, not post_ln, tkb)
        fn = lambda *a: fb.fused_attention_block_partial(*a, tkb, HEADS // TP, 1e-5,
                                                         not post_ln)
    else:
        x, s, b, w1, b1, w2, _ = _mlp_args()
        il = INTER // TP
        sl = slice(rank * il, (rank + 1) * il)
        jargs = [x, s, b, w1[:, sl], b1[sl], w2[sl]]
        jfn = lambda *a: jfb.fused_mlp_block_partial(*a, act, 1e-5, not post_ln, True)
        targs = [torch.from_numpy(a) for a in (x, s, b)] + [
            mesh.row_slice(torch.from_numpy(w1.T.copy()), rank, TP),
            mesh.row_slice(torch.from_numpy(b1), rank, TP),
            mesh.column_slice(torch.from_numpy(w2.T.copy()), rank, TP)]
        twin = lambda *a: fb._reference_mlp_partial(*a, act, 1e-5, not post_ln)
        fn = lambda *a: fb.fused_mlp_block_partial(*a, act, 1e-5, not post_ln)
    jargs = [jnp.asarray(np.ascontiguousarray(a)) for a in jargs]
    want = np.asarray(jfn(*jargs))
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * jnp.asarray(gout)),
                      argnums=tuple(range(6)))(*jargs)
    np.testing.assert_allclose(twin(*targs).numpy(), want, atol=5e-5, rtol=5e-5)
    leaves = [t.clone().requires_grad_() for t in targs]
    out = fn(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=5e-5, rtol=5e-5)
    (out * torch.from_numpy(gout)).sum().backward()
    for i, (t, g) in enumerate(zip(leaves, jgrads)):
        g = np.asarray(g)
        if i in (3, 5):   # the weights: [out, in] against JAX's [in, out]
            g = g.T
        if post_ln and i in (1, 2):
            # the LayerNorm of a post-LN sub-block is outside the partial
            assert t.grad is None and not g.any()
            continue
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=5e-4 * max(float(np.abs(g).max()), 1.0),
                                   err_msg=f"{case} gradient {i}")


PUBLISHED = [f"{v}@{t}" for v in ("ViT-B-16", "ViT-B-32", "ViT-L-14", "ViT-L-14-336",
                                  "ViT-H-14")
             for t in ("RoBERTa-wwm-ext-base-chinese", "RoBERTa-wwm-ext-large-chinese",
                       "RBT3-chinese")]


@pytest.mark.parametrize("struct", PUBLISHED)
def test_tp_routing_matches_jax(struct):
    """``gates.tp_impls`` picks "fused" or "xla" for each tower as the JAX
    towers do (vit.py:145-151, bert.py:97-144) for every attn_impl that
    runs on the CPU here, the partial kernels admit every published shape
    at tp 2 and 4, and the whole-tower route is never taken under tp > 1."""
    cfg = tconfigs.load_config(struct)
    v, t = cfg.vision, cfg.text
    towers = (("image", v.seq_len, v.width, v.heads, 4 * v.width, None),
              ("text", 52, t.hidden_size, t.num_attention_heads, t.intermediate_size,
               t.hidden_act))
    for tower, seq, w, heads, inter, act in towers:
        x = torch.empty(1, seq, w, device="meta")
        for impl in ("fused", "xla", "plain", "pallas", "auto"):
            use_fused = impl == "fused"   # JAX: "auto" is fused on a TPU only
            want_a = "fused" if use_fused and jfb.fits_fused(seq, w) else "xla"
            want_m = "fused" if (use_fused and jfb.fits_fused_mlp(seq, w)
                                 and (act is None or act == "gelu")) else "xla"
            assert gates.tp_impls(x, impl, act) == (want_a, want_m), (tower, impl)
        for tp in (2, 4):
            assert gates.fits_partial(w, tp, heads, inter), (tower, tp)
            xb = torch.empty(1, seq, w, dtype=torch.bfloat16)
            assert not gates.tower_route(xb, "auto", tower, heads, inter, False, tp)
    assert not gates.fits_partial(768, 8, heads=12)   # 12 heads on 8 ranks
    assert not gates.fits_partial(768, 8, inter=3072 + 32 * 8)   # fc1 width 416 a rank
    assert gates.fits_partial(768, 8, inter=3072)


def test_linear_takes_no_bias():
    """``linear`` and its twin take ``bias=None`` (the partials'
    out-projections): the product alone, then the activation and residual."""
    from nans_clip_tpu_torch.ops.gemm import linear, linear_plain
    rs = np.random.RandomState(5)
    a, w, res = (torch.from_numpy(rs.randn(*s).astype(np.float32))
                 for s in ((6, 64), (192, 64), (6, 192)))
    torch.testing.assert_close(linear(a, w, None), a @ w.T, rtol=1e-6, atol=1e-6)
    assert torch.equal(linear(a, w, None, "gelu", res), linear_plain(a, w, None, "gelu", res))
    torch.testing.assert_close(linear_plain(a, w, None, residual=res),
                               linear_plain(a, w, torch.zeros(192), residual=res))


def test_fail_fast_without_a_group():
    """tp > 1 without a process group, a bad tp value and dropout asked of
    the partial kernels raise with a message; nothing runs another route."""
    with pytest.raises(ValueError, match="tp must be"):
        ModelOptions(tp=0)
    with pytest.raises(RuntimeError, match="process group"):
        mesh.model_group(2)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.qkv_slice(torch.zeros(3 * 64, 64), torch.zeros(3 * 64), 3, 0, 2)
    cfg = tconfigs.tiny_config()
    bert = BertModel(cfg.text)
    bert.init_weights(torch.Generator().manual_seed(0))
    from nans_clip_tpu_torch.parallel.tp import tp_attention_block
    w = [torch.ones(64), torch.zeros(64), torch.zeros(192, 64), torch.zeros(192),
         torch.zeros(64, 64), torch.zeros(64)]
    with pytest.raises(ValueError, match="partial kernels take no dropout"):
        tp_attention_block(torch.zeros(2, 8, 64), *w, 4, 2, post_ln=True, impl="fused", seed=1,
                           hid_drop=0.1)
    with pytest.raises(ValueError, match="backend"):
        mesh.init_model_group("mpi", "file:///nonexistent", 0, 2)
    from nans_clip_tpu_torch.training import train_lora
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        train_lora.make_lora_step(cfg, ModelOptions(tp=2), 16.0, 0.0, 1)


# ---------------------------------------------------------------------------
# 2 processes
# ---------------------------------------------------------------------------


def _port_cfg(jcfg):
    v, t = jcfg.vision, jcfg.text
    return tconfigs.CLIPConfig(embed_dim=jcfg.embed_dim,
                               vision=tconfigs.VisionConfig(**dataclasses.asdict(v)),
                               text=tconfigs.TextConfig(**dataclasses.asdict(t)), name=jcfg.name)


def _tiny_batch(b=16, seed=0):
    rs = np.random.RandomState(seed)
    images = rs.randn(b, 32, 32, 3).astype(np.float32)
    texts = np.zeros((b, 52), np.int32)
    texts[:, 0] = 101
    texts[:, 1:12] = rs.randint(1000, 20000, (b, 11))
    texts[:, 12] = 102
    texts[0, 6:12] = 0                     # one shorter text: the key bias matters
    return images, texts


def _as_port(tree, cfg):
    return {k: v.numpy() for k, v in
            state_dict_from_jax_params(jax.tree.map(np.asarray, tree), cfg).items()}


TCFG = dict(lr=1e-3, warmup=1, max_steps=10)
DROPOUT_SEED = 5


def _dropout_cases() -> dict:
    """Text dropout under tp 2: ``tiny_config()`` and ViT-B-16@RoBERTa-base
    cut to 2 layers a tower (images at 32 px: the text tower keeps its
    widths, 12 heads of 64, I 3072), seeded weights, dropout 0.1."""
    from nans_clip_tpu_torch.models.clip import build_clip

    base = tconfigs.with_resolution(
        tconfigs.load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese"), 32)
    base = dataclasses.replace(base, vision=dataclasses.replace(base.vision, layers=2),
                               text=dataclasses.replace(base.text, num_hidden_layers=2))
    cases = {}
    for name, cfg, b in (("tiny", tconfigs.tiny_config(), 16), ("roberta-base", base, 8)):
        assert cfg.text.hidden_dropout_prob == cfg.text.attention_probs_dropout_prob == 0.1
        images, texts = _tiny_batch(b, seed=3)
        module = build_clip(cfg, "cpu", torch.Generator().manual_seed(1))
        cases[name] = dict(cfg=cfg, state_dict={k: v.numpy() for k, v in
                                                module.state_dict().items()},
                           images=images, texts=texts, tcfg=TCFG, seed=DROPOUT_SEED)
    return cases


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The JAX side here, then every port case in one pair of gloo ranks."""
    jax_side, blocks = {"blocks": {}}, {}
    mesh2 = create_mesh(data=4, model=2)
    for name, (kind, post_ln, act) in CASES.items():
        gout = _gout(11)
        if kind == "attn":
            args, key_bias = _attn_args(post_ln)
            kb = None if key_bias is None else jnp.asarray(key_bias)
            oracle = lambda *a: jfb._reference_block(*a, heads=HEADS, eps=1e-5, key_bias=kb,
                                                     post_ln=post_ln)
            with jax.set_mesh(mesh2):
                jtp = jtp_attention_block(*map(jnp.asarray, args), HEADS, TP, eps=1e-5,
                                          post_ln=post_ln, key_bias=kb, impl="fused",
                                          interpret=True)
            blocks[name] = dict(kind=kind, post_ln=post_ln, heads=HEADS, key_bias=key_bias,
                                args=_torch_layout(kind, args), gout=gout)
        else:
            args = _mlp_args()
            oracle = lambda *a: jfb._reference_mlp(*a, act=act, eps=1e-5, post_ln=post_ln)
            with jax.set_mesh(mesh2):
                jtp = jtp_mlp_block(*map(jnp.asarray, args), act, TP, eps=1e-5, post_ln=post_ln,
                                    impl="fused", interpret=True)
            blocks[name] = dict(kind=kind, post_ln=post_ln, act=act, args=_torch_layout(kind, args),
                                gout=gout)
        jargs = [jnp.asarray(a) for a in args]
        grads = jax.grad(lambda *a: jnp.sum(oracle(*a) * jnp.asarray(gout)),
                         argnums=tuple(range(7)))(*jargs)
        jax_side["blocks"][name] = dict(
            oracle=np.asarray(oracle(*jargs)), tp=np.asarray(jtp),
            grads=_torch_layout(kind, [np.asarray(g) for g in grads]))

    cfg = _port_cfg(TINY)
    params, _ = jclip.init_clip(jax.random.PRNGKey(0), TINY)
    images, texts = _tiny_batch()
    xla = JOptions(attn_impl="xla", deterministic=True)
    jax_side["towers"] = {
        "image": np.asarray(jclip.encode_image(params, TINY, jnp.asarray(images), xla)),
        "text": np.asarray(jclip.encode_text(params, TINY, jnp.asarray(texts), xla))}

    def loss_fn(p):
        img = jclip.encode_image(p, TINY, jnp.asarray(images), xla)
        txt = jclip.encode_text(p, TINY, jnp.asarray(texts), xla)
        scale = jnp.exp(p["logit_scale"].astype(jnp.float32))
        return jclip_loss(jclip.normalize(img), jclip.normalize(txt), scale, constrain=False)[0]

    tcfg = jtrainer.TrainConfig(**TCFG)
    step = jtrainer.make_train_step(TINY, tcfg, xla, constrain=False)
    state = jtrainer.create_train_state(jax.tree.map(jnp.copy, params), {}, tcfg)
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(texts), jax.random.PRNGKey(3))
    jax_side["train"] = dict(loss=float(metrics["loss"]),
                             grads=_as_port(jax.grad(loss_fn)(params), cfg),
                             params=_as_port(state.params, cfg))

    payload = {"blocks": blocks,
               "tiny": dict(cfg=cfg, state_dict=_as_port(params, cfg), images=images,
                            texts=texts, tcfg=TCFG),
               "dropout": _dropout_cases()}
    ranks = mesh.run_ranks(worker.run_all, 2, "gloo",
                           str(tmp_path_factory.mktemp("rendezvous") / "init"), (payload,),
                           timeout_s=300.0)
    jax_side["dropout_tp1"] = {name: worker.dropout_run(c["cfg"], c["state_dict"], c["images"],
                                                        c["texts"], c["tcfg"], c["seed"], 1)
                               for name, c in payload["dropout"].items()}
    return jax_side, ranks


@pytest.mark.parametrize("impl", ["fused", "xla"])
@pytest.mark.parametrize("case", list(CASES))
def test_tp_blocks_match_jax(tp_run, case, impl):
    """One TP sub-block on each of 2 ranks: the output against the JAX
    oracle and the JAX TP path, equal on both ranks; every input and
    parameter gradient against ``jax.grad`` of the oracle."""
    jax_side, ranks = tp_run
    ref = jax_side["blocks"][case]
    for r in ranks:
        got = r["blocks"][(case, impl)]
        np.testing.assert_allclose(got["out"], ref["oracle"], atol=5e-5, rtol=5e-5)
        np.testing.assert_allclose(got["out"], ref["tp"], atol=5e-5, rtol=5e-5)
        for i, (g, want) in enumerate(zip(got["grads"], ref["grads"])):
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=5e-4 * max(float(np.abs(want).max()), 1.0),
                                       err_msg=f"{case} {impl} gradient {i}")
    np.testing.assert_array_equal(ranks[0]["blocks"][(case, impl)]["out"],
                                  ranks[1]["blocks"][(case, impl)]["out"])


@pytest.mark.parametrize("tower", ["image", "text"])
def test_tp_towers_match_jax(tp_run, tower):
    """The TINY towers with ``ModelOptions(attn_impl="fused", tp=2)``
    against the JAX unsharded towers (test_tp.py:73-98)."""
    jax_side, ranks = tp_run
    for r in ranks:
        np.testing.assert_allclose(r["towers"][tower], jax_side["towers"][tower], atol=5e-5,
                                   rtol=5e-4)


def test_tp_train_step_matches_jax(tp_run):
    """One deterministic TP train step at TINY against JAX's one-device
    step: the loss, every gradient before the optimizer, the parameters
    after it; both ranks' parameters bit-equal."""
    jax_side, ranks = tp_run
    ref = jax_side["train"]
    for r in ranks:
        got = r["train"]
        assert abs(got["loss"] - ref["loss"]) <= 1e-4
        assert set(got["grads"]) == set(ref["grads"])
        for name, g in got["grads"].items():
            want = ref["grads"][name]
            if name.endswith("self.key.bias"):
                assert max(float(np.abs(g).max()), float(np.abs(want).max())) <= 1e-8, name
            else:
                assert float(np.abs(g - want).max()) <= 1e-4 * float(np.abs(want).max()), name
        for name, p in got["params"].items():
            slack = np.where(np.abs(ref["grads"][name]) < 1e-6, 2 * TCFG["lr"], 0.0)
            assert (np.abs(p - ref["params"][name]) <= 5e-4 + slack).all(), name
    for name, p in ranks[0]["train"]["params"].items():
        np.testing.assert_array_equal(p, ranks[1]["train"]["params"][name], err_msg=name)


def test_tp_mismatch_fails_fast(tp_run):
    """On a group of 2 ranks: ``tp=4`` raises in the sub-block and in
    ``model_group``, and a head count that tp does not divide raises."""
    _, ranks = tp_run
    for r in ranks:
        msgs = r["fail_fast"]
        assert "tp=4 but the model group has 2 ranks" in msgs["tp_mismatch"]
        assert "tp=4 but the model group has 2 ranks" in msgs["model_group"]
        assert "heads 3 not divisible by tp 2" in msgs["heads"]


@pytest.mark.parametrize("case", ["tiny", "roberta-base"])
def test_tp_text_dropout_matches_tp1(tp_run, case):
    """A text tower with dropout 0.1 trains under tp 2 (JAX's unfused path,
    bert.py:100-105) and draws tp 1's masks: the text tower's output and one
    train step against tp 1 with the same generator seed; the ranks'
    parameters bit-equal after the step."""
    jax_side, ranks = tp_run
    ref = jax_side["dropout_tp1"][case]
    for r in ranks:
        got = r["dropout"][case]
        np.testing.assert_allclose(got["seq"], ref["seq"], atol=1e-5, rtol=0)
        assert abs(got["loss"] - ref["loss"]) <= 1e-5
        assert set(got["grads"]) == set(ref["grads"])
        for name, g in got["grads"].items():
            want = ref["grads"][name]
            if name.endswith("self.key.bias"):
                assert max(float(np.abs(g).max()), float(np.abs(want).max())) <= 1e-8, name
            else:
                assert float(np.abs(g - want).max()) <= 1e-4 * float(np.abs(want).max()), name
    for name, p in ranks[0]["dropout"][case]["params"].items():
        np.testing.assert_array_equal(p, ranks[1]["dropout"][case]["params"][name], err_msg=name)
    # dropout is on: the output is not the same tower's without it
    assert float(np.abs(ref["seq"] - ref["seq_det"]).max()) > 0.1


def test_tp_attention_masks_are_tp1s(tp_run):
    """The ranks' attention-probability masks of one draw, concatenated over
    heads, are the mask one process draws for all heads."""
    from nans_clip_tpu_torch.ops import dropout as drop

    _, ranks = tp_run
    got = np.concatenate([r["attention_masks"] for r in ranks], axis=1)
    want = drop.attention_multiplier(drop.Dropout(1234, 0.1, drop.STREAM_ATTN), 2, 4, 12, "cpu")
    np.testing.assert_array_equal(got, want.numpy())
    assert 0 < float((want == 0).float().mean()) < 0.5
