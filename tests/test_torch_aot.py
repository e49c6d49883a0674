"""The port's fixed-shape towers (``nans_clip_tpu_torch/deploy/aot.py``) and
the registered operators they export through (``ops/library.py``), on the
CPU.

- ``compile_tower`` against the JAX package's ``deploy.aot.compile_tower``
  on the same weights (``state_dict_from_jax_params``), both towers, batch 2
  and 3, at ``tiny_config()`` and at base widths cut to 2 layers: features
  within 2e-4 (the slice tolerance of ``tests/test_torch_slice.py``; both in
  fp32).
- The mirrors of ``tests/test_deploy.py``: ``compile_tower(...,
  normalize_out=False)`` and ``load_program(export_program(...))`` against
  the eager towers within 1e-6 in fp32 (on the CPU both run the same
  twins: they are equal).
- ``torch.library.opcheck`` of every ``nans_clip::`` operator (schema, fake
  implementation, dispatch).
- The card's exported graph, traced here from fake CUDA tensors: at batch 1
  one ``nans_clip::tower`` (int8 for the quantized text tower), at batch 64
  the LayerNorm / linear / attention operators of #1-#3; and no weight is
  cast, concatenated or copied in a call (the weights reach the operators
  and the few plain ops as they are, or through views). Under ``pallas``
  one ``nans_clip::flash_attention`` a layer (#22) and no other operator.
- The ``pallas`` engine on the CPU: bit-equal to the eager ``pallas``
  towers, and within 2e-4 of JAX's ``pallas`` ``compile_tower`` (its
  Pallas kernel in interpret mode); tp > 1 is still refused."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.deploy import aot as jaot
from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models.clip import init_clip
from nans_clip_tpu.tokenizer import tokenize as jtokenize
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.api import CLIPModel
from nans_clip_tpu_torch.deploy import aot
from nans_clip_tpu_torch.models.clip import CLIP, build_clip, serving_weights
from nans_clip_tpu_torch.models.common import ModelOptions, cast_module
from nans_clip_tpu_torch.ops import library
from nans_clip_tpu_torch.utils.quantize import quantize_for_serving, quantize_weight
from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params

torch.set_num_threads(2)

TEXTS = ["西湖美景", "南宋古籍善本,绍兴二十一年刊刻。", "a photo of a cat"]


def _cut(cfg, layers):
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=layers),
                               text=dataclasses.replace(cfg.text, num_hidden_layers=layers))


JCFGS = {"tiny": jconfigs.tiny_config,
         "base2": lambda: _cut(jconfigs.load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese"), 2)}


def _port_cfg(jcfg):
    v, t = jcfg.vision, jcfg.text
    return tconfigs.CLIPConfig(embed_dim=jcfg.embed_dim,
                               vision=tconfigs.VisionConfig(**dataclasses.asdict(v)),
                               text=tconfigs.TextConfig(**dataclasses.asdict(t)), name=jcfg.name)


@pytest.fixture(scope="module", params=sorted(JCFGS))
def pair(request):
    """(JAX cfg, JAX params, the port's fp32 CPU model on the same weights)."""
    jcfg = JCFGS[request.param]()
    params, _ = init_clip(jax.random.PRNGKey(0), jcfg)
    cfg = _port_cfg(jcfg)
    module = build_clip(cfg)
    module.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, CLIPModel(cfg, module)


def _inputs(cfg, tower, batch, seed=0):
    if tower == "image":
        r = cfg.vision.image_resolution
        return np.random.RandomState(seed).randn(batch, r, r, 3).astype(np.float32)
    return jtokenize((TEXTS * batch)[:batch])


@pytest.mark.parametrize("tower", ["image", "text"])
@pytest.mark.parametrize("batch", [2, 3])
def test_compile_tower_matches_jax(pair, tower, batch):
    jcfg, params, model = pair
    x = _inputs(jcfg, tower, batch)
    want = jaot.compile_tower(jcfg, params, tower, batch,
                              options=JOptions(attn_impl="xla", compute_dtype=None))(x)
    run = aot.compile_tower(model, tower, batch)
    assert run.batch_size == batch and run.graph is None
    got = run(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (batch, jcfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def _eager(model, tower, x):
    return (model.encode_image if tower == "image" else model.encode_text)(torch.from_numpy(x))


def test_aot_matches_jit(pair):
    jcfg, _, model = pair
    for tower in ("image", "text"):
        x = _inputs(jcfg, tower, 4)
        run = aot.compile_tower(model, tower, 4, normalize_out=False)
        np.testing.assert_allclose(run(torch.from_numpy(x)).numpy(),
                                   _eager(model, tower, x).float().numpy(), atol=1e-6, rtol=1e-6)


def test_stablehlo_roundtrip(pair, tmp_path):
    jcfg, _, model = pair
    for tower in ("image", "text"):
        x = _inputs(jcfg, tower, 2)
        path = aot.export_program(model, tower, 2, str(tmp_path / f"{tower}.pt2"))
        fn = aot.load_program(path)
        out = fn(aot.tower_params(model, tower), torch.from_numpy(x).to(
            torch.float32 if tower == "image" else torch.long))
        ref = _eager(model, tower, x).float()
        ref = ref / torch.linalg.vector_norm(ref, dim=-1, keepdim=True)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)
        # the exported function on the CPU is the eager one: the same bits
        assert torch.equal(out, ref)


def _op_cases():
    rs = np.random.RandomState(3)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    b, s, w, heads, inter = 2, 5, 16, 2, 32
    layer = (1 + 0.1 * f(w), 0.1 * f(w), 0.2 * f(3 * w, w), 0.1 * f(3 * w), 0.2 * f(w, w),
             0.1 * f(w), 1 + 0.1 * f(w), 0.1 * f(w), 0.2 * f(inter, w), 0.1 * f(inter),
             0.2 * f(w, inter), 0.1 * f(w))
    layers = [layer, tuple(t.flip(0) for t in layer)]
    qlayers = [tuple(quantize_weight(t) if i in library._QUANT_SLOTS else t
                     for i, t in enumerate(p)) for p in layers]
    kb = torch.zeros(b, s)
    kb[1, 3:] = -10000.0
    x = f(b, s, w)
    return [
        ("tower", (x, None, library.flatten_layers(layers), False, heads, 1e-5, "quick_gelu",
                   False)),
        ("tower_int8", (x, kb, library.flatten_layers(qlayers), True, heads, 1e-12, "gelu",
                        True)),
        ("linear", (f(b * s, w), f(inter, w), f(inter), "quick_gelu", None, None)),
        ("linear_residual", (f(b * s, inter), f(w, inter), f(w), None, f(b * s, w),
                             torch.float64)),
        ("attention", (f(b * s, 3 * w), None, b, heads)),
        ("attention_masked", (f(b * s, 3 * w), kb, b, heads)),
        ("layer_norm", (f(b * s, w), 1 + f(w), f(w), 1e-5, None)),
        # q/k/v as the views of one QKV product, as a pallas layer passes them
        ("flash_attention", _flash_args(f, b, s, heads, w // heads, None)),
        ("flash_attention_masked", _flash_args(f, b, s, heads, w // heads, kb)),
    ]


def _flash_args(f, b, s, heads, dh, kb):
    qkv = f(b, s, 3 * heads * dh)
    return (*(t.view(b, s, heads, dh).permute(0, 2, 1, 3) for t in qkv.chunk(3, dim=-1)), kb)


@pytest.mark.parametrize("name,args", _op_cases(), ids=[c[0] for c in _op_cases()])
def test_opcheck(name, args):
    op = {"tower": library.tower_op, "tower_int8": library.tower_op,
          "linear": library.linear_op, "linear_residual": library.linear_op,
          "attention": library.attention_op, "attention_masked": library.attention_op,
          "layer_norm": library.layer_norm_op, "flash_attention": library.flash_attention_op,
          "flash_attention_masked": library.flash_attention_op}[name]
    torch.library.opcheck(op, args)
    assert torch.isfinite(op(*args)).all()


def test_ops_cpu_kernels_are_the_twins():
    """On CPU tensors each operator is its wrapper's twin, bit for bit."""
    from nans_clip_tpu_torch.ops import attention, gemm, layernorm, tower_kernel

    cases = dict(_op_cases())
    x, kb, flat, quant, heads, eps, act, post = cases["tower_int8"]
    layers = library.unflatten_layers(flat, quant)
    assert torch.equal(library.tower_op(*cases["tower_int8"]),
                       tower_kernel.tower_math(x, kb, layers, heads, eps, act, post))
    assert torch.equal(library.linear_op(*cases["linear"]),
                       gemm.linear_plain(*cases["linear"]))
    assert torch.equal(library.attention_op(*cases["attention_masked"]),
                       attention.attention_plain(*cases["attention_masked"]))
    assert torch.equal(library.layer_norm_op(*cases["layer_norm"]),
                       layernorm.layer_norm(*cases["layer_norm"]))
    # the flash operator: the eager route's o, merged ([B, S, H*dh], contiguous)
    q, k, v, kb = cases["flash_attention_masked"]
    ctx = library.flash_attention_op(q, k, v, kb)
    assert ctx.is_contiguous() and ctx.shape == (q.shape[0], q.shape[2], q.shape[1] * q.shape[3])
    assert torch.equal(ctx, attention.merge_heads(attention.attention_pallas(q, k, v, kb)))


def _fake_program(cfg, tower, batch, quantize=False, attn_impl="auto"):
    """The card's program of ``tower`` at ``batch``, traced from fake CUDA
    tensors (no card needed), bf16 weights (int8 for the quantized text
    tower) from a module on the meta device."""
    options = ModelOptions(compute_dtype="bfloat16", attn_impl=attn_impl)
    with torch.device("meta"):
        module = CLIP(cfg)
    cast_module(module, options)
    if quantize:
        module = quantize_for_serving(module, ("text",))
    w = serving_weights(module, tower, options)
    with FakeTensorMode():
        params = {k: torch.empty(v.shape, dtype=v.dtype, device="cuda") for k, v in w.items()}
        x = aot.example_input(cfg, tower, batch, device="cuda")
    return aot.export_tower(cfg, options, tower, params, x)


_VIEWS = {"aten.expand.default", "aten.narrow.default", "aten.select.int",
          "aten.unsqueeze.default", "aten.view.default", "aten.reshape.default",
          "aten.slice.Tensor", "aten._assert_tensor_metadata.default"}


def _transforms(program):
    """The graph's nodes that compute something new from the weights alone:
    neither a view nor a ``to`` that keeps the dtype (which returns its
    input)."""
    out = []
    for target, node in _weight_only_nodes(program):
        keeps = target == "aten.to.dtype" and \
            node.all_input_nodes[0].meta["val"].dtype == node.meta["val"].dtype
        if target not in _VIEWS and not keeps:
            out.append(node.format_node())
    return out


def _weight_only_nodes(program):
    """The graph's nodes computed from the weights alone (no path from the
    tower's input), as (target, node)."""
    specs = program.graph_signature.input_specs
    x_name = specs[-1].arg.name
    from_x = {x_name}
    weight_only = []
    for node in program.graph.nodes:
        if node.op != "call_function":
            continue
        ins = [a for a in node.all_input_nodes]
        if any(a.name in from_x for a in ins):
            from_x.add(node.name)
        elif ins:
            weight_only.append((str(node.target), node))
    return weight_only


@pytest.mark.parametrize("struct", ["ViT-B-16@RoBERTa-wwm-ext-base-chinese", "tiny"])
@pytest.mark.parametrize("tower", ["image", "text"])
@pytest.mark.parametrize("batch", [1, 64])
def test_card_program_calls_the_operators_and_transforms_no_weight(struct, tower, batch):
    cfg = tconfigs.tiny_config() if struct == "tiny" else \
        _cut(tconfigs.load_config(struct), 2)
    layers = cfg.vision.layers if tower == "image" else cfg.text.num_hidden_layers
    program = _fake_program(cfg, tower, batch)
    ops = [str(n.target) for n in program.graph.nodes if "nans_clip" in str(n.target)]
    tower_fits = struct != "tiny"   # tiny_config's heads of 32 / 16 take no tower kernel
    if batch == 1 and tower_fits:
        assert ops == ["nans_clip.tower.default"]
    else:
        assert ops.count("nans_clip.linear.default") == 4 * layers
        assert ops.count("nans_clip.attention.default") == layers
        assert ops.count("nans_clip.layer_norm.default") == 2 * layers
    assert not _transforms(program), "a weight is transformed in every call"
    for node in program.graph.nodes:
        if str(node.target) in ("aten.cat.default", "aten.stack.default"):
            assert any(a.name == program.graph_signature.input_specs[-1].arg.name
                       or a.op != "placeholder" for a in node.all_input_nodes)
        if str(node.target) in ("aten.to.dtype", "aten._to_copy.default"):
            src = node.all_input_nodes[0]
            if src.op == "placeholder" and src.name != program.graph_signature.input_specs[
                    -1].arg.name:
                assert src.meta["val"].dtype == node.meta["val"].dtype, node.format_node()


def test_card_program_int8_text_at_batch_1():
    cfg = _cut(tconfigs.load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese"), 2)
    program = _fake_program(cfg, "text", 1, quantize=True)
    towers = [n for n in program.graph.nodes if str(n.target) == "nans_clip.tower.default"]
    assert len(towers) == 1 and towers[0].args[3] is True   # quant
    weights = towers[0].args[2]
    assert len(weights) == 2 * 16 and sum(
        w.meta["val"].dtype == torch.int8 for w in weights) == 2 * 4
    assert not _transforms(program)


@pytest.mark.parametrize("tower", ["image", "text"])
@pytest.mark.parametrize("batch", [1, 64])
def test_card_program_pallas_calls_flash_once_a_layer(tower, batch):
    """Under ``pallas`` each layer reaches #22 as ``nans_clip::flash_attention``
    (q/k/v the QKV product's views), no other operator runs, and no weight
    is transformed in a call (the layers' LayerNorms are fp32 inputs)."""
    cfg = _cut(tconfigs.load_config("ViT-B-16@RoBERTa-wwm-ext-base-chinese"), 2)
    program = _fake_program(cfg, tower, batch, attn_impl="pallas")
    ops = [str(n.target) for n in program.graph.nodes if "nans_clip" in str(n.target)]
    assert ops == ["nans_clip.flash_attention.default"] * 2
    assert not _transforms(program), "a weight is transformed in every call"
    for node in program.graph.nodes:
        if "flash_attention" in str(node.target):
            assert all(not a.meta["val"].is_contiguous() for a in node.all_input_nodes[:3])
        assert not any(c in str(node.target) for c in ("clone", "contiguous", "_to_copy"))


@pytest.fixture
def interpret(monkeypatch):
    """The JAX towers' ``attention_pallas`` in interpret mode, as
    ``tests/test_torch_flash.py`` forces it."""
    from nans_clip_tpu.ops import attention as jattn

    orig = jattn.attention_pallas

    def forced(q, k, v, key_bias=None, block_q=128, interpret=False):
        return orig(q, k, v, key_bias, block_q, interpret=True)
    monkeypatch.setattr(jattn, "attention_pallas", forced)


def test_export_refuses_pallas_and_tp(pair, tmp_path, interpret):
    """tp > 1 is refused. A ``pallas`` engine (export, save with its header,
    load with the weights bound) equals the eager ``pallas`` tower bit for
    bit on the CPU, and JAX's ``pallas`` engine within 2e-4 (fp32)."""
    from nans_clip_tpu_torch.deploy.engine import load_engine, save_engine

    jcfg, params, base = pair
    cfg = tconfigs.tiny_config()
    with pytest.raises(ValueError, match="not exported"):
        aot.export_tower(cfg, ModelOptions(tp=2), "text", {}, aot.example_input(cfg, "text", 1))
    model = CLIPModel(base.cfg, base.module, ModelOptions(attn_impl="pallas"))
    for tower in ("image", "text"):
        x = torch.from_numpy(_inputs(jcfg, tower, 2))
        w = aot.tower_params(model, tower)
        path = save_engine(str(tmp_path / f"{tower}_bs2.engine"),
                           aot.export_tower(model.cfg, model.options, tower, w,
                                            aot.example_input(model.cfg, tower, 2)), 2,
                           meta={"attn_impl": "pallas"})
        got = load_engine(path, w)(x)
        assert torch.equal(got, aot.normalized(_eager(model, tower, x.numpy())))
        want = jaot.compile_tower(jcfg, params, tower, 2,
                                  options=JOptions(attn_impl="pallas", compute_dtype=None))(
            x.numpy())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_tower_params_pack_and_flatten_without_touching_the_model(pair):
    """q|k|v packed, the patch projection flattened, LayerNorms of the plain
    ``layer_norm`` in fp32; the model's own tensors unchanged."""
    jcfg, _, model = pair
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    img, txt = aot.tower_params(model, "image"), aot.tower_params(model, "text")
    sa = model.module.bert.encoder.layer[0].attention.self
    assert torch.equal(txt["layers.0.qkv.weight"],
                       torch.cat([sa.query.weight, sa.key.weight, sa.value.weight]))
    p = jcfg.vision.patch_size
    assert img["conv1"].shape == (p * p * 3, jcfg.vision.width)
    assert all(v.dtype == torch.float32 for k, v in img.items() if k.startswith("ln_"))
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, before[k]), k
