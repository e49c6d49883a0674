"""The port's CoreML export (``nans_clip_tpu_torch/deploy/coreml.py``) on the
CPU, after ``tests/test_coreml.py``: stage 1 writes each tower's
self-contained ``torch.export`` archive and its manifest; the manifest is
the JAX package's but for ``format``; the graph holds only ``aten``
operators (never a ``nans_clip::`` kernel operator); its features are held
against JAX's StableHLO module of the same weights within 2e-4 (both fp32,
the slice tolerance of ``tests/test_torch_slice.py``); stage 2 calls
``coremltools.convert`` as the reference does where a converter imports (a
stand-in module records the call here) and prints its skip line where none
does."""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu.deploy import coreml as jcoreml
from nans_clip_tpu.models.clip import init_clip
from nans_clip_tpu_torch.deploy import coreml
from tests.test_torch_aot import JCFGS, _inputs, _port_cfg

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, JAX params, the port's cfg, the port's fp32 CPU module on
    the same weights)."""
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params

    jcfg = JCFGS["tiny"]()
    params, _ = init_clip(jax.random.PRNGKey(0), jcfg)
    cfg = _port_cfg(jcfg)
    module = build_clip(cfg)
    module.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, cfg, module


@pytest.fixture
def no_converter(monkeypatch):
    monkeypatch.setitem(sys.modules, "coremltools", None)   # import raises ImportError


def _load(path):
    with open(path, "rb") as f:
        return torch.export.load(f)


def test_stage1_artifacts_and_selfcontained_program(tiny, tmp_path, no_converter, capsys):
    jcfg, params, cfg, module = tiny
    out = coreml.export_coreml(cfg, module, str(tmp_path / "clip_cn"), precision="fp16")
    assert set(out) == {"image", "text"}
    assert all(out[t]["mlpackage"] is None for t in out)
    said = capsys.readouterr().out
    assert said.count("coremltools not installed") == 2 and "--convert-only" in said
    for tower in ("image", "text"):
        program = _load(out[tower]["program"])
        kinds = {s.kind.name for s in program.graph_signature.input_specs}
        assert kinds == {"CONSTANT_TENSOR", "USER_INPUT"}, kinds   # the weights baked in
        targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
        assert not any("nans_clip" in t for t in targets), targets
        assert all(t.startswith("aten.") or t == "<built-in function getitem>"
                   for t in targets), targets


@pytest.mark.parametrize("tower", ["image", "text"])
def test_features_match_jax_stablehlo(tiny, tmp_path, no_converter, tower):
    """The archive's program against JAX's stage-1 module of the same
    weights, on the reference layouts (NCHW fp32, int32 ids), 2e-4."""
    from jax import export as jexport

    jcfg, params, cfg, module = tiny
    path = coreml.export_tower_program(cfg, module, tower, str(tmp_path / f"{tower}.pt2"))
    jpath = jcoreml.export_tower_stablehlo(jcfg, params, tower, str(tmp_path / f"{tower}.hlo"))
    x = _inputs(jcfg, tower, 1, seed=5)
    x = np.ascontiguousarray(x.transpose(0, 3, 1, 2)) if tower == "image" else x.astype(np.int32)
    with open(jpath, "rb") as f:
        want = np.asarray(jexport.deserialize(f.read()).call(jnp.asarray(x)))
    got = _load(path).module()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("tower,precision,context", [("image", "fp32", 52), ("text", "fp16", 24)])
def test_manifest_equals_jax_but_format(tiny, tmp_path, tower, precision, context):
    jcfg, _, cfg, _ = tiny
    got = json.load(open(coreml.write_manifest(cfg, tower, str(tmp_path / "m.json"), precision,
                                               context)))
    want = json.load(open(jcoreml.write_manifest(jcfg, tower, str(tmp_path / "j.json"),
                                                 precision, context)))
    assert got.pop("format") == "torch.export" and want.pop("format") == "stablehlo"
    assert got == want


def test_stage2_calls_the_converter(tiny, tmp_path, monkeypatch):
    """With a ``coremltools`` that imports (a stand-in that records its
    call), stage 2 converts the ``ExportedProgram`` as the reference
    converts its trace and saves the ``.mlpackage``; ``--convert-only``
    runs it from a stage-1 archive alone."""
    _, _, cfg, module = tiny
    calls = []

    class _Model:
        def save(self, path):
            calls.append(("save", path))

    ct = types.ModuleType("coremltools")
    ct.precision = types.SimpleNamespace(FLOAT16="fp16-precision", FLOAT32="fp32-precision")
    ct.target = types.SimpleNamespace(iOS15="iOS15-target")

    def convert(program, **kw):
        calls.append(("convert", type(program).__name__, kw))
        return _Model()
    ct.convert = convert
    monkeypatch.setitem(sys.modules, "coremltools", ct)
    prefix = str(tmp_path / "clip_cn")
    out = coreml.export_coreml(cfg, module, prefix, convert_vision=False, precision="fp16")
    assert out["text"]["mlpackage"] == prefix + ".text.mlpackage"
    assert calls == [("convert", "ExportedProgram",
                      {"convert_to": "mlprogram", "compute_precision": "fp16-precision",
                       "minimum_deployment_target": "iOS15-target"}),
                     ("save", prefix + ".text.mlpackage")]
    calls.clear()
    coreml.main(["--convert-only", out["text"]["program"]])
    assert [c[0] for c in calls] == ["convert", "save"]


def test_cli_writes_both_towers_without_the_converter(tmp_path, no_converter, monkeypatch):
    """``python -m nans_clip_tpu_torch.deploy.coreml`` with JAX's flags: a
    bare arch name resolved through MODEL_INFO, random weights, on the CPU
    (a tiny config stands in for the published one); ``--convert-only``
    without a converter exits non-zero."""
    from nans_clip_tpu_torch import api, configs as tconfigs

    seen = {}

    def small(name, checkpoint_path=None, device="cuda", **kw):
        seen.update(name=name, device=device)
        return api.model_from_config(tconfigs.tiny_config(), checkpoint_path, device=device)
    monkeypatch.setattr(api, "create_model", small)
    prefix = str(tmp_path / "cli")
    coreml.main(["--model-arch", "ViT-B-16", "--save-coreml-path", prefix, "--convert-text",
                 "--convert-vision", "--precision", "fp32"])
    assert seen == {"name": "ViT-B-16@RoBERTa-wwm-ext-base-chinese", "device": "cpu"}
    for tower in ("image", "text"):
        assert json.load(open(f"{prefix}.{tower}.manifest.json"))["coreml"][
            "compute_precision"] == "fp32"
        _load(f"{prefix}.{tower}.pt2")
    with pytest.raises(SystemExit):
        coreml.main(["--convert-only", f"{prefix}.text.pt2"])
