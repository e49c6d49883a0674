"""The port's user drives on the CPU: ``nans_clip_tpu_torch/demo.py`` after
``tests/test_demo.py`` (its ``_fake_load`` pattern: both demos on the same
tiny weights, the port's through ``utils/torch_interop.py``) and
``nans_clip_tpu_torch/examples/similarity_demo.py`` against the
repository's ``examples/similarity_demo.py``.

Both demos run in fp32 here (``demo.PRECISION`` and JAX's options patched),
and the JAX gallery decodes with PIL (its native library patched away), as
the port's does: the top-k ids must be equal and the scores within 2e-4
(the slice tolerance of ``tests/test_torch_slice.py``). The example's
printed probabilities are held to JAX's within 2e-4 as well."""

import base64
import io
import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

import demo as jdemo
from nans_clip_tpu.configs import tiny_config as jtiny
from nans_clip_tpu.data import npack as jnpack
from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models.clip import init_clip
from nans_clip_tpu.preprocess.build_dataset import build_split
from nans_clip_tpu_torch import demo as tdemo
from tests.test_torch_aot import _port_cfg

torch.set_num_threads(2)

QUERY = "示例文本第3条"


@pytest.fixture(scope="module")
def gallery_dir(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("demo_data")
    rs = np.random.RandomState(0)
    with open(root / "valid_imgs.tsv", "w") as f:
        for i in range(6):
            arr = rs.randint(0, 255, (48, 48, 3), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            f.write(f"{i}\t{base64.urlsafe_b64encode(buf.getvalue()).decode()}\n")
    with open(root / "valid_texts.jsonl", "w") as f:
        for t in range(6):
            f.write(json.dumps({"text_id": t, "text": f"示例文本第{t}条",
                                "image_ids": [t]}, ensure_ascii=False) + "\n")
    build_split(str(root), "valid")
    return str(root / "valid")


@pytest.fixture(scope="module")
def weights():
    jcfg = jtiny()
    params, batch_stats = init_clip(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, batch_stats


def _fake_load(monkeypatch, weights):
    """Both demos' ``load_eval_model`` on the same tiny fp32 weights; the
    JAX gallery decoded with PIL."""
    from nans_clip_tpu_torch.api import CLIPModel
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params

    jcfg, params, batch_stats = weights
    seen = {}

    def jfake(vision, text, resume, precision="bf16", attn_impl="auto", cfg_override=None):
        return jcfg, params, batch_stats, JOptions(attn_impl="xla", compute_dtype=None)

    def tfake(vision, text, resume, precision="bf16", attn_impl="auto", cfg=None, device="cuda"):
        seen.update(precision=precision, device=str(device))
        tcfg = _port_cfg(jcfg)
        module = build_clip(tcfg)
        module.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                                          tcfg))
        return CLIPModel(tcfg, module.to(device))

    monkeypatch.setattr(jdemo, "load_eval_model", jfake)
    monkeypatch.setattr(tdemo, "load_eval_model", tfake)
    monkeypatch.setattr(tdemo, "PRECISION", "fp32")
    monkeypatch.setattr(jnpack, "get_native_lib", lambda: None)
    return seen


def _args(gallery_dir, extra):
    return ["--data", gallery_dir, "--resume", "unused", "--topk", "4", "--batch-size", "4",
            *extra]


def _run_cli(capsys, gallery_dir, extra):
    tdemo.main(_args(gallery_dir, ["--cli", QUERY, "--platform", "cpu"] + extra))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("image_id=")]
    assert len(lines) == 4
    return [(int(ln.split()[0].split("=")[1]), float(ln.split("score=")[1])) for ln in lines]


def _lora_npz(path, weights):
    """A rank-4 adapter file with non-zero B, written by the port's
    ``save_lora`` in the JAX package's ``.npz`` layout."""
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.models.lora import init_lora, save_lora

    module = build_clip(_port_cfg(weights[0]))
    g = torch.Generator().manual_seed(5)
    adapters = init_lora(g, module, rank=4)
    with torch.no_grad():
        for tower in adapters.values():
            for leaves in tower.values():
                leaves["b"].copy_(0.05 * torch.randn(leaves["b"].shape, generator=g))
    save_lora(str(path), adapters, {"rank": 4, "alpha": 16.0})
    return str(path)


@pytest.mark.parametrize("mode", ["plain", "int8", "int8-text", "lora"])
def test_demo_cli_query_matches_jax(gallery_dir, capsys, monkeypatch, weights, tmp_path, mode):
    """The ``--cli`` query's top-k against JAX's ``RetrievalEngine`` on the
    same weights: ids equal, scores within 2e-4 (int8 towers quantized from
    the same fp32 weights on both sides; LoRA merged into fp32 before)."""
    seen = _fake_load(monkeypatch, weights)
    extra = {"plain": [], "int8": ["--quantize", "int8"],
             "int8-text": ["--quantize", "int8-text"],
             "lora": ["--lora", _lora_npz(tmp_path / "a.npz", weights)]}[mode]
    got = _run_cli(capsys, gallery_dir, extra)
    assert seen == {"precision": "fp32", "device": "cpu"}
    assert [s for _, s in got] == sorted((s for _, s in got), reverse=True)
    assert len({i for i, _ in got}) == 4
    want = jdemo.RetrievalEngine(jdemo.parse_args(_args(gallery_dir, extra))).search_by_text(
        QUERY, 4)
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=2e-4)


def test_demo_rank_texts_matches_jax(gallery_dir, monkeypatch, weights):
    _fake_load(monkeypatch, weights)
    args = _args(gallery_dir, [])
    got = tdemo.RetrievalEngine(tdemo.parse_args(args + ["--platform", "cpu"]))
    want = jdemo.RetrievalEngine(jdemo.parse_args(args))
    g, w = got.rank_texts_for_image(2, 3), want.rank_texts_for_image(2, 3)
    assert [t for t, _ in g] == [t for t, _ in w]
    np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=2e-4)
    np.testing.assert_allclose(got.gallery, want.gallery, atol=2e-4)


def test_demo_gradio_branch(gallery_dir, monkeypatch, weights):
    """The Gradio branch against a stub: the Interface's wiring and the
    text_search callback end to end (launch() drives one query)."""
    _fake_load(monkeypatch, weights)
    ran = {}

    gr = types.ModuleType("gradio")

    class _Component:
        def __init__(self, label=None):
            self.label = label

    class _Interface:
        def __init__(self, fn=None, inputs=None, outputs=None, title=None):
            assert callable(fn) and inputs is not None and outputs is not None
            ran["title"] = title
            self._fn = fn

        def launch(self, server_port=None):
            ran["port"] = server_port
            ran["results"] = self._fn("示例文本第2条")

    gr.Interface, gr.Textbox, gr.Gallery = _Interface, _Component, _Component
    monkeypatch.setitem(sys.modules, "gradio", gr)
    tdemo.main(["--data", gallery_dir, "--resume", "unused", "--topk", "3", "--batch-size", "4",
                "--port", "7777", "--platform", "cpu"])
    assert ran["port"] == 7777 and ran["title"]
    assert len(ran["results"]) == 3
    from PIL import Image
    for img, label in ran["results"]:
        assert isinstance(img, Image.Image) and "(" in label


def test_demo_and_example_default_to_the_card(gallery_dir, tmp_path):
    """Without ``--platform cpu`` both run on the card, so without one they
    raise before loading anything."""
    from nans_clip_tpu_torch.examples import similarity_demo

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--platform cpu"):
        tdemo.main(_args(gallery_dir, ["--cli", QUERY]))
    with pytest.raises(RuntimeError, match="--platform cpu"):
        similarity_demo.main(["--image", "x.jpg", "--ckpt", "x.pt"])


@pytest.mark.parametrize("quantize", [None, "int8-text"])
def test_similarity_example_matches_jax(tmp_path, capsys, monkeypatch, weights, quantize):
    """The example's printed probabilities against the repository's JAX
    example, ``load_from_name`` patched to the same tiny weights in both."""
    import importlib.util
    from pathlib import Path

    import nans_clip_tpu as jnc
    import nans_clip_tpu_torch as nct
    from nans_clip_tpu.api import CLIPModel as JModel
    from nans_clip_tpu.utils.transform import image_transform as jtransform
    from nans_clip_tpu_torch.api import CLIPModel
    from nans_clip_tpu_torch.examples import similarity_demo
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params
    from nans_clip_tpu_torch.utils.transform import image_transform
    from PIL import Image

    spec = importlib.util.spec_from_file_location(
        "jax_similarity_demo", Path(jdemo.__file__).parent / "examples" / "similarity_demo.py")
    jexample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexample)
    jcfg, params, batch_stats = weights
    r = jcfg.vision.image_resolution
    seen = {}

    def jload(name, vision_model_name=None, text_model_name=None, input_resolution=None,
              **kw):
        return JModel(jcfg, params, batch_stats, JOptions(attn_impl="xla")), jtransform(r)

    def tload(name, vision_model_name=None, text_model_name=None, input_resolution=None,
              options=None, device="cuda"):
        seen.update(dtype=options.compute_dtype, device=str(device))
        cfg = _port_cfg(jcfg)
        module = build_clip(cfg)
        module.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                                          cfg))
        return CLIPModel(cfg, module, options), image_transform(r)

    monkeypatch.setattr(jnc, "load_from_name", jload)
    monkeypatch.setattr(nct, "load_from_name", tload)
    img = tmp_path / "x.jpg"
    Image.fromarray(np.random.RandomState(9).randint(0, 255, (60, 80, 3), np.uint8)).save(img)
    argv = ["--image", str(img), "--ckpt", "unused.pt", "--texts", "猫", "狗", "皮卡丘"] \
        + (["--quantize", quantize] if quantize else [])

    def probs(out):
        return {ln.split(":")[0].strip(): float(ln.split(":")[1]) for ln in out.splitlines()
                if ":" in ln}

    similarity_demo.main(argv + ["--platform", "cpu"])
    got = probs(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["similarity_demo.py"] + argv)
    jexample.main()
    want = probs(capsys.readouterr().out)
    assert seen == {"dtype": None, "device": "cpu"}
    assert list(got) == ["猫", "狗", "皮卡丘"] and list(want) == list(got)
    np.testing.assert_allclose(list(got.values()), list(want.values()), atol=2e-4)
    assert abs(sum(got.values()) - 1.0) < 1e-5
