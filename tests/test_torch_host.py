"""Host-side modules of the port: tokenizer, configs, image transform,
checkpoint normalisation, and the import boundary (no jax)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.tokenizer import tokenize as jtokenize
from nans_clip_tpu.utils.transform import image_transform as jimage_transform
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.tokenizer import tokenize
from nans_clip_tpu_torch.utils.torch_interop import normalize_state_dict
from nans_clip_tpu_torch.utils.transform import image_transform

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "tests" / "golden_tokenizer.json").read_text(encoding="utf-8"))
VISION = ["ViT-B-16", "ViT-B-32", "ViT-L-14", "ViT-L-14-336", "ViT-H-14", "RN50"]
TEXT = ["RoBERTa-wwm-ext-base-chinese", "RoBERTa-wwm-ext-large-chinese", "RBT3-chinese"]


def test_tokenize_matches_golden_and_jax():
    texts = [g["text"] for g in GOLDEN]
    ids = tokenize(texts)
    assert ids.shape == (len(texts), 52) and ids.dtype == np.int32
    for row, g in zip(ids, GOLDEN):
        want = [101] + g["ids"][:50] + [102]
        assert row[:len(want)].tolist() == want
        assert not row[len(want):].any()
    np.testing.assert_array_equal(ids, jtokenize(texts))
    np.testing.assert_array_equal(tokenize(texts, 12), jtokenize(texts, 12))


def test_nine_model_configs_exist():
    names = sorted(p.stem for p in tconfigs.CONFIG_DIR.glob("*.json"))
    assert names == sorted(VISION + TEXT)


@pytest.mark.parametrize("struct", [f"{v}@RoBERTa-wwm-ext-base-chinese" for v in VISION]
                         + [f"ViT-B-16@{t}" for t in TEXT])
def test_configs_equal_jax(struct):
    assert dataclasses.asdict(tconfigs.load_config(struct)) == \
        dataclasses.asdict(jconfigs.load_config(struct))


def test_registry_and_helpers_equal_jax():
    assert tconfigs.MODEL_INFO == jconfigs.MODEL_INFO
    assert tconfigs.available_models() == jconfigs.available_models()
    for name in tconfigs.MODEL_INFO:
        tcfg, tres = tconfigs.config_for_name(name)
        jcfg, jres = jconfigs.config_for_name(name)
        assert tres == jres and dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tconfigs.MODEL_CKPT_FILES[name] == jconfigs.MODEL_CKPT_FILES[name][1]
    assert dataclasses.asdict(tconfigs.tiny_config()) == dataclasses.asdict(jconfigs.tiny_config())
    t336 = tconfigs.with_resolution(tconfigs.load_config("ViT-B-16@RBT3-chinese"), 336)
    j336 = jconfigs.with_resolution(jconfigs.load_config("ViT-B-16@RBT3-chinese"), 336)
    assert dataclasses.asdict(t336) == dataclasses.asdict(j336)


def test_image_transform_matches_jax():
    from PIL import Image

    rs = np.random.RandomState(0)
    img = Image.fromarray(rs.randint(0, 256, (40, 57, 3), dtype=np.uint8))
    np.testing.assert_array_equal(image_transform(32)(img), jimage_transform(32)(img))


def test_normalize_state_dict_splits_flash_layout():
    rs = np.random.RandomState(0)
    wqkv, bqkv = rs.randn(12, 4).astype(np.float32), rs.randn(12).astype(np.float32)
    sd = {
        "module.visual.transformer.resblocks.0.attn.Wqkv.weight": torch.from_numpy(wqkv),
        "module.visual.transformer.resblocks.0.attn.Wqkv.bias": torch.from_numpy(bqkv),
        "module.bert.encoder.layer.0.attention.self.Wqkv.weight": torch.from_numpy(wqkv).half(),
        "module.bert.encoder.layer.0.attention.self.Wqkv.bias": torch.from_numpy(bqkv),
        "module.bert.encoder.layer.0.attention.self.out_proj.weight": torch.eye(4),
        "module.bert.encoder.layer.0.attention.self.out_proj.bias": torch.zeros(4),
        "module.bert.pooler.dense.weight": torch.eye(4),
    }
    out = normalize_state_dict(sd)
    vis = "visual.transformer.resblocks.0.attn"
    assert torch.equal(out[f"{vis}.in_proj_weight"], torch.from_numpy(wqkv))
    assert torch.equal(out[f"{vis}.in_proj_bias"], torch.from_numpy(bqkv))
    att = "bert.encoder.layer.0.attention"
    assert out[f"{att}.self.key.weight"].dtype == torch.float32
    assert torch.equal(out[f"{att}.self.key.bias"], torch.from_numpy(bqkv[4:8]))
    assert torch.equal(out[f"{att}.output.dense.weight"], torch.eye(4))
    assert not any("pooler" in k or "Wqkv" in k or k.startswith("module.") for k in out)


def test_preprocess_text_matches_jax():
    from nans_clip_tpu.data.dataset import preprocess_text as jpreprocess
    from nans_clip_tpu_torch.data.dataset import preprocess_text

    for t in ["“西湖”美景", "ABC “引号” Def", "", "皮卡丘"]:
        assert preprocess_text(t) == jpreprocess(t)


def test_load_eval_model(tmp_path):
    from nans_clip_tpu_torch.eval.model_io import load_eval_model

    m = load_eval_model("ViT-B-16", "RoBERTa-wwm-ext-base-chinese", None, "fp32",
                        cfg=tconfigs.tiny_config(), device="cpu")
    assert m.cfg.name == "tiny" and m.device.type == "cpu" and m.options.compute_dtype is None
    ckpt = tmp_path / "tiny.pt"
    torch.save({"state_dict": m.module.state_dict()}, ckpt)
    back = load_eval_model("", "", str(ckpt), "bf16", cfg=tconfigs.tiny_config(), device="cpu")
    assert back.options.compute_dtype == "bfloat16"
    assert torch.equal(back.module.visual.proj, m.module.visual.proj.bfloat16())
    # a directory: the trainer's checkpoint directories load (tests/test_torch_cli.py);
    # any other directory raises and says what it is
    with pytest.raises(ValueError, match="not a checkpoint"):
        load_eval_model("", "", str(tmp_path), cfg=tconfigs.tiny_config(), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_eval_model("", "", str(tmp_path / "missing.pt"), cfg=tconfigs.tiny_config(),
                        device="cpu")


def test_import_leaves_jax_out():
    """Every module of the package (walked, so that a new one cannot slip
    past: ``parallel/*``, ``drill.py``, ``flywheel/*``, the HF interop, the
    profiling, the native tokenizer, the CoreML export, the demo and the
    example among them) and the TP, DP and PP workers import neither jax nor
    the JAX package."""
    code = ("import importlib, pkgutil, sys, nans_clip_tpu_torch, tests.test_torch_tp_worker, "
            "tests.test_torch_dp_worker, tests.test_torch_pp_worker; "
            "names = [m.name for m in pkgutil.walk_packages(nans_clip_tpu_torch.__path__, "
            "'nans_clip_tpu_torch.')]; [importlib.import_module(n) for n in names]; "
            "assert len(names) > 50 and 'nans_clip_tpu_torch.training.main' in names, names; "
            "assert {'nans_clip_tpu_torch.parallel.distributed', "
            "'nans_clip_tpu_torch.parallel.fsdp', "
            "'nans_clip_tpu_torch.parallel.pp', 'nans_clip_tpu_torch.drill', "
            "'nans_clip_tpu_torch.utils.hf_interop', 'nans_clip_tpu_torch.utils.profiling', "
            "'nans_clip_tpu_torch.flywheel.filter_annotations', "
            "'nans_clip_tpu_torch.data.fast_tokenizer', "
            "'nans_clip_tpu_torch.data.bench_loader', 'nans_clip_tpu_torch.deploy.coreml', "
            "'nans_clip_tpu_torch.demo', "
            "'nans_clip_tpu_torch.examples.similarity_demo'} <= set(names), names; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'nans_clip_tpu.'))"
            " or m == 'nans_clip_tpu'); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_step_timer_equals_jax(monkeypatch):
    """``utils/profiling.StepTimer`` against the JAX one on the same
    patched clock: windows, means and rates equal."""
    import itertools

    from nans_clip_tpu.utils import profiling as jprof
    from nans_clip_tpu_torch.utils import profiling as prof

    for mod in (jprof, prof):
        ticks = itertools.accumulate([0.0, 0.5, 0.25, 1.0, 0.125, 2.0, 0.375, 0.75])
        monkeypatch.setattr(mod.time, "perf_counter", ticks.__next__)
        t = mod.StepTimer(window=2)
        for n in (8, 8, 16):
            t.data_ready()
            t.step_done(n)
        got = (list(t.step_times), list(t.data_times), t.step_time, t.data_time,
               t.samples_per_sec(16), mod.StepTimer().samples_per_sec(4))
        if mod is jprof:
            want = got
    assert got == want
    assert got[:2] == ([0.125, 0.375], [1.0, 2.0]) and got[4] == 64.0 and got[5] == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    from nans_clip_tpu_torch.utils.profiling import TRACE_FILE, trace

    with trace(str(tmp_path / "prof")) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8)).sum()
    events = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(k.key == "aten::mm" for k in prof.key_averages())


def test_bench_loader_prints_and_returns_rates(capsys):
    from nans_clip_tpu_torch.data.bench_loader import main

    rates = main(["--images", "16", "--size", "32", "--batch-size", "8", "--threads", "2"])
    out = capsys.readouterr().out
    for line in ("host CPUs:", "decode+resize: pool", "tokenize: native", "loader end-to-end:"):
        assert line in out, out
    assert all(rates[k] > 0 for k in ("decode_pool_img_s", "decode_pil_img_s",
                                      "tokenize_native_texts_s", "tokenize_python_texts_s",
                                      "loader_pairs_s"))
