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


def test_import_leaves_jax_out():
    code = ("import sys, nans_clip_tpu_torch, nans_clip_tpu_torch.ops.layer_kernel; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'nans_clip_tpu.'))"
            " or m == 'nans_clip_tpu'); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
