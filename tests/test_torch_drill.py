"""The port's composed drill (``nans_clip_tpu_torch/drill.py``) at the CPU
scale: dataset build -> finetune from a saved init ``.pt`` -> 3-stage eval
of init and trained (mean recall must improve both ways) -> engine build
-> daemon on the engines (served features within 1e-5 of offline, fp32).
Its dataset is the JAX drill's, byte for byte, at the same seed."""

import json
import os

import torch

from nans_clip_tpu.drill import make_dataset as jmake_dataset
from nans_clip_tpu_torch.drill import main as drill_main
from nans_clip_tpu_torch.drill import make_dataset

torch.set_num_threads(2)

STAGES = {"build_dataset", "init_checkpoint", "train", "eval_init", "eval_trained",
          "build_engines", "serve"}


def test_drill_dataset_equals_jax(tmp_path):
    counts = make_dataset(str(tmp_path / "port"), 32, 8, 2, seed=123)
    assert counts == jmake_dataset(str(tmp_path / "jax"), 32, 8, 2, seed=123)
    files = []
    for root, _, names in os.walk(tmp_path / "jax"):
        files += [os.path.relpath(os.path.join(root, n), tmp_path / "jax") for n in names]
    assert {"train/imgs.npack", "train/pairs.npack", "valid/imgs.npack", "valid/pairs.npack",
            "valid_texts.tr.jsonl"} <= set(files)
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_drill_tiny_cpu(tmp_path):
    """60 steps at batch 16 on the 64-pair split (15 epochs): the drill's
    own asserts (recall up both ways, served == offline within 1e-5)."""
    record = drill_main(["--scale", "tiny", "--platform", "cpu", "--steps", "60",
                         "--workdir", str(tmp_path / "drill"),
                         "--out", str(tmp_path / "DRILL.json")])
    assert record["ok"] and record["improved"]
    for d in ("t2i", "i2t"):
        assert record["mean_recall_trained"][d] > record["mean_recall_init"][d]
    stages = record["stages"]
    assert set(stages) == STAGES
    assert stages["train"]["steps_run"] == record["steps"] == 60
    assert os.path.exists(stages["train"]["checkpoint"])
    assert stages["build_engines"]["engines"] == ["image_bs8.engine", "text_bs8.engine"]
    assert stages["serve"]["served_vs_offline_image_max_diff"] <= 1e-5
    assert stages["serve"]["served_vs_offline_text_max_diff"] <= 1e-5
    with open(tmp_path / "DRILL.json") as f:
        assert json.load(f)["ok"]
