"""The port's preprocess CLIs (nans_clip_tpu_torch/preprocess/build_dataset.py,
dataset_transform.py, transform_openai_weights.py) against the JAX
package's, byte for byte, and the golden harness (eval/golden.py) end to end
on the CPU at tiny_config, as the JAX machinery tests run theirs
(tests/test_golden_live.py): random weights flow through every gate and
fail it."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nans_clip_tpu.preprocess import build_dataset as jbuild
from nans_clip_tpu.preprocess import dataset_transform as jtransform
from nans_clip_tpu_torch.eval import golden
from nans_clip_tpu_torch.preprocess import build_dataset, dataset_transform
from nans_clip_tpu_torch.preprocess import transform_openai_weights

from test_torch_eval import write_raw_split

torch.set_num_threads(2)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A raw split with a string image id (hashed to a stable npack key) and
    blank lines between the texts."""
    root = tmp_path_factory.mktemp("raw")
    write_raw_split(str(root), modes={2: "CMYK", 3: "L"})
    tsv = (root / "valid_imgs.tsv").read_text().splitlines()
    tsv[0] = "cover_page" + tsv[0][1:]
    (root / "valid_imgs.tsv").write_text("\n".join(tsv) + "\n")
    rows = [json.loads(x) for x in (root / "valid_texts.jsonl").read_text(
        encoding="utf-8").splitlines()]
    rows[0]["image_ids"] = ["cover_page"]
    with open(root / "valid_texts.jsonl", "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n\n")
    return str(root)


@pytest.mark.parametrize("fmt", ["npack", "lmdb"])
def test_build_split_byte_equal_to_jax(raw, tmp_path, fmt):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    if fmt == "npack":
        meta = build_dataset.build_split(raw, "valid", mine)
        jmeta = jbuild.build_split(raw, "valid", theirs)
    else:
        meta = build_dataset.build_split_lmdb(raw, "valid", mine)
        jmeta = jbuild.build_split_lmdb(raw, "valid", theirs)
    assert {k: v for k, v in meta.items() if k != "out_dir"} == \
        {k: v for k, v in jmeta.items() if k != "out_dir"}
    assert meta["num_samples"] == 21 and meta["num_images"] == 14
    got, want = _tree_bytes(mine), _tree_bytes(theirs)
    assert sorted(got) == sorted(want) and got == want


def test_build_cli_and_lmdb_split_loads(raw, tmp_path):
    """The CLI (both formats); the LMDB split reads back through the port's
    PairDataset (converted to npack on first use) as the npack split."""
    from nans_clip_tpu_torch.data.dataset import PairDataset

    build_dataset.main(["--data-dir", raw, "--splits", "valid", "--out-dir",
                        str(tmp_path / "npack")])
    build_dataset.main(["--data-dir", raw, "--splits", "valid", "--out-dir",
                        str(tmp_path / "lmdb"), "--format", "lmdb"])
    a, b = PairDataset(str(tmp_path / "npack" / "valid")), PairDataset(str(tmp_path / "lmdb" /
                                                                          "valid"))
    assert len(a) == len(b) == 21
    assert [a.get_pair(i) for i in range(21)] == [b.get_pair(i) for i in range(21)]


def test_dataset_transform_matches_jax(tmp_path):
    from PIL import Image

    images = tmp_path / "ImageData"
    images.mkdir()
    rs = np.random.RandomState(4)
    names = [f"{i}.jpg" for i in range(7)] + ["cover.jpg", "missing.jpg"]
    for name in names[:-1]:
        Image.fromarray(rs.randint(0, 256, (20, 20, 3), dtype=np.uint8)).save(images / name)
    with open(tmp_path / "data.csv", "w", encoding="utf-8", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image_id", "caption"])
        w.writeheader()
        for i, name in enumerate(names):
            w.writerow({"image_id": name, "caption": f"第{i}幅，“宋刻本”"})
    args = ["--csv", str(tmp_path / "data.csv"), "--images-dir", str(images), "--test-size",
            "0.3", "--seed", "7"]
    dataset_transform.main(args + ["--out-dir", str(tmp_path / "port")])
    jtransform.main(args + ["--out-dir", str(tmp_path / "jax")])
    got, want = _tree_bytes(str(tmp_path / "port")), _tree_bytes(str(tmp_path / "jax"))
    assert sorted(got) == ["train_imgs.tsv", "train_texts.jsonl", "valid_imgs.tsv",
                           "valid_texts.jsonl"] and got == want
    assert sum(len(v.splitlines()) for k, v in got.items() if k.endswith(".tsv")) == 8


def test_transform_openai_weights(tmp_path):
    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(3, 2)
            self.register_buffer("scale", torch.tensor([2.0]))

        def forward(self, x):
            return self.proj(x) * self.scale

    module = Tiny()
    raw = str(tmp_path / "ViT-X.pt")
    torch.jit.save(torch.jit.script(module), raw)
    transform_openai_weights.main(["--raw-ckpt-path", raw])
    sd = torch.load(str(tmp_path / "ViT-X.state_dict.pt"))
    assert sorted(sd) == ["proj.bias", "proj.weight", "scale"]
    for k, v in module.state_dict().items():
        assert torch.equal(sd[k], v)
    transform_openai_weights.main(["--raw-ckpt-path", raw, "--new-ckpt-path",
                                   str(tmp_path / "out.pt")])
    assert sorted(torch.load(str(tmp_path / "out.pt"))) == sorted(sd)
    with pytest.raises(FileNotFoundError):
        transform_openai_weights.main(["--raw-ckpt-path", str(tmp_path / "none.pt")])


# -- the golden harness at tiny_config -------------------------------------------

TINY = {"tiny": True, "platform": "cpu"}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A reference-layout .pt of tiny_config, seeded weights (the gates'
    machinery needs no JAX weights)."""
    from nans_clip_tpu_torch import configs
    from nans_clip_tpu_torch.models.clip import build_clip

    path = str(tmp_path_factory.mktemp("golden") / "tiny.pt")
    module = build_clip(configs.tiny_config(), "cpu", torch.Generator().manual_seed(0))
    torch.save({"state_dict": module.state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def pokemon(tmp_path_factory):
    from PIL import Image

    path = tmp_path_factory.mktemp("img") / "pokemon.jpeg"
    Image.fromarray(np.random.RandomState(0).randint(0, 256, (60, 50, 3), dtype=np.uint8)).save(
        path)
    return str(path)


def test_pokemon_harness_runs_and_gates(ckpt, pokemon):
    result = golden.check_pokemon(ckpt, pokemon, **TINY)
    probs = np.asarray(result["probs"])
    assert result["check"] == "pokemon" and probs.shape == (4,)
    assert abs(probs.sum() - 1.0) < 1e-4
    assert not result["ok"] and result["max_abs_err"] > result["atol"]
    np.testing.assert_allclose(result["golden"], golden.POKEMON_GOLDEN)


def test_pokemon_int8_harness_runs(ckpt, pokemon):
    result = golden.check_pokemon_int8(ckpt, pokemon, **TINY)
    assert result["check"] == "pokemon_int8"
    for k in ("full_probs", "int8_probs"):
        assert abs(sum(result[k]) - 1.0) < 1e-4
    assert result["ok"] and result["max_abs_shift"] < result["atol"]


@pytest.mark.parametrize("dataset", ["muge", "flickr30k-cn"])
def test_retrieval_harness_runs(ckpt, tmp_path, dataset):
    """The raw official layout -> the port's build_dataset in a subprocess ->
    extract -> top-k -> score -> gate (muge: T2I; flickr: both ways)."""
    split = golden.RETRIEVAL_GOLDEN[dataset]["split"]
    write_raw_split(str(tmp_path), split, n_images=12)
    if dataset == "muge":
        result = golden.check_muge(ckpt, str(tmp_path), str(tmp_path / "work"), 4, **TINY)
        assert result["check"] == "muge_zeroshot_t2i" and not result["ok"]
        assert set(result["scores"]) >= {"mean_recall", "r1", "r5", "r10"}
        return
    result = golden.check_retrieval(dataset, ckpt, str(tmp_path), str(tmp_path / "work"), 4,
                                    **TINY)
    assert result["check"] == "flickr30k-cn_zeroshot_retrieval" and not result["ok"]
    assert set(result["directions"]) == {"t2i", "i2t"}
    for d in result["directions"].values():
        assert 0.0 <= d["scores"]["r10"] <= 100.0
        assert d["golden_mr"] == pytest.approx(
            (d["golden"]["r1"] + d["golden"]["r5"] + d["golden"]["r10"]) / 3)
    assert os.path.exists(tmp_path / "work" / "ds" / split / "imgs.npack")


def test_imagenet_and_lora_song_harness_run(ckpt, tmp_path):
    from PIL import Image

    from nans_clip_tpu_torch import configs
    from nans_clip_tpu_torch.eval.model_io import load_eval_model
    from nans_clip_tpu_torch.models.lora import init_lora, save_lora

    data = tmp_path / "val"
    rs = np.random.RandomState(2)
    for cls in ("n01", "n02"):
        (data / cls).mkdir(parents=True)
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), np.uint8)).save(data / cls / "x.jpg")
    labels = tmp_path / "labels.txt"
    labels.write_text("鲤鱼\n金鱼\n", encoding="utf8")
    result = golden.check_imagenet(ckpt, str(data), str(labels), str(tmp_path / "w"), 2, **TINY)
    assert result["check"] == "imagenet_zeroshot_top1" and not result["ok"]
    assert 0.0 <= result["top1"] <= 100.0
    assert os.path.exists(tmp_path / "w" / "imagenet.json")

    write_raw_split(str(tmp_path), n_images=4)
    build_dataset.build_split(str(tmp_path), "valid")
    model = load_eval_model("", "", ckpt, "fp32", cfg=configs.tiny_config(), device="cpu")
    lora = str(tmp_path / "adapter.npz")
    save_lora(lora, init_lora(torch.Generator().manual_seed(0), model.module, rank=4),
              {"rank": 4, "alpha": 16.0})
    result = golden.check_lora_song(ckpt, str(tmp_path / "valid"), lora, 4, **TINY)
    assert result["check"] == "lora_song_r1" and set(result["got"]) == {"zeroshot", "lora"}
    assert result["got"]["zeroshot"] == result["got"]["lora"]     # B = 0: the base model
    assert result["golden"] == golden.LORA_SONG_GOLDEN and isinstance(result["ok"], bool)


def test_golden_cli(ckpt, pokemon, capsys):
    assert golden.main(["pokemon", "--checkpoint", ckpt, "--image", pokemon, "--tiny-model",
                        "--platform", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["check"] == "pokemon"
    out = subprocess.run([sys.executable, "-m", "nans_clip_tpu_torch.eval.golden"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden.main(["pokemon", "--checkpoint", ckpt, "--image", pokemon])
