"""The port's zero-shot classifier (nans_clip_tpu_torch/eval/zeroshot_evaluation.py)
and the fork's retrieval suite (eval/retrieval_suite.py) on the CPU, against
the JAX package's at tiny_config in fp32, from one reference-layout .pt of
the JAX init.

Tolerances: the classifier matrix within 2e-4 (the feature bound); run's
top-1 equal and its probabilities within 1e-5; the suite's metrics equal
(each a count of hits over a ranking of the same features)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.eval import model_io as jmodel_io
from nans_clip_tpu.eval import retrieval_suite as jrs
from nans_clip_tpu.eval import zeroshot_evaluation as jzs
from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models import clip as jclip
from nans_clip_tpu.models import lora as jlora
from nans_clip_tpu.preprocess import build_dataset as jbuild
from nans_clip_tpu_torch import configs
from nans_clip_tpu_torch.eval import retrieval_suite, zeroshot_evaluation
from nans_clip_tpu_torch.eval.model_io import load_eval_model
from nans_clip_tpu_torch.models.clip import CLIP
from nans_clip_tpu_torch.preprocess import build_dataset

from test_torch_eval import tiny_checkpoint, write_raw_split

torch.set_num_threads(2)

JOPTS = JOptions(attn_impl="xla")
CLASSES = ["猫", "狗", "鸟"]
PROMPTS = ["一张{}的照片。", "{}", "“{}”的IMAGE"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(checkpoint, JAX params, the port's fp32 model) of one tiny init."""
    ckpt = tiny_checkpoint(str(tmp_path_factory.mktemp("zs") / "tiny.pt"))
    _, params, _, _ = jmodel_io.load_eval_model("", "", ckpt, "fp32",
                                                cfg=jconfigs.tiny_config())
    model = load_eval_model("", "", ckpt, "fp32", cfg=configs.tiny_config(), device="cpu")
    return ckpt, params, model


@pytest.fixture(scope="module")
def imagefolder(tmp_path_factory):
    """3 classes x 3 images: RGB JPEGs, a palette PNG and a CMYK JPEG."""
    from PIL import Image

    root = tmp_path_factory.mktemp("folder")
    rs = np.random.RandomState(2)
    for cls in ("n01", "n02", "n03"):
        (root / cls).mkdir()
        for j in range(3):
            img = Image.fromarray(rs.randint(0, 256, (48, 40, 3), dtype=np.uint8))
            if (cls, j) == ("n02", 1):
                img.convert("P").save(root / cls / f"{j}.png")
            elif (cls, j) == ("n03", 2):
                img.convert("CMYK").save(root / cls / f"{j}.jpg")
            else:
                img.save(root / cls / f"{j}.jpg")
    (root / "n01" / "notes.txt").write_text("not an image")
    return str(root)


def _jax_tiny(monkeypatch, module):
    load = jmodel_io.load_eval_model
    monkeypatch.setattr(module, "load_eval_model",
                        lambda *a, **kw: load(*a, **kw, cfg=jconfigs.tiny_config()))


def test_classifier_matches_jax(models):
    _, params, model = models
    want = jzs.zero_shot_classifier(jconfigs.tiny_config(), params, JOPTS, CLASSES, PROMPTS,
                                    batch_size=2)
    got = zeroshot_evaluation.zero_shot_classifier(model, CLASSES, PROMPTS, batch_size=2)
    assert got.shape == want.shape == (64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, atol=1e-5)


def test_run_matches_jax(models, imagefolder):
    _, params, model = models
    classifier = jzs.zero_shot_classifier(jconfigs.tiny_config(), params, JOPTS, CLASSES,
                                          PROMPTS, batch_size=4)
    assert [c for _, c in zeroshot_evaluation.iter_imagefolder(imagefolder)] == \
        [c for _, c in jzs.iter_imagefolder(imagefolder)] == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    acc, rows = zeroshot_evaluation.run(model, classifier, imagefolder, batch_size=4)
    jacc, jrows = jzs.run(jconfigs.tiny_config(), params, {}, JOPTS, classifier, imagefolder,
                          batch_size=4)
    np.testing.assert_allclose(rows, jrows, atol=1e-5, rtol=0)
    assert acc == jacc
    assert [int(np.argmax(r)) for r in rows] == [int(np.argmax(r)) for r in jrows]
    np.testing.assert_allclose(np.sum(rows, axis=1), 1.0, atol=1e-5)


def test_elevater_json_matches_jax(models, imagefolder, tmp_path, monkeypatch):
    ckpt = models[0]
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(CLASSES) + "\n", encoding="utf8")
    index = tmp_path / "index.json"
    index.write_text(json.dumps([8, 0, 4, 1, 2, 3, 5, 6, 7]))
    argv = ["--datapath", imagefolder, "--dataset", "oxford-flower-102", "--label-file",
            str(labels), "--index", str(index), "--resume", ckpt, "--precision", "fp32",
            "--img-batch-size", "4", "--text-batch-size", "16"]
    acc = zeroshot_evaluation.main(argv + ["--save-dir", str(tmp_path / "port"), "--tiny-model",
                                           "--platform", "cpu"])
    _jax_tiny(monkeypatch, jzs)
    jacc = jzs.main(argv + ["--save-dir", str(tmp_path / "jax")])
    assert acc == jacc
    with open(tmp_path / "port" / "oxford-flower-102.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax" / "oxford-flower-102.json") as f:
        want = json.load(f)
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "predictions"} == \
        {k: v for k, v in want.items() if k != "predictions"}
    np.testing.assert_allclose(got["predictions"][0], want["predictions"][0], atol=1e-5, rtol=0)
    assert all(abs(sum(r) - 1.0) < 1e-5 for r in got["predictions"][0])
    assert all(v == round(v, 6) for r in got["predictions"][0] for v in r)


@pytest.mark.parametrize("struct", ["tiny", "ViT-B-16@RoBERTa-wwm-ext-base-chinese",
                                    "ViT-L-14-336@RoBERTa-wwm-ext-base-chinese",
                                    "RN50@RBT3-chinese"])
def test_param_counts_equal_jax_leaves(struct):
    """num_params / num_visual_params: the port's parameters (not buffers)
    against the JAX tree's leaves (shapes only, on the meta device)."""
    cfg = configs.tiny_config() if struct == "tiny" else configs.load_config(struct)
    jcfg = jconfigs.tiny_config() if struct == "tiny" else jconfigs.load_config(struct)
    with torch.device("meta"):
        module = CLIP(cfg)
    shapes = jax.eval_shape(lambda k: jclip.init_clip(k, jcfg)[0], jax.random.PRNGKey(0))
    size = lambda tree: sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    assert zeroshot_evaluation.param_counts(module) == (size(shapes), size(shapes["visual"]))


def test_zeroshot_refuses_without_card(imagefolder, tmp_path, monkeypatch):
    """The card is the default; ``--vision-model RN50`` runs (the tiny RN
    config of tests/test_torch_resnet.py in its place) and writes the
    ELEVATER json of a ResNet model."""
    from nans_clip_tpu_torch.eval import model_io
    from test_torch_resnet import serve_tiny_rn, tiny_rn_config

    with pytest.raises(RuntimeError, match="no CUDA device"):
        zeroshot_evaluation.main(["--datapath", imagefolder, "--resume", "x.pt"])
    serve_tiny_rn(monkeypatch, model_io)
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(CLASSES) + "\n", encoding="utf8")
    acc = zeroshot_evaluation.main(["--datapath", imagefolder, "--resume", "", "--vision-model",
                                    "RN50", "--text-model", "RBT3-chinese", "--platform", "cpu",
                                    "--precision", "fp32", "--dataset", "oxford-flower-102",
                                    "--label-file", str(labels), "--img-batch-size", "4",
                                    "--save-dir", str(tmp_path)])
    with open(tmp_path / "oxford-flower-102.json") as f:
        out = json.load(f)
    with torch.device("meta"):
        module = CLIP(tiny_rn_config())
    assert 0.0 <= acc <= 1.0 and out["model_name"] == "CN-CLIP-RN50"
    assert (out["num_params"], out["num_visual_params"]) == \
        zeroshot_evaluation.param_counts(module)
    rows = np.asarray(out["predictions"][0])
    assert rows.shape == (9, 3)
    np.testing.assert_allclose(rows.sum(1), 1.0, atol=1e-5)


# -- the retrieval suite --------------------------------------------------------

@pytest.fixture(scope="module")
def suite_data(tmp_path_factory, models):
    """A split with a CMYK record built by both packages, a distractor
    folder (a palette PNG, a CMYK JPEG, a text file, a corrupt .jpg), and a
    JAX-written LoRA adapter of rank 2 with random B."""
    from PIL import Image

    root = tmp_path_factory.mktemp("suite")
    write_raw_split(str(root), modes={5: "CMYK", 3: "L"})
    build_dataset.build_split(str(root), "valid", str(root / "port"))
    jbuild.build_split(str(root), "valid", str(root / "jax"))
    dis = root / "distractors"
    dis.mkdir()
    rs = np.random.RandomState(9)
    for i in range(5):
        img = Image.fromarray(rs.randint(0, 256, (50, 44, 3), dtype=np.uint8))
        if i == 1:
            img.convert("P").save(dis / f"d{i}.png")
        else:
            (img.convert("CMYK") if i == 3 else img).save(dis / f"d{i}.jpg")
    (dis / "readme.txt").write_text("not an image")
    (dis / "broken.jpg").write_bytes(b"\xff\xd8 not a jpeg")

    params = models[1]
    adapters = jlora.init_lora(jax.random.PRNGKey(0), params, rank=2)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 8))
    adapters = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(next(keys), x.shape),
                            adapters)
    lora = str(root / "adapter.npz")
    jlora.save_lora(lora, adapters, {"rank": 2, "alpha": 8.0})
    return {"root": str(root), "distractors": str(dis), "lora": lora}


def test_load_split_matches_jax(suite_data):
    got = retrieval_suite.load_split(os.path.join(suite_data["root"], "port"))
    want = jrs.load_split(os.path.join(suite_data["root"], "jax"))
    assert got[:4] == want[:4]
    image_ids, texts, t2i, _, _ = got
    assert len(image_ids) == 14 and len(texts) == 15       # three captions collapse into one
    assert t2i[texts.index("第3卷的插图")] == {3, 7, 8}


@pytest.mark.parametrize("transform", ["pil", "native"])
def test_suite_matches_jax(models, suite_data, tmp_path, monkeypatch, transform):
    """Both directions, with distractors and the JAX-written adapter; the
    split's CMYK record under native takes the pil path's pixels."""
    argv = ["--resume", models[0], "--precision", "fp32", "--batch-size", "4",
            "--distractor-dir", suite_data["distractors"], "--lora", suite_data["lora"],
            "--image-transform", transform]
    got = retrieval_suite.main(argv + ["--data", os.path.join(suite_data["root"], "port"),
                                       "--output", str(tmp_path / "port.json"), "--tiny-model",
                                       "--platform", "cpu"])
    _jax_tiny(monkeypatch, jrs)
    want = jrs.main(argv + ["--data", os.path.join(suite_data["root"], "jax"),
                            "--output", str(tmp_path / "jax.json")])
    assert got == want
    assert got["lora"] != got["zeroshot"]
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        mine, theirs = json.load(f), json.load(g)
    assert mine == theirs and mine["num_distractors"] == 5 and mine["num_total_images"] == 19


def test_suite_native_cmyk_equals_pil(models, suite_data):
    """The features of a split with a CMYK record under native equal pil's,
    as the JAX package's do (tests/test_zeroshot.py)."""
    model = models[2]
    image_ids, texts, _, _, ds = retrieval_suite.load_split(
        os.path.join(suite_data["root"], "port"))
    feats = {pil: retrieval_suite.compute_features(model, ds, image_ids, texts, 4, 52, pil=pil)
             for pil in (True, False)}
    for a, b in zip(feats[True], feats[False]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        retrieval_suite.main(["--data", suite_data["root"], "--resume", models[0]])


def test_suite_raises_on_undecodable_record(tmp_path, models):
    import base64

    write_raw_split(str(tmp_path), n_images=4)
    lines = (tmp_path / "valid_imgs.tsv").read_text().splitlines()
    lines[1] = "1\t" + base64.urlsafe_b64encode(b"\xff\xd8 broken").decode()
    (tmp_path / "valid_imgs.tsv").write_text("\n".join(lines) + "\n")
    build_dataset.build_split(str(tmp_path), "valid")
    image_ids, texts, _, _, ds = retrieval_suite.load_split(str(tmp_path / "valid"))
    with pytest.raises(RuntimeError, match="image_id 1 is undecodable"):
        retrieval_suite.compute_features(models[2], ds, image_ids, texts, 4, 52, pil=False)


def test_load_adapters_takes_the_stored_rank(models, suite_data):
    adapters, alpha = retrieval_suite.load_adapters(suite_data["lora"], models[2].module)
    assert alpha == 8.0 and adapters["visual"]["wo"]["a"].shape[1] == 2
    assert retrieval_suite.load_adapters(suite_data["lora"], models[2].module, 0.0)[1] == 0.0
