"""The port's retrieval eval pipeline (nans_clip_tpu_torch/eval/templates.py,
evaluation.py, evaluation_tr.py, transform_ir_annotation_to_tr.py,
make_topk_predictions.py, extract_features.py) on the CPU, against the JAX
package's modules.

The three stages run in both packages at tiny_config in fp32 (JAX on its
XLA attention, what "auto" is on the CPU) from one reference-layout .pt of
the JAX init, on a split that each package's build_dataset built from the
same raw files. Tolerances: features within 2e-4 (the bound the feature
tests hold); top-k lists equal, except that two ids may trade places where
their exact scores differ by less than 1e-6 (the tie rule); score jsons
equal."""

import base64
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.eval import evaluation as jevaluation
from nans_clip_tpu.eval import evaluation_tr as jevaluation_tr
from nans_clip_tpu.eval import extract_features as jextract
from nans_clip_tpu.eval import make_topk_predictions as jtopk
from nans_clip_tpu.eval import templates as jtemplates
from nans_clip_tpu.eval import transform_ir_annotation_to_tr as jtranspose
from nans_clip_tpu.models.clip import init_clip
from nans_clip_tpu.preprocess import build_dataset as jbuild
from nans_clip_tpu.utils.torch_interop import save_torch_checkpoint, state_dict_from_params
from nans_clip_tpu_torch.eval import evaluation, evaluation_tr, extract_features
from nans_clip_tpu_torch.eval import make_topk_predictions as topk
from nans_clip_tpu_torch.eval import templates, transform_ir_annotation_to_tr
from nans_clip_tpu_torch.preprocess import build_dataset

torch.set_num_threads(2)

FEATURE_ATOL = 2e-4
TIE = 1e-6
N_IMAGES = 14


def write_raw_split(root, split="valid", n_images=N_IMAGES, seed=0, modes=None):
    """{split}_imgs.tsv and {split}_texts.jsonl: seeded noise JPEGs of 40-64
    px (``modes``: {index: PIL mode} for a grayscale or CMYK record), and
    texts as the fork-eval fixture has them: one caption an image and, above
    10 images, some with two or three image ids, two duplicate captions, one
    with capitals and CJK curly quotes."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    modes = modes or {}
    with open(os.path.join(root, f"{split}_imgs.tsv"), "w") as f:
        for i in range(n_images):
            side = int(rs.randint(40, 65))
            if modes.get(i) == "CMYK":
                # ink and black together: RGB = 255 - min(255, C + K) clips, so
                # converting before or after the resize gives other pixels
                img = Image.fromarray(rs.randint(0, 256, (side, side, 4), dtype=np.uint8), "CMYK")
            else:
                img = Image.fromarray(rs.randint(0, 256, (side, side, 3), dtype=np.uint8))
            if i in modes:
                img = img.convert(modes[i])
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=92)
            f.write(f"{i}\t{base64.urlsafe_b64encode(buf.getvalue()).decode()}\n")
    rows = [{"text_id": 100 + i, "text": f"第{i}卷的插图", "image_ids": [i]}
            for i in range(n_images)]
    if n_images > 10:
        rows[1]["image_ids"] = [1, 2]
        rows[4]["image_ids"] = [4, 5, 6]
        rows += [{"text_id": 200, "text": "第3卷的插图", "image_ids": [7]},
                 {"text_id": 201, "text": "第3卷的插图", "image_ids": [8]},
                 {"text_id": 202, "text": "“南宋”ABC刻本", "image_ids": [9, 10]}]
    with open(os.path.join(root, f"{split}_texts.jsonl"), "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


def tiny_checkpoint(path, seed=7):
    """A reference-layout .pt of the JAX init of tiny_config."""
    cfg = jconfigs.tiny_config()
    params, _ = init_clip(jax.random.PRNGKey(seed), cfg)
    save_torch_checkpoint(path, state_dict_from_params(jax.tree.map(np.asarray, params), cfg),
                          {"epoch": 0, "step": 0, "name": "tiny"})
    return path


def read_feats(path, key):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r[key] for r in rows], np.asarray([r["feature"] for r in rows], np.float64)


def read_topk(path, qkey, gkey):
    with open(path) as f:
        return {r[qkey]: r[gkey] for r in map(json.loads, f)}


def check_topk(got: dict, q_ids, q_feats, g_ids, g_feats, k=10) -> int:
    """``got`` against the float64 ranking of the same features under the
    tie rule; returns the number of positions where the ids differ."""
    scores = q_feats @ g_feats.T
    pos = {g: j for j, g in enumerate(g_ids)}
    swaps = 0
    assert sorted(got) == sorted(q_ids)
    for i, q in enumerate(q_ids):
        want = [g_ids[j] for j in np.argsort(-scores[i], kind="stable")[:min(k, len(g_ids))]]
        assert len(got[q]) == len(want) and len(set(got[q])) == len(want)
        for a, b in zip(got[q], want):
            if a != b:
                swaps += 1
                assert abs(scores[i, pos[a]] - scores[i, pos[b]]) < TIE, (q, got[q], want)
    return swaps


# -- templates, scorer, transpose ----------------------------------------------

@pytest.mark.parametrize("dataset", ["fgvc-aircraft-2013b-variants102", "food-101",
                                     "oxford-flower-102", "eurosat_clip", "resisc45_clip",
                                     "country211", "openai", "imagenet", "flower-102",
                                     "unknown-dataset"])
def test_templates_for_dataset_match_jax(dataset):
    assert templates.templates_for_dataset(dataset) == jtemplates.templates_for_dataset(dataset)


def test_template_tables_match_jax():
    assert templates.imagenet_classnames() == jtemplates.imagenet_classnames()
    assert templates.imagenet_templates() == jtemplates.imagenet_templates()
    assert templates.cvinw_templates() == jtemplates.cvinw_templates()
    assert len(templates.templates_for_dataset("imagenet")) == 183
    assert templates.apply_template("一张{}的照片", "狗") == "一张狗的照片"


_GOOD = list(range(10))
_BAD_SUBMISSIONS = {
    "missing file": None,
    "not json": "{text_id: 0",
    "no query key": json.dumps({"image_ids": _GOOD}),
    "string query id": json.dumps({"text_id": "0", "image_ids": _GOOD}),
    "no gallery key": json.dumps({"text_id": 0}),
    "gallery not a list": json.dumps({"text_id": 0, "image_ids": 3}),
    "wrong count": json.dumps({"text_id": 0, "image_ids": [1, 2, 3]}),
    "string gallery id": json.dumps({"text_id": 0, "image_ids": _GOOD[:9] + ["9"]}),
    "duplicates": json.dumps({"text_id": 0, "image_ids": [1] + _GOOD[1:]}),
    "missing query": json.dumps({"text_id": 5, "image_ids": _GOOD}),
}


@pytest.mark.parametrize("case", sorted(_BAD_SUBMISSIONS))
@pytest.mark.parametrize("tr", [False, True], ids=["t2i", "i2t"])
def test_read_submission_errors_match_jax(tmp_path, case, tr):
    keys = ("image_id", "text_ids") if tr else ("text_id", "image_ids")
    rename = lambda s: s.replace('"text_id"', f'"{keys[0]}"').replace('"image_ids"',
                                                                       f'"{keys[1]}"')
    golden = tmp_path / "golden.jsonl"
    golden.write_text(json.dumps({keys[0]: 0, keys[1]: [1]}) + "\n")
    sub = tmp_path / "sub.jsonl"
    if _BAD_SUBMISSIONS[case] is not None:
        sub.write_text(rename(_BAD_SUBMISSIONS[case]) + "\n")
    ref = evaluation.read_reference(str(golden), *keys)
    assert ref == jevaluation.read_reference(str(golden), *keys)
    with pytest.raises(Exception) as want:
        jevaluation.read_submission(str(sub), ref, 10, *keys)
    with pytest.raises(Exception) as got:
        evaluation.read_submission(str(sub), ref, 10, *keys)
    assert type(got.value) is Exception and got.value.args == want.value.args
    # the CLI's error json, both mirrors
    cli, jcli = (evaluation_tr, jevaluation_tr) if tr else (evaluation, jevaluation)
    cli.main([str(golden), str(sub), str(tmp_path / "out.json")])
    jcli.main([str(golden), str(sub), str(tmp_path / "jout.json")])
    assert (tmp_path / "out.json").read_bytes() == (tmp_path / "jout.json").read_bytes()


def test_recall_and_scores_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    golden, pred = tmp_path / "golden.jsonl", tmp_path / "pred.jsonl"
    with open(golden, "w") as g, open(pred, "w") as p:
        for t in range(40):
            g.write(json.dumps({"text_id": t, "image_ids": rs.choice(30, rs.randint(1, 4),
                                                                     replace=False).tolist()})
                    + "\n")
            p.write(json.dumps({"text_id": t, "image_ids": rs.permutation(30)[:10].tolist()})
                    + "\n")
    ref = evaluation.read_reference(str(golden))
    sub = evaluation.read_submission(str(pred), ref)
    assert evaluation.recall_at_ks(ref, sub) == jevaluation.recall_at_ks(ref, sub)
    assert evaluation.compute_score(str(golden), str(pred)) == \
        jevaluation.compute_score(str(golden), str(pred))
    evaluation.main([str(golden), str(pred), str(tmp_path / "a.json")])
    jevaluation.main([str(golden), str(pred), str(tmp_path / "b.json")])
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    assert json.loads((tmp_path / "a.json").read_text())["success"]


def test_transpose_byte_equal(tmp_path):
    write_raw_split(str(tmp_path))
    src = str(tmp_path / "valid_texts.jsonl")
    out = transform_ir_annotation_to_tr.transform(src)
    assert out == str(tmp_path / "valid_texts.tr.jsonl")
    jout = jtranspose.transform(src, str(tmp_path / "j.tr.jsonl"))
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
    transform_ir_annotation_to_tr.main(["--annotation-path", src, "--output-path",
                                        str(tmp_path / "cli.tr.jsonl")])
    assert (tmp_path / "cli.tr.jsonl").read_bytes() == (tmp_path / "j.tr.jsonl").read_bytes()


# -- top-k ---------------------------------------------------------------------

def _write_feats(path, key, ids, feats):
    with open(path, "w") as f:
        for i, v in zip(ids, feats):
            f.write(json.dumps({key: int(i), "feature": v.tolist()}) + "\n")


@pytest.mark.parametrize("k,tr,chunk", [(10, False, 1024), (10, True, 7), (50, False, 16),
                                        (50, True, 1024)])
def test_topk_byte_equal_to_jax(tmp_path, k, tr, chunk):
    """Seeded unit features; k = 50 is above both gallery sizes (cut to the
    gallery, as the JAX CLI does)."""
    rs = np.random.RandomState(1)
    unit = lambda n: (lambda x: x / np.linalg.norm(x, axis=1, keepdims=True))(
        rs.randn(n, 32).astype(np.float32))
    img, txt = str(tmp_path / "img.jsonl"), str(tmp_path / "txt.jsonl")
    _write_feats(img, "image_id", rs.permutation(1000)[:37], unit(37))
    _write_feats(txt, "text_id", np.arange(45) + 5, unit(45))
    args = ["--image-feats", img, "--text-feats", txt, "--top-k", str(k),
            "--eval-batch-size", str(chunk)] + (["--tr"] if tr else [])
    topk.main(args + ["--output", str(tmp_path / "mine.jsonl"), "--platform", "cpu"])
    jtopk.main(args + ["--output", str(tmp_path / "jax.jsonl")])
    mine = (tmp_path / "mine.jsonl").read_bytes()
    assert mine == (tmp_path / "jax.jsonl").read_bytes()
    assert len(json.loads(mine.splitlines()[0])["text_ids" if tr else "image_ids"]) == \
        min(k, 45 if tr else 37)


def test_topk_lists_ties_in_gallery_order():
    """Equal scores come in gallery order, as lax.top_k gives them."""
    gallery = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 0.0], [0.6, 0.8]])
    idx = topk.topk_indices(torch.tensor([[1.0, 0.0], [0.0, 1.0]]), gallery, 4)
    assert idx.tolist() == [[0, 2, 3, 4], [1, 4, 0, 2]]


def test_topk_is_exact_fp32_whatever_the_flag():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with topk.exact_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# -- extract_features and the whole pipeline ----------------------------------

def _extract_argv(split, texts, out, ckpt, batch=4, transform="pil"):
    return ["--extract-image-feats", "--extract-text-feats", "--image-data", split,
            "--text-data", texts, "--image-feat-output-path", os.path.join(out, "img.jsonl"),
            "--text-feat-output-path", os.path.join(out, "txt.jsonl"), "--resume", ckpt,
            "--precision", "fp32", "--tiny-model", "--img-batch-size", str(batch),
            "--text-batch-size", str(batch), "--image-transform", transform]


def _three_stages(ext, tk, ev, ev_tr, tr, argv, texts, out, platform):
    ext.main(argv + platform)
    img, txt = os.path.join(out, "img.jsonl"), os.path.join(out, "txt.jsonl")
    feats = ["--image-feats", img, "--text-feats", txt, "--top-k", "10",
             "--eval-batch-size", "5"]
    tk.main(feats + ["--output", os.path.join(out, "topk.jsonl")] + platform)
    ev.main([texts, os.path.join(out, "topk.jsonl"), os.path.join(out, "score.json")])
    annot = tr.transform(texts, os.path.join(out, "annot.tr.jsonl"))
    tk.main(feats + ["--tr", "--output", os.path.join(out, "topk_tr.jsonl")] + platform)
    ev_tr.main([annot, os.path.join(out, "topk_tr.jsonl"), os.path.join(out, "score_tr.json")])


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Both packages' three stages on their own builds of one raw split
    (one grayscale record), from one checkpoint."""
    root = tmp_path_factory.mktemp("pipeline")
    write_raw_split(str(root), modes={3: "L"})
    build_dataset.build_split(str(root), "valid", str(root / "port"))
    jbuild.build_split(str(root), "valid", str(root / "jax"))
    ckpt = tiny_checkpoint(str(root / "tiny.pt"))
    texts = str(root / "valid_texts.jsonl")
    out = {}
    for name, transform in (("port", "pil"), ("port_native", "native"), ("jax", "pil")):
        d = root / f"out_{name}"
        d.mkdir()
        split = str(root / ("jax" if name == "jax" else "port"))
        argv = _extract_argv(split, texts, str(d), ckpt, transform=transform)
        if name == "jax":
            _three_stages(jextract, jtopk, jevaluation, jevaluation_tr, jtranspose, argv, texts,
                          str(d), [])
        else:
            _three_stages(extract_features, topk, evaluation, evaluation_tr,
                          transform_ir_annotation_to_tr, argv, texts, str(d),
                          ["--platform", "cpu"])
        out[name] = str(d)
    return {"root": str(root), "ckpt": ckpt, "texts": texts, **out}


@pytest.mark.parametrize("name", ["port", "port_native"])
def test_features_match_jax(pipelines, name):
    for fname, key, n in (("img.jsonl", "image_id", N_IMAGES), ("txt.jsonl", "text_id", 17)):
        ids, mine = read_feats(os.path.join(pipelines[name], fname), key)
        jids, theirs = read_feats(os.path.join(pipelines["jax"], fname), key)
        assert ids == jids and len(ids) == n
        np.testing.assert_allclose(mine, theirs, atol=FEATURE_ATOL, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(mine, axis=1), 1.0, atol=1e-6)
    # the JSONL schema and key order
    with open(os.path.join(pipelines[name], "img.jsonl")) as f:
        assert list(json.loads(f.readline())) == ["image_id", "feature"]


@pytest.mark.parametrize("tr", [False, True], ids=["t2i", "i2t"])
def test_topk_and_scores_match_jax(pipelines, tr):
    """The port's lists against the float64 ranking of the JAX features (and
    of its own) under the tie rule, the JAX lists against the same, and the
    score jsons byte for byte."""
    d, jd = pipelines["port"], pipelines["jax"]
    keys = ("image_id", "text_ids") if tr else ("text_id", "image_ids")
    fname = "topk_tr.jsonl" if tr else "topk.jsonl"
    img_ids, img = read_feats(os.path.join(jd, "img.jsonl"), "image_id")
    txt_ids, txt = read_feats(os.path.join(jd, "txt.jsonl"), "text_id")
    q = (img_ids, img, txt_ids, txt) if tr else (txt_ids, txt, img_ids, img)
    for out in (d, jd):
        check_topk(read_topk(os.path.join(out, fname), *keys), *q)
    score = "score_tr.json" if tr else "score.json"
    with open(os.path.join(d, score), "rb") as a, open(os.path.join(jd, score), "rb") as b:
        mine, theirs = a.read(), b.read()
    assert mine == theirs and json.loads(mine)["success"]


def test_final_batch_rows_unchanged(pipelines, tmp_path):
    """No padding: batch 4 (a final batch of 2 images, 1 text) and one batch
    of everything give the same rows."""
    whole = str(tmp_path / "whole")
    os.makedirs(whole)
    extract_features.main(_extract_argv(os.path.join(pipelines["root"], "port"),
                                        pipelines["texts"], whole, pipelines["ckpt"], batch=64)
                          + ["--platform", "cpu"])
    for fname, key in (("img.jsonl", "image_id"), ("txt.jsonl", "text_id")):
        ids, a = read_feats(os.path.join(pipelines["port"], fname), key)
        wids, b = read_feats(os.path.join(whole, fname), key)
        assert ids == wids
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_native_reads_cmyk_as_pil(tmp_path):
    """The JAX package's native extraction raises on a CMYK record (its
    libjpeg decoder refuses it); the port's gives it the pil path's pixels."""
    write_raw_split(str(tmp_path), n_images=4, modes={2: "CMYK"})
    build_dataset.build_split(str(tmp_path), "valid")
    ckpt = tiny_checkpoint(str(tmp_path / "tiny.pt"))
    feats = {}
    for transform in ("pil", "native"):
        out = tmp_path / transform
        out.mkdir()
        argv = _extract_argv(str(tmp_path / "valid"), str(tmp_path / "valid_texts.jsonl"),
                             str(out), ckpt, transform=transform)
        extract_features.main(argv[:1] + argv[2:] + ["--platform", "cpu"])
        feats[transform] = read_feats(str(out / "img.jsonl"), "image_id")
    assert feats["pil"][0] == feats["native"][0] == [0, 1, 2, 3]
    np.testing.assert_allclose(feats["native"][1], feats["pil"][1], atol=1e-6, rtol=0)


def test_extract_refuses_unported(tmp_path):
    """RN50 (ROADMAP item 5) and a missing card are refused; the serialized
    backends run (tests/test_torch_engine.py) and refuse to start without
    their artifact."""
    base = ["--extract-text-feats", "--text-data", "x.jsonl", "--resume", "x.pt"]
    texts = tmp_path / "t.jsonl"
    texts.write_text(json.dumps({"text_id": 0, "text": "西湖"}) + "\n")
    for backend in ("stablehlo", "engine"):
        with pytest.raises(SystemExit, match="needs --text-artifact"):
            extract_features.main(["--extract-text-feats", "--text-data", str(texts),
                                   "--resume", "", "--tiny-model", "--precision", "fp32",
                                   "--backend", backend, "--platform", "cpu"])
    with pytest.raises(NotImplementedError, match="item 5"):
        extract_features.main(base[:-1] + ["", "--vision-model", "RN50", "--platform", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_features.main(base)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topk.main(["--image-feats", "a", "--text-feats", "b", "--output", "c"])
