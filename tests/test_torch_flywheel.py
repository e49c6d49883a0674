"""The port's data flywheel (``nans_clip_tpu_torch/flywheel``) against the
JAX package's on the same local fixtures: canned web APIs behind a patched
``fetch`` (``scrape``), an OpenAI-compatible stub on 127.0.0.1 (the VLM and
LLM stages), and the tiny model's fp32 weights, shared by both packages
(``filter_annotations``). Every stage's output files must be equal, byte
for byte; the filter's similarities within 2e-4 of JAX's (fp32 towers,
different sum orders), its kept/removed lists equal."""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

import nans_clip_tpu.flywheel.augment_texts as jaug
import nans_clip_tpu.flywheel.auto_annotate as jann
import nans_clip_tpu.flywheel.build_dataset as jbuild
import nans_clip_tpu.flywheel.filter_annotations as jfa
import nans_clip_tpu.flywheel.scrape as jsc
import nans_clip_tpu_torch.flywheel.augment_texts as aug
import nans_clip_tpu_torch.flywheel.auto_annotate as ann
import nans_clip_tpu_torch.flywheel.build_dataset as build
import nans_clip_tpu_torch.flywheel.filter_annotations as fa
import nans_clip_tpu_torch.flywheel.scrape as sc
from nans_clip_tpu import configs as jconfigs
from nans_clip_tpu.models import ModelOptions as JOptions
from nans_clip_tpu.models.clip import init_clip
from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.api import CLIPModel
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params

torch.set_num_threads(2)

JPG = b"\xff\xd8\xff" + b"x" * 25_000       # a JPEG signature over the 20 KB floor


def _fake_fetch(url, retries=3, timeout=30):
    """Canned answers of every source the scrapers ask."""
    if "commons.wikimedia.org" in url:
        return json.dumps({"query": {"pages": {
            "1": {"title": "File:A.jpg", "imageinfo": [
                {"thumburl": "http://x/a.jpg", "mime": "image/jpeg"}]},
            "2": {"title": "File:B.png", "imageinfo": [
                {"url": "http://x/b.png", "mime": "image/png"}]},
            "3": {"title": "File:C.pdf", "imageinfo": [
                {"url": "http://x/c.pdf", "mime": "application/pdf"}]},
            "4": {"title": "File:D.jpg", "imageinfo": [
                {"url": "http://x/broken.jpg", "mime": "image/jpeg"}]}}}}).encode()
    if "image.baidu.com/search/acjson" in url:
        if "pn=0" not in url:
            return b'{"data": []}'
        return json.dumps({"data": [
            {"hoverURL": "http://b/1.jpg", "fromPageTitleEnc": "<b>马远</b> 踏歌图"},
            {"middleURL": "http://b/tiny.jpg", "fromPageTitle": "small"},
            "junk-non-dict"]}).encode()
    if "collectionapi.metmuseum.org" in url and "/search" in url:
        return json.dumps({"objectIDs": [11, 12]}).encode()
    if url.endswith("/objects/11"):
        return json.dumps({"primaryImage": "http://m/pd.jpg", "isPublicDomain": True,
                           "title": "Met PD", "period": "Southern Song",
                           "department": "Asian Art"}).encode()
    if url.endswith("/objects/12"):
        return json.dumps({"primaryImage": "http://m/priv.jpg", "isPublicDomain": False,
                           "title": "Met private"}).encode()
    if "api.artic.edu" in url:
        return json.dumps({"data": [
            {"image_id": "abc", "is_public_domain": True, "title": "ARTIC PD",
             "date_display": "1200", "department_title": "Arts of Asia"},
            {"image_id": "nope", "is_public_domain": False, "title": "ARTIC private"}]}).encode()
    if url.endswith(("x/a.jpg", "b/1.jpg", "m/pd.jpg")) or "artic.edu/iiif/2/abc/" in url:
        return JPG
    if url.endswith("b.png"):
        return b"\x89PNG fakebytes"
    if url.endswith("tiny.jpg"):
        return b"\xff\xd8\xff small"
    raise RuntimeError("download refused")


def _tree(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            path = os.path.join(base, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _patch_scrape(monkeypatch, mod):
    monkeypatch.setattr(mod, "fetch", _fake_fetch)
    monkeypatch.setattr(mod.time, "sleep", lambda s: None)
    monkeypatch.setattr(mod, "SONG_QUERIES", ["南宋 绘画", "Ma Yuan painting"])
    monkeypatch.setattr(mod, "HARD_NEGATIVE_QUERIES", ["Ming dynasty painting"])
    monkeypatch.setattr(mod, "EASY_NEGATIVE_QUERIES", ["abstract art"])
    monkeypatch.setattr(mod, "BAIDU_QUERIES", ["马远 踏歌图 高清"])
    monkeypatch.setattr(mod, "MET_QUERIES", ["Song dynasty painting"])
    monkeypatch.setattr(mod, "ARTIC_QUERIES", ["Southern Song"])
    monkeypatch.setattr(mod, "IMAGE_SOURCES", tuple(
        (p, qs if p != "wiki" else ["Ma Yuan painting"], getattr(mod, f.__name__))
        for p, qs, f in mod.IMAGE_SOURCES))


@pytest.mark.parametrize("mode", ["wikimedia", "distractors", "images"])
def test_scrape_equals_jax(tmp_path, monkeypatch, mode):
    trees = []
    for mod, name in ((jsc, "jax"), (sc, "port")):
        _patch_scrape(monkeypatch, mod)
        out = str(tmp_path / name)
        mod.main([mode, "--out", out, "--per-query", "5"])
        mod.main([mode, "--out", out, "--per-query", "5"])   # a second run: the resume
        trees.append(_tree(out))
    assert trees[0] and trees[0] == trees[1]
    if mode == "images":   # four sources, each once: the resume added nothing
        with open(tmp_path / "port" / "image_metadata.jsonl", encoding="utf-8") as f:
            assert len(f.read().splitlines()) == 4


def test_build_texts_and_dataset_equal_jax(tmp_path):
    from PIL import Image

    for a in ({"modern_chinese": "南宋山水画描绘西湖", "ancient_style": "湖山清远,烟波浩渺",
               "keywords": "南宋, 山水画，西湖", "title": "西湖图"},
              {"title": "a", "modern_chinese": "a"}, {"keywords": " ", "title": ""}, {}):
        assert build.build_texts_for_image(a) == jbuild.build_texts_for_image(a)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    anns = []
    rs = np.random.RandomState(0)
    for i in range(10):
        fname = f"img{i}.jpg"
        Image.fromarray(rs.randint(0, 255, (700, 40, 3), dtype=np.uint8)).save(img_dir / fname)
        anns.append({"filename": fname, "title": f"图{i}", "modern_chinese": f"描述{i}",
                     "ancient_style": "古", "keywords": "南宋,山水"})
        anns.append({"filename": fname, "modern_chinese": f"另一描述{i}",
                     "_is_augmented": True})
    anns.append({"filename": "missing.jpg", "modern_chinese": "佚失"})
    path = tmp_path / "annotations.json"
    path.write_text(json.dumps(anns, ensure_ascii=False), encoding="utf-8")
    trees = []
    for mod, name in ((jbuild, "jax"), (build, "port")):
        mod.main(["--annotations", str(path), "--images-dir", str(img_dir),
                  "--output-dir", str(tmp_path / name), "--train-ratio", "0.8"])
        trees.append(_tree(tmp_path / name))
    assert set(trees[0]) == {"train_imgs.tsv", "train_texts.jsonl", "valid_imgs.tsv",
                             "valid_texts.jsonl"}
    assert trees[0] == trees[1]


class _Stub(BaseHTTPRequestHandler):
    mode = "json"   # "json" | "fenced" | "garbage"
    calls = []

    def do_POST(self):  # noqa: N802
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        content = body["messages"][0]["content"]
        if isinstance(content, list):   # the VLM: image and text parts
            _Stub.calls.append(("vlm", content[1]["text"]))
            a = {"modern_chinese": "一幅宋代山水画，远山近水，笔意疏朗。",
                 "ancient_style": "山色空濛，水光潋滟。", "keywords": "宋代,山水,绘画"}
            text = {"json": json.dumps(a, ensure_ascii=False),
                    "fenced": "```json\n" + json.dumps(a, ensure_ascii=False) + "\n```",
                    "garbage": "这不是JSON"}[_Stub.mode]
        else:   # the paraphrasing LLM
            _Stub.calls.append(("llm", content))
            text = "- 改写甲\n- 改写乙\n"
        data = json.dumps({"choices": [{"message": {"content": text}}]},
                          ensure_ascii=False).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture()
def stub_url():
    _Stub.calls, _Stub.mode = [], "json"
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/v1"
    srv.shutdown()
    srv.server_close()


def _images(d, names, side=24):
    from PIL import Image
    d.mkdir(exist_ok=True)
    rs = np.random.RandomState(0)
    for n in names:
        Image.fromarray(rs.randint(0, 255, (side, side, 3), dtype=np.uint8)).save(
            d / n, format="JPEG")
    return d


def test_auto_annotate_equals_jax(tmp_path, stub_url):
    images = _images(tmp_path / "images", ["a.jpg", "b.jpg", "c.jpg", "d.jpg"])
    meta = tmp_path / "metadata.jsonl"
    rows = [("a.jpg", "山水图"), ("b.jpg", "花鸟图"), ("missing.jpg", "佚失")]
    meta.write_text("".join(json.dumps({"filename": f, "title": t, "category": "绘画"},
                                       ensure_ascii=False) + "\n" for f, t in rows),
                    encoding="utf-8")
    outs = {name: str(tmp_path / f"{name}.json") for name in ("jax", "port")}
    for mode, extra in (("json", None), ("fenced", "c.jpg"), ("garbage", "d.jpg")):
        _Stub.mode = mode
        if extra:
            with open(meta, "a", encoding="utf-8") as f:
                f.write(json.dumps({"filename": extra, "title": "器物"},
                                   ensure_ascii=False) + "\n")
        for mod, name in ((jann, "jax"), (ann, "port")):
            n0 = len(_Stub.calls)
            mod.main(["--metadata", str(meta), "--images-dir", str(images), "--output",
                      outs[name], "--base-url", stub_url, "--sleep", "0"])
            assert len(_Stub.calls) - n0 == (2 if mode == "json" else 1)   # resumed
        assert open(outs["port"], "rb").read() == open(outs["jax"], "rb").read()
    with open(outs["port"], encoding="utf-8") as f:
        got = json.load(f)
    assert [a["filename"] for a in got] == ["a.jpg", "b.jpg", "c.jpg", "d.jpg"]
    assert got[2]["keywords"] == "宋代,山水,绘画" and got[3]["modern_chinese"] == "这不是JSON"


def test_augment_texts_equals_jax(tmp_path, stub_url):
    anns = [{"filename": "a.jpg", "title": "山水图", "modern_chinese": "一幅山水画。",
             "ancient_style": "", "keywords": "山水"},
            {"filename": "b.jpg", "title": "空白", "modern_chinese": "", "ancient_style": "",
             "keywords": ""}]
    for mod, name in ((jaug, "jax"), (aug, "port")):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(anns, ensure_ascii=False), encoding="utf-8")
        for _ in range(2):   # the second run adds nothing and asks nothing
            n0 = len(_Stub.calls)
            mod.main(["--annotations", str(path), "--base-url", stub_url, "--per-image", "2",
                      "--sleep", "0"])
        assert len(_Stub.calls) == n0
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    out = json.loads((tmp_path / "port.json").read_text(encoding="utf-8"))
    assert len(out) == 4 and {a["modern_chinese"] for a in out[2:]} == {"改写甲", "改写乙"}


def test_filter_annotations_equals_jax(tmp_path, monkeypatch):
    """The same fp32 tiny weights in both packages; 20 scored pairs (a
    padded second batch of 4), a missing file and an empty caption."""
    jcfg = jconfigs.tiny_config()
    params, batch_stats = init_clip(jax.random.PRNGKey(0), jcfg)
    cfg = tconfigs.tiny_config()
    module = build_clip(cfg)
    module.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg))
    model = CLIPModel(cfg, module)

    monkeypatch.setattr(jfa, "load_eval_model", lambda *a, **k: (
        jcfg, params, batch_stats, JOptions(attn_impl="xla")))
    monkeypatch.setattr(fa, "load_eval_model", lambda *a, **k: model)
    sims = {"jax": [], "port": []}
    real_jit, real_score = jax.jit, fa.score

    def spy_jit(f):
        g = real_jit(f)

        def h(*a):
            out = g(*a)
            sims["jax"].append(np.asarray(out))
            return out
        return h

    def spy_score(*a):
        out = real_score(*a)
        sims["port"].append(out)
        return out

    monkeypatch.setattr(jfa.jax, "jit", spy_jit)
    monkeypatch.setattr(fa, "score", spy_score)

    from PIL import Image
    names = [f"i{i}.png" for i in range(20)]
    d = tmp_path / "images"
    d.mkdir()
    rs = np.random.RandomState(1)
    for i, n in enumerate(names):   # RGBA and palette images too: resize before convert
        img = Image.fromarray(rs.randint(0, 255, (40, 50, 3), dtype=np.uint8))
        img = img.convert(("RGB", "RGBA", "P")[i % 3])
        img.save(d / n)
    caps = ["山水画", "花鸟画", "一只小猫", "西湖美景"]
    anns = [{"filename": n, "modern_chinese": caps[i % 4]} for i, n in enumerate(names)]
    anns += [{"filename": "gone.jpg", "modern_chinese": "佚失"},
             {"filename": "i0.png", "modern_chinese": ""}]
    path = str(tmp_path / "annotations.json")

    def run(mod, threshold, dry=True):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(anns, f, ensure_ascii=False)
        argv = ["--annotations", path, "--images-dir", str(d), "--resume", "unused.pt",
                "--threshold", str(threshold)] + (["--dry-run"] if dry else [])
        if mod is fa:
            argv += ["--platform", "cpu"]
        return mod.main(argv)

    run(jfa, -1.0)
    run(fa, -1.0)
    theirs, ours = np.concatenate(sims["jax"])[:20], np.concatenate(sims["port"])[:20]
    assert [len(s) for s in sims["port"]] == [16, 16] == [len(s) for s in sims["jax"]]
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=0)
    srt = np.sort(theirs)
    gaps = np.flatnonzero(np.diff(srt) > 1e-3)
    mid = float(srt[gaps[len(gaps) // 2]] + srt[gaps[len(gaps) // 2] + 1]) / 2
    for threshold in (-1.0, 1.01, mid):
        kept, removed = run(fa, threshold)
        jkept, jremoved = run(jfa, threshold)
        assert (kept, removed) == (jkept, jremoved), threshold
        assert len(kept) + len(removed) == len(anns)
    assert 0 < len(run(fa, mid)[1]) < 20
    # without --dry-run the kept records replace the file; unscored ones stay
    kept, removed = run(fa, 1.01, dry=False)
    assert len(removed) == 20 and len(kept) == 2
    with open(path, encoding="utf-8") as f:
        assert json.load(f) == kept
