"""The benchmark's yardstick on the CPU: seeded generators, operation
counts against hand counts, the reference against the port at a tiny
size, and the import rules."""

from __future__ import annotations

import ast
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import counts, harness
from perfbench.tests import tiny

PB = Path(__file__).resolve().parents[1]
CONFIGS = ["vitb16-rbt-base", "vith14-rbt-large"]


def ctx_for(root: Path, cell: str, seed: int, seconds: float = 2.0) -> harness.Context:
    c = harness.cell(harness.benchmark(), cell)
    return harness.Context(cell=c, config=harness.config(c["config"]),
                           traffic=harness.traffic(c["traffic"]), limits=harness.limits(cell),
                           seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
                           t_start=0.0)


@pytest.fixture
def copy(monkeypatch):
    root = tiny.make(Path(tempfile.mkdtemp()))
    tiny.use(root, monkeypatch)
    return root


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40 + 3])
def test_subseeds_take_large_seeds_and_differ_by_tag(seed):
    a, b = harness.subseed(seed, 1), harness.subseed(seed, 2)
    assert 0 <= a < 2 ** 63 and 0 <= b < 2 ** 63 and a != b
    assert harness.subseed(seed, 1) == a


def test_embed_inputs_repeat_for_a_seed_and_differ_across_seeds(copy):
    from perfbench.drivers.embed import make_inputs

    i1, t1 = make_inputs(ctx_for(copy, "embed-tiny", 2 ** 31 + 7))
    i2, t2 = make_inputs(ctx_for(copy, "embed-tiny", 2 ** 31 + 7))
    i3, t3 = make_inputs(ctx_for(copy, "embed-tiny", 11))
    assert torch.equal(i1, i2) and torch.equal(t1, t2)
    assert not torch.equal(i1, i3) and not torch.equal(t1, t3)
    # the same lengths in another order: every seed does the same work
    lengths = lambda t: sorted(((t[0] != 0).sum(1) - 2).tolist())
    assert lengths(t1) == lengths(t3)
    assert all(t1[0, r, 0] == 101 for r in range(t1.shape[1]))


def test_serve_requests_repeat_for_a_seed_and_differ_across_seeds(copy):
    from perfbench.drivers import serve

    tr = harness.traffic("serve-tiny")
    chars = serve.cjk_chars()
    reqs = [serve.Requests(tr, s, 2.0, serve.make_jpegs(tr, s), chars)
            for s in (5, 5, 2 ** 31 + 1)]
    assert reqs[0].payload == reqs[1].payload and np.array_equal(reqs[0].due, reqs[1].due)
    assert reqs[0].payload != reqs[2].payload
    # one arrival schedule; the same text lengths in another order
    assert np.array_equal(reqs[0].due, reqs[2].due)
    assert np.array_equal(reqs[0].is_text, reqs[2].is_text)
    tl = lambda r: sorted(len(p) for p, t in zip(r.payload, r.is_text) if t)
    assert tl(reqs[0]) == tl(reqs[2])
    assert abs(reqs[0].due[-1] - 2.0) < 1e-9


def test_train_step_seeds_differ():
    from perfbench.drivers.train import step_seed

    ctx = harness.Context({}, {}, {}, {}, 2 ** 31 + 9, 1.0, False, None, 0.0)
    seeds = {step_seed(ctx, i) for i in range(8)}
    assert len(seeds) == 8


def _hand_tower(seq, width, layers):
    qkv, out, mlp = 2 * seq * width * 3 * width, 2 * seq * width * width, 2 * 2 * seq * width * 4 * width
    attn = 2 * 2 * seq * seq * width
    return layers * (qkv + out + mlp + attn)


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_match_hand_counts(name):
    cfg = harness.load_json(PB / "configs" / f"{name}.json")
    s = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1
    w, e, h = cfg["vision_width"], cfg["embed_dim"], cfg["text_hidden_size"]
    img = (_hand_tower(s, w, cfg["vision_layers"]) + 2 * s * 3 * cfg["vision_patch_size"] ** 2 * w
           + 2 * w * e)
    txt = _hand_tower(52, h, cfg["text_num_hidden_layers"]) + 2 * h * e
    assert counts.pair_flops(cfg) == pytest.approx(img + txt, rel=1e-12)
    assert counts.image_flops(cfg) + counts.text_flops(cfg) == pytest.approx(img + txt, rel=1e-12)
    # the op lists count the same products (the patch embedding without the class token)
    ops = counts.image_ops(cfg, 1) + counts.text_ops(cfg, 1)
    patch_cls = 2 * 3 * cfg["vision_patch_size"] ** 2 * w
    assert sum(o.flops for o in ops) == pytest.approx(img + txt - patch_cls, rel=1e-12)


@pytest.mark.parametrize("name,published", [("vitb16-rbt-base", "ViT-B-16"),
                                            ("vith14-rbt-large", "ViT-H-14")])
def test_counts_equal_the_ports_and_its_parameters(name, published):
    from nans_clip_tpu_torch import bench, configs
    from nans_clip_tpu_torch.models.clip import build_clip

    cfg = harness.load_json(PB / "configs" / f"{name}.json")
    port_cfg = configs.config_for_name(published)[0]
    assert counts.pair_flops(cfg) == pytest.approx(bench.pair_flops(port_cfg), rel=1e-12)
    module = build_clip(harness.program_config(cfg), "meta")
    assert counts.n_params(cfg) == sum(p.numel() for p in module.parameters())
    mine = harness.program_config(cfg)
    assert (mine.embed_dim, mine.vision, mine.text) == (port_cfg.embed_dim, port_cfg.vision,
                                                         port_cfg.text)


def test_weights_layout_is_the_ports():
    from perfbench.reference import weights
    from nans_clip_tpu_torch.models.clip import build_clip

    for name in CONFIGS:
        cfg = harness.load_json(PB / "configs" / f"{name}.json")
        module = build_clip(harness.program_config(cfg), "meta")
        assert {n: tuple(p.shape) for n, p in module.named_parameters()} == \
            {n: s for n, s, *_ in weights.layout(cfg)}


def test_philox_masks_equal_the_ports():
    from nans_clip_tpu_torch.ops import dropout as port
    from perfbench.reference import philox

    g = torch.Generator().manual_seed(0)
    c = [torch.randint(0, 2 ** 32, (257,), generator=g, dtype=torch.int64) for _ in range(4)]
    for key in (0, 12345, 2 ** 31 - 1):
        for stream in (0, 1, 2):
            assert torch.equal(philox.word0(*c, key, stream), port.philox_word0(*c, key, stream))
    spec = port.Dropout(777, 0.1, port.STREAM_HIDDEN, 6)
    want = port.hidden_multiplier(spec, 3 * 6, 10, "cpu").view(3, 6, 10)
    assert torch.equal(philox.hidden(777, 1, 0.1, 3, 6, 10, "cpu"), want)
    spec = port.Dropout(99, 0.1, port.STREAM_ATTN)
    assert torch.equal(philox.attention(99, 0.1, 2, 3, 5, "cpu"),
                       port.attention_multiplier(spec, 2, 3, 5, "cpu"))


def test_reference_towers_equal_the_ports_in_fp32(copy):
    from nans_clip_tpu_torch.models.common import ModelOptions
    from perfbench.drivers.embed import make_inputs
    from perfbench.reference import model as ref_model

    ctx = ctx_for(copy, "embed-tiny", 3)
    images, ids = make_inputs(ctx)
    cfg = ctx.config
    module = harness.program_module(cfg, 3, "cpu")
    w = harness.reference_weights(cfg, 3, "cpu")
    with torch.no_grad():
        for k in range(images.shape[0]):
            x = images[k].float()
            assert torch.allclose(module.encode_image(x, ModelOptions()),
                                  ref_model.encode_image(w, cfg, x), atol=2e-5, rtol=1e-4)
            assert torch.allclose(module.encode_text(ids[k], ModelOptions()),
                                  ref_model.encode_text(w, cfg, ids[k]), atol=2e-5, rtol=1e-4)


def test_reference_tokenizer_and_decode_equal_the_daemons():
    from nans_clip_tpu_torch.data.dataset import preprocess_text
    from nans_clip_tpu_torch.data.npack import decode_jpeg_pil_batch
    from nans_clip_tpu_torch.tokenizer import tokenize
    from nans_clip_tpu_torch.utils.transform import OPENAI_MEAN, OPENAI_STD
    from perfbench.drivers import serve
    from perfbench.reference import image
    from perfbench.reference.tokenizer import WordPiece

    wp = WordPiece(str(serve.vocab_path()))
    texts = ["北京天安门", "你好，世界！", "“引号”和 空格 ABC def 123", "一" * 60]
    assert np.array_equal(wp.tokenize(texts, 52),
                          tokenize([preprocess_text(t) for t in texts], 52))
    tr = {"jpeg_pool": 3, "shape_seed": 0, "image_side": {"min": 224, "max": 320},
          "aspects": [[1, 1], [4, 3], [3, 4]], "jpeg_quality": 90}
    raws = serve.make_jpegs(tr, 5)
    out, ok = decode_jpeg_pil_batch(raws, 224, 2)
    port = (out.astype(np.float32) / 255.0 - np.asarray(OPENAI_MEAN, np.float32)) / \
        np.asarray(OPENAI_STD, np.float32)
    assert ok.all()
    assert np.array_equal(np.stack([image.transform(r, 224) for r in raws]), port)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_imports_jax_and_the_reference_imports_nothing_of_the_program():
    for path in PB.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "nans_clip_tpu"}, path
        if path.parent.name == "reference":
            assert "nans_clip_tpu_torch" not in tops, path
            assert all(m == "perfbench" or m.startswith("perfbench.reference")
                       for m in _imports(path) if m.split(".")[0] == "perfbench"), path


def test_a_run_loads_no_jax(tmp_path):
    import subprocess
    import sys

    root = tiny.make(tmp_path)
    code = f"""
import sys, torch
sys.path.insert(0, {str(tiny.REPO)!r})
from perfbench import harness, run
from pathlib import Path
harness.HERE, harness.ROOT = Path({str(root)!r}) / "perfbench", Path({str(root)!r})
out, _ = run.execute(run.parse_args(["--workload", "embed-tiny", "--seed", "3",
                                     "--seconds", "0.5"]), torch.device("cpu"))
print(out.correct, run.forbidden_modules())
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split("\n")[-2] == "True []"


def test_the_checkout_without_the_program_gives_no_result(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "embed-vitb16-b256", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert not res.stdout.strip()


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for c in bench["configs"]:
        assert (tiny.REPO / c["file"]).is_file() and c["file"].startswith("perfbench/")
    for w in bench["workloads"]:
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PB / "limits" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200
    for m in bench["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
