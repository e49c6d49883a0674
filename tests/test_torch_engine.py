"""The port's engine files (``nans_clip_tpu_torch/deploy/engine.py``) on the
CPU, mirroring ``tests/test_engine.py``: the roundtrip bound and unbound
(exact: on the CPU an engine runs the eager twins), an engine serving
another checkpoint's exact features, the header's checks (each field, and
``strict=False`` warning), the ``build`` / ``inspect`` CLI and its consumers
(``extract_features --backend engine|stablehlo`` equal to ``--backend
jit``; ``speed_benchmark --backend aot|engine``), a cold load in a fresh
process that imports no model-building module, and no weight bytes in the
file."""

import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.api import model_from_config
from nans_clip_tpu_torch.deploy import aot, engine, speed_benchmark
from nans_clip_tpu_torch.eval import extract_features
from nans_clip_tpu_torch.models.common import ModelOptions

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(seed=0, quantize=None):
    m = model_from_config(tconfigs.tiny_config(), seed=seed, device="cpu")
    return m.quantize("int8", ("text",)) if quantize else m


def _texts(n=2):
    t = np.zeros((n, 52), np.int64)
    t[:, 0], t[:, 1], t[:, 2] = 101, 768, 102
    t[1:, 3], t[1:, 4] = 555, 102
    return torch.from_numpy(t)


def _build(tmp_path, model=None, tower="text", batch=2):
    model = model or _model()
    program = aot.export_tower(model.cfg, model.options, tower, aot.tower_params(model, tower),
                               aot.example_input(model.cfg, tower, batch))
    path = engine.save_engine(str(tmp_path / f"{tower}_bs{batch}.engine"), program, batch,
                              meta={"tower": tower, "model": model.cfg.name, "quantize": None,
                                    "context_length": 52})
    return model, path


def test_engine_roundtrip(tmp_path):
    model, path = _build(tmp_path)
    texts = _texts()
    ref = aot.compile_tower(model, "text", 2)(texts)
    eng = engine.load_engine(path, aot.tower_params(model, "text"))
    assert eng.batch_size == 2 and eng.meta["tower"] == "text"
    assert torch.equal(eng(texts), ref)
    raw = engine.load_engine(path)   # unbound: fn(params, x)
    assert torch.equal(raw(aot.tower_params(model, "text"), texts), ref)
    # numpy int32 ids, as the tokenizer gives them
    assert torch.equal(eng(texts.numpy().astype(np.int32)), ref)


def test_engine_serves_other_checkpoints(tmp_path):
    """The weights are inputs, not baked in: an engine built under weights A
    gives B's exact features with B's weights, and stays A's with A's."""
    model_a, path = _build(tmp_path)
    model_b = _model(seed=7)
    texts = _texts()
    ref_b = aot.compile_tower(model_b, "text", 2)(texts)
    assert torch.equal(engine.load_engine(path, aot.tower_params(model_b, "text"))(texts), ref_b)
    ref_a = aot.compile_tower(model_a, "text", 2)(texts)
    assert torch.equal(engine.load_engine(path, aot.tower_params(model_a, "text"))(texts), ref_a)
    assert not torch.allclose(ref_a, ref_b)


def rewrite_header(path, out, **changes):
    """A copy of the engine at ``path`` with header fields replaced (a
    ``meta`` dict is merged into the header's)."""
    with zipfile.ZipFile(path) as z:
        entries = [(i, z.read(i.filename)) for i in z.infolist()]
    with zipfile.ZipFile(out, "w") as z:
        for info, data in entries:
            if info.filename.endswith("/extra/" + engine.HEADER_FILE):
                header = json.loads(data)
                meta = {**header.get("meta", {}), **changes.pop("meta", {})}
                data = json.dumps({**header, **changes, "meta": meta}).encode()
            z.writestr(info, data)
    return out


@pytest.mark.parametrize("field,value", [("torch", "1.0.0"), ("cuda", "11.0"),
                                         ("device_type", "cuda"), ("device_name", "TPU v5e"),
                                         ("capability", "8.0"), ("kernels", "0" * 16)])
def test_engine_header_mismatch(tmp_path, field, value):
    model, path = _build(tmp_path)
    params = aot.tower_params(model, "text")
    bad = rewrite_header(path, str(tmp_path / "bad.engine"), **{field: value})
    assert engine.read_header(bad)[field] == value
    with pytest.raises(ValueError, match=f"{field}=.*rebuild the engine"):
        engine.load_engine(bad, params)
    if field == "device_type":
        return   # a CUDA engine does not run on the CPU, even with a warning
    with pytest.warns(UserWarning, match="rebuild the engine"):
        eng = engine.load_engine(bad, params, strict=False)
    assert torch.isfinite(eng(_texts())).all()


def test_engine_refuses_weights_on_another_device(tmp_path):
    """An engine runs on the device of the weights it is given, and only on
    the device type it was built for: a CPU engine refuses weights on the
    card (fake CUDA tensors here), bound or unbound, even with
    ``strict=False``, rather than moving the card's work to the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model, path = _build(tmp_path)
    params = aot.tower_params(model, "text")
    with FakeTensorMode():
        cuda_params = {k: torch.empty(v.shape, dtype=v.dtype, device="cuda")
                       for k, v in params.items()}
    for strict in (True, False):
        with pytest.raises(ValueError, match="device_type='cpu', the weights lie on cuda"):
            engine.load_engine(path, cuda_params, strict=strict)
    raw = engine.load_engine(path)
    with pytest.raises(ValueError, match="rebuild the engine with --device cuda"):
        raw(cuda_params, _texts())
    split = {**params, "word_embeddings": params["word_embeddings"].to("meta")}
    with pytest.raises(ValueError, match="several devices"):
        engine.load_engine(path, split)


def test_tower_tables_live_as_long_as_their_keeper(monkeypatch):
    """The tower op's pointer tables (``ops/library.py``) are held by the
    graphs and programs that use them, not by an LRU: a table kept by a
    keeper survives any number of other towers' tables (a graph's baked
    addresses stay valid), and a table nobody keeps is released with its
    weights."""
    import gc

    from nans_clip_tpu_torch.ops import library, tower_kernel

    class Table:   # the card's TowerTable, without the card
        pass

    monkeypatch.setattr(tower_kernel, "TowerTable", Table)

    def weights():   # two layers of 12 tensors at new addresses
        return [torch.zeros(4) for _ in range(24)]

    first_w = weights()
    with library.keep_tables() as first:
        _, table = library._tower_table(first_w, False)
        assert library._tower_table(first_w, False)[1] is table   # one build a set of addresses
    assert [e.table for e in first] == [table]
    others = []
    for _ in range(9):
        with library.keep_tables() as kept:
            library._tower_table(weights(), False)
        others.append(kept)
    assert library._tower_table(first_w, False)[1] is table
    n = len(library._TABLES)
    del first, others, kept
    gc.collect()
    assert len(library._TABLES) == n - 10


def test_engine_refuses_other_files_and_weights(tmp_path):
    model, path = _build(tmp_path)
    junk = tmp_path / "junk.engine"
    junk.write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="not a nans-clip-tpu-torch engine"):
        engine.read_header(str(junk))
    pt2 = aot.export_program(model, "text", 2, str(tmp_path / "plain.pt2"))
    with pytest.raises(ValueError, match="not a nans-clip-tpu-torch engine"):
        engine.load_engine(pt2)
    # another width, another tower, another quantize mode: refused by name
    wide = model_from_config(tconfigs.CLIPConfig(
        embed_dim=64, vision=model.cfg.vision,
        text=tconfigs.TextConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                                 intermediate_size=256), name="tiny"), device="cpu")
    with pytest.raises(ValueError, match="weight 'word_embeddings'"):
        engine.load_engine(path, aot.tower_params(wide, "text"))
    with pytest.raises(ValueError, match="differ in"):
        engine.load_engine(path, aot.tower_params(model, "image"))
    with pytest.raises(ValueError, match="differ in"):
        engine.load_engine(path, aot.tower_params(_model(quantize="int8-text"), "text"))


def test_engine_file_holds_no_weights(tmp_path):
    model = _model()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in aot.tower_params(model, "image").values())
    _, path = _build(tmp_path, model, "image", 2)
    with zipfile.ZipFile(path) as z:
        sizes = {i.filename.split("/", 1)[1]: i.file_size for i in z.infolist()}
    assert sizes["data/sample_inputs/model.pt"] == 0
    assert not any(k.startswith(("data/weights/", "data/constants/")) and v > 64
                   for k, v in sizes.items()), sizes
    assert os.path.getsize(path) < weight_bytes, (os.path.getsize(path), weight_bytes)
    # the weights' own bytes are nowhere in the file
    proj = aot.tower_params(model, "image")["proj"].numpy().tobytes()
    assert proj[:256] not in open(path, "rb").read()


def _write_split(root, n=3):
    from PIL import Image

    from nans_clip_tpu_torch.data.npack import NPackWriter

    os.makedirs(root)
    rs = np.random.RandomState(0)
    with NPackWriter(os.path.join(root, "imgs.npack")) as w:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rs.randint(0, 255, (48, 48, 3), np.uint8)).save(
                buf, format="JPEG", quality=95)
            w.put(i, buf.getvalue())


def test_engine_build_cli_and_consumers(tmp_path, capsys):
    """``build`` writes one engine per tower x batch, ``inspect`` prints the
    header, and the consumers run from the files: extract_features
    (``engine`` and ``stablehlo`` equal to ``jit``; 3 rows through batch-2
    artifacts: the final batch padded), speed_benchmark (``aot`` and
    ``engine``), and the refusals of a quantize or batch mismatch."""
    d = str(tmp_path / "engines")
    engine.main(["build", "--tiny-model", "--device", "cpu", "--towers", "text,image",
                 "--batch-sizes", "1,2", "--precision", "fp32", "--out-dir", d])
    for tower in ("text", "image"):
        for bs in (1, 2):
            assert os.path.isfile(engine.engine_path(d, tower, bs))
    engine.main(["inspect", engine.engine_path(d, "text", 2)])
    head = capsys.readouterr().out
    assert f"magic: {engine.MAGIC}" in head and "batch_size: 2" in head
    assert "'tower': 'text'" in head and "device_type: cpu" in head

    txt = tmp_path / "texts.jsonl"
    txt.write_text("".join(json.dumps({"text_id": i, "text": t}) + "\n"
                           for i, t in enumerate(["西湖", "南宋古籍", "皮卡丘"])))
    img_dir = str(tmp_path / "imgs")
    _write_split(img_dir)
    model = _model()
    stable = str(tmp_path / "stable")
    for tower in ("text", "image"):
        aot.export_program(model, tower, 2, os.path.join(stable, f"{tower}.pt2"))
    outs = {}
    for backend, art in (("jit", d), ("engine", d), ("stablehlo", stable)):
        t_out, i_out = str(tmp_path / f"t_{backend}.jsonl"), str(tmp_path / f"i_{backend}.jsonl")
        arts = ([engine.engine_path(art, t, 2) for t in ("text", "image")]
                if backend != "stablehlo" else
                [os.path.join(art, f"{t}.pt2") for t in ("text", "image")])
        extract_features.main([
            "--extract-text-feats", "--extract-image-feats", "--text-data", str(txt),
            "--image-data", img_dir, "--text-feat-output-path", t_out,
            "--image-feat-output-path", i_out, "--text-batch-size", "2", "--img-batch-size",
            "2", "--resume", "", "--tiny-model", "--precision", "fp32", "--platform", "cpu",
            "--backend", backend, "--text-artifact", arts[0], "--image-artifact", arts[1]])
        outs[backend] = [[json.loads(line) for line in open(p)] for p in (t_out, i_out)]
    for backend in ("engine", "stablehlo"):
        for ref, got in zip(outs["jit"], outs[backend]):
            assert [r.get("text_id", r.get("image_id")) for r in ref] == \
                [r.get("text_id", r.get("image_id")) for r in got] and len(ref) == 3
            np.testing.assert_allclose([r["feature"] for r in got], [r["feature"] for r in ref],
                                       atol=1e-6, rtol=0)

    for backend in ("aot", "engine"):
        res = speed_benchmark.main(["--device", "cpu", "--tiny-model", "--precision", "fp32",
                                    "--batch-sizes", "1,2", "--n", "2", "--warmup", "1",
                                    "--backend", backend, "--engine-dir", d])
        assert set(res) == {"image@bs1", "text@bs1", "image@bs2", "text@bs2"}
        assert all(np.isfinite(s["mean"]) for s in res.values())

    # int8 engines: the quantized calling convention survives, and a
    # quantize mismatch fails fast
    qd = str(tmp_path / "engines_q")
    engine.main(["build", "--tiny-model", "--device", "cpu", "--towers", "text,image",
                 "--batch-sizes", "1", "--precision", "fp32", "--quantize", "int8-text",
                 "--out-dir", qd])
    res = speed_benchmark.main(["--device", "cpu", "--tiny-model", "--precision", "fp32",
                                "--batch-sizes", "1", "--n", "2", "--warmup", "1",
                                "--backend", "engine", "--quantize", "int8-text",
                                "--engine-dir", qd])
    assert np.isfinite(res["text@bs1"]["mean"])
    with pytest.raises(SystemExit, match="calling convention"):
        speed_benchmark.main(["--device", "cpu", "--tiny-model", "--precision", "fp32",
                              "--batch-sizes", "1", "--n", "2", "--backend", "engine",
                              "--engine-dir", qd])
    with pytest.raises(SystemExit, match="--quantize int8-text"):
        extract_features.main(["--extract-text-feats", "--text-data", str(txt),
                               "--text-feat-output-path", str(tmp_path / "q.jsonl"),
                               "--text-batch-size", "1", "--resume", "", "--tiny-model",
                               "--precision", "fp32", "--platform", "cpu", "--backend",
                               "engine", "--text-artifact", engine.engine_path(qd, "text", 1)])
    # fixed shapes: a batch size other than the engine's fails fast
    with pytest.raises(SystemExit, match="fixed-shape"):
        extract_features.main(["--extract-text-feats", "--text-data", str(txt),
                               "--text-feat-output-path", str(tmp_path / "x.jsonl"),
                               "--text-batch-size", "3", "--resume", "", "--tiny-model",
                               "--precision", "fp32", "--platform", "cpu", "--backend",
                               "engine", "--text-artifact", engine.engine_path(d, "text", 2)])


def test_engine_cold_load_in_fresh_process(tmp_path):
    """A new process runs the engine without tracing or building the model:
    the model-building modules are never imported there."""
    model, path = _build(tmp_path)
    texts = _texts()
    torch.save({"params": aot.tower_params(model, "text"), "texts": texts,
                "ref": aot.compile_tower(model, "text", 2)(texts)}, tmp_path / "data.pt")
    worker = tmp_path / "worker.py"
    worker.write_text(f'''
import sys
import torch
from nans_clip_tpu_torch.deploy.engine import load_engine

data = torch.load(r"{tmp_path}/data.pt")
eng = load_engine(r"{path}", data["params"])
out = eng(data["texts"])
assert torch.equal(out, data["ref"]), (out - data["ref"]).abs().max()
bad = sorted(m for m in sys.modules if m.startswith(("nans_clip_tpu_torch.models",
                                                      "nans_clip_tpu_torch.api", "jax")))
assert not bad, bad
print("COLD-ENGINE-OK")
''')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, str(worker)], capture_output=True, text=True,
                         env=dict(env, PYTHONPATH=REPO), timeout=300)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert "COLD-ENGINE-OK" in out.stdout


def test_batch_stats_digest():
    assert engine.batch_stats_digest(None) is None and engine.batch_stats_digest({}) is None
    a = engine.batch_stats_digest({"mean": torch.ones(3), "var": torch.zeros(3)})
    assert a == engine.batch_stats_digest([torch.ones(3), torch.zeros(3)])
    assert a != engine.batch_stats_digest({"mean": torch.ones(3), "var": torch.ones(3)})


def test_kernel_digest_covers_sources_and_flags(monkeypatch):
    from nans_clip_tpu_torch.ops import _build

    a = engine.kernel_digest()
    assert a == engine.kernel_digest() and len(a) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert engine.kernel_digest() != a


def test_tower_params_in_bf16():
    """A bf16 model's program inputs: the weights in bf16, the plain
    LayerNorm's params in fp32."""
    m = model_from_config(tconfigs.tiny_config(), seed=0, device="cpu",
                          options=ModelOptions(compute_dtype="bfloat16"))
    p = aot.tower_params(m, "text")
    assert p["layers.0.qkv.weight"].dtype == torch.bfloat16
    assert p["ln.weight"].dtype == torch.float32


def test_resnet_engine_records_and_checks_its_statistics(tmp_path, monkeypatch):
    """An RN50 image engine (the tiny RN config of tests/test_torch_resnet.py
    in its place) records the digest of its checkpoint's BatchNorm running
    statistics; ``extract_features --backend engine`` and the daemon accept
    it for that checkpoint, with the eager tower's features, and refuse it
    for a checkpoint whose statistics moved (one train step), as the JAX
    engine consumers do."""
    from nans_clip_tpu_torch.deploy.server import ClipService
    from nans_clip_tpu_torch.eval import model_io
    from nans_clip_tpu_torch.models.clip import batch_stats
    from nans_clip_tpu_torch.training import trainer
    from test_torch_resnet import serve_tiny_rn

    serve_tiny_rn(monkeypatch, model_io)
    rn = ["--vision-model", "RN50", "--text-model", "RBT3-chinese", "--precision", "fp32"]
    d = str(tmp_path / "engines")
    engine.main(["build", *rn, "--device", "cpu", "--towers", "image,text", "--batch-sizes", "2",
                 "--out-dir", d])
    model = model_io.load_eval_model("RN50", "RBT3-chinese", "", "fp32", device="cpu")
    meta = engine.read_header(engine.engine_path(d, "image", 2))["meta"]
    assert meta["batch_stats_digest"] == engine.batch_stats_digest(batch_stats(model.module))
    assert meta["batch_stats_digest"] is not None
    assert engine.read_header(engine.engine_path(d, "text", 2))["meta"]["batch_stats_digest"] \
        is None
    images = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32))
    eng = engine.load_engine(engine.engine_path(d, "image", 2),
                             aot.tower_params(model, "image"))
    assert torch.allclose(eng(images), aot.normalized(model.encode_image(images)), atol=1e-6)

    img_dir = str(tmp_path / "imgs")
    _write_split(img_dir)
    argv = ["--extract-image-feats", "--image-data", img_dir, "--img-batch-size", "2", *rn,
            "--platform", "cpu", "--backend", "engine",
            "--image-artifact", engine.engine_path(d, "image", 2)]
    out = {}
    for backend in ("engine", "jit"):
        path = str(tmp_path / f"{backend}.jsonl")
        extract_features.main([*argv[:-4], "--backend", backend, *argv[-2:], "--resume", "",
                               "--image-feat-output-path", path])
        out[backend] = [json.loads(line)["feature"] for line in open(path)]
    np.testing.assert_allclose(out["engine"], out["jit"], atol=1e-6, rtol=0)
    assert ClipService(model, engine_dir=d).backend == "engine"

    # one train step moves the statistics: the engine is refused for it
    tcfg = trainer.TrainConfig(lr=1e-3, warmup=1)
    state = trainer.create_train_state(model_io.load_eval_model(
        "RN50", "RBT3-chinese", "", "fp32", device="cpu").module, tcfg, "cpu")
    state, _ = trainer.make_train_step(state.module.cfg, tcfg, ModelOptions(deterministic=False))(
        state, images.repeat(2, 1, 1, 1), _texts(4), 0)
    ckpt = str(tmp_path / "moved.pt")
    torch.save({"state_dict": state.module.state_dict()}, ckpt)
    with pytest.raises(SystemExit, match="BN running stats"):
        extract_features.main([*argv, "--resume", ckpt,
                               "--image-feat-output-path", str(tmp_path / "x.jsonl")])
    moved = model_io.load_eval_model("RN50", "RBT3-chinese", ckpt, "fp32", device="cpu")
    with pytest.raises(ValueError, match="batch_stats_digest"):
        ClipService(moved, engine_dir=d)
