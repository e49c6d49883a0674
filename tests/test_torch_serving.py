"""The port's serving daemon (``nans_clip_tpu_torch/deploy/server.py``) and
latency CLI (``deploy/speed_benchmark.py``) on the CPU, mirroring
``tests/test_server.py``: bucketing, padding and chunking, dynamic batching,
the HTTP endpoints and their errors, and features against the JAX daemon on
the same tiny weights.

Tolerances: 1e-5 between two runs of the port's own fp32 path (batching
only regroups rows; each row's arithmetic is the same up to fp32 sum order
over batch-dependent kernels), 2e-4 against the JAX daemon (the slice
tolerance of ``tests/test_torch_slice.py``; both in fp32)."""

import base64
import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch.api import model_from_config
from nans_clip_tpu_torch.deploy import speed_benchmark
from nans_clip_tpu_torch.deploy.server import ClipService, _bucket, make_server

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _model():
    return model_from_config(tconfigs.tiny_config(), seed=0, device="cpu")


def _jpeg_b64(rs, size=48, urlsafe=False):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 255, (size, size, 3), np.uint8)).save(buf, format="JPEG",
                                                                         quality=95)
    enc = base64.urlsafe_b64encode if urlsafe else base64.b64encode
    return enc(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def service():
    return ClipService(_model(), max_batch=4)


@pytest.fixture(scope="module")
def server(service):
    srv = make_server(service, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _post(url, path, obj):
    req = urllib.request.Request(url + path, json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def test_bucket():
    assert [_bucket(n, 32) for n in (1, 2, 3, 5, 8, 9, 32, 33, 100)] == \
        [1, 2, 4, 8, 8, 16, 32, 32, 32]
    assert _bucket(3, 4) == 4 and _bucket(7, 4) == 4


def test_health(server):
    with urllib.request.urlopen(server + "/health") as r:
        obj = json.loads(r.read())
    assert obj["status"] == "ok" and obj["backend"] == "jit" and obj["device"] == "cpu"
    assert obj["model"] == "tiny" and obj["dynamic_batching"] is True


def test_encode_text_matches_direct(server, service):
    texts = ["西湖美景", "南宋古籍", "一只皮卡丘"]
    feats = np.asarray(_post(server, "/encode_text", {"texts": texts})["features"], np.float32)
    assert feats.shape == (3, service.cfg.embed_dim)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(feats, service.encode_texts(texts), **TOL)
    # and the model's own features, normalised
    from nans_clip_tpu_torch.tokenizer import tokenize
    direct = service.model.encode_text(tokenize(texts)).numpy()
    np.testing.assert_allclose(feats, direct / np.linalg.norm(direct, axis=-1, keepdims=True),
                               **TOL)


def test_encode_image_and_similarity(server, service):
    rs = np.random.RandomState(0)
    imgs = [_jpeg_b64(rs), _jpeg_b64(rs, urlsafe=True)]
    feats = np.asarray(_post(server, "/encode_image", {"images": imgs})["features"], np.float32)
    assert feats.shape == (2, service.cfg.embed_dim)
    np.testing.assert_allclose(feats, service.encode_images(imgs), **TOL)
    sim = _post(server, "/similarity", {"images": imgs, "texts": ["山水画", "佛经", "地图"]})
    probs = np.asarray(sim["probs"], np.float32)
    assert probs.shape == (2, 3)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert np.isfinite(np.asarray(sim["logits_per_image"], np.float32)).all()


def test_batch_padding_and_chunking(service):
    """5 texts through max_batch=4: one batch-4 call and one padded call,
    equal to one text at a time."""
    texts = [f"文本{i}" for i in range(5)]
    calls = []
    real = service.model.encode_text

    def spy(x):
        calls.append(len(x))
        return real(x)

    service.model.encode_text = spy
    try:
        feats = ClipService(service.model, max_batch=4, dynamic_batching=False).encode_texts(texts)
    finally:
        service.model.encode_text = real
    assert calls == [4, 4]      # 5 = 4 + (1 padded to 4)
    one_by_one = np.concatenate([service.encode_texts([t]) for t in texts])
    np.testing.assert_allclose(feats, one_by_one, **TOL)


def test_error_paths(server):
    for path, body, frag in [("/encode_text", {}, "texts"),
                             ("/encode_image", {"images": ["!!notb64!!"]}, "cannot decode"),
                             ("/nope", {"texts": []}, "unknown path")]:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, path, body)
        assert e.value.code in (400, 404)
        assert frag in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope")
    assert e.value.code == 404


def test_empty_requests(server):
    assert _post(server, "/encode_image", {"images": []})["features"] == []
    assert _post(server, "/encode_text", {"texts": []})["features"] == []
    sim = _post(server, "/similarity", {"images": [], "texts": ["一"]})
    assert sim["probs"] == [] and sim["logits_per_image"] == []


def test_stats_endpoint(server):
    with urllib.request.urlopen(server + "/stats") as r:
        before = json.loads(r.read())
    for key in ("requests", "samples", "device_dispatches", "device_ms_total",
                "coalesced_requests", "errors"):
        assert key in before, key
    _post(server, "/encode_text", {"texts": ["统计端点", "第二条"]})
    with pytest.raises(urllib.error.HTTPError):
        _post(server, "/encode_text", {"bad_key": []})
    with urllib.request.urlopen(server + "/stats") as r:
        after = json.loads(r.read())
    assert after["requests"]["text"] == before["requests"]["text"] + 1
    assert after["samples"]["text"] == before["samples"]["text"] + 2
    assert after["device_dispatches"] > before["device_dispatches"]
    assert after["device_ms_total"] > before["device_ms_total"]
    assert after["errors"] == before["errors"] + 1


def test_oversized_body_rejected_413():
    svc = ClipService(_model(), max_batch=2, dynamic_batching=False)
    srv = make_server(svc, "127.0.0.1", 0, max_body_bytes=1024)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        req = urllib.request.Request(url + "/encode_text",
                                     json.dumps({"texts": ["x" * 4096]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 413
        assert len(_post(url, "/encode_text", {"texts": ["ok"]})["features"]) == 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_concurrent_requests_roundtrip(server, service):
    texts = [f"并发请求{i}" for i in range(6)]
    results = {}

    def post(i):
        results[i] = np.asarray(_post(server, "/encode_text", {"texts": [texts[i]]})["features"],
                                np.float32)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    for i in range(6):
        np.testing.assert_allclose(results[i], service.encode_texts([texts[i]]), **TOL)


# -- dynamic batching ----------------------------------------------------------

def _gated_service(max_batch=8):
    """A fresh service whose _run_device records (tower, n) a call and holds
    the FIRST call on a gate, so that later requests must queue."""
    svc = ClipService(_model(), max_batch=max_batch)
    real = svc._run_device
    calls = []
    gate, first_in = threading.Event(), threading.Event()

    def wrapped(tower, x):
        calls.append((tower, x.shape[0]))
        if len(calls) == 1:
            first_in.set()
            assert gate.wait(30), "test gate never released"
        return real(tower, x)

    svc._run_device = wrapped
    return svc, calls, gate, first_in


def _wait_queue(svc, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while len(svc._queue) < n:
        assert time.monotonic() < deadline, f"queue never reached {n} (at {len(svc._queue)})"
        time.sleep(0.005)


def _join(threads):
    for t in threads:
        t.join(60)
        assert not t.is_alive()


def test_dynamic_batching_coalesces_concurrent_requests():
    svc, calls, gate, first_in = _gated_service()
    texts = [f"动态批处理{i}" for i in range(5)]
    results = {}

    def post(i):
        results[i] = svc.encode_texts([texts[i]])

    threads = [threading.Thread(target=post, args=(0,))]
    threads[0].start()
    assert first_in.wait(30)
    for i in range(1, 5):
        threads.append(threading.Thread(target=post, args=(i,)))
        threads[-1].start()
    _wait_queue(svc, 4)
    gate.set()
    _join(threads)
    assert [n for _, n in calls] == [1, 4], calls
    assert svc.stats["coalesced_requests"] == 4
    direct = ClipService(svc.model, max_batch=8, dynamic_batching=False)
    for i in range(5):
        np.testing.assert_allclose(results[i], direct.encode_texts([texts[i]]), **TOL)


def test_dynamic_batching_coalesces_only_same_tower_runs():
    img = _jpeg_b64(np.random.RandomState(0))
    svc, calls, gate, first_in = _gated_service()
    results = {}

    def post_text(i):
        results[i] = svc.encode_texts([f"塔{i}"])

    def post_image(i):
        results[i] = svc.encode_images([img])

    threads = [threading.Thread(target=post_text, args=(0,))]
    threads[0].start()
    assert first_in.wait(30)
    for n, t in enumerate([threading.Thread(target=post_text, args=(1,)),
                           threading.Thread(target=post_text, args=(2,)),
                           threading.Thread(target=post_image, args=(3,)),
                           threading.Thread(target=post_text, args=(4,))]):
        t.start()
        threads.append(t)
        _wait_queue(svc, n + 1)
    gate.set()
    _join(threads)
    assert calls == [("text", 1), ("text", 2), ("image", 1), ("text", 1)], calls
    direct = ClipService(svc.model, max_batch=8, dynamic_batching=False)
    for i in (0, 1, 2, 4):
        np.testing.assert_allclose(results[i], direct.encode_texts([f"塔{i}"]), **TOL)
    np.testing.assert_allclose(results[3], direct.encode_images([img]), **TOL)


def test_dynamic_batching_respects_coalesce_cap():
    svc, calls, gate, first_in = _gated_service(max_batch=2)
    threads = [threading.Thread(target=svc.encode_texts, args=(["首个"],))]
    threads[0].start()
    assert first_in.wait(30)
    for i in range(5):
        t = threading.Thread(target=svc.encode_texts, args=([f"排{i}"],))
        t.start()
        threads.append(t)
        _wait_queue(svc, i + 1)
    gate.set()
    _join(threads)
    assert calls[0] == ("text", 1)
    assert all(n <= 2 for _, n in calls[1:])
    assert sum(n for _, n in calls[1:]) == 5


def test_dynamic_batching_scatters_device_errors():
    svc, calls, gate, first_in = _gated_service()

    def boom(tower, x):
        raise ValueError("device exploded")

    errs = {}

    def post(i):
        try:
            svc.encode_texts([f"错{i}"])
        except ValueError as e:
            errs[i] = str(e)

    t0 = threading.Thread(target=post, args=(0,))
    t0.start()
    assert first_in.wait(30)
    svc._run_device = boom            # swap under the blocked first call
    t1 = threading.Thread(target=post, args=(1,))
    t2 = threading.Thread(target=post, args=(2,))
    t1.start()
    t2.start()
    _wait_queue(svc, 2)
    gate.set()
    _join((t0, t1, t2))
    assert errs.get(1) == "device exploded" and errs.get(2) == "device exploded"
    assert 0 not in errs


def test_features_match_jax_daemon():
    """The port's daemon and the JAX daemon (its live backend) on the same
    tiny weights, both in fp32."""
    from nans_clip_tpu.configs import tiny_config as jtiny
    from nans_clip_tpu.deploy.server import ClipService as JService
    from nans_clip_tpu.models import ModelOptions as JOptions
    from nans_clip_tpu.models.clip import init_clip
    from nans_clip_tpu_torch.api import CLIPModel
    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.utils.torch_interop import state_dict_from_jax_params

    jcfg = jtiny()
    params, stats = init_clip(jax.random.PRNGKey(0), jcfg)
    jsvc = JService(jcfg, params, stats, JOptions(attn_impl="xla", compute_dtype=None),
                    max_batch=4, dynamic_batching=False, native_decode=False)
    cfg = tconfigs.CLIPConfig(embed_dim=jcfg.embed_dim,
                              vision=tconfigs.VisionConfig(**dataclasses.asdict(jcfg.vision)),
                              text=tconfigs.TextConfig(**dataclasses.asdict(jcfg.text)),
                              name=jcfg.name)
    module = build_clip(cfg)
    module.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg))
    svc = ClipService(CLIPModel(cfg, module), max_batch=4, dynamic_batching=False)
    texts = ["西湖美景", "“引号”与ABC", "一只皮卡丘", "南宋", "第五条"]
    np.testing.assert_allclose(svc.encode_texts(texts), jsvc.encode_texts(texts),
                               atol=2e-4, rtol=2e-4)
    imgs = [_jpeg_b64(np.random.RandomState(3))]
    np.testing.assert_allclose(svc.encode_images(imgs), jsvc.encode_images(imgs),
                               atol=2e-4, rtol=2e-4)


def test_speed_benchmark_cli_on_cpu(tmp_path):
    out = tmp_path / "speed.json"
    res = speed_benchmark.main(["--device", "cpu", "--tiny-model", "--precision", "fp32",
                                "--batch-sizes", "1,2", "--n", "3", "--warmup", "1",
                                "--json-output", str(out)])
    saved = json.loads(out.read_text())
    assert set(saved) == {"image@bs1", "text@bs1", "image@bs2", "text@bs2"} == set(res)
    for s in saved.values():
        assert set(s) == {"mean", "std", "min", "max", "median", "p95", "p99", "ms_per_sample",
                          "samples_per_sec"}
        assert s["min"] <= s["median"] <= s["max"] and s["mean"] > 0
    q = speed_benchmark.main(["--device", "cpu", "--tiny-model", "--precision", "fp32",
                              "--quantize", "int8-text", "--batch-sizes", "1", "--n", "2",
                              "--warmup", "0"])
    assert set(q) == {"image@bs1", "text@bs1"}


# -- the engine backend ----------------------------------------------------------

def _build_engines(d, towers="text,image", batch_sizes="2", extra=()):
    from nans_clip_tpu_torch.deploy import engine

    engine.main(["build", "--tiny-model", "--device", "cpu", "--towers", towers,
                 "--batch-sizes", batch_sizes, "--precision", "fp32", "--out-dir", d, *extra])


def test_engine_backend_matches_jit(tmp_path, service):
    """Engines built by the CLI, served with no capture or export in the
    service: 3 texts through batch-2 engines (padded and chunked) equal the
    jit backend's features."""
    d = str(tmp_path / "engines")
    _build_engines(d)
    eng_service = ClipService(_model(), max_batch=4, engine_dir=d)
    assert eng_service._engine_batch == {"text": 2, "image": 2}
    assert eng_service.backend == "engine" and eng_service._coalesce_cap("text") == 2
    texts = ["西湖", "南宋", "古籍"]
    np.testing.assert_allclose(eng_service.encode_texts(texts), service.encode_texts(texts),
                               **TOL)
    imgs = [_jpeg_b64(np.random.RandomState(1))]
    np.testing.assert_allclose(eng_service.encode_images(imgs), service.encode_images(imgs),
                               **TOL)
    # no tower was added beside the engines
    assert set(eng_service._fns) == {("text", 2), ("image", 2)}
    srv = make_server(eng_service, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/health") as r:
            assert json.loads(r.read())["backend"] == "engine"
        feats = np.asarray(_post(url, "/encode_text", {"texts": texts})["features"], np.float32)
        np.testing.assert_allclose(feats, service.encode_texts(texts), **TOL)
    finally:
        srv.shutdown()
        srv.server_close()
    # the service reads its quantize mode from the model's weights: int8-text
    # engines serve an int8-text model, and a mismatch either way fails at
    # startup, not at request time
    q_model = _model().quantize("int8", ("text",))
    qd = str(tmp_path / "engines_q")
    _build_engines(qd, towers="text", extra=("--quantize", "int8-text"))
    q_service = ClipService(q_model, max_batch=4, engine_dir=qd)
    np.testing.assert_allclose(q_service.encode_texts(texts),
                               ClipService(q_model, max_batch=4).encode_texts(texts), **TOL)
    with pytest.raises(ValueError, match="quantize: built None, server has int8-text"):
        ClipService(q_model, engine_dir=d)
    with pytest.raises(ValueError, match="quantize: built int8-text, server has None"):
        ClipService(_model(), engine_dir=qd)


def test_server_rejects_mismatched_engine_headers(tmp_path):
    """Every convention the header records fails fast at startup: model
    name, text context length, the BatchNorm-statistics digest; the batch
    size comes from the header, not the file name."""
    import os
    import shutil

    from nans_clip_tpu_torch.deploy import engine
    from tests.test_torch_engine import rewrite_header

    d = str(tmp_path / "engines")
    _build_engines(d, towers="text")

    def corrupt(key, value):
        dd = str(tmp_path / f"bad_{key}")
        os.makedirs(dd)
        rewrite_header(engine.engine_path(d, "text", 2), engine.engine_path(dd, "text", 2),
                       meta={key: value})
        return dd

    for key, value, frag in [("model", "ViT-H-14@RoBERTa-wwm-ext-large-chinese", "model"),
                             ("context_length", 64, "context_length"),
                             ("batch_stats_digest", "deadbeef", "BN running stats")]:
        with pytest.raises(ValueError, match=frag):
            ClipService(_model(), engine_dir=corrupt(key, value))
    dd = str(tmp_path / "renamed")
    shutil.copytree(d, dd)
    os.rename(engine.engine_path(dd, "text", 2), engine.engine_path(dd, "text", 8))
    svc = ClipService(_model(), engine_dir=dd)
    assert set(svc._fns) == {("text", 2)}
    with pytest.raises(ValueError, match="no engine for the image tower"):
        svc.encode_images([_jpeg_b64(np.random.RandomState(2))])
    with pytest.raises(ValueError, match="no .* files"):
        ClipService(_model(), engine_dir=str(tmp_path))


def test_jit_backend_on_cpu_runs_live(service):
    """On the CPU the jit backend runs the towers eagerly: no graph, no
    captured tower kept."""
    service.encode_texts(["一"])
    assert service.backend == "jit" and not service._fns
