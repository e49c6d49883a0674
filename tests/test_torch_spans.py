"""The port's span recorder (``nans_clip_tpu_torch/utils/profiling.py``) on
the CPU: nothing recorded without a profiler; under one, the train step's
spans nested as ``training/trainer.py`` documents them, the towers' and
the casts' inside them, host stamps on the profiler's own clock; the
benchmark's readers of the spans and of the library counter on planted
records; the CUDA event pool (on fake events): made before a window,
short spans read no device time, refilled after; and ``profile_slice``'s
idle gaps put under the innermost span and kernels under the spans that
launched them.
The device half (a kernel's CUPTI interval inside its span) is
``tests/test_torch_cuda.py::test_span_holds_its_kernel_on_the_profiler_clock``.
"""

import logging
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nans_clip_tpu_torch import configs as tconfigs
from nans_clip_tpu_torch import profile_slice
from nans_clip_tpu_torch.models.clip import build_clip
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.ops import _build
from nans_clip_tpu_torch.training import trainer
from nans_clip_tpu_torch.utils import profiling
from nans_clip_tpu_torch.utils.profiling import SpanRecord, SpanRecorder
from perfbench import harness

torch.set_num_threads(2)

STEP_CHILDREN = ("train.prepare", "train.forward", "train.backward", "train.optimizer")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def recorder():
    profiling.clear()
    yield profiling
    profiling.clear()


def _tiny_step(accum: int = 1):
    cfg = tconfigs.tiny_config()
    tcfg = trainer.TrainConfig(lr=1e-3, warmup=2, max_steps=10, accum_freq=accum)
    state = trainer.create_train_state(build_clip(cfg, "cpu", torch.Generator().manual_seed(0)),
                                       tcfg, device="cpu")
    step = trainer.make_train_step(cfg, tcfg, ModelOptions(deterministic=False))
    gen = torch.Generator().manual_seed(1)
    r = cfg.vision.image_resolution
    images = torch.randn(4, r, r, 3, generator=gen)
    texts = torch.randint(1, cfg.text.vocab_size, (4, 12), generator=gen)
    return cfg, state, step, images, texts


def test_off_the_span_is_the_shared_null_context(recorder):
    first, second = recorder.span("a"), recorder.span("b", 3)
    assert first is second is profiling._NULL
    with first:
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    assert recorder.spans() == []


def test_off_the_span_reads_no_clock(recorder, monkeypatch):
    def no_clock():
        raise AssertionError("the off path read the clock")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    with recorder.span("train.step", 0):
        with recorder.span("train.forward"):
            pass
    assert recorder.spans() == []


def test_a_train_step_records_its_phases_under_its_root(recorder):
    cfg, state, step, images, texts = _tiny_step()
    step(state, images, texts, 0)          # warm-up, unrecorded
    assert recorder.spans() == []
    with _cpu_profile():
        step(state, images, texts, 1)
    recs = recorder.spans()
    roots = [i for i, r in enumerate(recs) if r.name == "train.step"]
    assert len(roots) == 1 and recs[roots[0]].parent is None and recs[roots[0]].id == 1
    root = recs[roots[0]]
    kids = [r for r in recs if r.parent == roots[0]]
    assert tuple(r.name for r in kids) == STEP_CHILDREN     # no group: no train.grad_sync
    for r in recs:
        assert r.end_ns is not None and r.device_ms is None
        if r.parent is not None:
            up = recs[r.parent]
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns, (r, up)
    assert sum(k.host_ms for k in kids) >= 0.95 * root.host_ms
    assert state.step == 2


def test_the_towers_and_their_casts_nest_in_the_forward(recorder):
    cfg, state, step, images, texts = _tiny_step()
    with _cpu_profile():
        step(state, images, texts, 0)
    recs = recorder.spans()
    forward = next(i for i, r in enumerate(recs) if r.name == "train.forward")
    towers = {r.name: i for i, r in enumerate(recs) if r.parent == forward}
    assert set(towers) == {"model.encode_image", "model.encode_text"}
    casts = [recs[r.parent].name for r in recs if r.name == "model.cast"]
    # one cast a ViT forward, one a BERT layer
    assert casts.count("model.encode_image") == 1
    assert casts.count("model.encode_text") == cfg.text.num_hidden_layers
    assert [r.id for r in recs if r.name == "model.cast"] == list(range(len(casts)))


def test_an_accumulated_step_encodes_again_in_its_backward(recorder):
    _, state, step, images, texts = _tiny_step(accum=2)
    with _cpu_profile():
        step(state, images, texts, 0)
    recs = recorder.spans()
    under = {}
    for r in recs:
        if r.name == "model.encode_image":
            under.setdefault(recs[r.parent].name, []).append(r)
    assert {k: len(v) for k, v in under.items()} == {"train.forward": 2, "train.backward": 2}
    totals = profiling.span_totals(recs)
    assert totals["train.forward"]["calls"] == totals["train.backward"]["calls"] == 1


def test_a_span_holds_its_op_on_the_profilers_clock(recorder):
    a = torch.randn(256, 256)
    with _cpu_profile() as prof:
        for _ in range(5):
            with recorder.span("clock.mm"):
                torch.mm(a, a)
    mms = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    marks = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock.mm"]
    recs = recorder.spans()
    assert len(mms) == len(marks) == len(recs) == 5
    for r, mm, mark in zip(recs, mms, marks):
        for e in (mm, mark):      # the op and the span's own record_function
            assert r.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= r.end_ns


def test_a_span_takes_its_parent_from_its_own_thread(recorder):
    seen = []

    def work():
        with recorder.span("other.inner"):
            seen.append(1)

    with _cpu_profile():
        with recorder.span("main.outer"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            with recorder.span("main.inner"):
                pass
    assert not t.is_alive() and len(seen) == 1
    recs = recorder.spans()
    parents = {r.name: r.parent for r in recs}
    assert parents == {"main.outer": None, "other.inner": None, "main.inner": 0}


def test_the_buffer_is_bounded():
    rec = SpanRecorder(capacity=3)
    with _cpu_profile() as prof:
        for i in range(5):
            with rec.span("bounded", i):
                pass
    assert [r.id for r in rec.spans()] == [0, 1, 2]
    # past the bound a span still marks the chrome trace
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("bounded") == 5
    rec.clear()
    assert rec.spans() == []


def test_span_totals_take_the_children_out_of_self_time():
    ms = 1_000_000
    recs = [SpanRecord("train.step", 0, None, 0, 10 * ms, 9.0),
            SpanRecord("train.forward", 0, 0, 1 * ms, 4 * ms, 3.5),
            SpanRecord("model.cast", 0, 1, 1 * ms, 2 * ms, None),
            SpanRecord("train.backward", 0, 0, 4 * ms, 9 * ms, 5.0),
            SpanRecord("train.step", 1, None, 10 * ms, 12 * ms, None),
            SpanRecord("train.optimizer", 0, None, 12 * ms, None, None)]
    recs[4] = recs[4]._replace(device_ms=2.0)
    t = profiling.span_totals(recs)
    assert t["train.step"] == {"calls": 2, "host_ms": 12.0, "self_ms": 4.0, "device_ms": 11.0}
    assert t["train.forward"] == {"calls": 1, "host_ms": 3.0, "self_ms": 2.0, "device_ms": 3.5}
    assert t["model.cast"]["device_ms"] is None and "train.optimizer" not in t


def _planted():
    """Two train steps (host 100 and 80 ms) and three tower calls."""
    ms = 1_000_000
    recs = []
    for k, (t0, host, fwd, bwd) in enumerate(((0, 100, 30.0, 50.0), (100, 80, 34.0, 54.0))):
        root = len(recs)
        recs += [SpanRecord("train.step", k, None, t0 * ms, (t0 + host) * ms, host - 5.0),
                 SpanRecord("train.forward", k, root, t0 * ms, (t0 + 30) * ms, fwd),
                 SpanRecord("model.cast", 2 * k, root + 1, t0 * ms, (t0 + 1) * ms, 1.0),
                 SpanRecord("model.cast", 2 * k + 1, root + 1, (t0 + 2) * ms, (t0 + 3) * ms, 3.0),
                 SpanRecord("train.backward", k, root, (t0 + 30) * ms, (t0 + 70) * ms, bwd)]
    for k, (image, text) in enumerate(((24.0, 7.0), (25.0, 8.0), (26.0, 6.0))):
        t0 = 200 + 40 * k
        recs += [SpanRecord("model.encode_image", k, None, t0 * ms, (t0 + 20) * ms, image),
                 SpanRecord("model.encode_text", k, None, (t0 + 20) * ms, (t0 + 30) * ms, text)]
    return recs


@pytest.mark.parametrize("metric,want", [("train.host_ms", 90.0), ("embed.image_ms", 25.0),
                                         ("embed.text_ms", 7.0)])
def test_span_readers_on_planted_spans(monkeypatch, metric, want):
    monkeypatch.setattr(profiling, "spans", _planted)
    assert harness.reader(metric).read({}, None) == pytest.approx(want)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert harness.reader(metric).read({}, None) is None


@pytest.mark.parametrize("metric", ["embed.text_ms", "embed.image_ms"])
def test_device_readers_read_none_from_a_cpu_run(monkeypatch, metric):
    """Spans recorded without a card carry no device time: no number goes
    under a device metric."""
    monkeypatch.setattr(profiling, "spans",
                        lambda: [r._replace(device_ms=None) for r in _planted()])
    assert harness.reader(metric).read({}, None) is None


def test_library_reader_reads_the_load_counter(monkeypatch):
    monkeypatch.setattr(_build, "LOAD", _build.LibraryLoad())
    reader = harness.reader("setup.library_s")
    assert reader.read({}, None) is None
    monkeypatch.setattr(_build, "LOAD", _build.LibraryLoad(nvcc_runs=5, seconds=93.5))
    assert reader.read({}, None) == 93.5


def test_idle_gaps_go_under_the_innermost_span():
    ms = 1_000_000
    kernels = [(0, 2 * ms), (1 * ms, 3 * ms), (5 * ms, 6 * ms), (9 * ms, 12 * ms)]
    gaps = profile_slice.idle_gaps(kernels, 0, 11 * ms)
    assert gaps == [(3 * ms, 5 * ms), (6 * ms, 9 * ms)]
    half = ms // 2
    recs = [SpanRecord("train.step", 0, None, 0, 8 * ms, None),
            SpanRecord("train.forward", 0, 0, 0, 4 * ms + half, None),
            SpanRecord("model.cast", 0, 1, 3 * ms + half, 4 * ms + half, None),
            SpanRecord("train.optimizer", 0, 0, 4 * ms + half, 8 * ms, None),
            SpanRecord("open", 0, None, 4 * ms, None, None)]          # still open: none
    # gap 3-5 ms (mid 4): model.cast, the latest of three to start; 6-9 ms (mid 7.5):
    # the optimizer; the step holds both
    assert profile_slice.idle_by_span(gaps, recs) == {"model.cast": 2 * ms,
                                                      "train.optimizer": 3 * ms}
    table = profile_slice.span_table(recs, gaps + [(10 * ms, 11 * ms)], 1)
    assert table["spans"][profile_slice.OUTSIDE]["idle_ms"] == pytest.approx(1.0)
    assert table["spans"]["train.optimizer"]["idle_ms"] == pytest.approx(3.0)
    assert table["idle_ms"] == pytest.approx(6.0)
    assert table["idle_named_share"] == pytest.approx(5.0 / 6.0)


def test_a_partly_timed_name_reads_no_device_time(monkeypatch):
    """A span that found the event pool empty has no device time: its name
    then sums none, and its reader reads None rather than low."""
    ms = 1_000_000
    recs = [SpanRecord("model.encode_image", k, None, 20 * k * ms, (20 * k + 10) * ms, dev)
            for k, dev in enumerate((24.0, 25.0, None))]
    recs.append(SpanRecord("model.encode_text", 0, None, 70 * ms, 80 * ms, 7.0))
    t = profiling.span_totals(recs)
    assert t["model.encode_image"]["device_ms"] is None
    assert t["model.encode_image"]["calls"] == 3 and t["model.encode_text"]["device_ms"] == 7.0
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    assert harness.reader("embed.image_ms").read({}, None) is None
    assert harness.reader("embed.text_ms").read({}, None) == pytest.approx(7.0)


def test_importing_the_recorder_leaves_torchs_profiler_alone():
    from torch.autograd import profiler as autograd_profiler

    start = autograd_profiler._run_on_profiler_start
    assert (start.__module__, start.__name__) == ("torch.autograd.profiler",
                                                  "_run_on_profiler_start")


def test_reserve_without_a_cuda_context_makes_nothing():
    rec = SpanRecorder(pool_events=8)
    rec.reserve()
    assert rec._pool is None and rec._made == 0


class _FakeEvent:
    """A CUDA event stand-in: ``record`` stamps a counter; the elapsed time
    between two is the difference in ms."""
    made = 0
    clock = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.at = None

    def record(self):
        _FakeEvent.clock += 1
        self.at = _FakeEvent.clock

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.fixture
def fake_cuda(monkeypatch):
    _FakeEvent.made = _FakeEvent.clock = 0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    return _FakeEvent


def _window(rec, n):
    with _cpu_profile():
        for i in range(n):
            with rec.span("pooled", i):
                pass


def test_a_reserved_pool_makes_no_event_in_the_window(fake_cuda):
    rec = SpanRecorder(pool_events=8)
    rec.reserve()
    assert fake_cuda.made == rec._made == 8
    rec.reserve()                       # made once
    assert fake_cuda.made == 8
    _window(rec, 4)
    assert fake_cuda.made == 8
    recs = rec.spans()
    assert [r.device_ms for r in recs] == [1.0] * 4
    assert len(rec._pool) == 8          # every event back in the pool


def test_spans_past_the_pool_read_none_and_the_pool_grows_after(fake_cuda):
    rec = SpanRecorder(pool_events=4)
    rec.reserve()
    _window(rec, 3)                     # two spans take the four events
    assert fake_cuda.made == 4
    recs = rec.spans()
    assert [r.device_ms is None for r in recs] == [False, False, True]
    assert profiling.span_totals(recs)["pooled"]["device_ms"] is None
    assert rec._made == 6               # grown by the shortfall, outside the window
    rec.clear()
    _window(rec, 3)
    assert fake_cuda.made == 6
    assert all(r.device_ms == 1.0 for r in rec.spans())


def test_kernels_go_under_every_span_that_launched_them():
    ms = 1_000_000
    recs = [SpanRecord("train.step", 0, None, 0, 10 * ms, None),
            SpanRecord("train.forward", 0, 0, 0, 4 * ms, None),
            SpanRecord("model.cast", 0, 1, 1 * ms, 2 * ms, None),
            SpanRecord("train.backward", 0, 0, 4 * ms, 9 * ms, None),
            SpanRecord("open", 0, None, 0, None, None)]                 # still open: none
    # (name, device start, device end, correlation id): the device runs late
    device = [("cast", 5 * ms, 6 * ms, 1), ("gemm", 6 * ms, 9 * ms, 2),
              ("dgemm", 9 * ms, 15 * ms, 3), ("adam", 15 * ms, 16 * ms, 4),
              ("lost", 16 * ms, 17 * ms, 99)]                           # no launch: none
    starts = {1: 1 * ms + 10, 2: 3 * ms, 3: 5 * ms, 4: 9 * ms + 500_000}
    assert profile_slice.launched_by_span(device, starts, recs) == {
        "train.step": 11 * ms, "train.forward": 4 * ms, "model.cast": 1 * ms,
        "train.backward": 6 * ms}
    table = profile_slice.span_table(recs, [], 2, profile_slice.launched_by_span(device, starts,
                                                                                 recs))
    assert table["spans"]["train.backward"]["kernel_ms"] == pytest.approx(3.0)
    assert table["spans"][profile_slice.OUTSIDE]["kernel_ms"] is None
    assert profile_slice.span_table(recs, [], 1)["spans"]["model.cast"]["kernel_ms"] is None


class _FakeKinetoEvent:
    def __init__(self, name, device, corr, start, kind=None):
        self._name, self._corr, self._start = name, corr, start
        self._device = type("DeviceType", (), {"name": device})()
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def correlation_id(self):
        return self._corr

    def start_ns(self):
        return self._start


@pytest.mark.parametrize("typed", [True, False])
def test_launch_starts_read_the_runtime_calls(typed):
    """With ``activity_type`` (newer torch) or by the call's name."""
    def ev(name, device, corr, start, kind):
        return _FakeKinetoEvent(name, device, corr, start, kind if typed else None)

    events = [ev("cudaLaunchKernel", "CPU", 7, 100, "cuda_runtime"),
              ev("cuLaunchKernelEx", "CPU", 8, 200, "cuda_driver"),
              ev("aten::mm", "CPU", 9, 300, "cpu_op"),
              ev("gemm_fwd_kernel", "CUDA", 7, 400, "kernel")]
    assert profile_slice.launch_starts(events) == {7: 100, 8: 200}


@pytest.mark.parametrize("stale", [True, False])
def test_the_library_load_logs_a_rebuild(monkeypatch, caplog, stale):
    def build():
        if stale:
            _build.LOAD.nvcc_runs += 5
        return ""

    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(_build, "LOAD", _build.LibraryLoad())
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    with caplog.at_level(logging.WARNING, logger=_build.__name__):
        _build.library.__wrapped__()
    assert _build.LOAD.seconds is not None
    said = [r.getMessage() for r in caplog.records]
    assert said == (["built the kernel library " + str(_build.LIB_PATH) + ": 5 nvcc runs, "
                     f"{_build.LOAD.seconds:.1f} s"] if stale else [])
