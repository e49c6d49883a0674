"""Query serving through the port's daemon engine
(``deploy/server.py::ClipService``: tokenization, JPEG decode, dynamic
batching into power-of-two buckets, a CUDA graph a tower and bucket on
the ``jit`` backend), driven in process by an open loop of client
threads; the HTTP shim is left out.

The mix's parameters: ``rate`` requests a second, ``text_share`` of them
text queries (one string of ``text_chars`` CJK characters drawn from the
vocabulary), the rest image queries (one JPEG each from a pool of
``jpeg_pool`` made at set-up from smooth seeded fields, the shorter side
``image_side``, the aspect one of ``aspects``, quality ``jpeg_quality``),
``clients`` threads, the service's ``max_batch``, ``decode_threads`` and
``dynamic_batching``; ``sample`` requests compared with the reference,
``trace_at`` / ``trace_seconds`` the traced sub-window, ``drain_seconds``
the longest wait for answers after the window.

The window holds exactly ``rate * seconds`` requests. Their arrival times
(exponential gaps: Poisson arrivals, scaled to end at ``seconds``) and
kinds are one schedule drawn from ``shape_seed``, the same for every seed,
and the text lengths one fixed multiset that each seed orders; the seed
draws the characters and the pixels. Each request is timed from when it was due
(so a late generator or a full client pool counts); one that fails or
never answers counts as beyond any limit. ``serve_req_per_s`` is the
requests answered within the window over its seconds: the cell runs above
the knee, where the queue grows all through the window, so the tails
(p50 / p95 / p99 on standard error) swing with the smallest change.
"""

from __future__ import annotations

import base64
import io
import itertools
import math
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from perfbench import counts, harness, trace
from perfbench.reference import image as ref_image
from perfbench.reference import model as ref_model
from perfbench.reference.tokenizer import WordPiece

# the vocabulary file of the checkout (the model's data, read as a file)
VOCAB = Path(__file__).resolve().parents[2] / "nans_clip_tpu" / "assets" / "vocab.txt"


def vocab_path() -> Path:
    return VOCAB


def cjk_chars() -> List[str]:
    with open(vocab_path(), encoding="utf-8") as f:
        words = [line.rstrip("\r\n") for line in f]
    return [w for w in words if len(w) == 1 and 0x4E00 <= ord(w) <= 0x9FFF]


def make_jpegs(tr: dict, seed: int) -> List[bytes]:
    """The pool's JPEGs: a 6 x 6 field of seeded colours, bicubic-upsampled
    (a smooth photo-like image), at the fixed multiset's sizes."""
    from PIL import Image

    n = tr["jpeg_pool"]
    shapes = np.random.default_rng(tr["shape_seed"])
    sides = shapes.integers(tr["image_side"]["min"], tr["image_side"]["max"] + 1, n)
    aspects = [tr["aspects"][k] for k in shapes.integers(0, len(tr["aspects"]), n)]
    rng = np.random.default_rng(harness.subseed(seed, harness.TAG_INPUTS))
    out = []
    for side, (aw, ah) in zip(sides, aspects):
        w, h = (int(side * aw / ah), int(side)) if aw >= ah else (int(side), int(side * ah / aw))
        field = Image.fromarray(rng.integers(0, 256, (6, 6, 3), dtype=np.uint8))
        buf = io.BytesIO()
        field.resize((w, h), Image.BICUBIC).save(buf, "JPEG", quality=tr["jpeg_quality"])
        out.append(buf.getvalue())
    return out


class Requests:
    """The window's requests: kind, payload and due time (seconds after the
    window opens) of each, in arrival order."""

    def __init__(self, tr: dict, seed: int, seconds: float, jpegs: List[bytes],
                 chars: List[str], rate: float = None):
        rate = tr["rate"] if rate is None else rate
        n = max(1, int(round(rate * seconds)))
        fixed = np.random.default_rng(tr["shape_seed"])
        gaps = fixed.exponential(1.0, n)
        n_text = int(round(n * tr["text_share"]))
        lengths = harness.fixed_multiset(tr["text_chars"], n_text)
        # one arrival schedule for every seed: when a query comes and of which
        # kind; the seed orders the text lengths and draws the contents
        self.due = np.cumsum(gaps) * (seconds / gaps.sum())
        self.is_text = fixed.permutation(np.arange(n) < n_text)
        order = np.random.default_rng(harness.subseed(seed, harness.TAG_ORDER))
        lengths = order.permutation(lengths)
        content = np.random.default_rng(harness.subseed(seed, harness.TAG_SAMPLE))
        self.payload: List[str] = []
        t = k = 0
        for text in self.is_text:
            if text:
                idx = content.integers(0, len(chars), lengths[t])
                self.payload.append("".join(chars[j] for j in idx))
                t += 1
            else:
                self.payload.append(base64.b64encode(jpegs[k % len(jpegs)]).decode())
                k += 1
        self.n = n


def sample(reqs: Requests, size: int, seed: int) -> List[int]:
    """``size`` request indices drawn from the seed, half texts (the
    longest among them) and half images."""
    rng = np.random.default_rng(harness.subseed(seed, harness.TAG_SAMPLE + 1))
    texts = np.nonzero(reqs.is_text)[0]
    images = np.nonzero(~reqs.is_text)[0]
    half = min(size // 2, len(texts), len(images))
    longest = sorted(texts, key=lambda i: -len(reqs.payload[i]))[:max(1, half // 4)]
    rest = rng.permutation(np.setdiff1d(texts, longest))[:half - len(longest)]
    return sorted(set(map(int, longest)) | set(map(int, rest))
                  | set(map(int, rng.permutation(images)[:half])))


class Loop:
    """The open loop: ``clients`` threads take the next request, sleep until
    it is due, send it, and record when it answered."""

    def __init__(self, service, reqs: Requests, clients: int, keep: List[int]):
        self.service, self.reqs, self.clients = service, reqs, clients
        self.keep = set(keep)
        self.done = np.full(reqs.n, np.nan)
        self.sent = np.full(reqs.n, np.nan)
        self.ok = np.zeros(reqs.n, bool)
        self.outputs: Dict[int, np.ndarray] = {}
        self.errors: List[str] = []
        self._next = itertools.count()

    def _client(self, t0: float) -> None:
        r = self.reqs
        while True:
            i = next(self._next)
            if i >= r.n:
                return
            delay = t0 + r.due[i] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            self.sent[i] = time.perf_counter()
            try:
                with torch.profiler.record_function("bench.request"):
                    out = (self.service.encode_texts([r.payload[i]]) if r.is_text[i]
                           else self.service.encode_images([r.payload[i]]))
                self.ok[i] = out.shape[0] == 1 and bool(np.isfinite(out).all())
                if i in self.keep:
                    self.outputs[i] = out[0]
            except Exception as e:  # a failed request counts as beyond any limit
                self.errors.append(f"{type(e).__name__}: {e}")
            self.done[i] = time.perf_counter()

    def run(self, t0: float, drain_s: float, during=None) -> None:
        threads = [threading.Thread(target=self._client, args=(t0,), daemon=True,
                                    name=f"bench-client-{k}") for k in range(self.clients)]
        for t in threads:
            t.start()
        if during is not None:
            during()
        end = t0 + self.reqs.due[-1] + drain_s
        for t in threads:
            t.join(max(0.0, end - time.perf_counter()))
        self.stuck = sum(t.is_alive() for t in threads)

    def latencies_ms(self, t0: float) -> np.ndarray:
        lat = (self.done - (t0 + self.reqs.due)) * 1e3
        return np.where(self.ok & np.isfinite(lat), lat, np.inf)


def build_service(ctx: harness.Context, phases=None):
    from nans_clip_tpu_torch.api import CLIPModel
    from nans_clip_tpu_torch.deploy.server import ClipService

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    model = CLIPModel(harness.program_config(cfg),
                      harness.program_module(cfg, ctx.seed, dev, phases),
                      harness.compute_options(cfg))
    service = ClipService(model, max_batch=tr["max_batch"], context_length=cfg["context_length"],
                          dynamic_batching=tr["dynamic_batching"], native_decode=True,
                          decode_threads=tr["decode_threads"])
    return model, service


def warm(service, jpegs: List[bytes], max_batch: int) -> None:
    """Capture every bucket either tower can be dispatched at."""
    b64 = base64.b64encode(jpegs[0]).decode()
    n = 1
    while n <= max_batch:
        service.encode_texts(["热身"] * n)
        service.encode_images([b64] * n)
        n *= 2


def percentile(x: np.ndarray, q: float) -> float:
    """The q-th percentile (linear between order statistics) where an
    infinite entry sorts last."""
    return float(np.percentile(x, q)) if np.isfinite(x).all() else float(
        np.sort(x)[min(len(x) - 1, int(math.ceil(q / 100 * len(x))) - 1)])


def window(service, reqs: Requests, tr: dict, keep: List[int], t0: float, during=None):
    """Run the open loop from ``t0``; the loop and the service's counters
    before and after."""
    stats0 = snapshot(service)
    loop = Loop(service, reqs, tr["clients"], keep)
    loop.run(t0, tr["drain_seconds"], during)
    return loop, stats0, snapshot(service)


def snapshot(service) -> dict:
    with service._stats_lock:
        s = service.stats
        return {"samples": sum(s["samples"].values()), "dispatches": s["device_dispatches"],
                "device_ms": s["device_ms_total"]}


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    sync = harness.synchronizer(dev)
    phases = harness.Phases(ctx.t_start)
    phases.mark("imports")
    jpegs = make_jpegs(tr, ctx.seed)
    phases.mark("jpegs")
    model, service = build_service(ctx, phases)
    phases.mark("model")
    warm(service, jpegs, tr["max_batch"])
    phases.mark("graphs")
    reqs = Requests(tr, ctx.seed, ctx.seconds, jpegs, cjk_chars())
    keep = sample(reqs, tr["sample"], ctx.seed)
    sync()
    phases.mark("requests")
    harness.steady()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    box = {}

    def during():
        start = time.perf_counter()
        time.sleep(max(0.0, box["t0"] + tr["trace_at"] * ctx.seconds - start))
        box["sub"] = (time.perf_counter(),)
        box["trace"] = trace.profiled(lambda: time.sleep(tr["trace_seconds"]), sync)
        box["sub"] += (time.perf_counter(),)

    t0 = box["t0"] = time.perf_counter() + 0.05
    setup_s = t0 - ctx.t_start
    loop, s0, s1 = window(service, reqs, tr, keep, t0, during if ctx.trace else None)
    sync()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lat = loop.latencies_ms(t0)
    failed = int((~np.isfinite(lat)).sum())
    late = (loop.sent - (t0 + reqs.due)) * 1e3
    last = np.nanmax(loop.done) if np.isfinite(loop.done).any() else t0
    answered = int((loop.ok & (loop.done <= t0 + ctx.seconds)).sum())
    out = harness.Outcome(attempted=reqs.n, failed=failed,
                          metrics={"serve_req_per_s": answered / ctx.seconds,
                                   "setup_s": setup_s},
                          checks={}, memory_peak_bytes=int(peak))
    out.notes.append(phases.line())
    out.notes.append(
        f"serve requests {reqs.n} rate {reqs.n / ctx.seconds:.3f}/s failed {failed} "
        f"stuck_clients {loop.stuck} p50_ms {percentile(lat, 50):.4f} "
        f"p95_ms {percentile(lat, 95):.4f} "
        f"p99_ms {percentile(lat, 99):.4f} generator_late_ms p50 {np.nanmedian(late):.4f} "
        f"p95 {np.nanpercentile(late, 95):.4f} max {np.nanmax(late):.4f} "
        f"drain_s {last - (t0 + reqs.due[-1]):.4f} errors {loop.errors[:3]}")
    n_img = int((~reqs.is_text).sum())
    n_txt = reqs.n - n_img
    dispatches = s1["dispatches"] - s0["dispatches"]
    out.observations = {
        "window_s": last - t0,
        "flops": n_img * counts.image_flops(cfg) + n_txt * counts.text_flops(cfg),
        "samples_per_dispatch": (s1["samples"] - s0["samples"]) / max(dispatches, 1),
        "dispatch_ms": (s1["device_ms"] - s0["device_ms"]) / max(dispatches, 1)}
    if ctx.trace and "trace" in box:
        t = box["trace"]
        a, b = box["sub"]
        inside = (loop.done >= a) & (loop.done <= b) & loop.ok
        line = t.check_line({})
        line["graph_launches_vs_dispatches_in_window"] = [t.graph_launches, None]
        out.notes.append(f"trace_check {line}")
        if line["agree"]:
            out.trace = t
            out.observations["bound_s"] = served_bound(
                cfg, int((inside & ~reqs.is_text).sum()), int((inside & reqs.is_text).sum()),
                tr["max_batch"])
    got = {i: loop.outputs.get(i) for i in keep}
    del service, model, loop
    harness.free(dev)
    out.checks = compare(ctx, reqs, got)
    return out


def served_bound(cfg: dict, n_img: int, n_txt: int, max_batch: int) -> float:
    """The least device time of ``n_img`` image and ``n_txt`` text samples
    served in dispatches of at most ``max_batch`` (so each tower's weights
    are read at least once per ``max_batch`` samples); padding rows are not
    counted."""
    total = 0.0
    for n, ops in ((n_img, counts.image_ops), (n_txt, counts.text_ops)):
        full, rest = divmod(n, max_batch)
        total += full * counts.ops_seconds(ops(cfg, max_batch))
        if rest:
            total += counts.ops_seconds(ops(cfg, rest))
    return total


def compare(ctx: harness.Context, reqs: Requests, got: Dict[int, np.ndarray]) -> dict:
    """The sampled requests' features against the reference's, which decodes
    and tokenizes the same payloads itself. A sampled request that never
    answered makes its tower's gap infinite."""
    cfg, dev = ctx.config, ctx.device
    w = harness.reference_weights(cfg, ctx.seed, dev, cfg["dtype"])
    wp = WordPiece(str(vocab_path()))
    gaps = {}
    for tower, is_text in (("image", False), ("text", True)):
        idx = [i for i in got if bool(reqs.is_text[i]) == is_text]
        if not idx:
            continue
        if any(got[i] is None for i in idx):
            gaps[tower] = math.inf
            continue
        x = reference_inputs(ctx, reqs, idx, is_text, wp)
        ref = ref_model.features(w, cfg, tower, x, block=32)
        prog = torch.from_numpy(np.stack([got[i] for i in idx])).to(dev)
        gaps[tower] = harness.max_gap(prog, ref)
    return {f"{t}_gap": (v, ctx.limits[f"{t}_gap"]) for t, v in gaps.items()}


def reference_inputs(ctx: harness.Context, reqs: Requests, idx: List[int], is_text: bool,
                     wp: WordPiece) -> torch.Tensor:
    """The requests' payloads as the reference reads them: token ids of its
    own tokenizer, or pixels of its own decode."""
    cfg = ctx.config
    if is_text:
        x = wp.tokenize([reqs.payload[i] for i in idx], cfg["context_length"])
    else:
        x = np.stack([ref_image.transform(base64.b64decode(reqs.payload[i]),
                                          cfg["image_resolution"]) for i in idx])
    return torch.from_numpy(x).to(ctx.device)


def sweep(ctx: harness.Context, rates: List[float], seconds: float) -> List[dict]:
    """One set-up, then a window at each rate: the knee is the highest rate
    whose answers keep pace with arrivals (no backlog left when the window
    closes: the drain after the last arrival stays under a tenth of a
    second and no request fails)."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    jpegs = make_jpegs(tr, ctx.seed)
    model, service = build_service(ctx)
    warm(service, jpegs, tr["max_batch"])
    chars = cjk_chars()
    rows = []
    for rate in rates:
        reqs = Requests(tr, ctx.seed, seconds, jpegs, chars, rate)
        t0 = time.perf_counter() + 0.05
        loop, s0, s1 = window(service, reqs, tr, [], t0)
        lat = loop.latencies_ms(t0)
        late = (loop.sent - (t0 + reqs.due)) * 1e3
        d = max(s1["dispatches"] - s0["dispatches"], 1)
        rows.append({"rate": rate, "requests": reqs.n, "failed": int((~np.isfinite(lat)).sum()),
                     "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
                     "p99_ms": percentile(lat, 99),
                     "drain_s": float(np.nanmax(loop.done) - (t0 + reqs.due[-1])),
                     "late_p95_ms": float(np.nanpercentile(late, 95)),
                     "samples_per_dispatch": (s1["samples"] - s0["samples"]) / d,
                     "dispatch_ms": (s1["device_ms"] - s0["device_ms"]) / d})
        print(rows[-1], flush=True)
    del service, model
    harness.free(dev)
    return rows


def control(ctx: harness.Context, prec: ref_model.Precision) -> dict:
    """The numbers this cell compares, with the reference at ``prec`` in the
    program's place, over the requests a run samples."""
    jpegs = make_jpegs(ctx.traffic, ctx.seed)
    reqs = Requests(ctx.traffic, ctx.seed, ctx.seconds, jpegs, cjk_chars())
    keep = sample(reqs, ctx.traffic["sample"], ctx.seed)
    w = harness.reference_weights(ctx.config, ctx.seed, ctx.device, ctx.config["dtype"])
    wp = WordPiece(str(vocab_path()))
    gaps = {}
    for tower, is_text in (("image", False), ("text", True)):
        idx = [i for i in keep if bool(reqs.is_text[i]) == is_text]
        x = reference_inputs(ctx, reqs, idx, is_text, wp)
        got = ref_model.features(w, ctx.config, tower, x, prec, block=32)
        gaps[f"{tower}_gap"] = harness.max_gap(got, ref_model.features(w, ctx.config, tower, x,
                                                                       block=32))
    return gaps
