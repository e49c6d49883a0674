"""Serving daemon: a stdlib HTTP shim around the towers (counterpart of
``nans_clip_tpu/deploy/server.py``).

- Backends, named as in the JAX daemon (``/health``'s ``backend``):
  ``jit``, the live model: on the card each (tower, batch bucket) is a CUDA
  graph of the tower (``deploy/aot.py::compile_tower``), captured on first
  use; on the CPU (``--device cpu``) the towers run eagerly. ``engine``
  (``--engine-dir``): the ``{image,text}_bsN.engine`` files of
  ``deploy/engine.py``, loaded at startup with the model's weights bound
  (no trace or compile; on the card each is a CUDA graph). An engine whose
  header's model, quantize mode or (text) context length differs from the
  service's is refused at startup.
- Fixed-shape discipline: with ``jit`` a request is padded to the next
  power-of-two batch up to ``--max-batch`` and chunked beyond it, so the
  towers see only a few batch sizes (at <= 32 they run the whole-tower
  kernel where ``ops/gates.py`` routes it); with ``engine`` it is padded to
  the smallest engine that fits it and chunked at the largest.
- Endpoints (JSON over POST; ``GET /health``, ``GET /stats``):
    /encode_text  {"texts": [str, ...]}            -> {"features": [[...]]}
    /encode_image {"images": [b64-jpeg, ...]}      -> {"features": [[...]]}
    /similarity   {"texts": [...], "images": [...]} ->
        {"logits_per_image": [[...]], "probs": [[...]]}
  Features are L2-normalised fp32. Images are standard or urlsafe base64
  JPEG/PNG. A request's images decode together on a pool of
  ``--decode-threads`` PIL threads (``data/npack.py::
  decode_jpeg_pil_batch``: the pixels of the port's ``image_transform``, or
  with ``--fast-decode`` PIL's draft mode first); a record that fails there
  is decoded again alone through ``image_transform`` and counted in
  ``/stats`` ``decode_fallbacks``, and one that fails again answers 400.
  ``--pil-decode`` decodes each image alone through ``image_transform``.
- Dynamic batching (on by default): concurrent requests for the same tower
  are coalesced into one device dispatch by an opportunistic drain. While
  the device runs one batch, arriving requests queue; the dispatcher takes
  the whole same-tower run at the head of the queue (up to the serving
  batch: ``--max-batch``, or the largest engine) when the device frees. A
  lone client waits for nothing.

The HTTP layer is a ``ThreadingHTTPServer``. All device work runs under one
lock, on the model's device, so the graphs (which share one memory pool)
run one at a time. The JAX daemon's threaded decode runs libjpeg
(``csrc/npack.cpp``); the card's machine has none, so the port's pool runs
PIL, which gives the same pixels.

    python -m nans_clip_tpu_torch.deploy.server [--resume ckpt.pt] \\
        [--quantize int8-text] [--engine-dir engines] [--port 8000] \\
        [--decode-threads 4] [--fast-decode | --pil-decode]
"""

from __future__ import annotations

import base64
import collections
import contextlib
import io
import json
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from nans_clip_tpu_torch.deploy.aot import normalized
from nans_clip_tpu_torch.models.common import PRECISIONS
from nans_clip_tpu_torch.ops import gates

logger = logging.getLogger(__name__)


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


class _Pending:
    """One queued encode request awaiting a coalesced device dispatch."""

    __slots__ = ("tower", "x", "out", "err", "done")

    def __init__(self, tower: str, x: np.ndarray):
        self.tower = tower
        self.x = x
        self.out: Optional[np.ndarray] = None
        self.err: Optional[BaseException] = None
        self.done = threading.Event()


class ClipService:
    """Pads and chunks requests to fixed batches, runs them through the
    towers of a :class:`CLIPModel` (``jit``) or through engines
    (``engine_dir``), and returns L2-normalised fp32 features. Engines
    must have been built with the quantize mode of the model's weights.
    ``native_decode``: a request's images through ``decode_jpeg_pil_batch``
    on ``decode_threads`` threads (``fast_decode``: its ``dct_scale``), else
    each through ``image_transform`` (the module docstring)."""

    def __init__(self, model, max_batch: int = 32, context_length: int = 52,
                 dynamic_batching: bool = True, engine_dir: Optional[str] = None,
                 native_decode: bool = True, decode_threads: int = 4,
                 fast_decode: bool = False):
        from nans_clip_tpu_torch.utils.quantize import quantize_mode
        from nans_clip_tpu_torch.utils.transform import image_transform

        self.model = model
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.context_length = context_length
        self.quantize = quantize_mode(model.module)
        self._transform = image_transform(self.cfg.vision.image_resolution)
        self.native_decode = native_decode
        self.decode_threads = decode_threads
        self.fast_decode = fast_decode
        self._lock = threading.Lock()
        self._fns: Dict[tuple, object] = {}
        self._engine_batch: Optional[Dict[str, int]] = None
        self.dynamic_batching = dynamic_batching
        self._queue: collections.deque = collections.deque()
        self._qcond = threading.Condition()
        self._dispatcher: Optional[threading.Thread] = None
        # GET /stats counters, written by the HTTP threads and the dispatcher
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": {"text": 0, "image": 0},
            "samples": {"text": 0, "image": 0},
            "device_dispatches": 0,
            "device_ms_total": 0.0,
            "coalesced_requests": 0,   # requests that rode a shared dispatch
            "decode_fallbacks": 0,     # records the batch decode failed, decoded alone
            "errors": 0,
        }
        if engine_dir is not None:
            self._load_engines(engine_dir)

    @property
    def backend(self) -> str:
        return "engine" if self._engine_batch else "jit"

    def _load_engines(self, engine_dir: str):
        import glob
        import re

        from nans_clip_tpu_torch.deploy.aot import tower_params
        from nans_clip_tpu_torch.deploy.engine import (batch_stats_digest, load_engine,
                                                       read_header)
        from nans_clip_tpu_torch.models.clip import batch_stats

        params = {}
        for path in sorted(glob.glob(f"{engine_dir.rstrip('/')}/*.engine")):
            m = re.match(r"(image|text)_bs\d+\.engine$", path.rsplit("/", 1)[-1])
            if not m:
                continue
            header = read_header(path)
            meta = header.get("meta", {})
            tower = m.group(1)
            # fail fast at startup on every convention the header records: a
            # mismatch would otherwise surface per request
            mismatches = []
            if meta.get("quantize") != self.quantize:
                mismatches.append(f"quantize: built {meta.get('quantize')}, server has "
                                  f"{self.quantize}")
            if meta.get("model") is not None and meta["model"] != self.cfg.name:
                mismatches.append(f"model: built {meta['model']!r}, server has "
                                  f"{self.cfg.name!r}")
            if tower == "text" and meta.get("context_length") is not None \
                    and meta["context_length"] != self.context_length:
                mismatches.append(f"context_length: built {meta['context_length']}, server "
                                  f"has {self.context_length}")
            if meta.get("batch_stats_digest") is not None \
                    and meta["batch_stats_digest"] != batch_stats_digest(
                        batch_stats(self.model.module)):
                mismatches.append("batch_stats_digest: the engine was built from other BN running "
                                  "stats than this checkpoint's (ResNet engines must be "
                                  "rebuilt per checkpoint)")
            if mismatches:
                raise ValueError(f"{path} does not match this server's configuration: "
                                 "rebuild the engine or fix the flags: " + "; ".join(mismatches))
            if tower not in params:
                params[tower] = tower_params(self.model, tower)
            with self._device_scope():
                eng = load_engine(path, params[tower], payload=header)
            bs = header.get("batch_size")
            if bs is None:
                bs = int(re.search(r"_bs(\d+)\.engine$", path).group(1))
            self._fns[(tower, int(bs))] = eng
            logger.info("loaded engine %s (batch %s)", path, bs)
        if not self._fns:
            raise ValueError(f"no {{image,text}}_bsN.engine files in {engine_dir}")
        # serve each tower at its largest engine batch (smaller requests pad
        # up, larger ones chunk)
        self._engine_batch = {tower: max(b for t, b in self._fns if t == tower)
                              for tower in {t for t, _ in self._fns}}

    def _tower_fn(self, tower: str, n: int):
        """(callable returning normalised fp32 features, padded batch) for a
        request of n samples."""
        if self._engine_batch is not None:
            avail = sorted(b for t, b in self._fns if t == tower)
            if not avail:
                raise ValueError(f"no engine for the {tower} tower in the engine dir")
            fits = [b for b in avail if b >= n]
            bs = fits[0] if fits else avail[-1]   # smallest fit, else chunk
            return self._fns[(tower, bs)], bs
        bs = _bucket(n, self.max_batch)
        if self.model.device.type != "cuda":
            encode = self.model.encode_text if tower == "text" else self.model.encode_image
            return (lambda x: normalized(encode(x))), bs
        key = (tower, bs)
        if key not in self._fns:
            from nans_clip_tpu_torch.deploy.aot import compile_tower
            self._fns[key] = compile_tower(self.model, tower, bs, self.context_length)
            logger.info("captured the %s tower at batch %d", tower, bs)
        return self._fns[key], bs

    def _run(self, tower: str, x: np.ndarray) -> np.ndarray:
        with self._stats_lock:
            self.stats["requests"][tower] += 1
            self.stats["samples"][tower] += int(x.shape[0])
        if x.shape[0] == 0:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        if not self.dynamic_batching:
            return self._run_device(tower, x)
        item = _Pending(tower, x)
        with self._qcond:
            if self._dispatcher is None:
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, daemon=True, name="clip-service-dispatch")
                self._dispatcher.start()
            self._queue.append(item)
            self._qcond.notify()
        item.done.wait()
        if item.err is not None:
            raise item.err
        return item.out

    def _dispatch_loop(self):
        """Take the whole same-tower run at the head of the queue (up to the
        serving batch), run it as ONE padded dispatch, scatter the results."""
        while True:
            with self._qcond:
                while not self._queue:
                    self._qcond.wait()
                tower = self._queue[0].tower
                cap = self._coalesce_cap(tower)
                batch: List[_Pending] = [self._queue.popleft()]
                total = batch[0].x.shape[0]
                while self._queue and self._queue[0].tower == tower and total < cap:
                    total += self._queue[0].x.shape[0]
                    batch.append(self._queue.popleft())
            try:
                xs = batch[0].x if len(batch) == 1 else np.concatenate([it.x for it in batch])
                if len(batch) > 1:
                    with self._stats_lock:
                        self.stats["coalesced_requests"] += len(batch)
                feats = self._run_device(tower, xs)
                ofs = 0
                for it in batch:
                    it.out = feats[ofs:ofs + it.x.shape[0]]
                    ofs += it.x.shape[0]
            except BaseException as e:  # scatter the failure to every rider
                for it in batch:
                    it.err = e
            finally:
                for it in batch:
                    it.done.set()

    def _coalesce_cap(self, tower: str) -> int:
        """Samples worth coalescing into one drain: the largest batch one
        device program serves."""
        if self._engine_batch is not None:
            return self._engine_batch.get(tower, 1)
        return self.max_batch

    def _device_scope(self):
        dev = self.model.device
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def _run_device(self, tower: str, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        out: List[np.ndarray] = []
        with self._lock, self._device_scope():
            fn, bs = self._tower_fn(tower, n)
            # timed after the lock and the tower's first-use capture
            t0 = time.perf_counter()
            for i in range(0, n, bs):
                chunk = x[i:i + bs]
                pad = bs - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:],
                                                            chunk.dtype)])
                feats = fn(torch.from_numpy(chunk))
                out.append(feats.cpu().numpy()[:bs - pad])   # .cpu() waits for the device
                with self._stats_lock:
                    self.stats["device_dispatches"] += 1
            dt_ms = (time.perf_counter() - t0) * 1e3
        with self._stats_lock:
            self.stats["device_ms_total"] += dt_ms
        return np.concatenate(out)

    def encode_texts(self, texts: List[str]) -> np.ndarray:
        from nans_clip_tpu_torch.data.dataset import preprocess_text
        from nans_clip_tpu_torch.tokenizer import tokenize
        tok = tokenize([preprocess_text(str(t)) for t in texts], self.context_length)
        return self._run("text", np.asarray(tok))

    def encode_images(self, images_b64: List[str]) -> np.ndarray:
        if not images_b64:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        raws = []
        for i, b in enumerate(images_b64):
            try:
                pad = "=" * (-len(b) % 4)
                raws.append(base64.urlsafe_b64decode(b + pad) if ("-" in b or "_" in b)
                            else base64.b64decode(b + pad))
            except Exception as e:
                raise ValueError(f"images[{i}]: cannot decode ({e})") from e
        return self._run("image", self._decode_batch(raws))

    def _decode_batch(self, raws: List[bytes]) -> np.ndarray:
        """Image bytes -> normalised float32 [N, R, R, 3]: the batch decode
        normalised in fp32 numpy (``image_transform``'s arithmetic), then
        each record it failed alone through ``image_transform`` (JAX
        ``server.py:323-349``)."""
        from nans_clip_tpu_torch.utils.transform import OPENAI_MEAN, OPENAI_STD

        res = self.cfg.vision.image_resolution
        if self.native_decode:
            from nans_clip_tpu_torch.data.npack import decode_jpeg_pil_batch
            out, ok = decode_jpeg_pil_batch(raws, res, self.decode_threads,
                                            dct_scale=self.fast_decode)
            x = out.astype(np.float32) / 255.0
            x = (x - np.asarray(OPENAI_MEAN, np.float32)) / np.asarray(OPENAI_STD, np.float32)
            bad = np.nonzero(ok == 0)[0]
            if len(bad):
                with self._stats_lock:
                    self.stats["decode_fallbacks"] += int(len(bad))
        else:
            x = np.zeros((len(raws), res, res, 3), np.float32)
            bad = range(len(raws))
        if len(bad):
            from PIL import Image
            for i in bad:
                try:
                    x[i] = self._transform(Image.open(io.BytesIO(raws[i])))
                except Exception as e:
                    raise ValueError(f"images[{i}]: cannot decode ({e})") from e
        return x

    def similarity(self, images_b64: List[str], texts: List[str]):
        img = self.encode_images(images_b64)
        txt = self.encode_texts(texts)
        scale = float(self.model.module.logit_scale.detach().float().exp())
        logits_per_image = scale * img @ txt.T
        if logits_per_image.size == 0:   # empty texts or images
            return logits_per_image, np.zeros_like(logits_per_image)
        e = np.exp(logits_per_image - logits_per_image.max(-1, keepdims=True))
        return logits_per_image, e / e.sum(-1, keepdims=True)


def make_handler(service: ClipService, max_body_bytes: int = 256 << 20):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        # keep-alive: _send always sets Content-Length
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):  # route through logging, not stderr
            logger.debug("%s - %s", self.address_string(), fmt % a)

        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok", "model": service.cfg.name,
                                 "backend": service.backend,
                                 "device": str(service.model.device),
                                 "dynamic_batching": service.dynamic_batching})
            elif self.path == "/stats":
                with service._stats_lock:
                    snap = json.loads(json.dumps(service.stats))
                self._send(200, snap)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > max_body_bytes:
                    # refuse before reading; the unread body stays on the
                    # socket, so the keep-alive connection must close
                    self.close_connection = True
                    self._send(413, {"error": f"request body {length} B exceeds "
                                              f"{max_body_bytes} B"})
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/encode_text":
                    self._send(200, {"features": service.encode_texts(req["texts"]).tolist()})
                elif self.path == "/encode_image":
                    self._send(200, {"features": service.encode_images(req["images"]).tolist()})
                elif self.path == "/similarity":
                    logits, probs = service.similarity(req["images"], req["texts"])
                    self._send(200, {"logits_per_image": logits.tolist(),
                                     "probs": probs.tolist()})
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except (KeyError, ValueError, TypeError) as e:
                with service._stats_lock:
                    service.stats["errors"] += 1
                self._send(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover - defensive 500
                with service._stats_lock:
                    service.stats["errors"] += 1
                logger.exception("request failed")
                self._send(500, {"error": str(e)})

    return Handler


def make_server(service: ClipService, host: str = "127.0.0.1", port: int = 8000,
                max_body_bytes: int = 256 << 20):
    from http.server import ThreadingHTTPServer
    return ThreadingHTTPServer((host, port), make_handler(service, max_body_bytes))


def parse_args(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="nans_clip_tpu_torch.deploy.server")
    p.add_argument("--vision-model", default="ViT-B-16")
    p.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese")
    p.add_argument("--resume", default=None)
    p.add_argument("--precision", default="bf16", choices=PRECISIONS,
                   help="every value but fp32 runs in bf16, as in the JAX package")
    p.add_argument("--attn-impl", default="auto", choices=gates.IMPLS,
                   help="the JAX choices auto|xla|pallas|fused, plus the port's plain|kernel")
    p.add_argument("--quantize", default=None, choices=[None, "int8", "int8-text"])
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--no-dynamic-batching", action="store_true",
                   help="dispatch each request separately instead of coalescing concurrent "
                        "same-tower requests into one device batch")
    p.add_argument("--context-length", type=int, default=52)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-body-mb", type=int, default=256,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--pil-decode", action="store_true",
                   help="decode request images with PIL one at a time instead of the threaded "
                        "batch decoder (bit-identical output; the slow path kept for debugging)")
    p.add_argument("--decode-threads", type=int, default=4)
    p.add_argument("--fast-decode", action="store_true",
                   help="DCT-scaled decode for large images (PIL draft mode): a much faster "
                        "host path, a small documented feature drift from the bit-exact "
                        "default")
    p.add_argument("--engine-dir", default=None,
                   help="serve the {image,text}_bsN.engine files of `python -m "
                        "nans_clip_tpu_torch.deploy.engine build` instead of per-bucket CUDA "
                        "graphs of the live model")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny-model", action="store_true",
                   help="2-layer debug config (configs.tiny_config)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from nans_clip_tpu_torch.eval.model_io import load_eval_model
    cfg = None
    if args.tiny_model:
        from nans_clip_tpu_torch.configs import tiny_config
        cfg = tiny_config()
    model = load_eval_model(args.vision_model, args.text_model, args.resume, args.precision,
                            attn_impl=args.attn_impl, cfg=cfg, device=args.device)
    if args.quantize:
        from nans_clip_tpu_torch.utils.quantize import towers_for_mode
        model = model.quantize("int8", towers_for_mode(args.quantize))
    service = ClipService(model, max_batch=args.max_batch, context_length=args.context_length,
                          dynamic_batching=not args.no_dynamic_batching,
                          engine_dir=args.engine_dir, native_decode=not args.pil_decode,
                          decode_threads=args.decode_threads, fast_decode=args.fast_decode)
    srv = make_server(service, args.host, args.port, max_body_bytes=args.max_body_mb << 20)
    logging.basicConfig(level=logging.INFO)
    logger.info("serving %s on %s:%d (%s, %s backend)", model.cfg.name, args.host,
                srv.server_address[1], model.device, service.backend)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
