"""Serving daemon: a stdlib HTTP shim around a live model (counterpart of
``nans_clip_tpu/deploy/server.py`` on its live backend).

- Fixed-shape discipline: a request is padded to the next power-of-two
  batch up to ``--max-batch`` and chunked beyond it, so the towers see only
  a few batch sizes (at <= 32 they run the whole-tower kernel where
  ``ops/gates.py`` routes it).
- Endpoints (JSON over POST; ``GET /health``, ``GET /stats``):
    /encode_text  {"texts": [str, ...]}            -> {"features": [[...]]}
    /encode_image {"images": [b64-jpeg, ...]}      -> {"features": [[...]]}
    /similarity   {"texts": [...], "images": [...]} ->
        {"logits_per_image": [[...]], "probs": [[...]]}
  Features are L2-normalised fp32. Images are standard or urlsafe base64
  JPEG/PNG, decoded with PIL (imported at decode time) through the port's
  ``image_transform``.
- Dynamic batching (on by default): concurrent requests for the same tower
  are coalesced into one device dispatch by an opportunistic drain. While
  the device runs one batch, arriving requests queue; the dispatcher takes
  the whole same-tower run at the head of the queue (up to the serving
  batch) when the device frees. A lone client waits for nothing.

The HTTP layer is a ``ThreadingHTTPServer``. All device work runs under one
lock, on the model's device. The saved-engine backend and the native JPEG
decoder of the JAX daemon wait for the port's ``deploy/engine.py`` and
``csrc/npack.cpp``.

    python -m nans_clip_tpu_torch.deploy.server [--resume ckpt.pt] \\
        [--quantize int8-text] [--port 8000]
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
from typing import List, Optional

import numpy as np
import torch

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
    """Pads and chunks requests to bucketed batches, runs them through a
    :class:`CLIPModel` and returns L2-normalised fp32 features."""

    def __init__(self, model, max_batch: int = 32, context_length: int = 52,
                 dynamic_batching: bool = True):
        from nans_clip_tpu_torch.utils.transform import image_transform

        self.model = model
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.context_length = context_length
        self._transform = image_transform(self.cfg.vision.image_resolution)
        self._lock = threading.Lock()
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
            "errors": 0,
        }

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
                cap = self.max_batch   # the largest batch one dispatch serves
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

    def _device_scope(self):
        dev = self.model.device
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def _run_device(self, tower: str, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        out: List[np.ndarray] = []
        with self._lock, self._device_scope():
            fn = self.model.encode_text if tower == "text" else self.model.encode_image
            bs = _bucket(n, self.max_batch)
            t0 = time.perf_counter()
            for i in range(0, n, bs):
                chunk = x[i:i + bs]
                pad = bs - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:],
                                                            chunk.dtype)])
                feats = fn(chunk).float()
                feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
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
        """Image bytes -> normalised float32 [N, R, R, 3] (PIL)."""
        from PIL import Image

        res = self.cfg.vision.image_resolution
        x = np.zeros((len(raws), res, res, 3), np.float32)
        for i, raw in enumerate(raws):
            try:
                x[i] = self._transform(Image.open(io.BytesIO(raw)))
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
                self._send(200, {"status": "ok", "model": service.cfg.name, "backend": "eager",
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
                          dynamic_batching=not args.no_dynamic_batching)
    srv = make_server(service, args.host, args.port, max_body_bytes=args.max_body_mb << 20)
    logging.basicConfig(level=logging.INFO)
    logger.info("serving %s on %s:%d (%s)", model.cfg.name, args.host, srv.server_address[1],
                model.device)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
