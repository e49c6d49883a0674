"""Feature extraction CLI (counterpart of
``nans_clip_tpu/eval/extract_features.py``), jsonl-compatible with the
reference (eval/extract_features.py:165-203): L2-normalised fp32 features
written as ``{"text_id": ..., "feature": [...]}`` / ``{"image_id": ...,
"feature": [...]}``, in the input's order, to the JAX CLI's default paths.

Texts go through ``preprocess_text`` (lowercase, CJK quotes), ``tokenize``
and ``encode_text`` in batches of ``--text-batch-size``. Images come from
the split's ``imgs.npack`` in key order:

* ``--image-transform pil``: the reference eval transform on the host
  (``utils/transform.py::image_transform``: a bicubic resize, then
  ``convert("RGB")``, then the normalisation);
* ``--image-transform native``: ``NPackReader.decode_jpeg_batch_pil`` in
  ``--num-threads`` threads (the same pixels: resize, then convert), then
  ``data/augment.py::preprocess_images`` on the device. A record that does
  not decode raises. The JAX package's libjpeg decoder also refuses CMYK
  records; PIL reads them, so they get the ``pil`` path's pixels here.

``--backend`` (the JAX choices): ``jit`` runs the model's towers, and its
final batch is not padded (a tower's rows do not depend on the batch around
them; on the card a short final batch takes the whole-tower kernel where
``ops/gates.py`` routes it). ``stablehlo`` runs exported programs
(``deploy/aot.py::export_program``: in this package a ``torch.export``
archive, not StableHLO; the JAX name is kept so that command lines carry
over) and ``engine`` the engine files of ``deploy/engine.py``, given by
``--image-artifact`` / ``--text-artifact``, with the checkpoint's weights
bound; their final batch is padded to the artifact's batch and the padding
rows are dropped, as the JAX CLI pads. An engine built with ``--quantize``
or at another batch size than ``--img-batch-size`` / ``--text-batch-size``
is refused, and so is a ResNet image engine built from a checkpoint whose
BatchNorm running statistics differ from the model's.

Usage:
  python -m nans_clip_tpu_torch.eval.extract_features \\
      --extract-image-feats --extract-text-feats \\
      --image-data DATADIR/valid --text-data DATADIR/valid_texts.jsonl \\
      --resume ckpt.pt --vision-model ViT-B-16 \\
      --text-model RoBERTa-wwm-ext-base-chinese [--platform cpu --tiny-model]
"""

from __future__ import annotations

import argparse
import io
import json
import os

import numpy as np
import torch

from nans_clip_tpu_torch.data.augment import preprocess_images
from nans_clip_tpu_torch.data.dataset import preprocess_text
from nans_clip_tpu_torch.data.npack import NPackReader
from nans_clip_tpu_torch.eval.model_io import load_eval_model
from nans_clip_tpu_torch.tokenizer import tokenize
from nans_clip_tpu_torch.training.trainer import platform_device
from nans_clip_tpu_torch.utils.transform import image_transform


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--extract-image-feats", action="store_true")
    p.add_argument("--extract-text-feats", action="store_true")
    p.add_argument("--image-data", default=None, help="npack dataset dir (uses imgs.npack)")
    p.add_argument("--text-data", default=None, help="jsonl with text_id/text")
    p.add_argument("--image-feat-output-path", default=None)
    p.add_argument("--text-feat-output-path", default=None)
    p.add_argument("--img-batch-size", type=int, default=64)
    p.add_argument("--text-batch-size", type=int, default=64)
    p.add_argument("--context-length", type=int, default=52)
    p.add_argument("--resume", required=True)
    p.add_argument("--vision-model", default="ViT-B-16")
    p.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese")
    p.add_argument("--precision", default="bf16")
    p.add_argument("--num-threads", type=int, default=8)
    p.add_argument("--image-transform", choices=["pil", "native"], default="pil",
                   help="pil = the reference eval transform on the host (PIL decode, "
                        "bicubic resize, normalise); native = the same pixels from a "
                        "thread pool of PIL decoders, normalised on the device")
    p.add_argument("--backend", choices=["jit", "stablehlo", "engine"], default="jit",
                   help="jit: the model's towers; stablehlo: exported programs "
                        "(deploy.aot.export_program; in this package a torch.export archive, "
                        "the JAX name kept); engine: engine files (deploy.engine build)")
    p.add_argument("--image-artifact", default=None)
    p.add_argument("--text-artifact", default=None)
    p.add_argument("--tiny-model", action="store_true",
                   help="2-layer debug config (configs.tiny_config)")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="the device of the towers (default: the card; raises without one)")
    return p.parse_args(argv)


def _load_engine_fn(path: str, params: dict, batch_size: int, tower: str, stats: dict):
    """Bind an engine and check its conventions up front (the JAX
    ``_load_engine_fn``): an engine built with ``--quantize`` or at another
    batch size, or whose BatchNorm statistics (``stats``, the model's) differ,
    is refused before any extraction."""
    from nans_clip_tpu_torch.deploy.engine import batch_stats_digest, load_engine, read_header

    header = read_header(path)
    meta = header.get("meta", {})
    if meta.get("quantize"):
        raise SystemExit(f"{path}: engine was built with --quantize {meta['quantize']}; "
                         "extract_features loads unquantized checkpoints: rebuild the engine "
                         "without --quantize")
    if meta.get("batch_stats_digest") is not None \
            and meta["batch_stats_digest"] != batch_stats_digest(stats):
        raise SystemExit(f"{path}: engine was built from other BN running stats than this "
                         "checkpoint's (ResNet engines must be rebuilt per checkpoint)")
    if header.get("batch_size") is not None and header["batch_size"] != batch_size:
        flag = "img" if tower == "image" else "text"
        raise SystemExit(f"{path}: engine was built at batch_size={header['batch_size']} but "
                         f"--{flag}-batch-size is {batch_size}; rebuild the engine or pass the "
                         "matching batch size (engines are fixed-shape, like TensorRT engines)")
    return load_engine(path, params, payload=header)


def tower_fn(args, model, tower: str):
    """``(fn(x) -> features, pad)`` of ``--backend`` for ``tower``: the model's
    own call (pad False), or an exported program or engine at the artifact's
    batch (pad True)."""
    if args.backend == "jit":
        return (model.encode_image if tower == "image" else model.encode_text), False
    artifact = args.image_artifact if tower == "image" else args.text_artifact
    if not artifact:
        raise SystemExit(f"--backend {args.backend} needs --{tower}-artifact")
    from nans_clip_tpu_torch.deploy.aot import load_program, tower_params

    params = tower_params(model, tower)
    bs = args.img_batch_size if tower == "image" else args.text_batch_size
    if args.backend == "engine":
        from nans_clip_tpu_torch.models.clip import batch_stats
        return _load_engine_fn(artifact, params, bs, tower, batch_stats(model.module)), True
    program = load_program(artifact)
    dtype = torch.float32 if tower == "image" else torch.long
    return (lambda x: program(params, torch.as_tensor(x, dtype=dtype, device=model.device))), True


def _padded(x, batch_size: int):
    """x with zero rows appended up to ``batch_size`` (numpy or a tensor)."""
    pad = batch_size - len(x)
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


def _normalized(feats: torch.Tensor) -> np.ndarray:
    """fp32 rows on the host, each divided by its norm (as the JAX CLI does
    it, in numpy)."""
    out = feats.float().cpu().numpy()
    out /= np.linalg.norm(out, axis=-1, keepdims=True)
    return out


def extract_text_features(args, model, out_path):
    ids, texts = [], []
    with open(args.text_data, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            ids.append(obj["text_id"])
            texts.append(obj["text"])
    bs = args.text_batch_size
    fn, pad = tower_fn(args, model, "text")
    written = 0
    with open(out_path, "w") as fout:
        for i in range(0, len(ids), bs):
            # lowercase + CJK-quote normalisation before tokenizing, like the
            # reference eval dataset (eval/data.py:23-26,50)
            chunk = [preprocess_text(str(t)) for t in texts[i:i + bs]]
            tok = tokenize(chunk, args.context_length)
            feats = _normalized(fn(_padded(tok, bs) if pad else tok))[:len(chunk)]
            for tid, feat in zip(ids[i:i + bs], feats):
                fout.write(json.dumps({"text_id": tid, "feature": feat.tolist()}) + "\n")
                written += 1
    print(f"{written} text features are stored in {out_path}")


def decode_native(reader: NPackReader, chunk, resolution: int, num_threads: int) -> np.ndarray:
    """uint8 [N, R, R, 3]: the records' pixels as the ``pil`` path makes
    them (resize, then convert). A record that does not decode raises."""
    raw, ok = reader.decode_jpeg_batch_pil(chunk, resolution, num_threads)
    if not ok.all():
        # fail like the pil path does on a corrupt file: a zero image would
        # silently pollute the feature jsonl and every downstream top-k run
        bad = np.asarray(chunk)[~ok]
        raise RuntimeError(
            f"JPEG decode failed for image_ids {bad[:8].tolist()} "
            f"({int((~ok).sum())} total); rebuild the dataset or drop the corrupt records")
    return raw


def image_batches(reader: NPackReader, resolution: int, batch_size: int, pil: bool,
                  num_threads: int, device):
    """(keys, model input) a batch, in key order: host-normalised float
    pixels (``pil``) or the device's ``preprocess_images`` of the decoded
    uint8 (``native``)."""
    from PIL import Image

    t = image_transform(resolution)
    keys = reader.keys()
    for i in range(0, len(keys), batch_size):
        chunk = keys[i:i + batch_size]
        if pil:
            # reference-exact path: PIL decode + bicubic square resize +
            # normalize (clip/utils.py:179-186)
            x = np.stack([t(Image.open(io.BytesIO(reader.get(int(k))))) for k in chunk])
        else:
            raw = decode_native(reader, chunk, resolution, num_threads)
            x = preprocess_images(None, torch.from_numpy(raw).to(device), resolution)
        yield chunk, x


def extract_image_features(args, model, out_path):
    reader = NPackReader(os.path.join(args.image_data, "imgs.npack"))
    fn, pad = tower_fn(args, model, "image")
    written = 0
    try:
        with open(out_path, "w") as fout:
            for chunk, x in image_batches(reader, model.image_resolution, args.img_batch_size,
                                          args.image_transform == "pil", args.num_threads,
                                          model.device):
                x = _padded(x, args.img_batch_size) if pad else x
                feats = _normalized(fn(x))[:len(chunk)]
                for key, feat in zip(chunk.tolist(), feats):
                    fout.write(json.dumps({"image_id": int(key), "feature": feat.tolist()})
                               + "\n")
                    written += 1
    finally:
        reader.close()
    print(f"{written} image features are stored in {out_path}")


def main(argv=None):
    args = parse_args(argv)
    device = platform_device(args.platform)
    cfg = None
    if args.tiny_model:
        from nans_clip_tpu_torch.configs import tiny_config
        cfg = tiny_config()
    model = load_eval_model(args.vision_model, args.text_model, args.resume, args.precision,
                            cfg=cfg, device=device)

    if args.extract_text_feats:
        out = args.text_feat_output_path or f"{args.text_data[:-6]}.txt_feat.jsonl"
        extract_text_features(args, model, out)
    if args.extract_image_feats:
        out = args.image_feat_output_path or os.path.join(args.image_data, "imgs.img_feat.jsonl")
        extract_image_features(args, model, out)


if __name__ == "__main__":
    main()
