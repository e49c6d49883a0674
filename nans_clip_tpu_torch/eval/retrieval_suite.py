"""The fork's retrieval evaluator (counterpart of
``nans_clip_tpu/eval/retrieval_suite.py``; the reference fork's
``evaluate.py``):

* the whole split in memory, ground truth keyed as the fork keys it
  (evaluate.py:48-101): queries are the UNIQUE TEXT STRINGS (duplicate
  captions collapse into one query with the union of their images), the
  gallery is the sorted unique image ids, and pairs whose image is missing
  from the store are dropped;
* texts are tokenized RAW, without ``preprocess_text`` (evaluate.py:147);
* an optional distractor pool appended to the image gallery, ids from
  100000 (evaluate.py:104-125);
* R@K / NDCG@K / mAP / MR in both directions (evaluate.py:158-210), on the
  host;
* an optional zero-shot against LoRA comparison (evaluate.py:248-319): the
  adapters of ``--lora`` (the JAX package's ``.npz``) merged into the fp32
  weights, then cast to the compute dtype as the base model is.

``--image-transform native`` decodes in a thread pool (resize, then
convert: the pil path's pixels for RGB and grayscale records) and
normalises on the device. A record of any other mode (CMYK) takes the
pil path's convert-then-resize, as the JAX package's native decoder
rejects it and re-decodes it so.

Usage:
  python -m nans_clip_tpu_torch.eval.retrieval_suite \\
      --data DATADIR/valid --resume ckpt.pt \\
      --vision-model ViT-B-16 --text-model RoBERTa-wwm-ext-base-chinese \\
      [--lora best_lora.npz] [--distractor-dir DIR] [--output results.json] \\
      [--platform cpu --tiny-model]
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from nans_clip_tpu_torch.api import CLIPModel
from nans_clip_tpu_torch.data.augment import preprocess_images
from nans_clip_tpu_torch.data.dataset import PairDataset
from nans_clip_tpu_torch.eval.model_io import load_eval_model
from nans_clip_tpu_torch.models.common import ModelOptions, compute_dtype_for
from nans_clip_tpu_torch.tokenizer import tokenize
from nans_clip_tpu_torch.training.trainer import platform_device
from nans_clip_tpu_torch.utils.transform import image_transform


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="npack dataset dir")
    p.add_argument("--resume", required=True)
    p.add_argument("--vision-model", default="ViT-B-16")
    p.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese")
    p.add_argument("--lora", default=None, help="adapter .npz for comparison")
    p.add_argument("--lora-alpha", type=float, default=None,
                   help="defaults to the alpha stored in the adapter file")
    p.add_argument("--distractor-dir", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--context-length", type=int, default=52)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--image-transform", choices=["pil", "native"], default="pil",
                   help="pil = host PIL convert + bicubic resize + normalise, the reference "
                        "preprocess; native = a thread pool of PIL decoders (the same "
                        "pixels), normalised on the device")
    p.add_argument("--output", default=None)
    p.add_argument("--tiny-model", action="store_true",
                   help="2-layer debug config (configs.tiny_config)")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="the device of the towers (default: the card; raises without one)")
    return p.parse_args(argv)


def metrics_at_k(sims: np.ndarray, ground_truth: Dict[int, set],
                 k_list=(1, 5, 10)) -> Dict[str, float]:
    """R@K / NDCG@K / mAP / MR over a [Q, G] similarity matrix (reference
    evaluate.py:158-210)."""
    recalls = {k: 0 for k in k_list}
    ndcgs = {k: 0.0 for k in k_list}
    map_sum = 0.0
    total = 0
    order = np.argsort(-sims, axis=1)
    for i in range(sims.shape[0]):
        gt = ground_truth.get(i)
        if not gt:
            continue
        pred = order[i]
        for k in k_list:
            hits = [1 if idx in gt else 0 for idx in pred[:k]]
            if sum(hits) > 0:
                recalls[k] += 1
            dcg = sum(rel / math.log2(rank + 2) for rank, rel in enumerate(hits))
            idcg = sum(1 / math.log2(rank + 2) for rank in range(min(len(gt), k)))
            ndcgs[k] += dcg / idcg if idcg > 0 else 0.0
        hits_so_far = 0
        ap = 0.0
        for rank, idx in enumerate(pred):
            if int(idx) in gt:
                hits_so_far += 1
                ap += hits_so_far / (rank + 1)
        map_sum += ap / len(gt)
        total += 1
    out = {}
    for k in k_list:
        out[f"R@{k}"] = 100.0 * recalls[k] / max(total, 1)
        out[f"NDCG@{k}"] = 100.0 * ndcgs[k] / max(total, 1)
    out["mAP"] = 100.0 * map_sum / max(total, 1)
    out["MR"] = sum(out[f"R@{k}"] for k in k_list) / len(k_list)
    return out


def load_split(data_dir: str) -> Tuple[List[int], List[str], Dict[int, set], Dict[int, set],
                                       PairDataset]:
    """(gallery image_ids, unique texts, t2i gt, i2t gt, dataset), the
    reference's evaluate.py:48-101: the gallery is the sorted image ids that
    are in the store, the queries the unique raw texts (first-seen order, the
    same dedup as the reference's ``list(set(...))``; the metrics do not
    depend on the order), the ground truth keyed by position."""
    ds = PairDataset(data_dir)
    pairs = []
    for i in range(len(ds)):
        image_id, _text_id, raw = ds.get_pair(i)
        pairs.append((image_id, raw))

    unique_image_ids = sorted({p[0] for p in pairs})
    available = {int(k) for k in ds.imgs.keys()}
    image_ids = [iid for iid in unique_image_ids if iid in available]
    imgid_to_pos = {iid: pos for pos, iid in enumerate(image_ids)}

    unique_texts = list(dict.fromkeys(p[1] for p in pairs))
    text_to_idx = {t: i for i, t in enumerate(unique_texts)}

    text_to_images: Dict[int, set] = {}
    image_to_texts: Dict[int, set] = {}
    for img_id, text in pairs:
        tidx = text_to_idx[text]
        pos = imgid_to_pos.get(img_id)
        if pos is None:
            continue
        text_to_images.setdefault(tidx, set()).add(pos)
        image_to_texts.setdefault(pos, set()).add(tidx)
    return image_ids, unique_texts, text_to_images, image_to_texts, ds


def _convert_then_resize(raw: bytes, resolution: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(raw)).convert("RGB")
    return np.asarray(img.resize((resolution, resolution), Image.BICUBIC), np.uint8)


def decode_native(ds: PairDataset, chunk, resolution: int) -> np.ndarray:
    """uint8 [N, R, R, 3] of the gallery ids in ``chunk``: the thread pool's
    resize-then-convert for RGB and grayscale records (the pil path's
    pixels), convert-then-resize for any other mode, as the JAX package
    re-decodes the records its native decoder rejects. Raises on a record
    PIL cannot decode."""
    from PIL import Image

    keys = np.asarray(chunk, np.uint64)
    raw, ok = ds.imgs.decode_jpeg_batch_pil(keys, resolution)
    for j, k in enumerate(keys.tolist()):
        data = ds.imgs.get(k)
        try:
            if ok[j] and Image.open(io.BytesIO(data)).mode in ("L", "RGB"):
                continue
            raw[j] = _convert_then_resize(data, resolution)
        except OSError as e:   # PIL's decode errors (UnidentifiedImageError among them)
            raise RuntimeError(f"image_id {k} is undecodable (native and PIL both failed: {e}); "
                               "rebuild the dataset or drop the corrupt record") from e
    return raw


def compute_features(model: CLIPModel, ds, image_ids, texts, batch_size, context_length,
                     distractors=None, pil: bool = True):
    """(image features [G (+ distractors), E], text features [T, E]), fp32,
    normalised on the device."""
    from PIL import Image

    resolution = model.image_resolution
    t = image_transform(resolution)

    def normalized(f: torch.Tensor) -> np.ndarray:
        f = f.float()
        return (f / f.norm(dim=-1, keepdim=True)).cpu().numpy()

    def encode(x) -> np.ndarray:
        if not pil:
            x = preprocess_images(None, torch.from_numpy(x).to(model.device), resolution)
        return normalized(model.encode_image(x))

    feats = []
    for i in range(0, len(image_ids), batch_size):
        chunk = image_ids[i:i + batch_size]
        if pil:
            # reference-exact path: evaluate.py:71 converts to RGB FIRST, then
            # applies the preprocess transform (resize + normalize)
            x = np.stack([t(Image.open(io.BytesIO(ds.imgs.get(int(k)))).convert("RGB"))
                          for k in chunk])
        else:
            x = decode_native(ds, chunk, resolution)
        feats.append(encode(x))
    for i in range(0, len(distractors or ()), batch_size):
        feats.append(encode(np.stack([r for _, r in distractors[i:i + batch_size]])))
    image_features = np.concatenate(feats)

    # raw text, NO preprocess_text: reference evaluate.py:147
    text_features = np.concatenate([
        normalized(model.encode_text(tokenize(texts[i:i + batch_size], context_length)))
        for i in range(0, len(texts), batch_size)])
    return image_features, text_features


def evaluate_model(model: CLIPModel, ds, image_ids, texts, text_to_images, image_to_texts,
                   batch_size, context_length, distractors=None, pil=True):
    img_f, txt_f = compute_features(model, ds, image_ids, texts, batch_size, context_length,
                                    distractors, pil=pil)
    sims_t2i = txt_f @ img_f.T                      # [T, G(+distractors)]
    t2i = metrics_at_k(sims_t2i, text_to_images)
    i2t = metrics_at_k(sims_t2i.T[: len(image_ids)], image_to_texts)
    return {"text_to_image": t2i, "image_to_text": i2t}


def load_distractors(distractor_dir: str, resolution: int, start_id: int = 100000,
                     pil: bool = True):
    """[(id, image)] with non-colliding ids (reference evaluate.py:104-125):
    the normalised float array of the reference transform with ``pil``, else
    the uint8 square resize for the device's preprocess. Files that are not
    images are skipped."""
    from PIL import Image

    t = image_transform(resolution)
    out = []
    exts = {".jpg", ".jpeg", ".png", ".webp"}
    for i, name in enumerate(sorted(os.listdir(distractor_dir))):
        p = os.path.join(distractor_dir, name)
        if os.path.splitext(name)[1].lower() not in exts or not os.path.isfile(p):
            continue
        try:
            # evaluate.py:120 converts to RGB BEFORE the preprocess transform
            img = Image.open(p).convert("RGB")
            if pil:
                out.append((start_id + i, t(img)))
            else:
                arr = np.asarray(img.resize((resolution, resolution), Image.BICUBIC), np.uint8)
                out.append((start_id + i, arr))
        except OSError:   # not an image PIL decodes: skipped, as the reference skips it
            continue
    return out


def load_adapters(path: str, module, alpha=None):
    """(adapters, alpha) from the JAX package's ``.npz``. The template gives
    the tree's keys; the arrays, and so the rank, are the file's (the JAX
    suite's rank-4 template loads any stored rank the same way). ``alpha``
    defaults to the file's (an alpha of 0 is a valid ablation)."""
    from nans_clip_tpu_torch.models.lora import init_lora, load_lora

    adapters, meta = load_lora(path, init_lora(torch.Generator().manual_seed(0), module))
    return adapters, (alpha if alpha is not None else meta.get("alpha", 16.0))


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    device = platform_device(args.platform)
    pil = args.image_transform == "pil"
    cfg = None
    if args.tiny_model:
        from nans_clip_tpu_torch.configs import tiny_config
        cfg = tiny_config()
    # fp32 weights first: the LoRA deltas are added to them, then the towers
    # are cast to the compute dtype (the JAX package casts its fp32 tree)
    base = load_eval_model(args.vision_model, args.text_model, args.resume, "fp32", cfg=cfg,
                           device=device)
    merged = None
    if args.lora:
        from nans_clip_tpu_torch.models.lora import merge_lora
        adapters, alpha = load_adapters(args.lora, base.module, args.lora_alpha)
        with torch.no_grad():
            merged = merge_lora(base.module, adapters, alpha=alpha)
    model = CLIPModel(base.cfg, base.module,
                      ModelOptions(compute_dtype=compute_dtype_for(args.precision)))

    image_ids, texts, text_to_images, image_to_texts, ds = load_split(args.data)
    logging.info("split: %d images, %d texts, %d t2i gt entries",
                 len(image_ids), len(texts), len(text_to_images))
    distractors = None
    if args.distractor_dir:
        distractors = load_distractors(args.distractor_dir, model.image_resolution, pil=pil)
        logging.info("added %d distractors to the gallery", len(distractors))

    run = lambda: evaluate_model(model, ds, image_ids, texts, text_to_images, image_to_texts,
                                 args.batch_size, args.context_length, distractors, pil=pil)
    results = {"zeroshot": run()}
    if merged is not None:
        params = dict(model.module.named_parameters())
        with torch.no_grad():
            for name, w in merged.items():
                params[name].copy_(w)
        results["lora"] = run()

    for name, res in results.items():
        for direction, m in res.items():
            logging.info("%s %s | " + " | ".join(f"{k} {v:.1f}" for k, v in m.items()),
                         name, direction)
    if args.output:
        n_dis = len(distractors) if distractors else 0
        out = dict(results)
        out["num_domain_images"] = len(image_ids)
        out["num_distractors"] = n_dis
        out["num_total_images"] = len(image_ids) + n_dis
        out["num_texts"] = len(texts)
        with open(args.output, "w") as f:
            json.dump(out, f, indent=1)
        logging.info("results dumped to %s", args.output)
    return results


if __name__ == "__main__":
    main()
