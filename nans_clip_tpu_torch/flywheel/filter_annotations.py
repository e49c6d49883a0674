"""CLIP-in-the-loop annotation quality filter (counterpart of
``nans_clip_tpu/flywheel/filter_annotations.py``).

Port of reference scripts/filter_annotations.py:33-60: score each
(image, caption) pair with the model itself and drop captions whose cosine
similarity is below ``--threshold`` (default 0.15). The towers are the
port's, loaded by ``eval/model_io.py::load_eval_model`` in its bf16
default as the JAX filter's, on the card unless ``--platform cpu`` says
otherwise.
Pairs are scored 16 at a time, a short last batch padded with zero images
and empty captions, as the JAX filter does. A record whose image file is
missing or whose caption is empty is kept unscored.

  python -m nans_clip_tpu_torch.flywheel.filter_annotations \\
      --annotations data/annotations.json --images-dir data/images \\
      --resume ckpt.pt [--threshold 0.15] [--dry-run]
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import torch

from nans_clip_tpu_torch.data.augment import preprocess_images
from nans_clip_tpu_torch.eval.model_io import load_eval_model
from nans_clip_tpu_torch.tokenizer import tokenize

logger = logging.getLogger(__name__)

BATCH = 16


@torch.inference_mode()
def score(model, raw: np.ndarray, tokens: np.ndarray) -> np.ndarray:
    """Cosine similarity of each row's image (uint8 [B, R, R, 3]) and text
    (ids [B, L]), fp32 [B]."""
    dev = model.device
    x = preprocess_images(None, torch.from_numpy(raw).to(dev), model.image_resolution)
    fi = model.encode_image(x).float()
    ft = model.encode_text(torch.from_numpy(tokens).to(dev)).float()
    fi = fi / fi.norm(dim=-1, keepdim=True)
    ft = ft / ft.norm(dim=-1, keepdim=True)
    return (fi * ft).sum(-1).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(prog="nans_clip_tpu_torch.flywheel.filter_annotations")
    p.add_argument("--annotations", default="data/annotations.json")
    p.add_argument("--images-dir", default="data/images")
    p.add_argument("--output", default=None, help="default: in-place")
    p.add_argument("--threshold", type=float, default=0.15)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--resume", required=True)
    p.add_argument("--vision-model", default="ViT-B-16")
    p.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese")
    p.add_argument("--caption-field", default="modern_chinese")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="the device of the towers (default: the card; raises without one)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    from PIL import Image

    model = load_eval_model(args.vision_model, args.text_model, args.resume,
                            device=args.platform)
    resolution = model.image_resolution

    with open(args.annotations, encoding="utf-8") as f:
        annotations = json.load(f)
    images_dir = Path(args.images_dir)

    kept, removed = [], []
    batch_anns, batch_raw, batch_txt = [], [], []

    def flush():
        if not batch_anns:
            return
        raw = np.stack(batch_raw)
        pad = BATCH - len(batch_anns)
        if pad:
            raw = np.concatenate([raw, np.zeros((pad,) + raw.shape[1:], raw.dtype)])
        sims = score(model, raw, tokenize(batch_txt + [""] * pad))[: len(batch_anns)]
        for ann, sim in zip(batch_anns, sims):
            if float(sim) < args.threshold:
                logger.info("drop sim=%.4f < %.2f | %s", sim, args.threshold, ann["filename"])
                removed.append(ann)
            else:
                kept.append(ann)
        batch_anns.clear()
        batch_raw.clear()
        batch_txt.clear()

    for ann in annotations:
        path = images_dir / ann["filename"]
        caption = ann.get(args.caption_field, "").strip()
        if not path.exists() or not caption:
            kept.append(ann)
            continue
        # resize BEFORE the RGB convert, as the model's transform (reference
        # clip/utils.py:179-186): the order changes pixels of palette/RGBA
        # images, which moves scores near the threshold
        img = Image.open(path).resize((resolution, resolution), Image.BICUBIC).convert("RGB")
        batch_anns.append(ann)
        batch_raw.append(np.asarray(img, np.uint8))
        batch_txt.append(caption)
        if len(batch_anns) == BATCH:
            flush()
    flush()

    logger.info("kept %d | removed %d (sim < %.2f)", len(kept), len(removed), args.threshold)
    if not args.dry_run:
        out = args.output or args.annotations
        with open(out, "w", encoding="utf-8") as f:
            json.dump(kept, f, ensure_ascii=False, indent=1)
        logger.info("filtered annotations written to %s", out)
    return kept, removed


if __name__ == "__main__":
    main()
