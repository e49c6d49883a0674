"""Data flywheel: annotations.json -> reference training format
(counterpart of ``nans_clip_tpu/flywheel/build_dataset.py``).

Behavioral port of reference scripts/build_dataset.py: converts VLM
annotations into ``{split}_imgs.tsv`` (image_id \\t base64) +
``{split}_texts.jsonl`` ({"text_id","text","image_ids"}), with

* multi-caption 1vN expansion per image — modern_chinese, ancient_style,
  keywords joined as one phrase, title (build_dataset.py:54-82);
* **image-level** train/valid split so caption variants of one image never
  leak across splits (build_dataset.py:140-153).

Feed the output straight to ``nans_clip_tpu_torch.preprocess.build_dataset``
to get npack stores.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import random
from pathlib import Path

logger = logging.getLogger(__name__)


def image_to_base64(image_path: Path, max_size: int = 512) -> str:
    from PIL import Image

    img = Image.open(image_path).convert("RGB")
    if max(img.size) > max_size:
        img.thumbnail((max_size, max_size), Image.BICUBIC)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=92)
    return base64.urlsafe_b64encode(buf.getvalue()).decode()


def build_texts_for_image(ann: dict) -> list:
    """One annotation -> up to 4 caption variants (reference :54-82)."""
    texts = []
    modern = ann.get("modern_chinese", "").strip()
    if modern:
        texts.append(modern)
    ancient = ann.get("ancient_style", "").strip()
    if ancient:
        texts.append(ancient)
    keywords = ann.get("keywords", "").strip()
    if keywords:
        texts.append(keywords.replace(",", " ").replace("，", " ").strip())
    title = ann.get("title", "").strip()
    if title and title not in texts:
        texts.append(title)
    return texts


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--annotations", default="data/annotations.json")
    p.add_argument("--images-dir", default="data/images")
    p.add_argument("--output-dir", default="data/dataset")
    p.add_argument("--train-ratio", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    with open(args.annotations, encoding="utf-8") as f:
        annotations = json.load(f)
    images_dir = Path(args.images_dir)

    valid = []
    for ann in annotations:
        if (images_dir / ann["filename"]).exists():
            valid.append(ann)
        elif not ann.get("_is_augmented", False):
            logger.warning("missing image, skipping: %s", ann["filename"])
    logger.info("valid records: %d", len(valid))
    if len(valid) < 5:
        logger.error("too few images (<5) to build a dataset")
        return

    # image-level split: all caption variants of one file go to one side
    random.seed(args.seed)
    unique = sorted({ann["filename"] for ann in valid})
    random.shuffle(unique)
    n_train = int(len(unique) * args.train_ratio)
    train_files = set(unique[:n_train])
    splits = {
        "train": [a for a in valid if a["filename"] in train_files],
        "valid": [a for a in valid if a["filename"] not in train_files],
    }
    logger.info("split by image: train %d | valid %d imgs",
                len(train_files), len(unique) - n_train)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for split, anns in splits.items():
        # group variants per filename: one image_id per file
        by_file: dict = {}
        for ann in anns:
            by_file.setdefault(ann["filename"], []).append(ann)
        text_id = 0
        with open(out / f"{split}_imgs.tsv", "w", encoding="utf-8") as f_tsv, \
                open(out / f"{split}_texts.jsonl", "w", encoding="utf-8") as f_jsonl:
            for image_id, (fname, group) in enumerate(sorted(by_file.items())):
                try:
                    b64 = image_to_base64(images_dir / fname)
                except Exception as e:
                    logger.warning("encode failed %s: %s", fname, e)
                    continue
                f_tsv.write(f"{image_id}\t{b64}\n")
                seen = set()
                for ann in group:
                    for text in build_texts_for_image(ann):
                        if text in seen:
                            continue
                        seen.add(text)
                        f_jsonl.write(json.dumps(
                            {"text_id": text_id, "text": text,
                             "image_ids": [image_id]}, ensure_ascii=False) + "\n")
                        text_id += 1
        logger.info("%s: %d images, %d texts -> %s", split, len(by_file),
                    text_id, out)


if __name__ == "__main__":
    main()
