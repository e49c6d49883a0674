"""CSV -> (tsv + jsonl) dataset converter (counterpart of
``nans_clip_tpu/preprocess/dataset_transform.py``; the reference's
``dataset_transform.py``): competition-style CSVs with ``image_id`` /
``caption`` columns become the training input format
(``{split}_imgs.tsv`` + ``{split}_texts.jsonl``) with a deterministic
train/valid split (``random.Random(seed)``). Non-numeric image names get a
process-stable id (``lmdb_to_npack._image_key``). Pure stdlib.

  python -m nans_clip_tpu_torch.preprocess.dataset_transform \\
      --csv ImageWordData.csv --images-dir ImageData --out-dir datasets/Name \\
      [--test-size 0.2] [--seed 42]
"""

from __future__ import annotations

import argparse
import base64
import csv
import json
import os
import random

from nans_clip_tpu_torch.preprocess.lmdb_to_npack import _image_key


def convert_rows(rows, images_dir, img_file, txt_file, image_col="image_id",
                 text_col="caption"):
    n = 0
    with open(img_file, "w", encoding="utf-8") as f_img, \
            open(txt_file, "w", encoding="utf-8") as f_txt:
        for row in rows:
            path = os.path.join(images_dir, str(row[image_col]))
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                b64 = base64.b64encode(f.read()).decode()
            stem = os.path.splitext(str(row[image_col]))[0]
            try:
                int_id = int(stem)
            except ValueError:
                int_id = _image_key(stem)
            f_img.write(f"{int_id}\t{b64}\n")
            f_txt.write(json.dumps({"text_id": int_id, "text": row[text_col],
                                    "image_ids": [int_id]}, ensure_ascii=False) + "\n")
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--csv", required=True)
    p.add_argument("--images-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--image-col", default="image_id")
    p.add_argument("--text-col", default="caption")
    p.add_argument("--test-size", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    with open(args.csv, encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    random.Random(args.seed).shuffle(rows)
    n_val = int(len(rows) * args.test_size)
    splits = {"valid": rows[:n_val], "train": rows[n_val:]}

    os.makedirs(args.out_dir, exist_ok=True)
    for split, split_rows in splits.items():
        n = convert_rows(split_rows, args.images_dir,
                         os.path.join(args.out_dir, f"{split}_imgs.tsv"),
                         os.path.join(args.out_dir, f"{split}_texts.jsonl"),
                         args.image_col, args.text_col)
        print(f"{split}: {n} records")


if __name__ == "__main__":
    main()
