"""Build npack datasets from the reference's raw input format (counterpart
of ``nans_clip_tpu/preprocess/build_dataset.py``; the same bytes from the
same input).

Input (the reference's preprocess/build_lmdb_dataset.py:43-95):
  ``{split}_texts.jsonl``: lines of {"text_id": int, "text": str,
  "image_ids": [int, ...]}
  ``{split}_imgs.tsv``: lines of "<image_id>\\t<urlsafe-b64 JPEG>"

Output per split directory:
  ``imgs.npack``: image_id -> raw JPEG bytes
  ``pairs.npack``: pair index -> (image_id, text_id, raw_text), one pair a
  text and image id (the reference's 1:N expansion); numeric ids pass
  through, string ids (the reference's dataset_transform keeps raw file
  names) hash with a process-stable digest (``lmdb_to_npack._image_key``)
  ``meta.json``
or, with ``--format lmdb``, the reference's two LMDB environments
(``pairs/``, ``imgs/``) through ``data/lmdb_store.py``.

Usage:
  python -m nans_clip_tpu_torch.preprocess.build_dataset \\
      --data-dir DIR --splits train,valid [--out-dir OUT] [--format npack|lmdb]
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import pickle

from nans_clip_tpu_torch.data import lmdb_store
from nans_clip_tpu_torch.data.npack import NPackWriter, encode_pair
from nans_clip_tpu_torch.preprocess.lmdb_to_npack import _image_key


def _lines(path: str):
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield line


def build_split(data_dir: str, split: str, out_dir: str | None = None) -> dict:
    out_dir = out_dir or os.path.join(data_dir, split)
    os.makedirs(out_dir, exist_ok=True)

    n_images = 0
    with NPackWriter(os.path.join(out_dir, "imgs.npack")) as w:
        for line in _lines(os.path.join(data_dir, f"{split}_imgs.tsv")):
            image_id, b64 = line.split("\t", 1)
            w.put(_image_key(image_id), base64.urlsafe_b64decode(b64))
            n_images += 1

    n_pairs = 0
    with NPackWriter(os.path.join(out_dir, "pairs.npack")) as w:
        for line in _lines(os.path.join(data_dir, f"{split}_texts.jsonl")):
            obj = json.loads(line)
            for image_id in obj["image_ids"]:
                w.put(n_pairs, encode_pair(_image_key(image_id), _image_key(obj["text_id"]),
                                           obj["text"]))
                n_pairs += 1

    meta = {"num_samples": n_pairs, "num_images": n_images, "split": split}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


def build_split_lmdb(data_dir: str, split: str, out_dir: str | None = None) -> dict:
    """The split in the reference's LMDB layout (preprocess/
    build_lmdb_dataset.py:43-95: pairs are pickled tuples keyed by index plus
    ``num_samples``, images urlsafe-b64 keyed by image_id plus
    ``num_images``), for interop with the reference's tooling."""
    out_dir = out_dir or os.path.join(data_dir, "lmdb", split)
    env_pairs = lmdb_store.open(os.path.join(out_dir, "pairs"), map_size=1 << 32)
    env_imgs = lmdb_store.open(os.path.join(out_dir, "imgs"), map_size=1 << 32)
    tp = env_pairs.begin(write=True)
    n_pairs = 0
    with open(os.path.join(data_dir, f"{split}_texts.jsonl"), encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            for image_id in obj["image_ids"]:
                tp.put(str(n_pairs).encode(),
                       pickle.dumps((image_id, obj["text_id"], obj["text"])))
                n_pairs += 1
    tp.put(b"num_samples", str(n_pairs).encode())
    tp.commit()
    ti = env_imgs.begin(write=True)
    n_images = 0
    for line in _lines(os.path.join(data_dir, f"{split}_imgs.tsv")):
        image_id, b64 = line.split("\t", 1)
        ti.put(image_id.encode(), b64.encode())
        n_images += 1
    ti.put(b"num_images", str(n_images).encode())
    ti.commit()
    env_pairs.close()
    env_imgs.close()
    return {"num_samples": n_pairs, "num_images": n_images, "split": split,
            "format": "lmdb", "out_dir": out_dir}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--splits", default="train,valid")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--format", choices=["npack", "lmdb"], default="npack",
                    help="npack = this framework's store; lmdb = the reference's on-disk "
                         "layout (interop)")
    args = ap.parse_args(argv)
    build = build_split if args.format == "npack" else build_split_lmdb
    for split in args.splits.split(","):
        meta = build(args.data_dir, split,
                     os.path.join(args.out_dir, split) if args.out_dir else None)
        print(f"{split}: {meta}")


if __name__ == "__main__":
    main()
