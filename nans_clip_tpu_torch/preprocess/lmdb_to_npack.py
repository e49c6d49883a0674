"""Convert a reference-built LMDB dataset split to npack stores (counterpart
of ``nans_clip_tpu/preprocess/lmdb_to_npack.py``; the same npack bytes from
the same split).

The reference stores each split as two LMDB environments
(preprocess/build_lmdb_dataset.py:43-95, read by training/data.py:49-56):

  <split>/pairs — key "idx" -> pickle((image_id, text_id, raw_text)),
                  plus key "num_samples" -> count string
  <split>/imgs  — key "<image_id>" -> urlsafe-base64 JPEG string,
                  plus key "num_images" -> count string

This CLI reads those files directly (through the port's LMDB format reader,
data/lmdb_store.py; no liblmdb needed) and writes the equivalent npack
split (imgs.npack / pairs.npack / meta.json) so previously built CN-CLIP
datasets load into this framework unchanged. ``PairDataset`` also calls
``convert_split`` automatically when pointed at an LMDB split directory.

Usage:
  python -m nans_clip_tpu_torch.preprocess.lmdb_to_npack \
      --lmdb-dir DATASET/lmdb/train [--out-dir DATASET/npack/train]
"""

from __future__ import annotations

import argparse
import base64
import binascii
import hashlib
import json
import os
import pickle

from nans_clip_tpu_torch.data.lmdb_store import LMDBReader
from nans_clip_tpu_torch.data.npack import NPackWriter, encode_pair


def _image_key(image_id) -> int:
    """npack keys are u64; non-integer reference image ids hash stably."""
    try:
        v = int(image_id)
        if v >= 0:
            return v
    except (TypeError, ValueError):
        pass
    digest = hashlib.blake2s(str(image_id).encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1  # keep inside int64 range


def convert_split(lmdb_dir: str, out_dir: str | None = None) -> dict:
    """Convert one LMDB split directory (containing pairs/ and imgs/).

    Returns the meta dict. ``out_dir`` defaults to the split dir itself
    (npack files are written next to the LMDB subdirectories, where
    ``PairDataset`` finds them).
    """
    pairs_dir = os.path.join(lmdb_dir, "pairs")
    imgs_dir = os.path.join(lmdb_dir, "imgs")
    assert os.path.isdir(pairs_dir), f"no LMDB pairs env under {lmdb_dir}"
    assert os.path.isdir(imgs_dir), f"no LMDB imgs env under {lmdb_dir}"
    out_dir = out_dir or lmdb_dir
    os.makedirs(out_dir, exist_ok=True)

    imgs = LMDBReader(imgs_dir)
    n_images = 0
    with NPackWriter(os.path.join(out_dir, "imgs.npack")) as w:
        for key, val in imgs.items():
            if key == b"num_images":
                continue
            image_id = key.decode("utf-8")
            val = bytes(val)
            if val[:3] == b"\xff\xd8\xff" or val[:8] == b"\x89PNG\r\n\x1a\n":
                jpeg = val  # already raw image bytes (magic detected)
            else:
                try:
                    # strict alphabet: the lenient decoder silently
                    # DISCARDS non-alphabet bytes, mangling raw JPEGs into
                    # garbage instead of raising into the fallback
                    jpeg = base64.b64decode(
                        val.replace(b"-", b"+").replace(b"_", b"/"),
                        validate=True)
                except (binascii.Error, ValueError):
                    jpeg = val  # raw bytes that aren't b64 text
            w.put(_image_key(image_id), jpeg)
            n_images += 1
    declared = imgs.get(b"num_images")
    imgs.close()
    if declared is not None:
        assert n_images == int(declared), (n_images, declared)

    pairs = LMDBReader(pairs_dir)
    num_samples = pairs.get(b"num_samples")
    if num_samples is not None:
        n_pairs = int(num_samples)
    else:
        # splits written WITHOUT the meta key: the fork's evaluate.py can
        # only read these (its range(txn.stat()['entries']) loop,
        # evaluate.py:57-59, would otherwise run one past the data and
        # pickle.loads(None) on the meta key) — every entry is a pair
        n_pairs = pairs.entries
    with NPackWriter(os.path.join(out_dir, "pairs.npack")) as w:
        for i in range(n_pairs):
            raw = pairs.get(str(i).encode("utf-8"))
            assert raw is not None, f"pairs env missing index {i}"
            image_id, text_id, text = pickle.loads(raw)
            w.put(i, encode_pair(_image_key(image_id), int(text_id), text))
    pairs.close()

    meta = {"num_samples": n_pairs, "num_images": n_images,
            "source": "lmdb", "lmdb_dir": os.path.abspath(lmdb_dir)}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lmdb-dir", required=True,
                    help="split directory containing pairs/ and imgs/ LMDB envs")
    ap.add_argument("--out-dir", default=None,
                    help="output directory (default: the split dir itself)")
    args = ap.parse_args(argv)
    meta = convert_split(args.lmdb_dir, args.out_dir)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
