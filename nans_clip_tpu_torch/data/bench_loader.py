"""Throughput of the data path on the host (counterpart of
``nans_clip_tpu/data/bench_loader.py``): a synthetic npack split, then

* decode + resize: the loader's thread pool of PIL decoders at
  ``--threads`` against one thread (the port has no libjpeg decoder: the
  card's machine has no libjpeg to link, so its "native" decode is the pool);
* tokenize: the native WordPiece (``data/fast_tokenizer.py``) against the
  Python tokenizer, on the same texts (the ids are checked equal);
* the loader end to end (``DataLoader``: decode, tokenize, batches).

The loader must outrun the train step (a ViT-B/16 step at batch 128 takes
~1,345 pairs/s on one NVIDIA H100 80GB HBM3 at 700 W) or training waits for
data.

  python -m nans_clip_tpu_torch.data.bench_loader [--images 512] [--size 224]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import shutil
import tempfile
import time

import numpy as np


def build_synthetic(root: str, n: int, src_size: int = 400):
    """``n`` random JPEGs of ``src_size`` px with one caption each, built
    into ``root/bench`` (imgs.npack, pairs.npack)."""
    from PIL import Image

    from nans_clip_tpu_torch.preprocess.build_dataset import build_split

    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(0)
    with open(os.path.join(root, "bench_imgs.tsv"), "w") as fi, \
            open(os.path.join(root, "bench_texts.jsonl"), "w", encoding="utf-8") as ft:
        for i in range(n):
            arr = rs.randint(0, 255, (src_size, src_size, 3), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=90)
            fi.write(f"{i}\t{base64.urlsafe_b64encode(buf.getvalue()).decode()}\n")
            ft.write(json.dumps({"text_id": i, "text": f"南宋古籍绘画第{i}卷山水人物",
                                 "image_ids": [i]}, ensure_ascii=False) + "\n")
    return build_split(root, "bench")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="nans_clip_tpu_torch.data.bench_loader")
    p.add_argument("--images", type=int, default=512)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--threads", type=int, default=8)
    args = p.parse_args(argv)

    from nans_clip_tpu_torch.data.dataset import DataLoader, PairDataset
    from nans_clip_tpu_torch.data.fast_tokenizer import get_fast_tokenizer
    from nans_clip_tpu_torch.tokenizer import tokenize

    print(f"host CPUs: {os.cpu_count()} (decode-pool scaling needs >1)")
    root = tempfile.mkdtemp(prefix="nans_bench_")
    try:
        build_synthetic(root, args.images)
        ds = PairDataset(os.path.join(root, "bench"))

        keys = ds.imgs.keys()
        t0 = time.perf_counter()
        ds.imgs.decode_jpeg_batch(keys, args.size, args.threads)
        pool = len(keys) / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        ds.imgs.decode_jpeg_batch(keys, args.size, 1)
        pil = len(keys) / (time.perf_counter() - t0)
        print(f"decode+resize: pool {pool:.0f} img/s ({args.threads} threads) "
              f"vs PIL {pil:.0f} img/s (1 thread) -> {pool / pil:.1f}x")

        texts = [f"南宋古籍绘画第{i}卷山水人物图册设色绢本" for i in range(2000)]
        ft = get_fast_tokenizer()
        t0 = time.perf_counter()
        native_ids = ft.encode_batch(texts, 52)
        fast = len(texts) / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        py_ids = tokenize(texts, 52)
        py = len(texts) / (time.perf_counter() - t0)
        if not np.array_equal(native_ids, py_ids):
            raise AssertionError("the native tokenizer's ids differ from the Python tokenizer's")
        print(f"tokenize: native {fast:.0f} texts/s vs python {py:.0f} texts/s "
              f"-> {fast / py:.1f}x")

        loader = DataLoader(ds, batch_size=args.batch_size, decode_size=args.size,
                            shuffle=True, num_threads=args.threads)
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            n += batch.images.shape[0]
        dt = time.perf_counter() - t0
        print(f"loader end-to-end: {n / dt:.0f} samples/s "
              f"(batch {args.batch_size}, decode {args.size}px)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"cpus": os.cpu_count(), "decode_pool_img_s": pool, "decode_pil_img_s": pil,
            "tokenize_native_texts_s": fast, "tokenize_python_texts_s": py,
            "loader_pairs_s": n / dt, "batch_size": args.batch_size, "size": args.size,
            "threads": args.threads}


if __name__ == "__main__":
    main()
