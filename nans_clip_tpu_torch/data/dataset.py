"""Pair datasets over npack splits and the epoch loader (counterpart of
``nans_clip_tpu/data/dataset.py``), with the JAX package's semantics:

* the epoch is padded, wrapping from the start, to a multiple of the global
  batch (reference pad_dataset, training/data.py:118-121);
* each epoch's order is ``np.random.default_rng(seed + epoch)``'s
  permutation, for training and validation alike, and a process takes every
  ``process_count``-th index of it from ``process_index`` (or, with
  ``layout="blocks"``, its block of each global batch);
* ``set_epoch(epoch, start_batch)`` skips the epoch's first batches without
  decoding them (mid-epoch resume);
* a pair whose image does not decode is replaced, image and caption, by the
  pair a fixed stride further on (``MAX_DECODE_RETRIES`` times), counted and
  logged;
* text: lowercase and CJK curly quotes (:func:`preprocess_text`), then
  ``[CLS] + WordPiece ids + [SEP]`` cut to ``context_length``, zero-padded;
* a prefetch thread decodes up to ``prefetch`` batches ahead and stops when
  the consumer leaves the epoch.

Batches are uint8 images on the host; :func:`~nans_clip_tpu_torch.data.augment.preprocess_images`
normalises (and augments) them on the card. Tokens come from the native
WordPiece tokenizer (``data/fast_tokenizer.py``) for the default vocab, as
in the JAX package, and from the Python tokenizer for a tokenizer the
caller passes; the two give the same ids.
"""

from __future__ import annotations

import json
import logging
import math
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from nans_clip_tpu_torch.data.npack import NPackReader, decode_pair
from nans_clip_tpu_torch.tokenizer import Tokenizer, get_tokenizer, tokenize


def preprocess_text(text: str) -> str:
    """Adapt text to the Chinese BERT vocab (reference data.py:29-33):
    lowercase, and CJK curly double quotes to ASCII."""
    return text.lower().replace("“", '"').replace("”", '"')


class PairDataset:
    """``imgs.npack`` + ``pairs.npack`` (+ ``meta.json``) under one
    directory. A reference-built LMDB split (``pairs/`` and ``imgs/`` LMDB
    environments) is converted to npack beside them on first use."""

    def __init__(self, path: str):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"dataset dir {path} does not exist")
        self.path = path
        if (not os.path.exists(os.path.join(path, "pairs.npack"))
                and os.path.isdir(os.path.join(path, "pairs"))):
            from nans_clip_tpu_torch.preprocess.lmdb_to_npack import convert_split
            logging.info("converting LMDB split %s to npack (one-time)", path)
            convert_split(path)
        self.pairs = NPackReader(os.path.join(path, "pairs.npack"))
        self.imgs = NPackReader(os.path.join(path, "imgs.npack"))
        meta_path = os.path.join(path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self.meta = json.load(f)
        else:
            self.meta = {"num_samples": len(self.pairs), "num_images": len(self.imgs)}
        self.num_samples = self.meta["num_samples"]
        self.num_images = self.meta["num_images"]

    def __len__(self) -> int:
        return self.num_samples

    def get_pair(self, i: int):
        _, raw = self.pairs.get_at(i % self.num_samples)
        return decode_pair(raw)


@dataclass
class Batch:
    images: np.ndarray      # uint8 [B, S, S, 3]
    texts: np.ndarray       # int32 [B, L]
    image_ids: np.ndarray   # int64 [B]
    text_ids: np.ndarray    # int64 [B]


def pad_len(n: int, global_batch: int) -> int:
    """Padded dataset length (reference pad_dataset, data.py:118-121)."""
    return max(1, math.ceil(n / global_batch)) * global_batch


LAYOUTS = ("strided", "blocks")


class DataLoader:
    """Epoch iterator yielding fixed-size host batches for one process.
    ``exact_decode`` decodes with the eval transform's pixels (bicubic,
    ``NPackReader.decode_jpeg_batch_pil``) instead of the bilinear loader
    decode. ``layout``: which records of the epoch's order process p of P
    takes: ``"strided"`` every P-th from p, as the JAX loader; ``"blocks"``
    block p of each global batch of ``batch_size * P`` records, so that the
    processes' batches i, concatenated, are the batch i that one process
    loads at that global batch (the port's data-parallel CLI,
    ``parallel/distributed.py``)."""

    MAX_DECODE_RETRIES = 2

    def __init__(self, dataset: PairDataset, batch_size: int,
                 decode_size: int = 224, context_length: int = 52,
                 shuffle: bool = True, seed: int = 123, epoch: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 tokenizer: Optional[Tokenizer] = None,
                 num_threads: int = 8, prefetch: int = 2,
                 exact_decode: bool = False, layout: str = "strided"):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        self.layout = layout
        self.ds = dataset
        self.batch_size = batch_size
        self.global_batch_size = batch_size * process_count
        self.decode_size = decode_size
        self.context_length = context_length
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.process_index = process_index
        self.process_count = process_count
        self.tokenizer = tokenizer or get_tokenizer()
        # the native WordPiece for the default vocab (the same ids, built on
        # first use; a failed build raises); a caller's tokenizer runs in Python
        self._fast_tok = None
        if tokenizer is None:
            from nans_clip_tpu_torch.data.fast_tokenizer import get_fast_tokenizer
            self._fast_tok = get_fast_tokenizer()
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.exact_decode = exact_decode

        self.padded_len = pad_len(len(dataset), self.global_batch_size)
        self.num_batches = self.padded_len // self.global_batch_size
        self.num_samples = self.padded_len
        self.decode_failures = 0
        self.start_batch = 0

    def set_epoch(self, epoch: int, start_batch: int = 0):
        """Position the next iteration at ``epoch``, skipping its first
        ``start_batch`` per-process batches (the order is a function of seed
        and epoch alone, so skipped records are never decoded)."""
        self.epoch = epoch
        self.start_batch = start_batch

    def _indices(self) -> np.ndarray:
        idx = np.arange(self.padded_len) % len(self.ds)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        if self.layout == "blocks":
            # block p of each global batch: the global batch is one process's
            return idx.reshape(-1, self.process_count, self.batch_size)[
                :, self.process_index].reshape(-1)
        return idx[self.process_index::self.process_count]

    def _make_batch(self, idx: np.ndarray) -> Batch:
        idx = np.array(idx)
        pairs = [self.ds.get_pair(int(i)) for i in idx]
        image_ids = np.asarray([p[0] for p in pairs], np.int64)
        text_ids = np.asarray([p[1] for p in pairs], np.int64)
        raw_texts = [preprocess_text(p[2]) for p in pairs]
        decode = (self.ds.imgs.decode_jpeg_batch_pil if self.exact_decode
                  else self.ds.imgs.decode_jpeg_batch)
        images, ok = decode(image_ids.astype(np.uint64), self.decode_size, self.num_threads)
        # a record that does not decode: resample the whole pair (image and
        # caption stay paired) from a shifted index, counted and logged
        for attempt in range(1, self.MAX_DECODE_RETRIES + 1):
            bad = np.flatnonzero(~ok)
            if bad.size == 0:
                break
            self.decode_failures += int(bad.size)
            failed_ids = image_ids[bad].tolist()
            n_ds = len(self.ds)
            off = (attempt * 9973) % n_ds
            if off == 0 and n_ds > 1:
                # the prime stride is the identity when n_ds divides it
                off = attempt % n_ds or 1
            idx[bad] = (idx[bad] + off) % n_ds
            for j in bad:
                p = self.ds.get_pair(int(idx[j]))
                image_ids[j], text_ids[j] = p[0], p[1]
                raw_texts[j] = preprocess_text(p[2])
            re_imgs, re_ok = decode(image_ids[bad].astype(np.uint64), self.decode_size,
                                    self.num_threads)
            images[bad] = re_imgs
            ok[bad] = re_ok
            logging.warning("decode failed for image_ids %s; resampled (%d total failures)",
                            failed_ids[:8], self.decode_failures)
        if not ok.all():
            logging.warning("decode still failing after %d retries for image_ids %s; "
                            "training on zero images", self.MAX_DECODE_RETRIES,
                            image_ids[~ok][:8].tolist())
        texts = (self._fast_tok.encode_batch(raw_texts, self.context_length) if self._fast_tok
                 else tokenize(raw_texts, self.context_length, self.tokenizer))
        return Batch(images=images, texts=texts, image_ids=image_ids, text_ids=text_ids)

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Batch]:
        indices = self._indices()
        n = self.num_batches
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that leaves mid-epoch must not leave the producer
            # blocked in q.put, holding its batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(min(self.start_batch, n), n):
                    if stop.is_set():
                        return
                    sl = indices[b * self.batch_size:(b + 1) * self.batch_size]
                    if not put(self._make_batch(sl)):
                        return
                put(None)
            except BaseException as e:  # raised in the consumer, not lost
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
