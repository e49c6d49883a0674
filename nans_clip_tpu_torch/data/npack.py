"""npack: the record store of the data path (counterpart of
``nans_clip_tpu/data/npack.py``).

A pack file is a header (magic, record count, index offset), the records'
bytes, zero padding to 8 bytes, then an index of ``(key, offset, length)``
u64 triples sorted by key. The file format is the JAX package's, byte for
byte, so either package reads the other's packs. A split is an ``imgs``
pack (image_id -> JPEG bytes) and a ``pairs`` pack (index -> (image_id,
text_id, raw_text)), as the reference's two LMDB environments.

The reader is a pure-Python ``mmap`` view (the JAX package's fallback
path): the port has no native library. Images decode with PIL in a thread
pool of ``num_threads`` (PIL releases the GIL while it decodes and
resizes), by one of two decoders, and neither falls back to the other:

* :meth:`NPackReader.decode_jpeg_batch`: ``convert("RGB")`` then a bilinear
  resize, the loader's pixels where the JAX package has no native decoder;
* :meth:`NPackReader.decode_jpeg_batch_pil`: a bicubic resize then
  ``convert("RGB")``, the eval transform's exact pixels.

A record that does not decode comes back as a zero image with ok = False.
:func:`decode_jpeg_pil_batch` is the serving daemon's decode of raw image
bytes (``nans_clip_tpu/data/npack.py:153-194``) on the same PIL pool: the
eval transform's pixels, or with ``dct_scale`` PIL's draft mode first.
"""

from __future__ import annotations

import io
import mmap
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"NSPK1\x00\x00\x00"
_HEADER = struct.Struct("<8sQQ")
_ENTRY = struct.Struct("<QQQ")


class NPackWriter:
    """Streaming writer; records may arrive in any key order."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "wb")
        self.f.write(_HEADER.pack(MAGIC, 0, 0))
        self.entries = []
        self.offset = _HEADER.size

    def put(self, key: int, value: bytes):
        self.f.write(value)
        self.entries.append((int(key), self.offset, len(value)))
        self.offset += len(value)

    def close(self):
        self.entries.sort(key=lambda e: e[0])
        # a duplicate key would resolve to either record by the search
        for a, b in zip(self.entries, self.entries[1:]):
            if a[0] == b[0]:
                raise ValueError(f"duplicate key {a[0]} in npack")
        # the index starts on an 8-byte boundary (the JAX native reader
        # refuses unaligned index entries)
        pad = (-self.offset) % 8
        if pad:
            self.f.write(b"\0" * pad)
        index_offset = self.offset + pad
        for key, off, length in self.entries:
            self.f.write(_ENTRY.pack(key, off, length))
        self.f.seek(0)
        self.f.write(_HEADER.pack(MAGIC, len(self.entries), index_offset))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _decode_one(raw: Optional[bytes], size: int, exact: bool, draft: bool = False):
    """(pixels [size, size, 3] uint8, ok) of one record. ``draft``: PIL's
    draft mode first (a JPEG decoded at the smallest DCT scale that keeps
    ``size``), before the exact path's resize."""
    from PIL import Image

    if raw is None:
        return None, False
    try:
        img = Image.open(io.BytesIO(raw))
        if draft:
            img.draft("RGB", (size, size))
        if exact:
            img = img.resize((size, size), Image.BICUBIC).convert("RGB")
        else:
            img = img.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(img, np.uint8), True
    except Exception:
        return None, False


def decode_jpeg_pil_batch(buffers: Sequence[bytes], size: int, num_threads: int = 4,
                          dct_scale: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Raw image bytes -> (out [N, size, size, 3] uint8, ok [N] uint8), on a
    pool of ``num_threads`` PIL threads for the call. Each image's pixels
    are the eval transform's before normalisation (``utils/transform.py``:
    a bicubic square resize, then ``convert("RGB")``); ``dct_scale`` puts
    ``img.draft("RGB", (size, size))`` first (JAX's PIL branch, :177-185),
    a faster decode of large JPEGs that is not bit-exact. A record that does
    not decode gets ok = 0 and a zero image: the caller decides what
    follows."""
    n = len(buffers)
    out = np.zeros((n, size, size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    fn = lambda raw: _decode_one(bytes(raw), size, True, dct_scale)
    if num_threads <= 1 or n <= 1:
        results = [fn(b) for b in buffers]
    else:
        with ThreadPoolExecutor(min(num_threads, n), thread_name_prefix="npack-decode") as pool:
            results = list(pool.map(fn, buffers))
    for i, (pixels, good) in enumerate(results):
        if good:
            out[i], ok[i] = pixels, 1
    return out, ok


class NPackReader:
    """Reads a pack through an ``mmap`` view of the file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, count, index_offset = _HEADER.unpack_from(self._mm, 0)
        if magic != MAGIC:
            raise ValueError(f"{path}: not an npack file")
        if index_offset + _ENTRY.size * count > len(self._mm):
            raise ValueError(f"{path}: truncated npack (index past EOF)")
        self.count = count
        # a view over the map, not a copy: the index of a large pack stays on disk
        idx = np.frombuffer(self._mm, dtype=np.uint64, count=3 * count,
                            offset=index_offset).reshape(count, 3)
        self._keys, self._offsets, self._lengths = idx[:, 0], idx[:, 1], idx[:, 2]
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_threads = 0

    def __len__(self) -> int:
        return self.count

    def keys(self) -> np.ndarray:
        return self._keys

    def get(self, key: int) -> Optional[bytes]:
        i = int(np.searchsorted(self._keys, np.uint64(key)))
        if i >= self.count or self._keys[i] != np.uint64(key):
            return None
        off, ln = int(self._offsets[i]), int(self._lengths[i])
        return self._mm[off:off + ln]

    def get_at(self, i: int) -> Tuple[int, bytes]:
        off, ln = int(self._offsets[i]), int(self._lengths[i])
        return int(self._keys[i]), self._mm[off:off + ln]

    def __iter__(self) -> Iterator[Tuple[int, bytes]]:
        for i in range(self.count):
            yield self.get_at(i)

    def _map(self, fn: Callable, items: list, num_threads: int) -> list:
        if num_threads <= 1 or len(items) <= 1:
            return [fn(x) for x in items]
        if self._pool is None or self._pool_threads != num_threads:
            if self._pool is not None:
                self._pool.shutdown()
            self._pool = ThreadPoolExecutor(num_threads, thread_name_prefix="npack-decode")
            self._pool_threads = num_threads
        return list(self._pool.map(fn, items))

    def _decode(self, keys, size: int, num_threads: int, exact: bool):
        keys = np.asarray(keys, np.uint64).tolist()
        out = np.zeros((len(keys), size, size, 3), np.uint8)
        ok = np.zeros((len(keys),), bool)
        results = self._map(lambda k: _decode_one(self.get(k), size, exact), keys, num_threads)
        for i, (pixels, good) in enumerate(results):
            if good:
                out[i], ok[i] = pixels, True
        return out, ok

    def decode_jpeg_batch(self, keys, size: int,
                          num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """JPEGs of ``keys`` -> ([N, size, size, 3] uint8, ok [N] bool):
        ``convert("RGB")``, then ``resize(BILINEAR)`` (the JAX reader's PIL
        path, ``nans_clip_tpu/data/npack.py:291-305``)."""
        return self._decode(keys, size, num_threads, exact=False)

    def decode_jpeg_batch_pil(self, keys, size: int,
                              num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """JPEGs of ``keys`` with the eval transform's pixels: ``resize(BICUBIC)``,
        then ``convert("RGB")`` (``nans_clip_tpu/data/npack.py:173-184``)."""
        return self._decode(keys, size, num_threads, exact=True)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        # the index arrays are views over the map: drop them before closing it
        self._keys = self._offsets = self._lengths = None
        try:
            self._mm.close()
        except BufferError:
            pass  # a caller still holds a view; the map goes with the last one
        self._f.close()


# -- pair record codec -------------------------------------------------------

_PAIR = struct.Struct("<qq")


def encode_pair(image_id: int, text_id: int, raw_text: str) -> bytes:
    return _PAIR.pack(image_id, text_id) + raw_text.encode("utf-8")


def decode_pair(raw: bytes) -> Tuple[int, int, str]:
    image_id, text_id = _PAIR.unpack_from(raw, 0)
    return image_id, text_id, raw[_PAIR.size:].decode("utf-8")
