"""ctypes binding of the C++ WordPiece tokenizer (``csrc/tokenizer.cpp``;
counterpart of ``nans_clip_tpu/data/fast_tokenizer.py``).

``FastTokenizer.encode_batch(texts, context_length)`` returns the padded
``[N, L]`` int32 matrix with the ``[CLS] ... [SEP]`` framing; its ids equal
the Python tokenizer's (``tokenizer.py``) on every text. The data loader
tokenizes with it for the default vocab.

The library is built on first use with ``g++`` into the git-ignored
``nans_clip_tpu_torch/build/``, never into the source tree: first the
Unicode tables (``csrc/gen_unicode_tables.py``, dumped from this
interpreter's ``unicodedata``, so the C++ sees the categories, lower-case
maps and NFD decompositions that the Python tokenizer sees), then the
library. Its file name carries a key of the sources, the Python version
and the Unicode version, so another interpreter builds its own. A build
that fails raises with the compiler's message: nothing falls back to the
Python tokenizer quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import tempfile
import threading
import unicodedata
from pathlib import Path
from typing import Sequence

import numpy as np

from nans_clip_tpu_torch.tokenizer import DEFAULT_VOCAB

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = (CSRC / "tokenizer.cpp", CSRC / "gen_unicode_tables.py")

_lock = threading.Lock()
_lib = None


def _key() -> str:
    h = hashlib.sha256()
    for path in SOURCES:
        h.update(path.read_bytes())
    h.update(f"{sys.version}|{unicodedata.unidata_version}|{platform.machine()}".encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    """Where this interpreter's build of the library lives."""
    return BUILD_DIR / f"libnanstok-{_key()}.so"


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native tokenizer failed: {' '.join(map(str, cmd))}\n"
                           f"{proc.stdout}{proc.stderr}")


def build() -> Path:
    """Generate the tables and compile the library unless this key's build
    exists. Each output is written to a temporary name and renamed, so
    processes that build at once never see half a file."""
    target = lib_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        _run([sys.executable, str(CSRC / "gen_unicode_tables.py"),
              os.path.join(tmp, "unicode_tables.inc")])
        out = os.path.join(tmp, target.name)
        _run(["g++", "-O2", "-shared", "-fPIC", "-I", tmp, str(CSRC / "tokenizer.cpp"),
              "-o", out])
        os.replace(out, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded library, built first when needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tok_create.restype = ctypes.c_void_p
            lib.tok_create.argtypes = [ctypes.c_char_p]
            lib.tok_destroy.argtypes = [ctypes.c_void_p]
            lib.tok_encode.restype = ctypes.c_int32
            lib.tok_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            lib.tok_encode_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
        return _lib


class FastTokenizer:
    """The native WordPiece tokenizer over ``vocab_file``."""

    def __init__(self, vocab_file: str = DEFAULT_VOCAB):
        self._lib = library()
        self._handle = self._lib.tok_create(vocab_file.encode())
        if not self._handle:
            raise FileNotFoundError(f"the native tokenizer cannot read vocab {vocab_file}")

    def encode(self, text: str, max_tokens: int = 512) -> list:
        """Raw WordPiece ids of one text (no framing), at most ``max_tokens``."""
        raw = text.encode("utf-8")
        out = np.empty((max_tokens,), np.int32)
        n = self._lib.tok_encode(self._handle, raw, len(raw),
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_tokens)
        return out[:n].tolist()

    def encode_batch(self, texts: Sequence[str], context_length: int = 52) -> np.ndarray:
        """``[N, context_length]`` int32: ``[CLS]`` + at most
        ``context_length - 2`` ids + ``[SEP]``, zero padded."""
        n = len(texts)
        raws = [t.encode("utf-8") for t in texts]
        arr = (ctypes.c_char_p * n)(*raws)
        lens = (ctypes.c_int64 * n)(*[len(r) for r in raws])
        out = np.empty((n, context_length), np.int32)
        self._lib.tok_encode_batch(self._handle, arr, lens, n, context_length,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.tok_destroy(self._handle)
            self._handle = None


_default = None


def get_fast_tokenizer(vocab_file: str = DEFAULT_VOCAB) -> FastTokenizer:
    """A :class:`FastTokenizer`; the default vocab's is built once a process."""
    global _default
    if vocab_file != DEFAULT_VOCAB:
        return FastTokenizer(vocab_file)
    if _default is None:
        _default = FastTokenizer()
    return _default
