"""Build and load the hand-written CUDA kernels.

``nans_clip_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, on first use, into the
git-ignored ``nans_clip_tpu_torch/build/`` directory, and loaded with
``ctypes``. The library is rebuilt when a source is newer than it. Only
the sources in the package are compiled.

Every C entry point takes pointers and the CUDA stream as ``c_void_p`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises when
that is not 0, so a refused launch is never silent.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
LIB_PATH = BUILD_DIR / "libnans_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, x_is_fp32, gamma, beta, y, rows, width, eps, stream
    "nans_layernorm": [_P, _I, _P, _P, _P, _I, _I, _F, _P],
    # A, W, bias, residual, C, out_fp32, M, N, K, act, stream
    "nans_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # qkv, key_bias, ctx, B, S, width, scale, stream
    "nans_attention": [_P, _P, _P, _I, _I, _I, _F, _P],
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = sources() + sorted(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def build() -> str:
    """Compile the library if it is missing or stale; returns nvcc's
    report (registers, shared memory, spills), or '' when up to date."""
    if not _stale():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream
