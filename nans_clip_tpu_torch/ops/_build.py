"""Build and load the hand-written CUDA kernels.

``nans_clip_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, on first use, into the
git-ignored ``nans_clip_tpu_torch/build/`` directory, and loaded with
``ctypes``. The library is rebuilt when a source is newer than it. Only
the sources in the package are compiled.

Every C entry point takes pointers and the CUDA stream as ``c_void_p`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises when
that is not 0, so a refused launch is never silent.

:data:`LOAD` counts, for this process, the ``nvcc`` processes the build
ran (0 when the library was up to date) and the seconds :func:`library`
took to build and load it; where nvcc ran, :func:`library` logs both as a
warning, so that a rebuild from a missing or stale library shows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
LIB_PATH = BUILD_DIR / "libnans_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_LL = ctypes.POINTER(ctypes.c_longlong)
_DROP = [_U, _U, _U, _F, _I, _I]   # seed, stream, threshold, scale, on, sample0 (ops/dropout.py)
_SIGNATURES = {
    # x, x_is_fp32, gamma, beta, y, rows, width, eps, stream
    "nans_layernorm": [_P, _I, _P, _P, _P, _I, _I, _F, _P],
    # form, gin, x, gamma, res, dx, dproj, xhat, drop..., seq, part, rows, width, sms,
    # eps, stream
    "nans_layernorm_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, *_DROP, _I, _P, _I, _I, _I, _F, _P],
    # rows, width, sms, out int[4]: the backward's launch plan
    "nans_layernorm_bwd_plan": [_I, _I, _I, ctypes.POINTER(_I)],
    # A, W, w_trans, bias, act, dact, aux, drop..., drop_seq, residual, res_f32,
    # C, c_f32, c_pre, c2, M, N, K, stream
    "nans_gemm": [_P, _P, _I, _P, _I, _I, _P, *_DROP, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                  _P],
    # M, N, K, out int[10]: the forward form's launch plan
    "nans_gemm_plan": [_I, _I, _I, ctypes.POINTER(_I)],
    # M, N, K, out int[10]: the input gradient's
    "nans_gemm_dgrad_plan": [_I, _I, _I, ctypes.POINTER(_I)],
    # M, N, K, splits, ktiles_per_split, out int[10]: the weight gradient's
    "nans_gemm_wgrad_plan": [_I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    # dY, X, partials, M, N, K, splits, ktiles_per_split, stream
    "nans_gemm_wgrad": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, x_f32, rows, cols, rows_per_chunk, out, stream
    "nans_colsum": [_P, _I, _I, _I, _I, _P, _P],
    # x (fp32), rows, cols, out, stream
    "nans_colsum_split": [_P, _I, _I, _P, _P],
    # qkv, key_bias, ctx, stats, B, S, width, dh, scale, drop..., sms, stream
    "nans_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, *_DROP, _I, _P],
    # B, H, S, dh, sms, out int[7]: the forward's launch plan
    "nans_attention_plan": [_I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    # qkv, dctx, key_bias, stats, dqkv32, dqkv16, B, S, width, dh, scale, drop..., stream
    "nans_attention_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, *_DROP, _P],
    # S, dh, drop_on, out int[4]: the one-shot backward's launch plan
    "nans_attention_bwd_plan": [_I, _I, _I, ctypes.POINTER(_I)],
    # qkv, dctx, stats, delta, dqkv32, dqkv16, B, S, width, dh, scale, stream
    "nans_attention_bwd_long": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # S, dh, out int[5]: the long-sequence backward's launch plan
    "nans_attention_bwd_long_plan": [_I, _I, ctypes.POINTER(_I)],
    # q, k, v, bias, o, lse, strides (int64 [4][3]), B, H, S, dh, scale, stream
    "nans_flash_fwd": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P],
    # S, dh, out int[4]: #22's launch plan
    "nans_flash_fwd_plan": [_I, _I, ctypes.POINTER(_I)],
    # q, k, v, bias, o, dout, lse, delta, dq, dk, dv, strides (int64 [8][3]), B, H, S,
    # dh, scale, stream
    "nans_flash_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P],
    # S, dh, out int[6]: #23's launch plan
    "nans_flash_bwd_plan": [_I, _I, ctypes.POINTER(_I)],
    # mode, S, dh, out: the largest co-resident grid
    "nans_tower_grid": [_I, _I, _I, ctypes.POINTER(_I)],
    # mode, B, S, W, I, dh, grid, out int[10]: the tower's launch plan
    "nans_tower_plan": [_I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    # table (host int64 [L][16]), L, W, I, quant, out (host, L * 4 tensor maps)
    "nans_tower_maps": [_P, _I, _I, _I, _I, _P],
    # x, key_bias, table, wmaps, work, sum, part, wbuf, sem, clock, B, S, W, I, L, dh,
    # eps, scale, act, post_ln, mode, ks_qkv, ks_o, ks_1, ks_2, grid, stream
    "nans_tower": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                   _I, _I, _I, _I, _I, _I, _I, _P],
}


# Sources compiled as several objects, one nvcc each with -DNANS_PART=i:
# the build waits for its longest compile, and attention.cu's forward
# instances alone took most of it (csrc/attention.cu's note).
PARTS = {"attention.cu": 3}


@dataclasses.dataclass
class LibraryLoad:
    nvcc_runs: int = 0                 # compiles and the link, in this process
    seconds: Optional[float] = None    # library()'s build and load; None before it


LOAD = LibraryLoad()


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _units() -> list:
    """(source, -D flags, object name) of each nvcc of the build."""
    return [(src, [f"-DNANS_PART={i}"] if src.name in PARTS else [],
             f"{src.stem}.{i}.o" if src.name in PARTS else f"{src.stem}.o")
            for src in sources() for i in range(PARTS.get(src.name, 1))]


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
    """Compile the library if it is missing or stale: one nvcc a source (a
    part of one, :data:`PARTS`), all started together, then one link.
    Returns nvcc's report (registers, shared memory, spills), or '' when up
    to date."""
    if not _stale():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = _units()
        objs = [os.path.join(tmp, obj) for _, _, obj in units]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *defs, "-c", "-I", str(CSRC), "-o", obj,
                                   str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for (src, defs, _), obj in zip(units, objs)]
        LOAD.nvcc_runs += len(procs)
        reports = [(src, defs, proc, proc.communicate()[1])
                   for (src, defs, _), proc in zip(units, procs)]
        for src, defs, proc, err in reports:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} {' '.join(defs)} "
                                   f"({proc.returncode}):\n{err}")
        lib = os.path.join(tmp, LIB_PATH.name)
        LOAD.nvcc_runs += 1
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, LIB_PATH)
    return "".join(err for _, _, _, err in reports)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    t0, runs = time.perf_counter(), LOAD.nvcc_runs
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    LOAD.seconds = time.perf_counter() - t0
    if LOAD.nvcc_runs > runs:
        logging.getLogger(__name__).warning(
            "built the kernel library %s: %d nvcc runs, %.1f s", LIB_PATH,
            LOAD.nvcc_runs - runs, LOAD.seconds)
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({_ERRORS.get(err, 'see cudaError_t')}) "
                           "at launch")


# cudaError_t values a launch here can return (driver_types.h)
_ERRORS = {1: "cudaErrorInvalidValue", 2: "cudaErrorMemoryAllocation",
           9: "cudaErrorInvalidConfiguration", 98: "cudaErrorInvalidDeviceFunction",
           209: "cudaErrorNoKernelImageForDevice",
           720: "cudaErrorCooperativeLaunchTooLarge"}


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream
