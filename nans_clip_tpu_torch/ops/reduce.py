"""Column sums in a fixed order, and their kernel ``csrc/reduce.cu``.

The backward kernels of ``nans_clip_tpu/ops/fused_block_bwd.py`` carried
their bias and LayerNorm gradients as fp32 sums across a batch grid that
the TPU ran in order. On the card those sums are taken in two passes with
no atomics (partials per chunk of rows, then the partials in chunk order),
so two runs give the same bits. ``column_sum_plain`` is the twin; CPU
tensors take it. A sum over at most ``ONE_PASS_ROWS`` rows takes one
launch a thread a column; fp32 over at most ``SPLIT_ROWS`` (the LayerNorm
backward's partials of all its planes at once, a first pass's chunk sums)
one launch of the kernel whose warps split the rows; longer inputs a first
pass over chunks of ``ROWS_PER_CHUNK`` rows.
"""

from __future__ import annotations

import torch

from nans_clip_tpu_torch.ops import _build, gates
from nans_clip_tpu_torch.ops.activations import upcast

ROWS_PER_CHUNK = 256
# A sum over at most this many rows is taken in one pass, a thread a column.
ONE_PASS_ROWS = 64
# An fp32 sum over at most this many rows is taken in one pass, 8 warps of a
# block over every 8th row of 32 columns.
SPLIT_ROWS = 512


def column_sum_plain(x: torch.Tensor) -> torch.Tensor:
    return upcast(x).sum(dim=0)


def _colsum(x: torch.Tensor, rows_per_chunk: int) -> torch.Tensor:
    rows, cols = x.shape
    out = torch.empty((-(-rows // rows_per_chunk), cols), dtype=torch.float32, device=x.device)
    err = _build.library().nans_colsum(x.data_ptr(), int(x.dtype == torch.float32), rows, cols,
                                       rows_per_chunk, out.data_ptr(),
                                       _build.stream_ptr(x.device))
    _build.check(err, "nans_colsum")
    column_sum.launches += 1
    return out


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``: [rows, cols] bf16 or fp32; returns the fp32 [cols] sum over the
    rows. CPU tensors take :func:`column_sum_plain`."""
    if not x.is_cuda:
        return column_sum_plain(x)
    gates.admit(x.dim() == 2 and x.is_contiguous()
                and x.dtype in (gates.KERNEL_DTYPE, torch.float32),
                "colsum: x must be contiguous bf16 or fp32 [rows, cols]")
    rows, cols = x.shape
    if rows > SPLIT_ROWS or (rows > ONE_PASS_ROWS and x.dtype != torch.float32):
        x = _colsum(x, ROWS_PER_CHUNK)
        rows = x.shape[0]
    if rows <= ONE_PASS_ROWS:
        return _colsum(x, max(1, rows))[0]
    out = torch.empty(cols, dtype=torch.float32, device=x.device)
    err = _build.library().nans_colsum_split(x.data_ptr(), rows, cols, out.data_ptr(),
                                             _build.stream_ptr(x.device))
    _build.check(err, "nans_colsum_split")
    column_sum.launches += 1
    return out


column_sum.launches = 0
