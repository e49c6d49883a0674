"""Linear layer with a fused epilogue, and its kernel ``csrc/gemm.cu``.

``linear`` computes ``A . W^T`` with bf16 inputs and fp32 accumulation,
then, in fp32, ``+ bias``, an optional activation and an optional
``+ residual``, and stores bf16 (or fp32 where a post-LN follows). These
are the matrix products inside ``nans_clip_tpu/ops/fused_block.py::_kernel``
(QKV :120, out-projection :185) and ``::_mlp_kernel`` (fc1 :809, fc2 :816),
with their rounding points. ``W`` is the torch Linear layout ``[out, in]``.

``linear_plain`` is the twin; CPU tensors take it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from nans_clip_tpu_torch.ops import _build, gates
from nans_clip_tpu_torch.ops.activations import ACT2FN

_ACT_CODES = {None: 0, "quick_gelu": 1, "gelu": 2}


def linear_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 act: Optional[str] = None, residual: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Twin of the kernel: the product of the (possibly bf16) operands in
    fp32, the epilogue in fp32, one cast at the end."""
    y = F.linear(a.float(), w.float(), bias.float())
    if act is not None:
        y = ACT2FN[act](y)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype or a.dtype)


def linear(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
           act: Optional[str] = None, residual: Optional[torch.Tensor] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a``: [..., K]; ``w``: [N, K]; ``bias``: [N]; ``residual``: [..., N].
    CPU tensors take :func:`linear_plain`; CUDA tensors launch the kernel
    (bf16 operands; output bf16 or fp32)."""
    if not a.is_cuda:
        return linear_plain(a, w, bias, act, residual, out_dtype)
    n, k = w.shape
    gates.admit(a.shape[-1] == k, f"gemm: a {tuple(a.shape)} vs w {tuple(w.shape)}")
    gates.admit(n % gates.GEMM_N_MULTIPLE == 0 and k % gates.GEMM_K_MULTIPLE == 0,
                f"gemm: N={n} K={k}")
    out_dtype = out_dtype or a.dtype
    gates.admit(out_dtype in (gates.KERNEL_DTYPE, torch.float32), f"gemm: output {out_dtype}")
    operands = (a, w, bias) if residual is None else (a, w, bias, residual)
    gates.admit_cuda("gemm", *operands)
    m = a.numel() // k
    out = torch.empty((*a.shape[:-1], n), dtype=out_dtype, device=a.device)
    err = _build.library().nans_gemm(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.float32), m, n, k, _ACT_CODES[act],
        _build.stream_ptr(a.device))
    _build.check(err, "nans_gemm")
    linear.launches += 1
    return out


linear.launches = 0
