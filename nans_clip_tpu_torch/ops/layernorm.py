"""LayerNorm with fp32 statistics, and its kernel ``csrc/layernorm.cu``.

``layer_norm`` is the plain version (counterpart of
``nans_clip_tpu/ops/layernorm.py::layer_norm``): the towers call it where
the JAX package left LayerNorm to XLA (``ln_pre``, ``ln_post``, the BERT
embedding LN), and it is the twin of the kernel.

``row_layer_norm`` launches ``layernorm.cu`` for CUDA tensors: the LN
stages inside the ported sub-block kernels (pre-LN prologue, post-LN
epilogue on the fp32 residual sum). It replaces the ``_ln`` stages of
``nans_clip_tpu/ops/fused_block.py::_kernel`` and ``::_mlp_kernel``.
"""

from __future__ import annotations

from typing import Optional

import torch

from nans_clip_tpu_torch.ops import _build, gates


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Mean, then mean of squared deviations, both in fp32; the result is
    cast to ``out_dtype`` (default: the dtype of ``x``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(out_dtype or x.dtype)


def row_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over the last axis. CPU tensors take :func:`layer_norm`;
    CUDA tensors launch the kernel: ``x`` bf16 or fp32, params and output
    bf16."""
    if not x.is_cuda:
        return layer_norm(x, weight, bias, eps, out_dtype)
    width = x.shape[-1]
    gates.admit(x.is_contiguous() and x.dtype in (torch.float32, gates.KERNEL_DTYPE),
                "layernorm: x must be contiguous bf16 or fp32")
    gates.admit(width % gates.LN_WIDTH_MULTIPLE == 0 and width <= gates.MAX_LN_WIDTH,
                f"layernorm: width {width}")
    gates.admit((out_dtype or gates.KERNEL_DTYPE) == gates.KERNEL_DTYPE,
                "layernorm: output is bf16")
    gates.admit_cuda("layernorm", weight, bias)
    y = torch.empty(x.shape, dtype=gates.KERNEL_DTYPE, device=x.device)
    rows = x.numel() // width
    err = _build.library().nans_layernorm(
        x.data_ptr(), int(x.dtype == torch.float32), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), rows, width, float(eps), _build.stream_ptr(x.device))
    _build.check(err, "nans_layernorm")
    row_layer_norm.launches += 1
    return y


row_layer_norm.launches = 0
