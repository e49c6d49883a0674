"""The port's routing and admission table for the hand-written CUDA kernels.

Counterpart of ``nans_clip_tpu/ops/gates.py``, which records TPU constants
(VMEM budgets, Mosaic lane rules, tiles) settled on a TPU. None of those
carry over: each entry here is the port's own and says how it was settled.

Routing (which function a tower calls) is decided on the host from the
tensor's device, its dtype and the model's ``attn_impl``:

* ``plain`` always runs the plain-torch twins;
* ``kernel`` runs the kernels and raises for a tensor off the card;
* ``auto`` runs the kernels on CUDA tensors and the twins on CPU tensors.

Under ``auto`` and ``kernel`` a CUDA tensor in another dtype than
``KERNEL_DTYPE`` raises: the plain path on the card is reached only by
asking for ``plain``.

Admission (what a kernel takes) is checked by each wrapper before it
launches; a CUDA tensor that the kernel does not admit raises. No path
turns a failed build or launch into the plain path.
"""

from __future__ import annotations

import torch

# io dtype of the kernels. Chosen for bring-up: the slice runs in bf16
# (bench and serving are bf16 inference); not yet measured on H100.
KERNEL_DTYPE = torch.bfloat16

# attention.cu: one head is 64 wide (every ViT-B/L and RoBERTa tower) and a
# head's K and V sit in shared memory, 144 bytes a key each: S <= 640 keeps
# the block inside the card's 227 KB. Set by the kernel's design.
HEAD_DIM = 64
MAX_SEQ = 640

# layernorm.cu: one warp a row, 32 values a lane at most. Set by the design.
MAX_LN_WIDTH = 1024
LN_WIDTH_MULTIPLE = 32

# gemm.cu: 128x128x32 block tiles with no N or K tail. Set by the design;
# the slice's N (768, 2304, 3072) and K (768, 3072) all qualify.
GEMM_N_MULTIPLE = 128
GEMM_K_MULTIPLE = 32

IMPLS = ("auto", "plain", "kernel")


def use_kernel(x: torch.Tensor, impl: str) -> bool:
    """True when a tower should call the kernel wrappers for ``x``."""
    if impl not in IMPLS:
        raise ValueError(f"attn_impl must be one of {IMPLS}, got {impl!r}")
    if impl == "plain":
        return False
    if not x.is_cuda:
        if impl == "kernel":
            raise ValueError("attn_impl='kernel' needs CUDA tensors")
        return False
    if x.dtype != KERNEL_DTYPE:
        raise ValueError(f"the kernels take {KERNEL_DTYPE} on CUDA, got {x.dtype}: pass "
                         "ModelOptions(compute_dtype='bfloat16'), or attn_impl='plain' "
                         "for the plain-torch path")
    return True


def admit(ok: bool, what: str) -> None:
    """Raise for a CUDA tensor that a kernel does not take."""
    if not ok:
        raise ValueError(f"kernel does not admit this input: {what}")


def admit_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel io: CUDA, contiguous, the kernel dtype, 16-byte aligned."""
    for t in tensors:
        admit(t.is_cuda and t.is_contiguous(), f"{name}: tensors must be contiguous on CUDA")
        admit(t.dtype == KERNEL_DTYPE, f"{name}: dtype {t.dtype}, kernels take {KERNEL_DTYPE}")
        admit(t.data_ptr() % 16 == 0, f"{name}: tensor not 16-byte aligned")
