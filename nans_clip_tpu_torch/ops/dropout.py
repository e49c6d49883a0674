"""Dropout keep masks that the backward can redraw, and their plain twin.

Counterpart of the in-kernel dropout of ``nans_clip_tpu/ops/fused_block.py``
(``_keep_mask`` :66, re-seeded per sample at :132 and in the backward
kernels at ``fused_block_bwd.py:303``). The TPU kernels drew keep bits from
the core's PRNG and the backward re-seeded the same stream. On the card each
keep bit is a pure function of its indices instead: Philox4x32-10 keyed by
``(seed, stream)`` with the counter ``(sample, head, row, col)``; word 0 of
the output is kept where ``bits >= rate * 2^32`` (``_keep_mask``'s rule) and
scaled by ``1 / (1 - rate)``. The kernels (``csrc/dropout.cuh``) and this
module compute the same bits, so a kernel and its twin draw the same masks
and a backward redraws its forward's mask with nothing stored. The bits are
not the TPU's.

Streams: 0 attention probabilities (counter ``(sample, head, query, key)``),
1 the hidden dropout of a sub-block's projection (``(sample, 0, row,
col)``), 2 the text tower's embedding dropout.

Under tensor parallelism (``parallel/tp.py``) a rank computes heads ``head0``
to ``head0 + heads / tp`` of the layer: its attention spec carries that
``head0``, so the rank counts by the global head index and tp ranks together
draw the masks one process draws (the GSPMD semantics of the JAX package,
where a mask is drawn on the global array). Under data parallelism
(``training/trainer.py``) a rank holds rows ``sample0`` to ``sample0 + B``
of each global microbatch: every spec of its draw carries that ``sample0``
(a :class:`Seed` carries it from the text tower to every sub-block), the
kernels take it too, and data ranks together draw the masks one process
draws over the global microbatch.
"""

from __future__ import annotations

import dataclasses

import torch

STREAM_ATTN, STREAM_HIDDEN, STREAM_EMBED = 0, 1, 2

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Dropout:
    """One dropout draw: ``seed`` (an int32 drawn from the caller's
    generator), ``rate``, ``stream``; ``seq`` is the sequence length that
    splits a flat row index into (sample, row) for the hidden masks;
    ``head0`` is the global index of the first head of an attention mask
    (a tensor-parallel rank's offset; the kernels take 0 only);
    ``sample0`` the global index of the first sample (a data-parallel
    rank's offset in the microbatch; the kernels take it)."""

    seed: int
    rate: float
    stream: int
    seq: int = 0
    head0: int = 0
    sample0: int = 0

    def __post_init__(self):
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {self.rate}")

    @property
    def on(self) -> bool:
        return self.rate > 0.0

    @property
    def threshold(self) -> int:
        return min(_MASK32, int(round(self.rate * 4294967296.0)))

    @property
    def scale(self) -> float:
        return 1.0 / (1.0 - self.rate)

    def kernel_args(self) -> tuple:
        """(seed, stream, threshold, scale, on, sample0) as the kernels take
        them."""
        if not self.on:
            return 0, 0, 0, 1.0, 0, 0
        if self.head0:
            raise ValueError("the kernels count heads from 0: a head offset runs the twins")
        return self.seed & _MASK32, self.stream, self.threshold, self.scale, 1, self.sample0


@dataclasses.dataclass(frozen=True)
class Seed:
    """A sub-block's dropout seed drawn for a global microbatch, and the
    global index of the first sample of the rows this process holds (a
    data-parallel rank's offset). :func:`sub_block` takes it or a bare int
    (offset 0)."""

    value: int
    sample0: int = 0


def kernel_args(spec) -> tuple:
    """The kernel arguments of ``spec``, or those of no dropout for None."""
    return (0, 0, 0, 1.0, 0, 0) if spec is None else spec.kernel_args()


def active(spec) -> bool:
    return spec is not None and spec.on


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit halves of a * m for a in [0, 2^32), in int64
    without overflow: a is split into 16-bit halves."""
    t = (a & 0xFFFF) * m
    u = (a >> 16) * m
    mid = ((u & 0xFFFF) << 16) + t
    return (u >> 16) + (mid >> 32), mid & _MASK32


def philox_word0(c0, c1, c2, c3, k0: int, k1: int) -> torch.Tensor:
    """Word 0 of Philox4x32-10 for int64 counter tensors (broadcast) and a
    two-word key, as ``csrc/dropout.cuh::philox_word0``."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def multiplier(spec: Dropout, sample, head, row, col) -> torch.Tensor:
    """fp32 keep multipliers (scale where kept, 0 where dropped) for int64
    index tensors that broadcast together."""
    bits = philox_word0(sample, head, row, col, spec.seed & _MASK32, spec.stream)
    return torch.where(bits >= spec.threshold, spec.scale, 0.0).float()


def hidden_multiplier(spec: Dropout, rows: int, width: int, device) -> torch.Tensor:
    """[rows, width] multipliers of a hidden dropout over B*S flat rows."""
    r = torch.arange(rows, device=device, dtype=torch.int64)[:, None]
    col = torch.arange(width, device=device, dtype=torch.int64)[None, :]
    return multiplier(spec, r // spec.seq + spec.sample0, torch.zeros_like(r), r % spec.seq, col)


def attention_multiplier(spec: Dropout, batch: int, heads: int, seq: int,
                         device) -> torch.Tensor:
    """[B, H, S, S] multipliers of the attention-probability dropout, for
    the samples from ``spec.sample0`` and the heads ``spec.head0`` to
    ``spec.head0 + heads``."""
    ar = lambda n: torch.arange(n, device=device, dtype=torch.int64)
    return multiplier(spec, ar(batch).view(-1, 1, 1, 1) + spec.sample0,
                      ar(heads).view(1, -1, 1, 1) + spec.head0, ar(seq).view(1, 1, -1, 1),
                      ar(seq).view(1, 1, 1, -1))


def sub_block(seed, attn_rate: float, hid_rate: float, seq: int):
    """The (attention-probability, hidden) dropouts of one sub-block drawn
    with ``seed`` (an int, or a :class:`Seed` with its sample offset); None
    where a rate is 0. A rate above 0 needs a seed."""
    if seed is None:
        if attn_rate > 0.0 or hid_rate > 0.0:
            raise ValueError("dropout needs a seed")
        return None, None
    value, sample0 = (seed.value, seed.sample0) if isinstance(seed, Seed) else (int(seed), 0)
    attn = Dropout(value, attn_rate, STREAM_ATTN, sample0=sample0) if attn_rate > 0.0 else None
    hid = Dropout(value, hid_rate, STREAM_HIDDEN, seq, sample0=sample0) if hid_rate > 0.0 \
        else None
    return attn, hid


def apply(x: torch.Tensor, spec: Dropout) -> torch.Tensor:
    """Plain-torch dropout of a [B, S, W] tensor with the hidden mask of
    ``spec``: ``where(keep, x / (1 - rate), 0)`` in x's dtype, as
    ``nans_clip_tpu/ops/activations.py::dropout`` computes it."""
    if not spec.on:
        return x
    b, s, w = x.shape
    keep = hidden_multiplier(spec, b * s, w, x.device).view(b, s, w) > 0
    return torch.where(keep, x / (1.0 - spec.rate), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))
