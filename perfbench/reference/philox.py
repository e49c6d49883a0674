"""Keep masks of the text tower's dropout, as the configuration's training
step defines them: each keep bit is word 0 of Philox4x32-10 (Salmon et
al., SC 2011) keyed by ``(seed, stream)`` with the counter ``(sample,
head, row, col)``; an element is kept where that word is at least
``round(rate * 2^32)`` and then scaled by ``1 / (1 - rate)``. Streams: 0
the attention probabilities (counter ``(sample, head, query, key)``), 1 a
sub-block's hidden output (``(sample, 0, position, column)``), 2 the
embedding output (the same counter). Written from the algorithm's
definition, in int64 arithmetic on 32-bit words.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF
ATTN, HIDDEN, EMBED = 0, 1, 2


def _mul32(a: torch.Tensor, m: int):
    """(hi, lo) words of the 64-bit product a * m, a a tensor of 32-bit
    words in int64: the 16-bit halves of a keep every partial product
    inside 63 bits."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    p_lo = a_lo * m                      # < 2^48
    p_hi = a_hi * m                      # < 2^48
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) # < 2^49
    hi = (p_hi >> 16) + (lo >> 32)
    return hi & MASK, lo & MASK


def word0(c0, c1, c2, c3, key0: int, key1: int) -> torch.Tensor:
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = key0 & MASK, key1 & MASK
    for i in range(10):
        if i:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        hi0, lo0 = _mul32(c0, M0)
        hi1, lo1 = _mul32(c2, M1)
        c0, c1, c2, c3 = (hi1 ^ c1 ^ k0), lo1, (hi0 ^ c3 ^ k1), lo0
    return c0


def keep_scale(seed: int, stream: int, rate: float, sample, head, row, col) -> torch.Tensor:
    """fp32 multipliers: 1 / (1 - rate) where kept, 0 where dropped."""
    bits = word0(sample, head, row, col, seed, stream)
    threshold = min(MASK, int(round(rate * 4294967296.0)))
    return torch.where(bits >= threshold, 1.0 / (1.0 - rate), 0.0).to(torch.float32)


def _ar(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device, dtype=torch.int64)


def hidden(seed: int, stream: int, rate: float, b: int, s: int, w: int, device,
           sample0: int = 0) -> torch.Tensor:
    """[b, s, w] multipliers of a hidden (or embedding) dropout of the
    samples from ``sample0``."""
    return keep_scale(seed, stream, rate, _ar(b, device).view(-1, 1, 1) + sample0, torch.zeros(
        (), dtype=torch.int64, device=device), _ar(s, device).view(1, -1, 1),
        _ar(w, device).view(1, 1, -1))


def attention(seed: int, rate: float, b: int, h: int, s: int, device,
              sample0: int = 0) -> torch.Tensor:
    """[b, h, s, s] multipliers of the attention-probability dropout of the
    samples from ``sample0``."""
    return keep_scale(seed, ATTN, rate, _ar(b, device).view(-1, 1, 1, 1) + sample0,
                      _ar(h, device).view(1, -1, 1, 1), _ar(s, device).view(1, 1, -1, 1),
                      _ar(s, device).view(1, 1, 1, -1))
