"""Image preprocessing and augmentation on the card (counterpart of
``nans_clip_tpu/data/augment.py``), on uint8 batches from the loader:

* RandomResizedCrop(scale=(0.9, 1.0), ratio=(3/4, 4/3)) with the Keys cubic
  (a = -0.5) over the continuous crop box: ``jax.image.scale_and_translate
  (method="cubic")``'s separable weight matrices, one an axis and an image,
  applied as two products (:func:`resized_crop`). ``F.interpolate``'s
  bicubic is another function: a = -0.75, and no translation;
* a horizontal flip with probability 1/2 (timm's default);
* AutoAugment's ImageNet policy (``data/autoaugment.py``);
* without augmentation, a cubic resize when the decoded size differs from
  the model's (``jax.image.resize(..., "cubic")``, antialiased when it
  shrinks);
* OpenAI-CLIP mean/std normalisation.

The crop boxes, flips and policy draws come from a ``torch.Generator`` on
the CPU (small tensors), the pixel work runs where the images are. This was
plain XLA in the JAX package, so it is plain torch here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nans_clip_tpu_torch.data import autoaugment
from nans_clip_tpu_torch.utils.transform import OPENAI_MEAN, OPENAI_STD

_EPS32 = float(torch.finfo(torch.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
               translation: torch.Tensor) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` with the cubic kernel and
    antialiasing, one matrix an image: [N, out_size, in_size], row o the
    weights output pixel o takes from the input, for an output that samples
    the input at ``(o + 0.5 - translation) / scale - 0.5``. ``scale``,
    ``translation``: float32 [N]."""
    inv = (1.0 / scale).view(-1, 1, 1)
    kernel_scale = torch.clamp(inv, min=1.0)
    dev = scale.device
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev).view(1, -1, 1) + 0.5)
              * inv - translation.view(-1, 1, 1) * inv - 0.5)
    x = (sample - torch.arange(in_size, dtype=torch.float32, device=dev).view(1, 1, -1)).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(dim=2, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def _warp(x: torch.Tensor, out_size: int, sy, sx, ty, tx) -> torch.Tensor:
    """x float32 [N, H, W, 3] -> [N, out, out, 3] through the two weight
    matrices (rows, then columns)."""
    wy = weight_mat(x.shape[1], out_size, sy, ty)
    wx = weight_mat(x.shape[2], out_size, sx, tx)
    x = torch.einsum("noh,nhwc->nowc", wy, x)
    return torch.einsum("npw,nowc->nopc", wx, x)


def draw_crop_boxes(generator: Optional[torch.Generator], n: int, h: int, w: int,
                    scale=(0.9, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)) -> torch.Tensor:
    """RandomResizedCrop's boxes, [n, 4] float32 (y0, x0, height, width):
    the area a uniform share ``scale`` of the image's, the aspect
    log-uniform in ``ratio``, the sides clipped to [1, image side], the
    corner uniform over what is left."""
    u = torch.rand(n, 4, generator=generator)
    area = h * w * (scale[0] + (scale[1] - scale[0]) * u[:, 0])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + (hi - lo) * u[:, 1])
    cw = torch.clamp(torch.sqrt(area * aspect), 1.0, w)
    ch = torch.clamp(torch.sqrt(area / aspect), 1.0, h)
    x0 = u[:, 2] * (w - cw)
    y0 = u[:, 3] * (h - ch)
    return torch.stack([y0, x0, ch, cw], dim=1)


def resized_crop(x: torch.Tensor, boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Each image's box (:func:`draw_crop_boxes`' layout) resampled to
    [out, out] with the cubic kernel: ``jax.image.scale_and_translate`` at
    scale out / side and translation -corner * scale, a box's edge landing
    on the output's edge."""
    return _warp(x, out_size, *crop_scale_translation(boxes.to(x.device), out_size))


def crop_scale_translation(boxes: torch.Tensor, out_size: int):
    """A box's (sy, sx, ty, tx), float32 [N] each, as JAX computes them: the
    scales by a correctly rounded division (``out / side`` on a tensor is a
    reciprocal times ``out`` in torch, up to an ulp off, which moves a 256 ->
    224 crop's pixels by 1e-2)."""
    y0, x0, ch, cw = boxes.float().unbind(1)
    sy = torch.full_like(ch, float(out_size)) / ch
    sx = torch.full_like(cw, float(out_size)) / cw
    return sy, sx, -y0 * sy, -x0 * sx


def resize(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``jax.image.resize(x, (N, out, out, 3), "cubic")``: an axis whose size
    is already ``out_size`` is left as it is."""
    n, h, w, _ = x.shape
    one = lambda v: torch.full((n,), v, dtype=torch.float32, device=x.device)
    zero = one(0.0)
    if h != out_size:
        wy = weight_mat(h, out_size, one(out_size / h), zero)
        x = torch.einsum("noh,nhwc->nowc", wy, x)
    if w != out_size:
        wx = weight_mat(w, out_size, one(out_size / w), zero)
        x = torch.einsum("npw,nowc->nopc", wx, x)
    return x


def draw_augment(generator: Optional[torch.Generator], n: int, h: int, w: int):
    """All of a batch's draws, in order: the crop boxes, the flips, the
    AutoAugment policy (:func:`autoaugment.draw_policy`)."""
    boxes = draw_crop_boxes(generator, n, h, w)
    flip = torch.rand(n, generator=generator) < 0.5
    return boxes, flip, autoaugment.draw_policy(generator, n)


def preprocess_images(generator: Optional[torch.Generator], raw, out_size: int,
                      augment: bool = False, rows=None) -> torch.Tensor:
    """uint8 [N, H, W, 3] (on the card, or any device) -> normalised float32
    [N, out, out, 3] on the same device. ``augment``: crop, flip and
    AutoAugment, drawn from ``generator`` (a CPU ``torch.Generator``).
    ``rows``: ``(n, index)`` where ``raw`` holds the rows ``index`` (an
    int64 tensor of N) of a global batch of n (a data-parallel rank's
    rows): the draws are made for the n rows and each image takes its
    row's, so that the ranks together draw what one process draws."""
    raw = torch.as_tensor(raw)
    x = raw.float()
    n, h, w, _ = x.shape
    if augment:
        if rows is None:
            boxes, flip, policy = draw_augment(generator, n, h, w)
        else:
            boxes, flip, policy = (t[rows[1]] if torch.is_tensor(t) else
                                   tuple(u[rows[1]] for u in t)
                                   for t in draw_augment(generator, rows[0], h, w))
        x = resized_crop(x, boxes, out_size).clamp(0.0, 255.0)
        x = torch.where(flip.to(x.device).view(-1, 1, 1, 1), x.flip(2), x)
        x = autoaugment.auto_augment(x, *policy)
    elif h != out_size or w != out_size:
        x = resize(x, out_size)
    x = x / 255.0
    mean = torch.tensor(OPENAI_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(OPENAI_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std

