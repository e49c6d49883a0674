"""AutoAugment 'original' (ImageNet policy) on the card, batched over images
(counterpart of ``nans_clip_tpu/data/autoaugment.py``).

The reference's train transform is timm ``create_transform(...,
auto_augment='original')`` on host workers (training/data.py:72-83). Here
each image draws one of the 25 sub-policies, each of its two (op,
probability, level) slots applies with its probability, and the images that
apply one op go through it together. The ops and their level mappings are
the JAX package's (timm's ORIGINAL-policy conventions, level denominator
10):

* Posterize keeps ``4 + int(level/10*4)`` bits; Solarize's threshold is
  ``int(level/10*256)`` (a higher level is milder); the enhance factors
  (Color, Contrast, Brightness, Sharpness) are ``level/10*1.8 + 0.1``,
  never negated; Rotate and Shear are ``level/10*{30 degrees, 0.3}``,
  negated with probability 1/2;
* Rotate and Shear sample bilinearly (``map_coordinates`` order 1, PIL's
  pixel-centre convention) and fill with timm's ``img_mean`` gray
  :data:`FILL`; this is the JAX package's documented deviation from timm's
  bicubic sampling, kept;
* Equalize builds ``ImageOps.equalize``'s LUT; Sharpness blends with PIL's
  SMOOTH filter, the 1-pixel border unfiltered; AutoContrast remaps each
  channel's min..max to 0..255.

Images are float [k, H, W, 3] in [0, 255]; ``level`` and ``sign`` are [k]
tensors, one entry an image. The draws come from a ``torch.Generator``, so
the port's stream is its own: the JAX package draws with ``jax.random``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# timm aa_params img_mean: round(255 * CLIP mean), the geometric ops' fill
FILL = (123, 117, 104)

# The canonical AutoAugment ImageNet ("original") policy:
# 25 sub-policies of ((op, prob, magnitude), (op, prob, magnitude)).
IMAGENET_POLICY = [
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, 7), ("Solarize", 0.4, 4)),
    (("Equalize", 0.4, 4), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, 7)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, 2)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, 8), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, 2)),
    (("Equalize", 0.0, 7), ("Equalize", 0.8, 8)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, 8)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, 9)),
    (("Color", 0.4, 0), ("Equalize", 0.6, 3)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
]

OP_NAMES = ["Identity", "Posterize", "Rotate", "Solarize", "AutoContrast",
            "Equalize", "Invert", "Color", "Contrast", "Brightness",
            "Sharpness", "ShearX", "ShearY"]
_OP_INDEX = {n: i for i, n in enumerate(OP_NAMES)}
# only the geometric ops are randomly negated (timm never negates the
# enhance factors)
SIGNED_OPS = frozenset(_OP_INDEX[n] for n in ("Rotate", "ShearX", "ShearY"))


def _col(t: torch.Tensor) -> torch.Tensor:
    """[k] -> [k, 1, 1, 1], to broadcast over the images."""
    return t.view(-1, 1, 1, 1)


def identity(img, level, sign):
    return img


def posterize(img, level, sign):
    shift = (8 - (4 + (level * 0.4).to(torch.int32))).to(torch.uint8)
    xi = img.clamp(0, 255).to(torch.uint8)
    return ((xi >> _col(shift)) << _col(shift)).to(img.dtype)


def solarize(img, level, sign):
    thresh = _col(torch.floor(level * 25.6))
    return torch.where(img >= thresh, 255.0 - img, img)


def invert(img, level, sign):
    return 255.0 - img


def autocontrast(img, level, sign):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-5)
    return torch.where(hi > lo, (img - lo) * scale, img)


def equalize(img, level, sign):
    """``ImageOps.equalize``'s LUT a channel: step = (pixels - count of the
    last used level) // 255, lut[i] = (step // 2 + pixels below i) // step,
    the identity where step is 0."""
    k, h, w, c = img.shape
    xi = img.clamp(0, 255).to(torch.int64).permute(0, 3, 1, 2).reshape(k * c, h * w)
    hist = torch.zeros(k * c, 256, dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, xi, torch.ones_like(xi))
    levels = torch.arange(256, device=img.device)
    last = torch.where(hist > 0, levels, -1).amax(dim=1, keepdim=True)
    step = (h * w - hist.gather(1, last)) // 255
    cum = torch.cumsum(hist, dim=1) - hist
    lut = ((step // 2 + cum) // step.clamp(min=1)).clamp(0, 255)
    out = lut.gather(1, xi).to(img.dtype)
    flat = img.permute(0, 3, 1, 2).reshape(k * c, h * w)
    out = torch.where(step == 0, flat, out)
    return out.view(k, c, h, w).permute(0, 2, 3, 1)


def _blend(a, b, factor):
    return torch.clamp(b + (a - b) * _col(factor), 0.0, 255.0)


def _enhance_factor(level):
    return level * 0.18 + 0.1


def _gray(img):
    """ITU-R 601-2 luma, floored, as PIL's ``convert("L")``: [k, H, W]."""
    return torch.floor((img[..., 0] * 299 + img[..., 1] * 587 + img[..., 2] * 114) / 1000.0)


def color(img, level, sign):
    return _blend(img, _gray(img)[..., None].expand_as(img), _enhance_factor(level))


def contrast(img, level, sign):
    mean = torch.floor(_gray(img).mean(dim=(1, 2)) + 0.5)
    return _blend(img, _col(mean).expand_as(img), _enhance_factor(level))


def brightness(img, level, sign):
    return _blend(img, torch.zeros_like(img), _enhance_factor(level))


def sharpness(img, level, sign):
    k, h, w, c = img.shape
    kernel = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=img.dtype,
                          device=img.device) / 13.0
    planes = img.permute(0, 3, 1, 2).reshape(k * c, 1, h, w)
    smoothed = F.conv2d(planes, kernel.view(1, 1, 3, 3), padding=1)
    smoothed = smoothed.view(k, c, h, w).permute(0, 2, 3, 1)
    ys = torch.arange(h, device=img.device).view(1, h, 1, 1)
    xs = torch.arange(w, device=img.device).view(1, 1, w, 1)
    interior = (ys > 0) & (ys < h - 1) & (xs > 0) & (xs < w - 1)
    return _blend(img, torch.where(interior, smoothed, img), _enhance_factor(level))


def _bilinear(planes: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(order=1, mode="constant", cval=0)`` of planes
    [k, P, H, W] at coordinates [k, H, W] each: the four corners in
    (y, x) = (lo, lo), (lo, hi), (hi, lo), (hi, hi) order, a corner outside
    the image contributing 0."""
    k, p, h, w = planes.shape
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    corners_y = ((y0.long(), 1 - wy1), (y0.long() + 1, wy1))
    corners_x = ((x0.long(), 1 - wx1), (x0.long() + 1, wx1))
    flat = planes.reshape(k, p, h * w)
    out = None
    for iy, wy in corners_y:
        for ix, wx in corners_x:
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).view(k, 1, h * w)
            vals = flat.gather(2, idx.expand(k, p, h * w)).view(k, p, h, w)
            term = (wy * wx).unsqueeze(1) * torch.where(valid.unsqueeze(1), vals, 0.0)
            out = term if out is None else out + term
    return out


def affine_sample(img, a, b, c, d, e, f):
    """PIL's inverse affine: output pixel (x, y) samples the input at
    (a(x+.5) + b(y+.5) + c - .5, d(x+.5) + e(y+.5) + f - .5); pixels that
    the input covers only in part blend toward :data:`FILL` by the covered
    share. The six coefficients are [k] tensors."""
    k, h, w, _ = img.shape
    ys = (torch.arange(h, dtype=img.dtype, device=img.device) + 0.5).view(1, h, 1)
    xs = (torch.arange(w, dtype=img.dtype, device=img.device) + 0.5).view(1, 1, w)
    v = lambda t: t.view(-1, 1, 1)
    sx = v(a) * xs + v(b) * ys + v(c) - 0.5
    sy = v(d) * xs + v(e) * ys + v(f) - 0.5
    planes = torch.cat([img.permute(0, 3, 1, 2), torch.ones_like(img[..., :1]).permute(0, 3, 1, 2)],
                       dim=1)
    sampled = _bilinear(planes, sy, sx)
    out, cov = sampled[:, :3].permute(0, 2, 3, 1), sampled[:, 3:].permute(0, 2, 3, 1)
    fill = torch.tensor(FILL, dtype=img.dtype, device=img.device)
    return out + (1.0 - cov) * fill


def rotate(img, level, sign):
    theta = sign * level * 3.0 * math.pi / 180.0
    h, w = img.shape[1], img.shape[2]
    cx, cy = w / 2.0, h / 2.0   # PIL rotates about the exact centre
    cos, sin = torch.cos(theta), torch.sin(theta)
    a, b, d, e = cos, -sin, sin, cos
    c = cx - a * cx - b * cy
    f = cy - d * cx - e * cy
    return affine_sample(img, a, b, c, d, e, f)


def shear_x(img, level, sign):
    s = sign * level * 0.03
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    return affine_sample(img, one, s, zero, zero, one, zero)


def shear_y(img, level, sign):
    s = sign * level * 0.03
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    return affine_sample(img, one, zero, zero, s, one, zero)


OP_FNS = [identity, posterize, rotate, solarize, autocontrast, equalize, invert, color,
          contrast, brightness, sharpness, shear_x, shear_y]


def policy_tables():
    """(op index [25, 2] int64, probability [25, 2], level [25, 2]) of
    :data:`IMAGENET_POLICY`, levels raw 0-10."""
    ops = torch.tensor([[_OP_INDEX[o1], _OP_INDEX[o2]] for (o1, _, _), (o2, _, _)
                        in IMAGENET_POLICY])
    probs = torch.tensor([[p1, p2] for (_, p1, _), (_, p2, _) in IMAGENET_POLICY])
    levels = torch.tensor([[float(m1), float(m2)] for (_, _, m1), (_, _, m2)
                           in IMAGENET_POLICY])
    return ops, probs, levels


def draw_policy(generator: Optional[torch.Generator], n: int):
    """Each image's draws, on the generator's device: (op [n, 2], level [n,
    2], applied [n, 2] bool, sign [n, 2] of +-1, 1 for unsigned ops). In
    order: the sub-policy, then for each slot an apply uniform and a sign
    coin."""
    ops_t, probs_t, levels_t = policy_tables()
    pol = torch.randint(0, len(IMAGENET_POLICY), (n,), generator=generator)
    u = torch.rand(n, 2, 2, generator=generator)
    op, level = ops_t[pol], levels_t[pol]
    applied = u[..., 0] < probs_t[pol]
    signed = torch.tensor([i in SIGNED_OPS for i in range(len(OP_NAMES))])[op]
    sign = torch.where(signed & (u[..., 1] >= 0.5), -1.0, 1.0)
    return op, level, applied, sign


def auto_augment(img: torch.Tensor, op, level, applied, sign) -> torch.Tensor:
    """Apply each image's two drawn slots in turn. ``img``: float [N, H, W,
    3] in [0, 255]; the draws are :func:`draw_policy`'s, on any device."""
    img = img.clone()
    for slot in range(2):
        for idx in range(1, len(OP_NAMES)):
            sel = torch.nonzero(applied[:, slot] & (op[:, slot] == idx)).flatten()
            if sel.numel() == 0:
                continue
            lv = level[sel, slot].to(img.device, img.dtype)
            sg = sign[sel, slot].to(img.device, img.dtype)
            rows = sel.to(img.device)
            img[rows] = OP_FNS[idx](img[rows], lv, sg)
    return img
