"""The port's image preprocessing and AutoAugment (nans_clip_tpu_torch/data/
augment.py, autoaugment.py) against the JAX package's, on the CPU in fp32.

Tolerances:

* without augmentation and without a resize (decoded at the model's size,
  the CLIs' case) 1e-6 on the normalised output;
* the cubic resize and the crop (the crop against
  ``jax.image.scale_and_translate`` for the same boxes): each weight matrix
  within 1e-6 of JAX's ``compute_weight_mat`` at JAX's scale and
  translation, the port's pixels within 1e-4 of a float64 evaluation of
  JAX's matrices and within 1e-3 of JAX's pixels, on the 0-255 scale;
* each AutoAugment op against the JAX op over levels 0-10 (and both signs
  for the geometric ops, the only ones that read the sign):
  pointwise ops 1e-4, the geometric ops (Rotate, ShearX, ShearY) 1e-3,
  Equalize and the integer ops (Posterize, Solarize, Invert) exact.

The random draws are the port's own (``torch.Generator``); the JAX package
draws with ``jax.random``, so augmented batches are compared op by op and
box by box, not draw by draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nans_clip_tpu.data import augment as jaugment
from nans_clip_tpu.data import autoaugment as jaa
from nans_clip_tpu_torch.data import augment, autoaugment

EXACT = {"Identity", "Posterize", "Solarize", "Invert", "Equalize"}
GEOMETRIC = {"Rotate", "ShearX", "ShearY"}


def _raw(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)).astype(np.uint8)


def _f64(raw, wy, wx):
    """The two products in float64, [N, out, out, 3] on the 0-255 scale.
    wy, wx: [N, out, in]."""
    x = np.einsum("noh,nhwc->nowc", wy.astype(np.float64), raw.astype(np.float64))
    return np.einsum("npw,nowc->nopc", wx.astype(np.float64), x)


def _jax_mats(size, out, scales, translations):
    """JAX's cubic weight matrices, one an image: [N, out, size]."""
    return np.stack([np.asarray(jax._src.image.scale.compute_weight_mat(
        size, out, jnp.float32(s), jnp.float32(t),
        jax._src.image.scale._fill_keys_cubic_kernel, True)).T
        for s, t in zip(scales, translations)])


def _check_warp(got, want, exact):
    """got, want (JAX's pixels), exact (JAX's matrices in float64): 0-255 scale."""
    assert np.abs(got - exact).max() <= 1e-4
    assert np.abs(got - want).max() <= 1e-3


@pytest.mark.parametrize("shape,out", [((3, 32, 32), 32), ((3, 40, 52), 32),
                                       ((2, 40, 40), 64)])
def test_preprocess_without_augment_matches_jax(shape, out):
    raw = _raw(*shape)
    want = np.asarray(jaugment.preprocess_images(jax.random.PRNGKey(0), jnp.asarray(raw), out))
    got = augment.preprocess_images(None, torch.from_numpy(raw), out).numpy()
    assert got.shape == want.shape == (shape[0], out, out, 3) and got.dtype == np.float32
    if shape[1:] == (out, out):
        assert np.abs(got - want).max() <= 1e-6
        return
    n, h, w = shape
    one = lambda v: torch.full((n,), v, dtype=torch.float32)
    mats = []
    for size in (h, w):
        mat = augment.weight_mat(size, out, one(out / size), one(0.0)).numpy()
        jmat = _jax_mats(size, out, [out / size] * n, [0.0] * n)
        assert np.abs(jmat - mat).max() <= 1e-6
        mats.append(jmat)
    mean, std = np.asarray(augment.OPENAI_MEAN), np.asarray(augment.OPENAI_STD)
    pixels = lambda y: (y * std + mean) * 255.0
    _check_warp(pixels(got), pixels(want), _f64(raw, *mats))


@pytest.mark.parametrize("shape,out", [((4, 40, 52), 32), ((4, 32, 32), 32),
                                       ((3, 24, 30), 48), ((2, 256, 256), 224)])
def test_crop_matches_scale_and_translate(shape, out):
    raw = _raw(*shape, seed=1)
    n, h, w = shape
    boxes = augment.draw_crop_boxes(torch.Generator().manual_seed(h), n, h, w)
    got = augment.resized_crop(torch.from_numpy(raw).float(), boxes, out).numpy()
    # JAX's scale and translation of each box (data/augment.py's arithmetic, float32)
    y0, x0, ch, cw = boxes.numpy().T
    # the box lies in the image (its sides clipped to the image's, as JAX clips them)
    assert (1 <= ch).all() and (ch <= h).all() and (1 <= cw).all() and (cw <= w).all()
    assert (0 <= y0).all() and (y0 <= h - ch).all() and (0 <= x0).all() and (x0 <= w - cw).all()
    sy, sx = np.float32(out) / ch, np.float32(out) / cw
    ty, tx = -y0 * sy, -x0 * sx
    jy, jx = _jax_mats(h, out, sy, ty), _jax_mats(w, out, sx, tx)
    psy, psx, pty, ptx = augment.crop_scale_translation(boxes, out)
    assert np.abs(augment.weight_mat(h, out, psy, pty).numpy() - jy).max() <= 1e-6
    assert np.abs(augment.weight_mat(w, out, psx, ptx).numpy() - jx).max() <= 1e-6
    exact = _f64(raw, jy, jx)
    for i in range(n):
        want = np.asarray(jax.image.scale_and_translate(
            jnp.asarray(raw[i], jnp.float32), (out, out, 3), (0, 1),
            jnp.stack([sy[i], sx[i]]), jnp.stack([ty[i], tx[i]]), method="cubic"))
        _check_warp(got[i], want, exact[i])


@pytest.fixture(scope="module")
def images():
    """Two structured + noise images (real histograms for Equalize and
    AutoContrast), as tests/test_autoaugment.py builds its one."""
    rs = np.random.RandomState(0)
    out = []
    for lo in (0, 40):
        x = lo + np.linspace(0, 200, 48)[:, None, None] + rs.randint(0, 55, (48, 48, 3))
        out.append(np.clip(x, 0, 255).astype(np.float32))
    return np.stack(out)


@pytest.mark.parametrize("name", autoaugment.OP_NAMES)
def test_autoaugment_op_matches_jax(images, name):
    i = autoaugment.OP_NAMES.index(name)
    assert jaa.OP_NAMES[i] == name
    jfn, fn = jaa._OP_FNS[i], autoaugment.OP_FNS[i]
    bound = 0.0 if name in EXACT else 1e-3 if name in GEOMETRIC else 1e-4
    for level in range(11):
        for sign in ((1.0, -1.0) if name in GEOMETRIC else (1.0,)):   # only they read it
            # the two images at different levels: one batched call
            levels = torch.tensor([float(level), float(10 - level)])
            got = fn(torch.from_numpy(images), levels, torch.tensor([sign, -sign])).numpy()
            for k in range(2):
                want = np.asarray(jfn(jnp.asarray(images[k]), jnp.float32(levels[k]),
                                      jnp.float32(sign if k == 0 else -sign)))
                err = np.abs(got[k] - want).max()
                assert err <= bound, (name, level, sign, k, err)


def test_policy_matches_jax():
    assert autoaugment.IMAGENET_POLICY == jaa.IMAGENET_POLICY
    assert autoaugment.OP_NAMES == jaa.OP_NAMES and autoaugment.FILL == jaa.FILL
    ops, probs, levels = autoaugment.policy_tables()
    jops, jprobs, jlevels = jaa._policy_tables()
    np.testing.assert_array_equal(ops.numpy(), np.asarray(jops))
    np.testing.assert_array_equal(probs.numpy(), np.asarray(jprobs))
    np.testing.assert_array_equal(levels.numpy(), np.asarray(jlevels))
    signed = [i for i in range(len(jaa.OP_NAMES)) if jaa._SIGNED_MASK[i]]
    assert sorted(autoaugment.SIGNED_OPS) == signed


def test_augmented_batch_is_each_image_augmented():
    """A batch through preprocess_images(augment=True) equals each image
    through its own draws (the crop, the flip and the two policy slots
    one image at a time), is finite, and follows the generator's seed."""
    raw = _raw(6, 40, 44, seed=3)
    run = lambda seed: augment.preprocess_images(torch.Generator().manual_seed(seed),
                                                 torch.from_numpy(raw), 32, augment=True)
    a, b, c = run(5), run(5), run(6)
    assert a.shape == (6, 32, 32, 3) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b) and not torch.equal(a, c)
    boxes, flip, (op, level, applied, sign) = augment.draw_augment(
        torch.Generator().manual_seed(5), 6, 40, 44)
    assert applied.any() and flip.any() and not flip.all()
    mean = torch.tensor(augment.OPENAI_MEAN)
    std = torch.tensor(augment.OPENAI_STD)
    for i in range(6):
        x = augment.resized_crop(torch.from_numpy(raw[i:i + 1]).float(), boxes[i:i + 1],
                                 32).clamp(0, 255)
        if flip[i]:
            x = x.flip(2)
        for slot in range(2):
            if applied[i, slot]:
                x = autoaugment.OP_FNS[int(op[i, slot])](x, level[i:i + 1, slot],
                                                          sign[i:i + 1, slot])
        want = (x / 255.0 - mean) / std
        assert float((a[i:i + 1] - want).abs().max()) <= 1e-5, i
