"""The Chinese-CLIP eval transform of one encoded image
(cn_clip/clip/utils.py::image_transform): decode, a bicubic resize to
R x R, RGB, to [0, 1], then normalised by the OpenAI CLIP mean and
standard deviation. NHWC float32."""

from __future__ import annotations

import io

import numpy as np

MEAN = np.asarray((0.48145466, 0.4578275, 0.40821073), np.float32)
STD = np.asarray((0.26862954, 0.26130258, 0.27577711), np.float32)


def transform(raw: bytes, size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(raw)).resize((size, size), Image.BICUBIC).convert("RGB")
    return (np.asarray(img, np.float32) / 255.0 - MEAN) / STD
