"""Image preprocessing: the reference eval/inference transform.

Counterpart of ``nans_clip_tpu/utils/transform.py::image_transform``
(reference clip/utils.py:179-186): bicubic square resize -> RGB -> scale to
[0,1] -> OpenAI-CLIP normalize. Output is NHWC float32, the layout the
port's encoders take. PIL is imported only when an image is transformed,
so building a model needs no PIL.
"""

from __future__ import annotations

import numpy as np

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


def image_transform(image_size: int = 224):
    """Returns fn(PIL.Image) -> np.float32 [H, W, 3], reference-parity."""
    mean = np.asarray(OPENAI_MEAN, np.float32)
    std = np.asarray(OPENAI_STD, np.float32)

    def transform(img) -> np.ndarray:
        from PIL import Image

        img = img.resize((image_size, image_size), Image.BICUBIC)
        img = img.convert("RGB")
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - mean) / std

    return transform
