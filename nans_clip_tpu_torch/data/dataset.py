"""Text preprocessing of the dataset module (counterpart of
``nans_clip_tpu/data/dataset.py::preprocess_text``). The rest of that module
(npack pair datasets, the prefetch loader) waits for the data port."""

from __future__ import annotations


def preprocess_text(text: str) -> str:
    """Adapt text to the Chinese BERT vocab (reference data.py:29-33):
    lowercase, and CJK curly double quotes to ASCII."""
    return text.lower().replace("“", '"').replace("”", '"')
