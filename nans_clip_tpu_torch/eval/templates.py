"""Zero-shot prompt templates and the ImageNet-CN classnames (counterpart of
``nans_clip_tpu/eval/templates.py``).

The 1000 Chinese ImageNet classnames, the 80 OpenAI-style Chinese templates
and the per-dataset ELEVATER template sets are the JAX package's data
files, read in place (``nans_clip_tpu/assets/zeroshot/*.json``, as the
tokenizer reads ``vocab.txt``); templates use ``{}`` as the classname slot.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "nans_clip_tpu", "assets", "zeroshot")


def _read(name: str):
    with open(os.path.join(_DIR, name), encoding="utf-8") as f:
        return json.load(f)


@lru_cache()
def imagenet_classnames() -> List[str]:
    return _read("imagenet.json")["imagenet_classnames"]


@lru_cache()
def imagenet_templates() -> List[str]:
    return _read("imagenet.json")["imagenet_templates"]


@lru_cache()
def cvinw_templates() -> Dict[str, List[str]]:
    return _read("cvinw_templates.json")


def templates_for_dataset(dataset: str) -> List[str]:
    """The reference's per-dataset table (zeroshot_evaluation.py:235-247):
    exact-match keys; every other dataset, "imagenet" included, takes the
    183-prompt cvinw ``openai`` set, not the 80-prompt
    ``imagenet_templates`` table (shipped but never routed)."""
    cv = cvinw_templates()
    table = {
        "fgvc-aircraft-2013b-variants102": cv["aircraft"],
        "food-101": cv["food"],
        "oxford-flower-102": cv["flower"],
        "eurosat_clip": cv["eurosat"],
        "resisc45_clip": cv["eurosat"],
        "country211": cv["country211"],
        "openai": cv["openai"],
    }
    return table.get(dataset, cv["openai"])


def apply_template(template: str, classname: str) -> str:
    return template.format(classname)
