"""LLM paraphrase augmentation of annotations (counterpart of
``nans_clip_tpu/flywheel/augment_texts.py``).

Port of reference scripts/augment_texts.py: for each annotated image,
ask an LLM (OpenAI-compatible chat API) for paraphrased caption variants
and append them as ``_is_augmented`` records sharing the image's filename.
Resumable: an image that already has augmented records is skipped.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

logger = logging.getLogger(__name__)

PROMPT = (
    "下面是一张南宋文物图片的描述：\n“{caption}”\n"
    "请生成{n}条语义一致但措辞不同的改写，每条30-80字，一行一条，不要编号。"
)


def call_llm(caption: str, n: int, model: str, base_url: str, api_key: str,
             timeout: int = 60) -> list:
    import urllib.request

    body = {"model": model,
            "messages": [{"role": "user",
                          "content": PROMPT.format(caption=caption, n=n)}],
            "temperature": 0.9}
    req = urllib.request.Request(
        f"{base_url.rstrip('/')}/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {api_key}"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.load(resp)
    text = out["choices"][0]["message"]["content"]
    return [l.strip("-• \t") for l in text.splitlines() if l.strip()][:n]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--annotations", default="data/annotations.json")
    p.add_argument("--output", default=None, help="default: in-place")
    p.add_argument("--per-image", type=int, default=2)
    p.add_argument("--model", default=os.environ.get("LLM_MODEL", "qwen-plus"))
    p.add_argument("--base-url", default=os.environ.get("LLM_BASE_URL"))
    p.add_argument("--api-key", default=os.environ.get("LLM_API_KEY", ""))
    p.add_argument("--sleep", type=float, default=0.3)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    assert args.base_url, "set --base-url or LLM_BASE_URL"

    with open(args.annotations, encoding="utf-8") as f:
        annotations = json.load(f)

    # images that already have augmented records are DONE: without this,
    # re-running the script (the natural incremental workflow) would
    # re-paraphrase every original caption and append duplicate variants
    # (and duplicate paid LLM calls) on each run
    done = {ann.get("filename") for ann in annotations
            if ann.get("_is_augmented")}
    augmented = []
    for ann in annotations:
        if ann.get("_is_augmented") or ann.get("filename") in done:
            continue
        caption = ann.get("modern_chinese", "").strip()
        if not caption:
            continue
        try:
            variants = call_llm(caption, args.per_image, args.model,
                                args.base_url, args.api_key)
        except Exception as e:
            logger.warning("LLM call failed for %s: %s", ann["filename"], e)
            continue
        for v in variants:
            augmented.append({"filename": ann["filename"], "title": ann.get("title", ""),
                              "modern_chinese": v, "ancient_style": "",
                              "keywords": "", "_is_augmented": True})
        time.sleep(args.sleep)

    out = args.output or args.annotations
    with open(out, "w", encoding="utf-8") as f:
        json.dump(annotations + augmented, f, ensure_ascii=False, indent=1)
    logger.info("added %d augmented captions -> %s", len(augmented), out)


if __name__ == "__main__":
    main()
