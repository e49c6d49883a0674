"""VLM auto-annotation of scraped images (counterpart of
``nans_clip_tpu/flywheel/auto_annotate.py``).

Port of reference scripts/auto_annotate.py: for each image, call a
vision-language model (OpenAI-compatible chat API, e.g. Qwen-VL) with a
Song-dynasty-curation prompt and collect three caption styles
(reference :230-238):

* ``modern_chinese`` — 50-100字 objective description,
* ``ancient_style`` — 30-80字 宋代笔记体 classical prose,
* ``keywords`` — 5-8 comma-separated retrieval keywords,

appended per image to ``annotations.json``. Endpoint/key come from
``VLM_BASE_URL`` / ``VLM_API_KEY`` env vars (zero-egress environments can
point this at a local server).
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import os
import time
from pathlib import Path

logger = logging.getLogger(__name__)

PROMPT = (
    "你是一位宋代文物与古籍领域的专家。请观察这张图片（题名：{title}，类别：{category}），"
    "输出一个JSON对象，包含三个字段：\n"
    "1. modern_chinese：50-100字的现代中文描述，客观描述画面内容，包含视觉元素"
    "（构图、色彩、物象）和文化意义。\n"
    "2. ancient_style：30-80字的古文风格描述，模仿宋代笔记体（如《梦粱录》风格）。\n"
    "3. keywords：5-8个用逗号分隔的检索关键词，涵盖朝代、题材、技法、地点等维度。\n"
    "只输出JSON，不要其它内容。"
)


def encode_image(path: Path) -> str:
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


def call_vlm(path: Path, title: str, category: str, model: str,
             base_url: str, api_key: str, timeout: int = 60) -> dict:
    import urllib.request

    mime = "image/png" if path.suffix.lower() == ".png" else "image/jpeg"
    body = {
        "model": model,
        "messages": [{
            "role": "user",
            "content": [
                {"type": "image_url", "image_url": {
                    "url": f"data:{mime};base64,{encode_image(path)}"}},
                {"type": "text", "text": PROMPT.format(title=title, category=category)},
            ],
        }],
        "temperature": 0.3,
    }
    req = urllib.request.Request(
        f"{base_url.rstrip('/')}/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {api_key}"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.load(resp)
    text = out["choices"][0]["message"]["content"]
    # tolerate markdown fencing
    text = text.strip().removeprefix("```json").removeprefix("```").removesuffix("```")
    try:
        return json.loads(text)
    except Exception:
        return {"modern_chinese": text[:200] if text else "描述生成失败",
                "ancient_style": "", "keywords": ""}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--metadata", default="data/metadata.jsonl",
                   help="scraped metadata (filename/title/category per line)")
    p.add_argument("--images-dir", default="data/images")
    p.add_argument("--output", default="data/annotations.json")
    p.add_argument("--model", default=os.environ.get("VLM_MODEL", "qwen-vl-plus"))
    p.add_argument("--base-url", default=os.environ.get("VLM_BASE_URL"))
    p.add_argument("--api-key", default=os.environ.get("VLM_API_KEY", ""))
    p.add_argument("--sleep", type=float, default=0.5)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    assert args.base_url, "set --base-url or VLM_BASE_URL (OpenAI-compatible endpoint)"

    existing = []
    done = set()
    if os.path.exists(args.output):
        with open(args.output, encoding="utf-8") as f:
            existing = json.load(f)
        done = {a["filename"] for a in existing}
        logger.info("resuming: %d images already annotated", len(done))

    images_dir = Path(args.images_dir)
    n = 0
    with open(args.metadata, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            meta = json.loads(line)
            fname = meta["filename"]
            if fname in done or not (images_dir / fname).exists():
                continue
            try:
                ann = call_vlm(images_dir / fname, meta.get("title", ""),
                               meta.get("category", "绘画"), args.model,
                               args.base_url, args.api_key)
            except Exception as e:
                logger.warning("VLM call failed for %s: %s", fname, e)
                continue
            ann.update({"filename": fname, "title": meta.get("title", ""),
                        "category": meta.get("category", "")})
            existing.append(ann)
            n += 1
            with open(args.output, "w", encoding="utf-8") as fo:
                json.dump(existing, fo, ensure_ascii=False, indent=1)
            logger.info("[%d] annotated %s", n, fname)
            if args.limit and n >= args.limit:
                break
            time.sleep(args.sleep)
    logger.info("done: %d new annotations (total %d)", n, len(existing))


if __name__ == "__main__":
    main()
