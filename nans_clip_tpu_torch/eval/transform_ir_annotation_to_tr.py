"""Transpose text-to-image ground truth into image-to-text form
(counterpart of ``nans_clip_tpu/eval/transform_ir_annotation_to_tr.py``;
reference eval/transform_ir_annotation_to_tr.py:17-35): each input line is
{"text_id": t, "image_ids": [...]}; the output lines are
{"image_id": i, "text_ids": [...]}, written next to the input with a
``.tr.jsonl`` suffix unless ``--output-path`` names another file.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


def transform(input_path: str, output_path: str | None = None) -> str:
    output_path = output_path or input_path.replace(".jsonl", "") + ".tr.jsonl"
    t2i = defaultdict(list)
    with open(input_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            for image_id in obj["image_ids"]:
                t2i[int(image_id)].append(int(obj["text_id"]))
    with open(output_path, "w", encoding="utf-8") as f:
        for image_id in sorted(t2i):
            f.write(json.dumps({"image_id": image_id, "text_ids": t2i[image_id]}) + "\n")
    return output_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--annotation-path", required=True)
    p.add_argument("--output-path", default=None)
    args = p.parse_args(argv)
    out = transform(args.annotation_path, args.output_path)
    print(f"Transposed annotations saved to {out}")


if __name__ == "__main__":
    main()
