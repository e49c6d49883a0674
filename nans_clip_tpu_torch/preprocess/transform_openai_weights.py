"""Turn an OpenAI ``torch.jit`` CLIP checkpoint into a plain state dict
(counterpart of ``nans_clip_tpu/preprocess/transform_openai_weights.py``;
reference preprocess/transform_openai_pretrain_weights.py:30-34), ready for
``api.load`` / ``merge_pretrained``.

  python -m nans_clip_tpu_torch.preprocess.transform_openai_weights \\
      --raw-ckpt-path ViT-B-16.pt [--new-ckpt-path out.pt]
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--raw-ckpt-path", required=True)
    p.add_argument("--new-ckpt-path", default=None)
    args = p.parse_args(argv)

    if not os.path.exists(args.raw_ckpt_path):
        raise FileNotFoundError("The raw ckpt path does not exist!")
    if args.new_ckpt_path is None:
        root, ext = os.path.splitext(args.raw_ckpt_path)
        args.new_ckpt_path = f"{root}.state_dict{ext}"

    model = torch.jit.load(args.raw_ckpt_path, map_location="cpu")
    torch.save(model.state_dict(), args.new_ckpt_path)
    print(f"Transformed openai ckpt {args.raw_ckpt_path} to {args.new_ckpt_path}!")


if __name__ == "__main__":
    main()
