"""Minimal similarity demo: the reference README's first example
(README_En.md:200-216) on the port (counterpart of the repository's
``examples/similarity_demo.py``).

    python -m nans_clip_tpu_torch.examples.similarity_demo --image pokemon.jpeg \\
        --ckpt clip_cn_vit-b-16.pt [--quantize int8-text] [--platform cpu]

With the published ViT-B-16 checkpoint the probabilities should be
approximately [1.27e-3, 5.44e-2, 6.80e-4, 9.44e-1] for
["杰尼龟", "妙蛙种子", "小火龙", "皮卡丘"] (the JAX package's figures; the
checkpoint is not in the repository). The model runs on the card in bf16,
the kernels' dtype, unless ``--platform cpu``, where it runs in fp32 as
``load_from_name``'s default.
"""

import argparse

import torch
from PIL import Image

import nans_clip_tpu_torch as nct
from nans_clip_tpu_torch.training.trainer import platform_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="nans_clip_tpu_torch.examples.similarity_demo")
    p.add_argument("--image", required=True)
    p.add_argument("--ckpt", required=True, help=".pt checkpoint path")
    p.add_argument("--vision-model", default="ViT-B-16")
    p.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese")
    p.add_argument("--resolution", type=int, default=224)
    p.add_argument("--texts", nargs="+",
                   default=["杰尼龟", "妙蛙种子", "小火龙", "皮卡丘"])
    p.add_argument("--quantize", default=None, choices=[None, "int8", "int8-text"],
                   help="weight-only int8 serving (see utils/quantize.py)")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="where the model runs (default: the card; raises without one)")
    args = p.parse_args(argv)

    device = platform_device(args.platform)
    options = nct.ModelOptions(compute_dtype="bfloat16" if device.type == "cuda" else None)
    model, preprocess = nct.load_from_name(
        args.ckpt, vision_model_name=args.vision_model, text_model_name=args.text_model,
        input_resolution=args.resolution, options=options, device=device)
    if args.quantize:
        from nans_clip_tpu_torch.utils.quantize import towers_for_mode
        model = model.quantize(towers=towers_for_mode(args.quantize))

    image = preprocess(Image.open(args.image))[None]
    tokens = nct.tokenize(args.texts)

    logits_per_image, _ = model.get_similarity(image, tokens)
    probs = torch.softmax(logits_per_image.float(), dim=-1)[0].cpu().numpy()
    for text, prob in zip(args.texts, probs):
        print(f"  {text}: {prob:.6f}")


if __name__ == "__main__":
    main()
