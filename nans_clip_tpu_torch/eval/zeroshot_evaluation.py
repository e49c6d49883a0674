"""Zero-shot classification, the ELEVATER / ImageNet protocol (counterpart
of ``nans_clip_tpu/eval/zeroshot_evaluation.py``; reference
eval/zeroshot_evaluation.py):

* the classifier: per class, embed every template prompt (lowercased by
  ``preprocess_text``, :111), normalise, take the mean and normalise again
  (:107-119): [E, C];
* images from an ImageFolder directory (class subdirectories, sorted as
  torchvision sorts them), ``convert("RGB")`` then a bicubic resize in a
  thread pool, then ``preprocess_images`` and ``encode_image`` on the
  device, fp32 normalisation and ``softmax(100 * f @ W)`` in exact fp32;
  top-1 is taken from those probabilities (:128-147);
* classnames from ``--label-file`` (one a line, :232-233), else the bundled
  ImageNet-CN list for an ``imagenet*`` dataset, else the class
  directories; ``--index`` rearranges the dumped rows (:152-158);
* the ELEVATER prediction json, floats rounded to 6 digits (:255-274).

Usage:
  python -m nans_clip_tpu_torch.eval.zeroshot_evaluation \\
      --datapath IMAGEFOLDER --dataset imagenet --label-file labels.txt \\
      --resume ckpt.pt --vision-model ViT-B-16 \\
      --text-model RoBERTa-wwm-ext-base-chinese --save-dir OUT [--platform cpu --tiny-model]
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from nans_clip_tpu_torch.data.augment import preprocess_images
from nans_clip_tpu_torch.data.dataset import preprocess_text
from nans_clip_tpu_torch.eval.make_topk_predictions import exact_fp32
from nans_clip_tpu_torch.eval.model_io import load_eval_model
from nans_clip_tpu_torch.eval.templates import (apply_template, imagenet_classnames,
                                                templates_for_dataset)
from nans_clip_tpu_torch.tokenizer import tokenize
from nans_clip_tpu_torch.training.trainer import platform_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="imagenet")
    p.add_argument("--datapath", required=True, help="ImageFolder root")
    p.add_argument("--label-file", default=None,
                   help="classnames, one per line (reference :232); falls back to the "
                        "bundled ImageNet-CN list, then to the ImageFolder class dirs")
    p.add_argument("--index", default=None,
                   help="json list of row indices to rearrange the dumped predictions "
                        "(reference :152-158)")
    p.add_argument("--img-batch-size", type=int, default=64)
    p.add_argument("--text-batch-size", type=int, default=256)
    p.add_argument("--context-length", type=int, default=52)
    p.add_argument("--resume", required=True)
    p.add_argument("--vision-model", default="ViT-B-16")
    p.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese")
    p.add_argument("--precision", default="bf16")
    p.add_argument("--save-dir", default=".")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--tiny-model", action="store_true",
                   help="2-layer debug config (configs.tiny_config)")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="the device of the towers (default: the card; raises without one)")
    return p.parse_args(argv)


def zero_shot_classifier(model, classnames, templates, context_length=52, batch_size=256):
    """[E, n_classes] fp32: each class's prompt features, normalised,
    mean-ensembled and normalised again (numpy, as the JAX package)."""
    weights = []
    for classname in classnames:
        prompts = [preprocess_text(apply_template(t, classname)) for t in templates]
        feats = np.concatenate([
            model.encode_text(tokenize(prompts[i:i + batch_size], context_length))
            .float().cpu().numpy() for i in range(0, len(prompts), batch_size)])
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        mean = feats.mean(axis=0)
        mean /= np.linalg.norm(mean)
        weights.append(mean)
    return np.stack(weights, axis=1)


def iter_imagefolder(root):
    """(path, class_index) pairs, classes sorted like torchvision."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    for ci, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".webp")):
                yield os.path.join(cdir, fname), ci


def load_rgb(path: str, resolution: int) -> np.ndarray:
    """uint8 [R, R, 3]: RGB conversion BEFORE the resize, as torchvision's
    ImageFolder loader (``Image.open().convert('RGB')``) then the
    transform's Resize (eval/data.py:155); resizing first would NEAREST-
    resample palette PNGs and mis-interpolate CMYK JPEGs."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((resolution, resolution), Image.BICUBIC)
    return np.asarray(img)


def run(model, classifier, datapath, batch_size=64, num_threads=8):
    """(top-1 accuracy, softmaxed prediction rows): the reference run()
    (:128-163) dumps probabilities, not logits."""
    resolution = model.image_resolution
    weights = torch.from_numpy(np.ascontiguousarray(classifier, np.float32)).to(model.device)
    samples = list(iter_imagefolder(datapath))
    if not samples:
        raise FileNotFoundError(f"no images under {datapath}")
    top1 = 0
    predictions = []
    with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
        for i in range(0, len(samples), batch_size):
            chunk = samples[i:i + batch_size]
            imgs = np.stack(list(pool.map(lambda p: load_rgb(p, resolution),
                                          [p for p, _ in chunk])))
            x = preprocess_images(None, torch.from_numpy(imgs).to(model.device), resolution)
            with torch.inference_mode(), exact_fp32():
                f = model.encode_image(x).float()
                f = f / f.norm(dim=-1, keepdim=True)
                probs = torch.softmax(100.0 * f @ weights, dim=-1)
            probs = probs.cpu().numpy().astype(np.float64)
            for (_, label), row in zip(chunk, probs):
                top1 += int(row.argmax() == label)
                predictions.append(row.tolist())
    return top1 / len(samples), predictions


def json_prec_dump(data, prec=6):
    """Every float rounded to ``prec`` digits (reference :255-258)."""
    return json.dumps(json.loads(json.dumps(data), parse_float=lambda x: round(float(x), prec)))


def param_counts(module) -> tuple:
    """(all parameters, the image tower's): the JAX tree's leaf sizes;
    buffers are not parameters."""
    named = list(module.named_parameters())
    total = sum(p.numel() for _, p in named)
    visual = sum(p.numel() for n, p in named if n.startswith("visual."))
    return total, visual


def main(argv=None):
    args = parse_args(argv)
    device = platform_device(args.platform)
    cfg = None
    if args.tiny_model:
        from nans_clip_tpu_torch.configs import tiny_config
        cfg = tiny_config()
    model = load_eval_model(args.vision_model, args.text_model, args.resume, args.precision,
                            cfg=cfg, device=device)

    if args.label_file:
        with open(args.label_file, encoding="utf8") as f:
            classnames = [line.strip() for line in f.readlines()]
    elif args.dataset.lower().startswith("imagenet"):
        classnames = imagenet_classnames()
    else:
        # ImageFolder class dirs are the classnames
        classnames = sorted(d for d in os.listdir(args.datapath)
                            if os.path.isdir(os.path.join(args.datapath, d)))
    templates = templates_for_dataset(args.dataset)
    print(f"{len(classnames)} classes, {len(templates)} templates")

    classifier = zero_shot_classifier(model, classnames, templates, args.context_length,
                                      args.text_batch_size)
    acc, predictions = run(model, classifier, args.datapath, args.img_batch_size,
                           args.num_workers)
    print(f"zeroshot top-1 accuracy: {acc * 100:.2f}%")

    if args.index:
        with open(args.index, encoding="utf-8") as f:
            index = json.load(f)
        predictions = [predictions[i] for i in index]

    n_params, n_visual = param_counts(model.module)
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, f"{args.dataset}.json")
    output_dict = {
        "model_name": "CN-CLIP-" + args.vision_model,
        "dataset_name": args.dataset,
        "num_trainable_params": 0,
        "num_params": n_params,
        "num_visual_params": n_visual,
        "num_backbone_params": n_params,
        "n_shot": 0,
        "rnd_seeds": [123],
        "predictions": [predictions],
    }
    with open(out, "w", encoding="utf-8") as f:
        f.write(json_prec_dump(output_dict))
    print(f"Results saved to {out}")
    return acc


if __name__ == "__main__":
    main()
