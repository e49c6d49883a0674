"""Interactive retrieval demo (counterpart of the repository's ``demo.py``,
the reference ``demo.py`` twin).

Precomputes the gallery's image features from an npack split, then serves
text -> image gallery search and image -> candidate-text ranking, with
optional LoRA adapters (the JAX package's ``.npz``) merged in and optional
weight-only int8 towers (reference demo.py:95-212).

It uses Gradio where it imports; otherwise it runs one ``--cli`` query, or
a REPL. The weights are loaded in fp32, the LoRA deltas added to them, the
towers quantized if asked, and the rest cast to the compute dtype (as the
JAX package merges and quantizes its fp32 tree and casts in the forward).
The towers run on the card unless ``--platform cpu``.

    python -m nans_clip_tpu_torch.demo --data DATADIR/valid --resume ckpt.pt \\
        [--lora best_lora.npz] [--quantize int8-text] [--cli "西湖 山水"]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import numpy as np
import torch

from nans_clip_tpu_torch.api import CLIPModel
from nans_clip_tpu_torch.data.augment import preprocess_images
from nans_clip_tpu_torch.data.dataset import PairDataset, preprocess_text
from nans_clip_tpu_torch.deploy.aot import normalized
from nans_clip_tpu_torch.eval.model_io import load_eval_model
from nans_clip_tpu_torch.models.common import compute_dtype_for
from nans_clip_tpu_torch.tokenizer import tokenize
from nans_clip_tpu_torch.training.trainer import platform_device

logger = logging.getLogger(__name__)

#: the towers' precision (the JAX demo's, ``load_eval_model``'s default)
PRECISION = "bf16"


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="nans_clip_tpu_torch.demo")
    p.add_argument("--data", required=True, help="npack dataset dir (gallery)")
    p.add_argument("--resume", required=True)
    p.add_argument("--vision-model", default="ViT-B-16")
    p.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese")
    p.add_argument("--lora", default=None)
    p.add_argument("--topk", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--cli", default=None, help="run one query and exit")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--quantize", default=None, choices=[None, "int8", "int8-text"],
                   help="weight-only int8 serving (utils/quantize.py; the text tower at batch 1 "
                        "streams its int8 weights through the tower kernel); int8-text leaves "
                        "the image tower in the compute dtype (applied AFTER any LoRA merge)")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="where the towers run (default: the card; raises without one)")
    return p.parse_args(argv)


class RetrievalEngine:
    def __init__(self, args):
        device = platform_device(args.platform)
        base = load_eval_model(args.vision_model, args.text_model, args.resume, "fp32",
                               device=device)
        module = base.module
        if args.lora:
            from nans_clip_tpu_torch.eval.retrieval_suite import load_adapters
            from nans_clip_tpu_torch.models.lora import merge_lora

            adapters, alpha = load_adapters(args.lora, module)
            with torch.no_grad():
                params = dict(module.named_parameters())
                for name, w in merge_lora(module, adapters, alpha=alpha).items():
                    params[name].copy_(w)
            logger.info("merged LoRA adapters from %s", args.lora)
        if args.quantize:
            from nans_clip_tpu_torch.utils.quantize import quantize_for_serving, towers_for_mode

            towers = towers_for_mode(args.quantize)
            module = quantize_for_serving(module, towers)
            logger.info("int8-quantized towers: %s", towers)
        options = dataclasses.replace(base.options, compute_dtype=compute_dtype_for(PRECISION))
        self.model = CLIPModel(base.cfg, module, options)
        self.cfg = base.cfg
        self.ds = PairDataset(args.data)
        self.resolution = self.cfg.vision.image_resolution

        # gallery features, a padded batch at a time
        keys = self.ds.imgs.keys()
        feats = []
        bs = args.batch_size
        for i in range(0, len(keys), bs):
            chunk = keys[i:i + bs]
            raw, _ = self.ds.imgs.decode_jpeg_batch(chunk, self.resolution)
            pad = bs - len(chunk)
            if pad:
                raw = np.concatenate([raw, np.zeros((pad,) + raw.shape[1:], raw.dtype)])
            feats.append(self._image_features(raw)[:len(chunk)])
        self.gallery_ids = keys.astype(np.int64)
        self.gallery = np.concatenate(feats)
        # candidate texts
        self.texts = {}
        for i in range(len(self.ds)):
            _, text_id, raw = self.ds.get_pair(i)
            self.texts.setdefault(text_id, raw)
        logger.info("gallery: %d images, %d candidate texts", len(self.gallery_ids),
                    len(self.texts))

    def _image_features(self, raw: np.ndarray) -> np.ndarray:
        x = preprocess_images(None, torch.from_numpy(raw).to(self.model.device),
                              self.resolution)
        return normalized(self.model.encode_image(x)).cpu().numpy()

    def _text_features(self, tok: np.ndarray) -> np.ndarray:
        return normalized(self.model.encode_text(tok)).cpu().numpy()

    def search_by_text(self, query: str, topk: int = 8):
        f = self._text_features(tokenize([preprocess_text(query)]))[0]
        scores = self.gallery @ f
        order = np.argsort(-scores)[:topk]
        return [(int(self.gallery_ids[i]), float(scores[i])) for i in order]

    def rank_texts_for_image(self, image_id: int, topk: int = 8):
        raw, _ = self.ds.imgs.decode_jpeg_batch(np.asarray([image_id], np.uint64),
                                                self.resolution)
        f = self._image_features(raw)[0]
        ids = sorted(self.texts)
        tf = self._text_features(tokenize([preprocess_text(self.texts[t]) for t in ids]))
        scores = tf @ f
        order = np.argsort(-scores)[:topk]
        return [(self.texts[ids[i]], float(scores[i])) for i in order]


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    args = parse_args(argv)
    engine = RetrievalEngine(args)

    if args.cli is not None:
        for image_id, score in engine.search_by_text(args.cli, args.topk):
            print(f"image_id={image_id}  score={score:.4f}")
        return

    try:
        import gradio as gr
    except ImportError:
        print("gradio not installed — interactive REPL (empty line to quit):")
        while True:
            q = input("query> ").strip()
            if not q:
                return
            for image_id, score in engine.search_by_text(q, args.topk):
                print(f"  image_id={image_id}  score={score:.4f}")

    def text_search(q):
        import io

        from PIL import Image
        out = []
        for image_id, score in engine.search_by_text(q, args.topk):
            raw = engine.ds.imgs.get(image_id)
            out.append((Image.open(io.BytesIO(raw)), f"{image_id} ({score:.3f})"))
        return out

    ui = gr.Interface(fn=text_search, inputs=gr.Textbox(label="中文查询"),
                      outputs=gr.Gallery(label="检索结果"), title="NanS-CLIP TPU 检索演示")
    ui.launch(server_port=args.port)


if __name__ == "__main__":
    main()
