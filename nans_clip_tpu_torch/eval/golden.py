"""Golden-value gates against CN-CLIP's published numbers (counterpart of
``nans_clip_tpu/eval/golden.py``), the same gates and CLI on the port's
models and eval pipeline:

1. **Pokemon probabilities**: the published ViT-B-16 quickstart output,
   reference README_En.md:214, within 2e-3; and the int8 serving copy's
   probabilities within 0.05 of the full model's.
2. **Zero-shot retrieval**: MUGE (valid, T2I, Results.md:13, MR 71.1),
   Flickr30K-CN and COCO-CN (test, both directions, Results.md:27-82), each
   MR within 0.2, through the three-stage pipeline (``extract_features`` ->
   ``make_topk_predictions`` -> ``evaluation``, and the ``_tr`` mirror).
3. **ImageNet-CN zero-shot top-1** 48.3 within 0.2 (Results.md:94).
4. **The fork's Southern-Song LoRA** before/after R@1 within 0.5.

The checkpoints and datasets are not in the repository; nothing is
downloaded. ``--tiny-model`` runs the machinery on the 2-layer debug config
and ``--platform cpu`` on the CPU (the gates then fail, as random weights
must).

    python -m nans_clip_tpu_torch.eval.golden pokemon --checkpoint clip_cn_vit-b-16.pt
    python -m nans_clip_tpu_torch.eval.golden muge --checkpoint ... --muge-dir MUGE/
    python -m nans_clip_tpu_torch.eval.golden flickr30k-cn --checkpoint ... --data-dir DIR
    python -m nans_clip_tpu_torch.eval.golden coco-cn --checkpoint ... --data-dir DIR
    python -m nans_clip_tpu_torch.eval.golden imagenet --checkpoint ... --datapath val/
    python -m nans_clip_tpu_torch.eval.golden lora-song --checkpoint ... \\
        --data-dir SongDynasty/lmdb/valid --lora best_lora.npz
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

# README_En.md:214 (fp16 CUDA reference output)
POKEMON_GOLDEN = np.array(
    [1.268734e-03, 5.436878e-02, 6.795761e-04, 9.436829e-01], np.float32)
POKEMON_LABELS = ["杰尼龟", "妙蛙种子", "小火龙", "皮卡丘"]
POKEMON_ATOL = 2e-3

# Results.md:13: CN-CLIP ViT-B/16, MUGE official validation, zero-shot
MUGE_GOLDEN = {"r1": 52.1, "r5": 76.7, "r10": 84.4, "mean_recall": 71.1}
MUGE_MR_TOL = 0.2

# The published ViT-B/16 zero-shot retrieval rows (Results.md:27-82)
RETRIEVAL_GOLDEN = {
    "muge": {"split": "valid",
             "t2i": {"r1": 52.1, "r5": 76.7, "r10": 84.4, "mean_recall": 71.1}},
    "flickr30k-cn": {"split": "test",
                     "t2i": {"r1": 62.7, "r5": 86.9, "r10": 92.8},
                     "i2t": {"r1": 74.6, "r5": 93.5, "r10": 97.1}},
    "coco-cn": {"split": "test",
                "t2i": {"r1": 62.2, "r5": 86.6, "r10": 94.9},
                "i2t": {"r1": 57.0, "r5": 84.1, "r10": 93.6}},
}

# Results.md:94: ImageNet-CN zero-shot top-1 (ELEVATER protocol)
IMAGENET_GOLDEN_TOP1 = 48.3
IMAGENET_TOL = 0.2

# The fork's Southern-Song LoRA results (CLIP南宋古籍项目复现计划.md:90-91, §五)
LORA_SONG_GOLDEN = {
    "zeroshot": {"t2i_r1": 65.9, "i2t_r1": 77.3},
    "lora": {"t2i_r1": 71.6, "i2t_r1": 86.4},
}
LORA_SONG_TOL = 0.5

VISION, TEXT = "ViT-B-16", "RoBERTa-wwm-ext-base-chinese"
_POKEMON = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "nans_clip_tpu", "assets", "pokemon.jpeg")


def _golden_mr(row: dict) -> float:
    """The published MR where the table prints one (MUGE), else the mean
    of the published R@K (evaluation.py's mean_recall)."""
    if "mean_recall" in row:
        return row["mean_recall"]
    return (row["r1"] + row["r5"] + row["r10"]) / 3.0


def _find_pokemon_image(explicit: str | None) -> str:
    if explicit:
        return explicit
    if os.path.exists(_POKEMON):
        return _POKEMON
    raise FileNotFoundError("pokemon.jpeg not found; pass --image (reference "
                            "examples/pokemon.jpeg)")


def _model_args(tiny: bool, platform: str) -> list:
    return ["--platform", platform] + (["--tiny-model"] if tiny else [])


def _load_pokemon_model(checkpoint: str, tiny: bool, platform: str):
    """(bf16 CLIPModel, preprocess) of the ViT-B-16 checkpoint, or of the
    debug config with ``tiny``."""
    import nans_clip_tpu_torch as nct
    from nans_clip_tpu_torch.eval.model_io import load_eval_model
    from nans_clip_tpu_torch.training.trainer import platform_device

    device = platform_device(platform)
    if tiny:
        model = load_eval_model(VISION, TEXT, checkpoint, "bf16", cfg=nct.tiny_config(),
                                device=device)
        return model, nct.image_transform(model.image_resolution)
    return nct.load_from_name(checkpoint, vision_model_name=VISION, text_model_name=TEXT,
                              input_resolution=224, device=device,
                              options=nct.ModelOptions(compute_dtype="bfloat16"))


def _pokemon_probs(model, preprocess, image_path) -> np.ndarray:
    from PIL import Image

    import nans_clip_tpu_torch as nct

    img = preprocess(Image.open(_find_pokemon_image(image_path)))[None]
    logits, _ = model.get_similarity(img, nct.tokenize(POKEMON_LABELS))
    logits = logits.float().cpu().numpy()[0]
    probs = np.exp(logits - logits.max())
    return probs / probs.sum()


def check_pokemon(checkpoint: str, image_path: str | None = None, tiny: bool = False,
                  platform: str = "cuda") -> dict:
    """Load the published ViT-B-16 checkpoint and gate the quickstart probs."""
    probs = _pokemon_probs(*_load_pokemon_model(checkpoint, tiny, platform), image_path)
    err = float(np.abs(probs - POKEMON_GOLDEN).max())
    return {"check": "pokemon", "ok": bool(err < POKEMON_ATOL), "max_abs_err": err,
            "atol": POKEMON_ATOL, "probs": probs.tolist(), "golden": POKEMON_GOLDEN.tolist()}


def check_pokemon_int8(checkpoint: str, image_path: str | None = None, atol: float = 0.05,
                       tiny: bool = False, platform: str = "cuda") -> dict:
    """The int8 serving copy (``CLIPModel.quantize``) against the full model
    on the published checkpoint: the probabilities within ``atol``."""
    model, preprocess = _load_pokemon_model(checkpoint, tiny, platform)
    full = _pokemon_probs(model, preprocess, image_path)
    quant = _pokemon_probs(model.quantize(), preprocess, image_path)
    err = float(np.abs(full - quant).max())
    return {"check": "pokemon_int8", "ok": bool(err < atol), "max_abs_shift": err,
            "atol": atol, "full_probs": full.tolist(), "int8_probs": quant.tolist()}


def _ensure_npack_split(data_dir: str, work_dir: str, split: str = "valid") -> tuple:
    """(npack split dir, {split}_texts.jsonl): the raw official download
    ({split}_imgs.tsv + {split}_texts.jsonl) built by the port's build_dataset in a
    subprocess, or an already-built npack split."""
    texts = os.path.join(data_dir, f"{split}_texts.jsonl")
    prebuilt = os.path.join(data_dir, "datasets")
    if os.path.isdir(prebuilt):
        for name in os.listdir(prebuilt):
            v = os.path.join(prebuilt, name, split)
            if os.path.exists(os.path.join(v, "imgs.npack")):
                return v, texts
    if os.path.exists(os.path.join(data_dir, split, "imgs.npack")):
        return os.path.join(data_dir, split), texts
    if not os.path.exists(os.path.join(data_dir, f"{split}_imgs.tsv")):
        raise FileNotFoundError(
            f"{data_dir}: need {split}_imgs.tsv+{split}_texts.jsonl "
            f"(official layout) or a prebuilt npack '{split}' split")
    out = os.path.join(work_dir, "ds")
    subprocess.run([sys.executable, "-m", "nans_clip_tpu_torch.preprocess.build_dataset",
                    "--data-dir", data_dir, "--splits", split, "--out-dir", out], check=True)
    return os.path.join(out, split), texts


def check_retrieval(dataset: str, checkpoint: str, data_dir: str, work_dir: str | None = None,
                    batch_size: int = 64, tiny: bool = False, platform: str = "cuda") -> dict:
    """The three-stage zero-shot retrieval eval of one published benchmark
    (muge: T2I only, as the official leaderboard; flickr30k-cn / coco-cn:
    both directions through the _tr mirror); each direction's MR within 0.2
    of the published ViT-B/16 row."""
    from nans_clip_tpu_torch.eval import (evaluation, evaluation_tr, extract_features,
                                          transform_ir_annotation_to_tr)
    from nans_clip_tpu_torch.eval import make_topk_predictions as topk

    golden = RETRIEVAL_GOLDEN[dataset]
    split = golden["split"]
    tmp = work_dir or tempfile.mkdtemp(prefix=f"{dataset}_golden_")
    os.makedirs(tmp, exist_ok=True)
    split_dir, texts_jsonl = _ensure_npack_split(data_dir, tmp, split)
    img_feats = os.path.join(tmp, "imgs.img_feat.jsonl")
    txt_feats = os.path.join(tmp, f"{split}_texts.txt_feat.jsonl")
    model = _model_args(tiny, platform)

    extract_features.main([
        "--extract-image-feats", "--extract-text-feats",
        "--image-data", split_dir, "--text-data", texts_jsonl,
        "--image-feat-output-path", img_feats, "--text-feat-output-path", txt_feats,
        "--img-batch-size", str(batch_size), "--text-batch-size", str(batch_size),
        "--resume", checkpoint, "--vision-model", VISION, "--text-model", TEXT, *model])

    directions = {}
    ok = True
    feats = ["--image-feats", img_feats, "--text-feats", txt_feats, "--top-k", "10",
             "--platform", platform]
    preds = os.path.join(tmp, "predictions.jsonl")
    score_json = os.path.join(tmp, "score.json")
    topk.main(feats + ["--output", preds])
    evaluation.main([texts_jsonl, preds, score_json])
    with open(score_json) as f:
        score = json.load(f)["scoreJson"]
    mr_golden = _golden_mr(golden["t2i"])
    ok &= abs(score["mean_recall"] - mr_golden) <= MUGE_MR_TOL
    directions["t2i"] = {"scores": score, "golden": golden["t2i"], "golden_mr": mr_golden}

    if "i2t" in golden:
        tr_annot = transform_ir_annotation_to_tr.transform(
            texts_jsonl, os.path.join(tmp, f"{split}_texts.tr.jsonl"))
        preds_tr = os.path.join(tmp, "predictions_tr.jsonl")
        score_tr = os.path.join(tmp, "score_tr.json")
        topk.main(feats + ["--tr", "--output", preds_tr])
        evaluation_tr.main([tr_annot, preds_tr, score_tr])
        with open(score_tr) as f:
            score2 = json.load(f)["scoreJson"]
        mr2_golden = _golden_mr(golden["i2t"])
        ok &= abs(score2["mean_recall"] - mr2_golden) <= MUGE_MR_TOL
        directions["i2t"] = {"scores": score2, "golden": golden["i2t"], "golden_mr": mr2_golden}

    return {"check": f"{dataset}_zeroshot_retrieval", "ok": bool(ok),
            "directions": directions, "mr_tolerance": MUGE_MR_TOL}


def check_muge(checkpoint: str, muge_dir: str, work_dir: str | None = None,
               batch_size: int = 64, tiny: bool = False, platform: str = "cuda") -> dict:
    """MUGE zero-shot T2I gate (Results.md:13)."""
    r = check_retrieval("muge", checkpoint, muge_dir, work_dir, batch_size, tiny, platform)
    return {"check": "muge_zeroshot_t2i", "ok": r["ok"],
            "scores": r["directions"]["t2i"]["scores"], "golden": MUGE_GOLDEN,
            "mr_tolerance": MUGE_MR_TOL}


def check_imagenet(checkpoint: str, datapath: str, label_file: str | None = None,
                   work_dir: str | None = None, batch_size: int = 64, tiny: bool = False,
                   platform: str = "cuda") -> dict:
    """Zero-shot ImageNet-CN through the ELEVATER protocol
    (``zeroshot_evaluation``, with the reference's 183-prompt ``openai``
    template routing); top-1 against Results.md:94."""
    from nans_clip_tpu_torch.eval import zeroshot_evaluation

    tmp = work_dir or tempfile.mkdtemp(prefix="imagenet_golden_")
    argv = ["--dataset", "imagenet", "--datapath", datapath, "--resume", checkpoint,
            "--vision-model", VISION, "--text-model", TEXT,
            "--img-batch-size", str(batch_size), "--save-dir", tmp, *_model_args(tiny, platform)]
    if label_file:
        argv += ["--label-file", label_file]
    top1 = zeroshot_evaluation.main(argv) * 100.0
    return {"check": "imagenet_zeroshot_top1", "ok": bool(abs(top1 - IMAGENET_GOLDEN_TOP1)
                                                          <= IMAGENET_TOL),
            "top1": top1, "golden": IMAGENET_GOLDEN_TOP1, "tolerance": IMAGENET_TOL}


def check_lora_song(checkpoint: str, data_dir: str, lora_path: str, batch_size: int = 32,
                    tiny: bool = False, platform: str = "cuda") -> dict:
    """The fork's Southern-Song gate: zero-shot and LoRA-merged T2I / I2T R@1
    on the fork's valid split and trained adapter, each within 0.5 of the
    published before/after numbers."""
    from nans_clip_tpu_torch.eval import retrieval_suite

    results = retrieval_suite.main([
        "--data", data_dir, "--resume", checkpoint, "--vision-model", VISION,
        "--text-model", TEXT, "--lora", lora_path, "--batch-size", str(batch_size),
        *_model_args(tiny, platform)])
    got = {mode: {"t2i_r1": results[mode]["text_to_image"]["R@1"],
                  "i2t_r1": results[mode]["image_to_text"]["R@1"]}
           for mode in ("zeroshot", "lora")}
    ok = all(abs(got[m][k] - LORA_SONG_GOLDEN[m][k]) <= LORA_SONG_TOL for m in got for k in got[m])
    return {"check": "lora_song_r1", "ok": bool(ok), "got": got, "golden": LORA_SONG_GOLDEN,
            "tolerance": LORA_SONG_TOL}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name):
        sp = sub.add_parser(name)
        sp.add_argument("--checkpoint", required=True)
        sp.add_argument("--tiny-model", action="store_true",
                        help="2-layer debug config (configs.tiny_config)")
        sp.add_argument("--platform", default="cuda", choices=["cpu", "cuda"])
        return sp

    for name in ("pokemon", "pokemon-int8"):
        add(name).add_argument("--image", default=None)
    mg = add("muge")
    mg.add_argument("--muge-dir", required=True)
    mg.add_argument("--work-dir", default=None)
    mg.add_argument("--batch-size", type=int, default=64)
    for name in ("flickr30k-cn", "coco-cn"):
        rp = add(name)
        rp.add_argument("--data-dir", required=True,
                        help="official download dir (test_imgs.tsv + test_texts.jsonl) or "
                             "prebuilt npack dataset")
        rp.add_argument("--work-dir", default=None)
        rp.add_argument("--batch-size", type=int, default=64)
    im = add("imagenet")
    im.add_argument("--datapath", required=True, help="ImageFolder val root")
    im.add_argument("--label-file", default=None)
    im.add_argument("--work-dir", default=None)
    im.add_argument("--batch-size", type=int, default=64)
    ls = add("lora-song")
    ls.add_argument("--data-dir", required=True,
                    help="the fork's Southern-Song valid split (LMDB or npack)")
    ls.add_argument("--lora", required=True, help="trained adapter (.npz)")
    ls.add_argument("--batch-size", type=int, default=32)
    args = p.parse_args(argv)
    model = {"tiny": args.tiny_model, "platform": args.platform}
    if args.cmd == "pokemon":
        result = check_pokemon(args.checkpoint, args.image, **model)
    elif args.cmd == "pokemon-int8":
        result = check_pokemon_int8(args.checkpoint, args.image, **model)
    elif args.cmd == "muge":
        result = check_muge(args.checkpoint, args.muge_dir, args.work_dir, args.batch_size,
                            **model)
    elif args.cmd in ("flickr30k-cn", "coco-cn"):
        result = check_retrieval(args.cmd, args.checkpoint, args.data_dir, args.work_dir,
                                 args.batch_size, **model)
    elif args.cmd == "imagenet":
        result = check_imagenet(args.checkpoint, args.datapath, args.label_file, args.work_dir,
                                args.batch_size, **model)
    else:
        result = check_lora_song(args.checkpoint, args.data_dir, args.lora, args.batch_size,
                                 **model)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
