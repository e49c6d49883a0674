"""Composed product drill: the whole reference workflow as one command
(counterpart of ``nans_clip_tpu/drill.py``, the same stages, record and
asserts), through the port's CLIs:

    dataset build (tsv + jsonl -> npack, ``preprocess/build_dataset``)
      -> finetune from a saved init ``.pt`` (``training/main`` with
         ``--clip-weight-path`` and ``--save-torch-format``: the real
         loader, augmentation, ``--steps-per-call``)
      -> 3-stage eval of the INIT and the TRAINED checkpoint
         (``eval/extract_features`` -> ``make_topk_predictions`` ->
         ``evaluation`` / ``evaluation_tr``, both directions): the mean
         recall MUST improve in both
      -> engine build from the trained checkpoint (``deploy/engine build``)
      -> the daemon (``deploy/server.ClipService``) on ``--engine-dir``
      -> the features it serves over HTTP MUST equal the offline ones
         (1e-5 in fp32, 2e-2 in bf16)

The dataset is synthetic but learnable (colour-coded images captioned by
colour words), so a model from scratch improves in a few hundred steps.
Every stage goes through the files a user handles (``.pt`` checkpoints,
npack splits, engine directories), so drift between stages (names,
transform modes, precision) fails the drill where each stage's own tests
pass.

    python -m nans_clip_tpu_torch.drill --scale tiny --platform cpu \\
        --workdir /tmp/drill --out DRILL.json          # CPU, seconds
    python -m nans_clip_tpu_torch.drill --scale chip --workdir /tmp/drill
        # ViT-B-16 + RoBERTa-base from scratch on the card, 224 px, bf16
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import os
import shutil
import threading
import time
import urllib.request
from typing import Callable, Optional

import numpy as np

# (word, RGB): visually and lexically distinct classes
COLORS = [
    ("红", (220, 40, 30)),
    ("绿", (40, 190, 60)),
    ("蓝", (30, 60, 220)),
    ("黄", (230, 210, 40)),
    ("紫", (150, 40, 190)),
    ("青", (40, 200, 200)),
    ("橙", (240, 140, 30)),
    ("灰", (128, 128, 128)),
]
TEMPLATES = ["一张{}色的图片", "{}色的方块", "这是{}色图案", "{}色背景照片"]


def _class_image(rs, rgb, resolution):
    """Solid class colour + noise + a lighter random rectangle (augmented
    crops stay informative, images within a class differ)."""
    img = np.tile(np.asarray(rgb, np.float32), (resolution, resolution, 1))
    img += rs.normal(0, 18, img.shape)
    x0, y0 = rs.randint(0, resolution // 2, 2)
    w, h = rs.randint(resolution // 8, resolution // 2, 2)
    img[y0:y0 + h, x0:x0 + w] = np.clip(img[y0:y0 + h, x0:x0 + w] * 1.25 + 15, 0, 255)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_dataset(workdir, resolution, per_class_train, per_class_valid, seed=7):
    """Write {train,valid}_imgs.tsv + _texts.jsonl and build the npack
    splits (the JAX drill's bytes at the same seed). The valid ground truth
    is by class: each valid text lists every valid image of its colour in
    ``image_ids``, so recall improves as the model learns colour <-> word,
    not by memorising pairs."""
    from PIL import Image

    from nans_clip_tpu_torch.eval.transform_ir_annotation_to_tr import transform
    from nans_clip_tpu_torch.preprocess.build_dataset import build_split

    rs = np.random.RandomState(seed)
    os.makedirs(workdir, exist_ok=True)

    def write_split(split, per_class, class_gt):
        img_id, text_id = 0, 0
        class_images = {ci: [] for ci in range(len(COLORS))}
        with open(os.path.join(workdir, f"{split}_imgs.tsv"), "w") as f:
            for ci, (_, rgb) in enumerate(COLORS):
                for _ in range(per_class):
                    buf = io.BytesIO()
                    Image.fromarray(_class_image(rs, rgb, resolution)).save(
                        buf, format="JPEG", quality=92)
                    f.write(f"{img_id}\t{base64.urlsafe_b64encode(buf.getvalue()).decode()}\n")
                    class_images[ci].append(img_id)
                    img_id += 1
        with open(os.path.join(workdir, f"{split}_texts.jsonl"), "w", encoding="utf-8") as f:
            for ci, (word, _) in enumerate(COLORS):
                for j in range(per_class):
                    text = TEMPLATES[j % len(TEMPLATES)].format(word)
                    gt = class_images[ci] if class_gt else [class_images[ci][j]]
                    f.write(json.dumps({"text_id": text_id, "text": text, "image_ids": gt},
                                       ensure_ascii=False) + "\n")
                    text_id += 1
        build_split(workdir, split)
        return img_id, text_id

    n_ti, n_tt = write_split("train", per_class_train, class_gt=False)
    n_vi, n_vt = write_split("valid", per_class_valid, class_gt=True)
    transform(os.path.join(workdir, "valid_texts.jsonl"))   # image -> text, the _tr leg
    return {"train_images": n_ti, "train_texts": n_tt,
            "valid_images": n_vi, "valid_texts": n_vt}


def save_init_checkpoint(path, cfg, seed=0):
    """Random init in the reference's .pt layout, from a generator seeded
    by ``seed`` on the host: the drill's step 0."""
    import torch

    from nans_clip_tpu_torch.models.clip import build_clip
    from nans_clip_tpu_torch.utils.checkpoint import save_torch_checkpoint

    module = build_clip(cfg, "cpu", torch.Generator().manual_seed(seed))
    save_torch_checkpoint(path, module, {"epoch": 0, "step": 0, "name": "drill"})
    return path


def eval_pipeline(workdir, tag, ckpt, scale_args):
    """The 3-stage pipeline in both directions -> ({'t2i': scores, 'i2t':
    scores}, image features path, text features path)."""
    from nans_clip_tpu_torch.eval import (evaluation, evaluation_tr, extract_features,
                                          make_topk_predictions)

    valid = os.path.join(workdir, "valid")
    texts_jsonl = os.path.join(workdir, "valid_texts.jsonl")
    tr_jsonl = os.path.join(workdir, "valid_texts.tr.jsonl")
    txt_f = os.path.join(workdir, f"{tag}.txt_feat.jsonl")
    img_f = os.path.join(workdir, f"{tag}.img_feat.jsonl")
    extract_features.main([
        "--extract-image-feats", "--extract-text-feats",
        "--image-data", valid, "--text-data", texts_jsonl,
        "--text-feat-output-path", txt_f, "--image-feat-output-path", img_f,
        "--img-batch-size", str(scale_args["eval_batch"]),
        "--text-batch-size", str(scale_args["eval_batch"]),
        "--resume", ckpt, "--platform", scale_args["platform"], *scale_args["model_flags"]])
    out = {}
    for direction, qf, extra in (("t2i", texts_jsonl, []), ("i2t", tr_jsonl, ["--tr"])):
        topk = os.path.join(workdir, f"{tag}.topk_{direction}.jsonl")
        make_topk_predictions.main([
            "--image-feats", img_f, "--text-feats", txt_f, "--top-k", "10",
            "--eval-batch-size", "32", "--output", topk,
            "--platform", scale_args["platform"], *extra])
        score = os.path.join(workdir, f"{tag}.score_{direction}.json")
        (evaluation_tr if direction == "i2t" else evaluation).main([qf, topk, score])
        with open(score) as f:
            res = json.load(f)
        assert res.get("success"), res
        out[direction] = res["scoreJson"]
    return out, img_f, txt_f


def serve_and_query(engine_dir, workdir, scale_args, img_feat_path, txt_feat_path, n_query):
    """Start the daemon on the built engines, query it over HTTP, and
    compare the served features with the offline extract_features rows."""
    from nans_clip_tpu_torch.configs import tiny_config
    from nans_clip_tpu_torch.data.npack import NPackReader
    from nans_clip_tpu_torch.deploy.server import ClipService, make_server
    from nans_clip_tpu_torch.eval.model_io import load_eval_model

    model = load_eval_model(scale_args["vision"], scale_args["text"],
                            scale_args["trained_ckpt"], scale_args["precision"],
                            cfg=tiny_config() if scale_args["tiny"] else None,
                            device=scale_args["platform"])
    service = ClipService(model, max_batch=n_query, dynamic_batching=False,
                          engine_dir=engine_dir)
    assert service.backend == "engine", service.backend
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, obj):
        req = urllib.request.Request(url + path, json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())

    def read_rows(path, key):
        rows = {}
        with open(path) as f:
            for line in f:
                obj = json.loads(line)
                rows[obj[key]] = np.asarray(obj["feature"], np.float32)
        return rows

    try:
        offline_img = read_rows(img_feat_path, "image_id")
        offline_txt = read_rows(txt_feat_path, "text_id")
        reader = NPackReader(os.path.join(workdir, "valid", "imgs.npack"))
        ids = sorted(offline_img)[:n_query]
        images_b64 = [base64.b64encode(reader.get(int(k))).decode() for k in ids]
        reader.close()
        served_img = np.asarray(post("/encode_image", {"images": images_b64})["features"],
                                np.float32)
        img_diff = float(np.abs(served_img - np.stack([offline_img[k] for k in ids])).max())
        with open(os.path.join(workdir, "valid_texts.jsonl"), encoding="utf-8") as f:
            rows = [json.loads(line) for line in f][:n_query]
        served_txt = np.asarray(post("/encode_text", {"texts": [r["text"] for r in rows]})[
            "features"], np.float32)
        txt_diff = float(np.abs(
            served_txt - np.stack([offline_txt[r["text_id"]] for r in rows])).max())
        # a 1-text request on the batch-N engine runs the daemon's padding
        padded = post("/encode_text", {"texts": [rows[0]["text"]]})
        assert len(padded["features"]) == 1
    finally:
        srv.shutdown()
        srv.server_close()
    return {"served_vs_offline_image_max_diff": img_diff,
            "served_vs_offline_text_max_diff": txt_diff, "backend": "engine"}


SCALES = {
    # CPU test scale: seconds, tiny config, fp32
    "tiny": dict(vision="ViT-B-16", text="RoBERTa-wwm-ext-base-chinese", tiny=True,
                 resolution=32, per_class_train=8, per_class_valid=2, steps=200,
                 batch_size=16, lr=2e-3, warmup=5, precision="fp32", attn="xla",
                 eval_batch=16, engine_batch=8, steps_per_call=2),
    # the card: ViT-B-16 + RoBERTa-base from scratch at full width and depth;
    # 3,200 train pairs, so 200 steps at 64 are 4 epochs (4 checkpoints)
    "chip": dict(vision="ViT-B-16", text="RoBERTa-wwm-ext-base-chinese", tiny=False,
                 resolution=224, per_class_train=400, per_class_valid=4, steps=200,
                 batch_size=64, lr=1e-4, warmup=20, precision="bf16", attn="auto",
                 eval_batch=32, engine_batch=8, steps_per_call=4),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="nans_clip_tpu_torch.drill")
    p.add_argument("--scale", choices=sorted(SCALES), default="tiny")
    p.add_argument("--workdir", required=True)
    p.add_argument("--out", default=None, help="drill record json path")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="the device of every stage (default: the card; raises without one)")
    p.add_argument("--steps", type=int, default=None, help="override the scale's train steps")
    p.add_argument("--seed", type=int, default=123)
    return p.parse_args(argv)


def main(argv=None, stage_hook: Optional[Callable[[str, Optional[dict]], None]] = None):
    """Run the drill; returns its record. ``stage_hook(name, None)`` is
    called as each stage starts and ``stage_hook(name, entry)`` as it ends,
    with the stage's record entry (a caller may add to it)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    s = SCALES[args.scale]
    steps = args.steps or s["steps"]
    record = {"scale": args.scale, "steps": steps, "platform": args.platform, "stages": {},
              "ok": False}
    t_all = time.time()

    def stage(name):
        record["stages"][name] = {"t0": time.time()}
        logging.info("drill stage: %s", name)
        if stage_hook:
            stage_hook(name, None)

    def done(name, **kw):
        st = record["stages"][name]
        st["seconds"] = round(time.time() - st.pop("t0"), 2)
        st.update(kw)
        if stage_hook:
            stage_hook(name, st)

    workdir = os.path.abspath(args.workdir)

    stage("build_dataset")
    counts = make_dataset(workdir, s["resolution"], s["per_class_train"], s["per_class_valid"],
                          seed=args.seed)
    done("build_dataset", **counts)

    stage("init_checkpoint")
    from nans_clip_tpu_torch.configs import load_config, tiny_config
    cfg = tiny_config() if s["tiny"] else load_config(f"{s['vision']}@{s['text']}")
    init_ckpt = save_init_checkpoint(os.path.join(workdir, "init.pt"), cfg, seed=args.seed)
    done("init_checkpoint", path=init_ckpt)

    stage("train")
    from nans_clip_tpu_torch.training.main import main as train_main
    logs = os.path.join(workdir, "logs")
    # the drill owns its workdir: a previous run's checkpoints would make
    # the trainer resume them instead of training from the init checkpoint
    shutil.rmtree(logs, ignore_errors=True)
    train_argv = [
        "--train-data", os.path.join(workdir, "train"),
        "--clip-weight-path", init_ckpt,   # init from the saved step-0 .pt
        "--batch-size", str(s["batch_size"]), "--lr", str(s["lr"]),
        "--warmup", str(s["warmup"]), "--wd", "0.001",
        "--max-steps", str(steps), "--precision", s["precision"],
        "--attn-impl", s["attn"], "--use-augment",
        "--steps-per-call", str(s["steps_per_call"]),
        "--save-torch-format", "--logs", logs, "--name", "drill",
        "--log-interval", "10", "--num-workers", "4",
        "--seed", str(args.seed), "--platform", args.platform,
    ]
    if s["tiny"]:
        train_argv += ["--tiny-model"]
    state = train_main(train_argv)
    # a trainer stopped by a signal returns after its save: an eval of that
    # partial model would pass or fail on noise, so demand the full run
    assert int(state.step) >= steps, (
        f"training stopped early at step {int(state.step)}/{steps} (preempted?)")
    ckpt_dir = os.path.join(logs, "drill", "checkpoints")
    with open(os.path.join(ckpt_dir, "LATEST")) as f:
        tag = f.read().strip()
    trained_ckpt = os.path.join(ckpt_dir, f"{tag}.pt")
    assert os.path.exists(trained_ckpt), trained_ckpt
    done("train", steps_run=int(state.step), checkpoint=trained_ckpt)
    del state

    model_flags = ["--vision-model", s["vision"], "--text-model", s["text"],
                   "--precision", s["precision"]]
    if s["tiny"]:
        model_flags += ["--tiny-model"]
    scale_args = dict(s, model_flags=model_flags, trained_ckpt=trained_ckpt,
                      platform=args.platform)

    stage("eval_init")
    mr_init, _, _ = eval_pipeline(workdir, "init", init_ckpt, scale_args)
    done("eval_init", **{d: m["mean_recall"] for d, m in mr_init.items()})

    stage("eval_trained")
    mr_trained, img_f, txt_f = eval_pipeline(workdir, "trained", trained_ckpt, scale_args)
    done("eval_trained", **{d: m["mean_recall"] for d, m in mr_trained.items()})

    record["mean_recall_init"] = {d: m["mean_recall"] for d, m in mr_init.items()}
    record["mean_recall_trained"] = {d: m["mean_recall"] for d, m in mr_trained.items()}
    record["recalls_trained"] = {d: {k: m[k] for k in ("r1", "r5", "r10")}
                                 for d, m in mr_trained.items()}
    improved = all(record["mean_recall_trained"][d] > record["mean_recall_init"][d]
                   for d in ("t2i", "i2t"))
    record["improved"] = improved
    assert improved, (f"training did not improve retrieval: init={record['mean_recall_init']} "
                      f"trained={record['mean_recall_trained']}")

    stage("build_engines")
    from nans_clip_tpu_torch.deploy import engine as engine_mod
    engines = os.path.join(workdir, "engines")
    engine_argv = ["build", "--resume", trained_ckpt, "--towers", "image,text",
                   "--batch-sizes", str(s["engine_batch"]), "--precision", s["precision"],
                   "--vision-model", s["vision"], "--text-model", s["text"],
                   "--out-dir", engines, "--device", args.platform]
    if s["tiny"]:
        engine_argv += ["--tiny-model"]
    engine_mod.main(engine_argv)
    built = sorted(os.listdir(engines))
    assert built, engines
    done("build_engines", engines=built)

    stage("serve")
    served = serve_and_query(engines, workdir, scale_args, img_f, txt_f,
                             n_query=s["engine_batch"])
    tol = 1e-5 if s["precision"] == "fp32" else 2e-2
    assert served["served_vs_offline_image_max_diff"] <= tol, served
    assert served["served_vs_offline_text_max_diff"] <= tol, served
    done("serve", **served)

    record["ok"] = True
    record["wall_seconds"] = round(time.time() - t_all, 2)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    logging.info("drill ok: %s", json.dumps(record))
    return record


if __name__ == "__main__":
    main()
