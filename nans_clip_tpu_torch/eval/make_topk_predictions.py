"""kNN top-k retrieval over extracted features (counterpart of
``nans_clip_tpu/eval/make_topk_predictions.py``; reference
eval/make_topk_predictions.py:69-88).

The whole query set runs as chunked fp32 products on the device, each chunk
one [Q_chunk, N] product and a ``torch.topk`` over the full gallery. The
product is exact fp32: TF32 is switched off around it, whatever the
process's global flag says (the JAX package asks for
``Precision.HIGHEST`` for the same reason: a reduced-precision product
swaps near-tie ranks at the k boundary). k is capped at the gallery size.
Equal scores are listed by gallery position, as ``lax.top_k`` lists them.

Output lines: {"text_id": ..., "image_ids": [...]}, or with ``--tr`` the
image-to-text {"image_id": ..., "text_ids": [...]}.

  python -m nans_clip_tpu_torch.eval.make_topk_predictions \\
      --image-feats imgs.img_feat.jsonl --text-feats valid_texts.txt_feat.jsonl \\
      --top-k 10 --output predictions.jsonl [--tr] [--platform cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from nans_clip_tpu_torch.training.trainer import platform_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image-feats", required=True)
    p.add_argument("--text-feats", required=True)
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--eval-batch-size", type=int, default=1024, help="query chunk size")
    p.add_argument("--output", required=True)
    p.add_argument("--tr", action="store_true", help="image-to-text retrieval (the _tr variant)")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="the device of the products (default: the card; raises without one)")
    return p.parse_args(argv)


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in full precision on the card (TF32 off) for the
    block, the flag restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def load_feats(path: str, id_key: str):
    ids, feats = [], []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            ids.append(obj[id_key])
            feats.append(obj["feature"])
    return np.asarray(ids), np.asarray(feats, np.float32)


def topk_indices(queries: torch.Tensor, gallery: torch.Tensor, k: int) -> torch.Tensor:
    """[Q, min(k, N)] gallery positions of each query's best scores, best
    first, equal scores in position order. fp32 inputs, exact products."""
    with exact_fp32():
        scores = queries @ gallery.T
    k = min(k, gallery.shape[0])
    vals, idx = torch.topk(scores, k, dim=1)
    # a tie across the k-th score: topk may keep any of the tied; lax.top_k
    # keeps the first, so such a row (rare) takes a stable sort of its own
    last = vals[:, -1:]
    split = ((scores == last).sum(1) > (vals == last).sum(1)).nonzero().flatten()
    for r in split.tolist():
        order = torch.sort(scores[r], descending=True, stable=True).indices[:k]
        vals[r], idx[r] = scores[r, order], order
    idx, order = idx.sort(dim=1)
    vals = vals.gather(1, order)
    order = vals.sort(dim=1, descending=True, stable=True).indices
    return idx.gather(1, order)


def topk(query_ids, query_feats, gallery_ids, gallery_feats, k, chunk, device="cuda"):
    """Yields (query_id, [gallery ids ranked]) for all queries."""
    device = torch.device(device)
    gallery = torch.from_numpy(np.ascontiguousarray(gallery_feats, np.float32)).to(device)
    with torch.inference_mode():
        for i in range(0, len(query_ids), chunk):
            q = torch.from_numpy(np.ascontiguousarray(query_feats[i:i + chunk], np.float32))
            idx = topk_indices(q.to(device), gallery, k).cpu().numpy()
            for qid, row in zip(query_ids[i:i + chunk], idx):
                yield qid, gallery_ids[row].tolist()


def main(argv=None):
    args = parse_args(argv)
    device = platform_device(args.platform)
    image_ids, image_feats = load_feats(args.image_feats, "image_id")
    text_ids, text_feats = load_feats(args.text_feats, "text_id")

    with open(args.output, "w") as fout:
        if args.tr:
            for qid, ranked in topk(image_ids, image_feats, text_ids, text_feats,
                                    args.top_k, args.eval_batch_size, device):
                fout.write(json.dumps({"image_id": int(qid), "text_ids": ranked}) + "\n")
        else:
            for qid, ranked in topk(text_ids, text_feats, image_ids, image_feats,
                                    args.top_k, args.eval_batch_size, device):
                fout.write(json.dumps({"text_id": int(qid), "image_ids": ranked}) + "\n")
    print(f"Top-{args.top_k} predictions are saved in {args.output}")


if __name__ == "__main__":
    main()
