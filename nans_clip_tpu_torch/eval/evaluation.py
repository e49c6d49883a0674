"""Recall scorer (R@1/5/10 and mean recall) with strict submission
validation (counterpart of ``nans_clip_tpu/eval/evaluation.py``; reference
eval/evaluation.py:15-58 the validator, :94-157 the scoring and the
score-json schema). ``query_key`` / ``gallery_key`` select the direction
(``evaluation_tr.py`` is the image-to-text mirror). The exceptions carry
the JAX package's messages word for word.

CLI (t2i): python -m nans_clip_tpu_torch.eval.evaluation GOLDEN PRED OUT.json
"""

from __future__ import annotations

import json
import os
import sys

NUM_K = 10


def read_reference(path: str, query_key: str = "text_id",
                   gallery_key: str = "image_ids") -> dict:
    reference = {}
    with open(path, encoding="utf-8") as fin:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            reference[obj[query_key]] = obj[gallery_key]
    return reference


def read_submission(submit_path: str, reference: dict, k: int = NUM_K,
                    query_key: str = "text_id", gallery_key: str = "image_ids") -> dict:
    if not os.path.exists(submit_path):
        raise Exception("The submission file is not found!")
    submission = {}
    with open(submit_path, encoding="utf-8") as fin:
        for line in fin:
            line = line.strip()
            try:
                obj = json.loads(line)
            except Exception:
                raise Exception(f"Cannot parse this line into json object: {line}")
            if query_key not in obj:
                raise Exception(f"There exists one line not containing {query_key}: {line}")
            qid = obj[query_key]
            if not isinstance(qid, int):
                raise Exception(
                    f"Found an invalid {query_key} {qid}, it should be an integer "
                    f"(not string), please check your schema")
            if gallery_key not in obj:
                raise Exception(
                    f"There exists one line not containing the predicted {gallery_key}: {line}")
            ids = obj[gallery_key]
            if not isinstance(ids, list):
                raise Exception(
                    f"The {gallery_key} field of {query_key} {qid} is not a list, "
                    f"please check your schema")
            if len(ids) != k:
                raise Exception(
                    f"{query_key} {qid} has wrong number of predicted {gallery_key}! "
                    f"Require {k}, but {len(ids)} founded.")
            for rank, gid in enumerate(ids):
                if not isinstance(gid, int):
                    raise Exception(
                        f"{query_key} {qid} has an invalid prediction {gid} at rank "
                        f"{rank + 1}, it should be an integer (not string)")
            if len(set(ids)) != k:
                raise Exception(
                    f"{query_key} {qid} has duplicate topk predictions. Please check again!")
            submission[qid] = ids
    missing = set(reference) - set(submission)
    if missing:
        raise Exception(
            "The following {} have no prediction in your submission, please check "
            "again: {}".format(query_key + "s", ", ".join(str(i) for i in sorted(missing))))
    return submission


def recall_at_ks(reference: dict, predictions: dict):
    r1 = r5 = r10 = 0
    for qid, gt in reference.items():
        gt = set(gt)
        pred = predictions[qid]
        if any(i in pred[:1] for i in gt):
            r1 += 1
        if any(i in pred[:5] for i in gt):
            r5 += 1
        if any(i in pred[:10] for i in gt):
            r10 += 1
    n = len(reference)
    return r1 / n, r5 / n, r10 / n


def compute_score(golden_file: str, predict_file: str,
                  query_key: str = "text_id", gallery_key: str = "image_ids"):
    """[mean_recall, r1, r5, r10] in percent (reference
    evaluation.py:94-115)."""
    reference = read_reference(golden_file, query_key, gallery_key)
    predictions = read_submission(predict_file, reference, NUM_K, query_key, gallery_key)
    r1, r5, r10 = recall_at_ks(reference, predictions)
    mean_recall = (r1 + r5 + r10) / 3.0
    return [100 * s for s in (mean_recall, r1, r5, r10)]


def report_score(r1, r5, r10, out_path):
    mean_recall = (r1 + r5 + r10) / 3.0
    result = {
        "success": True,
        "score": mean_recall * 100,
        "scoreJson": {"score": mean_recall * 100, "mean_recall": mean_recall * 100,
                      "r1": r1 * 100, "r5": r5 * 100, "r10": r10 * 100},
    }
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(result, f)


def report_error(msg, out_path):
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"errorDetail": msg, "errorMsg": msg, "score": 0,
                   "scoreJson": {}, "success": False}, f)


def main(argv=None, query_key="text_id", gallery_key="image_ids"):
    argv = argv if argv is not None else sys.argv[1:]
    standard_path, submit_path, out_path = argv[:3]
    print(f"Read standard from {standard_path}")
    print(f"Read user submit file from {submit_path}")
    try:
        reference = read_reference(standard_path, query_key, gallery_key)
        predictions = read_submission(submit_path, reference, NUM_K, query_key, gallery_key)
        r1, r5, r10 = recall_at_ks(reference, predictions)
        report_score(r1, r5, r10, out_path)
        print("The evaluation finished successfully.")
    except Exception as e:
        report_error(e.args[0], out_path)
        print(f"The evaluation failed: {e.args[0]}")


if __name__ == "__main__":
    main()
