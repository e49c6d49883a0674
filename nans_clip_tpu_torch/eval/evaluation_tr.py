"""Image-to-text recall scorer (counterpart of
``nans_clip_tpu/eval/evaluation_tr.py``, the reference eval/evaluation_tr.py
mirror).

CLI: python -m nans_clip_tpu_torch.eval.evaluation_tr GOLDEN PRED OUT.json
"""

from nans_clip_tpu_torch.eval.evaluation import main as _main


def main(argv=None):
    return _main(argv, query_key="image_id", gallery_key="text_ids")


if __name__ == "__main__":
    main()
