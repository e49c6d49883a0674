"""The data flywheel (counterpart of ``nans_clip_tpu/flywheel``): scrape
images, annotate them with a VLM, paraphrase the captions with an LLM,
filter the pairs with the model itself (``filter_annotations``, the one
stage that runs it), and build the reference training format."""

from nans_clip_tpu_torch.flywheel.build_dataset import build_texts_for_image

__all__ = ["build_texts_for_image"]
