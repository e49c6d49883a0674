"""Examples of the port's public API (``python -m nans_clip_tpu_torch.examples.<name>``)."""
