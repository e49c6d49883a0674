from nans_clip_tpu_torch.models.common import ModelOptions

__all__ = ["ModelOptions"]
