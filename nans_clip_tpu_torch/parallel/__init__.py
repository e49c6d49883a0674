from nans_clip_tpu_torch.parallel.loss import clip_loss

__all__ = ["clip_loss"]
