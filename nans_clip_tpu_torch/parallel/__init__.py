from nans_clip_tpu_torch.parallel.loss import clip_loss, kd_cosine_loss

__all__ = ["clip_loss", "kd_cosine_loss"]
