from nans_clip_tpu_torch.training.trainer import (TrainConfig, TrainState, cosine_with_warmup,
                                                  create_train_state, make_eval_step,
                                                  make_optimizer, make_train_step,
                                                  no_decay_mask)

__all__ = [
    "TrainConfig", "TrainState", "cosine_with_warmup", "create_train_state",
    "make_eval_step", "make_optimizer", "make_train_step", "no_decay_mask",
]
