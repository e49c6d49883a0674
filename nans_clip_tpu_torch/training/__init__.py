from nans_clip_tpu_torch.training.trainer import (CompactAdamW, TrainConfig, TrainState,
                                                  accumulate_backward, cosine_with_warmup,
                                                  create_train_state, full_weights,
                                                  make_eval_step, make_optimizer,
                                                  make_train_step, no_decay_mask,
                                                  shard_train_state, train_state_shardings)

__all__ = [
    "CompactAdamW", "TrainConfig", "TrainState", "accumulate_backward", "cosine_with_warmup",
    "create_train_state", "full_weights", "make_eval_step", "make_optimizer",
    "make_train_step", "no_decay_mask", "shard_train_state", "train_state_shardings",
]
