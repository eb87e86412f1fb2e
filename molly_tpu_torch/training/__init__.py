"""SFT training in PyTorch, the counterpart of ``molly_tpu.training``."""

from .trainer import (TrainConfig, TrainState, attach_lora, init_train_state,
                      make_schedule, make_train_step, trainable_mask)

__all__ = ["TrainConfig", "TrainState", "attach_lora", "init_train_state",
           "make_schedule", "make_train_step", "trainable_mask"]
