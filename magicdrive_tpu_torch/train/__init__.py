"""Training of the ControlNet and the UNet's cross-view modules (counterpart
of ``train/``): ``state`` (trainable partition, fp32 masters, the optimizer
with its schedules and gradient accumulation), ``adam8bit`` (int8 moments),
``train_step`` (the loss and one optimizer step) and ``runner`` (the
config-driven loop: loader, deferred NaN check, checkpoints and resume,
validation, profile window, weight export)."""
from .runner import (MetricsLogger, Runner, Validator,
                     train_config_from_cfg)
from .state import (TrainConfig, TrainState, create_train_state,
                    is_trainable, make_lr_schedule, reset_lr_schedule)
from .train_step import StepDraws, make_drop_mask, train_step

__all__ = ["MetricsLogger", "Runner", "StepDraws", "TrainConfig",
           "TrainState", "Validator", "create_train_state", "is_trainable",
           "make_drop_mask", "make_lr_schedule", "reset_lr_schedule",
           "train_config_from_cfg", "train_step"]
