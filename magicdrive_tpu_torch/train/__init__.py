"""Training of the ControlNet and the UNet's cross-view modules (counterpart
of ``train/``): ``state`` (trainable partition, fp32 masters, AdamW),
``train_step`` (the loss and one optimizer step) and ``runner`` (the step
loop with the deferred NaN check and checkpoints)."""
from .runner import Runner
from .state import TrainConfig, TrainState, create_train_state, is_trainable
from .train_step import StepDraws, make_drop_mask, train_step

__all__ = ["Runner", "StepDraws", "TrainConfig", "TrainState",
           "create_train_state", "is_trainable", "make_drop_mask",
           "train_step"]
