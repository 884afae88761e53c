from .step import (SGDMomentum, TrainState, init_train_state, loss_fn,
                   make_optimizer, make_train_step)
from .lr import lr_schedule, scale_lr

__all__ = ["SGDMomentum", "TrainState", "init_train_state", "loss_fn",
           "make_optimizer", "make_train_step", "lr_schedule", "scale_lr"]
