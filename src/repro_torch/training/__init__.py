"""Training substrate: optimizer, step builder, checkpointing, data."""
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.training.train_step import TrainState, build_train_step, init_train_state

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "TrainState",
    "build_train_step",
    "init_train_state",
]
