"""Training on one card — the port's ``repro.training``: AdamW and its
schedule, the train step with microbatch accumulation and remat, and
checkpoints in JAX's file format."""

from .checkpoint import load_checkpoint, save_checkpoint
from .optimizer import OptConfig, adamw_update, global_norm, init_opt_state, schedule
from .trainer import cross_entropy, grads_fn, loss_fn, make_train_step, train_step

__all__ = [
    "OptConfig",
    "adamw_update",
    "global_norm",
    "init_opt_state",
    "schedule",
    "cross_entropy",
    "grads_fn",
    "loss_fn",
    "make_train_step",
    "train_step",
    "load_checkpoint",
    "save_checkpoint",
]
