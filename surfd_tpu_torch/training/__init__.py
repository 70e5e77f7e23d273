from .common import (
    GracefulShutdown,
    StallWatchdog,
    TrainState,
    apply_update_if_finite,
    create_train_state,
    ema_update,
    global_norm,
    make_optimizer,
    staircase_lr,
)
from .diffusion_trainer import DiffusionTrainConfig, DiffusionTrainer, make_train_step

__all__ = [
    "GracefulShutdown", "StallWatchdog", "TrainState", "apply_update_if_finite",
    "create_train_state", "ema_update", "global_norm", "make_optimizer", "staircase_lr",
    "DiffusionTrainConfig", "DiffusionTrainer", "make_train_step",
]
