from .ae_trainer import (
    AETrainConfig,
    AutoEncoder,
    curriculum_validate,
    init_ae,
    make_ae_apply_fns,
    make_ae_eval_step,
    make_ae_train_step,
)
from .common import (
    GracefulShutdown,
    StallWatchdog,
    TrainState,
    annealed_lr,
    apply_update_if_finite,
    create_train_state,
    ema_update,
    global_norm,
    make_optimizer,
    snapshot_buffers,
    staircase_lr,
)
from .diffusion_trainer import DiffusionTrainConfig, DiffusionTrainer, make_train_step

__all__ = [
    "AETrainConfig", "AutoEncoder", "curriculum_validate", "init_ae", "make_ae_apply_fns",
    "make_ae_eval_step",
    "make_ae_train_step",
    "GracefulShutdown", "StallWatchdog", "TrainState", "annealed_lr", "apply_update_if_finite",
    "create_train_state", "ema_update", "global_norm", "make_optimizer", "snapshot_buffers",
    "staircase_lr",
    "DiffusionTrainConfig", "DiffusionTrainer", "make_train_step",
]
