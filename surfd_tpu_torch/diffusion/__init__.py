from .gaussian import (
    MeanType,
    PMeanVar,
    VarType,
    condition_mean,
    condition_score,
    ddim_reverse_sample,
    ddim_sample,
    ddim_sample_loop,
    p_mean_variance,
    p_sample,
    p_sample_loop,
    plms_sample_loop,
    predict_eps_from_xstart,
    predict_xstart_from_eps,
    predict_xstart_from_xprev,
    q_posterior_mean_variance,
    q_sample,
)
from .schedule import (
    Schedule,
    make_schedule,
    named_beta_schedule,
    named_schedule,
    space_timesteps,
    spaced_schedule,
)

__all__ = [
    "MeanType", "PMeanVar", "VarType", "condition_mean", "condition_score",
    "ddim_reverse_sample", "ddim_sample", "ddim_sample_loop", "p_mean_variance", "p_sample",
    "p_sample_loop", "plms_sample_loop", "predict_eps_from_xstart", "predict_xstart_from_eps",
    "predict_xstart_from_xprev", "q_posterior_mean_variance", "q_sample", "Schedule",
    "make_schedule", "named_beta_schedule", "named_schedule", "space_timesteps",
    "spaced_schedule",
]
