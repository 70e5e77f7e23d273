"""Gaussian diffusion sampling: DDPM, DDIM and PLMS, with guidance hooks
(counterpart of surfd_tpu/diffusion/gaussian.py, its sampling surface).

Every function takes a `Schedule` and a `model_fn(x, t) -> output` closure;
conditioning lives in the closure. `t` is a Python int indexing the
(possibly respaced) schedule; the denoiser and `cond_fn` see
`sched.model_timesteps(t)` as a (B,) tensor. The model output is read as
x₀ (START_X, the Surf-D setting), ε (EPSILON) or x_{t-1} (PREVIOUS_X); with
a LEARNED or LEARNED_RANGE variance its last axis holds 2C channels, the
mean's C first (channel-last, as in the JAX package).

The loops are Python loops over the steps. Noise comes from the caller's
`torch.Generator`, or is injected: `noise` for the initial sample and
`step_noise` (T − skip_timesteps, *shape) for the steps, so a test can
replay another implementation's noise exactly. PLMS draws no step noise.
Training losses are not here.
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple, Optional

import torch

from .schedule import Schedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class MeanType(str, enum.Enum):
    PREVIOUS_X = "prev_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class VarType(str, enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class PMeanVar(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def _model_t(sched: Schedule, x: torch.Tensor, t: int) -> torch.Tensor:
    """The (B,) timesteps the denoiser sees at step `t`."""
    tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    return sched.model_timesteps(tb)


# ---------------------------------------------------------------------------
# q(x_t | ...) and the model-output conversions
# ---------------------------------------------------------------------------

def q_sample(sched: Schedule, x_start, t: int, noise):
    """Sample x_t ~ q(x_t | x_0)."""
    c = sched.on(x_start.device)
    return c["sqrt_alphas_cumprod"][t] * x_start + c["sqrt_one_minus_alphas_cumprod"][t] * noise


def q_posterior_mean_variance(sched: Schedule, x_start, x_t, t: int):
    """q(x_{t-1} | x_t, x_0): (mean, variance, log_variance)."""
    c = sched.on(x_t.device)
    mean = c["posterior_mean_coef1"][t] * x_start + c["posterior_mean_coef2"][t] * x_t
    return mean, c["posterior_variance"][t], c["posterior_log_variance_clipped"][t]


def predict_xstart_from_eps(sched: Schedule, x_t, t: int, eps):
    c = sched.on(x_t.device)
    return c["sqrt_recip_alphas_cumprod"][t] * x_t - c["sqrt_recipm1_alphas_cumprod"][t] * eps


def predict_xstart_from_xprev(sched: Schedule, x_t, t: int, xprev):
    c = sched.on(x_t.device)
    coef1, coef2 = c["posterior_mean_coef1"][t], c["posterior_mean_coef2"][t]
    return (1.0 / coef1) * xprev - (coef2 / coef1) * x_t


def predict_eps_from_xstart(sched: Schedule, x_t, t: int, pred_xstart):
    c = sched.on(x_t.device)
    return (c["sqrt_recip_alphas_cumprod"][t] * x_t - pred_xstart) / c[
        "sqrt_recipm1_alphas_cumprod"][t]


def p_mean_variance(
    sched: Schedule,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: int,
    *,
    mean_type: MeanType = MeanType.START_X,
    var_type: VarType = VarType.FIXED_SMALL,
    clip_denoised: bool = True,
    denoised_fn: Optional[Callable] = None,
    inpainting: Optional[tuple] = None,
) -> PMeanVar:
    """p(x_{t-1} | x_t) parameters and the x₀ prediction at step `t`.
    `inpainting` is an optional (mask, values) pair: where mask holds, the
    model output is replaced by values."""
    c = sched.on(x.device)
    model_output = model_fn(x, _model_t(sched, x, t))
    if inpainting is not None:
        mask, values = inpainting
        model_output = torch.where(mask, values, model_output)

    if var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
        model_output, var_values = model_output.split(x.shape[-1], dim=-1)
        if var_type == VarType.LEARNED:
            log_variance = var_values
        else:
            min_log = c["posterior_log_variance_clipped"][t]
            max_log = torch.log(c["betas"][t])
            frac = (var_values + 1) / 2
            log_variance = frac * max_log + (1 - frac) * min_log
        variance = torch.exp(log_variance)
    elif var_type == VarType.FIXED_LARGE:
        variance, log_variance = c["fixed_large_variance"][t], c["fixed_large_log_variance"][t]
    elif var_type == VarType.FIXED_SMALL:
        variance = c["posterior_variance"][t]
        log_variance = c["posterior_log_variance_clipped"][t]
    else:
        raise ValueError(f"unsupported var_type {var_type}")

    def process_xstart(xs):
        if denoised_fn is not None:
            xs = denoised_fn(xs)
        return xs.clamp(-1.0, 1.0) if clip_denoised else xs

    if mean_type == MeanType.PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(sched, x, t, model_output))
        return PMeanVar(model_output, variance, log_variance, pred_xstart)
    if mean_type == MeanType.START_X:
        pred_xstart = process_xstart(model_output)
    elif mean_type == MeanType.EPSILON:
        pred_xstart = process_xstart(predict_xstart_from_eps(sched, x, t, model_output))
    else:
        raise ValueError(f"unsupported mean_type {mean_type}")
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return PMeanVar(mean, variance, log_variance, pred_xstart)


# ---------------------------------------------------------------------------
# Guidance hooks: cond_fn(x, model_t) returns the gradient of a log-density
# ---------------------------------------------------------------------------

def condition_mean(sched: Schedule, cond_fn, out: PMeanVar, x, t: int) -> PMeanVar:
    """Shift the mean by variance · gradient (DDPM guidance)."""
    gradient = cond_fn(x, _model_t(sched, x, t))
    return out._replace(mean=out.mean + out.variance * gradient)


def condition_score(sched: Schedule, cond_fn, out: PMeanVar, x, t: int) -> PMeanVar:
    """Move ε by −√(1 − ᾱ) · gradient and re-derive x₀ and the mean (DDIM,
    PLMS guidance)."""
    alpha_bar = sched.on(x.device)["alphas_cumprod"][t]
    eps = predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, _model_t(sched, x, t))
    pred_xstart = predict_xstart_from_eps(sched, x, t, eps)
    mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return out._replace(mean=mean, pred_xstart=pred_xstart)


# ---------------------------------------------------------------------------
# Single steps
# ---------------------------------------------------------------------------

def p_sample(sched: Schedule, model_fn: ModelFn, x: torch.Tensor, t: int,
             noise: torch.Tensor, *, cond_fn=None, const_noise: bool = False, **pmv_kwargs):
    """One DDPM ancestral step; returns (x_{t-1}, pred_xstart). With
    `const_noise` every sample takes the first sample's noise."""
    out = p_mean_variance(sched, model_fn, x, t, **pmv_kwargs)
    if const_noise:
        noise = noise[:1].expand_as(noise)
    if cond_fn is not None:
        out = condition_mean(sched, cond_fn, out, x, t)
    nonzero = 1.0 if t != 0 else 0.0
    sample = out.mean + nonzero * torch.exp(0.5 * out.log_variance) * noise
    return sample, out.pred_xstart


def ddim_sample(sched: Schedule, model_fn: ModelFn, x: torch.Tensor, t: int,
                noise: torch.Tensor, *, eta: float = 0.0, cond_fn=None, **pmv_kwargs):
    """One DDIM step; returns (x_{t-1}, pred_xstart)."""
    c = sched.on(x.device)
    out = p_mean_variance(sched, model_fn, x, t, **pmv_kwargs)
    if cond_fn is not None:
        out = condition_score(sched, cond_fn, out, x, t)
    eps = predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    alpha_bar, alpha_bar_prev = c["alphas_cumprod"][t], c["alphas_cumprod_prev"][t]
    sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
             * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
    mean_pred = (out.pred_xstart * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps)
    nonzero = 1.0 if t != 0 else 0.0
    return mean_pred + nonzero * sigma * noise, out.pred_xstart


def ddim_reverse_sample(sched: Schedule, model_fn: ModelFn, x: torch.Tensor, t: int,
                        **pmv_kwargs):
    """Deterministic ODE step t → t+1; returns (x_{t+1}, pred_xstart)."""
    c = sched.on(x.device)
    out = p_mean_variance(sched, model_fn, x, t, **pmv_kwargs)
    eps = predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    alpha_bar_next = c["alphas_cumprod_next"][t]
    mean_pred = out.pred_xstart * torch.sqrt(alpha_bar_next) + torch.sqrt(1 - alpha_bar_next) * eps
    return mean_pred, out.pred_xstart


# ---------------------------------------------------------------------------
# Loops
# ---------------------------------------------------------------------------

def _start(sched: Schedule, shape, generator, device, noise, step_noise, skip_timesteps: int,
           init_image, draws_steps: bool):
    """(initial sample after the warm start, the steps in order, a function
    giving step i's noise) for one loop."""
    T = sched.num_timesteps
    if not 0 <= skip_timesteps < T:
        raise ValueError(f"skip_timesteps must be in [0, {T}), got {skip_timesteps}")
    if generator is None and (noise is None or (draws_steps and step_noise is None)):
        raise ValueError("pass a torch.Generator, or inject noise"
                         + (" and step_noise" if draws_steps else ""))
    n = T - skip_timesteps
    if step_noise is not None and tuple(step_noise.shape) != (n, *shape):
        raise ValueError(f"step_noise must be {(n, *shape)}, got {tuple(step_noise.shape)}")
    device = torch.device(device) if device is not None else (
        noise.device if noise is not None else torch.device("cpu"))

    def draw():
        return torch.randn(shape, generator=generator, device=device)

    img = noise.to(device) if noise is not None else draw()
    img = _warm_start(sched, img, init_image, skip_timesteps)
    step_z = (lambda i: step_noise[i].to(device)) if step_noise is not None else (lambda i: draw())
    return img, range(n - 1, -1, -1), step_z


def _warm_start(sched: Schedule, img, init_image, skip_timesteps: int):
    """Start from q(x_{t0} | init_image) at t0 = T − skip − 1, the initial
    noise as q's noise; a skip without an image starts from zeros."""
    if skip_timesteps and init_image is None:
        init_image = torch.zeros_like(img)
    if init_image is not None:
        img = q_sample(sched, init_image.to(img.device), sched.num_timesteps - skip_timesteps - 1,
                       img)
    return img


def p_sample_loop(
    sched: Schedule,
    model_fn: ModelFn,
    shape,
    generator: Optional[torch.Generator] = None,
    *,
    device=None,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
    cond_fn=None,
    const_noise: bool = False,
    **pmv_kwargs,
) -> torch.Tensor:
    """DDPM ancestral sampling from step T − skip − 1 down to 0."""
    img, steps, step_z = _start(sched, shape, generator, device, noise, step_noise,
                                skip_timesteps, init_image, draws_steps=True)
    for i, t in enumerate(steps):
        img, _ = p_sample(sched, model_fn, img, t, step_z(i), cond_fn=cond_fn,
                          const_noise=const_noise, **pmv_kwargs)
    return img


def ddim_sample_loop(
    sched: Schedule,
    model_fn: ModelFn,
    shape,
    generator: Optional[torch.Generator] = None,
    *,
    eta: float = 0.0,
    device=None,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
    cond_fn=None,
    **pmv_kwargs,
) -> torch.Tensor:
    """DDIM sampling; every step takes one noise draw, as the DDPM loop does,
    also at η = 0."""
    img, steps, step_z = _start(sched, shape, generator, device, noise, step_noise,
                                skip_timesteps, init_image, draws_steps=True)
    for i, t in enumerate(steps):
        img, _ = ddim_sample(sched, model_fn, img, t, step_z(i), eta=eta, cond_fn=cond_fn,
                             **pmv_kwargs)
    return img


# Adams-Bashforth coefficients for PLMS orders 1-4; row k is order k+1, its
# entries weight ε of this step, the one before, and so on.
_AB_COEFFS = (
    (1.0,),
    (3.0 / 2.0, -1.0 / 2.0),
    (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0),
    (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0),
)


def plms_sample_loop(
    sched: Schedule,
    model_fn: ModelFn,
    shape,
    generator: Optional[torch.Generator] = None,
    *,
    order: int = 2,
    device=None,
    noise: Optional[torch.Tensor] = None,
    skip_timesteps: int = 0,
    init_image: Optional[torch.Tensor] = None,
    cond_fn=None,
    **pmv_kwargs,
) -> torch.Tensor:
    """PLMS (pseudo linear multistep) sampling. With order ≥ 2 the first
    step is a pseudo improved-Euler step (a second model call at
    max(t − 1, 0)); every later step is Adams-Bashforth of order
    min(order, steps taken + 1) over the ε history, one model call each. At
    t = 0 the sample is the x₀ prediction."""
    if not 1 <= order <= 4:
        raise ValueError("order must be 1..4")
    img, steps, _ = _start(sched, shape, generator, device, noise, None, skip_timesteps,
                           init_image, draws_steps=False)
    c = sched.on(img.device)

    def eps_and_x0(x, t):
        out = p_mean_variance(sched, model_fn, x, t, **pmv_kwargs)
        if cond_fn is not None:
            out = condition_score(sched, cond_fn, out, x, t)
        return predict_eps_from_xstart(sched, x, t, out.pred_xstart), out.pred_xstart

    prev = []  # ε of the earlier steps, newest first, at most 3
    for t in steps:
        alpha_bar_prev = c["alphas_cumprod_prev"][t]
        eps, x0 = eps_and_x0(img, t)
        if order > 1 and not prev:
            mean_pred = x0 * torch.sqrt(alpha_bar_prev) + torch.sqrt(1 - alpha_bar_prev) * eps
            eps2, _ = eps_and_x0(mean_pred, max(t - 1, 0))
            eps_prime = (eps + eps2) / 2.0
        else:
            hist = [eps] + prev
            coeffs = _AB_COEFFS[min(order, len(hist)) - 1]
            eps_prime = sum(k * e for k, e in zip(coeffs, hist))
        if t == 0:
            img = x0
        else:
            pred_prime = predict_xstart_from_eps(sched, img, t, eps_prime)
            img = (pred_prime * torch.sqrt(alpha_bar_prev)
                   + torch.sqrt(1 - alpha_bar_prev) * eps_prime)
        prev = [eps] + prev[:2]
    return img
