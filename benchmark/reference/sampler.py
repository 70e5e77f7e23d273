"""Plain reference of the latent samplers (guided-diffusion's
`GaussianDiffusion`, the settings every Surf-D generate script uses): the
denoiser predicts x₀ (START_X), the variance is the clipped posterior one
(FIXED_SMALL), x₀ is not clipped, the timesteps are not rescaled.

The samplers draw their noise in this order: the initial sample, then one
draw per step (DDIM at η = 0 draws it too and multiplies it by zero), each
of the sample's shape; `step` takes a step's draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def cosine_betas(T: int) -> np.ndarray:
    ab = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    return np.array([min(1.0 - ab((i + 1) / T) / ab(i / T), 0.999) for i in range(T)])


def linear_betas(T: int) -> np.ndarray:
    scale = 1000.0 / T
    return np.linspace(scale * 1e-4, scale * 0.02, T, dtype=np.float64)


def ddim_steps(T: int, n: int) -> list:
    """The retained steps of respacing "ddim{n}": the first integer stride
    that gives n steps."""
    for stride in range(1, T):
        if len(range(0, T, stride)) == n:
            return list(range(0, T, stride))
    raise ValueError(f"no integer stride gives {n} of {T} steps")


def schedule(name: str, T: int, respacing: str = "") -> dict:
    """Process constants (f32, from float64 sums) and the step map."""
    betas = {"cosine": cosine_betas, "linear": linear_betas}[name](T)
    tmap = list(range(T))
    if respacing:
        if not respacing.startswith("ddim"):
            raise ValueError(f"unsupported respacing {respacing}")
        tmap = ddim_steps(T, int(respacing[4:]))
        ac = np.cumprod(1.0 - betas)
        last, nb = 1.0, []
        for i in tmap:
            nb.append(1.0 - ac[i] / last)
            last = ac[i]
        betas = np.array(nb)
    ac = np.cumprod(1.0 - betas)
    ac_prev = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    return {
        "T": len(betas),
        "tmap": np.asarray(tmap, np.int64),
        "ac": ac, "ac_prev": ac_prev,
        "coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
        "coef2": (1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac),
        "log_var": np.log(np.append(post_var[1], post_var[1:])),
        "recip": np.sqrt(1.0 / ac), "recipm1": np.sqrt(1.0 / ac - 1.0),
    }


def _consts(sched: dict, device) -> dict:
    key = ("_f32", str(device))
    if key not in sched:
        sched[key] = {k: torch.tensor(np.asarray(v, np.float32), device=device)
                      for k, v in sched.items()
                      if isinstance(v, np.ndarray) and v.dtype != np.int64}
        sched[key]["tmap"] = torch.as_tensor(sched["tmap"], device=device)
    return sched[key]


def step(model_fn, sched: dict, x: torch.Tensor, t: int, noise: torch.Tensor,
         sampler: str = "ddpm") -> torch.Tensor:
    """One step from x (B, L, 1) at step index t: model_fn(x, timesteps) →
    x₀, then the sampler's update with this step's noise draw."""
    c = _consts(sched, x.device)
    x0 = model_fn(x, c["tmap"][t].repeat(x.shape[0]))
    if sampler == "ddpm":
        out = c["coef1"][t] * x0 + c["coef2"][t] * x
        return out + torch.exp(0.5 * c["log_var"][t]) * noise if t else out
    if sampler == "ddim":
        eps = (c["recip"][t] * x - x0) / c["recipm1"][t]
        return x0 * torch.sqrt(c["ac_prev"][t]) + torch.sqrt(1 - c["ac_prev"][t]) * eps
    raise ValueError(f"unsupported sampler {sampler}")
