"""Plain reference of Surf-D's diffusion train step (guided-diffusion's
`training_losses` with the x₀ target and Surf-D's L1 loss, `train_diffcloth`):
x_t = √ᾱ_t·x₀ + √(1 − ᾱ_t)·ε on the cosine schedule; the loss is the batch
mean of w · 1000 · mean|denoiser(x_t, t) − x₀|; AdamW (β 0.9 / 0.999, ε 1e-8,
decoupled weight decay) at lr·0.9^⌊count/1000⌋ floored at 1e-7.

`run` follows the first steps of a training from the same initial weights,
batches and noise draws as the program and returns what the check compares:
each step's loss, each leaf's first gradient, and each leaf's change after
the steps.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mdm as ref_mdm
from .precision import F32, Precision
from .sampler import cosine_betas, linear_betas


def run(sd0: dict, cfg: dict, batches: list, noise_fn, opt: dict,
        p: Precision = F32) -> dict:
    """batches: [(latents (B, L), action (B,) or None, context or None, t (B,),
    weights (B,))] on the device; `noise_fn(shape)` gives each step's noise
    ((B, L, 1): the program's one draw a step). Returns {"losses": [...], "grad": {leaf:
    first gradient}, "delta": {leaf: change after the steps}}."""
    dev = next(iter(sd0.values())).device
    betas = {"cosine": cosine_betas, "linear": linear_betas}[cfg["noise_schedule"]](
        cfg["diffusion_steps"])
    ac = np.cumprod(1.0 - betas)
    sqrt_ac = torch.tensor(np.sqrt(ac).astype(np.float32), device=dev)
    sqrt_1m = torch.tensor(np.sqrt(1.0 - ac).astype(np.float32), device=dev)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in sd0.items()}
    m1 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    for i, (lat, action, ctx, t, w) in enumerate(batches, 1):
        x0 = lat[..., None]
        noise = noise_fn(x0.shape)
        xt = sqrt_ac[t].reshape(-1, 1, 1) * x0 + sqrt_1m[t].reshape(-1, 1, 1) * noise
        out = ref_mdm.forward(params, cfg, xt, t, y=action, context=ctx, p=p)
        loss = (opt["l1_weight"] * (out - x0).abs().mean(dim=(1, 2)) * w).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(params, grads)}
        lr = max(opt["lr"] * opt["decay_rate"] ** ((i - 1) // opt["decay_every"]), opt["lr_floor"])
        with torch.no_grad():
            for (k, prm), g in zip(params.items(), grads):
                prm.mul_(1.0 - lr * opt["weight_decay"])
                m1[k].mul_(b1).add_(g, alpha=1 - b1)
                m2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (m2[k] / (1 - b2 ** i)).sqrt().add_(eps)
                prm.sub_(lr / (1 - b1 ** i) * m1[k] / denom)
    delta = {k: (v.detach() - sd0[k]) for k, v in params.items()}
    return {"losses": losses, "grad": first, "delta": delta}
