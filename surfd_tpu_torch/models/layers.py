"""Shared building blocks of the denoiser (counterpart of surfd_tpu/models/layers.py),
and the AE's BatchNorm with flax's semantics."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embeddings in [cos | sin] order, f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def group_count(channels: int, num_groups: int = 32) -> int:
    """32 groups, halved until they divide the channels (narrow test widths)."""
    groups = num_groups
    while channels % groups:
        groups //= 2
    return groups


class GroupNorm32(nn.GroupNorm):
    """GroupNorm computed in float32, eps 1e-5, channel-first input."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__(group_count(channels, num_groups), channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


@torch.no_grad()
def lecun_normal_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded LeCun-normal weights in every convolution and linear layer
    (N(0, 1 / fan_in), zero-init layers included, so that a random model's
    output is not identically zero), zero biases, unit norms, N(0, 1)
    embeddings; in `module.modules()` order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv3d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
    return module


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, training: bool) -> torch.Tensor:
    """flax `nn.BatchNorm` over every axis but the last, with `bn`'s eps,
    affine parameters (when it has them) and running buffers.

    Eval: the running statistics. Train: the batch's mean and its biased
    variance E[x²] − E[x]² clipped at 0 (flax's `use_fast_variance`), kept
    in the autograd graph, so that gradients couple the points through them
    as JAX's do; the running buffers move by `bn.momentum` in torch's
    convention (0.1 here is flax's momentum 0.9) towards the batch's mean
    and that same biased variance, where `F.batch_norm(training=True)`
    would take the unbiased one.
    """
    flat = x.reshape(-1, x.shape[-1])
    if not training:
        return F.batch_norm(flat, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            training=False, eps=bn.eps).reshape(x.shape)
    mean = flat.mean(0)
    var = torch.clamp(flat.square().mean(0) - mean.square(), min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
    mul = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        mul = mul * bn.weight
    y = (x - mean) * mul
    return y if bn.bias is None else y + bn.bias
