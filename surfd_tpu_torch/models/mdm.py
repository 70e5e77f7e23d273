"""MDM — the denoiser facade with conditioning routing, plus batched CFG.

PyTorch counterpart of surfd_tpu/models/mdm.py. The UNet sits under the
attribute `Unet`, so the state dict has the upstream `Unet.*` keys.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.cuda_graph import GraphedCall
from .unet1d import UNet1D

COND_MODES = ("no_cond", "text", "sketch", "img", "category")
CONTEXT_MODES = ("text", "sketch", "img")


class MDM(nn.Module):
    """Denoiser facade. Input and output latents are `(B, L, 1)` channel-last.
    `use_remat` and `dtype` are UNet1D's."""

    def __init__(
        self,
        cond_mode: str = "no_cond",
        num_actions: int = 9,
        clip_dim: int = 512,
        model_channels: int = 224,
        num_res_blocks: int = 2,
        channel_mult: tuple = (1, 2, 4, 4),
        num_heads: int = 8,
        dropout: float = 0.0,
        use_remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if cond_mode not in COND_MODES:
            raise ValueError(f"cond_mode must be one of {COND_MODES}, got {cond_mode}")
        self.cond_mode = cond_mode
        self.num_actions = num_actions
        self.Unet = UNet1D(
            model_channels=model_channels,
            num_res_blocks=num_res_blocks,
            channel_mult=channel_mult,
            # one extra label row: the dedicated CFG null class
            num_classes=num_actions + 1 if cond_mode == "category" else None,
            num_heads=num_heads,
            context_dim=clip_dim if cond_mode in CONTEXT_MODES else None,
            dropout=dropout,
            use_remat=use_remat,
            dtype=dtype,
        )
        self.dropout = float(dropout)  # res-block dropout, active in train() mode
        self.eval()

    @property
    def null_action(self) -> int:
        """The unconditional class id for CFG, one past the real classes."""
        return self.num_actions

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        action: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        h = x.permute(0, 2, 1)
        if self.cond_mode in CONTEXT_MODES:
            if context is None:
                raise ValueError(f"{self.cond_mode} conditioning requires context")
            out = self.Unet(h, timesteps, context=context)
        elif self.cond_mode == "category":
            if action is None:
                raise ValueError("category conditioning requires action labels")
            out = self.Unet(h, timesteps, y=action)
        else:
            out = self.Unet(h, timesteps)
        return out.permute(0, 2, 1)


def make_cfg_model_fn(model: MDM, guidance_scale: float, *, context=None, action=None):
    """A guided `model_fn(x, t)` for the samplers: the conditional and the
    unconditional branch run as one batched pass of 2B. On CUDA with grad
    off it is replayed from a CUDA graph captured at its first call
    (`ops.cuda_graph.GraphedCall`, whose `fn` is the eager function); the
    CPU, a call under grad and the model in train mode run it eagerly."""

    def cond_fn(x, t):
        return model(x, t, context=context, action=action)

    if guidance_scale == 1.0:
        return GraphedCall(cond_fn, model)

    if model.cond_mode in CONTEXT_MODES:
        def guided(x, t):
            ctx2 = torch.cat([context, torch.zeros_like(context)], dim=0)
            out = model(torch.cat([x, x]), torch.cat([t, t]), context=ctx2)
            out_cond, out_uncond = out.chunk(2, dim=0)
            return out_uncond + guidance_scale * (out_cond - out_uncond)

        return GraphedCall(guided, model)

    if model.cond_mode == "category":
        def guided(x, t):
            a2 = torch.cat([action, torch.full_like(action, model.null_action)], dim=0)
            out = model(torch.cat([x, x]), torch.cat([t, t]), action=a2)
            out_cond, out_uncond = out.chunk(2, dim=0)
            return out_uncond + guidance_scale * (out_cond - out_uncond)

        return GraphedCall(guided, model)

    return GraphedCall(cond_fn, model)
