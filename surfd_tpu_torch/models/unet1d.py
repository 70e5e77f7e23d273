"""1-D UNet denoiser (guided-diffusion lineage), PyTorch counterpart of
surfd_tpu/models/unet1d.py at the Surf-D configuration: scale-shift norm
off, resampling by convolution, attention at downsample rates {1, 2, 4}.

Internally channel-first `(B, C, L)`, PyTorch's and the upstream Conv1d
layout. Module names follow upstream (`time_embed`, `input_blocks`,
`middle_block`, `output_blocks`, `out`, `label_emb`, `sketch_emb`), so an
upstream `Unet.*` state dict loads with strict=True.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_kernel import qkv_attention
from .layers import GroupNorm32, timestep_embedding


class SeededDropout(nn.Module):
    """Dropout drawing its mask from `self.generator` (a torch.Generator on
    the input's device, set by the trainer; None draws from the global one).
    Active in train() mode, the identity in eval() mode or at p 0. Keeps
    with probability 1 − p and scales kept values by 1 / (1 − p), as Flax's
    `nn.Dropout` does; the bits differ from JAX's."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)
        return x * keep / (1.0 - self.p)


class ResBlock1D(nn.Module):
    """Residual block with additive timestep-embedding injection; `dropout`
    sits between the second SiLU and the last convolution."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int, dropout: float = 0.0):
        super().__init__()
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(), nn.Conv1d(channels, out_channels, 3, padding=1)
        )
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), SeededDropout(dropout),
            nn.Conv1d(out_channels, out_channels, 3, padding=1),
        )
        self.skip_connection = (
            nn.Identity() if channels == out_channels
            else nn.Conv1d(channels, out_channels, 1)
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None]
        h = self.out_layers(h)
        return self.skip_connection(x) + h


class AttentionBlock1D(nn.Module):
    """Self-attention over the length axis; the attention itself is kernel K2."""

    def __init__(self, channels: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # K2 reads the convolution's (B, 3·H·c, T) output as a (B, T, 3·H·c)
        # view and writes a (B, H·c, T) tensor for proj_out: no copy either side
        h = qkv_attention(self.qkv(self.norm(x)).transpose(1, 2), self.num_heads).transpose(1, 2)
        return x + self.proj_out(h)


class Downsample1D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv1d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample1D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class TimestepSequential(nn.Sequential):
    """Sequential that hands the embedding to the residual blocks."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock1D) else layer(x)
        return x


class UNet1D(nn.Module):
    """The full 1-D UNet; `forward` takes and returns `(B, C, L)`."""

    def __init__(
        self,
        in_channels: int = 1,
        model_channels: int = 224,
        out_channels: int = 1,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_classes: Optional[int] = None,
        num_heads: int = 8,
        context_dim: Optional[int] = None,
        dropout: float = 0.0,
    ):
        super().__init__()
        mc = model_channels
        ted = 4 * mc
        self.model_channels = mc
        self.num_classes = num_classes
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)
        if context_dim is not None:
            self.sketch_emb = nn.Linear(context_dim, ted)

        ch = mc
        chans = [mc]
        ds = 1
        self.input_blocks = nn.ModuleList(
            [TimestepSequential(nn.Conv1d(in_channels, mc, 3, padding=1))]
        )
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock1D(ch, ted, mult * mc, dropout)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(AttentionBlock1D(ch, num_heads))
                self.input_blocks.append(TimestepSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepSequential(Downsample1D(ch)))
                chans.append(ch)
                ds *= 2
        self.middle_block = TimestepSequential(
            ResBlock1D(ch, ted, ch, dropout), AttentionBlock1D(ch, num_heads),
            ResBlock1D(ch, ted, ch, dropout),
        )
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock1D(ch + chans.pop(), ted, mult * mc, dropout)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(AttentionBlock1D(ch, num_heads))
                if level and i == num_res_blocks:
                    layers.append(Upsample1D(ch))
                    ds //= 2
                self.output_blocks.append(TimestepSequential(*layers))
        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(), nn.Conv1d(mc, out_channels, 3, padding=1)
        )
        self.eval()

    def forward(self, x, timesteps, context=None, y=None):
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("pass y iff the model is class-conditional")
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        if y is not None:
            emb = emb + self.label_emb(y)
        if context is not None:
            emb = emb + self.sketch_emb(context)
        h = x
        hs = []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        return self.out(h)

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "UNet1D":
        """Seeded LeCun-normal weights (every conv and linear, zero-init ones
        included, so the random model's output is not identically zero),
        zero biases, unit norms, N(0, 1) label embeddings."""
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
                )
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        return self

    @torch.no_grad()
    def training_init_(self, generator: torch.Generator, null_class: Optional[int] = None
                       ) -> "UNet1D":
        """The JAX package's initialisation for training from scratch:
        random_init_'s LeCun-normal weights (Flax draws them truncated), then
        the reference's zero-initialised convolutions (`zero_module`: each
        res block's last conv, each attention block's proj_out, the output
        conv) and the CFG null class's label row at zero."""
        self.random_init_(generator)
        zeroed = [b.out_layers[-1] for b in self.modules() if isinstance(b, ResBlock1D)]
        zeroed += [b.proj_out for b in self.modules() if isinstance(b, AttentionBlock1D)]
        for m in zeroed + [self.out[-1]]:
            m.weight.zero_()
            m.bias.zero_()
        if null_class is not None:
            self.label_emb.weight[null_class].zero_()
        return self
