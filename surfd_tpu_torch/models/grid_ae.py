"""3-D grid autoencoder blocks (counterpart of surfd_tpu/models/grid_ae.py).

ResnetBlock3D, AttnBlock3D, Down/Upsample3D and GridAutoencoder: the
grid-based AE ablation of the upstream lineage, unused on the Surf-D main
path, kept for experiments that used it. Channel-first `(B, C, D, H, W)`,
torch's layout; the JAX package is channel-last and `utils.convert`
transposes at the bridge. Convolutions pad as flax's "SAME" does (a stride-2
convolution of an even side pads 0 before and 1 after). The attention is
single-head over all voxels, plain torch ops.

No upstream converter exists for this model on either side, so the keys
follow the JAX module's names (`conv_in`, `down_res.{i}`, `downs.{i}`,
`mid_attn`, `to_latent`, `from_latent`, `up_res.{i}`, `ups.{i}`,
`out_norm`, `conv_out`; `conv1`, `conv2`, `shortcut`, `q`, `k`, `v`,
`proj_out`), its auto-named GroupNorms as `norm1`, `norm2` and `norm`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import GroupNorm32, lecun_normal_


class SameConv3d(nn.Conv3d):
    """Conv3d with flax's "SAME" padding for its stride: out = ceil(in / s),
    the odd pixel of padding after."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in zip(reversed(x.shape[2:]), reversed(self.kernel_size),
                           reversed(self.stride)):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return F.conv3d(F.pad(x, pads), self.weight, self.bias, self.stride)


class ResnetBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = SameConv3d(in_channels, out_channels, 3)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = SameConv3d(out_channels, out_channels, 3)
        if in_channels != out_channels:
            self.shortcut = nn.Conv3d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.shortcut(x) if hasattr(self, "shortcut") else x) + h


class AttnBlock3D(nn.Module):
    """Single-head self-attention over all D·H·W voxels, with a residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        h = self.norm(x).reshape(B, C, -1).transpose(1, 2)  # (B, DHW, C)
        q, k, v = self.q(h), self.k(h), self.v(h)
        w = torch.softmax(torch.einsum("btc,bsc->bts", q, k) * C**-0.5, dim=-1)
        out = self.proj_out(torch.einsum("bts,bsc->btc", w, v))
        return x + out.transpose(1, 2).reshape(x.shape)


class Downsample3D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = SameConv3d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample3D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = SameConv3d(channels, channels, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class GridAutoencoder(nn.Module):
    """UNet3D-style grid AE: (B, 1, N, N, N) → latent (B, latent_channels,
    N / 2^(levels − 1), ...) → (B, 1, N, N, N)."""

    def __init__(self, base_channels: int = 32, channel_mult: Sequence[int] = (1, 2, 4),
                 latent_channels: int = 8):
        super().__init__()
        bc, cm = base_channels, list(channel_mult)
        self.conv_in = SameConv3d(1, bc, 3)
        chans = [bc] + [bc * m for m in cm]
        self.down_res = nn.ModuleList(ResnetBlock3D(a, b) for a, b in zip(chans, chans[1:]))
        self.downs = nn.ModuleList(Downsample3D(bc * m) for m in cm[:-1])
        top = bc * cm[-1]
        self.mid_attn = AttnBlock3D(top)
        self.to_latent = nn.Conv3d(top, latent_channels, 1)
        up = [bc * m for m in cm[::-1]]
        self.from_latent = SameConv3d(latent_channels, up[0], 3)
        self.up_res = nn.ModuleList(ResnetBlock3D(a, b) for a, b in zip(up[:1] + up, up))
        self.ups = nn.ModuleList(Upsample3D(c) for c in up[:-1])
        self.out_norm = GroupNorm32(up[-1])
        self.conv_out = SameConv3d(up[-1], 1, 3)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i, res in enumerate(self.down_res):
            h = res(h)
            if i < len(self.downs):
                h = self.downs[i](h)
        return self.to_latent(self.mid_attn(h))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.from_latent(z)
        for i, res in enumerate(self.up_res):
            h = res(h)
            if i < len(self.ups):
                h = self.ups[i](h)
        return self.conv_out(F.silu(self.out_norm(h)))

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "GridAutoencoder":
        """Seeded LeCun-normal weights (`layers.lecun_normal_`)."""
        return lecun_normal_(self, generator)
