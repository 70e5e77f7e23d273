"""Classifier half-UNet (`EncoderUNetModel`) and classifier guidance
(counterpart of surfd_tpu/models/encoder_unet.py).

The UNet's encoder trunk and middle block with a pooled classification
head: the model that guided-diffusion's classifier guidance differentiates
with respect to x_t to steer sampling toward a class
(`make_classifier_cond_fn`, plugged into the samplers' `cond_fn`).

The JAX package's fixes for dims = 1 are kept: the "adaptive" and "spatial"
heads pool by a mean over the length axis (upstream's 2-D pooling crashes on
a 1-D trunk), and the "attention" pool's positional table is sized by
ceil-halving `seq_len` once per downsample. The trunk is the port's
`ResBlock1D`, `Downsample1D` and `AttentionBlock1D`, so its attention runs
K2, and K2-bwd under `make_classifier_cond_fn`'s gradient. `AttentionPool1D`
splits q, k and v before the heads (upstream `QKVAttention`, not K2's
`QKVAttentionLegacy` layout), so it is plain torch ops.

`forward` takes `(B, L, C)` tokens, the samplers' layout, as the JAX
module does. Keys follow upstream `EncoderUNetModel` (`time_embed`,
`input_blocks`, `middle_block`, `out`), which
surfd_tpu/utils/torch_convert.py `convert_encoder_unet` reads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import GroupNorm32, lecun_normal_, timestep_embedding
from .unet1d import AttentionBlock1D, Downsample1D, ResBlock1D, TimestepSequential


class AttentionPool1D(nn.Module):
    """CLIP-style attention pooling: the mean token prepended, a learned
    positional table (C, seq_len + 1) added, one multi-head attention, the
    output at the mean token's position. Takes (B, C, L) channel-first."""

    def __init__(self, seq_len: int, embed_dim: int, num_head_channels: int, output_dim: int):
        super().__init__()
        if embed_dim % num_head_channels:
            raise ValueError(f"pool width {embed_dim} not divisible by num_head_channels "
                             f"{num_head_channels}")
        self.num_heads = embed_dim // num_head_channels
        self.positional_embedding = nn.Parameter(torch.randn(embed_dim, seq_len + 1)
                                                 / embed_dim**0.5)
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, _ = x.shape
        x = torch.cat([x.mean(dim=-1, keepdim=True), x], dim=-1)
        x = x + self.positional_embedding[None].to(x.dtype)
        q, k, v = self.qkv_proj(x).chunk(3, dim=1)  # qkv split before the heads
        T, hd = x.shape[-1], C // self.num_heads
        scale = hd**-0.25
        q = (q * scale).reshape(B * self.num_heads, hd, T)
        k = (k * scale).reshape(B * self.num_heads, hd, T)
        w = torch.softmax(torch.einsum("bct,bcs->bts", q, k).float(), dim=-1).to(x.dtype)
        a = torch.einsum("bts,bcs->bct", w, v.reshape(B * self.num_heads, hd, T))
        return self.c_proj(a.reshape(B, C, T))[:, :, 0]


class _MeanPool(nn.Module):
    """Mean over the length axis, kept as a length-1 axis."""

    def forward(self, x):
        return x.mean(dim=-1, keepdim=True)


class EncoderUNet1D(nn.Module):
    """Half UNet (encoder + middle block) with a pooled head: `adaptive`,
    `attention` (needs num_head_channels > 0 and seq_len), `spatial` or
    `spatial_v2`. (B, L, in_channels) → (B, out_channels) logits.
    `use_remat` and `dtype` as UNet1D's."""

    def __init__(
        self,
        in_channels: int = 1,
        model_channels: int = 224,
        out_channels: int = 9,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        conv_resample: bool = True,
        num_heads: int = 8,
        num_head_channels: int = -1,
        dropout: float = 0.0,
        use_scale_shift_norm: bool = False,
        pool: str = "adaptive",
        seq_len: Optional[int] = None,
        use_remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if pool not in ("adaptive", "attention", "spatial", "spatial_v2"):
            raise NotImplementedError(f"unexpected pool {pool!r}")
        mc = model_channels
        ted = 4 * mc
        self.model_channels, self.pool, self.dtype = mc, pool, dtype

        def heads_for(ch):
            # num_head_channels, when set, sizes the trunk's heads too
            return ch // num_head_channels if num_head_channels > 0 else num_heads

        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        ch = mc
        feats = [ch]
        ds = 1
        self.input_blocks = nn.ModuleList(
            [TimestepSequential(nn.Conv1d(in_channels, mc, 3, padding=1))])
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock1D(ch, ted, mult * mc, dropout, use_scale_shift_norm,
                                     use_remat)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(AttentionBlock1D(ch, heads_for(ch)))
                self.input_blocks.append(TimestepSequential(*layers))
                feats.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepSequential(Downsample1D(ch, conv_resample)))
                feats.append(ch)
                ds *= 2
        self.middle_block = TimestepSequential(
            ResBlock1D(ch, ted, ch, dropout, use_scale_shift_norm, use_remat),
            AttentionBlock1D(ch, heads_for(ch)),
            ResBlock1D(ch, ted, ch, dropout, use_scale_shift_norm, use_remat))
        feats.append(ch)

        if pool == "adaptive":
            self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), _MeanPool(),
                                     nn.Conv1d(ch, out_channels, 1), nn.Flatten())
        elif pool == "attention":
            if num_head_channels <= 0 or seq_len is None:
                raise ValueError("pool='attention' needs num_head_channels > 0 and seq_len")
            trunk_len = seq_len
            while ds > 1:  # a stride-2 convolution of padding 1 gives ceil(L / 2)
                trunk_len = (trunk_len + 1) // 2
                ds //= 2
            self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                     AttentionPool1D(trunk_len, ch, num_head_channels,
                                                     out_channels))
        elif pool == "spatial":
            self.out = nn.Sequential(nn.Linear(sum(feats), 2048), nn.ReLU(),
                                     nn.Linear(2048, out_channels))
        else:
            self.out = nn.Sequential(nn.Linear(sum(feats), 2048), GroupNorm32(2048), nn.SiLU(),
                                     nn.Linear(2048, out_channels))
        self.eval()

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        h = x.permute(0, 2, 1).to(self.dtype).to(torch.float32)
        feats = []
        for block in self.input_blocks:
            h = block(h, emb)
            feats.append(h.mean(dim=-1))
        h = self.middle_block(h, emb)
        feats.append(h.mean(dim=-1))
        if self.pool.startswith("spatial"):
            return self.out(torch.cat(feats, dim=-1))
        return self.out(h)

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "EncoderUNet1D":
        """Seeded LeCun-normal weights (`layers.lecun_normal_`; zero-init
        layers included) and the attention pool's table as N(0, 1/C)."""
        lecun_normal_(self, generator)
        for m in self.modules():
            if isinstance(m, AttentionPool1D):
                pe = m.positional_embedding
                pe.copy_(torch.randn(pe.shape, generator=generator) / pe.shape[0]**0.5)
        return self


def make_classifier_cond_fn(classifier, y: torch.Tensor, scale: float = 1.0):
    """Classifier guidance's `cond_fn`: ∇ₓ log p(y | x_t, t) · scale.

    classifier: (x, t) → (B, num_classes) logits, x in the samplers' (B, L,
    C) layout (an EncoderUNet1D). y: (B,) int target labels. The samplers
    run under `torch.no_grad()`, so the gradient is taken under
    `torch.enable_grad()` here; through the trunk's attention it runs
    K2-bwd on the card."""

    def cond_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            xi = x.detach().requires_grad_(True)
            logp = torch.log_softmax(classifier(xi, t), dim=-1)
            sel = logp.gather(-1, y.reshape(-1, 1).to(device=logp.device, dtype=torch.int64))
            (g,) = torch.autograd.grad(sel.sum(), xi)
        return g * scale

    return cond_fn
