"""1-D UNet denoiser (guided-diffusion lineage), PyTorch counterpart of
surfd_tpu/models/unet1d.py. The Surf-D configuration is the default:
scale-shift norm off, resampling by convolution, self-attention (K2) at
downsample rates {1, 2, 4}, a context added to the time embedding. The JAX
package's other settings are here too: `use_scale_shift_norm`,
`conv_resample=False` (average pooling and a bare nearest upsample) and
`use_spatial_transformer` (cross-attention over the context in
`SpatialTransformer1D` blocks at the attention sites, in place of K2),
`use_remat` (each residual block recomputed in the backward pass) and
`dtype` (the input rounded to it; the network runs in float32).

Every convolution is `Conv1d` below: with grad off on a CUDA float32 input
it runs the hand-written kernel `ops.conv1d_kernel.conv1d`, with grad on
cuDNN, on the CPU the plain `F.conv1d`.

Internally channel-first `(B, C, L)`, PyTorch's and the upstream Conv1d
layout. Module names follow upstream (`time_embed`, `input_blocks`,
`middle_block`, `output_blocks`, `out`, `label_emb`, `sketch_emb`), so an
upstream `Unet.*` state dict loads with strict=True.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..ops.attention_kernel import qkv_attention
from ..ops.conv1d_kernel import conv1d, conv1d_ref
from .attention import SpatialTransformer1D
from .layers import GroupNorm32, lecun_normal_, timestep_embedding


class Conv1d(nn.Conv1d):
    """`nn.Conv1d` (dilation 1, one group, zero padding) with the same
    parameters and state-dict keys, whose forward routes by what it
    observes: a CPU input takes the plain version `conv1d_ref` (`F.conv1d`,
    the call nn.Conv1d makes); a CUDA input with grad off (sampling, a CUDA
    graph's capture) the weight-streaming kernel `conv1d`, which raises on a
    dtype or layout it does not take; a CUDA input with grad on (training,
    a guidance gradient) cuDNN through nn.Conv1d, since the kernel has no
    backward. `residual` (the block's skip path) is added to the output:
    in the kernel's epilogue, else after the convolution; the same f32 sum
    either way."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not x.is_cuda:
            return conv1d_ref(x, self.weight, self.bias, self.stride[0], self.padding[0], residual)
        if torch.is_grad_enabled():
            out = super().forward(x)
            return out if residual is None else out + residual
        return conv1d(x, self.weight, self.bias, self.stride[0], self.padding[0], residual)


class SeededDropout(nn.Module):
    """Dropout drawing its mask from `self.generator` (a torch.Generator on
    the input's device, set by the trainer; None draws from the global one).
    Active in train() mode, the identity in eval() mode or at p 0. Keeps
    with probability 1 − p and scales kept values by 1 / (1 − p), as Flax's
    `nn.Dropout` does; the bits differ from JAX's. A caller may draw the
    mask first (`draw`) and hand it to forward, as a recomputed block does."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def draw(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The keep mask forward draws for x, or None when it is inactive."""
        if not self.training or self.p == 0.0:
            return None
        return torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if keep is None:
            keep = self.draw(x)
        return x if keep is None else x * keep / (1.0 - self.p)


class ResBlock1D(nn.Module):
    """Residual block with timestep-embedding injection; `dropout` sits
    between the second SiLU and the last convolution. The embedding is
    added before the second norm, or with `use_scale_shift_norm` it scales
    and shifts that norm's output (h·(1 + scale) + shift).

    use_remat: while grad is enabled, the block runs under
    `torch.utils.checkpoint` and is recomputed in the backward pass (JAX's
    `nn.remat`). Its dropout mask is drawn before the checkpoint and handed
    in, so that the recomputation applies the same mask and draws nothing:
    a checkpoint restores only the global generators, not the dropout's."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int, dropout: float = 0.0,
                 use_scale_shift_norm: bool = False, use_remat: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.use_remat = use_remat
        self.out_channels = out_channels
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(), Conv1d(channels, out_channels, 3, padding=1)
        )
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, (2 if use_scale_shift_norm else 1) * out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), SeededDropout(dropout),
            Conv1d(out_channels, out_channels, 3, padding=1),
        )
        self.skip_connection = (
            nn.Identity() if channels == out_channels
            else Conv1d(channels, out_channels, 1)
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if self.use_remat and torch.is_grad_enabled():
            # the mask's shape is the second activation's, (B, out, L)
            keep = self.out_layers[2].draw(
                x.new_empty((x.shape[0], self.out_channels) + tuple(x.shape[2:])))
            # nothing inside draws from a generator, so none is saved
            return checkpoint(self._forward, x, emb, keep, use_reentrant=False,
                              preserve_rng_state=False)
        return self._forward(x, emb)

    def _forward(self, x: torch.Tensor, emb: torch.Tensor,
                 keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.in_layers(x)
        e = self.emb_layers(emb)[:, :, None]
        norm, act, drop, conv = self.out_layers
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = norm(h) * (1 + scale) + shift
        else:
            h = norm(h + e)
        return conv(drop(act(h), keep), residual=self.skip_connection(x))


class AttentionBlock1D(nn.Module):
    """Self-attention over the length axis; the attention itself is kernel K2."""

    def __init__(self, channels: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = Conv1d(channels, 3 * channels, 1)
        self.proj_out = Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # K2 reads the convolution's (B, 3·H·c, T) output as a (B, T, 3·H·c)
        # view and writes a (B, H·c, T) tensor for proj_out: no copy either side
        h = qkv_attention(self.qkv(self.norm(x)).transpose(1, 2), self.num_heads).transpose(1, 2)
        return self.proj_out(h, residual=x)


class Downsample1D(nn.Module):
    """Stride-2 convolution (padding 1 each side, as torch's), or average
    pooling over pairs without `use_conv`."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        self.op = (Conv1d(channels, channels, 3, stride=2, padding=1) if use_conv
                   else nn.AvgPool1d(2, 2))

    def forward(self, x):
        return self.op(x)


class Upsample1D(nn.Module):
    """Nearest upsampling by 2, then a convolution with `use_conv`."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        if use_conv:
            self.conv = Conv1d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if hasattr(self, "conv") else x


class TimestepSequential(nn.Sequential):
    """Sequential that hands the embedding to the residual blocks and the
    context to the spatial transformers (which take tokens, (B, L, C))."""

    def forward(self, x, emb, context=None):
        for layer in self:
            if isinstance(layer, ResBlock1D):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer1D):
                x = layer(x.transpose(1, 2), context).transpose(1, 2)
            else:
                x = layer(x)
        return x


class UNet1D(nn.Module):
    """The full 1-D UNet; `forward` takes and returns `(B, C, L)`.

    The context (B, context_dim) is added to the time embedding through
    `sketch_emb`; with `use_spatial_transformer` it is instead the
    cross-attention context, (B, S, context_dim) or (B, context_dim) lifted
    to S = 1, of `transformer_depth`-deep SpatialTransformer1D blocks at the
    attention sites (there, `context_dim` is required).

    use_remat: each ResBlock1D is recomputed in the backward pass (the
    attention blocks are not). dtype: the input is rounded to it before the
    first convolution, which takes it back to float32, the weights' type;
    as in the JAX package, where flax promotes the rounded input to the f32
    params, the rest of the network runs in float32.
    """

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
        use_scale_shift_norm: bool = False,
        conv_resample: bool = True,
        use_spatial_transformer: bool = False,
        transformer_depth: int = 1,
        use_remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        mc = model_channels
        ted = 4 * mc
        self.model_channels = mc
        self.dtype = dtype
        self.num_classes = num_classes
        self.use_spatial_transformer = use_spatial_transformer
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)
        if use_spatial_transformer and context_dim is None:
            raise ValueError("use_spatial_transformer needs context_dim")
        if context_dim is not None and not use_spatial_transformer:
            self.sketch_emb = nn.Linear(context_dim, ted)

        def res(cin, cout):
            return ResBlock1D(cin, ted, cout, dropout, use_scale_shift_norm, use_remat)

        def attn(c):
            if use_spatial_transformer:
                return SpatialTransformer1D(c, num_heads, transformer_depth, context_dim)
            return AttentionBlock1D(c, num_heads)

        ch = mc
        chans = [mc]
        ds = 1
        self.input_blocks = nn.ModuleList(
            [TimestepSequential(Conv1d(in_channels, mc, 3, padding=1))]
        )
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(TimestepSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepSequential(Downsample1D(ch, conv_resample)))
                chans.append(ch)
                ds *= 2
        self.middle_block = TimestepSequential(res(ch, ch), attn(ch), res(ch, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample1D(ch, conv_resample))
                    ds //= 2
                self.output_blocks.append(TimestepSequential(*layers))
        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(), Conv1d(mc, out_channels, 3, padding=1)
        )
        self.eval()

    def forward(self, x, timesteps, context=None, y=None):
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("pass y iff the model is class-conditional")
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        if y is not None:
            emb = emb + self.label_emb(y)
        ctx = None
        if context is not None:
            if self.use_spatial_transformer:
                ctx = context if context.dim() == 3 else context[:, None, :]
            else:
                emb = emb + self.sketch_emb(context)
        h = x.to(self.dtype).to(torch.float32)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, ctx)
            hs.append(h)
        h = self.middle_block(h, emb, ctx)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, ctx)
        return self.out(h)

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "UNet1D":
        """Seeded LeCun-normal weights (every conv and linear, zero-init ones
        included, so the random model's output is not identically zero),
        zero biases, unit norms, N(0, 1) label embeddings."""
        return lecun_normal_(self, generator)

    @torch.no_grad()
    def training_init_(self, generator: torch.Generator, null_class: Optional[int] = None
                       ) -> "UNet1D":
        """The JAX package's initialisation for training from scratch:
        random_init_'s LeCun-normal weights (Flax draws them truncated), then
        the reference's zero-initialised convolutions (`zero_module`: each
        res block's last conv, each attention block's and spatial transformer's
        proj_out, the output
        conv) and the CFG null class's label row at zero."""
        self.random_init_(generator)
        zeroed = [b.out_layers[-1] for b in self.modules() if isinstance(b, ResBlock1D)]
        zeroed += [b.proj_out for b in self.modules()
                   if isinstance(b, (AttentionBlock1D, SpatialTransformer1D))]
        for m in zeroed + [self.out[-1]]:
            m.weight.zero_()
            m.bias.zero_()
        if null_class is not None:
            self.label_emb.weight[null_class].zero_()
        return self
