"""LDM-style transformer blocks, the cross-attention conditioning path
(counterpart of surfd_tpu/models/attention.py).

GEGLU, FeedForward, CrossAttention, BasicTransformerBlock,
SpatialTransformer1D and LinearAttention, each on `(B, L, C)` tokens. Off
in the shipped Surf-D configuration (context enters through the time
embedding); `UNet1D(use_spatial_transformer=True)` routes the context
through these blocks instead of its attention blocks.

Numerics are the JAX package's: q scaled by dim_head^-½ before its product
with k, the softmax in float32, LayerNorm eps 1e-6 (flax's), GELU in its
tanh form (flax's `nn.gelu`), GroupNorm32. The attention is plain torch
ops: it takes q from x and k, v from a context of another length, so it
is not K2's function. Keys follow upstream `modules/attention.py`
(`transformer_blocks.{i}.attn1.to_q`, `ff.net.0.proj`, `norm1`..`norm3`,
`proj_in`, `proj_out`); every projection is a Linear, shaped as the JAX
package's Dense (`utils.convert` bridges them).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import GroupNorm32

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class GEGLU(nn.Module):
    """x·W1 ⊙ gelu(x·W2), one projection split in two halves."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * _gelu(gate)


class _LinearGelu(nn.Sequential):
    """Linear then GELU: FeedForward's input without the gate."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__(nn.Linear(dim_in, dim_out))

    def forward(self, x):
        return _gelu(super().forward(x))


class FeedForward(nn.Module):
    """The transformer MLP, `mult`× wide, with an optional GEGLU gate;
    `net` = (input projection, dropout slot, output Linear) as upstream."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = True):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(GEGLU(dim, inner) if glu else _LinearGelu(dim, inner),
                                 nn.Identity(), nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class CrossAttention(nn.Module):
    """Multi-head attention of x over `context` (B, S, context_dim);
    context=None attends over x itself, and then `context_dim` must be
    None (the key and value projections read x)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        kv_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Identity())

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        B, T, _ = x.shape
        S = ctx.shape[1]
        q = self.to_q(x).reshape(B, T, self.heads, self.dim_head)
        k = self.to_k(ctx).reshape(B, S, self.heads, self.dim_head)
        v = self.to_v(ctx).reshape(B, S, self.heads, self.dim_head)
        logits = torch.einsum("bthc,bshc->bhts", q * self.dim_head**-0.5, k)
        w = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        out = torch.einsum("bhts,bshc->bthc", w, v).reshape(B, T, self.heads * self.dim_head)
        return self.to_out(out)


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention over the context, feed-forward; each
    pre-LayerNorm with a residual."""

    def __init__(self, dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer1D(nn.Module):
    """GroupNorm → Linear in → `depth` transformer blocks → Linear out (zero
    in training_init_), plus the residual, over the length axis."""

    def __init__(self, channels: int, heads: int = 8, depth: int = 1,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, context_dim, heads, channels // heads)
            for _ in range(depth))
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.proj_in(self.norm(x.transpose(1, 2)).transpose(1, 2))
        for block in self.transformer_blocks:
            h = block(h, context)
        return x + self.proj_out(h)


class LinearAttention(nn.Module):
    """Softmax-free linear attention: keys softmaxed over the length, a
    (dim_head × dim_head) context per head, read by the queries. The fused
    projection splits heads before q, k, v, as the JAX package's does."""

    def __init__(self, channels: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Linear(channels, 3 * inner, bias=False)
        self.to_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        qkv = self.to_qkv(x).reshape(B, L, self.heads, 3 * self.dim_head)
        q, k, v = qkv.chunk(3, dim=-1)
        k = torch.softmax(k, dim=1)
        ctx = torch.einsum("blhd,blhe->bhde", k, v)
        out = torch.einsum("bhde,blhd->blhe", ctx, q).reshape(B, L, self.heads * self.dim_head)
        return self.to_out(out)
