"""UDF decoder: NeRF positional encoding + conditional-batch-norm MLP.

PyTorch counterpart of `surfd_tpu/models/decoder.py` (the upstream Surf-D
`DecoderConditionalBatchNorm`). Parameters keep the upstream layout — every
projection is a kernel-size-1 Conv1d weight `(out, in, 1)` — so an upstream
`decoder.*` state dict loads unchanged (after dropping the `decoder.` prefix,
see `utils/convert.py`). The forward pass is channel-last `(B, N, C)`: each
projection is a plain matmul over points.

A decoder is built in eval mode: normalisation uses the running statistics.
On the main path the values come from the folded kernel
(`ops/decoder_kernel.py`); this module is the float32 reference and the
graph that torch autograd differentiates for the near-band gradients. In
train mode (`train_ae`) it normalises by the batch's statistics over all
points, as flax's BatchNorm does, and moves the running statistics
(`models.layers.batch_norm`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# NeRF positional encoding [x, sin(f0·x), cos(f0·x), sin(f1·x), ...] → 63,
# frequencies 2^0..2^9; the folded kernel's encoding is the same function.
from ..ops.decoder_kernel import posenc_f32 as coords_encode
from .layers import batch_norm


class Conv1x1(nn.Module):
    """Kernel-size-1 Conv1d parameters `(out, in, 1)`, applied channel-last."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


class ConditionalBatchNorm(nn.Module):
    """Affine-free BatchNorm with latent-conditioned γ/β: running statistics
    in eval mode, the batch's (every point of every item) in train mode."""

    def __init__(self, latent_dim: int, features: int):
        super().__init__()
        self.conv_gamma = Conv1x1(latent_dim, features)
        self.conv_beta = Conv1x1(latent_dim, features)
        self.bn = nn.BatchNorm1d(features, affine=False, eps=1e-5)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        gamma = self.conv_gamma(cond)
        beta = self.conv_beta(cond)
        if cond.dim() == x.dim() - 1:  # (B, D) latent broadcast over points
            gamma = gamma[:, None, :]
            beta = beta[:, None, :]
        return gamma * batch_norm(x, self.bn, self.training) + beta

    def fold(self, latent: torch.Tensor):
        """(a, c) with cbn(x) = a⊙x + c for one latent (D,)."""
        gamma = self.conv_gamma(latent)
        beta = self.conv_beta(latent)
        inv = gamma / torch.sqrt(self.bn.running_var + self.bn.eps)
        return inv, beta - self.bn.running_mean * inv


class ConditionalResnetBlock(nn.Module):
    """x + fc_1(relu(bn_1(fc_0(relu(bn_0(x))))))."""

    def __init__(self, latent_dim: int, features: int):
        super().__init__()
        self.bn_0 = ConditionalBatchNorm(latent_dim, features)
        self.fc_0 = Conv1x1(features, features)
        self.bn_1 = ConditionalBatchNorm(latent_dim, features)
        self.fc_1 = Conv1x1(features, features)

    def forward(self, x, cond):
        net = self.fc_0(torch.relu(self.bn_0(x, cond)))
        dx = self.fc_1(torch.relu(self.bn_1(net, cond)))
        return x + dx


class CbnDecoder(nn.Module):
    """(B, N, 63) encoded coords + (B, latent) → (B, N) UDF logit."""

    def __init__(self, latent_dim: int, hidden_dim: int = 512,
                 num_hidden_layers: int = 5, in_dim: int = 63):
        super().__init__()
        self.latent_dim = latent_dim
        self.hidden_dim = hidden_dim
        self.num_hidden_layers = num_hidden_layers
        self.fc_p = Conv1x1(in_dim, hidden_dim)
        self.blocks = nn.ModuleList(
            ConditionalResnetBlock(latent_dim, hidden_dim) for _ in range(num_hidden_layers)
        )
        self.bn = ConditionalBatchNorm(latent_dim, hidden_dim)
        self.fc_out = Conv1x1(hidden_dim, 1)
        self.eval()

    def forward(self, coords_emb: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
        net = self.fc_p(coords_emb)
        for block in self.blocks:
            net = block(net, latent)
        net = self.bn(net, latent)
        return self.fc_out(torch.relu(net))[..., 0]

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "CbnDecoder":
        """Seeded LeCun-normal weights, zero biases, unit running variance."""
        for m in self.modules():
            if isinstance(m, Conv1x1):
                fan_in = m.weight.shape[1]
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
                )
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm1d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        for cbn in [b.bn_0 for b in self.blocks] + [b.bn_1 for b in self.blocks] + [self.bn]:
            cbn.conv_gamma.bias.fill_(1.0)  # γ starts near 1, as upstream
        return self


def udf_from_logits(logits: torch.Tensor, max_dist: float = 0.1) -> torch.Tensor:
    """(1 − σ(logit)) · max_dist — the inverse of the BCE training target."""
    return (1.0 - torch.sigmoid(logits)) * max_dist
