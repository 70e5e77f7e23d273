"""DGCNN point-cloud encoder (counterpart of surfd_tpu/models/dgcnn.py, the
upstream Surf-D AutoEncoder `Dgcnn`).

kNN is exact brute force over the pairwise distance matrix, in query tiles
of `chunk` rows: one (B, chunk, N) tile of ‖q‖² − 2q·p + ‖p‖² in float32,
then `torch.topk`. Four edge-conv blocks (64, 64, 128, 256) on the same
neighbours, each a Dense on the edge features [x_j − x_i, x_i], BatchNorm,
LeakyReLU 0.2 and max over the neighbours; then a Dense to the latent,
BatchNorm, LeakyReLU and max over the points.

Parameters keep the upstream state-dict layout: `conv_1..5.weight` as
(out, in) and `bn_1..5.*` BatchNorm1d buffers. Matmuls are float32: callers
on CUDA go through `utils.device.resolve_device`, which turns TF32 off.
In train mode (`train_ae`) each BatchNorm takes flax's batch statistics
(`models.layers.batch_norm`); the kNN indices carry no gradient, the
gathered edge features do. On a CUDA float32 input in train mode with grad
enabled (`fused`) each of the four edge convolutions is one unit with a
hand-written forward and first derivative (`ops/edgeconv_train.py`), which
writes no (B, N, k, ·) tensor; the four share one reverse adjacency of the
neighbours a step. Eval mode, the CPU and grad-off calls keep the composed
path; kNN and the latent's block stay composed everywhere.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.edgeconv_train import adjacency, edgeconv_train
from .layers import batch_norm

WIDTHS = (64, 64, 128, 256)


def auto_chunk(B: int, N: int, budget: int = 4 * 1024**3) -> int:
    """Query rows per kNN distance tile: all N while the B tiles of N × N
    float32 fit `budget` bytes, else as many rows as fit (at least 256)."""
    return N if B * N * N * 4 <= budget else max(budget // (B * N * 4), 256)


def knn_indices(points: torch.Tensor, k: int, chunk: int | None = None) -> torch.Tensor:
    """(B, N, 3) → (B, N, k) int64 indices of each point's k nearest points,
    itself included, in ascending distance. Near-ties may be ordered or
    chosen differently from another implementation's top-k: both
    aggregations downstream depend only on the set."""
    B, N, _ = points.shape
    chunk = chunk or auto_chunk(B, N)
    sq = (points * points).sum(-1)  # (B, N)
    pts_t = points.transpose(1, 2)
    out = []
    for i in range(0, N, chunk):
        # (‖q‖² − 2q·p) + ‖p‖², the reference's order of operations
        d = torch.bmm(points[:, i:i + chunk], pts_t).mul_(-2.0)
        d.add_(sq[:, i:i + chunk, None]).add_(sq[:, None, :])
        out.append(torch.topk(d, k, dim=-1, largest=False).indices)
        del d
    return torch.cat(out, dim=1)


def gather_graph_feature(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Edge features [x_j − x_i, x_i]: x (B, N, D), indices (B, N, K) →
    (B, N, K, 2D)."""
    B = x.shape[0]
    neighbors = x[torch.arange(B, device=x.device)[:, None, None], indices]
    center = x[:, :, None, :].expand_as(neighbors)
    return torch.cat([neighbors - center, center], dim=-1)


def fused(training: bool, x: torch.Tensor) -> bool:
    """Whether the edge convolutions take the hand-written unit."""
    return (training and x.is_cuda and x.dtype == torch.float32
            and torch.is_grad_enabled())


class Dgcnn(nn.Module):
    """(B, N, 3) point clouds → (B, size_latent) embeddings, with the
    optional `latent_index` (B,) appended as one more channel."""

    def __init__(self, size_latent: int, k: int = 20):
        super().__init__()
        self.size_latent = size_latent
        self.k = k
        d_in = 3
        for i, width in enumerate(WIDTHS, 1):
            setattr(self, f"conv_{i}", nn.Linear(2 * d_in, width, bias=False))
            setattr(self, f"bn_{i}", nn.BatchNorm1d(width, eps=1e-5))
            d_in = width
        self.conv_5 = nn.Linear(sum(WIDTHS), size_latent, bias=False)
        self.bn_5 = nn.BatchNorm1d(size_latent, eps=1e-5)
        self.eval()

    def _bn_act(self, bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
        """BatchNorm over every axis but the last (running statistics in eval
        mode, flax's batch statistics in train mode), then LeakyReLU 0.2."""
        return F.leaky_relu(batch_norm(x, bn, self.training), 0.2, inplace=True)

    def forward(self, x: torch.Tensor, latent_index: torch.Tensor | None = None) -> torch.Tensor:
        indices = knn_indices(x, self.k)
        adj = adjacency(indices) if fused(self.training, x) else None
        feats, f = [], x
        for i in range(1, len(WIDTHS) + 1):
            conv, bn = getattr(self, f"conv_{i}"), getattr(self, f"bn_{i}")
            if adj is not None:
                f = edgeconv_train(f, adj, conv.weight, bn)
            else:
                f = self._bn_act(bn, conv(gather_graph_feature(f, indices))).amax(dim=2)
            feats.append(f)
        feat = self._bn_act(self.bn_5, self.conv_5(torch.cat(feats, dim=-1))).amax(dim=1)
        if latent_index is not None:
            feat = torch.cat([feat, latent_index[:, None].to(feat.dtype)], dim=-1)
        return feat

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "Dgcnn":
        """Seeded LeCun-normal weights, unit BatchNorm scales, zero shifts
        and running means, unit running variances."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(m.weight.shape[1]))
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
        return self
