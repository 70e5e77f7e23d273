"""Symmetric Chamfer-L2 between two point sets: the mean squared
nearest-neighbour distance from each set to the other, summed (the metric of
the sheet fixture's own bar), by exhaustive search in blocks."""

from __future__ import annotations

import torch


def nn_sq_dists(a: torch.Tensor, b: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """(len(a),) squared distance from each point of a to its nearest in b,
    in float64 differences (no |a|² + |b|² − 2ab cancellation)."""
    out = []
    for s in range(0, len(a), block):
        d = (a[s:s + block, None, :].double() - b[None].double()).square().sum(-1)
        out.append(d.min(dim=1).values)
    return torch.cat(out)


def chamfer(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(nn_sq_dists(a, b, 256).mean() + nn_sq_dists(b, a, 256).mean())
