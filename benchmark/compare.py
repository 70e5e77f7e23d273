"""The comparisons of a training cell: per-leaf norms against the
reference's, taken by the worst leaf."""

from __future__ import annotations

import statistics

import torch


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def moving_leaves(ref_grad: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient norm is at least `share` of the
    median leaf's: the others (a key's bias under softmax, say) move under
    Adam by round-off alone."""
    n = leaf_norms(ref_grad)
    med = statistics.median(n.values())
    return {k for k, v in n.items() if v >= share * med}


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """{leaf: |‖prog‖ − ‖ref‖| / max(‖ref leaf‖, ‖median ref leaf‖)}."""
    leaves = sorted(ref) if leaves is None else sorted(leaves)
    pn, rn = leaf_norms({k: prog[k] for k in leaves}), leaf_norms({k: ref[k] for k in leaves})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in leaves}


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> tuple:
    """(gap, leaf) of the worst leaf by `leaf_gaps`."""
    gaps = leaf_gaps(prog, ref, leaves)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def loss_gap(prog: list, ref: list) -> float:
    """Widest relative gap between the steps' losses."""
    if len(prog) != len(ref):
        return float("inf")
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref))
