"""Reconstruction and generation quality metrics (counterpart of
surfd_tpu/geometry/metrics.py, the same definitions in numpy): Chamfer-L2,
Hausdorff and F-score between point sets, exact point-to-mesh distances
through the native BVH, surface-to-surface metrics between two meshes and
1-NN accuracy between two sets of clouds."""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def _nn_dists(x: np.ndarray, y: np.ndarray, chunk: int) -> np.ndarray:
    """Euclidean distance from each point of x to its nearest point of y:
    a KD-tree above 10^6 pairs, else brute force in chunks of x."""
    if len(x) * len(y) > 1_000_000:
        d, _ = cKDTree(y).query(x, k=1)
        return np.asarray(d, np.float64)
    mins = []
    for i in range(0, len(x), chunk):
        d = ((x[i:i + chunk, None, :] - y[None, :, :]) ** 2).sum(-1)
        mins.append(np.sqrt(d.min(axis=1)))
    return np.concatenate(mins) if mins else np.zeros((0,))


def chamfer_distance(a: np.ndarray, b: np.ndarray, chunk: int = 4096) -> float:
    """Symmetric Chamfer-L2: mean squared nearest-neighbour distance, both ways."""
    da = _nn_dists(a, b, chunk)
    db = _nn_dists(b, a, chunk)
    return float((da**2).mean() + (db**2).mean())


def hausdorff_distance(a: np.ndarray, b: np.ndarray, chunk: int = 4096) -> float:
    """Symmetric Hausdorff distance (max of the directed NN distances)."""
    return float(max(_nn_dists(a, b, chunk).max(), _nn_dists(b, a, chunk).max()))


def f_score(a: np.ndarray, b: np.ndarray, threshold: float = 0.01, chunk: int = 4096) -> float:
    """F-score at a distance threshold (precision and recall of the samples)."""
    precision = float((_nn_dists(a, b, chunk) < threshold).mean()) if len(a) else 0.0
    recall = float((_nn_dists(b, a, chunk) < threshold).mean()) if len(b) else 0.0
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def point_mesh_distances(points: np.ndarray, mesh) -> np.ndarray:
    """Exact distance from each point to a triangle mesh's surface (the
    native closest-point BVH): no sampling noise on the mesh side."""
    from .. import native

    d, _, _ = native.closest_points(mesh.vertices, mesh.faces, points)
    return np.asarray(d, np.float64)


def mesh_surface_metrics(recon_mesh, gt_mesh, n: int = 16384, threshold: float = 0.01,
                         rng: "np.random.Generator | None" = None) -> dict:
    """Symmetric surface-to-surface metrics between two meshes: n
    area-weighted samples on each, exact distances to the other mesh.
    Chamfer-L2 (mean squared, summed both ways), Hausdorff, F-score at
    `threshold`, precision and recall."""
    from ..data.preprocess import sample_points_on_mesh

    rng = rng or np.random.default_rng(0)
    pa = sample_points_on_mesh(recon_mesh, n, rng)
    pb = sample_points_on_mesh(gt_mesh, n, rng)
    da = point_mesh_distances(pa, gt_mesh)  # recon → gt surface
    db = point_mesh_distances(pb, recon_mesh)  # gt → recon surface
    precision = float((da < threshold).mean())
    recall = float((db < threshold).mean())
    f = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {
        "chamfer": float((da**2).mean() + (db**2).mean()),
        "hausdorff": float(max(da.max(), db.max())),
        f"f_score@{threshold:g}": f,
        "precision": precision,
        "recall": recall,
    }


def one_nn_accuracy(sample_sets: "list[np.ndarray]", reference_sets: "list[np.ndarray]",
                    chunk: int = 4096) -> float:
    """Leave-one-out 1-NN two-sample accuracy over the pooled clouds under
    Chamfer distance: 0.5 when the two sets are indistinguishable, 1.0 when
    separable. Pass sets of equal size: unequal sizes move the null away
    from 0.5."""
    pools = list(sample_sets) + list(reference_sets)
    labels = np.array([0] * len(sample_sets) + [1] * len(reference_sets))
    n = len(pools)
    if n < 2:
        raise ValueError("1-NNA needs at least one point cloud per set")
    dist = np.full((n, n), np.inf)
    for i in range(n):
        for j in range(i + 1, n):
            dist[i, j] = dist[j, i] = chamfer_distance(pools[i], pools[j], chunk)
    nn = dist.argmin(axis=1)
    return float((labels[nn] == labels).mean())
