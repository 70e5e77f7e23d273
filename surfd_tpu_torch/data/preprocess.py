"""Surface sampling of meshes (counterpart of surfd_tpu/data/preprocess.py;
so far only what the reconstruction eval needs)."""

from __future__ import annotations

import numpy as np


def sample_points_on_mesh(mesh, n: int, rng: np.random.Generator) -> np.ndarray:
    """n area-weighted uniform samples on a triangle mesh, (n, 3) float32."""
    v, f = mesh.vertices.astype(np.float64), mesh.faces
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    tri = rng.choice(len(f), size=n, p=areas / total)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    a, b, c = v[f[tri, 0]], v[f[tri, 1]], v[f[tri, 2]]
    pts = (1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c
    return pts.astype(np.float32)
