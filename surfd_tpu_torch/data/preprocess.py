"""Mesh → UDF training sample (counterpart of surfd_tpu/data/preprocess.py):
host numpy and the native BVH (`native.closest_points`).

Per mesh, at the defaults: a 100,000-point area-weighted surface cloud;
500,000 queries, gaussian shells around cloud points at σ 0.003 / 0.01 / 0.1
(250,000 / 200,000 / 25,000) plus 25,000 uniform in [-1, 1]³, clipped to
the cube; each query's distance to the mesh clipped at max_dist and its unit
gradient (query − closest point) / distance. One `default_rng(seed)` draws
all of it in that order, as the JAX package's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .. import native
from ..geometry.marching import Mesh


def normalize_mesh(mesh: Mesh, mode: str = "box_center") -> Mesh:
    """'center' subtracts the vertex mean, 'box_center' the bounding box's
    centre, 'unit' also scales the largest |coordinate| to 1."""
    v = mesh.vertices.astype(np.float64)
    if mode == "center":
        v = v - v.mean(axis=0)
    elif mode in ("box_center", "unit"):
        v = v - (v.max(axis=0) + v.min(axis=0)) / 2
        if mode == "unit":
            v = v / np.abs(v).max()
    else:
        raise ValueError(f"unknown normalization mode {mode}")
    return Mesh(v.astype(np.float32), mesh.faces)


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


def sample_points_around_pcd(pcd: np.ndarray, stds: Sequence[float] = (0.003, 0.01, 0.1),
                             counts: Sequence[int] = (250_000, 200_000, 25_000),
                             num_uniform: int = 25_000,
                             coords_range: tuple[float, float] = (-1.0, 1.0),
                             rng: np.random.Generator | None = None) -> np.ndarray:
    """Per (std, count): `count` cloud points with normal noise of that std;
    then `num_uniform` uniform points in the box; all clipped to it, f32.
    Without `rng`, `default_rng(1024)`."""
    rng = rng or np.random.default_rng(1024)
    lo, hi = coords_range
    parts = []
    for std, count in zip(stds, counts):
        base = pcd[rng.integers(0, len(pcd), size=count)]
        parts.append(base + rng.normal(scale=std, size=(count, 3)))
    parts.append(rng.uniform(lo, hi, size=(num_uniform, 3)))
    return np.clip(np.concatenate(parts).astype(np.float32), lo, hi)


def compute_udf_from_mesh(mesh: Mesh, queries: np.ndarray, max_dist: float = 0.1):
    """(distance to the mesh clipped at max_dist, unit gradient) per query,
    ((Q,) f32, (Q, 3) f32), by the native BVH."""
    d, closest, _ = native.closest_points(mesh.vertices, mesh.faces, queries)
    grad = queries - closest
    norm = np.maximum(np.linalg.norm(grad, axis=1, keepdims=True), 1e-9)
    return np.minimum(d, max_dist).astype(np.float32), (grad / norm).astype(np.float32)


@dataclass
class PreprocessConfig:
    num_points_pcd: int = 100_000
    stds: tuple = (0.003, 0.01, 0.1)
    counts: tuple = (250_000, 200_000, 25_000)
    num_uniform: int = 25_000
    max_dist: float = 0.1
    coords_range: tuple = (-1.0, 1.0)
    seed: int = 1024


def prepare_udf_sample(mesh: Mesh, cfg: PreprocessConfig = PreprocessConfig()) -> dict:
    """One mesh → the npz payload of an item: vertices, triangles, pcd,
    coords, labels (the clipped UDF) and gradients."""
    rng = np.random.default_rng(cfg.seed)
    pcd = sample_points_on_mesh(mesh, cfg.num_points_pcd, rng)
    coords = sample_points_around_pcd(pcd, cfg.stds, cfg.counts, cfg.num_uniform,
                                      cfg.coords_range, rng)
    labels, gradients = compute_udf_from_mesh(mesh, coords, cfg.max_dist)
    return {
        "vertices": mesh.vertices.astype(np.float32),
        "triangles": mesh.faces.astype(np.int32),
        "pcd": pcd,
        "coords": coords,
        "labels": labels,
        "gradients": gradients,
    }


def preprocess_mesh_file(obj_path: str, out_path: str,
                         cfg: PreprocessConfig = PreprocessConfig()) -> dict:
    """Read an OBJ, scale it into [-1, 1]³ ('unit'), save its payload as npz."""
    from ..geometry.mesh_io import read_obj

    payload = prepare_udf_sample(normalize_mesh(read_obj(obj_path), mode="unit"), cfg)
    np.savez(out_path, **payload)
    return payload
