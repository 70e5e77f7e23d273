"""Mesh post-processing on the host (counterpart of the parts of
surfd_tpu/geometry/mesh_ops.py that the generation path runs after the
native cleanup and on the watertight path): unreferenced-vertex removal,
uniform Laplacian smoothing, small-component removal and keeping the largest
component."""

from __future__ import annotations

import numpy as np

from .marching import Mesh


def remove_unreferenced_vertices(mesh: Mesh) -> Mesh:
    if len(mesh.faces) == 0:
        return Mesh(np.zeros((0, 3), np.float32), mesh.faces)
    used = np.unique(mesh.faces)
    remap = -np.ones(len(mesh.vertices), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return Mesh(mesh.vertices[used], remap[mesh.faces])


def _neighbor_mean(verts: np.ndarray, e: np.ndarray):
    """Mean neighbour position per vertex over directed edges e (E, 2)."""
    n = len(verts)
    cnt = np.bincount(e[:, 0], minlength=n).astype(np.float64)
    acc = np.stack(
        [np.bincount(e[:, 0], weights=verts[e[:, 1], k], minlength=n) for k in range(3)],
        axis=1,
    )
    has = cnt > 0
    return np.where(has[:, None], acc / np.maximum(cnt, 1)[:, None], verts)


def laplacian_smooth(mesh: Mesh, iterations: int = 3, lam: float = 0.5) -> Mesh:
    """Uniform Laplacian smoothing: v ← v + λ·(mean(neighbours) − v)."""
    f = mesh.faces
    e = np.concatenate(
        [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]], f[:, [1, 0]], f[:, [2, 1]], f[:, [0, 2]]],
        axis=0,
    )
    v = mesh.vertices.astype(np.float64)
    for _ in range(iterations):
        v = v + lam * (_neighbor_mean(v, e) - v)
    return Mesh(v.astype(np.float32), mesh.faces)


def face_components(faces: np.ndarray, num_vertices: int) -> np.ndarray:
    """Connected-component label per face (graph over shared vertices)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    if len(faces) == 0:
        return np.zeros(0, np.int64)
    rows = np.concatenate([faces[:, 0], faces[:, 1]])
    cols = np.concatenate([faces[:, 1], faces[:, 2]])
    g = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                   shape=(num_vertices, num_vertices))
    _, vlabels = connected_components(g, directed=False)
    _, labels = np.unique(vlabels[faces[:, 0]], return_inverse=True)
    return labels.ravel()


def filter_small_components(mesh: Mesh, min_faces: int) -> Mesh:
    """Drop connected components with fewer than `min_faces` faces."""
    if len(mesh.faces) == 0:
        return mesh
    labels = face_components(mesh.faces, len(mesh.vertices))
    keep = np.bincount(labels)[labels] >= min_faces
    return remove_unreferenced_vertices(Mesh(mesh.vertices, mesh.faces[keep]))


def keep_largest_component(mesh: Mesh, by_bbox: bool = False) -> Mesh:
    """Keep one connected component: the one with the most faces, or with
    `by_bbox` the one with the longest bounding-box diagonal (the first on
    a tie). The boxes come from one sort of the vertices by component, so
    the cost does not grow with the number of components."""
    if len(mesh.faces) == 0:
        return mesh
    labels = face_components(mesh.faces, len(mesh.vertices))
    if by_bbox:
        vlab = np.zeros(len(mesh.vertices), np.int64)
        vlab[mesh.faces] = labels[:, None]  # a vertex's faces share its component
        used = np.unique(mesh.faces)
        order = used[np.argsort(vlab[used], kind="stable")]
        starts = np.searchsorted(vlab[order], np.arange(labels.max() + 1))
        vs = mesh.vertices[order]
        lo, hi = np.minimum.reduceat(vs, starts), np.maximum.reduceat(vs, starts)
        best = int(np.argmax([float(np.linalg.norm(h - l)) for l, h in zip(lo, hi)]))
    else:
        best = int(np.bincount(labels).argmax())
    return remove_unreferenced_vertices(Mesh(mesh.vertices, mesh.faces[labels == best]))
