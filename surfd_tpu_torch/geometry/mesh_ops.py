"""Mesh cleanup on the host, in numpy (counterpart of
surfd_tpu/geometry/mesh_ops.py).

The generation path runs the fused native cleanup (`native.finalize_mesh*`);
this module is its oracle and the chain `get_mesh_from_udf` runs with
`filter_faces=False`: vertex merging, degenerate and duplicate face removal,
open-border detection and smoothing, 3-edge hole filling, the
repeat-until-stable loop, plus unreferenced-vertex removal, uniform
Laplacian smoothing, connected components and area-weighted vertex normals.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .marching import Mesh


def merge_duplicate_vertices(mesh: Mesh, decimals: int = 6) -> Mesh:
    """Merge vertices equal after rounding to `decimals`; drop collapsed faces.

    Coordinates pack into one int64 key (21 bits per axis), which needs
    |coord| < 2^20 · 10^-decimals (±1.05 at the default).
    """
    if len(mesh.vertices) == 0:
        return mesh
    scale = 10.0**decimals
    q = np.round(mesh.vertices.astype(np.float64) * scale).astype(np.int64) + (1 << 20)
    if q.min() < 0 or q.max() >= (1 << 21):
        raise ValueError("vertices out of the packable range")
    key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
    uniq, inv = _unique_i64(key)
    # first occurrence of each unique key
    first = np.zeros(len(uniq), np.int64)
    first[inv[::-1]] = np.arange(len(key) - 1, -1, -1)
    return remove_degenerate_faces(Mesh(mesh.vertices[first], inv[mesh.faces]))


def remove_degenerate_faces(mesh: Mesh, area_eps: float = 0.0) -> Mesh:
    """Drop faces with repeated indices or (with area_eps > 0) ~zero area."""
    f = mesh.faces
    if len(f) == 0:
        return mesh
    keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    if area_eps > 0:
        v = mesh.vertices
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        keep &= 0.5 * np.linalg.norm(n, axis=1) > area_eps
    return Mesh(mesh.vertices, f[keep])


def remove_duplicate_faces(mesh: Mesh) -> Mesh:
    """Drop repeated faces regardless of winding or rotation (the first stays)."""
    if len(mesh.faces) == 0:
        return mesh
    s = np.sort(mesh.faces, axis=1)
    NV = len(mesh.vertices) + 1
    uniq, inv = _unique_i64((s[:, 0] * NV + s[:, 1]) * NV + s[:, 2])
    idx = np.zeros(len(uniq), np.int64)
    idx[inv[::-1]] = np.arange(len(inv) - 1, -1, -1)
    return Mesh(mesh.vertices, mesh.faces[np.sort(idx)])


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


def _uniform_laplacian_step(verts, faces, lam):
    """One step v ← v + λ·(mean(neighbours) − v)."""
    f = faces
    e = np.concatenate(
        [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]], f[:, [1, 0]], f[:, [2, 1]], f[:, [0, 2]]],
        axis=0,
    )
    return verts + lam * (_neighbor_mean(verts, e) - verts)


def laplacian_smooth(mesh: Mesh, iterations: int = 3, lam: float = 0.5) -> Mesh:
    """Uniform Laplacian smoothing: v ← v + λ·(mean(neighbours) − v)."""
    v = mesh.vertices.astype(np.float64)
    for _ in range(iterations):
        v = _uniform_laplacian_step(v, mesh.faces, lam)
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


def _edges_of(faces: np.ndarray) -> np.ndarray:
    """The 3F face edges, each as (min, max)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    return np.sort(e, axis=1)


def _unique_i64(keys: np.ndarray):
    """Sorted unique + inverse; the native radix sort above 100,000 keys."""
    if len(keys) > 100_000:
        return native.unique_inverse_i64(keys)
    uniq, inv = np.unique(keys, return_inverse=True)
    return uniq, inv.ravel()


def _unique_edges_with_counts(faces: np.ndarray, num_vertices: int):
    """(unique undirected edges (E, 2) ascending, faces per edge (E,))."""
    a = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    b = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    NV = num_vertices + 1
    uniq, inv = _unique_i64(np.minimum(a, b) * NV + np.maximum(a, b))
    counts = np.bincount(inv, minlength=len(uniq))
    return np.stack([uniq // NV, uniq % NV], axis=1), counts


def boundary_vertices(mesh: Mesh) -> np.ndarray:
    """Vertex ids on open borders (edges of exactly one face)."""
    if len(mesh.faces) == 0:
        return np.zeros(0, np.int64)
    edges, counts = _unique_edges_with_counts(mesh.faces, len(mesh.vertices))
    return np.unique(edges[counts == 1])


def smooth_borders(mesh: Mesh, iterations: int = 20, lam: float = 0.3) -> Mesh:
    """Laplacian smoothing of the open-border vertices, each pulled toward
    its border neighbours (the reference's λ 0.3, 20 iterations). Works on
    compact border-only arrays."""
    if len(mesh.faces) == 0:
        return mesh
    edges, counts = _unique_edges_with_counts(mesh.faces, len(mesh.vertices))
    be = edges[counts == 1]
    border = np.unique(be)
    if len(border) == 0:
        return mesh
    remap = np.full(len(mesh.vertices), -1, np.int64)
    remap[border] = np.arange(len(border))
    ce = remap[be]
    both = np.concatenate([ce, ce[:, ::-1]], axis=0)
    bv = mesh.vertices[border].astype(np.float64)
    nb = len(border)
    cnt = np.bincount(both[:, 0], minlength=nb).astype(np.float64)
    has = cnt > 0
    denom = np.maximum(cnt, 1)[:, None]
    for _ in range(iterations):
        acc = np.stack(
            [np.bincount(both[:, 0], weights=bv[both[:, 1], k], minlength=nb) for k in range(3)],
            axis=1,
        )
        bv = bv + lam * (np.where(has[:, None], acc / denom, bv) - bv)
    v = mesh.vertices.copy()
    v[border] = bv.astype(np.float32)
    return Mesh(v, mesh.faces)


def fill_triangle_holes(mesh: Mesh) -> Mesh:
    """Close every 3-edge boundary loop with one triangle.

    A detached triangle has all three edges on the border; it is not a hole
    (filling it would duplicate it), so loops whose three edges belong to
    one face are skipped.
    """
    if len(mesh.faces) == 0:
        return mesh
    NV = len(mesh.vertices)
    a_ = np.concatenate([mesh.faces[:, 0], mesh.faces[:, 1], mesh.faces[:, 2]])
    b_ = np.concatenate([mesh.faces[:, 1], mesh.faces[:, 2], mesh.faces[:, 0]])
    uniq, inv = _unique_i64(np.minimum(a_, b_) * (NV + 1) + np.maximum(a_, b_))
    counts = np.bincount(inv, minlength=len(uniq))
    edges = np.stack([uniq // (NV + 1), uniq % (NV + 1)], axis=1)
    # owner face per edge (exact for the one-face edges)
    owner = np.zeros(len(uniq), np.int64)
    owner[inv] = np.tile(np.arange(len(mesh.faces)), 3)
    border1 = counts == 1
    be = edges[border1]
    be_owner = owner[border1]
    if len(be) == 0:
        return mesh
    # candidates: border paths a < b < c whose closing edge (a, c) is also a
    # border edge; be ascends by (lo, hi), so groups by lo index it directly
    starts = np.searchsorted(be[:, 0], np.arange(NV))
    ends = np.searchsorted(be[:, 0], np.arange(NV) + 1)
    n_cont = ends[be[:, 1]] - starts[be[:, 1]]
    if n_cont.max(initial=0) == 0:
        return mesh
    rep = np.repeat(np.arange(len(be)), n_cont)
    cum = np.cumsum(n_cont) - n_cont
    offs = np.arange(int(n_cont.sum())) - np.repeat(cum, n_cont)
    cont_idx = starts[be[rep, 1]] + offs
    a, b, c = be[rep, 0], be[rep, 1], be[cont_idx, 1]
    key_be = be[:, 0] * (NV + 1) + be[:, 1]
    close = a * (NV + 1) + c
    pos = np.clip(np.searchsorted(key_be, close), 0, len(key_be) - 1)
    ok = key_be[pos] == close
    ok &= ~((be_owner[rep] == be_owner[cont_idx]) & (be_owner[rep] == be_owner[pos]))
    if not ok.any():
        return mesh
    new_faces = np.stack([a[ok], b[ok], c[ok]], axis=1)
    return Mesh(mesh.vertices, np.concatenate([mesh.faces, new_faces], axis=0))


def stabilize(mesh: Mesh, max_rounds: int = 3, assume_clean: bool = False) -> Mesh:
    """Repeat vertex merge, duplicate-face removal and hole filling until
    the counts stop changing (at most `max_rounds`).

    assume_clean: the input has no duplicate vertices or faces (marching
    output, keyed by unique grid edges): fill holes first and run the loop
    only if that added faces.
    """
    prev = (-1, -1)
    if assume_clean:
        n0 = len(mesh.faces)
        mesh = fill_triangle_holes(mesh)
        if len(mesh.faces) == n0:
            return mesh
        max_rounds -= 1
    for _ in range(max_rounds):
        n0 = (len(mesh.vertices), len(mesh.faces))
        mesh = fill_triangle_holes(remove_duplicate_faces(merge_duplicate_vertices(mesh)))
        now = (len(mesh.vertices), len(mesh.faces))
        if now == n0 or now == prev:
            break
        prev = n0
    return mesh


def vertex_normals(mesh: Mesh) -> np.ndarray:
    """Area-weighted unit vertex normals, float32."""
    v, f = mesh.vertices.astype(np.float64), mesh.faces
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for i in range(3):
        np.add.at(vn, f[:, i], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)
