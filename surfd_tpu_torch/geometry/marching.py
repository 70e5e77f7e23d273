"""Surface extraction by marching tetrahedra (counterpart of
surfd_tpu/geometry/marching.py): the open surface of a UDF grid on the
native C++ path (`marching_tetrahedra_udf`), and the iso-surface of a signed
grid in numpy (`marching_tetrahedra`, the watertight path).

Each cube splits into 6 Kuhn tetrahedra. Corner pseudo-signs come from
gradient crossings along axis edges (an edge crosses the surface iff its
endpoint gradients oppose), interpolation uses only the unsigned distances,
and pass 2 orients each triangle from the per-cube signed gradients. A cube
takes part only if max corner udf ≤ near_mult·voxel and mean corner udf <
avg_mult·voxel. Gradients are looked up lazily, by flat grid id, at exactly
the corners of the active cubes.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np

from .. import native

# Corner ids: bit 0 = dx, bit 1 = dy, bit 2 = dz. Each Kuhn tetrahedron is
# a monotone path 0 → +axis → +axis → 7, so neighbouring cubes split each
# shared face along the same diagonal (crack-free).
_TETS = np.array(
    [[0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7], [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7]],
    dtype=np.int32,
)

# Tetrahedron edges as local corner index pairs.
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32)

# For each of the 16 inside-bit configurations of a tetrahedron, up to 2
# triangles as triples of tet-edge ids (-1 = unused); the gradient pass
# orients them afterwards.
_TRI_TABLE = -np.ones((16, 2, 3), dtype=np.int32)
_TRI_TABLE[1, 0] = (0, 1, 2)
_TRI_TABLE[2, 0] = (0, 3, 4)
_TRI_TABLE[4, 0] = (1, 3, 5)
_TRI_TABLE[8, 0] = (2, 4, 5)
_TRI_TABLE[3] = [(1, 3, 4), (1, 4, 2)]
_TRI_TABLE[5] = [(0, 3, 5), (0, 5, 2)]
_TRI_TABLE[6] = [(0, 1, 5), (0, 5, 4)]
_TRI_TABLE[9] = [(0, 5, 1), (0, 4, 5)]
_TRI_TABLE[10] = [(0, 5, 3), (0, 2, 5)]
_TRI_TABLE[12] = [(1, 4, 3), (1, 2, 4)]
_TRI_TABLE[7, 0] = (2, 4, 5)
_TRI_TABLE[11, 0] = (1, 5, 3)
_TRI_TABLE[13, 0] = (0, 4, 3)
_TRI_TABLE[14, 0] = (0, 2, 1)

_CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.int64
)


class Mesh(NamedTuple):
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int64


def empty_mesh() -> Mesh:
    return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))


def marching_tetrahedra_udf(
    udf: np.ndarray,
    gradients,
    coords_range: tuple = (-1.0, 1.0),
    near_mult: float = 1.74,
    avg_mult: float = 1.05,
    times: dict | None = None,
    active_blocks: tuple | None = None,
) -> Mesh:
    """Extract an open surface from an (R,R,R) UDF grid.

    gradients: a dense (R,R,R,3) array, or a callable gid (K,) int64 →
    (K, 3) gradient (any scale; only directions are used).
    active_blocks: optional (ab (M,3), B) from GridFiller.fill — every
    near-band node is inside a listed block, so pass 1 scans only those
    blocks dilated by one in the negative direction.
    """
    R = udf.shape[0]
    if udf.shape != (R, R, R):
        raise ValueError(f"udf must be (R, R, R), got {udf.shape}")
    lo, hi = coords_range
    voxel = (hi - lo) / (R - 1)
    u = np.ascontiguousarray(udf, dtype=np.float32)
    if callable(gradients):
        grad_lookup = lambda gids: np.asarray(gradients(np.asarray(gids)), np.float32)
    else:
        if gradients.shape != (R, R, R, 3):
            raise ValueError(f"gradients must be (R, R, R, 3), got {gradients.shape}")
        flat_g = np.ascontiguousarray(gradients, dtype=np.float32).reshape(-1, 3)
        grad_lookup = lambda gids: flat_g[gids]

    def mark(name, t0):
        if times is not None:
            times[name] = round(time.perf_counter() - t0, 3)
        return time.perf_counter()

    t0 = time.perf_counter()
    if active_blocks is not None:
        ab, B = active_blocks
        # a cube anchored in block b has corners in blocks b..b+1 per axis
        nb = R // B
        ab = np.asarray(ab, np.int64)
        dil = (ab[:, None, :] - _CORNER_OFFSETS[None]).reshape(-1, 3)
        np.clip(dil, 0, nb - 1, out=dil)
        scan = np.unique((dil[:, 0] * nb + dil[:, 1]) * nb + dil[:, 2])
        sb = np.empty((len(scan), 3), np.int32)
        sb[:, 0] = scan // (nb * nb)
        sb[:, 1] = (scan // nb) % nb
        sb[:, 2] = scan % nb
    else:  # every block of a 1-voxel tiling: the whole grid
        B = 1
        r = np.arange(R, dtype=np.int32)
        sb = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    cube_ids, near_gids = native.mt_active_cubes_blocks(
        u, near_mult * voxel, avg_mult * voxel, sb, B
    )
    t0 = mark("mt_pass1", t0)
    if times is not None:
        times["mt_cubes"] = len(cube_ids)
        times["mt_corners"] = len(near_gids)
    if len(cube_ids) == 0:
        return empty_mesh()
    # pass 1 emitted the sorted distinct corners: ranks, not np.unique
    inv8 = native.mt_corner_ranks(near_gids, cube_ids, R)
    t0 = mark("mt_unique", t0)
    g_near = grad_lookup(near_gids)
    t0 = mark("mt_grads", t0)
    norm = np.maximum(np.linalg.norm(g_near, axis=-1, keepdims=True), 1e-12)
    g8 = np.round(g_near / norm * 127.0).astype(np.int8)[inv8]
    t0 = mark("mt_g8", t0)
    verts, faces = native.mt_emit(u, lo, voxel, cube_ids, g8)
    mark("mt_pass2", t0)
    return Mesh(verts, faces)


def _cube_corner_gids(cube_xyz: np.ndarray, R: int) -> np.ndarray:
    """Flat grid ids of the 8 corners of each cube; cube_xyz (M, 3)."""
    base = (cube_xyz[:, 0].astype(np.int64) * R + cube_xyz[:, 1]) * R + cube_xyz[:, 2]
    offs = (_CORNER_OFFSETS[:, 0] * R + _CORNER_OFFSETS[:, 1]) * R + _CORNER_OFFSETS[:, 2]
    return base[:, None] + offs[None, :]


def _gid_positions(gids: np.ndarray, R: int, lo: float, spacing: float) -> np.ndarray:
    """Grid-node positions from flat grid ids."""
    x = gids // (R * R)
    rem = gids % (R * R)
    return np.stack([x, rem // R, rem % R], axis=-1).astype(np.float32) * spacing + lo


def _collect_tri_edges(corner_vals: np.ndarray, corner_gids: np.ndarray) -> np.ndarray:
    """Case lookup over the 6 tetrahedra of each cube → (T, 3, 2) triangle
    edges as pairs of endpoint grid ids."""
    tri_edge_gids = []
    inside = corner_vals < 0.0 if corner_vals.dtype != np.bool_ else corner_vals
    for tet in _TETS:
        tin = inside[:, tet]
        case = tin[:, 0] * 1 + tin[:, 1] * 2 + tin[:, 2] * 4 + tin[:, 3] * 8
        tris = _TRI_TABLE[case]  # (M, 2, 3) edge ids
        for s in range(2):
            e = tris[:, s, :]
            valid = e[:, 0] >= 0
            if not valid.any():
                continue
            cube_sel = np.nonzero(valid)[0]
            local = tet[_TET_EDGES[e[cube_sel]]]  # (K, 3, 2) cube-local corners
            tri_edge_gids.append(corner_gids[cube_sel[:, None, None], local])
    if not tri_edge_gids:
        return np.zeros((0, 3, 2), np.int64)
    return np.concatenate(tri_edge_gids, axis=0)


def _emit_triangles_core(sign_vals: np.ndarray, corner_gids: np.ndarray, R: int, lo: float,
                         spacing: float, t_fn) -> Mesh:
    """Tetrahedralise the cubes, share each crossing by its global edge key,
    place it at t_fn(a, b) along a → b and drop degenerate faces. t_fn must
    depend only on the two global endpoints."""
    gids = _collect_tri_edges(sign_vals, corner_gids)
    if len(gids) == 0:
        return empty_mesh()
    NV = R * R * R
    a = gids.min(axis=-1).ravel()
    b = gids.max(axis=-1).ravel()
    uniq, inv = np.unique(a * NV + b, return_inverse=True)
    ua = (uniq // NV).astype(np.int64)
    ub = (uniq % NV).astype(np.int64)
    t = t_fn(ua, ub)
    pa = _gid_positions(ua, R, lo, spacing)
    pb = _gid_positions(ub, R, lo, spacing)
    verts = pa + t[:, None] * (pb - pa)
    faces = inv.reshape(-1, 3).astype(np.int64)
    # t clamped onto a shared grid node makes degenerate faces
    keep = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return Mesh(verts.astype(np.float32), faces[keep])


def _emit_triangles(corner_vals: np.ndarray, corner_gids: np.ndarray, R: int, lo: float,
                    spacing: float, grid_vals: np.ndarray, iso: float) -> Mesh:
    """Signed-field emission: each crossing at t = (va − iso)/(va − vb)."""

    def t_fn(ua, ub):
        va = grid_vals[ua]
        vb = grid_vals[ub]
        denom = va - vb
        t = np.where(np.abs(denom) > 1e-12, (va - iso) / np.where(denom == 0, 1, denom), 0.5)
        return np.clip(t, 0.0, 1.0).astype(np.float32)

    return _emit_triangles_core(corner_vals - iso, corner_gids, R, lo, spacing, t_fn)


def _orient_faces_by_gradient(mesh: Mesh, outward_at: np.ndarray) -> Mesh:
    """Flip faces whose normal opposes the outward direction at their vertices."""
    if len(mesh.faces) == 0:
        return mesh
    v, f = mesh.vertices, mesh.faces
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    flip = (n * outward_at[f].mean(axis=1)).sum(axis=1) < 0
    faces = f.copy()
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return Mesh(v, faces)


def marching_tetrahedra(values: np.ndarray, iso: float = 0.0,
                        coords_range: tuple = (-1.0, 1.0)) -> Mesh:
    """The iso-surface of a signed (R, R, R) grid indexed [x, y, z], faces
    oriented along the field's gradient (low → high). The watertight path
    runs it on the UDF grid at a small positive iso."""
    R = values.shape[0]
    if values.shape != (R, R, R):
        raise ValueError(f"values must be (R, R, R), got {values.shape}")
    inside = values < iso
    # active cubes: not all corners on one side
    agg_and = inside[:-1, :-1, :-1]
    agg_or = inside[:-1, :-1, :-1]
    for corner in _CORNER_OFFSETS[1:]:
        sl = inside[corner[0]:R - 1 + corner[0], corner[1]:R - 1 + corner[1],
                    corner[2]:R - 1 + corner[2]]
        agg_and = agg_and & sl
        agg_or = agg_or | sl
    cube_xyz = np.argwhere(agg_or & ~agg_and)
    if len(cube_xyz) == 0:
        return empty_mesh()
    flat_vals = values.reshape(-1).astype(np.float32)
    gids = _cube_corner_gids(cube_xyz, R)
    lo, hi = coords_range
    spacing = (hi - lo) / (R - 1)
    mesh = _emit_triangles(flat_vals[gids], gids, R, lo, spacing, flat_vals, iso)
    if len(mesh.faces) == 0:
        return mesh
    # central differences at each vertex's nearest interior grid node
    vid = np.clip(np.round((mesh.vertices - lo) / spacing).astype(np.int64), 1, R - 2)
    return _orient_faces_by_gradient(mesh, _gathered_central_diff(flat_vals, vid, R))


def _gathered_central_diff(flat_vals: np.ndarray, vid: np.ndarray, R: int) -> np.ndarray:
    """Central-difference gradient at integer grid nodes vid (K, 3)."""
    def val(dx, dy, dz):
        return flat_vals[((vid[:, 0] + dx) * R + (vid[:, 1] + dy)) * R + (vid[:, 2] + dz)]

    return np.stack([val(1, 0, 0) - val(-1, 0, 0), val(0, 1, 0) - val(0, -1, 0),
                     val(0, 0, 1) - val(0, 0, -1)], axis=-1)
