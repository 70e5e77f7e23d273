"""MeshUDF gradient-vote sign recovery, a host oracle for marching.py
(counterpart of surfd_tpu/geometry/vote_signs.py).

A numpy and Python form of the sign assignment the reference runs inside its
Cython marching cubes: a raster scan with breadth-first exploration and the
unsure-case and non-trivial-case deferred queues; per-corner neighbour votes
with `compute_edge_vote`'s opposite-facing-projection override, walks
extended past zero-valued vertices; the |vote|/votes < 0.707 unsure
threshold with its visit-neighbours-first re-queue; and the anchor-gradient
fallback for vote-less corners in the reference's corner order.

Only the sign field and the set of face-emitting cubes are reproduced: the
signed corner values feed the same marching-tetrahedra emitter as the
crossing-parity path (`marching_tetrahedra_udf`), so the two sign schemes
compare mesh to mesh with everything else held fixed.

Two approximations, both of the traversal's routing and not of the vote:
  * the trivial marching-cubes cases {1, 2, 5, 8, 9} are decided by a
    classifier over the minority corners' adjacency (`_trivial_case_table`)
    instead of the reference's CASES table;
  * "the new cube's triangulation reuses ≥ 2 created edge vertices" is
    approximated by "≥ 2 of its sign-crossing edges are shared with an
    already-emitted cube".

Gradient convention: `grads[i, j, k]` is the unit vector pointing toward the
surface (the reference's −normalize(∂udf/∂p)); component c is the derivative
along array axis c.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from .marching import Mesh, _cube_corner_gids, _emit_triangles_udf, _orient_faces_by_gradient

# Corner order of the reference's vertex_index_array (_cy.pyx:1220-1222):
# offsets along (axis0, axis1, axis2) for v0..v7.
_CORNERS = np.array(
    [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
     (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0)], dtype=np.int64
)
# Search directions in the reference's order (+a0,-a0,+a1,-a1,+a2,-a2)
# (_cy.pyx:1180-1182).
_DIRECTIONS = np.array(
    [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
    dtype=np.int64,
)
# Anchor fallback preference order over corner slots: the reference checks
# the 8 corners as (z,y,x),(z,y,x'),(z,y',x),(z,y',x'),(z',y,x),(z',y,x'),
# (z',y',x),(z',y',x') (_cy.pyx:1313-1336) — in _CORNERS slots:
_ANCHOR_ORDER = (0, 1, 3, 2, 4, 5, 7, 6)
# The 12 cube edges as corner-slot pairs.
_CUBE_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
)

_UNSURE_THRESH = 0.707


def _trivial_case_table() -> np.ndarray:
    """(256,) bool: does this corner-sign index fall in MC cases {1,2,5,8,9}?

    Derived from first principles: the Lewiner/Chernyaev case of an index is
    a function of the minority corner set's adjacency invariants —
    (#corners n, #cube-edges e among them, max vertex degree d):
      case 1 = (1,0,·)   single corner
      case 2 = (2,1,·)   edge pair
      case 5 = (3,2,·)   3-corner path on a face
      case 8 = (4,4,·)   full face
      case 9 = (4,3,d=3) claw (one corner with all 3 neighbors)
    All other signatures (incl. the chains 11/14 at (4,3,d=2)) are
    non-trivial. The JAX package's tests check the classifier against the
    reference CASES table on all 256 indices.
    """
    out = np.zeros(256, dtype=bool)
    for idx in range(256):
        s = [i for i in range(8) if (idx >> i) & 1]
        if len(s) > 4:
            s = [i for i in range(8) if not (idx >> i) & 1]
        n = len(s)
        deg = [0] * n
        e = 0
        for a in range(n):
            for b in range(a + 1, n):
                if np.abs(_CORNERS[s[a]] - _CORNERS[s[b]]).sum() == 1:
                    e += 1
                    deg[a] += 1
                    deg[b] += 1
        d = max(deg, default=0)
        out[idx] = (
            (n == 1)
            or (n == 2 and e == 1)
            or (n == 3 and e == 2)
            or (n == 4 and e == 4)
            or (n == 4 and e == 3 and d == 3)
        )
    return out


_TRIVIAL = _trivial_case_table()


def _my_sign(a: float) -> float:
    return 1.0 if a > 0 else (-1.0 if a < 0 else 0.0)  # _cy.pyx:1809-1815


class _VoteSigner:
    """One extraction's worth of vote/BFS state (the Cython locals)."""

    def __init__(self, im: np.ndarray, grads: np.ndarray, mask=None):
        if im.ndim != 3 or grads.shape != im.shape + (3,):
            raise ValueError(f"want udf (R, R, R) and grads (R, R, R, 3), got "
                             f"{im.shape} and {grads.shape}")
        self.im = np.ascontiguousarray(im, np.float32)
        self.g = np.ascontiguousarray(grads, np.float32)
        self.mask = mask
        N0, N1, N2 = im.shape
        # Nx_bound etc. (_cy.pyx:1154): last usable vertex index per axis.
        self.bound = (N0 - 2, N1 - 2, N2 - 2)
        # 2.0/(Nx-1) with Nx = im.shape[2] (_cy.pyx:1129-1131)
        self.voxel = 2.0 / (N2 - 1)
        self.avg_thresh = 1.05 * self.voxel
        self.max_thresh = 1.74 * self.voxel
        self.signed = np.zeros(im.shape, np.float32)
        self.smask = np.zeros(im.shape, bool)
        self.visited = np.zeros(im.shape, bool)
        self.emitted = np.zeros(im.shape, bool)  # face-producing cube anchors
        self.queue = deque()
        self.unsure = deque()
        self.nontrivial = deque()

    # -- the vote rule ----------------------------------------------------
    def _edge_vote(self, v, n, axis, sgn) -> float:
        """compute_edge_vote (_cy.pyx:1776-1806): +1 when the projections
        diverge along the walk direction (no surface between — gradients
        point toward surfaces on opposite OUTER sides), else the dot."""
        g1, g2 = self.g[v], self.g[n]
        p1, p2 = g1[axis], g2[axis]
        if sgn > 0:
            if p2 > 0 and p1 < 0:
                return 1.0
        else:
            if p2 < 0 and p1 > 0:
                return 1.0
        return float(g1 @ g2)

    def _vote_corner(self, vert) -> tuple[int, float]:
        """Accumulate neighbor votes for one corner (_cy.pyx:1265-1302)."""
        votes, ssum = 0, 0.0
        im, signed, bound = self.im, self.signed, self.bound
        for dz, dy, dx in _DIRECTIONS:
            axis = 0 if dz else (1 if dy else 2)
            sgn = (dz + dy + dx)
            i, max_d = 0, 1
            while i < max_d:
                i += 1
                c = (vert[0] + i * dz, vert[1] + i * dy, vert[2] + i * dx)
                if not (0 <= c[0] <= bound[0] and 0 <= c[1] <= bound[1]
                        and 0 <= c[2] <= bound[2]):
                    break
                if im[c] == 0.0:
                    # walk one vertex further past exact zeros (_cy.pyx:1288)
                    max_d += 1
                    continue
                if signed[c] == 0.0:
                    continue  # not yet signed — no opinion
                votes += 1
                ssum += signed[c] * self._edge_vote(vert, c, axis, sgn)
        return votes, ssum

    # -- per-cube processing ---------------------------------------------
    def _gates(self, z, y, x) -> bool:
        u8 = self.im[tuple((_CORNERS + (z, y, x)).T)]
        return u8.mean() < self.avg_thresh and u8.max() <= self.max_thresh

    def _anchor_fallback(self, z, y, x, verts, votes, bfs_gate: bool) -> bool:
        """Sign vote-less corners from one anchor gradient
        (_cy.pyx:1310-1374 seed / 1597-1713 BFS). Returns False when the BFS
        unsure check re-queued the cube (abandon it for now)."""
        base = None
        anchor_sign = 1.0
        for slot in _ANCHOR_ORDER:
            v = verts[slot]
            if self.smask[v] and np.abs(self.g[v]).sum() > 0:
                anchor_sign = _my_sign(self.signed[v])
                base = self.g[v].astype(np.float64)
                break
        if base is None:
            for slot in _ANCHOR_ORDER:
                v = verts[slot]
                if np.abs(self.g[v]).sum() > 0:
                    base = self.g[v].astype(np.float64)
                    break
        if base is None:
            return True  # 'all 0 vec...' — reference just prints and moves on
        base = anchor_sign * base
        for slot in range(8):
            if votes[slot] != 0:
                continue
            v = verts[slot]
            d = float(base @ self.g[v])
            if bfs_gate and abs(d) < _UNSURE_THRESH:
                self.unsure.append((z, y, x))
                return False
            self.signed[v] = _my_sign(d)
        return True

    def _push_neighbors(self, z, y, x):
        """_cy.pyx:1407-1418 — note the asymmetric bounds (< bound)."""
        b0, b1, b2 = self.bound
        if x + 1 < b2:
            self.queue.append((z, y, x + 1))
        if y + 1 < b1:
            self.queue.append((z, y + 1, x))
        if x - 1 >= 0:
            self.queue.append((z, y, x - 1))
        if y - 1 >= 0:
            self.queue.append((z, y - 1, x))
        if z - 1 >= 0:
            self.queue.append((z - 1, y, x))
        if z + 1 < b0:
            self.queue.append((z + 1, y, x))

    def _cube_index(self, verts) -> int:
        idx = 0
        for slot in range(8):
            if self.signed[verts[slot]] * self.im[verts[slot]] > 0.0:
                idx |= 1 << slot
        return idx

    def _shared_crossing_edges(self, z, y, x, verts) -> int:
        """Approximation of check_the_big_switch >= 2 (_cy.pyx:1752): count
        sign-crossing cube edges shared with an already-emitted cube."""
        n = 0
        sv = [self.signed[verts[s]] * self.im[verts[s]] for s in range(8)]
        for a, b in _CUBE_EDGES:
            if (sv[a] > 0) == (sv[b] > 0):
                continue
            pa, pb = _CORNERS[a] + (z, y, x), _CORNERS[b] + (z, y, x)
            lo_ = np.minimum(pa, pb)
            axis = int(np.argmax(pa != pb))
            # cubes sharing this edge: anchors lo - {0,1} on the two axes
            # perpendicular to the edge
            for da in (0, 1):
                for db in (0, 1):
                    anchor = lo_.copy()
                    p, q = [k for k in range(3) if k != axis]
                    anchor[p] -= da
                    anchor[q] -= db
                    if (anchor == (z, y, x)).all():
                        continue
                    if (anchor >= 0).all() and self.emitted[tuple(anchor)]:
                        n += 1
                        break
                else:
                    continue
                break
        return n

    def _process(self, z, y, x, *, seed: bool, emit: bool) -> bool:
        """Vote-sign one cube. Returns True iff it produced faces (case > 0
        path taken) so the caller enters/continues the BFS."""
        verts = [tuple(_CORNERS[s] + (z, y, x)) for s in range(8)]
        votes = [0] * 8
        for slot in range(8):
            v = verts[slot]
            if self.smask[v]:
                votes[slot] = 1
                continue
            if self.im[v] == 0.0:
                votes[slot] = 1
                continue
            nv, ssum = self._vote_corner(v)
            votes[slot] = nv
            # BFS unsure deferral (_cy.pyx:1583-1588): only while the main
            # queue is non-empty, and only face-producing visits re-queue
            if (not seed and nv >= 1 and abs(ssum) / nv < _UNSURE_THRESH
                    and self.queue):
                if emit:
                    self.unsure.append((z, y, x))
                return False
            self.signed[v] = _my_sign(ssum)

        if not all(v >= 1 for v in votes):
            bfs_gate = (not seed) and emit and bool(self.queue)
            if not self._anchor_fallback(z, y, x, verts, votes, bfs_gate):
                return False

        if not emit:
            # neighbor-of-unsure visit: signs computed, nothing else
            # (_cy.pyx:1443-1446 — "no faces ... do not take part")
            return False

        for v in verts:
            self.smask[v] = True

        idx = self._cube_index(verts)
        if idx in (0, 255):  # case == 0
            self.visited[z, y, x] = True
            return False
        if not seed:
            # non-trivial MC configurations wait for more context
            # (_cy.pyx:1747-1749)
            if not _TRIVIAL[idx] and (self.queue or self.unsure):
                self.nontrivial.append((z, y, x))
                return False
            if self._shared_crossing_edges(z, y, x, verts) < 2:
                return False
        self.visited[z, y, x] = True
        self.emitted[z, y, x] = True
        self._push_neighbors(z, y, x)
        return True

    # -- the traversal ----------------------------------------------------
    def run(self):
        b0, b1, b2 = self.bound
        for zi in range(0, b0 + 1):
            for yi in range(0, b1 + 1):
                for xi in range(0, b2 + 1):
                    if self.visited[zi, yi, xi]:
                        continue
                    if self.mask is not None and not self.mask[
                        min(zi + 1, b0 + 1), min(yi + 1, b1 + 1), min(xi + 1, b2 + 1)
                    ]:
                        continue
                    if not self._gates(zi, yi, xi):
                        continue
                    if not self._process(zi, yi, xi, seed=True, emit=True):
                        continue
                    self._bfs()

    def _bfs(self):
        visit_neighbors = True  # _cy.pyx:1433
        while self.queue or self.unsure or self.nontrivial:
            emit = True
            if self.queue:
                z, y, x = self.queue.popleft()
            elif self.unsure:
                if visit_neighbors:
                    # peek: flood the unsure cube's neighbors first
                    z, y, x = self.unsure[0]
                    if self.visited[z, y, x]:
                        self.unsure.popleft()
                        continue
                    self._push_neighbors(z, y, x)
                    visit_neighbors = False
                    continue
                z, y, x = self.unsure.popleft()
                visit_neighbors = True
            else:
                z, y, x = self.nontrivial.popleft()
            if self.visited[z, y, x]:
                continue
            if self.mask is not None and not self.mask[z + 1, y + 1, x + 1]:
                continue
            if not self._gates(z, y, x):
                continue
            # neighbors visited on behalf of an unsure cube produce no faces
            self._process(z, y, x, seed=False, emit=visit_neighbors)


def vote_sign_field(udf: np.ndarray, grads: np.ndarray, mask=None):
    """Run the reference's vote/BFS sign recovery.

    Returns (signed, emitted): `signed` (R,R,R) float32 in {-1,0,+1} and
    `emitted` (R,R,R) bool marking face-producing cube anchors.
    """
    vs = _VoteSigner(udf, grads, mask)
    vs.run()
    return vs.signed, vs.emitted


def marching_tetrahedra_vote(
    udf: np.ndarray,
    grads: np.ndarray,
    coords_range: tuple[float, float] = (-1.0, 1.0),
    mask=None,
) -> Mesh:
    """Vote-signed UDF extraction through the production MT emitter.

    The sign ASSIGNMENT is the reference's vote/BFS algorithm; the
    triangulation, dedup and orientation are marching.py's — so a mesh-level
    comparison against `marching_tetrahedra_udf` isolates exactly the
    sign-recovery difference.
    """
    R = udf.shape[0]
    signed, emitted = vote_sign_field(udf, grads, mask)
    cube_xyz = np.argwhere(emitted)
    if len(cube_xyz) == 0:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    flat_u = np.ascontiguousarray(udf, np.float32).reshape(-1)
    flat_s = signed.reshape(-1)
    gids = _cube_corner_gids(cube_xyz, R)
    corner_vals = (flat_s[gids] * flat_u[gids]).astype(np.float32)
    lo, hi = coords_range
    voxel = (hi - lo) / (R - 1)
    mesh = _emit_triangles_udf(corner_vals, gids, R, lo, voxel, flat_u)
    if len(mesh.faces):
        vid = np.clip(np.round((mesh.vertices - lo) / voxel).astype(np.int64), 0, R - 1)
        # outward = away from the surface = MINUS the (toward-surface) grads
        g = grads[vid[:, 0], vid[:, 1], vid[:, 2]]
        mesh = _orient_faces_by_gradient(mesh, -g)
    return mesh
