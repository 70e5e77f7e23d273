"""The cleanup's Laplacian smoothing (`ops.mesh_laplacian`) on the CPU.

The plain PyTorch version against numpy's `geometry.mesh_ops.laplacian_smooth`
(the JAX package's pass, held to it bit for bit in test_torch_oracles) on a
finalized sheet mesh, meshes with a degenerate face and an isolated vertex,
zero iterations and an empty mesh; a numpy emulation of the CUDA kernel's
order of sums (corner rows sorted by corner id, six walks a row) against
numpy on the same meshes; `get_mesh_from_udf` on the CPU, which keeps numpy's
pass and launches no kernel; and the wrapper's checks. The kernel itself
runs on the card: tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from surfd_tpu_torch import ops
from surfd_tpu_torch.geometry import TorchField, filter_small_components
from surfd_tpu_torch.geometry import mesh_ops
from surfd_tpu_torch.geometry.marching import Mesh, empty_mesh
from surfd_tpu_torch.ops import mesh_laplacian as ml
from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf

SHEET = dict(resolution=32, max_batch=2**14)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _sheet_mesh():
    """The analytic open sheet at 32³ through the extraction's finalize (the
    exact-point filter, stabilize, border smoothing): the mesh the cleanup's
    Laplacian is handed."""
    return get_mesh_from_udf(TorchField("open_sheet", "cpu"), cfg=MeshExtractionConfig(**SHEET))


def _random_mesh(seed=0, n_verts=400, n_faces=1200):
    """A soup: random faces, a twentieth of them degenerate (a repeated id),
    repeated faces, vertices in no face."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (n_verts, 3)).astype(np.float32)
    f = rng.integers(0, n_verts - 20, (n_faces, 3))
    f[: n_faces // 20, 1] = f[: n_faces // 20, 0]
    f = np.concatenate([f, f[: n_faces // 10]])
    return Mesh(v, f.astype(np.int64))


def _two_triangles(extra_vertex: bool, degenerate: bool):
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5], [3, 3, 3]], np.float32)
    f = np.array([[0, 1, 2], [1, 3, 2]] + ([[2, 2, 3]] if degenerate else []), np.int64)
    return Mesh(v if extra_vertex else v[:4], f)


CASES = {
    "sheet": (_sheet_mesh, 3),
    "soup": (_random_mesh, 3),
    "degenerate face": (lambda: _two_triangles(False, True), 3),
    "isolated vertex": (lambda: _two_triangles(True, False), 2),
    "one iteration": (lambda: _two_triangles(True, True), 1),
    "iterations 0": (_random_mesh, 0),
    "empty mesh": (empty_mesh, 3),
    "vertices, no faces": (lambda: Mesh(_random_mesh().vertices, np.zeros((0, 3), np.int64)), 3),
}


@pytest.fixture(scope="module")
def meshes():
    return {name: make() for name, (make, _) in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_numpy(meshes, case):
    mesh, iters = meshes[case], CASES[case][1]
    want = mesh_ops.laplacian_smooth(mesh, iterations=iters, lam=0.5).vertices
    before = ml.laplacian_smooth_ref.calls
    got = ml.laplacian_smooth(torch.from_numpy(mesh.vertices), torch.from_numpy(mesh.faces),
                              iters, 0.5)
    assert ml.laplacian_smooth_ref.calls == before + 1  # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.shape == mesh.vertices.shape
    assert np.abs(got.numpy().astype(np.float64) - want.astype(np.float64)).max(initial=0) <= 1e-12
    if case == "sheet":
        assert len(mesh.faces) > 1000
        assert np.abs(want - mesh.vertices).max() > 1e-3  # the pass moved the mesh


def _kernel_emulation(vertices, faces, iterations, lam):
    """ops/csrc/mesh_laplacian.cu's arithmetic in numpy: corner rows sorted
    by corner id; each vertex's float64 sums in the kernel's order (the
    (c+1) neighbours of slots 0, 1, 2, then the (c+2) neighbours of slots 1,
    2, 0, each walk along the row); mean = sum / (2·corners); the step.
    Returns the float64 positions of the last pass, before its cast."""
    V = len(vertices)
    fi = faces.reshape(-1)
    row_len = np.bincount(fi, minlength=V)
    off = np.concatenate([[0], np.cumsum(row_len)])
    corners = np.argsort(fi, kind="stable")  # within a row: ascending corner id
    owner = np.repeat(np.arange(V), row_len)
    at = np.arange(len(corners)) - off[owner]  # position in its row
    p = vertices.astype(np.float64)
    for _ in range(iterations):
        s = np.zeros((V, 3))
        for r in range(6):
            slot, step = (r, 1) if r < 3 else ((r - 2) % 3, 2)
            for j in range(int(row_len.max(initial=0))):
                sel = (at == j) & (corners % 3 == slot)  # one entry a vertex at most
                c = corners[sel]
                s[owner[sel]] += p[fi[3 * (c // 3) + (c % 3 + step) % 3]]
        cnt = 2.0 * row_len
        mean = np.where((cnt > 0)[:, None], s / np.maximum(cnt, 1)[:, None], p)
        p = p + lam * (mean - p)
    return p


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_order_equals_numpy(meshes, case):
    """The kernel's order of sums gives numpy's float64 iterate bit for bit,
    so its float32 result too. (Summing each corner's two neighbours in
    corner order instead differs in the last bits of a few hundred
    coordinates of the sheet and the soup.)"""
    mesh, iters = meshes[case], CASES[case][1]
    want = mesh.vertices.astype(np.float64)
    for _ in range(iters):
        want = mesh_ops._uniform_laplacian_step(want, mesh.faces, 0.5)
    got = _kernel_emulation(mesh.vertices, mesh.faces, iters, 0.5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.float32),
                                  mesh_ops.laplacian_smooth(mesh, iters, 0.5).vertices)


def test_cpu_extraction_keeps_numpy_and_launches_nothing():
    """On the CPU the cleanup smooths with numpy: the mesh is the finalized
    mesh through `mesh_ops.laplacian_smooth` and the component filter, and
    neither the kernel nor its plain version runs."""
    cfg = MeshExtractionConfig(**SHEET, final_laplacian_iters=3, min_component_faces=10)
    before = (ml.laplacian_smooth.launches, ops.kernel_calls()["plain_calls"])
    got, stats = get_mesh_from_udf(TorchField("open_sheet", "cpu"), cfg=cfg, return_stats=True)
    assert (ml.laplacian_smooth.launches, ops.kernel_calls()["plain_calls"]) == before
    assert "mesh_laplacian" not in ops.kernel_calls()["launches"]
    assert stats["times"]["cleanup_laplacian"] >= 0
    want = filter_small_components(mesh_ops.laplacian_smooth(_sheet_mesh(), 3, 0.5), 10)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert stats["final_faces"] == len(want.faces) > 1000


BAD = {
    "vertices float64": (lambda v, f: (v.double(), f), "vertices"),
    "vertices (V, 2)": (lambda v, f: (v[:, :2], f), "vertices"),
    "faces int32": (lambda v, f: (v, f.int()), "faces"),
    "faces (F, 4)": (lambda v, f: (v, torch.cat([f, f[:, :1]], 1)), "faces"),
    "id past V": (lambda v, f: (v, torch.where(f == 3, 4, f)), "outside"),
    "negative id": (lambda v, f: (v, torch.where(f == 3, -1, f)), "outside"),
    "meta device": (lambda v, f: (v.to("meta"), f.to("meta")), "device"),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_wrapper_raises(bad):
    m = _two_triangles(False, False)
    v, f = BAD[bad][0](torch.from_numpy(m.vertices), torch.from_numpy(m.faces))
    with pytest.raises(ValueError, match=BAD[bad][1]):
        ml.laplacian_smooth(v, f, 3, 0.5)
    with pytest.raises(ValueError, match="iterations"):
        ml.laplacian_smooth(torch.from_numpy(m.vertices), torch.from_numpy(m.faces), -1, 0.5)
