"""The port's extraction oracles against the JAX package's, on the CPU:
the analytic fixtures, the numpy mesh cleanup, the gradient-vote sign
recovery, the numpy marching path, make_grad_fn / QueryStream and the
PLY writer. Inputs come from numpy seeds.

Bars: the fixtures and every numpy function bit-equal (both sides are
numpy); the numpy marching against the port's native passes by
tests/test_chamfer_parity.py's bars (equal faces, Hausdorff < 1e-5);
autograd gradients within 1e-6 of JAX's VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.geometry import analytic as janalytic
from surfd_tpu.geometry import grid as jgrid
from surfd_tpu.geometry import marching as jmarch
from surfd_tpu.geometry import mesh_ops as jops
from surfd_tpu.geometry import vote_signs as jvote
from surfd_tpu_torch import native
from surfd_tpu_torch.geometry import analytic, mesh_ops, vote_signs
from surfd_tpu_torch.geometry import (
    GridFiller,
    Mesh,
    QueryStream,
    TorchField,
    hausdorff_distance,
    make_grad_fn,
    marching_tetrahedra,
    marching_tetrahedra_udf,
    write_ply,
)
from surfd_tpu_torch.geometry.marching import gid_positions

FIELDS = ["sphere", "torus", "open_sheet"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _dense(g):
    """A dense (R, R, R, 3) gradient array as marching's gradient starter."""
    flat = np.ascontiguousarray(g, dtype=np.float32).reshape(-1, 3)
    return lambda gids: (lambda: flat[gids])


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("R", [17, 32])
def test_fixtures_bit_equal(name, R):
    got, want = analytic.FIXTURES[name](R), janalytic.FIXTURES[name](R)
    for g, w in zip(got[:3], want[:3]):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(got[3](500, rng_a), want[3](500, rng_b))


@pytest.mark.parametrize("name", FIELDS)
def test_torch_field_matches_fixture(name):
    """The torch form on the CPU: values at the grid nodes within 1e-6 of the
    numpy fixture's, autograd gradients where the field is smooth."""
    R = 24
    _, udf, grad, _ = analytic.FIXTURES[name](R)
    xs = np.linspace(-1.0, 1.0, R, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
    field = TorchField(name, "cpu")
    np.testing.assert_allclose(field(torch.from_numpy(pts)).numpy(), udf.reshape(-1), atol=1e-6)
    g = QueryStream("cpu", 1000).fetch(make_grad_fn(field), pts)
    smooth = udf.reshape(-1) > 0.05  # away from the surface and its kinks
    np.testing.assert_allclose(g[smooth], grad.reshape(-1, 3)[smooth], atol=1e-5)


def test_torch_field_rejects_unknown():
    with pytest.raises(ValueError, match="unknown field"):
        TorchField("cube", "cpu")


# --- make_grad_fn / QueryStream against JAX's eval_in_chunks --------------

def _jax_sphere(p):
    return jnp.abs(jnp.linalg.norm(p, axis=-1) - 0.6)


def test_make_grad_fn_matches_jax():
    pts = np.random.default_rng(0).uniform(-1, 1, (5000, 3)).astype(np.float32)
    want = jgrid.eval_in_chunks(jgrid.make_grad_fn(_jax_sphere), pts, 1024)
    got = QueryStream("cpu", 1024).fetch(make_grad_fn(TorchField("sphere", "cpu")), pts)
    assert got.shape == want.shape == (5000, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_eval_in_chunks_matches_jax():
    pts = np.random.default_rng(1).uniform(-1, 1, (3001, 3)).astype(np.float32)
    want = jgrid.eval_in_chunks(_jax_sphere, pts, 512)
    for chunk in (512, 4096):
        got = QueryStream("cpu", chunk).fetch(TorchField("sphere", "cpu"), pts)
        np.testing.assert_allclose(got, want, atol=1e-6)
    # a tensor is used where it lies; an empty input gives an empty result
    t = QueryStream("cpu", 512).fetch(TorchField("sphere", "cpu"), torch.from_numpy(pts[:0]))
    assert t.shape == (0,)


def test_eval_in_chunks_never_defaults_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryStream(chunk=4).fetch(lambda p: p.sum(-1), pts)
    assert QueryStream("cpu", 4).fetch(lambda p: p.sum(-1), pts).shape == (4,)


def test_fill_gradients_matches_jax():
    """The dense band gradients of an analytic field: the same band, the
    same values to 1e-5 (the port takes the nodes at index·spacing + lo, JAX
    at the linspace coordinates: an ulp apart)."""
    R = 32
    _, udf, _, _ = analytic.sphere_fields(R)
    want = jgrid.GridFiller(R).fill_gradients(jgrid.make_grad_fn(_jax_sphere), udf)
    got = GridFiller(R, queries=QueryStream("cpu")).fill_gradients(
        make_grad_fn(TorchField("sphere", "cpu")), udf)
    np.testing.assert_array_equal(np.abs(got).sum(-1) > 0, np.abs(want).sum(-1) > 0)
    np.testing.assert_allclose(got, want, atol=1e-5)


# --- the numpy mesh cleanup, bit-equal ----------------------------------

def _random_mesh(seed, n_verts, n_faces, decimals=3):
    """A messy soup: vertices on a coarse lattice (so some coincide), random
    faces with degenerate and repeated ones."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.uniform(-1, 1, (n_verts, 3)), decimals).astype(np.float32)
    f = rng.integers(0, n_verts, (n_faces, 3))
    f[: n_faces // 20, 1] = f[: n_faces // 20, 0]  # degenerate
    f = np.concatenate([f, f[: n_faces // 10, [1, 2, 0]]])  # rotated repeats
    return Mesh(v, f.astype(np.int64))


def _analytic_mesh(name, R=40):
    sdf, udf, grad, _ = analytic.FIXTURES[name](R)
    return jmarch.marching_tetrahedra_udf(udf, grad, use_native=False)


def _meshes():
    return {
        "random_small": _random_mesh(0, 300, 900, decimals=1),
        "random_large": _random_mesh(1, 20_000, 40_000),  # > 100,000 keys: the native sort
        "sphere": _analytic_mesh("sphere"),
        "open_sheet": _analytic_mesh("open_sheet"),
    }


@pytest.fixture(scope="module")
def meshes():
    return _meshes()


def _assert_mesh_equal(got, want):
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)


MESH_FNS = [
    ("merge_duplicate_vertices", {}),
    ("merge_duplicate_vertices", {"decimals": 2}),
    ("remove_degenerate_faces", {}),
    ("remove_degenerate_faces", {"area_eps": 1e-3}),
    ("remove_duplicate_faces", {}),
    ("smooth_borders", {}),
    ("fill_triangle_holes", {}),
    ("stabilize", {}),
    ("stabilize", {"assume_clean": True}),
    ("laplacian_smooth", {}),
    ("remove_unreferenced_vertices", {}),
]


@pytest.mark.parametrize("fn,kw", MESH_FNS, ids=[f"{n}{kw or ''}" for n, kw in MESH_FNS])
@pytest.mark.parametrize("which", ["random_small", "random_large", "sphere", "open_sheet"])
def test_mesh_op_bit_equal(meshes, fn, kw, which):
    mesh = meshes[which]
    _assert_mesh_equal(getattr(mesh_ops, fn)(mesh, **kw), getattr(jops, fn)(mesh, **kw))


@pytest.mark.parametrize("which", ["random_small", "random_large", "sphere", "open_sheet"])
def test_boundary_and_normals_bit_equal(meshes, which):
    mesh = meshes[which]
    np.testing.assert_array_equal(mesh_ops.boundary_vertices(mesh), jops.boundary_vertices(mesh))
    np.testing.assert_array_equal(mesh_ops.vertex_normals(mesh), jops.vertex_normals(mesh))


def test_mesh_op_helpers_bit_equal(meshes):
    for mesh in meshes.values():
        f = mesh.faces
        np.testing.assert_array_equal(mesh_ops._edges_of(f), jops._edges_of(f))
        for got, want in zip(mesh_ops._unique_edges_with_counts(f, len(mesh.vertices)),
                             jops._unique_edges_with_counts(f, len(mesh.vertices))):
            np.testing.assert_array_equal(got, want)
        v = mesh.vertices.astype(np.float64)
        np.testing.assert_array_equal(mesh_ops._uniform_laplacian_step(v, f, 0.3),
                                      jops._uniform_laplacian_step(v, f, 0.3))
    keys = np.random.default_rng(5).integers(0, 1 << 40, 150_000)
    for got, want in zip(mesh_ops._unique_i64(keys), jops._unique_i64(keys)):
        np.testing.assert_array_equal(got, want)


def test_merge_rejects_unpackable_vertices():
    mesh = Mesh(np.array([[3.0, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
                np.array([[0, 1, 2]], np.int64))
    with pytest.raises(ValueError, match="packable"):
        mesh_ops.merge_duplicate_vertices(mesh)


def test_empty_meshes():
    empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    for fn, kw in MESH_FNS:
        out = getattr(mesh_ops, fn)(empty, **kw)
        assert len(out.faces) == 0
    assert len(mesh_ops.boundary_vertices(empty)) == 0


# --- the gradient-vote sign oracle ---------------------------------------

def test_trivial_case_table_equal():
    np.testing.assert_array_equal(vote_signs._trivial_case_table(), jvote._trivial_case_table())
    np.testing.assert_array_equal(vote_signs._TRIVIAL, jvote._TRIVIAL)


@pytest.mark.parametrize("name", ["sphere", "torus"])
@pytest.mark.parametrize("R", [24, 32])
def test_vote_signs_equal_jax(name, R):
    """Sign field, emitted cubes and the vote-signed mesh equal JAX's, with
    exact gradients and with seeded noise on them."""
    _, udf, grad, _ = analytic.FIXTURES[name](R)
    for sigma in (0.0, 0.3):
        g = -grad + sigma * np.random.default_rng(R).normal(size=grad.shape).astype(np.float32)
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9)
        signed, emitted = vote_signs.vote_sign_field(udf, g)
        jsigned, jemitted = jvote.vote_sign_field(udf, g)
        np.testing.assert_array_equal(signed, jsigned)
        np.testing.assert_array_equal(emitted, jemitted)
        assert emitted.any()
        _assert_mesh_equal(vote_signs.marching_tetrahedra_vote(udf, g),
                           jvote.marching_tetrahedra_vote(udf, g))


def test_vote_signs_reject_bad_shapes():
    with pytest.raises(ValueError):
        vote_signs.vote_sign_field(np.zeros((4, 4, 4), np.float32), np.zeros((4, 4, 3)))


# --- the numpy marching path ---------------------------------------------

@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("R", [32, 48])  # even: the sheet lies between grid planes
def test_numpy_marching_equals_jax(name, R):
    """use_native=False on starters over dense gradients, a point callable
    at the nodes' positions and a grid-id callable: JAX's numpy marching,
    bit for bit."""
    _, udf, grad, _ = analytic.FIXTURES[name](R)
    want = jmarch.marching_tetrahedra_udf(udf, grad, use_native=False)
    assert len(want.faces) > 100
    _assert_mesh_equal(marching_tetrahedra_udf(udf, _dense(grad), use_native=False), want)
    flat = grad.reshape(-1, 3)
    lo, voxel = -1.0, 2.0 / (R - 1)

    def by_point(pts):
        idx = np.clip(np.rint((pts - lo) / voxel), 0, R - 1).astype(np.int64)
        return flat[(idx[:, 0] * R + idx[:, 1]) * R + idx[:, 2]]

    at_points = lambda gids: (lambda: by_point(gid_positions(gids, R, lo, voxel)))  # noqa: E731
    by_id = lambda gids: (lambda: flat[gids])  # noqa: E731
    for start in (at_points, by_id):
        _assert_mesh_equal(marching_tetrahedra_udf(udf, start, use_native=False), want)


@pytest.mark.parametrize("name", ["sphere", "torus", "open_sheet"])
def test_numpy_marching_matches_native(name):
    """The numpy path against the port's native passes: equal face counts,
    vertex Hausdorff < 1e-5 (tests/test_chamfer_parity.py's bars)."""
    _, udf, grad, _ = analytic.FIXTURES[name](64)
    m_np = marching_tetrahedra_udf(udf, _dense(grad), use_native=False)
    m_cc = marching_tetrahedra_udf(udf, _dense(grad))
    assert len(m_np.faces) == len(m_cc.faces) > 1000
    assert hausdorff_distance(m_np.vertices, m_cc.vertices) < 1e-5


@pytest.mark.parametrize("name", ["sphere", "torus"])
def test_numpy_marching_matches_oracle_signs(name):
    """Closed fields: the numpy path reproduces the exact-sign mesh."""
    R = 48
    sdf, udf, grad, _ = analytic.FIXTURES[name](R)
    m_udf = marching_tetrahedra_udf(udf, _dense(grad), use_native=False)
    m_oracle = marching_tetrahedra(sdf, iso=0.0)
    assert len(m_udf.faces) == len(m_oracle.faces)
    assert hausdorff_distance(m_udf.vertices, m_oracle.vertices) < 1e-5 * 2.0 / (R - 1)


def test_native_full_pass_equals_block_pass():
    """mt_active_cubes (the whole grid) equals the block-gated pass over
    every block."""
    R = 32
    _, udf, _, _ = analytic.torus_fields(R)
    voxel = 2.0 / (R - 1)
    r = np.arange(R // 4, dtype=np.int32)
    sb = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    for got, want in zip(native.mt_active_cubes(udf, 1.74 * voxel, 1.05 * voxel),
                         native.mt_active_cubes_blocks(udf, 1.74 * voxel, 1.05 * voxel, sb, 4)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        native.mt_active_cubes(udf[:, :, :5], 0.1, 0.1)


# --- PLY -----------------------------------------------------------------

def _read_ply(path):
    with open(path, "rb") as fh:
        data = fh.read()
    head, body = data.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    nv = int(next(x for x in lines if x.startswith("element vertex")).split()[-1])
    nf = int(next(x for x in lines if x.startswith("element face")).split()[-1])
    v = np.frombuffer(body[: 12 * nv], "<f4").reshape(nv, 3)
    rows = np.frombuffer(body[12 * nv:], np.uint8).reshape(nf, 13)
    assert (rows[:, 0] == 3).all()
    f = rows[:, 1:].copy().view("<i4").reshape(nf, 3)
    return v, f


def test_write_ply_reads_back(tmp_path, meshes):
    mesh = meshes["sphere"]
    path = tmp_path / "m.ply"
    write_ply(str(path), mesh)
    v, f = _read_ply(path)
    np.testing.assert_array_equal(v, mesh.vertices)
    np.testing.assert_array_equal(f, mesh.faces)
    jpath = tmp_path / "j.ply"
    from surfd_tpu.geometry.mesh_io import write_ply as jax_write_ply

    jax_write_ply(str(jpath), mesh)
    assert path.read_bytes() == jpath.read_bytes()
