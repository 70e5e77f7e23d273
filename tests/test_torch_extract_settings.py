"""Extraction at every MeshExtractionConfig setting, the port against the JAX
package on the CPU: the 64x2 sphere decoder of test_torch_pipeline at 64³
(faces within 1 %, symmetric mean NN distance <= 0.1 voxel), a plain
callable (the analytic sphere) with and without grad_fn, and
filter_faces_by_udf with and without the per-point bias (kept faces equal
except where a point's f32 UDF lies within 1e-5 of the threshold)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.pipelines import MeshExtractionConfig as JaxConfig
from surfd_tpu.pipelines import filter_faces_by_udf as jax_filter
from surfd_tpu.pipelines import get_mesh_from_udf as jax_get_mesh
from surfd_tpu.pipelines import get_watertight_mesh_from_udf as jax_watertight
from surfd_tpu.pipelines.generate import make_field_bias_at as jax_bias_at
from surfd_tpu_torch import native
from surfd_tpu_torch.geometry import (
    TorchField,
    make_grad_fn,
    marching_tetrahedra_udf,
    sphere_fields,
)
from surfd_tpu_torch.geometry.marching import int8_units, settled_int8_units
from surfd_tpu_torch.pipelines import (
    MeshExtractionConfig,
    filter_faces_by_udf,
    get_mesh_from_udf,
    get_watertight_mesh_from_udf,
    make_field_bias_at,
)
from test_torch_pipeline import (  # noqa: F401
    MAX_DIST,
    R,
    VOXEL,
    _assert_meshes_agree,
    _mean_nn_chamfer,
    bound,
    decoders,
)

KW = dict(resolution=R, max_dist=MAX_DIST, max_batch=2**14, face_filter_mult=4.0)
SETTINGS = {
    "unquantised": dict(quantized_filter_points=False),
    "no filter": dict(filter_faces=False),
    "no stabilize": dict(do_stabilize=False),
    "no border smoothing": dict(do_smooth_borders=False),
    "no cleanup": dict(do_stabilize=False, do_smooth_borders=False),
    "no filter, no cleanup": dict(filter_faces=False, do_stabilize=False, do_smooth_borders=False),
    "single tier": dict(two_tier_filter=False),
    "band override": dict(two_tier_band=5e-3),
    "wide band": dict(two_tier_band=1.0),
    "coords range": dict(coords_range=(-1.1, 1.1)),
    "laplacian and components": dict(filter_faces=False, final_laplacian_iters=2,
                                     min_component_faces=50),
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _dense(g):
    """A dense (R, R, R, 3) gradient array as marching's gradient starter."""
    flat = np.ascontiguousarray(g, dtype=np.float32).reshape(-1, 3)
    return lambda gids: (lambda: flat[gids])


def test_config_fields_match_jax():
    """Every field of JAX's config, its device mesh included, with its default."""
    want = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    got = {f.name: f.default for f in dataclasses.fields(MeshExtractionConfig)}
    assert got == want


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_setting_matches_jax(bound, setting):
    jfn, tfn, _ = bound
    kw = dict(KW, **SETTINGS[setting])
    jm, js_ = jax_get_mesh(jfn, cfg=JaxConfig(**kw), return_stats=True)
    tm, ts = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**kw), return_stats=True)
    _assert_meshes_agree(jm, tm)
    assert ts["oob_vertices"] == js_.get("oob_vertices", 0) == 0
    assert ts["raw_faces"] == pytest.approx(js_["raw_faces"], rel=0.01)
    lo, hi = kw.get("coords_range", (-1.0, 1.0))
    assert tm.vertices.min() >= lo - 2 * VOXEL and tm.vertices.max() <= hi + 2 * VOXEL


def test_setting_stats(bound):
    """Which filter ran: two tiers with the calibrated or given band while
    it is under a quarter of the threshold; one f32 tier otherwise, and on
    exact points without quantised ones."""
    _, tfn, _ = bound
    runs = {name: get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**KW, **SETTINGS[name]),
                                    return_stats=True)[1]
            for name in ("unquantised", "single tier", "band override", "wide band")}
    default = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**KW), return_stats=True)[1]
    thr = 4.0 / R
    assert default["ff_band"] == tfn.two_tier_band(tfn.queries)
    assert default["ff_two_tier"] == (tfn.two_tier_band(tfn.queries) < 0.25 * thr)
    assert runs["band override"]["ff_band"] == 5e-3 and runs["band override"]["ff_two_tier"]
    assert runs["band override"]["ff_unsure"] > 0
    assert not runs["wide band"]["ff_two_tier"] and "ff_unsure" not in runs["wide band"]
    assert not runs["single tier"]["ff_two_tier"] and runs["single tier"]["ff_band"] is None
    assert not runs["unquantised"]["ff_two_tier"] and runs["unquantised"]["ff_band"] is None


def test_two_tier_mesh_equals_single_tier(bound):
    """The engaged two-tier filter gives the single-tier mesh bit for bit."""
    _, tfn, _ = bound
    two, ts = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**KW, two_tier_band=5e-3),
                                return_stats=True)
    one = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**KW, two_tier_filter=False))
    assert ts["ff_two_tier"] and ts["ff_unsure"] > 0
    np.testing.assert_array_equal(two.vertices, one.vertices)
    np.testing.assert_array_equal(two.faces, one.faces)


def test_unquantised_with_bias_field(bound):
    """surface_bias="auto" on the unquantised filter: the per-point field
    (the port's deviation; JAX widens by the median) against the default's
    u16 points and uint8 table — the same surface."""
    _, tfn, _ = bound
    kw = dict(KW, surface_bias="auto")
    a = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**kw))
    b = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**kw, quantized_filter_points=False))
    assert abs(len(a.faces) - len(b.faces)) <= 0.01 * len(a.faces)
    assert _mean_nn_chamfer(a.vertices, b.vertices) <= 0.1 * VOXEL


def test_watertight_coords_range(bound):
    jfn, tfn, _ = bound
    kw = dict(KW, surface_bias="auto", coords_range=(-1.1, 1.1))
    want = jax_watertight(jfn, JaxConfig(**kw))
    got = get_watertight_mesh_from_udf(tfn, MeshExtractionConfig(**kw))
    assert len(want.faces) > 1000
    assert abs(len(got.faces) - len(want.faces)) <= 0.01 * len(want.faces)
    assert _mean_nn_chamfer(got.vertices, want.vertices) <= 0.1 * 2.0 / (R - 1)


# --- plain callables ------------------------------------------------------

def _jax_sphere(p):
    return jnp.abs(jnp.linalg.norm(p, axis=-1) - 0.6)


def test_plain_callable_matches_jax():
    """The analytic sphere as a plain callable, without grad_fn: make_grad_fn
    gradients and the exact-point filter in both packages."""
    kw = dict(resolution=48, max_batch=2**14)
    jm, js_ = jax_get_mesh(_jax_sphere, cfg=JaxConfig(**kw), return_stats=True)
    tm, ts = get_mesh_from_udf(TorchField("sphere", "cpu"), cfg=MeshExtractionConfig(**kw),
                               return_stats=True)
    assert len(jm.faces) > 1000
    assert abs(len(tm.faces) - len(jm.faces)) <= 0.01 * len(jm.faces)
    assert _mean_nn_chamfer(tm.vertices, jm.vertices) <= 0.1 * 2.0 / 47
    assert ts["ff_two_tier"] is False and ts["ff_band"] is None
    assert "ff_prep" in ts["times"]


def test_plain_callable_grad_fn_forms():
    """An autograd grad_fn, one that reads the dense analytic gradients at
    the grid node, and none at all give one mesh; the device comes from the
    field's `device`, also on a plain function."""
    kw = dict(resolution=40, max_batch=2**14)
    field = TorchField("sphere", "cpu")
    cfg = MeshExtractionConfig(**kw)
    want = get_mesh_from_udf(field, cfg=cfg)
    _, _, grad, _ = sphere_fields(40)
    flat = torch.from_numpy(grad.reshape(-1, 3))

    def at_node(p):
        idx = torch.round((p + 1.0) * (39 / 2.0)).long().clamp(0, 39)
        return flat[(idx[:, 0] * 40 + idx[:, 1]) * 40 + idx[:, 2]]

    bare = lambda p: field(p)  # noqa: E731
    bare.device = "cpu"
    for g, f in ((make_grad_fn(field), field), (at_node, field), (make_grad_fn(field), bare)):
        got = get_mesh_from_udf(f, g, cfg=cfg)
        assert abs(len(got.faces) - len(want.faces)) <= 0.01 * len(want.faces)
        assert _mean_nn_chamfer(got.vertices, want.vertices) <= 0.1 * 2.0 / 39


def test_plain_callable_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_mesh_from_udf(lambda p: p.norm(dim=-1), cfg=MeshExtractionConfig(resolution=16))
    # grad_fn does not name the device: the field does
    with pytest.raises(RuntimeError, match="CUDA"):
        get_mesh_from_udf(lambda p: p.norm(dim=-1), make_grad_fn(TorchField("sphere", "cpu")),
                          cfg=MeshExtractionConfig(resolution=16))


def test_config_passed_as_grad_fn_raises(bound):
    _, tfn, _ = bound
    with pytest.raises(TypeError, match="cfg="):
        get_mesh_from_udf(tfn, MeshExtractionConfig(resolution=16))


# --- filter_faces_by_udf --------------------------------------------------

def _raw_mesh(tfn):
    """The 64³ marching mesh of the sphere decoder, unfiltered."""
    return get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**KW, filter_faces=False,
                                                           do_stabilize=False,
                                                           do_smooth_borders=False))


@pytest.mark.parametrize("biased", [False, True])
def test_filter_faces_by_udf_matches_jax(bound, biased):
    jfn, tfn, _ = bound
    mesh = _raw_mesh(tfn)
    pts, einv = native.face_filter_prep(mesh.vertices, mesh.faces)
    u = tfn.queries.fetch(tfn, pts)
    bias_at = jbias = None
    if biased:
        nb = 8
        field = np.random.default_rng(9).uniform(0, 0.01, (nb, nb, nb)).astype(np.float32)
        bias_at = make_field_bias_at(field, -1.0, (R // nb) * VOXEL)
        jbias = jax_bias_at(field, -1.0, (R // nb) * VOXEL)
        np.testing.assert_array_equal(bias_at(pts), jbias(pts))
        u = u - bias_at(pts)
    thr = float(np.quantile(u, 0.8))
    got = filter_faces_by_udf(mesh, tfn, thr, tfn.queries, bias_at=bias_at)
    want = jax_filter(mesh, jfn, thr, chunk=2**14, bias_at=jbias)
    # faces one package keeps and the other drops must touch a point within
    # 1e-5 of the threshold (one f32 rounding apart in the two decoders)
    near = np.abs(u - thr) <= 1e-5
    V = len(mesh.vertices)
    touches = near[mesh.faces].any(axis=1) | near[V + einv].any(axis=1)
    key = lambda f: set(map(tuple, f))
    differ = key(got.faces) ^ key(want.faces)
    faces_near = key(mesh.faces[touches])
    assert differ <= faces_near
    assert near.sum() <= 0.01 * len(u)  # the count of such points stays small
    assert 0.1 * len(mesh.faces) < len(got.faces) < 0.9 * len(mesh.faces)
    np.testing.assert_array_equal(got.vertices, mesh.vertices)


def test_filter_faces_by_udf_equals_fused_mask(bound):
    """filter_faces_by_udf keeps exactly the faces the unquantised fused
    filter's mask keeps (native prep, the same f32 values)."""
    _, tfn, _ = bound
    mesh = _raw_mesh(tfn)
    pts, einv = native.face_filter_prep(mesh.vertices, mesh.faces)
    thr = float(np.median(tfn.queries.fetch(tfn, pts)))
    ok = tfn.queries.fetch(tfn, pts) <= thr
    fused = mesh.faces[ok[mesh.faces].all(axis=1) & ok[len(mesh.vertices) + einv].all(axis=1)]
    np.testing.assert_array_equal(filter_faces_by_udf(mesh, tfn, thr, tfn.queries).faces, fused)


@pytest.mark.parametrize("surface_bias", [0.0, "auto"])
def test_filter_faces_by_udf_equals_program_unquantised(bound, surface_bias):
    """filter_faces_by_udf and the vertex merge on the raw mesh give the
    mesh of get_mesh_from_udf's unquantised filter without cleanup (its
    unreferenced vertices aside): the per-point bias field where it is
    non-zero, else the scalar bias."""
    from surfd_tpu_torch.geometry import merge_duplicate_vertices, remove_unreferenced_vertices

    _, tfn, _ = bound
    kw = dict(KW, surface_bias=surface_bias, do_stabilize=False, do_smooth_borders=False)
    raw, stats = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**kw, filter_faces=False),
                                   return_stats=True)
    prog = remove_unreferenced_vertices(
        get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**kw, quantized_filter_points=False)))
    field = stats.get("surface_bias_field")
    thr = KW["face_filter_mult"] / R
    if field is not None and float(field.max()) > 0:
        bias_at = make_field_bias_at(field, -1.0, (R // field.shape[0]) * VOXEL)
    else:
        bias_at = None
        thr += 0.0 if field is not None else float(stats.get("surface_bias") or 0.0)
    kept = filter_faces_by_udf(raw, tfn, thr, tfn.queries, bias_at=bias_at)
    kept = merge_duplicate_vertices(remove_unreferenced_vertices(kept))
    assert 1000 < len(kept.faces) < len(raw.faces)
    np.testing.assert_array_equal(kept.vertices, prog.vertices)
    np.testing.assert_array_equal(kept.faces, prog.faces)


def test_filter_faces_by_udf_empty(bound):
    _, tfn, _ = bound
    empty = marching_tetrahedra_udf(np.ones((8, 8, 8), np.float32),
                                    _dense(np.zeros((8, 8, 8, 3), np.float32)))
    assert len(filter_faces_by_udf(empty, tfn, 0.1, tfn.queries).faces) == 0


def test_dense_and_lazy_gradients_agree(bound):
    """fill_gradients over make_grad_fn takes the nodes where the fill and
    the gradient query by grid id take them: at every active-cube corner
    both routes round to the same int8 unit, and native marching on the
    dense grid gives the by-id route's mesh."""
    from surfd_tpu_torch.geometry import GridFiller

    _, tfn, _ = bound
    gf = GridFiller(R, max_dist=MAX_DIST, queries=tfn.queries)
    grid, stats = gf.fill(tfn, return_stats=True)
    dense = gf.fill_gradients(make_grad_fn(tfn), grid)
    _, corners = native.mt_active_cubes(grid, 1.74 * VOXEL, 1.05 * VOXEL)
    g = dense.reshape(-1, 3)[corners]
    lazy = lambda gids: tfn.grad_i8_gid_async(gids, R, -1.0, VOXEL, tfn.queries)  # noqa: E731
    np.testing.assert_array_equal(int8_units(g), lazy(corners)())
    d8 = np.zeros_like(dense.reshape(-1, 3))
    d8[corners] = lazy(corners)()
    a = marching_tetrahedra_udf(grid, _dense(d8))
    b = marching_tetrahedra_udf(grid, lazy, active_blocks=(stats["ab"], stats["block"]))
    assert len(a.faces) > 1000
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


def test_settled_int8_units_are_read_alike(bound):
    """settled_int8_units is a fixed point of int8_units, and on it the
    numpy marching path gives as many faces as the native passes, with
    vertex Hausdorff < 1e-5 (the int8 check of chip_smoke.py's phase
    settings (c))."""
    from surfd_tpu_torch.geometry import GridFiller, hausdorff_distance

    _, tfn, _ = bound
    gf = GridFiller(R, max_dist=MAX_DIST, queries=tfn.queries)
    grid = gf.fill(tfn)
    dense = gf.fill_gradients(make_grad_fn(tfn), grid)
    g8 = settled_int8_units(dense)
    assert g8.shape == dense.shape
    np.testing.assert_array_equal(int8_units(g8).astype(np.float32), g8)
    a = marching_tetrahedra_udf(grid, _dense(g8), use_native=False)
    b = marching_tetrahedra_udf(grid, _dense(g8))
    assert len(a.faces) == len(b.faces) > 1000
    assert hausdorff_distance(a.vertices, b.vertices) < 1e-5


# --- the native bindings this slice adds ---------------------------------

def test_finalize_mesh_matches_numpy_chain(bound):
    """native.finalize_mesh is the numpy chain filter → stabilize →
    smooth_borders → merge: the same face count and vertex set to 1e-6."""
    from surfd_tpu_torch.geometry import (
        merge_duplicate_vertices,
        remove_unreferenced_vertices,
        smooth_borders,
        stabilize,
    )

    _, tfn, _ = bound
    mesh = _raw_mesh(tfn)
    pts, einv = native.face_filter_prep(mesh.vertices, mesh.faces)
    u = tfn.queries.fetch(tfn, pts)
    thr = float(np.quantile(u, 0.8))
    v, f = native.finalize_mesh(mesh.vertices, mesh.faces, u <= thr, einv)
    m = remove_unreferenced_vertices(filter_faces_by_udf(mesh, tfn, thr, tfn.queries))
    m = merge_duplicate_vertices(smooth_borders(stabilize(m, assume_clean=True)))
    assert len(f) == len(m.faces) > 1000
    assert _mean_nn_chamfer(v, m.vertices) <= 1e-6


def test_native_bindings_check_arguments():
    v = np.zeros((3, 3), np.float32)
    f = np.array([[0, 1, 2]], np.int64)
    with pytest.raises(ValueError, match="out of range"):
        native.face_filter_prep(v, f + 1)
    with pytest.raises(ValueError, match="faces"):
        native.face_filter_prep(v, f[:, :2])
    pts, einv = native.face_filter_prep(v, f)
    assert pts.shape == (6, 3) and einv.shape == (1, 3)
    with pytest.raises(ValueError, match="ok has"):
        native.finalize_mesh(v, f, np.ones(5, np.uint8), einv)
    with pytest.raises(ValueError, match="einv"):
        native.finalize_mesh(v, f, np.ones(6, np.uint8), einv[:, :2])
