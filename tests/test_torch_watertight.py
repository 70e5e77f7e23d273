"""Watertight-path parity: signed marching tetrahedra and
keep_largest_component against the JAX package (numpy on both sides, so
equal bit for bit), and get_watertight_mesh_from_udf with the 64×2 sphere
decoder at 64³ (faces within 1 %, symmetric mean NN distance ≤ 0.1 voxel).

The iso-0.01 shell of the sphere decoder's UDF has two sheets (r ≈ 0.6 ±
0.01); the component with the longer bounding-box diagonal, the outer one,
is kept."""

import numpy as np
import pytest
import torch

from surfd_tpu.geometry import marching as jmarch
from surfd_tpu.geometry import mesh_ops as jops
from surfd_tpu.pipelines import MeshExtractionConfig as JaxConfig
from surfd_tpu.pipelines import get_watertight_mesh_from_udf as jax_watertight
from surfd_tpu_torch.geometry import keep_largest_component, marching_tetrahedra
from surfd_tpu_torch.geometry.mesh_ops import face_components
from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_watertight_mesh_from_udf
from test_torch_pipeline import MAX_DIST, _mean_nn_chamfer, bound, decoders  # noqa: F401


def _grid(R):
    xs = np.linspace(-1.0, 1.0, R, dtype=np.float32)
    return np.meshgrid(xs, xs, xs, indexing="ij")


def _field(kind, R):
    x, y, z = _grid(R)
    if kind == "sphere":
        return (np.sqrt(x * x + y * y + z * z) - 0.55).astype(np.float32)
    if kind == "torus":
        return (np.sqrt((np.sqrt(x * x + y * y) - 0.5) ** 2 + z * z) - 0.2).astype(np.float32)
    if kind == "blobs":  # hundreds of components
        return (np.sin(9 * x + 0.3) * np.sin(9 * y) * np.sin(9 * z + 0.7) - 0.5).astype(np.float32)
    # a thin torus (the longer bbox diagonal) beside a sphere (more faces)
    a = np.sqrt((np.sqrt((x + 0.4) ** 2 + y * y) - 0.5) ** 2 + z * z) - 0.07
    b = np.sqrt((x - 0.6) ** 2 + y * y + z * z) - 0.35
    return np.minimum(a, b).astype(np.float32)


def _assert_equal(got, want):
    assert got.vertices.dtype == want.vertices.dtype and got.faces.dtype == want.faces.dtype
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)


@pytest.mark.parametrize("kind", ["sphere", "torus"])
@pytest.mark.parametrize("R", [32, 48])
@pytest.mark.parametrize("iso", [0.0, 0.01, 0.07])
def test_signed_marching_equals_jax(kind, R, iso):
    vals = _field(kind, R)
    want = jmarch.marching_tetrahedra(vals, iso=iso)
    got = marching_tetrahedra(vals, iso=iso)
    assert len(want.faces) > 100
    _assert_equal(got, want)


def test_signed_marching_empty():
    got = marching_tetrahedra(np.ones((8, 8, 8), np.float32), iso=0.01)
    assert got.vertices.shape == (0, 3) and got.faces.shape == (0, 3)
    with pytest.raises(ValueError):
        marching_tetrahedra(np.ones((8, 8, 4), np.float32))


@pytest.mark.parametrize("by_bbox", [False, True])
def test_keep_largest_component_equals_jax(by_bbox):
    mesh = jmarch.marching_tetrahedra(_field("two", 48), iso=0.0)
    assert face_components(mesh.faces, len(mesh.vertices)).max() == 1  # two components
    want = jops.keep_largest_component(mesh, by_bbox=by_bbox)
    got = keep_largest_component(mesh, by_bbox=by_bbox)
    _assert_equal(got, want)
    kept_torus = float(got.vertices[:, 0].min()) < 0.0
    assert kept_torus == by_bbox


@pytest.mark.parametrize("by_bbox", [False, True])
def test_keep_largest_of_many_components_equals_jax(by_bbox):
    mesh = jmarch.marching_tetrahedra(_field("blobs", 40), iso=0.0)
    assert face_components(mesh.faces, len(mesh.vertices)).max() > 100
    _assert_equal(keep_largest_component(mesh, by_bbox=by_bbox),
                  jops.keep_largest_component(mesh, by_bbox=by_bbox))


def test_watertight_mesh_matches_jax(bound):
    jfn, tfn, _ = bound
    R = 64
    kw = dict(resolution=R, max_dist=MAX_DIST, max_batch=2**14, surface_bias="auto")
    want = jax_watertight(jfn, JaxConfig(**kw))
    torch.set_num_threads(1)
    got, stats = get_watertight_mesh_from_udf(tfn, MeshExtractionConfig(**kw), return_stats=True)
    assert len(want.faces) > 1000
    assert abs(len(got.faces) - len(want.faces)) <= 0.01 * len(want.faces)
    assert _mean_nn_chamfer(got.vertices, want.vertices) <= 0.1 * 2.0 / (R - 1)
    assert face_components(got.faces, len(got.vertices)).max() == 0
    assert float(np.abs(got.vertices).max()) == 1.0
    assert stats["final_faces"] == len(got.faces) < stats["raw_faces"]  # the inner sheet went
