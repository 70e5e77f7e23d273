"""The reconstruction metrics against the JAX package's, which are numpy on
both sides: the closest-point binding bit for bit, each metric equal to JAX's
within 1e-12 on seeded clouds and meshes (the brute-force path below 10^6
pairs and the KD-tree path above), and the samplers bit for bit on the same
rng."""

import numpy as np
import pytest

from surfd_tpu import native as jnative
from surfd_tpu.data.datasets import random_point_sampling as jax_random_point_sampling
from surfd_tpu.data.preprocess import sample_points_on_mesh as jax_sample_points_on_mesh
from surfd_tpu.geometry import metrics as jmetrics
from surfd_tpu.geometry.marching import Mesh as JaxMesh
from surfd_tpu_torch import native
from surfd_tpu_torch.data import random_point_sampling, sample_points_on_mesh
from surfd_tpu_torch.geometry import Mesh
from surfd_tpu_torch.geometry import metrics

TOL = 1e-12


def _sheet(seed: int, n: int = 24, amp: float = 0.1):
    """A seeded open height-field sheet over [-0.8, 0.8]², 2(n−1)² faces."""
    rng = np.random.default_rng(seed)
    u = np.linspace(-0.8, 0.8, n)
    x, y = np.meshgrid(u, u, indexing="ij")
    z = amp * np.sin(3 * x + rng.uniform(0, 6)) * np.cos(2 * y) + 0.01 * rng.normal(size=x.shape)
    v = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (i * n + j).ravel()
    f = np.concatenate([np.stack([a, a + n, a + 1], 1), np.stack([a + 1, a + n, a + n + 1], 1)])
    return v, f.astype(np.int64)


def _meshes(seed):
    v, f = _sheet(seed)
    return Mesh(v, f), JaxMesh(v, f)


def _cloud(seed, n):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


def test_closest_points_bit_equal():
    v, f = _sheet(0)
    q = _cloud(1, 5000)
    got = native.closest_points(v, f, q)
    want = jnative.closest_points(v, f, q)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].min() >= 0 and len(np.unique(got[2])) > 100
    with pytest.raises(ValueError, match="out of range"):
        native.closest_points(v, f + 1, q)  # the last index names no vertex
    with pytest.raises(ValueError, match="queries"):
        native.closest_points(v, f, q[:, :2])


@pytest.mark.parametrize("na,nb", [(500, 400), (1500, 1200)])  # brute force; KD-tree (>1e6 pairs)
def test_point_set_metrics_equal_jax(na, nb):
    a, b = _cloud(2, na), 0.9 * _cloud(3, nb)
    for name in ("chamfer_distance", "hausdorff_distance", "f_score"):
        for chunk in (4096, 37):
            got = getattr(metrics, name)(a, b, chunk=chunk)
            want = getattr(jmetrics, name)(a, b, chunk=chunk)
            assert abs(got - want) <= TOL, (name, chunk, got, want)
    for thr in (0.01, 0.05):
        assert abs(metrics.f_score(a, b, thr) - jmetrics.f_score(a, b, thr)) <= TOL
    np.testing.assert_array_equal(metrics._nn_dists(a, b, 64), jmetrics._nn_dists(a, b, 64))


def test_mesh_metrics_equal_jax():
    (m1, j1), (m2, j2) = _meshes(4), _meshes(5)
    q = _cloud(6, 3000)
    np.testing.assert_array_equal(metrics.point_mesh_distances(q, m1),
                                  jmetrics.point_mesh_distances(q, j1))
    for n, thr in ((4096, 0.01), (2000, 0.05)):
        got = metrics.mesh_surface_metrics(m1, m2, n=n, threshold=thr,
                                           rng=np.random.default_rng(7))
        want = jmetrics.mesh_surface_metrics(j1, j2, n=n, threshold=thr,
                                             rng=np.random.default_rng(7))
        assert list(got) == list(want)
        for k in got:
            assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
    assert 0 < got["precision"] < 1  # the two sheets partly overlap at 0.05


def test_one_nn_accuracy_equal_jax():
    rng = np.random.default_rng(8)
    s = [rng.normal(size=(300, 3)).astype(np.float32) for _ in range(3)]
    r = [rng.normal(size=(300, 3)).astype(np.float32) + 0.3 for _ in range(3)]
    assert metrics.one_nn_accuracy(s, r) == jmetrics.one_nn_accuracy(s, r)
    with pytest.raises(ValueError):
        metrics.one_nn_accuracy(s[:1], [])


def test_samplers_bit_equal_jax():
    m, j = _meshes(9)
    for n in (1, 1000):
        np.testing.assert_array_equal(sample_points_on_mesh(m, n, np.random.default_rng(n)),
                                      jax_sample_points_on_mesh(j, n, np.random.default_rng(n)))
    pcd = _cloud(10, 2000)
    for n in (500, 2000, 3000):  # without replacement, all, with replacement
        np.testing.assert_array_equal(
            random_point_sampling(pcd, n, np.random.default_rng(11)),
            jax_random_point_sampling(pcd, n, np.random.default_rng(11)))
    flat = Mesh(np.zeros((3, 3), np.float32), np.array([[0, 1, 2]]))
    with pytest.raises(ValueError, match="zero surface area"):
        sample_points_on_mesh(flat, 4, np.random.default_rng(0))
