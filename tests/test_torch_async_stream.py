"""The overlapped grid-query stream on the CPU: `QueryStream.start`
against `QueryStream.fetch` and JAX's `eval_in_chunks_async`; the
extraction's schedule (the gradient query started before marching's corner
ranks, the vertex query before the face filter's edge pass, the midpoint
query after it, both fetched after); the async extraction's mesh against
the synchronous one (`QueryStream.start` replaced by a blocking closure)
bit for bit, and against JAX's within the parity bars (faces 1 %, mean NN
0.1 voxel); the sharded async stream at world 2 against the unsharded one.

On the CPU the async route computes at once, so these tests hold its
results and its order of calls; that the device overlaps the host shows
only in the card's stage times (chip_smoke.py, phase extract)."""

import jax
import numpy as np
import pytest
import torch

from surfd_tpu.geometry import eval_in_chunks_async as jax_eval_in_chunks_async
from surfd_tpu.pipelines import MeshExtractionConfig as JaxConfig
from surfd_tpu.pipelines import get_mesh_from_udf as jax_get_mesh
from surfd_tpu_torch import native
from surfd_tpu_torch.geometry import QueryStream
from surfd_tpu_torch.geometry.grid import to_device
from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf
from test_torch_parallel import _jax_test_decoder, run_world
from test_torch_pipeline import (  # noqa: F401  (fixtures)
    MAX_DIST,
    R,
    _assert_meshes_agree,
    bound,
    decoders,
)


def _affine(p):
    return p[:, 0] * 2.0 + p[:, 1] - p[:, 2]


@pytest.mark.parametrize("n,chunk", [(1000, 256), (4096, 4096), (777, 100), (0, 64)])
def test_async_equals_sync_and_jax(n, chunk):
    """The same values whether fetched at once or later, from a host array
    or a CPU tensor, and JAX's async stream's on the same points, bit for
    bit (2x + y − z is rounded alike by both)."""
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    queries = QueryStream("cpu", chunk)
    pending = queries.start(_affine, pts)
    sync = queries.fetch(_affine, pts)
    got = pending()
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got, sync)
    np.testing.assert_array_equal(queries.start(_affine, torch.from_numpy(pts))(), sync)
    if n:
        want = jax_eval_in_chunks_async(jax.jit(lambda p: p[:, 0] * 2.0 + p[:, 1] - p[:, 2]),
                                        pts, chunk)()
        np.testing.assert_array_equal(got, want)


def test_async_rows_and_kinds():
    """Bool, int8 and several-values-a-point outputs keep dtype and shape."""
    pts = np.random.default_rng(1).normal(size=(500, 3)).astype(np.float32)
    fns = {"bool": (lambda p: p[:, 0] > 0, np.bool_, (500,)),
           "int8": (lambda p: torch.round(p * 50).to(torch.int8), np.int8, (500, 3)),
           "pair": (lambda p: torch.stack([p[:, 0] > 0, p[:, 1] > 0], 1), np.bool_, (500, 2))}
    queries = QueryStream("cpu", 128)
    for name, (fn, dtype, shape) in fns.items():
        got = queries.start(fn, pts)()
        assert got.dtype == dtype and got.shape == shape, name
        np.testing.assert_array_equal(got, queries.fetch(fn, pts))


def _blocking(self, fn, pts):
    """The synchronous stream behind QueryStream.start's interface."""
    pts = pts if torch.is_tensor(pts) else to_device(pts, self.device)
    res = self.run(fn, pts).detach().cpu().numpy()
    return lambda: res


def _same_mesh(a, b) -> bool:
    """Equal vertices and equal oriented faces, whatever their order."""
    def canonical(m):
        order = np.lexsort(m.vertices.T[::-1])
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        f = rank[m.faces]
        r = np.argmin(f, axis=1)[:, None]
        f = np.take_along_axis(f, (r + np.arange(3)) % 3, axis=1)
        return m.vertices[order], f[np.lexsort(f.T[::-1])]

    (va, fa), (vb, fb) = canonical(a), canonical(b)
    return np.array_equal(va, vb) and np.array_equal(fa, fb)


SETTINGS = {"default": {}, "auto_bias": {"surface_bias": "auto"},
            "single_tier": {"two_tier_filter": False}}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_sphere_async_mesh_equals_sync_and_jax(bound, monkeypatch, setting):  # noqa: F811
    """The sphere decoder at 64³: the async mesh equals the synchronous one
    bit for bit, and JAX's within faces 1 % and mean NN 0.1 voxel."""
    jfn, tfn, _ = bound
    kw = dict(resolution=R, max_dist=MAX_DIST, max_batch=2**14, face_filter_mult=4.0,
              **SETTINGS[setting])
    jm = jax_get_mesh(jfn, cfg=JaxConfig(**kw))
    am, stats = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**kw), return_stats=True)
    assert "ff_fetch" in stats["times"] and "ff_prep" in stats["times"]
    monkeypatch.setattr(QueryStream, "start", _blocking)
    sm = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**kw))
    assert _same_mesh(am, sm)
    _assert_meshes_agree(jm, am)
    if setting == "default":
        assert stats["ff_two_tier"]  # the tier-1 query and the re-query ran async


def test_extraction_schedule(bound, monkeypatch):  # noqa: F811
    """The order of the host passes and the queries: the gradient query
    starts before mt_corner_ranks and is fetched after it; the vertex query
    starts before face_filter_prep_q16, the midpoint query after it, and
    both are fetched after both started."""
    _, tfn, _ = bound
    log = []
    real = QueryStream.start

    def started(self, fn, pts):
        n = sum(e.startswith("start") for e in log)
        log.append(f"start{n}")
        pending = real(self, fn, pts)

        def fetch():
            log.append(f"fetch{n}")
            return pending()

        return fetch

    def logged(name, f):
        def g(*a, **k):
            log.append(name)
            return f(*a, **k)
        return g

    monkeypatch.setattr(QueryStream, "start", started)
    monkeypatch.setattr(native, "mt_corner_ranks", logged("ranks", native.mt_corner_ranks))
    monkeypatch.setattr(native, "face_filter_prep_q16",
                        logged("prep", native.face_filter_prep_q16))
    get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(resolution=R, max_dist=MAX_DIST,
                                                    max_batch=2**14, face_filter_mult=4.0,
                                                    two_tier_filter=False))
    assert log == ["start0", "ranks", "fetch0", "start1", "prep", "start2", "fetch1", "fetch2"]


def test_sharded_async_stream_equals_unsharded(tmp_path):
    """World 2 over gloo: QueryStream.start over the data ranks equals the
    unsharded stream at atol 0 (checked in each rank: three output kinds,
    three slice counts, and the int8 gradients by grid id); the ranks agree."""
    sd, lats = _jax_test_decoder()
    rng = np.random.default_rng(0)
    inputs = {"pts": rng.uniform(-1, 1, (5000, 3)).astype(np.float32), "decoder": sd,
              "latent": lats[0], "gids": np.sort(rng.choice(48**3, 10_000, replace=False))}
    res = run_world("async_chunks", 2, tmp_path, inputs)
    assert res[0].keys() == res[1].keys()
    for k in res[0]:
        np.testing.assert_array_equal(res[0][k], res[1][k])
