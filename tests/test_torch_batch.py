"""The batch generator: meshes pipelined two deep equal the sequential ones
bit for bit and in order (open and watertight), stats ride along, the
front door reports each mesh as it comes, and nothing in gives nothing out.
The 64×2 sphere decoder at 48³, three latents."""

import numpy as np
import pytest
import torch

from surfd_tpu_torch.pipelines import (
    MeshExtractionConfig,
    generate_meshes,
    generate_meshes_pipelined,
    get_mesh_from_udf,
    get_watertight_mesh_from_udf,
    make_udf_fn,
)
from test_torch_pipeline import LATENT, MAX_DIST, decoders  # noqa: F401

CFG = MeshExtractionConfig(resolution=48, max_dist=MAX_DIST, max_batch=2**14,
                           face_filter_mult=4.0, surface_bias="auto")


@pytest.fixture(scope="module")
def latents():
    return (np.random.default_rng(12).normal(size=(3, LATENT)) * 0.5).astype(np.float32)


def _fns(dec, latents):
    return (make_udf_fn(dec, None, lat, MAX_DIST, device="cpu", chunk=2**14) for lat in latents)


def _assert_same(a, b):
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        assert len(ma.faces) > 100
        np.testing.assert_array_equal(ma.vertices, mb.vertices)
        np.testing.assert_array_equal(ma.faces, mb.faces)


@pytest.mark.parametrize("watertight", [False, True])
def test_depth_two_equals_depth_one(decoders, latents, watertight):
    torch.set_num_threads(1)
    dec = decoders[0]
    runs = {d: list(generate_meshes_pipelined(_fns(dec, latents), CFG, watertight=watertight,
                                              depth=d)) for d in (1, 2)}
    _assert_same(runs[1], runs[2])
    # in input order: the k-th mesh is the k-th latent's
    extract = get_watertight_mesh_from_udf if watertight else get_mesh_from_udf
    one = extract(next(_fns(dec, latents[1:])), cfg=CFG)
    _assert_same([runs[2][1]], [one])
    assert len({len(m.faces) for m in runs[2]}) == 3  # the latents give three meshes


def test_return_stats(decoders, latents):
    torch.set_num_threads(1)
    out = list(generate_meshes_pipelined(_fns(decoders[0], latents[:2]), CFG, depth=2,
                                         return_stats=True))
    assert len(out) == 2
    for mesh, stats in out:
        assert stats["final_faces"] == len(mesh.faces)
        assert "grid_fill" in stats["times"]
    (mesh, stats), = generate_meshes_pipelined(_fns(decoders[0], latents[:1]), CFG,
                                               watertight=True, return_stats=True)
    assert stats["final_faces"] == len(mesh.faces)


def test_generate_meshes_on_mesh(decoders, latents):
    torch.set_num_threads(1)
    seen = []
    out = generate_meshes(decoders[0], latents[:2], CFG, pipelined=True, max_dist=MAX_DIST,
                          on_mesh=lambda k, m: seen.append((k, len(m.faces))), device="cpu")
    assert seen == [(k, len(m.faces)) for k, m in enumerate(out)]
    _assert_same(out, list(generate_meshes_pipelined(_fns(decoders[0], latents[:2]), CFG)))


def test_empty_iterable():
    assert list(generate_meshes_pipelined(iter(()), CFG, depth=2)) == []
    assert generate_meshes(None, [], CFG, device="cpu") == []


def test_generate_meshes_raises_without_cuda(decoders, latents):
    """CUDA unless the caller names another device; no silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_meshes(decoders[0], latents[:1], CFG)
