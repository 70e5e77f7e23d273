"""The DGCNN encoder against the JAX package's: kNN neighbour sets (JAX's
blocked two-phase top-k and its single top-k, whole and tiled), the edge
features bit for bit, and the latents of one random Flax Dgcnn loaded
through both weight layouts (the Flax variables and the upstream state dict
that `export_dgcnn` writes), with and without the latent-index channel.

Neighbour ORDER is not compared: torch's top-k may order near-ties
differently, and both aggregations (max over the neighbours, then over the
points) and eval BatchNorm depend only on the set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.models import dgcnn as jdgcnn
from surfd_tpu.utils.torch_convert import export_dgcnn
from surfd_tpu_torch.models import Dgcnn, gather_graph_feature, knn_indices
from surfd_tpu_torch.models.dgcnn import auto_chunk
from surfd_tpu_torch.utils.convert import dgcnn_state_from_flax

torch.set_num_threads(2)

N, LATENT = 1000, 32
LATENT_TOL = 1e-5  # f32 sums in another order: ~1e-7 relative on O(1) latents


def _cloud(seed, n=N, b=1):
    return np.random.default_rng(seed).uniform(-1, 1, (b, n, 3)).astype(np.float32)


@pytest.mark.parametrize("k,jax_kw,chunk", [
    (20, {}, None),                       # JAX blocked (block 100), one tile
    (20, {"block": N}, None),             # JAX single top-k
    (8, {"chunk": 64}, 64),               # tiled (JAX: the divisor 50)
    (8, {"chunk": 256, "block": N}, 256),  # tiled, single top-k (JAX: 250)
])
def test_knn_neighbour_sets_equal_jax(k, jax_kw, chunk):
    pts = _cloud(0, b=2)
    want = np.asarray(jdgcnn.knn_indices(jnp.asarray(pts), k, **jax_kw))
    got = knn_indices(torch.from_numpy(pts), k, chunk=chunk).numpy()
    assert got.shape == want.shape == (2, N, k)
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1))
    # ascending distance: each point is its own nearest neighbour
    np.testing.assert_array_equal(got[..., 0], np.broadcast_to(np.arange(N), (2, N)))


def test_auto_chunk_matches_jax():
    for B, n in ((1, 10_000), (8, 10_000), (16, 10_000), (64, 20_000)):
        assert auto_chunk(B, n) == jdgcnn.auto_chunk(B, n)


def test_gather_graph_feature_exact():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, size=(2, 50, 6)).astype(np.int32)
    want = np.asarray(jdgcnn.gather_graph_feature(jnp.asarray(x), jnp.asarray(idx)))
    got = gather_graph_feature(torch.from_numpy(x), torch.from_numpy(idx).long()).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def flax_dgcnn():
    """A random Flax Dgcnn with every leaf drawn (weights, BatchNorm scales,
    shifts and running statistics), so that no layer is an identity."""
    model = jdgcnn.Dgcnn(size_latent=LATENT)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 3)))
    rng = np.random.default_rng(2)
    flat, tree = jax.tree_util.tree_flatten_with_path(variables)
    leaves = []
    for kp, leaf in flat:
        name = str(kp[-1])
        a = np.asarray(leaf)
        if "var" in name:
            a = rng.uniform(0.5, 2.0, a.shape)
        elif "scale" in name:
            a = rng.uniform(0.5, 1.5, a.shape)
        elif "kernel" in name:
            a = rng.normal(size=a.shape) / np.sqrt(a.shape[0])
        else:  # bias, mean
            a = 0.1 * rng.normal(size=a.shape)
        leaves.append(jnp.asarray(a, jnp.float32))
    return model, jax.tree_util.tree_unflatten(tree, leaves)


@pytest.mark.parametrize("layout", ["flax", "upstream"])
@pytest.mark.parametrize("with_index", [False, True])
def test_dgcnn_latents_match_jax(flax_dgcnn, layout, with_index):
    model, variables = flax_dgcnn
    pts = _cloud(3, b=2)
    index = np.array([3.0, 7.0], np.float32) if with_index else None
    want = np.asarray(model.apply(variables, jnp.asarray(pts),
                                  latent_index=None if index is None else jnp.asarray(index)))
    enc = Dgcnn(size_latent=LATENT)
    if layout == "flax":
        sd = dgcnn_state_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    else:
        sd = {k: torch.from_numpy(np.array(v)) for k, v in export_dgcnn(variables).items()}
    enc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(pts),
                  latent_index=None if index is None else torch.from_numpy(index)).numpy()
    assert got.shape == want.shape == (2, LATENT + int(with_index))
    assert np.abs(want).max() > 0.1  # the latent is not near zero
    np.testing.assert_allclose(got, want, rtol=0, atol=LATENT_TOL)
