"""Decoder parity: the port's CbnDecoder, folded evaluation (K1's plain
versions), weight bridge and autograd gradient against the JAX package on the
same weights and inputs (made with numpy from a seed). The kernel-vs-plain
checks are in test_torch_kernels_cuda.py."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.models import CbnDecoder as FlaxCbnDecoder
from surfd_tpu.models import CoordsEncoder
from surfd_tpu.models import udf_from_logits as jax_udf_from_logits
from surfd_tpu.ops import decoder_kernel as jdk
from surfd_tpu.utils.torch_convert import export_cbn_decoder
from surfd_tpu_torch.models import CbnDecoder, coords_encode, udf_from_logits
from surfd_tpu_torch.ops import decoder_kernel as dk
from surfd_tpu_torch.pipelines import make_udf_fn
from surfd_tpu_torch.utils.convert import (
    decoder_state_from_flax,
    load_sheet_fixture,
    strip_prefix,
)

LATENT, HIDDEN, LAYERS, MAX_DIST = 16, 64, 2, 0.1
FIXTURE = str(Path(__file__).resolve().parent.parent / "surfd_tpu/assets/bench_sheet_decoder.npz")


def _randomize(tree, rng, scale):
    """Every leaf replaced by seeded normals (running variances kept > 0)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, scale)
        elif k == "var":
            out[k] = (np.abs(rng.normal(size=v.shape)) + 0.5).astype(np.float32)
        else:
            out[k] = (rng.normal(size=v.shape) * scale).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """(flax module, flax variables as numpy, port CbnDecoder) with equal weights."""
    torch.set_num_threads(1)
    fdec = FlaxCbnDecoder(latent_dim=LATENT, hidden_dim=HIDDEN, num_hidden_layers=LAYERS)
    init = fdec.init(
        jax.random.PRNGKey(0), CoordsEncoder().encode(jnp.zeros((1, 8, 3))), jnp.zeros((1, LATENT))
    )
    variables = _randomize(jax.tree.map(np.asarray, dict(init)), np.random.default_rng(0), 0.15)
    tdec = CbnDecoder(LATENT, HIDDEN, LAYERS)
    tdec.load_state_dict(strip_prefix(decoder_state_from_flax(variables), "decoder."), strict=True)
    return fdec, variables, tdec


def _jax_udf(fdec, variables, pts, lat):
    jv = jax.tree.map(jnp.asarray, variables)
    logits = fdec.apply(jv, CoordsEncoder().encode(jnp.asarray(pts)[None]), jnp.asarray(lat)[None])
    return np.asarray(jax_udf_from_logits(logits[0], MAX_DIST))


def _data(seed, n=512):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.normal(size=(LATENT,)).astype(np.float32))


def test_bridge_matches_export_and_loads_strict(pair):
    _, variables, _ = pair
    sd = decoder_state_from_flax(variables)
    ref = export_cbn_decoder(variables)
    assert set(sd) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(ref[k]), err_msg=k)
    CbnDecoder(LATENT, HIDDEN, LAYERS).load_state_dict(strip_prefix(sd, "decoder."), strict=True)


def test_decoder_matches_flax(pair):
    fdec, variables, tdec = pair
    pts, lat = _data(1)
    want = _jax_udf(fdec, variables, pts, lat)
    with torch.no_grad():
        got = udf_from_logits(
            tdec(coords_encode(torch.from_numpy(pts))[None], torch.from_numpy(lat)[None])[0],
            MAX_DIST,
        ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_folded_matches_jax(pair, precision):
    """f32: JAX folded_udf(f32) within 1e-5; bf16: JAX folded_udf_mixed
    within 1e-4 (same bf16 roundings, another summation order)."""
    _, variables, tdec = pair
    pts, lat = _data(2)
    jf = jdk.fold_decoder(jax.tree.map(jnp.asarray, variables), jnp.asarray(lat), MAX_DIST)
    if precision == "f32":
        want, tol = np.asarray(jdk.folded_udf(jf, jnp.asarray(pts), dtype=jnp.float32)), 1e-5
    else:
        want, tol = np.asarray(jdk.folded_udf_mixed(jf, jnp.asarray(pts))), 1e-4
    folded = dk.fold_decoder(tdec, torch.from_numpy(lat), MAX_DIST)
    got = dk.folded_udf(folded, torch.from_numpy(pts), precision).numpy()
    np.testing.assert_allclose(got, want, atol=tol)


def test_folded_f32_matches_unfolded(pair):
    _, _, tdec = pair
    pts, lat = _data(3)
    p, lt = torch.from_numpy(pts), torch.from_numpy(lat)
    with torch.no_grad():
        ref = udf_from_logits(tdec(coords_encode(p)[None], lt[None])[0], MAX_DIST)
    got = dk.folded_udf(dk.fold_decoder(tdec, lt, MAX_DIST), p)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_gradient_matches_jax_vjp(pair):
    fdec, variables, tdec = pair
    pts, lat = _data(4, 256)
    jv = jax.tree.map(jnp.asarray, variables)

    def f(p):
        logits = fdec.apply(jv, CoordsEncoder().encode(p[None]), jnp.asarray(lat)[None])
        return jax_udf_from_logits(logits[0], MAX_DIST)

    _, vjp = jax.vjp(f, jnp.asarray(pts))
    (want,) = vjp(jnp.ones(len(pts)))
    ev = make_udf_fn(tdec, None, lat, MAX_DIST, device="cpu")
    got = ev.grad(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_sheet_fixture_loader():
    fx = load_sheet_fixture(FIXTURE)
    z = np.load(FIXTURE)
    assert fx["state_dict"]["decoder.fc_p.weight"].dtype == torch.float32
    np.testing.assert_array_equal(
        fx["state_dict"]["decoder.blocks.0.fc_0.weight"][:, :, 0].numpy(),
        z["dec/params/block_0/fc_0/kernel"].astype(np.float32).T,
    )
    assert fx["latent"].dtype == np.float32 and fx["latent"].shape == (32,)
    assert fx["max_dist"] == pytest.approx(0.1)
    assert fx["surface_samples"].dtype == np.float32 and fx["surface_samples"].shape[1] == 3
    dec = CbnDecoder(32, fx["hidden_dim"], fx["num_hidden_layers"])
    dec.load_state_dict(strip_prefix(fx["state_dict"], "decoder."), strict=True)


def test_folded_udf_rejects_bad_input(pair):
    _, _, tdec = pair
    folded = dk.fold_decoder(tdec, torch.zeros(LATENT), MAX_DIST)
    with pytest.raises(ValueError):
        dk.folded_udf(folded, torch.zeros(8, 3), "fp16")
    with pytest.raises(ValueError):
        dk.folded_udf(folded, torch.zeros(8, 4))
    with pytest.raises(ValueError):
        dk.folded_udf(folded, torch.zeros(8, 3, device="meta"))


@pytest.mark.parametrize("width", [128, 512])
def test_padded_mixed_matches_jax(pair, width):
    """The fold zero-padded to K1 bf16's widths keeps the bf16 plain version
    on JAX folded_udf_mixed, within the bf16 bar, 1e-4."""
    _, variables, tdec = pair
    pts, lat = _data(5)
    jf = jdk.fold_decoder(jax.tree.map(jnp.asarray, variables), jnp.asarray(lat), MAX_DIST)
    want = np.asarray(jdk.folded_udf_mixed(jf, jnp.asarray(pts)))
    folded = dk.fold_decoder(tdec, torch.from_numpy(lat), MAX_DIST).padded(width)
    got = dk.folded_udf(folded, torch.from_numpy(pts), "bf16").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
