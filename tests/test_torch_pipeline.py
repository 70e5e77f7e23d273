"""Extraction parity: the port's evaluator forms, GridFiller and
get_mesh_from_udf against the JAX package at 64³ on one decoder (a 64×2 CBN
decoder fitted to a sphere, with perturbed latent projections so the latent
matters), plus the slice end to end: replayed-noise sampling → mesh.

max_dist 0.4 makes the 64³ fill block-sparse (block 8, sub-block 2), so the
coarse, sub-block and fine passes all run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from surfd_tpu.diffusion import schedule as js
from surfd_tpu.geometry.grid import GridFiller as JaxGridFiller
from surfd_tpu.geometry.grid import eval_in_chunks
from surfd_tpu.models import CbnDecoder as FlaxCbnDecoder
from surfd_tpu.pipelines import MeshExtractionConfig as JaxConfig
from surfd_tpu.pipelines import get_mesh_from_udf as jax_get_mesh
from surfd_tpu.pipelines import make_udf_fn as jax_make_udf_fn
from surfd_tpu.utils.torch_convert import convert_cbn_decoder
from surfd_tpu_torch.diffusion import named_beta_schedule, space_timesteps, spaced_schedule
from surfd_tpu_torch.geometry import GridFiller, QueryStream
from surfd_tpu_torch.models import CbnDecoder, coords_encode
from surfd_tpu_torch.pipelines import (
    BiasTable,
    MeshExtractionConfig,
    get_mesh_from_udf,
    make_udf_fn,
)
from test_torch_diffusion import sample_both, tiny_mdm_pair

LATENT, HIDDEN, LAYERS = 8, 64, 2
MAX_DIST, R, LO = 0.4, 64, -1.0
VOXEL = 2.0 / (R - 1)
QSTEP = 2.0 / 65535.0


@pytest.fixture(scope="module")
def decoders():
    """(port CbnDecoder, flax module, flax variables) with equal weights."""
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(0)
    dec = CbnDecoder(LATENT, HIDDEN, LAYERS).random_init_(g)
    params = [p for n, p in dec.named_parameters() if "conv_" not in n]
    opt = torch.optim.Adam(params, lr=3e-3)
    rng = np.random.default_rng(1)
    zero = torch.zeros(1, LATENT)
    for _ in range(300):
        q = torch.from_numpy(rng.uniform(-1, 1, (1, 512, 3)).astype(np.float32))
        target = 1.0 - torch.clamp((q.norm(dim=-1) - 0.6).abs(), max=MAX_DIST) / MAX_DIST
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            dec(coords_encode(q), zero), target)
        opt.zero_grad()
        loss.backward()
        opt.step()
    with torch.no_grad():  # let the latent matter a little
        for n, p in dec.named_parameters():
            if "conv_" in n and n.endswith("weight"):
                p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 0.02))
    sd = {"decoder." + k: v.detach().numpy() for k, v in dec.state_dict().items()}
    variables = convert_cbn_decoder(sd, num_hidden_layers=LAYERS)
    fdec = FlaxCbnDecoder(latent_dim=LATENT, hidden_dim=HIDDEN, num_hidden_layers=LAYERS)
    return dec, fdec, jax.tree.map(jnp.asarray, variables)


@pytest.fixture(scope="module")
def bound(decoders):
    """(JAX udf_fn, port evaluator, latent) for one latent."""
    dec, fdec, fvars = decoders
    lat = (np.random.default_rng(2).normal(size=(LATENT,)) * 0.5).astype(np.float32)
    jfn = jax_make_udf_fn(fdec, fvars, jnp.asarray(lat), max_dist=MAX_DIST)
    tfn = make_udf_fn(dec, None, lat, MAX_DIST, device="cpu", chunk=2**14)
    return jfn, tfn, lat


def _qpts(n, seed):
    """Points on the 2^16 coords grid near the sphere, where the UDF is small."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    p = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(0.5, 0.7, (n, 1))
    return np.clip(np.rint((p - LO) / QSTEP), 0, 65535).astype(np.uint16)


def _jax_f32(jfn, qpts):
    return eval_in_chunks(jfn, qpts.astype(np.float32) * np.float32(QSTEP) + np.float32(LO), 4096)


def _near(u, thr):
    return np.abs(u - thr) <= 1e-5 * MAX_DIST


def test_u16_within_one_step(bound):
    jfn, tfn, _ = bound
    pts = np.random.default_rng(3).uniform(-1, 1, (4096, 3)).astype(np.float32)
    want = np.asarray(jfn.u16_fn(jnp.asarray(pts))).astype(np.int64)
    got = tfn.u16(torch.from_numpy(pts)).numpy().astype(np.int64)
    assert np.abs(got - want).max() <= 1


def test_below_mask_matches(bound):
    jfn, tfn, _ = bound
    q = _qpts(8192, 4)
    u = _jax_f32(jfn, q)
    thr = float(np.median(u))
    want = eval_in_chunks(jfn.below_packed_q16_bound(thr, LO, QSTEP), q, 4096, unpack_bits=True)
    got = tfn.queries.run(tfn.below_q16_bound(thr, LO, QSTEP),
                          torch.from_numpy(q.astype(np.int32))).numpy()
    far = ~_near(u, thr)
    assert far.sum() > 0.99 * len(q)
    np.testing.assert_array_equal(got[far], want[far].astype(bool))


def test_biased_below_mask_matches(bound):
    jfn, tfn, _ = bound
    q = _qpts(8192, 5)
    nb = 4
    field = np.random.default_rng(6).uniform(0, 0.02, (nb, nb, nb)).astype(np.float32)
    cell = (R // nb) * VOXEL
    table = BiasTable(field, LO, cell, "cpu")
    pts = q.astype(np.float32) * np.float32(QSTEP) + np.float32(LO)
    b = table.at(torch.from_numpy(pts)).numpy()
    u = _jax_f32(jfn, q) - b
    thr = float(np.median(u))
    bscale = float(field.max()) / 255.0
    btbl = jnp.asarray(np.rint(field.reshape(-1) / bscale).astype(np.uint8))
    want = eval_in_chunks(
        jfn.below_packed_q16_biased_bound(thr, LO, QSTEP, bscale, 1.0 / cell, nb, btbl),
        q, 4096, unpack_bits=True,
    )
    got = tfn.queries.run(tfn.below_q16_bound(thr, LO, QSTEP, table),
                          torch.from_numpy(q.astype(np.int32))).numpy()
    far = ~_near(u, thr)
    np.testing.assert_array_equal(got[far], want[far].astype(bool))


def test_two_tier_mask_equals_f32(bound):
    """Tier 1 decides outside the calibrated band, tier 2 (f32) inside: the
    result is the single-tier f32 mask bit for bit, and the band is hit."""
    jfn, tfn, _ = bound
    q = torch.from_numpy(_qpts(8192, 7).astype(np.int32))
    u = tfn(q.to(torch.float32) * QSTEP + LO)
    thr = float(u.median())
    band = tfn.two_tier_band(tfn.queries)
    assert 1e-4 * MAX_DIST <= band < thr
    tier1 = tfn.queries.run(tfn.below2t_q16_bound(thr, LO, QSTEP, band), q)
    below, sure = tier1[:, 0], tier1[:, 1]
    uns = torch.nonzero(~sure)[:, 0]
    assert len(uns) > 0
    f32 = tfn.below_q16_bound(thr, LO, QSTEP)
    below[uns] = tfn.queries.run(f32, q[uns])
    torch.testing.assert_close(below, tfn.queries.run(f32, q), rtol=0, atol=0)


def test_grad_i8_within_one_step(bound):
    jfn, tfn, _ = bound
    pts = _qpts(4096, 8).astype(np.float32) * QSTEP + LO
    idx = np.clip(np.rint((pts - LO) / VOXEL), 0, R - 1).astype(np.int64)
    gids = (idx[:, 0] * R + idx[:, 1]) * R + idx[:, 2]
    want = np.asarray(jfn.grad_i8_gid_bound(R, LO, VOXEL)(jnp.asarray(gids.astype(np.int32))))
    got = tfn.grad_i8_gid_async(gids, R, LO, VOXEL, tfn.queries)()
    assert got.dtype == np.int8 and got.shape == (len(gids), 3)
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_grid_filler_matches(bound):
    jfn, tfn, _ = bound
    jg = JaxGridFiller(R, max_dist=MAX_DIST, max_batch=2**14, surface_bias="auto")
    want, ws = jg.fill(jfn, return_stats=True)
    tg = GridFiller(R, max_dist=MAX_DIST, surface_bias="auto", queries=QueryStream("cpu", 2**14))
    got, gs = tg.fill(tfn, return_stats=True)
    assert (tg.block, tg.sub_block, gs["block"]) == (8, 2, 2)
    np.testing.assert_array_equal(gs["ab"], ws["ab"])
    assert gs["surface_bias"] == pytest.approx(ws["surface_bias"], abs=2 * MAX_DIST / 65535)
    assert np.abs(got - want).max() <= 2 * MAX_DIST / 65535 * 1.0001


def _mean_nn_chamfer(a, b):
    """Symmetric mean nearest-neighbour distance between two vertex sets."""
    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def _mesh_pair(jfn, tfn, bias):
    kw = dict(resolution=R, max_dist=MAX_DIST, max_batch=2**14, face_filter_mult=4.0,
              surface_bias=bias)
    jm, js_ = jax_get_mesh(jfn, cfg=JaxConfig(**kw), return_stats=True)
    tm, ts = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**kw), return_stats=True)
    return jm, js_, tm, ts


def _assert_meshes_agree(jm, tm):
    assert len(jm.faces) > 500
    assert abs(len(tm.faces) - len(jm.faces)) <= 0.01 * len(jm.faces)
    assert _mean_nn_chamfer(tm.vertices, jm.vertices) <= 0.1 * VOXEL


@pytest.mark.parametrize("bias", [0.0, "auto"])
def test_mesh_matches(bound, bias):
    jfn, tfn, _ = bound
    jm, js_, tm, ts = _mesh_pair(jfn, tfn, bias)
    _assert_meshes_agree(jm, tm)
    assert ts["oob_vertices"] == js_.get("oob_vertices", 0) == 0
    assert ts["face_explosion"] == js_["face_explosion"]
    assert ts["raw_faces"] == pytest.approx(js_["raw_faces"], rel=0.01)
    r = np.linalg.norm(tm.vertices, axis=1)
    assert abs(float(np.median(r)) - 0.6) < 0.05


def test_slice_end_to_end(decoders):
    """sample (replayed noise) → bind latent → mesh, in both frameworks."""
    torch.set_num_threads(1)
    dec, fdec, fvars = decoders
    fm, mvars, mm = tiny_mdm_pair(L=LATENT, seed=3)
    sj = js.spaced_schedule(js.named_beta_schedule("cosine", 1000), js.space_timesteps(1000, "10"))
    st = spaced_schedule(named_beta_schedule("cosine", 1000), space_timesteps(1000, "10"))
    want, got, _, _ = sample_both(fm, mvars, mm, sj, st, 2, LATENT, 11)
    np.testing.assert_allclose(got, want[..., 0], atol=1e-4)
    lat_j, lat_t = want[0, :, 0] * 0.5, got[0] * 0.5  # keep the latent in the fitted range
    jfn = jax_make_udf_fn(fdec, fvars, jnp.asarray(lat_j), max_dist=MAX_DIST)
    tfn = make_udf_fn(dec, None, lat_t, MAX_DIST, device="cpu", chunk=2**14)
    jm, _, tm, ts = _mesh_pair(jfn, tfn, "auto")
    _assert_meshes_agree(jm, tm)
    assert ts["oob_vertices"] == 0
