"""K1 f32's host side and its arithmetic, on the CPU.

The kernel (ops/csrc/folded_mlp.cu) runs only on the card
(tests/test_torch_kernels_cuda.py). Here:
- the weights packed by `pack_afrag` are read back the way the kernel's
  threads load their m64nNk8 tf32 A fragments;
- `round_tf32`, the kernel's operand rounding, and the hi / lo split built
  on it;
- `FoldedDecoder.packed`, made once per fold and made again when the fold
  changes;
- `_udf_3xtf32`, an emulation of the kernel's 3xTF32 math (split every
  matmul operand, three products, f32 sums), against JAX `folded_udf` in
  f32. The emulation is a test helper: nothing in the port calls it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.models import CbnDecoder as FlaxCbnDecoder
from surfd_tpu.models import CoordsEncoder
from surfd_tpu.ops import decoder_kernel as jdk
from surfd_tpu_torch.models import CbnDecoder
from surfd_tpu_torch.ops import decoder_kernel as dk
from surfd_tpu_torch.utils.convert import (
    decoder_state_from_flax,
    load_sheet_fixture,
    nest_flat_keys,
    strip_prefix,
)

LATENT, MAX_DIST = 16, 0.1
FIXTURE = str(Path(__file__).resolve().parent.parent / "surfd_tpu/assets/bench_sheet_decoder.npz")
TOL = 1e-5  # K1 f32's bar against the f32 reference


def _folded(hidden, layers=2, seed=0):
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(seed)
    dec = CbnDecoder(LATENT, hidden, layers).random_init_(g)
    with torch.no_grad():
        for n, p in dec.named_parameters():
            if "conv_" in n and n.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    lat = torch.from_numpy(np.random.default_rng(seed).normal(size=(LATENT,)).astype(np.float32))
    return dk.fold_decoder(dec, lat, MAX_DIST)


def _read_as_kernel(packed, K, N):
    """Rebuild the (K, N) weight from `pack_afrag`'s output as the kernel's
    threads read it: slab s (16 K rows) at s·16·N floats; in it, thread tt of
    the warpgroup owning M tile j loads, for k8 step q, the float4 at
    ((q·N/64 + j)·128 + tt)·4; its value v is A-fragment register v, row
    16·(tt/32) + (tt%32)/4 + 8·(v%2), column (tt%4) + 4·(v/2) of the
    m64n·k8 tf32 A tile, i.e. hidden unit 64·j + row and K row 16·s + 8·q +
    column."""
    flat = packed.numpy()
    assert flat.dtype == np.float32 and flat.size == K * N
    out = np.full((K, N), np.nan, np.float32)
    for s in range(K // 16):
        for q in range(2):
            for j in range(N // 64):
                for tt in range(128):
                    base = s * 16 * N + ((q * (N // 64) + j) * 128 + tt) * 4
                    for v in range(4):
                        row = 16 * (tt // 32) + (tt % 32) // 4 + 8 * (v % 2)
                        col = tt % 4 + 4 * (v // 2)
                        out[16 * s + 8 * q + col, 64 * j + row] = flat[base + v]
    return torch.from_numpy(out)


@pytest.mark.parametrize("hidden,width", [(64, 64), (96, 128), (128, 128), (256, 256), (512, 512)])
def test_pack_afrag_round_trips(hidden, width):
    f = _folded(hidden, layers=1 if hidden == 512 else 2)
    pk = f.packed("f32")
    assert pk.folded.hidden == width and f.packed("f32") is pk  # made once
    w_in = _read_as_kernel(pk.w_in, 64, width)
    assert torch.equal(w_in[:63, :hidden], f.w_in)
    assert not w_in[63:].any() and not w_in[:, hidden:].any()
    size = width * width
    for name in ("w1", "w2"):
        mats = getattr(pk, name)
        assert mats.dtype == torch.float32 and mats.numel() == f.layers * size
        for i in range(f.layers):
            w = _read_as_kernel(mats[i * size:(i + 1) * size], width, width)
            assert torch.equal(w[:hidden, :hidden], getattr(f, name)[i])
            assert not w[hidden:].any() and not w[:, hidden:].any()
    assert pk.w_out.dtype == torch.float32 and pk.w_out.shape == (width,)
    assert torch.equal(pk.w_out[:hidden], f.w_out[:, 0]) and not pk.w_out[hidden:].any()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("change", ["in place", "in place through a view", "field replaced"])
def test_packed_follows_changes_to_the_fold(precision, change):
    """The kernel reads the cached pack: it must never hold weights the fold
    no longer has, and must not be made again while nothing changed."""
    f = _folded(64)
    pk = f.packed(precision)
    assert f.packed(precision) is pk
    if change == "in place":
        f.w1.mul_(2)
    elif change == "in place through a view":
        f.w2[1].add_(1)
    else:
        f.b_out_value = f.b_out_value + 1.0
    fresh = f.packed(precision)
    assert fresh is not pk and f.packed(precision) is fresh
    assert torch.equal(fresh.folded.w1, f.w1) and torch.equal(fresh.folded.w2, f.w2)
    assert fresh.folded.b_out_value == f.b_out_value
    assert torch.equal(fresh.w1, dk.pack_k1(f, precision).w1)


def test_pack_afrag_rejects_bad_shapes():
    with pytest.raises(ValueError):
        dk.pack_afrag(torch.zeros(24, 64))
    with pytest.raises(ValueError):
        dk.pack_afrag(torch.zeros(64, 96))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _random_f32(n, seed):
    rng = np.random.default_rng(seed)
    mag = rng.uniform(1, 2, n) * 2.0 ** rng.integers(-60, 60, n)
    return torch.from_numpy((mag * rng.choice([-1.0, 1.0], n)).astype(np.float32))


def test_round_tf32_is_exact_on_tf32_values():
    a = _random_f32(100_000, 0)
    t = (_bits(a) & -0x2000).view(torch.float32)  # tf32 values: low 13 bits 0
    assert torch.equal(_bits(dk.round_tf32(t)), _bits(t))
    for v in (0.0, -0.0, 1.0, -2.5, 2.0 ** -100, 3.0 * 2 ** 60):
        x = torch.tensor([v])
        assert torch.equal(_bits(dk.round_tf32(x)), _bits(x))


def test_round_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # tf32 spacing in [1, 2)
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + 0.49 * one_ulp,
                      1 + 0.51 * one_ulp, 1 + 2.5 * one_ulp], dtype=torch.float32)
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp, 1 + 3 * one_ulp])
    assert torch.equal(dk.round_tf32(x), want)
    a = _random_f32(100_000, 1)
    hi = dk.round_tf32(a).double()
    assert bool(((a.double() - hi).abs() <= 2.0 ** -11 * a.double().abs()).all())


def _split(a):
    """The kernel's split: hi = tf32(a), lo = tf32(a - hi)."""
    hi = dk.round_tf32(a)
    return hi, dk.round_tf32(a - hi)


def test_tf32_split_keeps_f32_accuracy():
    a = _random_f32(200_000, 2)
    hi, lo = _split(a)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    err = (a.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * a.double().abs()).all())
    h2, l2 = _split(hi)  # a tf32 value splits exactly, lo = 0
    assert torch.equal(h2, hi) and not l2.any()


def _mm3(a, w):
    """a @ w as K1 f32 computes it: W_lo·a_hi + W_hi·a_lo + W_hi·a_hi,
    products of tf32 halves (exact in f32), summed in f32."""
    (ah, al), (wh, wl) = _split(a), _split(w)
    return ah @ wl + al @ wh + ah @ wh


def _udf_3xtf32(f, pts, mm=_mm3):
    """`folded_udf_ref`'s f32 math with every hidden matmul through `mm`."""
    x = mm(dk.posenc_f32(pts), f.w_in) + f.b_in
    for i in range(f.layers):
        h = torch.relu(x * f.a1[i] + f.c1[i])
        h = torch.relu((mm(h, f.w1[i]) + f.b1[i]) * f.a2[i] + f.c2[i])
        x = x + (mm(h, f.w2[i]) + f.b2[i])
    logit = (torch.relu(x * f.a_out + f.c_out) @ f.w_out + f.b_out)[..., 0]
    return (1.0 - torch.sigmoid(logit)) * f.max_dist


def _randomize(tree, rng, scale):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, scale)
        elif k == "var":
            out[k] = (np.abs(rng.normal(size=v.shape)) + 0.5).astype(np.float32)
        else:
            out[k] = (rng.normal(size=v.shape) * scale).astype(np.float32)
    return out


def _pair(hidden, layers, seed):
    """(JAX fold, port fold) of one seeded random decoder and latent."""
    torch.set_num_threads(1)
    fdec = FlaxCbnDecoder(latent_dim=LATENT, hidden_dim=hidden, num_hidden_layers=layers)
    init = fdec.init(jax.random.PRNGKey(0), CoordsEncoder().encode(jnp.zeros((1, 8, 3))),
                     jnp.zeros((1, LATENT)))
    rng = np.random.default_rng(seed)
    variables = _randomize(jax.tree.map(np.asarray, dict(init)), rng, 0.15)
    lat = rng.normal(size=(LATENT,)).astype(np.float32)
    tdec = CbnDecoder(LATENT, hidden, layers)
    tdec.load_state_dict(strip_prefix(decoder_state_from_flax(variables), "decoder."), strict=True)
    jf = jdk.fold_decoder(jax.tree.map(jnp.asarray, variables), jnp.asarray(lat), MAX_DIST)
    return jf, dk.fold_decoder(tdec, torch.from_numpy(lat), MAX_DIST)


def _points(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("hidden,layers,seed", [(64, 1, 0), (96, 2, 1), (128, 3, 2)])
def test_3xtf32_matches_jax_f32(hidden, layers, seed):
    jf, folded = _pair(hidden, layers, seed)
    pts = _points(1000, seed + 10)
    want = np.asarray(jdk.folded_udf(jf, jnp.asarray(pts), dtype=jnp.float32))
    got = _udf_3xtf32(folded.packed("f32").folded, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def sheet():
    """(JAX fold, port fold, points) of the shipped trained sheet decoder."""
    torch.set_num_threads(1)
    fx = load_sheet_fixture(FIXTURE)
    with np.load(FIXTURE) as z:
        dv = nest_flat_keys({k: jnp.asarray(z[k], jnp.float32) for k in z.files
                             if k.startswith("dec/")}, "dec/")
    jf = jdk.fold_decoder(dv, jnp.asarray(fx["latent"]), fx["max_dist"])
    dec = CbnDecoder(len(fx["latent"]), fx["hidden_dim"], fx["num_hidden_layers"])
    dec.load_state_dict(strip_prefix(fx["state_dict"], "decoder."), strict=True)
    folded = dk.fold_decoder(dec, torch.from_numpy(fx["latent"]), fx["max_dist"])
    pts = _points(3000, 7)
    want = np.asarray(jdk.folded_udf(jf, jnp.asarray(pts), dtype=jnp.float32))
    return folded, torch.from_numpy(pts), want


def test_3xtf32_matches_jax_f32_on_sheet_fixture(sheet):
    folded, pts, want = sheet
    assert folded.hidden == 512 and folded.layers == 5
    got = _udf_3xtf32(folded, pts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_one_tf32_product_misses_the_bar_on_sheet_fixture(sheet):
    """The bar tells 3xTF32 from one tf32 product (W_hi·a_hi alone): what
    the kernel would compute had it dropped both small products."""
    folded, pts, want = sheet
    one = lambda a, w: dk.round_tf32(a) @ dk.round_tf32(w)
    err_one = np.abs(_udf_3xtf32(folded, pts, one).numpy() - want).max()
    err_3x = np.abs(_udf_3xtf32(folded, pts).numpy() - want).max()
    assert err_one > TOL and err_one > 30 * err_3x, (err_one, err_3x)
