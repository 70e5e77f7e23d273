"""The JAX package's last model modules in the port: the attention blocks,
UNet1D's spatial-transformer / scale-shift / pooled-resampling settings, the
classifier half-UNet with classifier guidance, and the grid AE. Each is held
to its Flax counterpart on seeded numpy inputs and randomised weights,
through its `*_state_from_flax` bridge, at small widths. Bars: module
outputs within 1e-5 of max(1, max |Flax|) (f32 on both sides; the spatial
heads' logits reach ~35); the guidance gradient within 5e-5 of its max |·|
(f32 through the classifier's backward at weights of std 0.2: 6.4e-6 to
1.8e-5 over three seeds, 0.8e-6 to 2.5e-6 at std 0.1); a guided DDPM
sample within 1e-4 (the latent-parity bar of tests/test_torch_samplers.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.diffusion import gaussian as jg
from surfd_tpu.models import attention as jatt
from surfd_tpu.models import encoder_unet as jenc
from surfd_tpu.models import grid_ae as jgae
from surfd_tpu.models import unet1d as junet
from surfd_tpu.utils.torch_convert import convert_encoder_unet
from surfd_tpu_torch.diffusion import p_sample_loop
from surfd_tpu_torch.models import attention as tatt
from surfd_tpu_torch.models.encoder_unet import EncoderUNet1D, make_classifier_cond_fn
from surfd_tpu_torch.models.grid_ae import GridAutoencoder
from surfd_tpu_torch.models.unet1d import UNet1D
from surfd_tpu_torch.utils.convert import (
    attention_state_from_flax,
    encoder_unet_state_from_flax,
    grid_ae_state_from_flax,
    unet1d_state_from_flax,
)
from test_torch_diffusion import _randomize, jax_replay_noise
from test_torch_samplers import _scheds

ATOL = 1e-5
GRAD_BAR = 5e-5


def _close(got, want, bar=ATOL):
    """max |got − want| ≤ bar · max(1, max |want|)."""
    assert got.shape == want.shape
    gap = float(np.abs(got - want).max())
    assert gap <= bar * max(1.0, float(np.abs(want).max())), gap


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _init(module, *args, seed=0, **kw):
    """Flax params of `module` at `args`, randomised (zero-init layers would
    hide whole paths), as numpy."""
    v = module.init(jax.random.PRNGKey(0), *args, **kw)
    return _randomize(jax.tree.map(np.asarray, dict(v["params"])), np.random.default_rng(seed))


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


D, CTX = 16, 12  # token width, context width
ATTN_CASES = {
    "geglu": (lambda: jatt.GEGLU(24), lambda: tatt.GEGLU(D, 24), "GEGLU", False),
    "ff_glu": (lambda: jatt.FeedForward(D), lambda: tatt.FeedForward(D), "FeedForward", False),
    "ff_gelu": (lambda: jatt.FeedForward(D, glu=False), lambda: tatt.FeedForward(D, glu=False),
                "FeedForward", False),
    "cross_self": (lambda: jatt.CrossAttention(D, heads=2, dim_head=8),
                   lambda: tatt.CrossAttention(D, None, 2, 8), "CrossAttention", False),
    "cross_context": (lambda: jatt.CrossAttention(D, CTX, 2, 8),
                      lambda: tatt.CrossAttention(D, CTX, 2, 8), "CrossAttention", True),
    "block_self": (lambda: jatt.BasicTransformerBlock(D, None, 2, 8),
                   lambda: tatt.BasicTransformerBlock(D, None, 2, 8), "BasicTransformerBlock",
                   False),
    "block_context": (lambda: jatt.BasicTransformerBlock(D, CTX, 2, 8),
                      lambda: tatt.BasicTransformerBlock(D, CTX, 2, 8), "BasicTransformerBlock",
                      True),
    "spatial_self": (lambda: jatt.SpatialTransformer1D(D, 2, 2),
                     lambda: tatt.SpatialTransformer1D(D, 2, 2), "SpatialTransformer1D", False),
    "spatial_context": (lambda: jatt.SpatialTransformer1D(D, 2, 2, CTX),
                        lambda: tatt.SpatialTransformer1D(D, 2, 2, CTX), "SpatialTransformer1D",
                        True),
    "linear": (lambda: jatt.LinearAttention(D, 2, 8), lambda: tatt.LinearAttention(D, 2, 8),
               "LinearAttention", False),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_blocks_match_flax(case):
    jmod, tmod, name, with_ctx = ATTN_CASES[case]
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 5, D)
    args = (jnp.asarray(x),)
    kw = {"context": jnp.asarray(_np(rng, 2, 7, CTX))} if with_ctx else {}
    fm = jmod()
    params = _init(fm, *args, **kw)
    want = np.asarray(fm.apply({"params": params}, *args, **kw))
    tm = tmod()
    tm.load_state_dict(attention_state_from_flax(name, params), strict=True)
    with torch.no_grad():
        got = tm(_t(x), *([_t(kw["context"])] if with_ctx else [])).numpy()
    assert got.shape == want.shape
    _close(got, want)


UNET_SMALL = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                  attention_resolutions=(1, 2), num_heads=4)
UNET_CASES = {
    # context 2-D (lifted to one token) and 3-D, transformer 2 deep
    "transformer_ctx2d": (dict(use_spatial_transformer=True, transformer_depth=2,
                               context_dim=24), (2, 24)),
    "transformer_ctx3d": (dict(use_spatial_transformer=True, context_dim=24), (2, 3, 24)),
    "scale_shift": (dict(use_scale_shift_norm=True, context_dim=None), None),
    "pooled_resample": (dict(conv_resample=False, use_scale_shift_norm=True, context_dim=24),
                        (2, 24)),
}


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_unet1d_settings_match_flax(case):
    kw, ctx_shape = UNET_CASES[case]
    rng = np.random.default_rng(2)
    x = _np(rng, 2, 16, 1)
    t = np.array([3, 700], np.int32)
    ctx = _np(rng, *ctx_shape) if ctx_shape else None
    fm = junet.UNet1D(**UNET_SMALL, **kw)
    jkw = {"context": jnp.asarray(ctx)} if ctx is not None else {}
    params = _init(fm, jnp.asarray(x), jnp.asarray(t), **jkw)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), **jkw))
    tm = UNet1D(**UNET_SMALL, **kw)
    tm.load_state_dict(unet1d_state_from_flax(params, (1, 2), 1, (1, 2)), strict=True)
    with torch.no_grad():
        got = tm(_t(x).permute(0, 2, 1), _t(t),
                 context=None if ctx is None else _t(ctx)).permute(0, 2, 1).numpy()
    _close(got, want)


def test_unet1d_transformer_replaces_k2_and_needs_context_dim(monkeypatch):
    """With the transformer on, no attention site calls qkv_attention (K2),
    and the context really flows (a scaled context moves the output)."""
    from surfd_tpu_torch.models import unet1d

    calls = []
    monkeypatch.setattr(unet1d, "qkv_attention", lambda *a: calls.append(1))
    tm = UNet1D(**UNET_SMALL, use_spatial_transformer=True, context_dim=8)
    tm.random_init_(torch.Generator().manual_seed(0))
    x, t, c = torch.randn(2, 1, 16), torch.tensor([1, 2]), torch.randn(2, 8)
    with torch.no_grad():
        a, b = tm(x, t, context=c), tm(x, t, context=3 * c)
    assert not calls and not torch.allclose(a, b)
    with pytest.raises(ValueError, match="context_dim"):
        UNet1D(**UNET_SMALL, use_spatial_transformer=True)


ENC = dict(model_channels=32, out_channels=5, num_res_blocks=1, attention_resolutions=(1, 2),
           channel_mult=(1, 2), num_heads=4, num_head_channels=8, seq_len=15)
POOLS = ("adaptive", "attention", "spatial", "spatial_v2")


def _encoder_pair(pool, seed=3):
    fm = jenc.EncoderUNet1D(pool=pool, **ENC)
    x = jnp.zeros((1, ENC["seq_len"], 1))
    params = _init(fm, x, jnp.zeros((1,), jnp.int32), seed=seed)
    tm = EncoderUNet1D(pool=pool, **ENC)
    tm.load_state_dict(encoder_unet_state_from_flax({"params": params}, (1, 2), 1, (1, 2), pool),
                       strict=True)
    return fm, {"params": params}, tm


@pytest.mark.parametrize("pool", POOLS)
def test_encoder_unet_matches_flax(pool):
    """All four heads at seq_len 15 (ceil-halved to 8 for the pool's table)."""
    fm, fvars, tm = _encoder_pair(pool)
    rng = np.random.default_rng(4)
    x = _np(rng, 3, ENC["seq_len"], 1)
    t = np.array([0, 250, 999], np.int32)
    want = np.asarray(fm.apply(fvars, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(_t(x), _t(t)).numpy()
    assert got.shape == (3, 5)
    _close(got, want)


@pytest.mark.parametrize("pool", POOLS)
def test_encoder_unet_state_dict_reads_in_convert_encoder_unet(pool):
    """The port's state dict (seeded random weights) goes through the JAX
    package's `convert_encoder_unet` unchanged, and the Flax module on the
    converted params gives the port's logits."""
    tm = EncoderUNet1D(pool=pool, **ENC).random_init_(torch.Generator().manual_seed(5))
    params = convert_encoder_unet(tm.state_dict(), (1, 2), 1, (1, 2), pool)
    rng = np.random.default_rng(6)
    x, t = _np(rng, 2, ENC["seq_len"], 1), np.array([10, 500], np.int32)
    want = np.asarray(jenc.EncoderUNet1D(pool=pool, **ENC).apply(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(_t(x), _t(t)).numpy()
    _close(got, want)


def _cond_fn_pair(pool="attention", scale=2.5):
    fm, fvars, tm = _encoder_pair(pool, seed=7)
    y = np.array([1, 3], np.int32)
    jfn = jenc.make_classifier_cond_fn(lambda x, t: fm.apply(fvars, x, t), jnp.asarray(y), scale)
    tfn = make_classifier_cond_fn(tm, torch.from_numpy(y), scale)
    return jfn, tfn


def test_classifier_cond_fn_matches_jax_under_no_grad():
    """∇ₓ log p(y | x_t) · scale against jax.grad, called under no_grad as
    the samplers call it."""
    jfn, tfn = _cond_fn_pair()
    rng = np.random.default_rng(8)
    x, t = _np(rng, 2, ENC["seq_len"], 1), np.array([5, 400], np.int32)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tfn(_t(x), _t(t)).numpy()
    top = float(np.abs(want).max())
    assert top > 0
    assert float(np.abs(got - want).max()) <= GRAD_BAR * top


def test_classifier_guided_ddpm_matches_jax():
    """A guided p_sample_loop (10 cosine steps, the classifier's gradient
    shifting each mean) against JAX's on its replayed noise."""
    jfn, tfn = _cond_fn_pair()
    sj, st = _scheds("10")
    L = ENC["seq_len"]
    shape = (2, L, 1)

    def model_j(x, t):
        return 0.5 * x

    def model_t(x, t):
        return 0.5 * x

    noise = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    want = np.asarray(jg.p_sample_loop(sj, model_j, shape, rng, noise=jnp.asarray(noise),
                                       cond_fn=jfn))
    steps = torch.from_numpy(jax_replay_noise(rng, st.num_timesteps, shape))
    with torch.no_grad():
        got = p_sample_loop(st, model_t, shape, noise=torch.from_numpy(noise), step_noise=steps,
                            cond_fn=tfn).numpy()
        plain = p_sample_loop(st, model_t, shape, noise=torch.from_numpy(noise),
                              step_noise=steps).numpy()
    assert np.abs(got - plain).max() > 1e-3  # the guidance moved the sample
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_grid_autoencoder_encode_decode_match_flax():
    """Encode and decode at 16³, base 8, mult (1, 2), latent 4, on the
    channel-first port against the channel-last Flax module."""
    fm = jgae.GridAutoencoder(base_channels=8, channel_mult=(1, 2), latent_channels=4)
    rng = np.random.default_rng(10)
    x = _np(rng, 2, 16, 16, 16, 1)
    params = _init(fm, jnp.asarray(x), seed=11)
    fv = {"params": params}
    z_want = np.asarray(fm.apply(fv, jnp.asarray(x), method=jgae.GridAutoencoder.encode))
    y_want = np.asarray(fm.apply(fv, jnp.asarray(z_want), method=jgae.GridAutoencoder.decode))
    tm = GridAutoencoder(base_channels=8, channel_mult=(1, 2), latent_channels=4)
    tm.load_state_dict(grid_ae_state_from_flax(fv), strict=True)
    with torch.no_grad():
        z = tm.encode(_t(x).permute(0, 4, 1, 2, 3))
        y = tm.decode(_t(z_want).permute(0, 4, 1, 2, 3))
    assert tuple(z.shape) == (2, 4, 8, 8, 8)
    _close(z.permute(0, 2, 3, 4, 1).numpy(), z_want)
    _close(y.permute(0, 2, 3, 4, 1).numpy(), y_want)
