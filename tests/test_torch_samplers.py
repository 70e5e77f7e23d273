"""Sampler parity: the port's DDIM, PLMS, guidance hooks, warm starts, mean
and variance types against surfd_tpu.diffusion.gaussian, on equal weights
and with JAX's own noise replayed into the port. Bar: 1e-4 abs.

The denoiser is the tiny MDM pair (16 channels, mult (1, 2), latent 8) or,
where a case needs a model output the MDM cannot give (2C channels for a
learned variance), an analytic model written once for each framework."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.diffusion import gaussian as jg
from surfd_tpu.diffusion import schedule as js
from surfd_tpu.models import MDM as FlaxMDM
from surfd_tpu.models.mdm import make_cfg_model_fn as jax_cfg
from surfd_tpu_torch.diffusion import (
    MeanType,
    VarType,
    ddim_reverse_sample,
    ddim_sample_loop,
    named_beta_schedule,
    p_sample_loop,
    plms_sample_loop,
    space_timesteps,
    spaced_schedule,
)
from surfd_tpu_torch.models import MDM, make_cfg_model_fn
from surfd_tpu_torch.pipelines import sample_latents
from surfd_tpu_torch.utils.convert import mdm_state_from_flax
from test_torch_diffusion import _randomize, jax_replay_noise, tiny_mdm_pair

B, L = 2, 8
SHAPE = (B, L, 1)
ATOL = 1e-4
LOOPS = {"ddpm": (jg.p_sample_loop, p_sample_loop),
         "ddim": (jg.ddim_sample_loop, ddim_sample_loop),
         "plms": (jg.plms_sample_loop, plms_sample_loop)}


@pytest.fixture(scope="module")
def mdm():
    torch.set_num_threads(1)
    fm, fvars, tm = tiny_mdm_pair(L=L, seed=4)
    return (lambda x, t: fm.apply(fvars, x, t)), tm


def _scheds(spacing="10", name="cosine"):
    base_j, base_t = js.named_beta_schedule(name, 1000), named_beta_schedule(name, 1000)
    return (js.spaced_schedule(base_j, js.space_timesteps(1000, spacing)),
            spaced_schedule(base_t, space_timesteps(1000, spacing)))


def _sched_name(loop):
    """PLMS runs on the linear schedule: its x₀ from ε at the cosine
    schedule's last step (ᾱ ≈ 2.4e-9) cancels in f32 in either framework,
    beyond the bar (`test_plms_conditioning_of_the_schedules`)."""
    return "linear" if loop == "plms" else "cosine"


def _run_both(loop, jfn, tfn, *, seed=3, spacing="10", jkw=None, tkw=None, **kw):
    """(JAX sample, port sample) of one loop on the same initial noise and
    replayed step noise. `kw` goes to both; `jkw` / `tkw` to one side."""
    sj, st = _scheds(spacing, _sched_name(loop))
    noise = np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(seed)
    jloop, tloop = LOOPS[loop]
    want = np.asarray(jloop(sj, jfn, SHAPE, rng, noise=jnp.asarray(noise), **kw, **(jkw or {})))
    tk = dict(kw, **(tkw or {}))
    if loop != "plms":
        n = st.num_timesteps - kw.get("skip_timesteps", 0)
        tk["step_noise"] = torch.from_numpy(jax_replay_noise(rng, n, SHAPE))
    with torch.no_grad():
        got = tloop(st, tfn, SHAPE, noise=torch.from_numpy(noise), **tk).numpy()
    assert got.shape == want.shape == SHAPE
    assert np.isfinite(got).all()
    return want, got


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_matches_jax(mdm, eta):
    jfn, tm = mdm
    want, got = _run_both("ddim", jfn, tm, eta=eta, clip_denoised=False)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_plms_matches_jax(mdm, order):
    jfn, tm = mdm
    want, got = _run_both("plms", jfn, tm, order=order, clip_denoised=False)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_plms_conditioning_of_the_schedules(mdm, name):
    """Why PLMS parity runs on the linear schedule: JAX's own PLMS sample on
    the cosine schedule moves by more than the 1e-4 bar when its initial
    noise moves by one part in 10⁶; on the linear schedule it stays well
    inside."""
    jfn, _ = mdm
    sj, _ = _scheds(name=name)
    noise = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
    a, b = (np.asarray(jg.plms_sample_loop(sj, jfn, SHAPE, jax.random.PRNGKey(3),
                                           noise=jnp.asarray(n), order=2, clip_denoised=False))
            for n in (noise, noise * np.float32(1 + 1e-6)))
    moved = float(np.abs(a - b).max())
    assert moved > ATOL if name == "cosine" else moved < 0.5 * ATOL


def test_plms_model_calls(mdm):
    """Order ≥ 2: one extra model call, at max(t − 1, 0), on the first step
    only; order 1: one call a step."""
    _, tm = mdm
    _, st = _scheds(name="linear")
    for order, extra in ((1, 0), (2, 1), (4, 1)):
        seen = []
        fn = lambda x, t: (seen.append(int(t[0])), tm(x, t))[1]
        with torch.no_grad():
            plms_sample_loop(st, fn, SHAPE, noise=torch.zeros(SHAPE), order=order)
        assert len(seen) == st.num_timesteps + extra
        if extra:
            assert seen[1] == int(st.timestep_map[st.num_timesteps - 2])


@pytest.mark.parametrize("t", [1, 5, 9])
def test_ddim_reverse_sample_matches_jax(mdm, t):
    """Not at t = 0: there ε = (x/√ᾱ − x₀)/√(1/ᾱ − 1) divides by 6e-3 on the
    cosine schedule, so the frameworks' 1e-6 apart model outputs read 1e-4
    apart."""
    jfn, tm = mdm
    sj, st = _scheds()
    x = np.random.default_rng(t).normal(size=SHAPE).astype(np.float32)
    want, wx0 = jg.ddim_reverse_sample(sj, jfn, jnp.asarray(x), jnp.full((B,), t, jnp.int32),
                                       clip_denoised=False)
    with torch.no_grad():
        got, gx0 = ddim_reverse_sample(st, tm, torch.from_numpy(x), t, clip_denoised=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(gx0.numpy(), np.asarray(wx0), atol=ATOL)


@pytest.mark.parametrize("loop", ["ddpm", "ddim", "plms"])
@pytest.mark.parametrize("with_image", [False, True])
def test_skip_timesteps_warm_start(mdm, loop, with_image):
    """T − skip steps from q(x_{t0} | init_image), t0 = T − skip − 1 (zeros
    without an image)."""
    jfn, tm = mdm
    img = np.random.default_rng(7).normal(size=SHAPE).astype(np.float32) * 0.5
    jkw = {"init_image": jnp.asarray(img)} if with_image else {}
    tkw = {"init_image": torch.from_numpy(img)} if with_image else {}
    want, got = _run_both(loop, jfn, tm, skip_timesteps=4, clip_denoised=False, jkw=jkw, tkw=tkw)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _cond_fns():
    """The same analytic guidance gradient in each framework; it reads the
    timesteps it is given, so a wrong map to model timesteps shows."""
    jcond = lambda x, t: -0.1 * x * (1.0 + t.reshape(-1, 1, 1).astype(jnp.float32) / 1000.0)
    tcond = lambda x, t: -0.1 * x * (1.0 + t.reshape(-1, 1, 1).to(torch.float32) / 1000.0)
    return jcond, tcond


@pytest.mark.parametrize("loop", ["ddpm", "ddim", "plms"])
def test_cond_fn_guidance_matches_jax(mdm, loop):
    """condition_mean in DDPM, condition_score in DDIM and PLMS."""
    jfn, tm = mdm
    jcond, tcond = _cond_fns()
    want, got = _run_both(loop, jfn, tm, clip_denoised=False,
                          jkw={"cond_fn": jcond}, tkw={"cond_fn": tcond})
    np.testing.assert_allclose(got, want, atol=ATOL)
    _, plain = _run_both(loop, jfn, tm, clip_denoised=False)
    assert np.abs(got - plain).max() > 1e-3  # the guidance moved the sample


@pytest.mark.parametrize("loop", ["ddpm", "ddim"])
@pytest.mark.parametrize("mean_type", ["epsilon", "prev_x"])
def test_mean_types_match_jax(mdm, loop, mean_type):
    jfn, tm = mdm
    want, got = _run_both(loop, jfn, tm, clip_denoised=True,
                          jkw={"mean_type": jg.MeanType(mean_type)},
                          tkw={"mean_type": MeanType(mean_type)})
    np.testing.assert_allclose(got, want, atol=ATOL)


def _learned_models():
    """Analytic models with 2C output channels: a mean part and a variance
    part in [-1, 1] (LEARNED_RANGE's fraction; LEARNED reads it as a log
    variance)."""
    def jfn(x, t):
        s = t.reshape(-1, 1, 1).astype(jnp.float32) / 1000.0
        return jnp.concatenate([0.8 * x + 0.1 * s, jnp.tanh(x) - 0.5 * s], axis=-1)

    def tfn(x, t):
        s = t.reshape(-1, 1, 1).to(torch.float32) / 1000.0
        return torch.cat([0.8 * x + 0.1 * s, torch.tanh(x) - 0.5 * s], dim=-1)

    return jfn, tfn


@pytest.mark.parametrize("loop", ["ddpm", "ddim"])
@pytest.mark.parametrize("var_type", ["learned", "learned_range"])
def test_learned_variance_matches_jax(loop, var_type):
    jfn, tfn = _learned_models()
    want, got = _run_both(loop, jfn, tfn, clip_denoised=True,
                          jkw={"var_type": jg.VarType(var_type)},
                          tkw={"var_type": VarType(var_type)})
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_denoised_fn_matches_jax(mdm):
    jfn, tm = mdm
    want, got = _run_both("ddpm", jfn, tm, clip_denoised=False,
                          jkw={"denoised_fn": lambda x: 0.9 * x},
                          tkw={"denoised_fn": lambda x: 0.9 * x})
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_inpainting_matches_jax(mdm):
    jfn, tm = mdm
    rng = np.random.default_rng(9)
    mask = rng.random(SHAPE) < 0.5
    values = rng.normal(size=SHAPE).astype(np.float32) * 0.3
    want, got = _run_both(
        "ddpm", jfn, tm, clip_denoised=False,
        jkw={"inpainting": (jnp.asarray(mask), jnp.asarray(values))},
        tkw={"inpainting": (torch.from_numpy(mask), torch.from_numpy(values))})
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_const_noise_matches_jax(mdm):
    """const_noise: every sample takes sample 0's step noise."""
    jfn, tm = mdm
    want, got = _run_both("ddpm", jfn, tm, clip_denoised=False, const_noise=True)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "plms"])
def test_sample_latents_sampler(mdm, sampler):
    jfn, tm = mdm
    want, _ = _run_both(sampler, jfn, tm, clip_denoised=False)
    _, st = _scheds(name=_sched_name(sampler))
    noise = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
    steps = (None if sampler == "plms" else torch.from_numpy(
        jax_replay_noise(jax.random.PRNGKey(3), st.num_timesteps, SHAPE)))
    got = sample_latents(st, tm, B, L, sampler=sampler, device="cpu",
                         noise=torch.from_numpy(noise), step_noise=steps).numpy()
    assert got.shape == (B, L)
    np.testing.assert_allclose(got, want[..., 0], atol=ATOL)


def test_sample_latents_rejects_unknown_sampler(mdm):
    _, tm = mdm
    _, st = _scheds()
    with pytest.raises(ValueError, match="unknown sampler"):
        sample_latents(st, tm, B, L, torch.Generator(), sampler="euler", device="cpu")
    with pytest.raises(ValueError, match="step noise"):
        sample_latents(st, tm, B, L, sampler="plms", device="cpu", noise=torch.zeros(SHAPE),
                       step_noise=torch.zeros((st.num_timesteps, *SHAPE)))


def test_loop_noise_contract(mdm):
    """A generator, or injected noise (and step noise where the loop draws
    it); step noise must have T − skip rows."""
    _, tm = mdm
    _, st = _scheds()
    z = torch.zeros(SHAPE)
    with torch.no_grad():
        a = ddim_sample_loop(st, tm, SHAPE, torch.Generator().manual_seed(5), eta=0.5,
                             clip_denoised=False)
        b = ddim_sample_loop(st, tm, SHAPE, torch.Generator().manual_seed(5), eta=0.5,
                             clip_denoised=False)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        plms_sample_loop(st, tm, SHAPE, noise=z)  # no step noise needed
    with pytest.raises(ValueError, match="Generator"):
        ddim_sample_loop(st, tm, SHAPE, noise=z)
    with pytest.raises(ValueError, match="step_noise must be"):
        p_sample_loop(st, tm, SHAPE, noise=z, skip_timesteps=2,
                      step_noise=torch.zeros((st.num_timesteps, *SHAPE)))
    with pytest.raises(ValueError, match="skip_timesteps"):
        p_sample_loop(st, tm, SHAPE, torch.Generator(), skip_timesteps=st.num_timesteps)


def _category_pair(num_actions=3, seed=5):
    """Tiny category MDMs on equal weights; the CFG null row stays zero."""
    fm = FlaxMDM(cond_mode="category", model_channels=16, channel_mult=(1, 2),
                 num_res_blocks=1, num_actions=num_actions)
    init = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, L, 1)), jnp.zeros((1,), jnp.int32),
                   action=jnp.zeros((1,), jnp.int32))
    params = _randomize(jax.tree.map(np.asarray, dict(init["params"])),
                        np.random.default_rng(seed))
    params["unet"]["label_emb"]["embedding"][-1] = 0.0
    tm = MDM(cond_mode="category", model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
             num_actions=num_actions)
    tm.load_state_dict(mdm_state_from_flax({"params": params}, (1, 2), 1), strict=True)
    return fm, {"params": jax.tree.map(jnp.asarray, params)}, tm


def test_category_cfg_ddim_matches_jax():
    """DDIM through the category denoiser with guidance 2.5 (one batched
    pass of 2B with the null class)."""
    torch.set_num_threads(1)
    fm, fvars, tm = _category_pair()
    action = np.array([0, 2], np.int32)
    jfn = jax_cfg(fm, fvars, 2.5, action=jnp.asarray(action))
    tfn = make_cfg_model_fn(tm, 2.5, action=torch.from_numpy(action).long())
    want, got = _run_both("ddim", jfn, tfn, clip_denoised=False)
    np.testing.assert_allclose(got, want, atol=ATOL)
