"""`use_remat` and `dtype` on the port's UNet1D, MDM and EncoderUNet1D, and
the two small public functions `q_mean_variance` and `make_ae_apply_fns`,
on the CPU against surfd_tpu and against the port's own plain route.

Remat: each ResBlock1D under torch.utils.checkpoint, its dropout mask drawn
before the checkpoint and handed in. With dropout 0.1 and a seeded
generator, the forward, every gradient and the generator's state after the
step must equal the plain route's bit for bit; two faults must break that:
a recomputation that redraws its mask, and a checkpoint on a detached input
(no gradient reaches the layers below it). Train steps with remat on both
sides against JAX's `nn.remat` trainer, at the train-parity bars of
tests/test_torch_train_diffusion.py (dropout 0 there: JAX's masks cannot be
replayed in the port).

dtype: the input rounded to bfloat16 and the rest in float32, as the JAX
package runs it (flax promotes the rounded input to its f32 params): within
1e-5 of max(1, |JAX|), bit-equal to the f32 model on the rounded input, and
not equal to the f32 model on the raw input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from surfd_tpu.diffusion import gaussian as jg
from surfd_tpu.diffusion import named_schedule as jax_named_schedule
from surfd_tpu.models import MDM as FlaxMDM
from surfd_tpu.models import encoder_unet as jenc
from surfd_tpu.training import create_train_state as jax_create_state
from surfd_tpu.training import make_ae_apply_fns as jax_make_ae_apply_fns
from surfd_tpu.training import make_optimizer as jax_make_optimizer
from surfd_tpu.training import make_train_step as jax_make_train_step
from surfd_tpu_torch.diffusion import named_schedule, q_mean_variance
from surfd_tpu_torch.models import MDM
from surfd_tpu_torch.models.encoder_unet import EncoderUNet1D
from surfd_tpu_torch.models.unet1d import ResBlock1D, SeededDropout
from surfd_tpu_torch.training import (
    create_train_state,
    make_ae_apply_fns,
    make_optimizer,
    make_train_step,
)
from surfd_tpu_torch.utils.convert import mdm_state_from_flax
from test_torch_ae_trainer import _jax_init, _port_ae
from test_torch_ae_trainer import _randomize as _ae_randomize
from test_torch_train_diffusion import EMA_RATE, LR, _export
from test_torch_train_diffusion import _batches as _train_batches
from test_torch_train_diffusion import _randomize as _train_randomize
from test_torch_vestigial_models import ENC, _close, _encoder_pair

SMALL = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1)
L, B, NA, P_DROP = 16, 2, 3, 0.1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --- use_remat ---------------------------------------------------------------

def _models(kind, remat):
    """A small model of `kind` with seeded weights, dropout 0.1, train mode."""
    if kind == "encoder":
        m = EncoderUNet1D(**{**ENC, "pool": "adaptive"}, dropout=P_DROP, use_remat=remat)
        m.random_init_(torch.Generator().manual_seed(0))
    else:
        m = MDM(cond_mode="category", num_actions=NA, **SMALL, dropout=P_DROP, use_remat=remat)
        m.Unet.random_init_(torch.Generator().manual_seed(0))
    return m.train()


def _step(model, kind, seed=5):
    """One forward and backward pass with every SeededDropout drawing from a
    generator seeded `seed`: (output, {name: grad}, generator state after)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.generator = g
    rng = np.random.default_rng(1)
    if kind == "encoder":
        x = torch.from_numpy(rng.normal(size=(B, ENC["seq_len"], 1)).astype(np.float32))
        out = model(x, torch.tensor([3, 700]))
    else:
        x = torch.from_numpy(rng.normal(size=(B, L, 1)).astype(np.float32))
        out = model(x, torch.tensor([3, 700]), action=torch.tensor([0, 2]))
    (out.square().sum() + out.sum()).backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in model.named_parameters()}  # a parameter cut off gets none
    return out.detach(), grads, g.get_state()


@pytest.mark.parametrize("kind", ["mdm", "encoder"])
def test_remat_is_bit_equal_to_plain(kind):
    """Forward, every gradient and the dropout generator's state after the
    pass, bit for bit; the blocks' first convolutions get a gradient."""
    plain, remat = _models(kind, False), _models(kind, True)
    remat.load_state_dict(plain.state_dict())
    want, want_g, want_state = _step(plain, kind)
    got, got_g, got_state = _step(remat, kind)
    assert torch.equal(got, want)
    assert got_g.keys() == want_g.keys()
    for n in want_g:
        assert torch.equal(got_g[n], want_g[n]), n
    assert torch.equal(got_state, want_state)
    assert any(float(g.abs().max()) > 0 for n, g in got_g.items() if "in_layers" in n)


def test_remat_runs_only_resblocks_under_checkpoint(monkeypatch):
    """Each ResBlock1D, and nothing else, goes through checkpoint while grad
    is enabled; none under no_grad."""
    from surfd_tpu_torch.models import unet1d

    calls = []

    def counting(fn, *args, **kw):
        calls.append(fn.__self__)
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(unet1d, "checkpoint", counting)
    m = _models("mdm", True)
    n_res = sum(isinstance(x, ResBlock1D) for x in m.modules())
    _step(m, "mdm")
    assert len(calls) == n_res and all(isinstance(c, ResBlock1D) for c in calls)
    calls.clear()
    with torch.no_grad():
        m(torch.zeros(B, L, 1), torch.tensor([1, 2]), action=torch.tensor([0, 1]))
    assert not calls


def _redrawn_mask(self, x, emb):
    """Planted fault: the mask drawn inside the checkpoint, so the
    recomputation draws another and advances the generator."""
    return checkpoint(self._forward, x, emb, use_reentrant=False)


def _detached_input(self, x, emb):
    """Planted fault: the checkpoint's input detached."""
    keep = self.out_layers[2].draw(
        x.new_empty((x.shape[0], self.out_channels) + tuple(x.shape[2:])))
    return checkpoint(self._forward, x.detach(), emb, keep, use_reentrant=False)


@pytest.mark.parametrize("fault", [_redrawn_mask, _detached_input])
def test_remat_faults_break_bit_equality(monkeypatch, fault):
    """The checks of test_remat_is_bit_equal_to_plain reject each fault: the
    redrawn mask moves the gradients and the generator's state; the detached
    input leaves the layers below the last block without the right gradient."""
    plain, remat = _models("mdm", False), _models("mdm", True)
    remat.load_state_dict(plain.state_dict())
    want, want_g, want_state = _step(plain, "mdm")
    monkeypatch.setattr(ResBlock1D, "forward", lambda self, x, emb: (
        fault(self, x, emb) if self.use_remat and torch.is_grad_enabled()
        else self._forward(x, emb)))
    got, got_g, got_state = _step(remat, "mdm")
    assert torch.equal(got, want)  # the forward alone cannot see either fault
    assert not all(torch.equal(got_g[n], want_g[n]) for n in want_g)
    if fault is _redrawn_mask:
        assert not torch.equal(got_state, want_state)


def test_remat_train_step_keeps_the_generator():
    """make_train_step with remat and dropout 0.1, draws from one seeded
    generator: the metrics, the params after two steps and the generator's
    state equal the plain model's bit for bit."""
    runs = []
    for remat in (False, True):
        m = MDM(cond_mode="category", num_actions=NA, **SMALL, dropout=P_DROP, use_remat=remat)
        m.Unet.training_init_(torch.Generator().manual_seed(0), null_class=NA)
        state = create_train_state(m, make_optimizer(m.parameters(), LR))
        step = make_train_step(m, named_schedule("cosine", 1000), cond_mask_prob=0.5)
        g = torch.Generator().manual_seed(3)
        rng = np.random.default_rng(4)
        metrics = []
        for _ in range(2):
            batch = {"latents": rng.normal(size=(B, L)).astype(np.float32),
                     "action": rng.integers(0, NA, size=B).astype(np.int32)}
            t = rng.integers(0, 1000, size=B).astype(np.int32)
            metrics.append(step(state, batch, t, np.ones(B, np.float32), generator=g))
        runs.append((metrics, m.state_dict(), g.get_state()))
    (m0, p0, s0), (m1, p1, s1) = runs
    for a, b in zip(m0, m1):
        for k in ("loss", "per_example_loss", "grad_norm"):
            assert torch.equal(a[k], b[k]), k
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert torch.equal(s0, s1)


@pytest.fixture(scope="module")
def remat_steps():
    """Three train steps with remat on both sides, from the same weights and
    inputs (category, conditioning dropout 0.5, 64 channels), against JAX's
    make_train_step over MDM(use_remat=True)."""
    from test_torch_train_diffusion import COND_P, MC, MULT, NRB

    fm = FlaxMDM(cond_mode="category", model_channels=MC, channel_mult=MULT, num_res_blocks=NRB,
                 num_actions=NA, use_remat=True)
    init = jax.eval_shape(fm.init, jax.random.PRNGKey(0), jnp.zeros((1, L, 1)),
                          jnp.zeros((1,), jnp.int32), action=jnp.zeros((1,), jnp.int32))
    params = _train_randomize(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                           dict(init["params"])), np.random.default_rng(0))
    params["unet"]["label_emb"]["embedding"][-1] = 0.0
    tm = MDM(cond_mode="category", model_channels=MC, channel_mult=MULT, num_res_blocks=NRB,
             num_actions=NA, use_remat=True)
    tm.load_state_dict(mdm_state_from_flax({"params": params}, MULT, NRB), strict=True)
    tx = jax_make_optimizer(LR, 0.0)
    jstate = jax_create_state(params, tx, ema=True)
    jstep = jax_make_train_step(fm, jax_named_schedule("cosine", 1000), tx, ema_rate=EMA_RATE,
                                cond_mask_prob=COND_P)
    tstate = create_train_state(tm, make_optimizer(tm.parameters(), LR, 0.0), ema_rate=EMA_RATE)
    tstep = make_train_step(tm, named_schedule("cosine", 1000), cond_mask_prob=COND_P)
    out = {"jax": [], "port": [], "grads": []}
    for batch, t, w, key, noise, drop in _train_batches("category"):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), jnp.asarray(t),
                           jnp.asarray(w), key)
        loss, _ = tstep.loss_fn(batch, t, w, noise=noise, cond_drop=drop)
        loss.backward()
        out["grads"].append({n: p.grad.clone() for n, p in tm.named_parameters()})
        tm.zero_grad(set_to_none=True)
        out["jax"].append(jax.tree.map(np.asarray, jm))
        out["port"].append(tstep(tstate, batch, t, w, noise=noise, cond_drop=drop))
    out["jax_params"] = _export(jstate.params)
    out["port_params"] = {n: v.clone() for n, v in tm.state_dict().items()}
    return out


def test_remat_train_steps_match_jax_remat(remat_steps):
    """Losses 1e-5 relative at each step; after 3 AdamW steps the params
    within 1e-6 wherever every step's |g| > 1e-4 (the bars of the plain
    train-step tests, PERF.md §2)."""
    for jm, tm_ in zip(remat_steps["jax"], remat_steps["port"]):
        np.testing.assert_allclose(float(tm_["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm_["per_example_loss"].numpy(), jm["per_example_loss"],
                                   rtol=1e-5)
    jp, tp = remat_steps["jax_params"], remat_steps["port_params"]
    for n, p in tp.items():
        m = torch.stack([g[n].abs() for g in remat_steps["grads"]]).amin(0) > 1e-4
        if n == "Unet.label_emb.weight":
            p, m = p[:-1], m[:-1]
        if m.any():
            assert float((p - jp[n])[m].abs().max()) <= 1e-6, n


# --- dtype ---------------------------------------------------------------------

def _mdm_pair(dtype_t, dtype_j, seed=0):
    fm = FlaxMDM(cond_mode="no_cond", **SMALL, dtype=dtype_j)
    init = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, L, 1)), jnp.zeros((1,), jnp.int32))
    params = _train_randomize(jax.tree.map(np.asarray, dict(init["params"])),
                              np.random.default_rng(seed))
    tm = MDM(cond_mode="no_cond", **SMALL, dtype=dtype_t)
    tm.load_state_dict(mdm_state_from_flax({"params": params}, SMALL["channel_mult"],
                                           SMALL["num_res_blocks"]), strict=True)
    return fm, {"params": jax.tree.map(jnp.asarray, params)}, tm


def test_mdm_bf16_input_matches_jax():
    """MDM(dtype=bfloat16) against Flax's on the same weights: within 1e-5 of
    max(1, |JAX|); bit-equal to the f32 port model on the bf16-rounded input;
    unequal to the f32 model on the raw input; f32 out."""
    fm, fvars, tm = _mdm_pair(torch.bfloat16, jnp.bfloat16)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, L, 1)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    want = np.asarray(fm.apply(fvars, jnp.asarray(x), jnp.asarray(t)))
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    f32 = MDM(cond_mode="no_cond", **SMALL)
    f32.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got = tm(tx, tt)
        rounded = f32(tx.to(torch.bfloat16).float(), tt)
        raw = f32(tx, tt)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _close(got.numpy(), want)
    assert torch.equal(got, rounded)
    assert not torch.equal(got, raw)


def test_encoder_unet_bf16_input_matches_jax():
    """EncoderUNet1D(dtype=bfloat16) against Flax's, as the MDM."""
    _, fvars, tm32 = _encoder_pair("adaptive")
    fm = jenc.EncoderUNet1D(pool="adaptive", **ENC, dtype=jnp.bfloat16)
    tm = EncoderUNet1D(pool="adaptive", **ENC, dtype=torch.bfloat16)
    tm.load_state_dict(tm32.state_dict())
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, ENC["seq_len"], 1)).astype(np.float32)
    t = np.array([0, 250, 999], np.int32)
    want = np.asarray(fm.apply(fvars, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t))
        raw = tm32(torch.from_numpy(x), torch.from_numpy(t))
        rounded = tm32(torch.from_numpy(x).to(torch.bfloat16).float(), torch.from_numpy(t))
    _close(got.numpy(), want)
    assert torch.equal(got, rounded) and not torch.equal(got, raw)


# --- the two small public functions ---------------------------------------------

def test_q_mean_variance_matches_jax():
    """Mean, variance and log variance at a (B,) tensor of steps, 1e-6."""
    rng = np.random.default_rng(7)
    x0 = rng.normal(size=(4, L, 1)).astype(np.float32)
    t = np.array([0, 1, 500, 999], np.int32)
    want = jg.q_mean_variance(jax_named_schedule("cosine", 1000), jnp.asarray(x0),
                              jnp.asarray(t))
    got = q_mean_variance(named_schedule("cosine", 1000), torch.from_numpy(x0),
                          torch.from_numpy(t).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(np.asarray(w), g.shape),
                                   rtol=1e-6, atol=1e-6)
    assert got[1].shape == (4, 1, 1)


@pytest.mark.parametrize("train", [False, True])
def test_make_ae_apply_fns_match_jax(train):
    """encode and decode against JAX's pair on the same variables, in eval
    mode and in train mode (batch statistics), 1e-5 of max(1, |JAX|)."""
    from test_torch_ae_trainer import LATENT, NP, Q

    encoder, decoder, params, stats = _jax_init()
    params, stats = _ae_randomize(params, stats)
    jenc_fn, jdec_fn = jax_make_ae_apply_fns(encoder, decoder)
    rng = np.random.default_rng(8)
    pcd = rng.normal(size=(2, NP, 3)).astype(np.float32) * 0.5
    coords = rng.uniform(-1, 1, size=(2, Q, 3)).astype(np.float32)
    ev = {"params": params["encoder"], "batch_stats": stats["encoder"]}
    dv = {"params": params["decoder"], "batch_stats": stats["decoder"]}
    jl = jenc_fn(ev, jnp.asarray(pcd), train=train)
    jl = jl[0] if train else jl
    jo = jdec_fn(dv, jnp.asarray(coords), jl, train=train)
    jo = jo[0] if train else jo
    encode, decode = make_ae_apply_fns(_port_ae(params, stats))
    with torch.no_grad():
        tl = encode(torch.from_numpy(pcd), train=train)
        to = decode(torch.from_numpy(coords), tl, train=train)
    assert tl.shape == (2, LATENT)
    _close(tl.numpy(), np.asarray(jl))
    _close(to.numpy(), np.asarray(jo))
