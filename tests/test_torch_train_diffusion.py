"""Diffusion training on the CPU against surfd_tpu: the training losses for
every mean, variance and loss type; the timestep samplers and the lr
anneal; one to three train steps against JAX's `make_train_step` on the
same exported weights, batches, timesteps, weights, noise and conditioning
dropout (no_cond and category); the non-finite skip; `run_chunked` against
the per-step loop; res-block dropout.

The MDMs are 64 channels wide: at 16 each GroupNorm32 group is one channel
and cancels the class embedding (ROADMAP queue 3), so the category case
would not test conditioning."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surfd_tpu.diffusion import gaussian as jg
from surfd_tpu.diffusion import named_schedule as jax_named_schedule
from surfd_tpu.diffusion import resample as jresample
from surfd_tpu.models import MDM as FlaxMDM
from surfd_tpu.training import create_train_state as jax_create_state
from surfd_tpu.training import make_optimizer as jax_make_optimizer
from surfd_tpu.training import make_train_step as jax_make_train_step
from surfd_tpu.utils.torch_convert import export_mdm_unet
from surfd_tpu_torch.diffusion import gaussian as tg
from surfd_tpu_torch.diffusion import named_schedule, resample
from surfd_tpu_torch.models import MDM
from surfd_tpu_torch.models.unet1d import SeededDropout
from surfd_tpu_torch.training import (
    DiffusionTrainConfig,
    DiffusionTrainer,
    annealed_lr,
    create_train_state,
    make_optimizer,
    make_train_step,
    staircase_lr,
)
from surfd_tpu_torch.utils.convert import pad_null_class_row

MC, MULT, NRB, L, B, NA = 64, (1, 2), 1, 16, 2, 3
LR, EMA_RATE, COND_P = 1e-4, 0.99, 0.5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


# --- the losses -------------------------------------------------------------

def _toy_model(learned: bool):
    """The same small model_fn in both frameworks: (B, L, 1) → (B, L, 1 or 2)."""
    def jfn(x, t):
        h = jnp.tanh(0.8 * x + 0.3 * t[:, None, None].astype(jnp.float32) / 1000.0)
        return jnp.concatenate([h, 0.5 * jnp.sin(x)], -1) if learned else h

    def tfn(x, t):
        h = torch.tanh(0.8 * x + 0.3 * t[:, None, None].float() / 1000.0)
        return torch.cat([h, 0.5 * torch.sin(x)], -1) if learned else h

    return jfn, tfn


@pytest.mark.parametrize("loss_type", list(tg.LossType))
@pytest.mark.parametrize("var_type", list(tg.VarType))
@pytest.mark.parametrize("mean_type", list(tg.MeanType))
def test_training_losses_match_jax(mean_type, var_type, loss_type):
    """Every term, per example, within 1e-5 relative (t = 0 takes the
    decoder NLL branch of the bound)."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, size=(4, 8, 1)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 1, 57, 99], np.int32)
    jfn, tfn = _toy_model(var_type.value.startswith("learned"))
    kw = dict(l1_weight=1000.0)
    want = jg.training_losses(
        jax_named_schedule("cosine", 100), jfn, jnp.asarray(x0), jnp.asarray(t), None,
        noise=jnp.asarray(noise), mean_type=jg.MeanType(mean_type.value),
        var_type=jg.VarType(var_type.value), loss_type=jg.LossType(loss_type.value), **kw)
    got = tg.training_losses(
        named_schedule("cosine", 100), tfn, torch.from_numpy(x0), torch.from_numpy(t).long(),
        noise=torch.from_numpy(noise), mean_type=mean_type, var_type=var_type,
        loss_type=loss_type, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_training_losses_draw_from_the_generator():
    sched = named_schedule("cosine", 10)
    x0, t = torch.zeros(2, 4, 1), torch.tensor([3, 9])
    a = tg.training_losses(sched, lambda x, tt: x, x0, t, generator=torch.Generator().manual_seed(1))
    b = tg.training_losses(sched, lambda x, tt: x, x0, t, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a["loss"], b["loss"]) and bool((a["loss"] > 0).all())


# --- samplers and the anneal -----------------------------------------------

@pytest.mark.parametrize("name", ["uniform", "loss-second-moment"])
def test_schedule_samplers_draw_equal_to_jax(name):
    """Bit-equal indices and weights on the same default_rng, the
    loss-second-moment sampler before and after its warm-up."""
    ours = resample.create_named_schedule_sampler(name, 20)
    ref = jresample.create_named_schedule_sampler(name, 20)
    assert ours.needs_losses == ref.needs_losses
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    feed = np.random.default_rng(5)
    for _ in range(150):
        a, b = ours.sample(6, r1), ref.sample(6, r2)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[0].dtype == np.int32 and a[1].dtype == np.float32
        losses = feed.uniform(0.1, 3.0, size=6) * (1 + a[0])
        ours.update_with_all_losses(a[0], losses)
        ref.update_with_all_losses(b[0], losses)
    if name == "loss-second-moment":
        assert ours._warmed_up() and ref._warmed_up()
        np.testing.assert_array_equal(ours.weights(), ref.weights())


@pytest.mark.parametrize("n", [0, 999, 1000, 12_345, 100_000])
def test_staircase_lr_matches_optax(n):
    """The lr of the update after n applied ones: lr·0.9^⌊n/1000⌋ floored
    at 1e-7, as optax's schedule reads it (f32 there, so 1e-6 relative)."""
    want = float(optax.exponential_decay(1e-4, 1000, 0.9, staircase=True, end_value=1e-7)(n))
    group = make_optimizer([torch.zeros(1, requires_grad=True)], lr=1e-4).param_groups[0]
    np.testing.assert_allclose(staircase_lr(group, n), want, rtol=1e-6)


@pytest.mark.parametrize("n", [0, 999, 1000, 12_345, 100_000])
def test_annealed_lr_reads_the_staircase_at_a_device_count(n):
    """The lr that the update reads from the device count: staircase_lr at
    that count rounded to f32 (the fused kernel's lr), exactly."""
    group = make_optimizer([torch.zeros(1, requires_grad=True)], lr=1e-4).param_groups[0]
    got = annealed_lr(group, torch.tensor(n))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.item() == np.float32(staircase_lr(group, n))


def test_skip_before_an_anneal_boundary_keeps_the_applied_counts_lr():
    """Annealing every 2 applied updates, a NaN batch at step 2 (count 1,
    one short of the boundary): steps 1-3 update at the base lr, since the
    skip applied nothing (a schedule on the step counter would anneal at
    step 3), and step 4 at 0.9 of it; the count reads 1, 1, 2, 3."""
    trainer = _small_trainer(1)
    trainer.state = create_train_state(
        trainer.mdm, make_optimizer(trainer.mdm.parameters(), 1e-3, decay_every=2))
    trainer.data_iter = _batches_of(poison_at=2)
    group = trainer.state.optimizer.param_groups[0]
    lrs, counts = [], []
    for k in range(1, 5):
        trainer.run(k)
        lrs.append(group["lr"].item())
        counts.append(int(trainer.state.count))
    assert counts == [1, 1, 2, 3]
    assert lrs == [np.float32(1e-3)] * 3 + [np.float32(1e-3 * 0.9)]


# --- train steps against JAX's make_train_step -----------------------------

def _randomize(tree, rng):
    return {k: _randomize(v, rng) if isinstance(v, dict)
            else (rng.normal(size=v.shape) * 0.2).astype(np.float32) for k, v in tree.items()}


def _export(params) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in
            export_mdm_unet({"params": jax.tree.map(np.asarray, params)}, MC, MULT, NRB).items()}


def _pair(cond_mode):
    """Flax MDM with seeded random params (the category null row zero, as
    at init), and the port's MDM on the same weights via export_mdm_unet."""
    fm = FlaxMDM(cond_mode=cond_mode, model_channels=MC, channel_mult=MULT,
                 num_res_blocks=NRB, num_actions=NA)
    kw = {"action": jnp.zeros((1,), jnp.int32)} if cond_mode == "category" else {}
    # shapes only: every value is drawn below
    init = jax.eval_shape(fm.init, jax.random.PRNGKey(0), jnp.zeros((1, L, 1)),
                          jnp.zeros((1,), jnp.int32), **kw)
    params = _randomize(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), dict(init["params"])),
                        np.random.default_rng(0))
    if cond_mode == "category":
        params["unet"]["label_emb"]["embedding"][-1] = 0.0
    tm = MDM(cond_mode=cond_mode, model_channels=MC, channel_mult=MULT, num_res_blocks=NRB,
             num_actions=NA)
    tm.load_state_dict(pad_null_class_row(_export(params), NA), strict=True)
    return fm, params, tm


def _batches(cond_mode, n=3, seed=1):
    """n steps of (batch, t, weights, PRNG key) for JAX, with the noise and
    the dropout mask JAX's step draws from each key, to replay in the port."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        batch = {"latents": (0.5 * rng.normal(size=(B, L))).astype(np.float32)}
        if cond_mode == "category":
            batch["action"] = rng.integers(0, NA, size=B).astype(np.int32)
        t = rng.integers(0, 1000, size=B).astype(np.int32)
        w = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
        key = jax.random.PRNGKey(10 + k)
        noise_key, _, cond_key = jax.random.split(key, 3)  # as make_train_step splits it
        drop = np.asarray(jax.random.bernoulli(cond_key, COND_P, (B,)))
        noise = np.asarray(jax.random.normal(noise_key, (B, L, 1), jnp.float32))
        out.append((batch, t, w, key, noise, drop))
    return out


def _jax_grads(fm, params, sched, batch, t, w, noise, drop):
    """JAX's gradient of make_train_step's loss, through its training_losses."""
    action = batch.get("action")
    if action is not None:
        action = jnp.where(jnp.asarray(drop), NA, jnp.asarray(action))

    def loss(p):
        terms = jg.training_losses(
            sched, lambda x, tt: fm.apply({"params": p}, x, tt, action=action),
            jnp.asarray(batch["latents"])[..., None], jnp.asarray(t), None,
            noise=jnp.asarray(noise), mean_type=jg.MeanType.START_X,
            var_type=jg.VarType.FIXED_SMALL, loss_type=jg.LossType.MSE, l1_weight=1000.0)
        return (terms["loss"] * jnp.asarray(w)).mean()

    return _export(jax.jit(jax.grad(loss))(params))


@pytest.fixture(scope="module", params=["no_cond", "category"])
def three_steps(request):
    """Three steps on each side from the same start; the port's gradients
    of each step and JAX's of the first; then one NaN batch on each side."""
    cond_mode = request.param
    fm, params, tm = _pair(cond_mode)
    jsched, tsched = jax_named_schedule("cosine", 1000), named_schedule("cosine", 1000)
    tx = jax_make_optimizer(LR, 0.0)
    jstate = jax_create_state(params, tx, ema=True)
    jstep = jax_make_train_step(fm, jsched, tx, ema_rate=EMA_RATE, cond_mask_prob=COND_P)
    tstate = create_train_state(tm, make_optimizer(tm.parameters(), LR, 0.0), ema_rate=EMA_RATE)
    tstep = make_train_step(tm, tsched, cond_mask_prob=COND_P)
    steps = _batches(cond_mode)
    out = {"mode": cond_mode, "jax": [], "port": [], "port_grads": []}
    out["jax_grads"] = _jax_grads(fm, params, jsched, *(steps[0][i] for i in (0, 1, 2, 4, 5)))
    for batch, t, w, key, noise, drop in steps:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), jnp.asarray(t),
                           jnp.asarray(w), key)
        loss, _ = tstep.loss_fn(batch, t, w, noise=noise, cond_drop=drop)
        loss.backward()
        out["port_grads"].append({n: p.grad.clone() for n, p in tm.named_parameters()})
        tm.zero_grad(set_to_none=True)
        out["jax"].append(jax.tree.map(np.asarray, jm))
        out["port"].append(tstep(tstate, batch, t, w, noise=noise, cond_drop=drop))
    out["jax_state"] = jstate
    out["port_after"] = {"step": tstate.step, "count": tstate.count,
                         "params": {n: v.clone() for n, v in tm.state_dict().items()},
                         "ema": {n: v.clone() for n, v in tstate.ema_state_dict().items()}}
    out["port_state"] = tstate
    # a NaN batch: no update on either side, the step counters advance
    batch, t, w, key, noise, drop = _batches(cond_mode, n=1, seed=9)[0]
    batch["latents"][0, 3] = np.nan
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt_before = copy.deepcopy(tstate.optimizer.state_dict()["state"])
    ema_before = [e.clone() for e in tstate.ema]
    count_before = tstate.count
    jnan, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), jnp.asarray(t), jnp.asarray(w), key)
    out["nan"] = {
        "port": tstep(tstate, batch, t, w, noise=noise, cond_drop=drop),
        "jax": jax.tree.map(np.asarray, jm), "jax_same": jax.tree.map(
            lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
            (jnan.params, jnan.opt_state, jnan.ema_params),
            (jstate.params, jstate.opt_state, jstate.ema_params)),
        "jax_step": int(jnan.step),
        "params_same": all(torch.equal(before[n], p) for n, p in tm.named_parameters()),
        "opt_same": all(torch.equal(opt_before[i][k], v[k]) for i, v in
                        tstate.optimizer.state_dict()["state"].items() for k in v),
        "ema_same": all(torch.equal(a, b) for a, b in zip(ema_before, tstate.ema)),
        "count": (count_before, tstate.count),
    }
    return out


def test_train_step_losses_match_jax(three_steps):
    """Loss and per-example loss within 1e-5 relative at each of 3 steps; the
    same metric keys; grad_norm and param_norm within 1e-3: JAX's jitted
    global_norm reads 1032.52 on gradients whose f64 norm is 1032.958 (its
    vdot under jit on the CPU, not the gradients, which hold to 1e-5 below)."""
    for jm, tm_ in zip(three_steps["jax"], three_steps["port"]):
        assert set(tm_) == set(jm)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm_["per_example_loss"].numpy(), jm["per_example_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm_["latent_l1"]), float(jm["latent_l1"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm_["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(tm_["param_norm"]), float(jm["param_norm"]), rtol=1e-3)
        assert tm_["nonfinite_skipped"] == float(jm["nonfinite_skipped"]) == 0.0


def test_train_step_gradients_match_jax(three_steps):
    """Step 1's gradient of every tensor within 1e-5 of the global max |g|
    (the category null row included: half the batch is dropped)."""
    want, got = three_steps["jax_grads"], three_steps["port_grads"][0]
    scale = max(float(v.abs().max()) for v in want.values())
    for n, g in got.items():
        if n == "Unet.label_emb.weight":
            g = g[:-1]
        assert float((g - want[n]).abs().max()) <= 1e-5 * scale, n
    if three_steps["mode"] == "category":
        assert float(got["Unet.label_emb.weight"][-1].abs().max()) > 0  # the null row trains


def test_train_step_params_and_ema_match_jax(three_steps):
    """After 3 AdamW steps (lr 1e-4) the params and the EMA (rate 0.99; one
    f32 ulp of a weight near 1 is 1.2e-7) within 1e-6 wherever |g| > 1e-4 at
    every step. Nearer zero Adam's m / (√v + ε) turns the frameworks' f32
    gradient rounding into lr-sized moves: read 1.24e-6 where |g| > 1e-5,
    3.2e-6 where |g| > 1e-6, 4.2e-4 anywhere."""
    js, ts = three_steps["jax_state"], three_steps["port_after"]
    assert int(js.step) == ts["step"] == ts["count"] == 3
    jp, je = _export(js.params), _export(js.ema_params)
    mask = {n: torch.stack([g[n].abs() for g in three_steps["port_grads"]]).amin(0) > 1e-4
            for n in jp}
    ema = ts["ema"]
    for n, p in ts["params"].items():
        e = ema[n]
        if n == "Unet.label_emb.weight":
            p, e, m = p[:-1], e[:-1], mask[n][:-1]
        else:
            m = mask[n]
        if m.any():
            assert float((p - jp[n])[m].abs().max()) <= 1e-6, n
            assert float((e - je[n])[m].abs().max()) <= 1e-6, n


def test_nonfinite_batch_skips_the_update(three_steps):
    """A NaN latent: nonfinite_skipped 1 on both sides; params, AdamW state
    and its count, and EMA unchanged; the step counter advances."""
    nan = three_steps["nan"]
    assert nan["port"]["nonfinite_skipped"] == float(nan["jax"]["nonfinite_skipped"]) == 1.0
    assert all(jax.tree.leaves(nan["jax_same"])) and nan["jax_step"] == 4
    assert nan["params_same"] and nan["opt_same"] and nan["ema_same"]
    assert nan["count"] == (3, 3) and three_steps["port_state"].step == 4
    assert not np.isfinite(float(nan["port"]["loss"]))


# --- the loop ---------------------------------------------------------------

def _small_trainer(steps_per_call, seed=0):
    mdm = MDM(cond_mode="category", model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
              num_actions=NA)
    mdm.Unet.random_init_(torch.Generator().manual_seed(seed))
    cfg = DiffusionTrainConfig(batch_size=2, num_steps=7, log_interval=4,
                               save_interval=100, cond_mask_prob=0.3, stall_exit_s=0)
    state = create_train_state(mdm, make_optimizer(mdm.parameters(), 1e-3))
    return DiffusionTrainer(cfg, mdm, named_schedule("cosine", 20), state, iter(()),
                            generator=torch.Generator().manual_seed(5))


def test_run_chunked_equals_the_per_step_loop():
    """Chunks of 3 (cut at the log step 4) against the same steps one by
    one with the same rows, timesteps, weights and generator: bit-equal."""
    rng = np.random.default_rng(2)
    bank = {"latents": torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32)),
            "action": torch.tensor([0, 1, 2, 0, 1])}
    chunked = _small_trainer(3)
    chunked.run_chunked(bank, steps_per_call=3)

    loop = _small_trainer(1)
    step_fn, np_rng, n = loop._step_fn, np.random.default_rng(0), 5
    rows = [o[s:s + 2] for o in (np_rng.permutation(n) for _ in range(1)) for s in (0, 2)]
    ks = []
    step = 0
    while step < 7:  # the chunk rule: 3 steps, cut at the next multiple of 4
        K = min(3, 7 - step, 4 - step % 4)
        ks.append(K)
        step += K
    for K in ks:
        while len(rows) < K:
            order = np_rng.permutation(n)
            rows += [order[0:2], order[2:4]]
        take, rows = rows[:K], rows[K:]
        t, w = loop.schedule_sampler.sample(K * 2, np_rng)
        for k in range(K):
            batch = {key: v[torch.as_tensor(take[k])] for key, v in bank.items()}
            step_fn(loop.state, batch, t.reshape(K, 2)[k], w.reshape(K, 2)[k],
                    generator=loop.generator)
    assert ks == [3, 1, 3] and chunked.state.step == loop.state.step == 7
    for a, b in zip(chunked.mdm.parameters(), loop.mdm.parameters()):
        assert torch.equal(a, b)


def test_dropout_is_seeded_and_inert_in_eval():
    """SeededDropout: identity in eval() and at p 0; in train() it keeps
    1 − p of the values, scaled by 1 / (1 − p), from its generator. The
    state dict is the one without dropout."""
    d = SeededDropout(0.25).train()
    x = torch.ones(4000)
    d.generator = torch.Generator().manual_seed(0)
    a = d(x)
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(a, d(x))
    assert set(a.unique().tolist()) == {0.0, float(torch.tensor(1 / 0.75))}
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.03
    assert torch.equal(d.eval()(x), x)
    m = MDM(model_channels=16, channel_mult=(1, 2), num_res_blocks=1, dropout=0.1)
    plain = MDM(model_channels=16, channel_mult=(1, 2), num_res_blocks=1)
    assert set(m.state_dict()) == set(plain.state_dict())


def _batches_of(poison_at=None, stop_at=None):
    """Endless category batches of latent 8; NaN at step `poison_at`; a
    SIGTERM to this process when batch `stop_at` is drawn."""
    import os
    import signal

    rng = np.random.default_rng(8)
    k = 0
    while True:
        k += 1
        if k == stop_at:
            os.kill(os.getpid(), signal.SIGTERM)
        b = {"latents": rng.normal(size=(2, 8)).astype(np.float32),
             "action": rng.integers(0, NA, size=2).astype(np.int32)}
        if k == poison_at:
            b["latents"][:] = np.nan
        yield b


def test_loss_aware_sampler_takes_finite_losses_only():
    trainer = _small_trainer(1)
    trainer.cfg.schedule_sampler = "loss-second-moment"
    trainer.schedule_sampler = resample.create_named_schedule_sampler("loss-second-moment", 20)
    trainer.data_iter = _batches_of(poison_at=3)
    trainer.run(5)
    assert trainer.state.step == 5 and trainer.state.count == 4
    assert int(trainer.schedule_sampler._loss_counts.sum()) == 8  # 4 finite steps of 2
    with pytest.raises(ValueError, match="uniform"):
        trainer.run_chunked({"latents": torch.zeros(4, 8)}, 2)


def test_sigterm_checkpoints_and_returns(tmp_path):
    """Preemption: the loop saves the state at the step it reached (forced)
    and returns; the run resumes from that checkpoint."""
    from surfd_tpu_torch.utils import Checkpointer, Logger

    trainer = _small_trainer(1)
    trainer.data_iter = _batches_of(stop_at=3)
    trainer.checkpointer = Checkpointer(str(tmp_path / "ckpt"))
    trainer.logger = Logger(str(tmp_path), formats=("jsonl",))
    state = trainer.run(7)
    assert state.step == 3 and trainer.checkpointer.latest_step() == 3
    assert '"preempted": 1.0' in (tmp_path / "metrics.jsonl").read_text()
    fresh = _small_trainer(1)
    trainer.checkpointer.restore(fresh.state)
    assert fresh.state.step == 3
    for a, b in zip(fresh.mdm.parameters(), trainer.mdm.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.9])
def test_ema_is_kept_iff_its_rate_is_set(rate):
    """One setting: create_train_state keeps an EMA iff ema_rate > 0, and
    the step moves it at that rate, ema ← rate·ema + (1 − rate)·params
    (within two f32 ulps: the rounding order differs)."""
    trainer = _small_trainer(1)
    mdm = trainer.mdm
    state = create_train_state(mdm, make_optimizer(mdm.parameters(), 1e-3), ema_rate=rate)
    assert (state.ema is None) == (rate == 0.0) and state.ema_rate == rate
    init = [p.detach().clone() for p in mdm.parameters()]
    trainer.state, trainer.data_iter = state, _batches_of()
    trainer.run(1)
    assert state.count == 1 and not all(torch.equal(a, p) for a, p in zip(init, mdm.parameters()))
    if rate:
        for e, a, p in zip(state.ema, init, mdm.parameters()):
            torch.testing.assert_close(e, rate * a + (1 - rate) * p.detach(), rtol=2.5e-7, atol=1e-7)
    with pytest.raises(ValueError, match="ema_rate"):
        create_train_state(mdm, make_optimizer(mdm.parameters(), 1e-3), ema_rate=1.0)


def test_logged_skips_count_since_the_last_log(tmp_path):
    """Log every 4 steps, NaN batches at steps 2 and 3: the log at step 4
    reads nonfinite_skipped 2, the one at step 8 reads 0."""
    from surfd_tpu_torch.utils import Logger

    trainer = _small_trainer(1)
    poisoned = _batches_of(poison_at=2)

    def batches():
        for k, b in enumerate(poisoned, 1):
            if k == 3:
                b["latents"][:] = np.nan
            yield b

    trainer.data_iter = batches()
    trainer.logger = Logger(str(tmp_path), formats=("jsonl",))
    trainer.run(8)
    trainer.logger.close()
    rows = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["nonfinite_skipped"]) for r in rows] == [(4, 2.0), (8, 0.0)]
    assert trainer.state.count == 6
