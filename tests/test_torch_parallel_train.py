"""Data-parallel training of the port on the CPU: gloo process groups of 2
ranks, each a subprocess of tests/torch_parallel_worker.py (see
tests/test_torch_parallel.py, whose `run_world` starts them, each world with
its own time limits).

The JAX reference is computed here: its trainer's steps with
`make_mesh(data=2)` on the 8-device CPU mesh of tests/conftest.py. Bars, as
tests/test_torch_train_diffusion.py's: losses 1e-5 rel, step-1 gradients
1e-5 of the global max |g|, params and EMA 1e-6 where |g| > 1e-4; against
JAX's meshed trainer and against the port's single process.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_worker

from surfd_tpu.diffusion import named_schedule as jax_named_schedule
from surfd_tpu.parallel import make_mesh as jax_make_mesh
from surfd_tpu.parallel import shard_batch as jax_shard_batch
from surfd_tpu.training import create_train_state as jax_create_state
from surfd_tpu.training import make_optimizer as jax_make_optimizer
from surfd_tpu.training import make_train_step as jax_make_train_step
from surfd_tpu_torch.diffusion import named_schedule
from surfd_tpu_torch.models import MDM
from surfd_tpu_torch.training import create_train_state, make_optimizer, make_train_step
from test_torch_parallel import run_world
from test_torch_train_diffusion import (
    COND_P,
    EMA_RATE,
    LR,
    MC,
    MULT,
    NA,
    NRB,
    L,
    _batches,
    _export,
    _jax_grads,
    _pair,
)

MDM_KW = dict(model_channels=MC, channel_mult=MULT, num_res_blocks=NRB, num_actions=NA)


@pytest.fixture(scope="module")
def train_refs():
    """The inputs of three category steps (B 2, cond dropout 0.5, injected
    noise and masks), the port's single-process run and JAX's trainer on a
    2-device 'data' mesh, from one init."""
    torch.set_num_threads(1)
    fm, params, tm = _pair("category")
    steps = _batches("category")
    init = {"category": {k: v.clone() for k, v in tm.state_dict().items()}}
    for mode in ("no_cond", "sketch"):
        m = MDM(cond_mode=mode, **MDM_KW).eval()
        m.Unet.random_init_(torch.Generator().manual_seed(7))
        init[mode] = m.state_dict()
    sched = named_schedule("cosine", 1000)
    state = create_train_state(tm, make_optimizer(tm.parameters(), LR), ema_rate=EMA_RATE)
    step = make_train_step(tm, sched, cond_mask_prob=COND_P)
    one = {"metrics": []}
    for batch, t, w, _, noise, drop in steps:
        one["metrics"].append(step(state, batch, t, w, noise=noise, cond_drop=drop))
    one["params"] = {n: v.clone() for n, v in tm.state_dict().items()}

    jsched = jax_named_schedule("cosine", 1000)
    tx = jax_make_optimizer(LR, 0.0)
    jstate = jax_create_state(params, tx, ema=True)
    jstep = jax_make_train_step(fm, jsched, tx, ema_rate=EMA_RATE, cond_mask_prob=COND_P)
    jmesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    jax_losses = []
    for batch, t, w, key, _, _ in steps:
        jstate, jm = jstep(jstate, jax_shard_batch(jmesh, jax.tree.map(jnp.asarray, batch)),
                           jnp.asarray(t), jnp.asarray(w), key)
        jax_losses.append((float(jm["loss"]), np.asarray(jm["per_example_loss"])))
    jgrads = _jax_grads(fm, params, jsched, *(steps[0][i] for i in (0, 1, 2, 4, 5)))
    inputs = {"init": init, "mdm_kw": MDM_KW, "lr": LR, "ema_rate": EMA_RATE, "cond_p": COND_P,
              "L": L, "steps": [(b, t, w, n, d) for b, t, w, _, n, d in steps]}
    return {"inputs": inputs, "one": one, "jax_losses": jax_losses, "jax_grads": jgrads,
            "jax_params": _export(jstate.params), "jax_ema": _export(jstate.ema_params)}


def test_ddp_train_steps_match_one_process_and_jax_mesh(tmp_path, train_refs):
    """Three steps at world 2 × B/2: each step's loss and per-example loss
    against the port's single process at B and JAX's meshed trainer (1e-5
    rel); step 1's DDP-averaged gradients against JAX's (1e-5 of the global
    max); the params and EMA after the steps (1e-6 where every step's |g| >
    1e-4); both ranks hold the same weights; no_cond and sketch take two
    DDP steps each (every parameter gets a gradient)."""
    res = run_world("train", 2, tmp_path, train_refs["inputs"], timeout=180)
    r0, r1 = res
    for n, v in r0["params"].items():
        assert torch.equal(v, r1["params"][n]), n
    for mode in ("no_cond", "sketch"):
        for n, v in r0[f"{mode}_params"].items():
            assert torch.equal(v, r1[f"{mode}_params"][n]), (mode, n)
    for got, one, (jl, jpe) in zip(r0["metrics"], train_refs["one"]["metrics"],
                                   train_refs["jax_losses"]):
        for want_l, want_pe in ((float(one["loss"]), one["per_example_loss"].numpy()), (jl, jpe)):
            np.testing.assert_allclose(float(got["loss"]), want_l, rtol=1e-5)
            np.testing.assert_allclose(got["per_example_loss"].numpy(), want_pe, rtol=1e-5)
        assert got["nonfinite_skipped"] == 0.0
    jg = train_refs["jax_grads"]
    scale = max(float(v.abs().max()) for v in jg.values())
    mask = {}
    for n, g in r0["grads"].items():
        gj = jg[n]
        if n == "Unet.label_emb.weight":
            g = g[:-1]
        assert float((g - gj).abs().max()) <= 1e-5 * scale, n
        mask[n] = gj.abs() > 1e-4
    for n, p in r0["params"].items():
        if n == "Unet.label_emb.weight":
            p, e = p[:-1], r0["ema"][n][:-1]
        else:
            e = r0["ema"][n]
        m = mask[n]
        if m.any():
            assert float((p - train_refs["jax_params"][n])[m].abs().max()) <= 1e-6, n
            assert float((e - train_refs["jax_ema"][n])[m].abs().max()) <= 1e-6, n
            one = train_refs["one"]["params"][n]
            one = one[:-1] if n == "Unet.label_emb.weight" else one
            assert float((p - one)[m].abs().max()) <= 1e-6, n


def test_loss_aware_sampler_history_equal_on_ranks(tmp_path, train_refs):
    """20 steps with the loss-second-moment sampler: both ranks' histories
    hold the global batch's losses, identically, and match the single
    process's within 1e-5 rel (80 examples, short of its warm-up, so the
    draws stay uniform and alike)."""
    r0, r1 = run_world("sampler", 2, tmp_path, train_refs["inputs"])
    np.testing.assert_array_equal(r0["history"], r1["history"])
    np.testing.assert_array_equal(r0["counts"], r1["counts"])
    one = torch_parallel_worker.case_sampler(train_refs["inputs"], 0, 1, None)
    np.testing.assert_array_equal(r0["counts"], one["counts"])
    np.testing.assert_allclose(r0["history"], one["history"], rtol=1e-5)
    assert (r0["history"] > 0).sum() == r0["counts"].sum() > 40


def test_only_rank0_writes_and_a_world2_resume(tmp_path, train_refs):
    """The checkpoint and the log come from rank 0 alone; both ranks resume
    from it at step 2 and end at step 3 with equal weights."""
    r0, r1 = run_world("ckpt", 2, tmp_path, train_refs["inputs"])
    assert os.listdir(tmp_path / "ckpt_r0") == ["step_000000002.pt"]
    assert os.listdir(tmp_path / "ckpt_r1") == []
    assert (tmp_path / "log_r0" / "metrics.jsonl").read_text().count("\n") == 2
    log1 = tmp_path / "log_r1" / "metrics.jsonl"
    assert not log1.exists() or log1.read_text() == ""
    assert r0["step"] == r1["step"] == 3
    for n, v in r0["params"].items():
        assert torch.equal(v, r1["params"][n]), n

