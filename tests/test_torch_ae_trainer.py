"""AE training on the CPU against surfd_tpu: the train-mode decoder's
coordinate VJP against `jax.vjp`; 1-3 `make_ae_train_step` steps against
JAX's on the same weights and batches (losses, step-1 gradients, params,
every BatchNorm running buffer), with torch's unbiased running variance and
a swapped momentum planted, which must fail the buffers' bar; the
non-finite skip (params, AdamW's moments and the BatchNorm buffers stay);
`make_ae_eval_step` and `curriculum_validate` per item; `init_ae`'s
distributions against JAX's `init_ae`; the flat-npz bridges' round trip.

Small widths (latent 8, hidden 32, 2 blocks, B 2, 256 cloud points, 512
queries); weights go from JAX's variables, randomised so that no path is
zero at the start, into the port through utils/convert.py."""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from surfd_tpu.models import CoordsEncoder
from surfd_tpu.training import AETrainConfig as JaxAECfg
from surfd_tpu.training import create_train_state as jax_create_state
from surfd_tpu.training import curriculum_validate as jax_curriculum_validate
from surfd_tpu.training import init_ae as jax_init_ae
from surfd_tpu.training import make_ae_eval_step as jax_make_eval_step
from surfd_tpu.training import make_ae_train_step as jax_make_train_step
from surfd_tpu.training import make_optimizer as jax_make_optimizer
from surfd_tpu.utils.checkpoint import load_params_npz
from surfd_tpu_torch.data import UdfDataset, prepare_udf_sample
from surfd_tpu_torch.data.preprocess import PreprocessConfig
from surfd_tpu_torch.geometry import marching_tetrahedra
from surfd_tpu_torch.models import decoder as tdecoder
from surfd_tpu_torch.models import dgcnn as tdgcnn
from surfd_tpu_torch.models import coords_encode
from surfd_tpu_torch.training import (
    AETrainConfig,
    AutoEncoder,
    create_train_state,
    curriculum_validate,
    init_ae,
    make_ae_eval_step,
    make_ae_train_step,
    make_optimizer,
    snapshot_buffers,
)
from surfd_tpu_torch.training.ae_trainer import coords_gradient
from surfd_tpu_torch.utils.checkpoint import save_params_npz
from surfd_tpu_torch.utils.convert import (
    decoder_flat_from_state,
    decoder_state_from_flax,
    dgcnn_flat_from_state,
    dgcnn_state_from_flax,
    nest_flat_keys,
)

LATENT, HIDDEN, LAYERS, B, NP, Q = 8, 32, 2, 2, 256, 512
LR, MAX_DIST = 1e-4, 0.1  # the deepfashion3d preset's lr
BUFFER_BAR = 1e-5  # of max(1, |JAX|)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _jax_init(hidden=HIDDEN):
    cfg = JaxAECfg(latent_size=LATENT, hidden_dim=hidden, num_hidden_layers=LAYERS)
    return jax_init_ae(jax.random.PRNGKey(0), cfg, jnp.zeros((1, NP, 3)), jnp.zeros((1, Q, 3)))


def _randomize(params, stats, seed=0):
    """Every param moved by N(0, 0.1²) (the zero-initialised kernels too),
    running means N(0, 0.1²), running variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)
                                     ).astype(np.float32), params)
    stats = jax.tree_util.tree_map_with_path(
        lambda kp, a: (rng.uniform(0.5, 1.5, a.shape) if kp[-1].key == "var"
                       else 0.1 * rng.normal(size=a.shape)).astype(np.float32), stats)
    return params, stats


def _port_state(params, stats) -> dict:
    """JAX's {'encoder', 'decoder'} variables as the AutoEncoder's state dict."""
    enc = dgcnn_state_from_flax({"params": params["encoder"], "batch_stats": stats["encoder"]})
    dec = decoder_state_from_flax({"params": params["decoder"], "batch_stats": stats["decoder"]})
    return {**{f"encoder.{k}": v for k, v in enc.items()}, **dec}


def _port_ae(params, stats) -> AutoEncoder:
    ae = AutoEncoder(LATENT, HIDDEN, LAYERS)
    ae.load_state_dict(_port_state(params, stats), strict=True)
    return ae


@pytest.fixture(scope="module")
def pair():
    encoder, decoder, params, stats = _jax_init()
    params, stats = _randomize(params, stats)
    return encoder, decoder, params, stats


def _batches(n=3, seed=1):
    """n AE batches around a sphere of radius 0.5: clouds on it, uniform
    queries, UDF labels clipped at MAX_DIST (about half strictly inside the
    grad loss's mask), unit radial gradients."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = rng.normal(size=(B, NP, 3))
        pcd = 0.5 * d / np.linalg.norm(d, axis=-1, keepdims=True) + 0.01 * rng.normal(size=d.shape)
        r = rng.uniform(0.35, 0.65, (B, Q, 1))
        d = rng.normal(size=(B, Q, 3))
        unit = d / np.linalg.norm(d, axis=-1, keepdims=True)
        coords = r * unit
        udf = np.minimum(np.abs(r[..., 0] - 0.5), MAX_DIST)
        out.append({"pcd": pcd.astype(np.float32), "coords": coords.astype(np.float32),
                    "udf": udf.astype(np.float32),
                    "gradients": (np.sign(r - 0.5) * unit).astype(np.float32)})
    return out


def _grab():
    """An optax transformation that applies nothing and keeps the gradients
    as its state: JAX's real step then hands back its own gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _buffers(ae) -> dict:
    return {k: v.clone() for k, v in ae.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _buffer_gap(got: dict, params, stats) -> float:
    """max |port − JAX| / max(1, |JAX|) over every running mean and variance."""
    want = _port_state(params, stats)
    return max(float(((g - want[k]).abs() / want[k].abs().clamp(min=1.0)).max())
               for k, g in got.items())


def test_coordinate_vjp_matches_jax(pair):
    """∂udf/∂coords of the train-mode decoder (batch statistics over all
    B·Q points, in the graph) within 1e-5 of max |∂| of jax.vjp's; with the
    statistics detached it is off by far more."""
    _, fdec, params, stats = pair
    rng = np.random.default_rng(3)
    coords = rng.uniform(-1, 1, (B, Q, 3)).astype(np.float32)
    latent = rng.normal(size=(B, LATENT)).astype(np.float32)
    variables = {"params": params["decoder"], "batch_stats": stats["decoder"]}

    def udf_of_coords(c):
        logits, _ = fdec.apply(variables, CoordsEncoder().encode(c), jnp.asarray(latent),
                               train=True, mutable=["batch_stats"])
        return (1.0 - jax.nn.sigmoid(logits)) * MAX_DIST

    udf, vjp_fn = jax.vjp(udf_of_coords, jnp.asarray(coords))
    want = np.asarray(vjp_fn(jnp.ones_like(udf))[0])
    dec = _port_ae(params, stats).decoder.train()

    def port_vjp():
        c = torch.from_numpy(coords).requires_grad_(True)
        u = (1.0 - torch.sigmoid(dec(coords_encode(c), torch.from_numpy(latent)))) * MAX_DIST
        np.testing.assert_allclose(u.detach().numpy(), np.asarray(udf), rtol=1e-5, atol=1e-7)
        return coords_gradient(u, c).detach().numpy()

    scale = np.abs(want).max()
    assert np.abs(port_vjp() - want).max() <= 1e-5 * scale

    def detached(x, bn, training):
        flat = x.reshape(-1, x.shape[-1])
        mean = flat.mean(0).detach()
        var = (flat.square().mean(0) - mean.square()).clamp(min=0).detach()
        return (x - mean) * torch.rsqrt(var + bn.eps)

    with mock.patch.object(tdecoder, "batch_norm", detached):
        assert np.abs(port_vjp() - want).max() > 1e-3 * scale


def _torch_bn(x, bn, training):
    """torch's own train-mode BatchNorm: its running variance is unbiased."""
    flat = x.reshape(-1, x.shape[-1])
    return F.batch_norm(flat, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        training=training, momentum=bn.momentum, eps=bn.eps).reshape(x.shape)


def _port_run(params, stats, batches):
    """The port's AutoEncoder trained on `batches`: each step's gradients
    (taken by a backward of `loss_fn` with the BatchNorm buffers put back
    after it) and metrics, then the params and BatchNorm buffers."""
    ae = _port_ae(params, stats)
    state = create_train_state(ae, make_optimizer(ae.parameters(), LR))
    step = make_ae_train_step(ae, MAX_DIST)
    grads, metrics, params_after = [], [], []
    for b in batches:
        saved = snapshot_buffers(ae)
        loss, terms = step.loss_fn(b)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in ae.named_parameters()})
        if not metrics:
            step1 = (float(loss.detach()), {k: float(v.detach()) for k, v in terms.items()})
        ae.zero_grad(set_to_none=True)
        for live, copy in saved:
            live.copy_(copy)
        metrics.append(step(state, b))
        params_after.append({n: p.detach().clone() for n, p in ae.named_parameters()})
    return {"grads": grads, "metrics": metrics, "state": state, "step1": step1,
            "params": params_after}


def _forced_buffer_gap(jax_states, batches, fault=None) -> float:
    """The worst `_buffer_gap` over the steps, each step taken by the port
    from JAX's state before it (params and BatchNorm buffers), against
    JAX's buffers after it. `fault`: None, 'unbiased' (torch's own
    train-mode BatchNorm, whose running variance is unbiased) or 'momentum'
    (0.9 on the batch's side)."""
    gaps = []
    for (p0, s0), (p1, s1), b in zip(jax_states, jax_states[1:], batches):
        ae = _port_ae(p0, s0)
        step = make_ae_train_step(ae, MAX_DIST)
        state = create_train_state(ae, make_optimizer(ae.parameters(), LR))
        with contextlib.ExitStack() as stack:
            if fault == "unbiased":
                for mod in (tdecoder, tdgcnn):
                    stack.enter_context(mock.patch.object(mod, "batch_norm", _torch_bn))
            elif fault == "momentum":
                for m in ae.modules():
                    if isinstance(m, torch.nn.BatchNorm1d):
                        m.momentum = 0.9
            step(state, b)
        gaps.append(_buffer_gap(_buffers(ae), p1, s1))
    return max(gaps)


@pytest.fixture(scope="module")
def three_steps(pair):
    """Three steps on each side from the same start and batches; JAX's
    state before and after each, and its step-1 gradients from its own step
    (through `_grab`)."""
    encoder, decoder, params, stats = pair
    batches = _batches()
    jbatches = [jax.tree.map(jnp.asarray, b) for b in batches]
    grab = _grab()
    gstep = jax_make_train_step(encoder, decoder, grab, max_dist=MAX_DIST)
    tx = jax_make_optimizer(LR)
    jstate = jax_create_state(params, tx, batch_stats=stats)
    jstep = jax_make_train_step(encoder, decoder, tx, max_dist=MAX_DIST)
    jmetrics, jstates, jgrads = [], [(params, stats)], []
    for b in jbatches:
        p0, s0 = jstates[-1]
        gstate, gm = gstep(jax_create_state(p0, grab, batch_stats=s0), b)
        jgrads.append(_port_state(jax.tree.map(np.asarray, gstate.opt_state), stats))
        if not jmetrics:
            step1 = jax.tree.map(float, gm)
        jstate, m = jstep(jstate, b)
        jmetrics.append(jax.tree.map(float, m))
        jstates.append(jax.tree.map(np.asarray, (jstate.params, jstate.batch_stats)))
    return {"jax_grads": jgrads, "jax_step1": step1, "jax": jmetrics, "jax_state": jstate,
            "jax_states": jstates, "port": _port_run(params, stats, batches),
            "batches": batches}


def test_train_step_losses_match_jax(three_steps):
    """loss, udf_loss and grad_loss within 1e-5 relative at each of 3 steps;
    grad_norm within 1e-3 (JAX's jitted global_norm, as in the diffusion
    tests); nothing skipped."""
    port = three_steps["port"]
    loss, terms = port["step1"]
    np.testing.assert_allclose(loss, three_steps["jax_step1"]["loss"], rtol=1e-5)
    for k in ("udf_loss", "grad_loss"):
        np.testing.assert_allclose(terms[k], three_steps["jax_step1"][k], rtol=1e-5)
    for jm, tm in zip(three_steps["jax"], port["metrics"]):
        assert set(tm) == set(jm)
        for k in ("loss", "udf_loss", "grad_loss"):
            np.testing.assert_allclose(float(tm[k]), jm[k], rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), jm["grad_norm"], rtol=1e-3)
        assert tm["nonfinite_skipped"] == jm["nonfinite_skipped"] == 0.0


# Biases that feed only BatchNorms (through the residual stream): their
# gradient is 0 in exact arithmetic, so each side reads rounding noise.
BN_CANCELLED = ("decoder.fc_p.bias", ".fc_0.bias", ".fc_1.bias")


def test_train_step_gradients_match_jax(three_steps):
    """Step 1's gradient of every tensor within 1e-5 of that tensor's max |g|
    (the grad loss's second-order terms included); the biases that only
    BatchNorms read stay within 1e-6 of the global max on both sides."""
    want, got = three_steps["jax_grads"][0], three_steps["port"]["grads"][0]
    assert set(got) == {k for k in want if not k.endswith(("running_mean", "running_var",
                                                           "num_batches_tracked"))}
    top = max(float(want[n].abs().max()) for n in got)
    for n, g in got.items():
        if n.endswith(BN_CANCELLED):
            assert max(float(g.abs().max()), float(want[n].abs().max())) <= 1e-6 * top, n
            continue
        scale = float(want[n].abs().max())
        assert scale > 1e-3 * top, n
        assert float((g - want[n]).abs().max()) <= 1e-5 * scale, n


def test_train_step_params_match_jax(three_steps):
    """The params after each step within 1e-6 wherever |g| > 1e-4 at every
    step so far (nearer zero Adam's m / (√v + ε) turns f32 rounding of the
    gradient into lr-sized moves; the BatchNorm-cancelled biases, whose
    gradient is all rounding, move by ~lr on each side): the decoder's
    after each of the 3 steps, the encoder's after steps 1 and 2. At step
    3's batch, 18 of the 131,072 maxima over the neighbours in DGCNN block 4
    are within 1e-6 of their runner-up (the closest 1.2e-7 apart), near-ties
    that each side breaks its own way: the
    encoder's whole gradient then moves by 3.2e-3 of conv_4's max |g|
    against JAX, and as much against the port's own float64 step from the
    same state (3.18e-3; 2.5e-6 and 3.2e-6 at steps 1 and 2), so it is
    ill-conditioned there, not wrong."""
    js, port = three_steps["jax_state"], three_steps["port"]
    assert int(js.step) == port["state"].step == port["state"].count == 3
    for k, got in enumerate(port["params"]):
        want = _port_state(*three_steps["jax_states"][k + 1])
        for n, p in got.items():
            if n.startswith("encoder.") and k == 2:
                continue
            mask = torch.stack([g[n].abs() for g in port["grads"][: k + 1]]).amin(0) > 1e-4
            if mask.any():
                assert float((p - want[n])[mask].abs().max()) <= 1e-6, (k, n)


@pytest.mark.parametrize("fault", [None, "unbiased", "momentum"])
def test_batchnorm_buffers_match_jax(three_steps, fault):
    """Every BatchNorm running mean and variance of both modules after each
    of 3 steps, each taken from JAX's state before it, within 1e-5 of
    max(1, |JAX|). (Over a free-running trajectory the BatchNorm-cancelled
    biases' lr-sized noise moves the running means by ~1e-4 on each side.)
    Each planted fault fails that bar: torch's unbiased running variance
    (B·Q / (B·Q − 1) = 1024 / 1023 in the decoder) and momentum 0.9 on the
    batch's side (torch's convention taken for flax's)."""
    gap = _forced_buffer_gap(three_steps["jax_states"], three_steps["batches"], fault)
    assert (gap <= BUFFER_BAR) == (fault is None), gap


def test_nonfinite_batch_restores_params_moments_and_buffers(pair):
    """A NaN cloud: nonfinite_skipped 1; params, AdamW's moments and count
    and every BatchNorm buffer unchanged; the step counter advances. The
    next good batch updates the params and moves the buffers."""
    _, _, params, stats = pair
    ae = _port_ae(params, stats)
    state = create_train_state(ae, make_optimizer(ae.parameters(), LR))
    step = make_ae_train_step(ae, MAX_DIST)
    good, bad = _batches(2, seed=4)
    step(state, good)
    bad["pcd"][1, 7] = np.nan
    before = {k: v.clone() for k, v in ae.state_dict().items()}
    opt_before = {i: {k: v.clone() for k, v in s.items()}
                  for i, s in state.optimizer.state_dict()["state"].items()}
    m = step(state, bad)
    assert m["nonfinite_skipped"] == 1.0 and not np.isfinite(float(m["loss"]))
    assert (state.step, state.count) == (2, 1)
    for k, v in ae.state_dict().items():
        assert torch.equal(v, before[k]), k
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt_before[i][k]), (i, k)
    m = step(state, good)
    assert m["nonfinite_skipped"] == 0.0 and (state.step, state.count) == (3, 2)
    after = ae.state_dict()
    assert not torch.equal(after["decoder.fc_p.weight"], before["decoder.fc_p.weight"])
    assert not torch.equal(after["decoder.bn.bn.running_var"], before["decoder.bn.bn.running_var"])


def test_nonfinite_step_changes_nothing_but_the_step_counter(pair):
    """The skip as the card takes it, decided on the device: with an EMA
    kept, a NaN cloud leaves the params, AdamW's two moments and per-param
    step, the count (a 0-d device tensor), the lr, the EMA and every
    BatchNorm buffer bit-equal to before; the step counter advances, the
    gradients are cleared, and `ok` and `nonfinite_skipped` are 0-d tensors
    that the step did not read. The next good batch moves all of them."""
    _, _, params, stats = pair
    ae = _port_ae(params, stats)
    state = create_train_state(ae, make_optimizer(ae.parameters(), LR), ema_rate=0.9)
    step = make_ae_train_step(ae, MAX_DIST)
    good, bad = _batches(2, seed=6)
    step(state, good)
    bad["pcd"][0, 3] = np.nan

    def snapshot():
        opt = state.optimizer
        return {"model": {k: v.clone() for k, v in ae.state_dict().items()},
                "opt": {i: {k: v.clone() for k, v in s.items()}
                        for i, s in opt.state_dict()["state"].items()},
                "ema": [e.clone() for e in state.ema], "count": state.count.clone(),
                "lr": opt.param_groups[0]["lr"].clone()}

    def same(a, b):
        return {"model": all(torch.equal(v, b["model"][k]) for k, v in a["model"].items()),
                "opt": all(torch.equal(v, b["opt"][i][k])
                           for i, s in a["opt"].items() for k, v in s.items()),
                "ema": all(torch.equal(x, y) for x, y in zip(a["ema"], b["ema"])),
                "count": torch.equal(a["count"], b["count"]), "lr": torch.equal(a["lr"], b["lr"])}

    before = snapshot()
    m = step(state, bad)
    assert isinstance(m["nonfinite_skipped"], torch.Tensor) and m["nonfinite_skipped"].dim() == 0
    assert m["nonfinite_skipped"] == 1.0 and state.step == 2 and state.count == 1
    assert state.count.dtype == torch.int64 and state.count.dim() == 0
    assert all(p.grad is None for p in ae.parameters())
    assert all(same(snapshot(), before).values()), same(snapshot(), before)
    m = step(state, good)
    assert m["nonfinite_skipped"] == 0.0 and (state.step, state.count) == (3, 2)
    moved = same(snapshot(), before)
    assert not any(moved[k] for k in ("model", "opt", "ema", "count")), moved


def test_skip_returns_a_device_bool(pair):
    """`apply_update_if_finite` hands back `ok` as a 0-d bool tensor on the
    loss's device, False for a non-finite loss and True for a finite one."""
    from surfd_tpu_torch.training import apply_update_if_finite

    _, _, params, stats = pair
    ae = _port_ae(params, stats)
    state = create_train_state(ae, make_optimizer(ae.parameters(), LR))
    for value, want in ((float("nan"), False), (float("inf"), False), (1.0, True)):
        loss = sum(p.sum() for p in ae.parameters()) * 0.0 + value
        loss.backward()
        ok, gnorm = apply_update_if_finite(state, loss.detach())
        assert ok.dtype == torch.bool and ok.dim() == 0 and bool(ok) is want, value
        assert gnorm.dim() == 0


def test_on_device_copies_host_arrays_on_the_cpu():
    """Without CUDA nothing is pinned: `on_device` gives the array's values
    as a copy (a later write to the array does not show), in the dtype
    asked, from read-only and non-contiguous arrays too; a tensor already
    on the device is handed through."""
    from surfd_tpu_torch.training.common import on_device

    cpu = torch.device("cpu")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = on_device(a, cpu)
    a[0, 0] = 99.0
    assert got[0, 0] == 0.0 and got.dtype == torch.float32
    a.flags.writeable = False
    assert torch.equal(on_device(a.T, cpu, torch.float64), torch.from_numpy(a.T.astype(np.float64)))
    t = torch.ones(2)
    assert on_device(t, cpu) is t


def _sphere(radius: float, r: int = 24):
    xs = np.linspace(-1, 1, r)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    return marching_tetrahedra(np.linalg.norm(g, axis=-1) - radius, iso=0.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five sphere items of radii 0.3-0.7 (small preprocessing counts)."""
    root = tmp_path_factory.mktemp("ae_corpus")
    (root / "train").mkdir()
    cfg = PreprocessConfig(num_points_pcd=600, counts=(400, 300, 50), num_uniform=50)
    for i, rad in enumerate((0.3, 0.4, 0.5, 0.6, 0.7)):
        np.savez(root / "train" / f"s{i}.npz", **prepare_udf_sample(_sphere(rad), cfg))
    return str(root)


def test_eval_and_curriculum_validate_match_jax(pair, corpus):
    """Per-item validation losses within 1e-5 relative of JAX's
    `curriculum_validate` on the same rng; at batch 1 and 4 the same draws
    and the same losses within 1e-6 relative: not bit for bit, as the BLAS
    kernels sum a matmul of 4 · 512 rows in another order than one of 512
    (1.2e-6 apart in a decoder logit); a loss that mixed items, as
    train-mode BatchNorm would, is off by far more. The eval step per
    example against JAX's eval step."""
    encoder, decoder, params, stats = pair
    jeval = jax_make_eval_step(encoder, decoder, max_dist=MAX_DIST)
    variables = {m: {"params": params[m], "batch_stats": stats[m]} for m in ("encoder", "decoder")}
    ds = UdfDataset(corpus, "train")
    cand = [0, 2, 3, 4]
    want = jax_curriculum_validate(jeval, variables, ds, cand, NP, Q,
                                   np.random.default_rng(5), batch_size=4)
    ae = _port_ae(params, stats)
    teval = make_ae_eval_step(ae, MAX_DIST)
    got = {bs: curriculum_validate(teval, ds, cand, NP, Q, np.random.default_rng(5), bs)
           for bs in (1, 4)}
    np.testing.assert_allclose(got[4], want, rtol=1e-5)
    np.testing.assert_allclose(got[1], got[4], rtol=1e-6)
    b = _batches(1, seed=6)[0]
    np.testing.assert_allclose(teval(b).numpy(), np.asarray(jeval(variables, b)), rtol=1e-5)


def test_init_ae_matches_jax_distributions():
    """`init_ae` against JAX's at hidden 64: the same tensors constant (CBN
    γ/β kernels 0, γ bias 1, fc_1 kernels 0, biases 0, BatchNorm scale 1,
    shift 0, running mean 0, variance 1) with the same values, and every
    lecun-normal kernel truncated at 2σ' (σ' = 1 / (√fan_in · 0.8796)) with
    a sample standard deviation, as JAX's, within 5 of its standard errors
    (√(1 / 2n) relative, n elements) of 1 / √fan_in."""
    _, _, params, stats = _jax_init(hidden=64)
    want = _port_state(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))
    ae = init_ae(AETrainConfig(latent_size=LATENT, hidden_dim=64, num_hidden_layers=LAYERS),
                 torch.Generator().manual_seed(0))
    assert not ae.training
    got = ae.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].float()
        if bool((w == w.flatten()[0]).all()) and w.numel() > 1:
            assert torch.equal(g, w.float()), k
        elif w.numel() > 1:
            fan_in = g.shape[1]
            sigma = 1.0 / np.sqrt(fan_in) / 0.87962566103423978
            assert float(g.abs().max()) <= 2 * sigma + 1e-7, k
            tol = 5 * np.sqrt(1 / (2 * w.numel()))
            for t in (g, w.float()):
                assert abs(float(t.std()) * np.sqrt(fan_in) - 1) < tol, k


def test_flat_bridges_round_trip(pair, tmp_path):
    """flax → state → flat npz keys → flax, bit-equal, for the decoder and
    the encoder; the flat keys are exactly JAX's `save_params_npz` keys; the
    port's `save_params_npz`, given the flat dict or the nested tree, writes
    what JAX's `load_params_npz` reads back bit for bit."""
    _, _, params, stats = pair
    for mod, to_state, to_flat in (("decoder", decoder_state_from_flax, decoder_flat_from_state),
                                   ("encoder", dgcnn_state_from_flax, dgcnn_flat_from_state)):
        variables = {"params": params[mod], "batch_stats": stats[mod]}
        flat = to_flat(to_state(variables))
        want = {"/".join(k.key for k in kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(variables)[0]}
        assert set(flat) == set(want)
        for k, v in flat.items():
            assert v.dtype == np.float32 and np.array_equal(v, want[k]), k
        back = nest_flat_keys(flat)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), back, variables)
        for i, tree in enumerate((flat, back)):
            path = str(tmp_path / f"{mod}_{i}.npz")
            save_params_npz(path, tree)
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                         load_params_npz(path, variables), back)
