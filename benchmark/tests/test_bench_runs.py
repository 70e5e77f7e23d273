"""Each cell driven end to end on the CPU at a tiny size through the plain
paths, the benchmark's look for a card skipped: sound runs come out correct;
runs with the timed path broken underneath (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is made)
come out not correct; and the control, the references in TF32 in the
program's place, fails a limit."""

import numpy as np
import pytest
import torch

import bench_tiny
from benchmark import harness
from benchmark.kinds import generate, train_ae, train_mdm

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(name, traced=False, seconds=0.2):
    cell = bench_tiny.tiny(name)
    res = harness.run_cell(cell, bench_tiny.SEED, seconds, traced, CPU)
    return cell, res, harness.result_line(cell, res, traced, {})


@pytest.mark.parametrize("name", [bench_tiny.GEN_CAT, bench_tiny.GEN_TEXT, bench_tiny.TRAIN_MDM,
                                  bench_tiny.TRAIN_AE])
def test_a_sound_run_is_correct(name):
    cell, res, line = run(name)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("name,expect", [
    (bench_tiny.TRAIN_MDM, {"mfu.train", "idle_share.train", "host_launches_per_step.train"}),
    (bench_tiny.TRAIN_AE, {"mfu.ae", "idle_share.ae", "host_launches_per_step.ae"}),
    (bench_tiny.GEN_TEXT, {"sample_step_ms.gen", "extract_s.gen", "fill_s.gen", "marching_s.gen",
                           "face_filter_s.gen", "mfu.gen", "idle_share.gen"})])
def test_a_traced_run_reports_its_per_layer_metrics(name, expect):
    # on a CPU no kernel of K1 runs: its roofline reads nothing and is left out
    cell, res, line = run(name, traced=True)
    assert line["correct"]
    assert expect <= set(line["metrics"])
    assert "k1_f32_roofline.gen" not in line["metrics"]
    assert "breakdown" in line


def test_inputs_come_from_the_seed():
    a = bench_tiny.tiny(bench_tiny.GEN_TEXT)
    p = generate.Program(a, 11, CPU)
    q = generate.Program(a, 11, CPU)
    r = generate.Program(a, 12, CPU)
    assert all(torch.equal(p.sd_mdm[k], q.sd_mdm[k]) for k in p.sd_mdm)
    assert not torch.equal(p.sd_mdm["Unet.out.2.weight"], r.sd_mdm["Unet.out.2.weight"])
    from benchmark import traffic
    assert torch.equal(traffic.prompt_tokens(11, 3, (5, 20)), traffic.prompt_tokens(11, 3, (5, 20)))


# --- faults planted under the timed path ---------------------------------------------------

def _unchanged_step(monkeypatch):
    from surfd_tpu_torch.diffusion import gaussian

    monkeypatch.setattr(gaussian, "p_sample", lambda sched, fn, x, t, noise, **kw: (x, x))
    monkeypatch.setattr(gaussian, "ddim_sample", lambda sched, fn, x, t, noise, **kw: (x, x))


def _half_the_meshes(monkeypatch):
    import surfd_tpu_torch.pipelines as pipelines

    real = pipelines.generate_meshes_pipelined

    def half(fns, *a, **k):
        fns = list(fns)
        return real(fns[: len(fns) // 2], *a, **k)

    monkeypatch.setattr(pipelines, "generate_meshes_pipelined", half)


def _latent_altered(monkeypatch):
    import surfd_tpu_torch.pipelines as pipelines

    real = pipelines.sample_latents
    monkeypatch.setattr(pipelines, "sample_latents",
                        lambda *a, **k: real(*a, **k) + 1e-3)


def _field_altered(monkeypatch):
    from surfd_tpu_torch.pipelines.generate import UdfEvaluator

    real = UdfEvaluator.__call__
    monkeypatch.setattr(UdfEvaluator, "__call__", lambda self, p: real(self, p) * 1.001)


def _mesh_moved(monkeypatch):
    import surfd_tpu_torch.pipelines.batch as batch
    from surfd_tpu_torch.geometry import Mesh

    real = batch.get_mesh_from_udf

    def moved(*a, **k):
        mesh, stats = real(*a, **k)
        return Mesh(mesh.vertices + np.float32(0.05), mesh.faces), stats

    monkeypatch.setattr(batch, "get_mesh_from_udf", moved)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_the_meshes, _latent_altered,
                                   _field_altered, _mesh_moved])
def test_a_broken_generation_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, _, line = run(bench_tiny.GEN_CAT)
    assert line["correct"] is False, line["checks"]


def _no_update(monkeypatch):
    import surfd_tpu_torch.training.diffusion_trainer as dt

    def skip(state, loss, buffers=None):
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return True, torch.zeros(())

    monkeypatch.setattr(dt, "apply_update_if_finite", skip)


def _half_batch(monkeypatch):
    import surfd_tpu_torch.training.diffusion_trainer as dt

    real = dt.training_losses

    def half(sched, fn, x0, t, **k):
        terms = real(sched, fn, x0, t, **k)
        keep = len(t) // 2
        return {key: v[:keep].repeat_interleave(len(t) // keep)[: len(t)] if v.dim() else v
                for key, v in terms.items()}

    monkeypatch.setattr(dt, "training_losses", half)


def _ae_no_update(monkeypatch):
    import surfd_tpu_torch.training.ae_trainer as at

    def skip(state, loss, buffers=None):
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return True, torch.zeros(())

    monkeypatch.setattr(at, "apply_update_if_finite", skip)


def _ae_half_batch(monkeypatch):
    import surfd_tpu_torch.training.ae_trainer as at

    real = at.on_device
    monkeypatch.setattr(at, "on_device", lambda x, *a, **k: real(x, *a, **k)[: len(x) // 2])


@pytest.mark.parametrize("name,fault", [(bench_tiny.TRAIN_MDM, _no_update),
                                        (bench_tiny.TRAIN_MDM, _half_batch),
                                        (bench_tiny.TRAIN_AE, _ae_no_update),
                                        (bench_tiny.TRAIN_AE, _ae_half_batch)])
def test_a_broken_train_step_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    _, _, line = run(name)
    assert line["correct"] is False, line["checks"]


# --- the control ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [bench_tiny.GEN_CAT, bench_tiny.GEN_TEXT, bench_tiny.TRAIN_MDM,
                                  bench_tiny.TRAIN_AE])
def test_the_control_fails_a_limit(name):
    cell = bench_tiny.tiny(name)
    driver = {"generate": generate, "train_mdm": train_mdm, "train_ae": train_ae}[
        cell["traffic"]["kind"]]
    (row,) = driver.readings(cell, [bench_tiny.SEED], CPU)
    lim = cell["traffic"]["check"]["limits"]
    sound = {k: row[k] for k in lim if k in row}
    control = {k: row[f"{k}_control"] for k in lim if f"{k}_control" in row}
    assert all(sound[k] <= lim[k] for k in control), (sound, lim)
    assert any(control[k] > lim[k] for k in control), (control, lim)
