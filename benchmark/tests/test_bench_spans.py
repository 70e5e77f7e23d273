"""The program's spans as the per-layer readers take them: a span run inside a
traced session lies within the session's [t0, t1] (and, on a card, holds the
trace's interval of a kernel it waited for); the readers' arithmetic on
synthetic sessions and spans; a program without spans gives nothing to read;
the tiny cells' traced runs report what a CPU can give."""

import json
import subprocess
import sys

import pytest
import torch

import bench_tiny
from benchmark import harness, spans, trace
from benchmark.trace import Session

MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def empty_buffer():
    from surfd_tpu_torch.utils import profiling

    profiling.clear()
    yield
    profiling.clear()


def _span(name, a, b, device_ms=None):
    return {"name": name, "start_ns": a * MS, "end_ns": b * MS, "device_ms": device_ms}


def _sampling(ops):
    return {"traced": {"sample_session": Session(0, 100 * MS, [
        ("k", a * MS, b * MS, None) for a, b in ops], [])}}


SAMPLING = [_span("sample", 0, 100),
            _span("sample.step", 10, 50), _span("sample.denoise", 15, 35),
            _span("sample.step", 50, 90), _span("sample.denoise", 55, 75)]


@pytest.mark.parametrize("grids", [False, True])
def test_a_span_in_a_traced_session_lies_within_it(grids):
    from surfd_tpu_torch.utils.profiling import span

    def work():
        with span("inside"):
            return torch.ones(64).sum()

    _, sess = trace.profile(work, grids=grids)
    (got,) = spans.in_session(sess, {"inside"})
    assert sess.t0 <= got["start_ns"] <= got["end_ns"] <= sess.t1


def test_sampler_split_puts_each_idle_stretch_where_the_host_was():
    # steps [10, 50] and [50, 90] ms, denoiser calls [15, 35] and [55, 75]; busy 12-20,
    # 30-45, 60-62, 80-95. Idle in the steps: 10-12 (begins outside a denoiser call),
    # 20-30 (inside one), 45-60 (begins outside, runs into the next call), 62-80
    # (begins inside, runs past the call's end)
    got = spans.sampler_split(_sampling([(12, 20), (30, 45), (60, 62), (80, 95)]), SAMPLING)
    assert got == {"busy_ms": (8 + 15 + 2 + 10) / 2, "denoise_idle_ms": (10 + 18) / 2,
                   "sampler_idle_ms": (2 + 15) / 2}
    assert sum(got.values()) == 80 / 2  # the host's time in the steps, per step


def test_sampler_split_reads_nothing_without_steps_or_device_operations():
    assert spans.sampler_split(_sampling([(12, 20)]), []) is None
    assert spans.sampler_split(_sampling([]), SAMPLING) is None
    assert spans.sampler_split({"traced": {}}, SAMPLING) is None


def test_mean_device_ms_takes_the_traced_sessions_spans():
    run = {"traced": {"sessions": [Session(0, 100 * MS, [], []), Session(200 * MS, 300 * MS, [],
                                                                       [])]}}
    given = [_span("train.forward", 1, 5, 3.0), _span("train.forward", 210, 230, 5.0),
             _span("train.forward", 150, 160, 100.0),  # between the sessions
             _span("train.backward", 6, 9, 7.0), _span("train.update", 9, 10)]
    assert spans.mean_device_ms(run, "train.forward", given) == 4.0
    assert spans.mean_device_ms(run, "train.backward", given) == 7.0
    assert spans.mean_device_ms(run, "train.update", given) is None  # no CUDA events


def test_a_program_without_spans_gives_none(monkeypatch):
    from surfd_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert spans.program_spans() == []
    assert spans.sampler_split(_sampling([(12, 20)])) is None


def test_the_traced_tiny_cells_report_what_a_cpu_gives():
    torch.set_num_threads(2)
    cell = bench_tiny.tiny(bench_tiny.GEN_CAT)
    res = harness.run_cell(cell, bench_tiny.SEED, 0.2, True, torch.device("cpu"))
    line = harness.result_line(cell, res, True, {})
    got = line["metrics"]
    parts = [got[n]["value"] for n in ("finalize_s.gen", "laplacian_s.gen", "components_s.gen")]
    meshes = [m for j in res["layer"]["jobs"] for m in j["meshes"]]
    cleanup = sum(m[1]["times"]["cleanup"] for m in meshes) / len(meshes)
    assert abs(sum(parts) - cleanup) <= 1e-3
    # the device readers have no device operations on a CPU, though the spans are there
    assert not {"step_busy_ms.gen", "denoise_idle_ms.gen", "sampler_idle_ms.gen"} & set(got)
    sess = res["layer"]["traced"]["sample_session"]
    assert len(spans.in_session(sess, {"sample.step"})) == cell["config"]["diffusion"][
        "diffusion_steps"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the trace's kernel intervals")
    return torch.device("cuda")


# run in a process of its own: on the card, once a tiny cell has run on the CPU in a
# process, torch.profiler records no kernels there
CLOCK_CHECK = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from benchmark import spans, trace
from surfd_tpu_torch.utils.profiling import span

torch.cuda._sleep(1000)  # the kernel built and its context warm


def work():
    with span("sleep"):
        torch.cuda._sleep(50_000_000)  # tens of ms
        torch.cuda.synchronize()


_, sess = trace.profile(work, grids=sys.argv[2] == "1")
(got,) = spans.in_session(sess, {"sleep"})
name, a, b, _ = max(sess.ops, key=lambda op: op[2] - op[1])
print(json.dumps([got, name, a, b]))
"""


@pytest.mark.parametrize("grids", [False, True])
def test_a_span_holds_the_kernel_it_waited_for(cuda, grids):
    out = subprocess.run([sys.executable, "-c", CLOCK_CHECK, bench_tiny.ROOT, str(int(grids))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got, name, a, b = json.loads(out.stdout.strip().splitlines()[-1])
    seen = (name, a, b, got)
    assert b - a > 5 * MS, seen
    # the shared clock: the kernel's trace interval inside the span's, within 0.1 ms
    assert got["start_ns"] - 0.1 * MS <= a and b <= got["end_ns"] + 0.1 * MS, seen
    assert got["device_ms"] == pytest.approx((b - a) / MS, rel=0.05, abs=0.2), seen
