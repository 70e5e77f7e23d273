"""The port's spans (`utils.profiling`): with no profiler a span records
nothing and still fills its `times`; under a CPU `torch.profiler` session
spans nest by parent and root, across the batch generator's pool thread
too; a `device_trace` holds them by name; the buffer is capped, counts
what it drops and loses nothing to threads sharing it. The spans where the work happens: the sampler's steps and
denoiser calls in every loop, the extraction's stages and passes (with the
stage `times` they write), the AE step's phases."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from surfd_tpu_torch.diffusion import named_schedule
from surfd_tpu_torch.pipelines import (
    MeshExtractionConfig,
    generate_meshes_pipelined,
    get_mesh_from_udf,
    make_udf_fn,
    sample_latents,
)
from surfd_tpu_torch.training import (
    AutoEncoder,
    create_train_state,
    make_ae_train_step,
    make_optimizer,
)
from surfd_tpu_torch.utils import profiling
from surfd_tpu_torch.utils.profiling import span
from test_torch_pipeline import LATENT, MAX_DIST, decoders  # noqa: F401

CFG = MeshExtractionConfig(resolution=48, max_dist=MAX_DIST, max_batch=2**14,
                           face_filter_mult=4.0, surface_bias="auto",
                           final_laplacian_iters=3, min_component_faces=10)
# get_mesh_from_udf's `times` keys before the cleanup's passes had spans
STAGE_KEYS = {"grid_fill", "marching", "mt_pass1", "mt_unique", "mt_grads", "mt_g8",
              "mt_pass2", "cleanup"}
FILTER_KEYS = {"face_filter", "ff_prep"}
CLEANUP_PARTS = ("cleanup_finalize", "cleanup_laplacian", "cleanup_components")


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def _fns(dec, n):
    lats = (np.random.default_rng(12).normal(size=(n, LATENT)) * 0.5).astype(np.float32)
    return [make_udf_fn(dec, None, lat, MAX_DIST, device="cpu", chunk=2**14) for lat in lats]


def test_no_profiler_records_nothing_and_fills_times():
    times = {}
    for _ in range(2):
        with span("outer", times, "outer_s"):
            with span("inner", times):
                assert profiling.current() is None
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert set(times) == {"outer_s", "inner"}
    assert times["outer_s"] >= times["inner"] > 0


def test_spans_nest_by_parent_and_root():
    with traced():
        with span("a"):
            with span("a.b"):
                with span("a.b.c"):
                    pass
            with span("a.d"):
                pass
        with span("e"):
            pass
    got = by_name(profiling.spans())
    (a,), (b,), (c,), (d,), (e,) = (got[n] for n in ("a", "a.b", "a.b.c", "a.d", "e"))
    assert a["parent"] is None and a["root"] == a["id"]
    assert b["parent"] == a["id"] and c["parent"] == b["id"] and d["parent"] == a["id"]
    assert {b["root"], c["root"], d["root"]} == {a["id"]}
    assert e["parent"] is None and e["root"] == e["id"] != a["id"]
    for inner, outer in ((b, a), (c, b), (d, a)):
        assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    assert all(r["device_ms"] is None for r in (a, b, c, d, e))  # no CUDA here
    assert profiling.current() is None


def test_buffer_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with traced():
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [r["name"] for r in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_threads_share_the_buffer_without_losing_a_span(monkeypatch):
    import sys
    import threading

    monkeypatch.setattr(profiling, "CAPACITY", 1000)
    workers, each = 16, 100
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with traced():
            def work():
                for _ in range(each):
                    with span("outer"):
                        with span("inner"):
                            pass

            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = profiling.spans()
    assert len(got) + profiling.dropped() == 2 * workers * each
    assert len(got) == 1000 and len({r["id"] for r in got}) == 1000
    ids = {r["id"]: r for r in got}
    for r in got:  # each inner span's parent is its own thread's outer span
        if r["name"] == "inner" and r["parent"] in ids:
            assert ids[r["parent"]]["thread"] == r["thread"]


def test_a_span_shows_in_the_device_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with span("extract.marching"):
            torch.ones(8).sum()
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(ev.get("name") == "extract.marching" for ev in events)


@pytest.mark.parametrize("depth", [1, 2])
def test_extract_spans_sit_in_the_callers_tree_across_the_pool(decoders, depth):
    torch.set_num_threads(1)
    with traced():
        with span("job"):
            out = list(generate_meshes_pipelined(iter(_fns(decoders[0], 2)), CFG, depth=depth,
                                                 return_stats=True))
    assert len(out) == 2
    got = by_name(profiling.spans())
    (job,) = got["job"]
    ids = {r["id"]: r for rs in got.values() for r in rs}
    assert len(got["extract"]) == 2
    for ex in got["extract"]:
        assert ex["parent"] == job["id"] and ex["root"] == job["id"]
        assert ex["thread"] != job["thread"]  # the pool's thread
    for name, parent in (("extract.fill", "extract"), ("extract.marching", "extract"),
                         ("extract.face_filter", "extract"), ("extract.cleanup", "extract"),
                         ("marching.pass1", "extract.marching"),
                         ("marching.grads", "extract.marching"),
                         ("face_filter.prep", "extract.face_filter"),
                         ("cleanup.finalize", "extract.cleanup"),
                         ("cleanup.laplacian", "extract.cleanup"),
                         ("cleanup.components", "extract.cleanup")):
        assert len(got[name]) == 2, name
        for r in got[name]:
            assert ids[r["parent"]]["name"] == parent and r["root"] == job["id"]


@pytest.mark.parametrize("setting", ["q16", "exact", "no_filter"])
def test_stage_times_keep_their_keys_and_the_cleanup_splits(decoders, setting):
    torch.set_num_threads(1)
    cfg = {"q16": CFG,
           "exact": MeshExtractionConfig(**{**CFG.__dict__, "quantized_filter_points": False}),
           "no_filter": MeshExtractionConfig(**{**CFG.__dict__, "filter_faces": False})}[setting]
    mesh, stats = get_mesh_from_udf(_fns(decoders[0], 1)[0], cfg=cfg, return_stats=True)
    assert len(mesh.faces) > 100
    times = stats["times"]
    want = STAGE_KEYS | (FILTER_KEYS if cfg.filter_faces else set())
    assert want | set(CLEANUP_PARTS) <= set(times)
    assert all(isinstance(v, float) and v >= 0 for v in times.values())  # seconds alone
    assert "mt_cubes" not in times and stats["mt_cubes"] > 0 and stats["mt_corners"] > 0
    assert abs(sum(times[k] for k in CLEANUP_PARTS) - times["cleanup"]) <= 1e-3
    assert profiling.spans() == []  # no profiler: nothing kept


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "plms"])
def test_sampler_spans_a_step_and_a_denoiser_call(sampler):
    sched = named_schedule("cosine", 6)
    calls = []

    def model_fn(x, t):
        calls.append(t)
        return x * 0.5

    with traced():
        sample_latents(sched, model_fn, 2, 4, torch.Generator().manual_seed(0), sampler=sampler,
                       device="cpu")
    got = by_name(profiling.spans())
    (root,) = got["sample"]
    assert len(got["sample.step"]) == 6
    # PLMS of order 2 calls the model twice in its first step
    assert len(got["sample.denoise"]) == len(calls) == (7 if sampler == "plms" else 6)
    steps = {r["id"] for r in got["sample.step"]}
    assert all(r["parent"] == root["id"] for r in got["sample.step"])
    assert all(r["parent"] in steps and r["root"] == root["id"] for r in got["sample.denoise"])


def test_ae_step_spans_its_phases():
    torch.manual_seed(0)
    ae = AutoEncoder(8, 32, 1, k=4)
    state = create_train_state(ae, make_optimizer(ae.parameters(), 1e-3))
    step = make_ae_train_step(ae, MAX_DIST)
    rng = np.random.default_rng(0)
    batch = {"pcd": rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32),
             "coords": rng.uniform(-1, 1, (2, 32, 3)).astype(np.float32),
             "udf": rng.uniform(0, MAX_DIST, (2, 32)).astype(np.float32),
             "gradients": rng.normal(size=(2, 32, 3)).astype(np.float32)}
    with traced():
        for _ in range(2):
            step(state, batch)
    got = by_name(profiling.spans())
    assert len(got["train.step"]) == 2
    roots = {r["id"] for r in got["train.step"]}
    for name in ("train.forward", "train.backward", "train.update"):
        assert len(got[name]) == 2 and {r["parent"] for r in got[name]} == roots, name
