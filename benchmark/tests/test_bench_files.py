"""The harness's files: the result line's keys, what the benchmark imports,
the files found by name, the contract's limits on BENCHMARK.json."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import bench_tiny
from benchmark import harness

BENCH = os.path.join(bench_tiny.ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & harness.FORBIDDEN, (path, tops & harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert "surfd_tpu_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "math", "numpy", "torch"}, (path, tops)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["surfd_tpu_torch", "surfd_tpu_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_modules(["surfd_tpu.models", "jax.numpy", "flax"]) == [
        "flax", "jax", "surfd_tpu"]


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "import bench_tiny; from benchmark import harness\n"
        "cell = bench_tiny.tiny(bench_tiny.TRAIN_MDM)\n"
        "harness.run_cell(cell, 5, 0.2, False, torch.device('cpu'))\n"
        "from benchmark.kinds import generate\n"
        "print(harness.forbidden_modules())\n"
    ) % (bench_tiny.ROOT, os.path.dirname(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_result_line_keys_and_checks_last():
    cell = {"per_layer": [], "end_to_end": [{"name": "mesh_s", "unit": "s"},
                                            {"name": "setup_s", "unit": "s"}]}
    res = {"e2e": {"mesh_s": 3.5, "setup_s": 20.0}, "checks": [("step_gap", 1e-6, 1e-4, "max"),
                                                              ("faces_min", 12, 10, "min")],
           "attempted": 4, "failed": 0}
    line = harness.result_line(cell, res, False, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"mesh_s": {"value": 3.5, "unit": "s"},
                               "setup_s": {"value": 20.0, "unit": "s"}}
    res["checks"][1] = ("faces_min", 9, 10, "min")
    assert harness.result_line(cell, res, False, {})["correct"] is False
    res["checks"][1] = ("faces_min", 12, 10, "min")
    res["failed"] = 1
    assert harness.result_line(cell, res, False, {})["correct"] is False
    # a check with nothing to read fails, and the line stays JSON
    res["failed"] = 0
    res["checks"][0] = ("step_gap", float("inf"), 1e-4, "max")
    line = harness.result_line(cell, res, False, {})
    assert line["correct"] is False and line["checks"]["step_gap"]["value"] == "inf"
    json.dumps(line, allow_nan=False)


def test_no_card_exits_non_zero_without_a_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          bench_tiny.GEN_CAT, "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=bench_tiny.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_new_workload_file_is_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(bench_tiny.ROOT, "BENCHMARK.json")))
    wl = json.load(open(os.path.join(BENCH, "workloads", "gen-cat-ddpm1000-r256.json")))
    wl["samples"] = 1
    (tmp_path / "benchmark" / "workloads" / "gen-cat-one-sample.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": "df3d-gen-one", "config": "df3d-l32",
                               "traffic": "gen-cat-one-sample", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("df3d-gen-one", str(tmp_path))
    assert cell["traffic"]["samples"] == 1
    assert cell["config"]["name"] == "df3d-l32"
    # per-layer metrics listed for named cells only do not reach the new cell
    assert cell["per_layer"] == []
    assert [m["name"] for m in cell["end_to_end"]] == ["setup_s"]


def test_benchmark_json_keeps_the_contracts_limits():
    b = json.load(open(os.path.join(bench_tiny.ROOT, "BENCHMARK.json")))
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert os.path.isfile(os.path.join(bench_tiny.ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and name.match(w["name"])
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert os.path.isfile(os.path.join(BENCH, "workloads", w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        # every listed cell reports the end-to-end metric the layer metric moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    assert len(json.dumps(b)) < 64 * 1024
