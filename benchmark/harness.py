"""One run of one cell: find the cell's files by name, check the cards, run
its kind's driver, print the checks and the result line.

The result line's metrics are the cell's end-to-end metrics (`--trace 0`) or
its per-layer metrics (`--trace 1`), as `BENCHMARK.json` lists them; a
per-layer metric is the value its reader in `metrics/<name>.py` returns, and
is left out of the line where the reader finds nothing.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may hold: the JAX stack and the JAX
# package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "surfd_tpu"})


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT, bench: dict | None = None) -> dict:
    """The cell `name` of root/BENCHMARK.json (or of `bench`, a document of
    its layout) with its configuration and traffic files and the metrics
    that apply to it."""
    bench = bench or load_json(root, "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    applies = lambda m: name in m.get("workloads", [name])
    here = os.path.join(root, os.path.relpath(HERE, ROOT))
    return {
        "name": name,
        "chips": wl["chips"],
        "config": load_json(root, conf["file"]),
        "traffic": load_json(here, "workloads", wl["traffic"] + ".json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
        "path": lambda rel: os.path.join(root, rel),
        "metrics_dir": os.path.join(here, "metrics"),
    }


def reader(metrics_dir: str, name: str):
    """The `read(run)` function of metrics/<name>.py."""
    path = os.path.join(metrics_dir, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def passes(value, limit, how: str) -> bool:
    return value <= limit if how == "max" else value >= limit


def _number(x):
    """x for the JSON line: a non-finite reading (a check with nothing to
    read) as its name, since JSON has no infinity."""
    return x if math.isfinite(x) else str(x)


def result_line(cell: dict, res: dict, traced: bool, device: dict) -> dict:
    """The run's last line: correct, attempted, failed, metrics, device,
    (breakdown), and the compared numbers with their limits last."""
    metrics = {}
    if traced:
        for m in cell["per_layer"]:
            v = reader(cell["metrics_dir"], m["name"])(res["layer"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": res["e2e"][m["name"]], "unit": m["unit"]}
    checks = res["checks"]
    correct = bool(checks) and all(passes(v, lim, how) for _, v, lim, how in checks) \
        and res["failed"] == 0
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if traced and "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {n: {"value": _number(v), "limit": lim,
                          "is": "at most" if how == "max" else "at least"}
                      for n, v, lim, how in checks}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"the run loaded forbidden modules: {found}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell["chips"],
           "memory_peak_bytes": int(res["memory_peak"])}
    if args.trace:
        dev["busy_s"], dev["window_s"] = res["busy_s"], res["window_s"]
    line = result_line(cell, res, bool(args.trace), dev)
    for n, v, lim, how in res["checks"]:
        print(f"check {n}: {v!r} {'at most' if how == 'max' else 'at least'} {lim!r}: "
              f"{'ok' if passes(v, lim, how) else 'FAIL'}", file=sys.stderr)
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device) -> dict:
    """The driver's run of the cell, with set-up timed from process start to
    the window's open and, traced, the device's busy time and breakdown."""
    driver = importlib.import_module(f"benchmark.kinds.{cell['traffic']['kind']}")
    setup = {}
    res = driver.run(cell, seed, seconds, traced, device,
                     opened=lambda: setup.setdefault("s", process_age_s()))
    res["e2e"]["setup_s"] = setup["s"]
    if traced:
        from . import trace

        tr = res["layer"]["traced"]
        res["busy_s"], res["window_s"] = trace.busy_and_window(tr["sessions"])
        res["breakdown"] = {
            "device_ops": trace.device_ops(tr["sessions"]),
            "idle_gaps": trace.labelled_idle([(s, tr["spans"]) for s in tr["sessions"]]),
        }
    return res
