"""The traced run's profiler sessions and what the per-layer readers take
from them.

A session runs a callable under `torch.profiler` (CUDA activity: device
operations and the runtime API) and keeps, on the host's wall clock in
nanoseconds (`time.time_ns`), its own span [t0, t1], every device operation
(name, start, end, launch grid where the trace gives one) and the count of
host launch calls. `grids=True` reads the exported Chrome trace, which holds
the kernels' launch grids; its clock is aligned to the host's by a
`cudaDeviceSynchronize` issued at a known host instant. Without it the
profiler's events are read in memory (their clock is the host's).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from .window import idle_gaps, union_length

# runtime and driver calls that put work on the device
LAUNCH_NAMES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
})
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Session:
    def __init__(self, t0: int, t1: int, ops: list, launches: list):
        self.t0, self.t1 = t0, t1
        self.ops = ops  # [(name, start_ns, end_ns, grid or None)]
        self.launches = launches  # [start_ns] of host launch calls

    @property
    def wall_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e, _ in self.ops], self.t0, self.t1) / 1e9


def profile(fn, grids: bool = False):
    """(fn(), Session) with fn run under the profiler and the device
    synchronised before the session closes."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with torch_profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        sync()
        mark = time.time_ns()
        sync()  # the clock mark of the Chrome trace
        t0 = time.time_ns()
        out = fn()
        sync()
        t1 = time.time_ns()
    if grids:
        return out, _from_chrome(prof, mark, t0, t1)
    ops, launches = [], []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            ops.append((e.name(), e.start_ns(), e.end_ns(), None))
        elif e.name() in LAUNCH_NAMES:
            launches.append(e.start_ns())
    return out, Session(t0, t1, ops, launches)


def _from_chrome(prof, mark: int, t0: int, t1: int) -> Session:
    path = os.path.join(tempfile.gettempdir(), f"bench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    syncs = sorted(e["ts"] for e in events if e.get("name") == "cudaDeviceSynchronize"
                   and e.get("ph") == "X")
    if len(syncs) >= 2:
        off = mark - round(syncs[1] * 1000)  # the second sync is the mark
    elif torch.cuda.is_available():
        raise RuntimeError("the trace holds no clock mark")
    else:
        off = 0  # a CPU rehearsal: no device operations to place
    ops, launches = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        start = round(e["ts"] * 1000) + off
        if e.get("cat") in DEVICE_CATS:
            grid = (e.get("args") or {}).get("grid")
            ops.append((e["name"], start, start + round(e.get("dur", 0) * 1000), grid))
        elif e.get("cat") == "cuda_runtime" and e.get("name") in LAUNCH_NAMES:
            launches.append(start)
    return Session(t0, t1, ops, launches)


def busy_and_window(sessions: list) -> tuple:
    """(device-busy seconds, traced window seconds) summed over sessions."""
    return sum(s.busy_s() for s in sessions), sum(s.wall_s for s in sessions)


def device_ops(sessions: list, top: int = 10) -> list:
    """[[kernel or copy name, seconds]] of the device operations that took
    most time, summed by name."""
    by = {}
    for s in sessions:
        for name, a, b, _ in s.ops:
            by[name] = by.get(name, 0) + (b - a)
    return [[n[:200], t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def labelled_idle(sessions_spans: list, top: int = 10) -> list:
    """[[span label, idle seconds]]: the device's idle time in each traced
    session, by the benchmark span the host was in when each gap began,
    summed by label, largest first. sessions_spans: [(Session, [(label,
    start_ns, end_ns)])]."""
    by = {}
    for s, spans in sessions_spans:
        for a, b in idle_gaps([(x, y) for _, x, y, _ in s.ops], s.t0, s.t1):
            label = next((lab for lab, lo, hi in spans if lo <= a < hi), "other")
            by[label] = by.get(label, 0) + (b - a)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
