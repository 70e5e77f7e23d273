"""Host phase timers and device traces (counterpart of
surfd_tpu/utils/profiling.py): `torch.profiler` in place of `jax.profiler`."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class PhaseTimer:
    """Wall-clock seconds and entries per named phase, on the host clock
    (a device phase needs a `torch.cuda.synchronize()` inside it)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in sorted(self.totals.items())}


@contextmanager
def device_trace(logdir: str):
    """The block's host and CUDA activity under torch.profiler, written to
    `logdir` as a Chrome / Perfetto trace; yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextmanager
def annotate(name: str):
    """A named range in the device trace (`record_function`)."""
    with record_function(name):
        yield
