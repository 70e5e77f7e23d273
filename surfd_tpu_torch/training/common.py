"""Training-loop utilities (counterpart of surfd_tpu/training/common.py; so
far the stall watchdog, which the reconstruction eval also runs)."""

from __future__ import annotations

import os
import sys
import threading
import time


class StallWatchdog:
    """Exit the process with code 42 when a loop stops completing steps.

    A wedged device call raises nothing and cannot be interrupted, so the
    only recovery is to leave with a distinctive code and let a restart loop
    resume (the CLIs' `--resume`). Loops call `tick()` once per completed
    step. Before the first tick the loop gets `first_grace_s` (start-up and
    kernel builds); after it, `timeout_s` of silence ends the process from
    a daemon thread. `timeout_s=0` disables. Use as a context manager.
    """

    EXIT_CODE = 42

    def __init__(self, timeout_s: float = 480.0, first_grace_s: float = 3600.0):
        self.timeout_s = float(timeout_s)
        self.first_grace_s = float(first_grace_s)
        self._last = None  # monotonic time of the last tick; None before the first
        self._t0 = None
        self._stop = threading.Event()

    def tick(self):
        self._last = time.monotonic()

    def _watch(self):
        while not self._stop.wait(min(30.0, self.timeout_s / 4)):
            now = time.monotonic()
            if self._last is None:
                if now - self._t0 > self.first_grace_s:
                    self._bark(now - self._t0, "no first step")
            elif now - self._last > self.timeout_s:
                self._bark(now - self._last, "no step completed")

    def _bark(self, silent_s: float, why: str):
        print(f"StallWatchdog: {why} in {silent_s:.0f}s; the device is presumed wedged, "
              f"exiting {self.EXIT_CODE} for the restart loop", file=sys.stderr, flush=True)
        os._exit(self.EXIT_CODE)

    def __enter__(self):
        self._t0 = time.monotonic()
        if self.timeout_s > 0:
            threading.Thread(target=self._watch, daemon=True, name="stall-watchdog").start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        return False
