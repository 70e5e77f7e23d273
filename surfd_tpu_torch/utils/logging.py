"""Key-value metric logger with several sinks (counterpart of
surfd_tpu/utils/logging.py): a stdout table, `metrics.jsonl`, `metrics.csv`
and TensorBoard when it is installed.
"""

from __future__ import annotations

import csv
import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional


class _StdoutSink:
    def write(self, kvs: Dict[str, float], step: int) -> None:
        items = sorted(kvs.items())
        width = max((len(k) for k, _ in items), default=1)
        lines = [f"| step {step}"]
        for k, v in items:
            sval = f"{v:.5g}" if isinstance(v, float) else str(v)
            lines.append(f"|   {k:<{width}} {sval}")
        print("\n".join(lines), flush=True)

    def close(self):
        pass


class _JsonlSink:
    def __init__(self, path: str):
        self.f = open(path, "a")

    def write(self, kvs, step):
        self.f.write(json.dumps({"step": step, **kvs}) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


class _CsvSink:
    """Rewrites the whole file at each dump, so that a new key adds a
    column; rows already in the file (a resumed run's) are kept."""

    def __init__(self, path: str):
        self.path = path
        self.keys: list[str] = []
        self.rows: list[dict] = []
        if os.path.exists(path):
            with open(path, newline="") as f:
                r = csv.DictReader(f)
                if r.fieldnames:
                    self.keys = list(r.fieldnames)
                    self.rows = [dict(row) for row in r]

    def write(self, kvs, step):
        row = {"step": step, **kvs}
        for k in row:
            if k not in self.keys:
                self.keys.append(k)
        self.rows.append(row)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.keys)
            w.writeheader()
            w.writerows(self.rows)

    def close(self):
        pass


class _TensorBoardSink:
    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter  # needs the tensorboard package

        self.w = SummaryWriter(logdir)

    def write(self, kvs, step):
        for k, v in kvs.items():
            self.w.add_scalar(k, v, step)

    def close(self):
        self.w.close()


class Logger:
    """Accumulates key-values (`logkv`, running means with `logkv_mean`) and
    writes them to every sink at `dumpkvs`; `log_metrics` does both."""

    def __init__(self, log_dir: Optional[str] = None, formats: tuple = ("stdout",)):
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self.sinks = []
        for fmt in formats:
            if fmt == "stdout":
                self.sinks.append(_StdoutSink())
            elif fmt in ("jsonl", "csv", "tensorboard"):
                if not log_dir:
                    raise ValueError(f"the {fmt} sink needs a log_dir")
                if fmt == "jsonl":
                    self.sinks.append(_JsonlSink(os.path.join(log_dir, "metrics.jsonl")))
                elif fmt == "csv":
                    self.sinks.append(_CsvSink(os.path.join(log_dir, "metrics.csv")))
                else:
                    try:
                        self.sinks.append(_TensorBoardSink(os.path.join(log_dir, "tb")))
                    except ImportError:
                        pass
            else:
                raise ValueError(f"unknown log format {fmt}")
        self._kvs: dict = {}
        self._counts: dict = defaultdict(int)

    def logkv(self, key: str, value) -> None:
        self._kvs[key] = float(value)
        self._counts[key] = 0

    def logkv_mean(self, key: str, value) -> None:
        """A running mean until the next dump."""
        n = self._counts[key]
        old = self._kvs.get(key, 0.0) if n > 0 else 0.0
        self._kvs[key] = old * (n / (n + 1)) + float(value) / (n + 1)
        self._counts[key] = n + 1

    def dumpkvs(self, step: int = 0) -> None:
        if not self._kvs:
            return
        for s in self.sinks:
            s.write(dict(self._kvs), step)
        self._kvs.clear()
        self._counts.clear()

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            self.logkv(k, v)
        self.dumpkvs(step)

    @contextmanager
    def profile_kv(self, name: str):
        """Host time of the block, as a running mean under `time/<name>`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.logkv_mean(f"time/{name}", time.perf_counter() - t0)

    def close(self):
        for s in self.sinks:
            s.close()
