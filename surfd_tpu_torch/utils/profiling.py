"""Spans of the program and device traces (counterpart of
surfd_tpu/utils/profiling.py): `torch.profiler` in place of `jax.profiler`.

`span(name, times, key)` marks a block where the work happens. Where a
`times` dict is given it always adds the block's host seconds under `key`
(the always-on stage records, such as `get_mesh_from_udf`'s `times`). Only
while a `torch.profiler` session is active (the profiler's own enabled flag,
read once per span) does it also:

- keep a record in a bounded in-memory buffer: the name, start and end on
  `time.time_ns()` (the host clock on which the profiler's events can be
  compared with it), the thread, its own id, its parent's id (the innermost
  span open in the thread) and its root's id (shared by one call tree);
- open a `record_function` range of the same name, so that the span shows
  in a Perfetto trace;
- on a process that has initialised CUDA, record a CUDA event pair on the
  current stream: the span's device duration, read only when the buffer is
  read (`spans()`), with no synchronisation while it runs.

With no profiler active a span costs the flag check and the `times`
arithmetic. Nesting is per thread; `adopt(current())` carries a caller's
open span into a worker thread. `device_trace` writes a block's trace with
the spans in it.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# spans kept while a profiler runs; those past it are dropped and counted
CAPACITY = 100_000


class _Record:
    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns", "end_ns", "_range",
                 "_events", "device_ms")

    def __init__(self, name: str, parent):
        self.name = name
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.thread = threading.get_ident()
        self.device_ms = None
        self.start_ns = time.time_ns()
        self._range = record_function(name)
        self._range.__enter__()
        self._events = None
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.end_ns = None

    def close(self) -> None:
        if self._events is not None:
            self._events[1].record()
        self._range.__exit__(None, None, None)
        self.end_ns = time.time_ns()

    def resolve(self) -> None:
        """The device duration from the event pair (waits for the end event)."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self._events = None


_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_buffer: list = []
_dropped = 0


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """A named block of the program (see the module's docstring). Use as
    `with span("extract.fill", times, "grid_fill"): ...`; `key` defaults
    to `name`."""

    __slots__ = ("name", "times", "key", "_t0", "_rec")

    def __init__(self, name: str, times: dict | None = None, key: str | None = None):
        self.name, self.times = name, times
        self.key = name if key is None else key

    def __enter__(self):
        self._rec = None
        if _autograd_profiler._is_profiler_enabled:
            stack = _stack()
            self._rec = _Record(self.name, stack[-1] if stack else None)
            stack.append(self._rec)
        if self.times is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.times is not None:
            self.times[self.key] = self.times.get(self.key, 0.0) + time.perf_counter() - self._t0
        rec = self._rec
        if rec is not None:
            rec.close()
            stack = _stack()
            if stack and stack[-1] is rec:
                stack.pop()
            else:
                stack.remove(rec)
            _keep(rec)
        return False


def _keep(rec: _Record) -> None:
    global _dropped
    with _lock:
        if len(_buffer) < CAPACITY:
            _buffer.append(rec)
        else:
            _dropped += 1


def current():
    """The innermost span open in this thread while a profiler runs, or
    None: what a worker thread `adopt`s."""
    stack = _stack()
    return stack[-1] if stack else None


@contextmanager
def adopt(parent):
    """Spans opened in this thread inside the block are children of
    `parent` (`current()` of another thread), in its call tree."""
    if parent is None:
        yield
        return
    stack = _stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.remove(parent)


def spans() -> list:
    """The recorded spans, oldest end first, as dicts: name, start_ns,
    end_ns (`time.time_ns()`), thread, id, parent, root, device_ms (None
    without CUDA)."""
    with _lock:
        recs = list(_buffer)
    out = []
    for r in recs:
        r.resolve()
        out.append({"name": r.name, "start_ns": r.start_ns, "end_ns": r.end_ns,
                    "thread": r.thread, "id": r.id, "parent": r.parent, "root": r.root,
                    "device_ms": r.device_ms})
    return out


def dropped() -> int:
    """Spans not kept since the last `clear()`: the buffer was full."""
    return _dropped


def clear() -> None:
    """Empty the buffer and its count of dropped spans."""
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0


@contextmanager
def device_trace(logdir: str):
    """The block's host and CUDA activity under torch.profiler, with the
    program's spans as named ranges, written to `logdir/trace.json` (open it
    in Perfetto); yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
