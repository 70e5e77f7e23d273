"""The window's arithmetic: the closed loop, the step-end gaps and their
percentile, and the device's busy time as a union of intervals. Pure
functions of numbers, so that the CPU tests hold them."""

from __future__ import annotations

import time


def closed_loop(seconds: float, job, clock=time.perf_counter):
    """One client, jobs back to back: job(k) runs while the elapsed time at
    its start is under `seconds`; the window closes when the last job ends.
    Returns (window seconds, [(start, end) of each job relative to the
    window's open, job(k)'s result])."""
    t_open = clock()
    done = []
    while clock() - t_open < seconds:
        t0 = clock() - t_open
        out = job(len(done))
        done.append((t0, clock() - t_open, out))
    return clock() - t_open, done


def gaps(ends: list) -> list:
    """Gaps between consecutive instants."""
    return [b - a for a, b in zip(ends, ends[1:])]


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics (numpy's default method)."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def merge(intervals: list) -> list:
    """Sorted, non-overlapping [start, end] intervals covering the input's."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals: list, lo=None, hi=None) -> float:
    """Length of the union of the intervals, clipped to [lo, hi] if given:
    overlapping operations (two streams, a copy beside a kernel) count once."""
    total = 0
    for s, e in merge(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        total += max(e - s, 0)
    return total


def idle_gaps(intervals: list, lo, hi) -> list:
    """The [start, end] stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in merge(intervals):
        if e <= lo or s >= hi:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out
