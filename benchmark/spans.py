"""The program's own spans (`surfd_tpu_torch.utils.profiling.span`) inside
the traced sessions, and the arithmetic of the per-layer readers that take
them.

A span's host interval is on `time.time_ns()`, the clock of a session's
[t0, t1] and of its device operations (`trace.py`), so the two compare
directly. A program without a span buffer gives no spans, and the readers
that need them read nothing. The spans are read once the run is over
(`spans()` waits for their CUDA events), never inside a timed window.
"""

from __future__ import annotations

from .window import idle_gaps, merge


def program_spans() -> list:
    """Every span the program kept in this process, as dicts (name,
    start_ns, end_ns, thread, id, parent, root, device_ms); [] where the
    program keeps none."""
    try:
        from surfd_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def in_session(session, names=None, spans=None) -> list:
    """The spans (the program's unless given) that lie within the session's
    [t0, t1], those named in `names` alone where it is given."""
    spans = program_spans() if spans is None else spans
    return [s for s in spans if session.t0 <= s["start_ns"] and s["end_ns"] <= session.t1
            and (names is None or s["name"] in names)]


def intersect(a: list, b: list) -> list:
    """The intersection of two sorted lists of disjoint [start, end]
    intervals, as such a list."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def sampler_split(run: dict, spans=None):
    """Per step of the traced job's sampling session, in ms: the device's
    busy time inside the host intervals of the `sample.step` spans, and its
    idle time there, each idle stretch put down to where the host was at
    its start: inside a `sample.denoise` span (the denoiser) or outside one
    (the sampler's own arithmetic and noise draw). The three add up to the
    host's time in the steps. None without steps or device operations."""
    sess = run.get("traced", {}).get("sample_session")
    if sess is None or not sess.ops:
        return None
    mine = in_session(sess, {"sample.step", "sample.denoise"}, spans)
    steps = [(s["start_ns"], s["end_ns"]) for s in mine if s["name"] == "sample.step"]
    if not steps:
        return None
    in_steps = merge(steps)
    denoise = merge([(s["start_ns"], s["end_ns"]) for s in mine if s["name"] == "sample.denoise"])
    ops = [(a, b) for _, a, b, _ in sess.ops]
    busy = sum(b - a for a, b in intersect(merge(ops), in_steps))
    denoise_idle = sampler_idle = j = 0
    for a, b in intersect(idle_gaps(ops, sess.t0, sess.t1), in_steps):  # in order
        while j < len(denoise) and denoise[j][1] <= a:
            j += 1
        if j < len(denoise) and denoise[j][0] <= a:
            denoise_idle += b - a
        else:
            sampler_idle += b - a
    n = len(steps) * 1e6
    return {"busy_ms": busy / n, "denoise_idle_ms": denoise_idle / n,
            "sampler_idle_ms": sampler_idle / n}


def mean_device_ms(run: dict, name: str, spans=None):
    """The mean device duration (its CUDA event pair) of the spans called
    `name` in the traced sessions; None where none has one."""
    vals = [s["device_ms"] for sess in run.get("traced", {}).get("sessions", [])
            for s in in_session(sess, {name}, spans) if s["device_ms"] is not None]
    return sum(vals) / len(vals) if vals else None
