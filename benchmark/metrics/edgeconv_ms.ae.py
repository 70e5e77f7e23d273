"""Trainer (the AE train step): the device ms a step of the DGCNN encoder's
train-mode edge convolution unit, the summed device durations (CUDA event
pairs) of the program's `edgeconv.forward` and `edgeconv.backward` spans in
the traced steps over the traced steps. None where the program keeps no such
span (a program without the unit, or its composed path)."""

from benchmark.spans import in_session

NAMES = {"edgeconv.forward", "edgeconv.backward"}


def read(run):
    traced = run.get("traced", {})
    steps = traced.get("steps")
    vals = [s["device_ms"] for sess in traced.get("sessions", [])
            for s in in_session(sess, NAMES) if s["device_ms"] is not None]
    return sum(vals) / steps if vals and steps else None
