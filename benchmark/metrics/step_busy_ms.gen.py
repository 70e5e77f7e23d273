"""Sampler: ms per sampler step in which the card was busy, over the traced
job's sampling: the union of its device operations inside the host
intervals of the program's `sample.step` spans, over the steps."""

from benchmark.spans import sampler_split


def read(run):
    got = sampler_split(run)
    return got["busy_ms"] if got else None
