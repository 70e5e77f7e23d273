"""Denoiser: ms per sampler step in which the card was idle while the host was
inside a denoiser call (the program's `sample.denoise` span at the idle
stretch's start), over the traced job's sampling."""

from benchmark.spans import sampler_split


def read(run):
    got = sampler_split(run)
    return got["denoise_idle_ms"] if got else None
