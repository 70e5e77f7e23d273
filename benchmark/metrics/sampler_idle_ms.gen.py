"""Sampler: ms per sampler step in which the card was idle while the host was in
the step outside the denoiser (the posterior, the noise draw: a `sample.step`
span and no `sample.denoise` at the idle stretch's start), over the traced
job's sampling."""

from benchmark.spans import sampler_split


def read(run):
    got = sampler_split(run)
    return got["sampler_idle_ms"] if got else None
