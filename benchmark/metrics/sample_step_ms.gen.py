"""Sampler: milliseconds per denoiser call, from the benchmark's span around
`pipelines.sample_latents` (it ends in a synchronise), over the window's jobs."""


def read(run):
    jobs = run.get("jobs", [])
    calls = sum(j["calls"] for j in jobs)
    return 1000.0 * sum(j["sample_s"] for j in jobs) / calls if calls else None
