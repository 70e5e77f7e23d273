"""The traced job's model FLOPs over its wall, as a share of the dense TF32
peak: the denoiser's forward per call (CFG's two branches as rows) and
CLIP's, counted over the plain references on the meta device; the decoder's
per point for every point K1 evaluated (both precisions, from the launch
grids); three times that for each gradient corner (forward and backward)."""

from benchmark import flops
from benchmark.readers import K1_KERNELS, decoder_point_flops, k1, traced_wall


def read(run):
    tr = run.get("traced", {})
    wall = traced_wall(run)
    if not wall:
        return None
    total = run["flops"]["denoiser_call"] * tr["calls"] + run["flops"]["clip"]
    points = sum((k1(run, name) or (0, 0))[0] for name in K1_KERNELS)
    total += decoder_point_flops(run) * (points + 3 * tr["corners"])
    return flops.share(total, wall, flops.peak("tf32_flops"))
