"""K1 f32 (`folded_mlp_tf32x3_kernel`): the decoder's FLOPs for the points it
evaluated (from its launch grids, 32 points a CTA) over its device time in
the traced job's extraction, as a share of the dense TF32 peak, which bounds
any f32-accurate implementation on the tensor cores."""

from benchmark import flops
from benchmark.readers import decoder_point_flops, k1


def read(run):
    got = k1(run)
    if got is None:
        return None
    pts, secs = got
    return flops.share(pts * decoder_point_flops(run), secs, flops.peak("tf32_flops"))
