"""The window's arithmetic, the FLOP counts and the roofline and MFU
formulas."""

import json

import numpy as np
import pytest

import bench_tiny  # noqa: F401  (puts the repository on the path)
from benchmark import flops, trace, window


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_closed_loop_runs_whole_jobs_and_closes_at_the_last_end():
    clock = FakeClock()

    def job(k):
        clock.t += 4.0  # every job takes 4 s
        return k

    window_s, done = window.closed_loop(10.0, job, clock)
    # jobs start at 0, 4 and 8 (< 10); the third ends at 12
    assert [d[2] for d in done] == [0, 1, 2]
    assert window_s == 12.0
    assert [(a, b) for a, b, _ in done] == [(0.0, 4.0), (4.0, 8.0), (8.0, 12.0)]


def test_closed_loop_runs_one_job_longer_than_the_window():
    clock = FakeClock()

    def job(k):
        clock.t += 25.0
        return k

    window_s, done = window.closed_loop(10.0, job, clock)
    assert len(done) == 1 and window_s == 25.0


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys_linear_method(q):
    vals = list(np.random.default_rng(3).exponential(size=113))
    assert window.percentile(vals, q) == pytest.approx(float(np.percentile(vals, q)))


def test_gaps_between_step_ends():
    assert window.gaps([0.0, 1.0, 3.0, 6.0]) == [1.0, 2.0, 3.0]


def test_union_counts_overlaps_once_and_clips():
    ivs = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)]
    assert window.union_length(ivs) == 15 + 11
    assert window.union_length(ivs, 8, 25) == 7 + 5
    assert window.idle_gaps(ivs, 0, 50) == [(15, 20), (31, 50)]


def test_busy_share_is_a_union_not_a_sum():
    # two streams' kernels overlap: a sum would read 150 % busy
    sess = trace.Session(0, 100, [("a", 0, 75, None), ("b", 0, 75, None)], [10, 20])
    busy, wall = trace.busy_and_window([sess])
    assert (busy, wall) == (75e-9, 100e-9)
    assert trace.device_ops([sess]) == [["a", 75e-9], ["b", 75e-9]]
    assert trace.labelled_idle([(sess, [("sample", 0, 90)])]) == [["sample", 25e-9]]


def test_decoder_point_flops_at_h512_l5():
    f = flops.decoder_point_flops(512, 5)
    assert f == 5_308_416
    assert round(f / 1e6, 2) == 5.31


def test_roofline_and_mfu_formulas():
    assert flops.peak("tf32_flops") == 495e12
    # 2^20 points of the decoder in 106.9 ms against 495 TFLOP/s
    share = flops.share(2**20 * flops.decoder_point_flops(512, 5), 0.1069, 495e12)
    assert share == pytest.approx(100 * 5.566e12 / 0.1069 / 495e12, rel=1e-3)
    assert flops.share(1.0, 0.0, 1.0) is None


def test_denoiser_flops_count_the_convolutions():
    from benchmark.reference import mdm as ref_mdm

    cfg = {"cond_mode": "category", "num_actions": 3, "model_channels": 32, "channel_mult": [1],
           "num_res_blocks": 1, "attention_resolutions": [], "num_heads": 2, "latent_size": 8}
    B, L = 2, 8  # one level: every convolution runs at length L
    f = flops.mdm_forward_flops(json.dumps(cfg), B)
    expect = 0
    for key, shape, kind in ref_mdm.param_specs(cfg):
        if kind == "fan_in" and len(shape) == 3:  # (out, in, k) convolutions
            expect += 2 * B * L * shape[0] * shape[1] * shape[2]
        elif kind == "fan_in":  # linear layers, once a row
            expect += 2 * B * shape[0] * shape[1]
    expect += 2 * (2 * B * L * L * 32)  # the middle block's attention: q·k and w·v
    assert f == expect
    assert flops.mdm_train_flops(json.dumps(cfg), B) == pytest.approx(3 * f, rel=0.05)
