"""Trainer (the AE train step): the mean device duration of the program's
`train.forward` span (its CUDA event pair), over the traced steps."""

from benchmark.spans import mean_device_ms


def read(run):
    return mean_device_ms(run, "train.forward")
