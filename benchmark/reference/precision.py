"""The arithmetic every reference product goes through, in one of two
precisions: float32 with TF32 off (the configurations' own precision), or
TF32, the next one below it, which the benchmark's control computes in.

On CUDA, TF32 is the card's own: the products run with
`torch.backends.{cuda.matmul,cudnn}.allow_tf32` set for the call. On the CPU,
which has no TF32, the operands of each product are rounded to TF32's 10-bit
mantissa first, so that the control can be run by the CPU tests too.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (19 bits: the low 13 of the f32
    mantissa cleared, ties away from zero); gradients pass straight through,
    as the card's TF32 products round in the backward pass too."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


@contextlib.contextmanager
def _tf32_flags(on: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


class Precision:
    """Matrix products and convolutions in float32 (`tf32=False`) or TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _args(self, *xs):
        if self.tf32 and xs[0].device.type == "cpu":
            return tuple(None if x is None else tf32_round(x) for x in xs)
        return xs

    def linear(self, x, w, b=None):
        x, w = self._args(x, w)
        with _tf32_flags(self.tf32):
            return F.linear(x, w, b)

    def matmul(self, a, b):
        a, b = self._args(a, b)
        with _tf32_flags(self.tf32):
            return a @ b

    def einsum(self, eq, a, b):
        a, b = self._args(a, b)
        with _tf32_flags(self.tf32):
            return torch.einsum(eq, a, b)

    def conv1d(self, x, w, b=None, stride=1, padding=0):
        x, w = self._args(x, w)
        with _tf32_flags(self.tf32):
            return F.conv1d(x, w, b, stride=stride, padding=padding)


F32 = Precision(False)
TF32 = Precision(True)
