"""The denoiser's 1-D convolutions as one weight-streaming f32 kernel.

`conv1d(x, weight, bias, stride, padding, residual=None)` is `F.conv1d` at
dilation 1 and one group, plus a residual where one is given: on a CUDA
tensor it launches `ops/csrc/conv1d_stream.cu` on the current stream, which
adds the residual in its epilogue, on a CPU tensor it takes the plain
version `conv1d_ref` (`F.conv1d` itself, then the add). The kernel replaces no TPU kernel (the JAX package left
the convolutions to XLA); its source note says what bounds it and how the
design answers. It has no backward: `models/unet1d.py Conv1d` sends a CUDA
call with grad on to cuDNN, and `conv1d` raises if autograd would record.

`plan` chooses the kernel's split from the conv's shape alone (see its
docstring); the launch counter `conv1d.launches` is keyed by (K, stride).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

TR = 4  # weight rows a warp owns (the kernel's kTR)
WARPS = 8  # warps a CTA
MAX_SPLITS = 8  # CTAs of a cluster (the portable size)
SMEM_MAX = 232448 - 1024  # dynamic shared memory a CTA: the H100's 227 KB less the static tables
# The CTA counts the split aims between, read from a sweep of every (wr,
# splits) at twelve of the MDM's shapes on the H100 (PERF.md §6): the
# fastest plans keep all 8 warps on rows where that still gives ~100 CTAs,
# and split k over the cluster up to ~200 CTAs, not past.
MIN_CTAS = 96
MAX_CTAS = 200
KERNEL_SIZES = (1, 3)


class Plan(NamedTuple):
    """The kernel's split of one conv: `tm` x `lm` columns a CTA (`lm` lane
    groups of `tm`), `wr` warps along the weight rows (8 / wr along k),
    `splits` CTAs of a cluster along k, `kc` columns of W a CTA."""

    tm: int
    lm: int
    wr: int
    splits: int
    kc: int

    @property
    def kstep(self) -> int:
        """Columns of W a warp step covers: 4 for each of 32 / lm lanes."""
        return 4 * (32 // self.lm)

    def grid(self, cout: int, m: int) -> tuple:
        """The launch grid (splits, row tiles, column tiles)."""
        return (self.splits, -(-cout // (self.wr * TR)), -(-m // (self.tm * self.lm)))

    def smem_bytes(self) -> int:
        """The staged im2col tile, the warps' partials where several share
        the rows, and the cluster's partials of the CTA's outputs."""
        mt, s = self.tm * self.lm, self.splits
        tile = self.wr * TR * mt
        return 4 * (mt * self.kc + (WARPS // self.wr * tile if self.wr < WARPS else 0)
                    + s * -(-tile // s))


def plan(cout: int, kw: int, m: int) -> Plan:
    """The split for a conv of `cout` output channels, `kw` = Cin·K weight
    columns and `m` output columns: `wr` the most warps along the rows (8,
    4, 2, 1) that still give MIN_CTAS CTAs with 8 along k, then the most CTAs
    along k (at most 8, the cluster) that keep the grid within MAX_CTAS, or
    more where the CTA's shared memory needs a shorter k-range. The columns
    a CTA: 8 x 1 up to M 8, 16 x 1 up to 16, 16 x 2 up to 32, 16 x 4 (tiles
    of 64) above."""
    tm, lm = (8, 1) if m <= 8 else (16, 1) if m <= 16 else (16, 2) if m <= 32 else (16, 4)
    kstep = 4 * (32 // lm)
    steps = -(-kw // kstep)
    cols = -(-m // (tm * lm))
    for wr in (8, 4, 2, 1):
        tiles = -(-cout // (wr * TR)) * cols
        if tiles * min(MAX_SPLITS, steps) >= MIN_CTAS:
            break
    for s in range(max(1, min(MAX_SPLITS, MAX_CTAS // tiles)), MAX_SPLITS + 1):
        per = -(-steps // s)  # steps of a CTA
        p = Plan(tm, lm, wr, -(-steps // per), per * kstep)
        if p.smem_bytes() <= SMEM_MAX:
            return p
    raise ValueError(f"conv with Cout {cout}, Cin*K {kw}, M {m}: no split of the kernel "
                     "fits its shared memory")


def conv1d_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
               stride: int = 1, padding: int = 0,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: `F.conv1d` at dilation 1, one group, then
    `+ residual` where one is given."""
    conv1d_ref.calls += 1
    out = F.conv1d(x, weight, bias, stride, padding)
    return out if residual is None else out + residual


conv1d_ref.calls = 0

_plans: dict = {}  # (shapes, strides, dtypes, devices, alignment, stride, padding) -> launch
_launch = None  # the library's surfd_conv1d_stream, bound at the first launch


def _check(x, weight, bias, stride, padding, residual) -> tuple:
    """The launch arguments for these tensors, or ValueError."""
    if x.dtype != torch.float32 or weight.dtype != torch.float32 or (
            bias is not None and bias.dtype != torch.float32):
        raise ValueError(f"conv1d takes float32, got x {x.dtype}, weight {weight.dtype}"
                         + ("" if bias is None else f", bias {bias.dtype}"))
    if x.dim() != 3 or weight.dim() != 3 or not x.is_contiguous() or not weight.is_contiguous():
        raise ValueError(f"conv1d takes contiguous (B, Cin, L) and (Cout, Cin, K), got "
                         f"{tuple(x.shape)} strides {x.stride()}, {tuple(weight.shape)} "
                         f"strides {weight.stride()}")
    B, cin, lin = x.shape
    cout, wcin, k = weight.shape
    if wcin != cin or k not in KERNEL_SIZES or stride not in (1, 2) or padding < 0:
        raise ValueError(f"conv1d: x {tuple(x.shape)}, weight {tuple(weight.shape)}, stride "
                         f"{stride}, padding {padding}: want Cin equal, K in {KERNEL_SIZES}, "
                         "stride 1 or 2")
    if bias is not None and (tuple(bias.shape) != (cout,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous ({cout},), got {tuple(bias.shape)}")
    if any(t.device != x.device for t in (weight, bias) if t is not None):
        raise ValueError("x, weight and bias must be on one device")
    lout = (lin + 2 * padding - k) // stride + 1
    if lout < 1:
        raise ValueError(f"conv1d: length {lin} too short for K {k}, padding {padding}")
    if residual is not None and (tuple(residual.shape) != (B, cout, lout)
                                 or residual.dtype != torch.float32
                                 or not residual.is_contiguous() or residual.device != x.device):
        raise ValueError(f"residual must be a contiguous float32 {(B, cout, lout)} on "
                         f"{x.device}, got {residual.dtype} {tuple(residual.shape)} strides "
                         f"{residual.stride()} on {residual.device}")
    p = plan(cout, cin * k, B * lout)
    vec = int(weight.data_ptr() % 16 == 0 and (cin * k) % 4 == 0)
    return (B, cin, lin, cout, lout, k, stride, padding, *p, vec), (B, cout, lout)


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """`F.conv1d(x, weight, bias, stride, padding)`, plus `residual` (B, Cout,
    L_out) where given. CUDA tensors launch the kernel on the current stream,
    the residual added in its epilogue (float32, contiguous x (B, Cin, L) and
    weight (Cout, Cin, K), K 1 or 3, stride 1 or 2; anything else raises);
    CPU tensors take `conv1d_ref`. The kernel has no backward: a CUDA call
    that autograd would record raises."""
    global _launch
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return conv1d_ref(x, weight, bias, stride, padding, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias, residual)):
        raise ValueError("conv1d's kernel has no backward: call it with grad off")
    key = (x.shape, x.stride(), x.dtype, weight.shape, weight.stride(), weight.dtype,
           x.device, weight.device, weight.data_ptr() % 16 == 0, stride, padding,
           *((None,) if t is None else (t.shape, t.stride(), t.dtype, t.device)
             for t in (bias, residual)))
    entry = _plans.get(key)
    if entry is None:
        entry = _check(x, weight, bias, stride, padding, residual)
        if _launch is None:
            _launch = _build.load().surfd_conv1d_stream
        if len(_plans) >= 256:
            _plans.clear()
        _plans[key] = entry  # only once the checks passed and the library loaded
    args, size = entry
    out = torch.empty(size, dtype=torch.float32, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    _build.check(_launch(x.data_ptr(), weight.data_ptr(), 0 if bias is None else bias.data_ptr(),
                         0 if residual is None else residual.data_ptr(), out.data_ptr(), *args,
                         stream), "conv1d")
    shape = (args[5], stride)
    conv1d.launches[shape] = conv1d.launches.get(shape, 0) + 1
    return out


conv1d.launches = {}  # kernel launches per (K, stride)
