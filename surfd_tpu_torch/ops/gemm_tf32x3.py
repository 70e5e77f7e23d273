"""A float32 matrix product at f32 accuracy on the tensor cores, to any order
of derivative: the AE decoder's 512 × 512 projections in train mode.

`mm_tf32x3(a, b, bias=None)` is `a @ b (+ bias)` for 2-D float32 operands,
a `torch.autograd.Function` whose backward is `mm_tf32x3(g, bᵀ)` and
`mm_tf32x3(aᵀ, g)` (and `g.sum(0)` for the bias) through the same Function,
so that the create-graph coordinate gradient of the AE step and its
derivative in `loss.backward()` stay on the kernel. The backward computes
only the gradients the running backward pass will use: the create-graph
gradient asks for the input's alone.

On a CUDA tensor it launches `ops/csrc/gemm_tf32x3.cu`: 3xTF32 on wgmma
(each operand split into a tf32 hi and lo in registers, three products each
summed in f32; the operands loaded by TMA), in one of three forms read from
the strides, so that no transposed view is copied:

- `nt`: a row-major, b K-contiguous (a transposed row-major matrix): X·Wᵀ;
- `nn`: a and b row-major: G·W;
- `tn`: a M-contiguous (Xᵀ), b row-major: the weight gradients, K the rows;
  K is split over enough CTAs to fill the SMs (`plan`), the partials summed
  in a fixed order by a second kernel (no float atomics: bit-equal reruns).

Any other strides are copied to row-major first, and an operand whose
leading dimension TMA cannot take (not a multiple of 4 elements) into a
padded buffer. On a CPU tensor it takes
the plain version `mm_ref` (`torch.matmul`). The kernel ignores
`allow_tf32`: single-pass TF32 stays off. It replaces no TPU kernel: the JAX
package left these matmuls to XLA. `models/decoder.py` sends a train-mode
CUDA float32 `Conv1x1` whose widths are multiples of `TILE` here; eval mode,
the CPU and the other projections keep `F.linear`. Span: `gemm.tf32x3`
around each call's launches; `mm_tf32x3.launches` counts the calls of each
form.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from . import _build

TILE = 128        # the kernel's output tile, rows and columns
K_STEP = 128      # its promotion period (four k-blocks): a split's K chunk is a multiple of it
MIN_STEPS = 2     # the fewest periods a split of K is given


def mm_ref(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: torch.matmul (+ bias)."""
    mm_ref.calls += 1
    out = torch.matmul(a, b)
    return out if bias is None else out + bias


mm_ref.calls = 0


def plan(M: int, N: int, K: int, sms: int) -> tuple:
    """(splits, k_chunk): K is split only where the output's tiles leave SMs
    idle, into at most sms // tiles chunks of at least MIN_STEPS periods,
    none empty; k_chunk is a multiple of K_STEP."""
    tiles = -(-M // TILE) * -(-N // TILE)
    steps = -(-K // K_STEP)
    splits = max(1, min(sms // tiles, steps // MIN_STEPS)) if tiles < sms else 1
    per = -(-steps // splits)
    return -(-steps // per), per * K_STEP


def _layout(t: torch.Tensor):
    """The layout of a 2-D operand: "row" where dimension 1 is contiguous,
    "col" where dimension 0 is, else None."""
    rows, cols = t.shape
    if t.stride(1) == 1 and t.stride(0) >= max(cols, 1):
        return "row"
    if t.stride(0) == 1 and t.stride(1) >= max(rows, 1):
        return "col"
    return None


def operands(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(form, a, b) for the kernel: the form ("nt", "nn" or "tn") read from
    the strides, an operand of other strides (or b where a is M-contiguous
    and b K-contiguous: the kernel has no TT form) copied to row-major."""
    a_kind = _layout(a)
    if a_kind is None:
        a, a_kind = a.contiguous(), "row"
    b_kind = _layout(b)
    if b_kind is None or (a_kind == "col" and b_kind == "col"):
        b, b_kind = b.contiguous(), "row"
    return ("n" if a_kind == "row" else "t") + ("t" if b_kind == "col" else "n"), a, b


def _tma_ready(t: torch.Tensor, row: bool) -> tuple:
    """(t, its leading dimension) as the kernel's TMA loads take it: the
    leading dimension a multiple of 4 elements and the data 16-byte aligned;
    where they are not, a copy into a buffer padded to that, as a view of
    the same layout."""
    ld = t.stride(0) if row else t.stride(1)
    if ld % 4 == 0 and t.data_ptr() % 16 == 0:
        return t, ld
    src = t if row else t.t()
    rows, cols = src.shape
    buf = torch.empty((rows, -(-cols // 4) * 4), dtype=t.dtype, device=t.device)
    buf[:, :cols] = src
    view = buf[:, :cols]
    return (view if row else view.t()), buf.stride(0)


_lib = None  # the kernels' library, bound at the first launch


def _kernels():
    global _lib
    if _lib is None:
        _lib = _build.load()
    return _lib


def _launch(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    for t in (a, b) + (() if bias is None else (bias,)):
        if t.device != a.device or t.dtype != torch.float32:
            raise ValueError(f"gemm_tf32x3 takes float32 operands on {a.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    M, K = a.shape
    N = b.shape[1]
    if max(M, N, K) >= 2**31:
        raise ValueError(f"gemm_tf32x3: shape {M} x {N} x {K} out of range")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_() if bias is None else out.copy_(bias.expand(M, N))
    form, a, b = operands(a, b)
    a, lda = _tma_ready(a, form[0] == "n")
    b, ldb = _tma_ready(b, form[1] == "n")
    if bias is not None:
        bias = bias.contiguous()
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits, k_chunk = plan(M, N, K, sms)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
            if splits > 1 else out)
    vec = int(N % 4 == 0)  # paired stores and a float4 reduction
    with span("gemm.tf32x3"):
        _build.check(_kernels().surfd_gemm_tf32x3(
            a.data_ptr(), lda, int(form[0] == "n"), b.data_ptr(), ldb, int(form[1] == "t"),
            0 if bias is None else bias.data_ptr(), out.data_ptr(), part.data_ptr(),
            M, N, K, k_chunk, splits, vec,
            torch._C._cuda_getCurrentRawStream(a.get_device())), f"gemm_tf32x3 {form}")
    mm_tf32x3.launches[form] += 1
    return out


def _will_run(node) -> bool:
    """Whether the running backward pass executes `node`; True for a leaf
    that `autograd.grad` was asked for, which torch captures rather than
    executes and will not answer for."""
    try:
        return torch._C._will_engine_execute_node(node)
    except RuntimeError:
        return True


def _needed(ctx, tensors) -> list:
    """Which inputs' gradients the running backward pass uses: those that
    require one and whose node the engine will execute (the create-graph
    coordinate gradient runs the input's branch alone). `tensors` says which
    inputs are tensors: only those have an entry in `next_functions`."""
    nodes = iter(ctx.next_functions)
    out = []
    for need, is_tensor in zip(ctx.needs_input_grad, tensors):
        node = next(nodes)[0] if is_tensor else None
        out.append(need and node is not None and _will_run(node))
    return out


class _Mm(torch.autograd.Function):
    """(a, b, bias) → a @ b (+ bias); its backward is this Function again."""

    @staticmethod
    def forward(ctx, a, b, bias):
        ctx.save_for_backward(a, b)
        ctx.has_bias = bias is not None
        return _launch(a, b, bias) if a.is_cuda else mm_ref(a, b, bias)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need = _needed(ctx, (True, True, ctx.has_bias))
        return (_Mm.apply(g, b.t(), None) if need[0] else None,
                _Mm.apply(a.t(), g, None) if need[1] else None,
                g.sum(0) if need[2] else None)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """a @ b (+ bias) for a (M, K) and b (K, N), bias (N,): float32 CUDA
    tensors launch the kernel (anything else on CUDA raises), CPU tensors
    take `mm_ref`; differentiable to any order."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or (
            bias is not None and tuple(bias.shape) != (b.shape[1],)):
        raise ValueError(f"mm_tf32x3: a (M, K), b (K, N) and bias (N,), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {None if bias is None else tuple(bias.shape)}")
    return _Mm.apply(a, b, bias)


mm_tf32x3.launches = {"nt": 0, "nn": 0, "tn": 0}  # calls of each form
