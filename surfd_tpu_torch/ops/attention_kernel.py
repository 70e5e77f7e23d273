"""Fused QKV softmax attention of the denoiser's attention blocks.

Kernel K2, `ops/csrc/qkv_attention.cu`, replaces the TPU kernel
`_attn_kernel` / `pallas_qkv_attention` (surfd_tpu/ops/attention_kernel.py,
retired in commit a9ab519); its plain version below is
`surfd_tpu/models/layers.py qkv_attention`. The source note in the .cu file
says what bounds it on an H100 and how the design answers.

Shapes are the JAX package's: heads-major fused qkv `(B, T, 3·H·c)` →
`(B, T, H·c)`. Two layouts are taken, and the output comes back in the
input's: a contiguous token-major tensor, or the `transpose(1, 2)` view of a
contiguous channel-first `(B, 3·H·c, T)` tensor, which is what the attention
block's 1×1 `Conv1d` writes. Any other striding raises; nothing is copied.

Under autograd (`qkv.requires_grad` with grad mode on) the call goes through
`QKVAttention`, a `torch.autograd.Function`: the forward is K2 as above, it
saves `qkv` and no softmax, and the backward is kernel K2-bwd,
`ops/csrc/qkv_attention_bwd.cu` (`qkv_attention_bwd`), which recomputes the
softmax; on the CPU the two plain versions. The JAX package trained through
`jax.grad` of its XLA reference; `qkv_attention_bwd_ref` is that gradient's
explicit formulas.
"""

from __future__ import annotations

import math

import torch

from . import _build

MAX_T, MAX_C = 64, 128  # the kernel's limits (T 64, c 28 at latent 64)


def _check(qkv: torch.Tensor, num_heads: int) -> int:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, T, 3*H*c), got {tuple(qkv.shape)}")
    if qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"width {qkv.shape[-1]} is not a multiple of 3*{num_heads}")
    return qkv.shape[-1] // (3 * num_heads)


def _channel_first(qkv: torch.Tensor) -> bool:
    """False for a contiguous (B, T, W) tensor, True for the transpose(1, 2)
    view of a contiguous (B, W, T) one; any other striding raises."""
    if qkv.is_contiguous():
        return False
    B, T, W = qkv.shape
    sb, st, sc = qkv.stride()
    if st == 1 and sc == T and (sb == W * T or B == 1):
        return True
    raise ValueError(
        f"qkv strides {qkv.stride()} for shape {tuple(qkv.shape)}: want a contiguous "
        "(B, T, W) tensor or the transpose(1, 2) of a contiguous (B, W, T) one"
    )


def qkv_attention_ref(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version (QKVAttentionLegacy, softmax in f32), in the
    input's layout."""
    qkv_attention_ref.calls += 1
    ch = _check(qkv, num_heads)
    channel_first = _channel_first(qkv)
    B, T, _ = qkv.shape
    q, k, v = qkv.reshape(B, T, num_heads, 3 * ch).split(ch, dim=-1)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    weights = _softmax_weights(q, k, scale)
    out = torch.einsum("bhts,bshc->bthc", weights, v).reshape(B, T, num_heads * ch)
    return _in_layout(out, channel_first)


qkv_attention_ref.calls = 0


def _softmax_weights(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, T, T) softmax((s·q)(s·k)ᵀ) over keys, computed in f32 at least
    (f64 stays f64, for gradcheck), returned in the inputs' dtype."""
    logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
    wide = torch.promote_types(logits.dtype, torch.float32)
    return torch.softmax(logits.to(wide), dim=-1).to(logits.dtype)


def _in_layout(x: torch.Tensor, channel_first: bool) -> torch.Tensor:
    """A (B, T, W) result as is, or as the transpose(1, 2) view of a
    contiguous (B, W, T) tensor."""
    return x.transpose(1, 2).contiguous().transpose(1, 2) if channel_first else x


def qkv_attention_bwd_ref(qkv: torch.Tensor, grad_out: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of K2-bwd: the gradient of `qkv_attention_ref`
    with respect to `qkv` for the output gradient `grad_out` (B, T, H·c), in
    `qkv`'s layout. The explicit formulas, softmax in f32: with s = c^-1/4
    and P = softmax((s·q)(s·k)ᵀ), dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP −
    rowsum(dO ⊙ O)), dQ = s²·dS·K, dK = s²·dSᵀ·Q."""
    qkv_attention_bwd_ref.calls += 1
    ch = _check(qkv, num_heads)
    channel_first = _channel_first(qkv)
    B, T, _ = qkv.shape
    if tuple(grad_out.shape) != (B, T, num_heads * ch):
        raise ValueError(f"grad_out must be {(B, T, num_heads * ch)}, got {tuple(grad_out.shape)}")
    q, k, v = qkv.reshape(B, T, num_heads, 3 * ch).split(ch, dim=-1)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    p = _softmax_weights(q, k, scale)
    do = grad_out.reshape(B, T, num_heads, ch)
    o = torch.einsum("bhts,bshc->bthc", p, v)
    dv = torch.einsum("bhts,bthc->bshc", p, do)
    dp = torch.einsum("bthc,bshc->bhts", do, v)
    row = (do * o).sum(-1).permute(0, 2, 1)[..., None]  # (B, H, T, 1)
    ds = p * (dp - row)
    dq = (scale * scale) * torch.einsum("bhts,bshc->bthc", ds, k)
    dk = (scale * scale) * torch.einsum("bhts,bthc->bshc", ds, q)
    grad = torch.cat([dq, dk, dv], dim=-1).reshape(B, T, 3 * num_heads * ch)
    return _in_layout(grad, channel_first)


qkv_attention_bwd_ref.calls = 0


def _plan(qkv: torch.Tensor, num_heads: int) -> tuple:
    """Everything a launch needs besides the pointers and the stream, for one
    (shape, strides, heads): the full checks run here, once."""
    ch = _check(qkv, num_heads)
    B, T, _ = qkv.shape
    if T > MAX_T or ch > MAX_C or B > 65535:
        raise ValueError(f"B={B}, T={T}, c={ch} is past K2's limits (T {MAX_T}, c {MAX_C})")
    hc = num_heads * ch
    out_strides = (hc * T, 1, T) if _channel_first(qkv) else (T * hc, hc, 1)
    args = (B, T, num_heads, ch, 1.0 / math.sqrt(math.sqrt(ch)), *qkv.stride(), *out_strides)
    return args, (B, T, hc), out_strides, (T, ch)


_plans: dict = {}  # (shape, strides, heads) -> _plan(...)
_launch = None  # the library's surfd_qkv_attention, bound at the first launch


def _launch_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K2 on a CUDA tensor, on the current stream."""
    global _launch
    if qkv.dtype != torch.float32:
        raise ValueError(f"qkv must be float32, got {qkv.dtype}")
    key = (qkv.shape, qkv.stride(), num_heads)
    plan = _plans.get(key)
    if plan is None:
        plan = _plan(qkv, num_heads)
        if _launch is None:
            _launch = _build.load().surfd_qkv_attention
        if len(_plans) >= 256:
            _plans.clear()
        _plans[key] = plan  # only once the checks passed and the library loaded
    args, size, out_strides, shape = plan
    out = qkv.new_empty_strided(size, out_strides)
    # the current stream's handle (honours torch.cuda.stream) without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(qkv.get_device())
    _build.check(_launch(qkv.data_ptr(), out.data_ptr(), *args, stream), "qkv_attention")
    qkv_attention.launches[shape] = qkv_attention.launches.get(shape, 0) + 1
    return out


def _cpu(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return True


class QKVAttention(torch.autograd.Function):
    """K2 with its gradient: the forward saves `qkv` (not the softmax), the
    backward recomputes it in K2-bwd. CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv)
        return qkv_attention_ref(qkv, num_heads) if _cpu(qkv) else _launch_fwd(qkv, num_heads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        (qkv,) = ctx.saved_tensors
        return qkv_attention_bwd(qkv, grad_out, ctx.num_heads), None


def qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, 3·H·c) → (B, T, H·c), in the input's layout. CUDA tensors launch
    K2 on the current stream; CPU tensors take the plain version. Any other
    device, dtype, striding or a shape past the kernel's limits raises. When
    autograd records (grad mode on, `qkv.requires_grad`), the backward is
    K2-bwd (`QKVAttention`)."""
    if qkv.requires_grad and torch.is_grad_enabled():
        return QKVAttention.apply(qkv, num_heads)
    return qkv_attention_ref(qkv, num_heads) if _cpu(qkv) else _launch_fwd(qkv, num_heads)


qkv_attention.launches = {}  # kernel launches per (T, c) shape


def _layout(x: torch.Tensor) -> str | None:
    """"token" (contiguous), "channel" (transpose(1, 2) of a contiguous
    (B, W, T)) or None for any other striding."""
    try:
        return "channel" if _channel_first(x) else "token"
    except ValueError:
        return None


_bwd_plans: dict = {}  # (shape, qkv strides, grad_out strides, heads) -> launch arguments
_launch_bwd = None  # the library's surfd_qkv_attention_bwd, bound at the first launch


def qkv_attention_bwd(qkv: torch.Tensor, grad_out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Gradient of `qkv_attention` with respect to `qkv` for the output
    gradient `grad_out`, in `qkv`'s layout. CUDA tensors launch K2-bwd on the
    current stream; CPU tensors take `qkv_attention_bwd_ref`. `grad_out` is
    read in either of K2's layouts; any other striding is made contiguous
    first. `qkv` must be in one of the two (else it raises), f32, within
    K2's limits."""
    global _launch_bwd
    if _cpu(qkv):
        return qkv_attention_bwd_ref(qkv, grad_out, num_heads)
    if qkv.dtype != torch.float32 or grad_out.dtype != torch.float32:
        raise ValueError(f"qkv and grad_out must be float32, got {qkv.dtype}, {grad_out.dtype}")
    if grad_out.device != qkv.device:
        raise ValueError(f"grad_out on {grad_out.device}, qkv on {qkv.device}")
    if _layout(grad_out) is None:
        grad_out = grad_out.contiguous()
    key = (qkv.shape, qkv.stride(), grad_out.shape, grad_out.stride(), num_heads)
    plan = _bwd_plans.get(key)
    if plan is None:
        args, size, out_strides, shape = _plan(qkv, num_heads)  # the forward's checks
        B, T, H, C, scale = args[:5]
        if tuple(grad_out.shape) != size:
            raise ValueError(f"grad_out must be {size}, got {tuple(grad_out.shape)}")
        W = 3 * size[2]
        dq_strides = (W * T, 1, T) if _channel_first(qkv) else (T * W, W, 1)
        bwd_args = (B, T, H, C, scale, *qkv.stride(), *grad_out.stride(), *dq_strides)
        plan = (bwd_args, (B, T, W), dq_strides, shape)
        if _launch_bwd is None:
            _launch_bwd = _build.load().surfd_qkv_attention_bwd
        if len(_bwd_plans) >= 256:
            _bwd_plans.clear()
        _bwd_plans[key] = plan
    args, size, dq_strides, shape = plan
    grad = qkv.new_empty_strided(size, dq_strides)
    stream = torch._C._cuda_getCurrentRawStream(qkv.get_device())
    _build.check(_launch_bwd(qkv.data_ptr(), grad_out.data_ptr(), grad.data_ptr(), *args, stream),
                 "qkv_attention_bwd")
    qkv_attention_bwd.launches[shape] = qkv_attention_bwd.launches.get(shape, 0) + 1
    return grad


qkv_attention_bwd.launches = {}  # K2-bwd launches per (T, c) shape
