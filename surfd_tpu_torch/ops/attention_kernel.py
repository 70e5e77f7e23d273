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
    logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
    weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    out = torch.einsum("bhts,bshc->bthc", weights, v).reshape(B, T, num_heads * ch)
    return out.transpose(1, 2).contiguous().transpose(1, 2) if channel_first else out


qkv_attention_ref.calls = 0


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


def qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, 3·H·c) → (B, T, H·c), in the input's layout. CUDA tensors launch
    K2 on the current stream; CPU tensors take the plain version. Any other
    device, dtype, striding or a shape past the kernel's limits raises."""
    global _launch
    if not qkv.is_cuda:
        if qkv.device.type != "cpu":
            raise ValueError(f"unsupported device {qkv.device}")
        return qkv_attention_ref(qkv, num_heads)
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


qkv_attention.launches = {}  # kernel launches per (T, c) shape
