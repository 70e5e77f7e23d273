"""The AE decoder's train-mode conditional BatchNorm and its ReLU as one unit.

`cbn_relu_train(x, gamma, beta, bn)` is `relu(gamma · BN(x) + beta)` with
the batch's statistics, as `models.layers.batch_norm` takes them in train
mode: rows i run over every point of every item (M = B·Q), per channel

    μ = Σx / M,  s = Σx² / M,  v = max(s − μ², 0),  r = 1 / √(v + ε),
    x̂ = (x − μ)·r,  z = γ_b·x̂ + β_b,  h = relu(z),

γ and β one row per item (the latent's projections), and `bn`'s running
buffers move by `bn.momentum` towards μ and the biased v. The unit is a
`torch.autograd.Function` whose backward is another, `_CbnReluGrad`, so
that the create-graph coordinate gradient of the AE step can itself be
differentiated; that one's backward (the unit's second derivative) is
`once_differentiable`. Each of the three stages reduces once over the rows
(per item and channel sums) and then makes one pointwise pass:

- forward: Σx, Σx² → μ, r, the clamp's mask k = [s − μ² ≥ 0]; h;
- backward, given gh: gz = [z > 0]·gh; gβ_b = Σ_b gz, gγ_b = Σ_b gz·x̂;
  S1 = Σ_b γ_b·gβ_b, S2 = Σ_b γ_b·gγ_b; gx = r·(γ_b·gz − S1/M − k·x̂·S2/M);
- backward2, given the cotangents a, Γ, Β of (gx, gγ, gβ): those of (gh,
  x, γ; β's is 0, β only moves the ReLU's mask), the derivative of the
  backward's formulas with μ, r and x̂ followed back to x (`backward2_ref`
  writes it out).

x̂, z and the masks are recomputed from x and the saved μ, r, k, γ, β in
every stage, never stored; z is rounded as torch rounds `γ·x̂ + β` (a product
and a sum), so that every stage reads the forward's mask.

On a CUDA tensor each stage launches `ops/csrc/cbn_train.cu` (a reduction,
a fixed-order finalize, a pointwise pass; no float atomics, so two runs are
bit-equal); on a CPU tensor it takes the plain versions below, which are
the same formulas in torch ops. The kernels replace no TPU kernel: the JAX
package left the decoder's BatchNorm to XLA. `models/decoder.py` sends a
CUDA float32 input in train mode here; eval mode and the CPU keep the
composed `batch_norm`. Spans: `cbn.forward`, `cbn.backward`,
`cbn.backward2` around the stages; `cbn_relu_train.launches` counts the
kernel launches of each stage.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from . import _build

SLAB_ROWS = 256  # rows of one item a CTA reduces or applies (the kernels' slab)


def _items(t: torch.Tensor) -> torch.Tensor:
    """(B, C) per-item rows broadcast over the points: (B, 1, C)."""
    return t[:, None, :]


def _xhat_z(x, gamma, beta, stats):
    mean, rstd = stats[0], stats[1]
    xh = (x - mean) * rstd
    return xh, _items(gamma) * xh + _items(beta)


def forward_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """The plain forward: (h, stats, v), stats (3, C) = (μ, r, k), v the
    clamped biased variance that the running buffer moves towards."""
    forward_ref.calls += 1
    flat = x.reshape(-1, x.shape[-1])
    mean = flat.mean(0)
    d = flat.square().mean(0) - mean.square()
    var = torch.clamp(d, min=0.0)
    stats = torch.stack([mean, torch.rsqrt(var + eps), (d >= 0).to(x.dtype)])
    _, z = _xhat_z(x, gamma, beta, stats)
    return torch.relu(z), stats, var


def backward_ref(gh: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 stats: torch.Tensor):
    """The plain backward: (gx, gγ, gβ) for the cotangent gh of h."""
    backward_ref.calls += 1
    M = x.shape[0] * x.shape[1]
    rstd, k = stats[1], stats[2]
    xh, z = _xhat_z(x, gamma, beta, stats)
    gz = torch.where(z > 0, gh, 0.0)
    gbeta = gz.sum(1)
    ggamma = (gz * xh).sum(1)
    s1 = (gamma * gbeta).sum(0)
    s2 = (gamma * ggamma).sum(0)
    gx = rstd * (_items(gamma) * gz - s1 / M - (k * s2 / M) * xh)
    return gx, ggamma, gbeta


def backward2_ref(a: torch.Tensor, ga: torch.Tensor, ba: torch.Tensor, gh: torch.Tensor,
                  x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, stats: torch.Tensor):
    """The plain second derivative: for the cotangents a (M-sized), ga and
    ba ((B, C)) of the backward's (gx, gγ, gβ), those of its inputs (gh, x,
    γ). With A = Σa, A2 = Σa·x̂ per channel and T_b = Σ_b a·gz:

        ggh = [z > 0]·(γ_b·r·(a − A/M − k·x̂·A2/M) + Γ_b·x̂ + Β_b)
        gγ  = r·(T_b − gβ_b·A/M − k·gγ_b·A2/M)
        gx  = r·(P_b·gz − q·a − G1/M − k·x̂·(r·R + G2)/M)

    where q = k·r·S2/M, P_b = Γ_b − k·r·γ_b·A2/M, G1 = Σ_b P_b·gβ_b − q·A,
    G2 = Σ_b P_b·gγ_b − q·A2 and R = Σ_b γ_b·T_b − S1·A/M − k·S2·A2/M: the
    gradient g_x̂ = P_b·gz − q·a of x̂ taken back through μ and r, which
    has the backward's own form."""
    backward2_ref.calls += 1
    M = x.shape[0] * x.shape[1]
    rstd, k = stats[1], stats[2]
    xh, z = _xhat_z(x, gamma, beta, stats)
    m = z > 0
    gz = torch.where(m, gh, 0.0)
    gbeta, ggamma = gz.sum(1), (gz * xh).sum(1)
    t = (a * gz).sum(1)
    A, A2 = a.sum((0, 1)), (a * xh).sum((0, 1))
    s1, s2 = (gamma * gbeta).sum(0), (gamma * ggamma).sum(0)
    q = k * rstd * s2 / M
    p = ga - (k * rstd / M) * gamma * A2
    g1 = (p * gbeta).sum(0) - q * A
    g2 = (p * ggamma).sum(0) - q * A2
    R = (gamma * t).sum(0) - s1 * A / M - k * s2 * A2 / M
    ggh = torch.where(m, _items(gamma) * rstd * (a - A / M - (k * A2 / M) * xh)
                      + _items(ga) * xh + _items(ba), 0.0)
    ggamma2 = rstd * (t - gbeta * (A / M) - ggamma * (k * A2 / M))
    gx = rstd * (_items(p) * gz - q * a - g1 / M - (k * (rstd * R + g2) / M) * xh)
    return ggh, gx, ggamma2


forward_ref.calls = backward_ref.calls = backward2_ref.calls = 0

_lib = None  # the kernels' library, bound at the first launch


def _kernels():
    global _lib
    if _lib is None:
        _lib = _build.load()
    return _lib


def _plan(x: torch.Tensor, full=(), small=()) -> tuple:
    """(B, Q, C, slabs, vec) for the launch; raises on inputs the kernels do
    not take. `full` are x's shape, `small` end in C (per item or per
    channel). vec: 16-byte loads along the channels."""
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"cbn kernels take a contiguous float32 (B, Q, C), got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, Q, C = x.shape
    nslab = -(-Q // SLAB_ROWS)
    if B * Q >= 2**31 or not 0 < B <= 65535 or not 0 < nslab <= 65535 or C == 0:
        raise ValueError(f"cbn kernels: shape {tuple(x.shape)} out of range")
    for t in (*full, *small):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"cbn kernels: a contiguous float32 on {x.device} wanted, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if any(t.shape != x.shape for t in full) or any(t.shape[-1] != C for t in small):
        raise ValueError(f"cbn kernels: {[tuple(t.shape) for t in (*full, *small)]} against x "
                         f"{tuple(x.shape)}")
    vec = int(C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *full, *small)))
    return B, Q, C, nslab, vec


def _stream(x: torch.Tensor):
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _forward(x, gamma, beta, bn):
    """h and stats; moves bn's running buffers."""
    if not x.is_cuda:
        h, stats, var = forward_ref(x, gamma, beta, bn.eps)
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(stats[0], alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
        return h, stats
    B, Q, C, nslab, vec = _plan(x, small=(gamma, beta, bn.running_mean, bn.running_var))
    h = torch.empty_like(x)
    stats = torch.empty((3, C), dtype=torch.float32, device=x.device)
    scratch = torch.empty(B * nslab * 2 * C + B * 2 * C, dtype=torch.float32, device=x.device)
    _build.check(_kernels().surfd_cbn_forward(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), bn.running_mean.data_ptr(),
        bn.running_var.data_ptr(), stats.data_ptr(), h.data_ptr(), scratch.data_ptr(),
        B, Q, C, SLAB_ROWS, vec, float(bn.eps), float(bn.momentum), _stream(x)), "cbn forward")
    cbn_relu_train.launches["forward"] += 1
    return h, stats


def _backward(gh, x, gamma, beta, stats):
    if not x.is_cuda:
        return backward_ref(gh, x, gamma, beta, stats)
    gh = gh.contiguous()
    B, Q, C, nslab, vec = _plan(x, (gh,), (gamma, beta, stats))
    gx = torch.empty_like(x)
    grads = torch.empty((2, B, C), dtype=torch.float32, device=x.device)  # gβ, gγ
    scratch = torch.empty(B * nslab * 2 * C + 2 * C, dtype=torch.float32, device=x.device)
    _build.check(_kernels().surfd_cbn_backward(
        x.data_ptr(), gh.data_ptr(), gamma.data_ptr(), beta.data_ptr(), stats.data_ptr(),
        gx.data_ptr(), grads.data_ptr(), scratch.data_ptr(),
        B, Q, C, SLAB_ROWS, vec, _stream(x)), "cbn backward")
    cbn_relu_train.launches["backward"] += 1
    return gx, grads[1], grads[0]


def _backward2(a, ga, ba, gh, x, gamma, beta, stats):
    if not x.is_cuda:
        return backward2_ref(a, ga, ba, gh, x, gamma, beta, stats)
    a, ga, ba = a.contiguous(), ga.contiguous(), ba.contiguous()
    B, Q, C, nslab, vec = _plan(x, (a, gh), (gamma, beta, ga, ba, stats))
    ggh, gx = torch.empty_like(x), torch.empty_like(x)
    ggamma = torch.empty((B, C), dtype=torch.float32, device=x.device)
    scratch = torch.empty(B * nslab * 5 * C + 6 * B * C + 5 * C, dtype=torch.float32,
                          device=x.device)
    _build.check(_kernels().surfd_cbn_backward2(
        x.data_ptr(), gh.data_ptr(), a.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        ga.data_ptr(), ba.data_ptr(), stats.data_ptr(), ggh.data_ptr(), gx.data_ptr(),
        ggamma.data_ptr(), scratch.data_ptr(), B, Q, C, SLAB_ROWS, vec, _stream(x)),
        "cbn backward2")
    cbn_relu_train.launches["backward2"] += 1
    return ggh, gx, ggamma


class _CbnReluGrad(torch.autograd.Function):
    """(gh, x, γ, β, stats) → (gx, gγ, gβ), differentiable once more."""

    @staticmethod
    def forward(ctx, gh, x, gamma, beta, stats):
        with span("cbn.backward"):
            out = _backward(gh, x, gamma, beta, stats)
        ctx.save_for_backward(gh, x, gamma, beta, stats)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, a, ga, ba):
        gh, x, gamma, beta, stats = ctx.saved_tensors
        if a is None and ga is None and ba is None:
            return None, None, None, None, None
        a = torch.zeros_like(x) if a is None else a
        ga = torch.zeros_like(gamma) if ga is None else ga
        ba = torch.zeros_like(beta) if ba is None else ba
        with span("cbn.backward2"):
            ggh, gx, ggamma = _backward2(a, ga, ba, gh, x, gamma, beta, stats)
        return ggh, gx, ggamma, None, None


class _CbnRelu(torch.autograd.Function):
    """(x, γ, β, bn) → h; saves x, γ, β and the (3, C) statistics."""

    @staticmethod
    def forward(ctx, x, gamma, beta, bn):
        with span("cbn.forward"):
            h, stats = _forward(x, gamma, beta, bn)
        ctx.save_for_backward(x, gamma, beta, stats)
        return h

    @staticmethod
    def backward(ctx, gh):
        x, gamma, beta, stats = ctx.saved_tensors
        gx, ggamma, gbeta = _CbnReluGrad.apply(gh, x, gamma, beta, stats)
        return gx, ggamma, gbeta, None


def cbn_relu_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   bn: torch.nn.BatchNorm1d) -> torch.Tensor:
    """relu(γ·BN(x) + β) on the batch's statistics, moving `bn`'s running
    buffers (its eps and momentum; `bn` has no affine parameters): x (B, Q,
    C), γ and β (B, C), one row per item. CUDA tensors launch the kernels
    (float32, anything else raises), CPU tensors take the plain versions;
    both are differentiable twice."""
    if x.dim() != 3 or gamma.shape != (x.shape[0], x.shape[2]) or beta.shape != gamma.shape:
        raise ValueError(f"cbn_relu_train: x (B, Q, C) with γ, β (B, C), got {tuple(x.shape)}, "
                         f"{tuple(gamma.shape)}, {tuple(beta.shape)}")
    return _CbnRelu.apply(x.contiguous(), gamma.contiguous(), beta.contiguous(), bn)


cbn_relu_train.launches = {"forward": 0, "backward": 0, "backward2": 0}  # calls of each stage
