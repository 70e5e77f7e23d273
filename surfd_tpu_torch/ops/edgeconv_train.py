"""The DGCNN encoder's train-mode edge convolution as one unit: gather →
Linear → BatchNorm on the batch's statistics → LeakyReLU 0.2 → max over the
k neighbours, with its first derivative.

`edgeconv_train(x, adj, weight, bn)` is, for x (B, N, Din), the neighbours
`adj.idx` (B, N, k) and the Linear's weight W (Dout, 2·Din),

    e_ij = W · [x_j − x_i, x_i],  f_i = max_j lrelu(γ·(e_ij − μ)·r + β),

μ and r = 1/√(v + ε) over every edge of every item (M = B·N·k), v =
max(E[e²] − μ², 0) (`models.layers.batch_norm` in train mode), `bn`'s γ,
β, eps, and its running buffers moved by `bn.momentum` towards μ and v.

Per channel the BatchNorm is an affine map of slope mul = γ·r and the
LeakyReLU is increasing, so the max over j is taken at the largest e_ij
where mul ≥ 0 and at the smallest where mul < 0: f_i = lrelu((e_sel − μ)·mul
+ β), bit for bit the composed path's value. The unit keeps, per (point,
channel), that e_sel and its slot (`sel`, uint8: k ≤ 255) and nothing of
size B·N·k. Off the selected edge the BN output's gradient is 0, so with u_i
= ∂L/∂f_i·lrelu'(f_i), Su = Σ_i u_i and Sux = Σ_i u_i·x̂_sel (point-level
sums, which are also ∂L/∂β and ∂L/∂γ) each edge's gradient is

    G_ij = mul·(s_ij·u_i − Su/M − (e_ij − μ)·r·k·Sux/M),

s_ij = [j is i's selected slot] and k the variance clamp's mask. Where
several neighbours give the same output (γ = 0, or equal e), the composed
amax shares the gradient among them; the unit gives it to the first slot.

On a CUDA tensor the unit writes the Linear as W_a·x_j + (W_b − W_a)·x_i
(W = [W_a | W_b]): one point-level product PQ = x·[W_a; W_b − W_a]ᵀ (N × 2·Dout,
`torch.matmul` in f32, TF32 off) makes every e_ij = P_j + Q_i, 20× fewer
FLOPs than the edge-level product. The kernels (`ops/csrc/edgeconv_train.cu`)
then take

- forward: one pass over the edges (Σe, Σe² per slab of points, the max and
  the min of e over j with their slots), a fixed-order finalize (μ, r, mul,
  the running buffers), a pass over the points (f, e_sel, sel);
- backward: a pass over the points (u, and Su, Sux per slab), a fixed-order
  finalize (∂γ, ∂β and G's coefficients), a pass over the points that sums
  each point's out-edges (Gc_i = Σ_j G_ij, from P of its neighbours) and its
  in-edges (Gn_j = Σ_i G_ij, through `adj`'s reverse adjacency, so no
  scatter and no float atomics), writing H = [Gn − Gc, Gc]; then
  ∂x = H·[W_a; W_b] and ∂W = [(Gn − Gc)ᵀx | Gcᵀx], two point-level products.

Two runs give the same bits. On a CPU tensor the unit takes the plain
versions below, which compute e_ij at the edge level as the composed path
does. The kernels replace no TPU kernel: the JAX package left the DGCNN to
XLA (`surfd_tpu/models/dgcnn.py`). `models/dgcnn.py` sends a train-mode
CUDA float32 input with grad enabled here; eval mode and the CPU keep the
composed path. Spans: `edgeconv.forward`, `edgeconv.backward` around the
stages (products included); `edgeconv_train.launches` counts the stages'
calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from . import _build

SLAB = 64         # points a CTA of the edge and point passes owns
NEG_SLOPE = 0.2   # the encoder's LeakyReLU


class Adjacency(NamedTuple):
    """The neighbours of one step, shared by its four blocks: `idx` (B, N,
    k) int32 of each point's k neighbours in its item; the reverse adjacency
    as CSR over the B·N points, `edges[offsets[g]:offsets[g + 1]]` the edge
    ids (g'·k + slot, ascending) whose neighbour is point g."""

    idx: torch.Tensor
    offsets: torch.Tensor
    edges: torch.Tensor


def adjacency(indices: torch.Tensor) -> Adjacency:
    """`indices` (B, N, k) int64 from `knn_indices` → their Adjacency: a
    stable sort of the edges by their global neighbour id (deterministic),
    the offsets by a search in the sorted ids (no host sync, which
    `bincount` on CUDA takes)."""
    B, N, k = indices.shape
    if B * N * k >= 2**31 or k > 255:
        raise ValueError(f"edgeconv: {B} x {N} points x k {k} out of range (k <= 255, "
                         f"B·N·k < 2^31)")
    dev = indices.device
    target = (indices + N * torch.arange(B, device=dev)[:, None, None]).reshape(-1)
    ids, edges = torch.sort(target, stable=True)
    offsets = torch.searchsorted(ids, torch.arange(B * N + 1, device=dev))
    return Adjacency(indices.to(torch.int32).contiguous(), offsets.to(torch.int32),
                     edges.to(torch.int32))


def _edges(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> tuple:
    """(e (B, N, k, Dout), the edge features) as the composed path forms them."""
    from ..models.dgcnn import gather_graph_feature

    feat = gather_graph_feature(x, idx.long())
    return F.linear(feat, weight), feat


def forward_ref(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor, eps: float):
    """The plain forward: (f, stats, e_sel, sel, v), stats (4, Dout) = (μ, r,
    mul, k), v the clamped variance that the running buffer moves towards."""
    forward_ref.calls += 1
    e, _ = _edges(x, idx, weight)
    flat = e.reshape(-1, e.shape[-1])
    mean = flat.mean(0)
    d = flat.square().mean(0) - mean.square()
    var = torch.clamp(d, min=0.0)
    rstd = torch.rsqrt(var + eps)
    mul = rstd * gamma
    emax, smax = e.max(dim=2)
    emin, smin = e.min(dim=2)
    up = mul >= 0
    esel = torch.where(up, emax, emin)
    sel = torch.where(up, smax, smin).to(torch.uint8)
    f = F.leaky_relu((esel - mean) * mul + beta, NEG_SLOPE)
    stats = torch.stack([mean, rstd, mul, (d >= 0).to(x.dtype)])
    return f, stats, esel, sel, var


def backward_ref(gf: torch.Tensor, x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                 stats: torch.Tensor, esel: torch.Tensor, sel: torch.Tensor, f: torch.Tensor):
    """The plain backward: (∂x, ∂W, ∂γ, ∂β) for the cotangent gf of f, from
    every edge's G_ij (the module's docstring) at the edge level."""
    backward_ref.calls += 1
    mean, rstd, mul, k = stats
    B, N, K = idx.shape
    M = B * N * K
    u = torch.where(f > 0, gf, gf * NEG_SLOPE)
    su = u.sum((0, 1))
    sux = (u * ((esel - mean) * rstd)).sum((0, 1))
    e, feat = _edges(x, idx, weight)
    hit = torch.arange(K, device=x.device)[:, None] == sel[:, :, None, :].long()
    g = mul * (torch.where(hit, u[:, :, None, :], 0.0) - su / M
               - (e - mean) * (rstd * k * sux / M))
    dw = torch.einsum("bnkc,bnkd->cd", g, feat)
    dfeat = g @ weight  # (B, N, k, 2·Din): [∂(x_j − x_i), ∂x_i]
    Din = x.shape[-1]
    dx = dfeat[..., Din:].sum(2) - dfeat[..., :Din].sum(2)
    flat = (idx.long() + N * torch.arange(B, device=x.device)[:, None, None]).reshape(-1)
    dx = dx.reshape(B * N, Din).index_add(0, flat, dfeat[..., :Din].reshape(-1, Din))
    return dx.reshape(x.shape), dw, sux, su


forward_ref.calls = backward_ref.calls = 0

_lib = None  # the kernels' library, bound at the first launch


def _kernels():
    global _lib
    if _lib is None:
        _lib = _build.load()
    return _lib


def _check(x: torch.Tensor, adj: Adjacency, weight: torch.Tensor, bn) -> tuple:
    """(B, N, Din, Dout, k) for the launch; raises on what the kernels do not take."""
    tensors = (x, weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    if any(t.dtype != torch.float32 or t.device != x.device for t in tensors):
        raise ValueError("edgeconv kernels take float32 tensors on one device, got "
                         f"{[(t.dtype, str(t.device)) for t in tensors]}")
    if any(t.device != x.device or t.dtype != torch.int32 for t in adj):
        raise ValueError("edgeconv kernels: the adjacency must be int32 on the input's device")
    B, N, Din = x.shape
    Dout, k = weight.shape[0], adj.idx.shape[-1]
    if Dout % 4 or Dout > 4096 or -(-B * N // SLAB) > 65535:
        raise ValueError(f"edgeconv kernels: Dout {Dout} (a multiple of 4 up to 4096) or "
                         f"{B} x {N} points out of range")
    return B, N, Din, Dout, k


def _stream(x: torch.Tensor):
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _forward(x, weight, adj, bn):
    """f and what the backward reads; moves bn's running buffers."""
    if not x.is_cuda:
        f, stats, esel, sel, var = forward_ref(x, adj.idx, weight, bn.weight, bn.bias, bn.eps)
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(stats[0], alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
        return f, (stats, esel, sel, None)
    B, N, Din, Dout, k = _check(x, adj, weight, bn)
    G = B * N
    wa = weight[:, :Din]
    pq = torch.matmul(x.reshape(G, Din), torch.cat([wa, weight[:, Din:] - wa]).t())
    f, esel, emin = (torch.empty((B, N, Dout), dtype=torch.float32, device=x.device)
                     for _ in range(3))
    sel, smin = (torch.empty((B, N, Dout), dtype=torch.uint8, device=x.device) for _ in range(2))
    stats = torch.empty((4, Dout), dtype=torch.float32, device=x.device)
    partial = torch.empty((-(-G // SLAB), 2, Dout), dtype=torch.float32, device=x.device)
    _build.check(_kernels().surfd_edgeconv_forward(
        pq.data_ptr(), adj.idx.data_ptr(), bn.weight.data_ptr(), bn.bias.data_ptr(),
        bn.running_mean.data_ptr(), bn.running_var.data_ptr(), stats.data_ptr(), f.data_ptr(),
        esel.data_ptr(), emin.data_ptr(), sel.data_ptr(), smin.data_ptr(),
        partial.data_ptr(), B, N, k, Dout, SLAB, float(bn.eps), float(bn.momentum),
        _stream(x)), "edgeconv forward")
    edgeconv_train.launches["forward"] += 1
    return f, (stats, esel, sel, pq)


def _backward(gf, x, weight, adj, f, stats, esel, sel, pq, need_x: bool):
    """(∂x or None, ∂W, ∂γ, ∂β)."""
    if not x.is_cuda:
        dx, dw, dgamma, dbeta = backward_ref(gf, x, adj.idx, weight, stats, esel, sel, f)
        return (dx if need_x else None), dw, dgamma, dbeta
    B, N, Din = x.shape
    Dout, k, G = weight.shape[0], adj.idx.shape[-1], B * N
    gf = gf.contiguous()
    if gf.data_ptr() % 16:  # a view at an offset: the kernels load 16 bytes at a time
        gf = gf.clone()
    u = torch.empty((G, Dout), dtype=torch.float32, device=x.device)
    h = torch.empty((G, 2 * Dout), dtype=torch.float32, device=x.device)
    grads = torch.empty((2, Dout), dtype=torch.float32, device=x.device)  # ∂β, ∂γ
    coef = torch.empty((4, Dout), dtype=torch.float32, device=x.device)
    partial = torch.empty((-(-G // SLAB), 2, Dout), dtype=torch.float32, device=x.device)
    _build.check(_kernels().surfd_edgeconv_backward(
        gf.data_ptr(), f.data_ptr(), esel.data_ptr(), sel.data_ptr(), stats.data_ptr(),
        pq.data_ptr(), adj.idx.data_ptr(), adj.offsets.data_ptr(), adj.edges.data_ptr(),
        u.data_ptr(), h.data_ptr(), grads.data_ptr(), coef.data_ptr(), partial.data_ptr(),
        B, N, k, Dout, SLAB, _stream(x)), "edgeconv backward")
    edgeconv_train.launches["backward"] += 1
    x2 = x.reshape(G, Din)
    hx = h.t() @ x2  # (2·Dout, Din): [(Gn − Gc)ᵀx; Gcᵀx]
    dw = torch.cat([hx[:Dout], hx[Dout:]], 1)
    dx = (h @ torch.cat([weight[:, :Din], weight[:, Din:]])).reshape(x.shape) if need_x else None
    return dx, dw, grads[1], grads[0]


class _EdgeConv(torch.autograd.Function):
    """(x, W, γ, β, idx, offsets, edges, bn) → f; differentiable once."""

    @staticmethod
    def forward(ctx, x, weight, gamma, beta, idx, offsets, edges, bn):
        adj = Adjacency(idx, offsets, edges)
        with span("edgeconv.forward"):
            f, (stats, esel, sel, pq) = _forward(x, weight, adj, bn)
        ctx.save_for_backward(x, weight, idx, offsets, edges, f, stats, esel, sel,
                              *(() if pq is None else (pq,)))
        return f

    @staticmethod
    @once_differentiable
    def backward(ctx, gf):
        x, weight, idx, offsets, edges, f, stats, esel, sel, *pq = ctx.saved_tensors
        with span("edgeconv.backward"):
            dx, dw, dgamma, dbeta = _backward(
                gf, x, weight, Adjacency(idx, offsets, edges), f, stats, esel, sel,
                pq[0] if pq else None, ctx.needs_input_grad[0])
        return dx, dw, dgamma, dbeta, None, None, None, None


def edgeconv_train(x: torch.Tensor, adj: Adjacency, weight: torch.Tensor,
                   bn: torch.nn.BatchNorm1d) -> torch.Tensor:
    """max over the k neighbours of lrelu(BN(W·[x_j − x_i, x_i]), 0.2) on the
    batch's statistics, moving `bn`'s running buffers: x (B, N, Din), `adj`
    from `adjacency`, W (Dout, 2·Din), `bn` affine over Dout → (B, N, Dout).
    CUDA tensors launch the kernels (float32, anything else raises), CPU
    tensors take the plain versions; both are differentiable once."""
    if (x.dim() != 3 or adj.idx.shape[:2] != x.shape[:2] or weight.dim() != 2
            or weight.shape[1] != 2 * x.shape[2] or bn.weight is None
            or bn.num_features != weight.shape[0]):
        raise ValueError(f"edgeconv_train: x (B, N, D), idx (B, N, k), W (Dout, 2·D) and an "
                         f"affine BatchNorm over Dout, got {tuple(x.shape)}, "
                         f"{tuple(adj.idx.shape)}, {tuple(weight.shape)}, {bn}")
    return _EdgeConv.apply(x.contiguous(), weight, bn.weight, bn.bias, *adj, bn)


edgeconv_train.launches = {"forward": 0, "backward": 0}  # calls of each stage
