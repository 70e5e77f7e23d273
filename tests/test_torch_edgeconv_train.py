"""The DGCNN encoder's train-mode edge convolution unit
(`ops/edgeconv_train.py`) on the CPU, through its plain versions: the unit's
forward and running buffers bit for bit against the composed block (gather,
Linear, `batch_norm`, LeakyReLU, amax), its gradients with respect to x, W,
γ and β against autograd of the composed block, `gradcheck` in float64, a
float64 emulation of the kernels' algorithm (the point-level product, the
max and min over the neighbours, the out- and in-edge sums through the
reverse adjacency) against the plain versions, the adjacency itself, the
routing of `Dgcnn`, and a whole train-mode `Dgcnn` on the plain unit against
the composed one. γ takes both signs, so both the max and the min path run.
The kernels themselves run on the card (tests/test_torch_edgeconv_train_cuda.py)."""

from unittest import mock

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from surfd_tpu_torch.models import dgcnn as tdgcnn
from surfd_tpu_torch.models.layers import batch_norm
from surfd_tpu_torch.ops import edgeconv_train as ec
from surfd_tpu_torch.ops import kernel_calls

# (B, N, k, Din, Dout): the first block's Din 3, a ragged N, k 16, one item,
# k 1, a wide block
SHAPES = [(2, 37, 6, 3, 8), (3, 50, 16, 5, 12), (1, 23, 4, 8, 4), (2, 9, 1, 4, 8),
          (2, 40, 20, 16, 32)]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(shape, dtype=torch.float64, seed=0):
    """x with a per-channel offset, its kNN on a random cloud, W, an affine
    BatchNorm whose γ has both signs (and moved running buffers), gf."""
    B, N, k, Din, Dout = shape
    g = torch.Generator().manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, dtype=dtype)

    idx = tdgcnn.knn_indices(randn(B, N, 3), k)
    x = randn(B, N, Din) + torch.linspace(-1, 2, Din, dtype=dtype)
    w = randn(Dout, 2 * Din) / (2 * Din) ** 0.5
    bn = nn.BatchNorm1d(Dout).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(randn(Dout))
        bn.weight[0], bn.weight[-1] = 0.7, -0.7
        bn.bias.copy_(0.2 * randn(Dout))
        bn.running_mean.uniform_(-1, 1, generator=g)
        bn.running_var.uniform_(0.5, 2, generator=g)
    return x, idx, w, bn, randn(B, N, Dout)


def _copy(bn):
    out = nn.BatchNorm1d(bn.num_features).to(bn.weight.dtype)
    out.load_state_dict(bn.state_dict())
    return out


def _composed(x, idx, w, bn):
    e = F.linear(tdgcnn.gather_graph_feature(x, idx), w)
    return F.leaky_relu(batch_norm(e, bn, True), 0.2, inplace=True).amax(dim=2)


def _leaves(*ts):
    return [t.clone().requires_grad_(True) for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_buffers_match_composed(shape, dtype):
    x, idx, w, bn, _ = _inputs(shape, dtype)
    bn2 = _copy(bn)
    f = ec.edgeconv_train(x, ec.adjacency(idx), w, bn)
    want = _composed(x, idx, w, bn2)
    # the same arithmetic on the selected element: the same bits
    assert torch.equal(f, want)
    assert torch.equal(bn.running_mean, bn2.running_mean)
    assert torch.equal(bn.running_var, bn2.running_var)
    _, stats, esel, sel, _ = ec.forward_ref(x, idx, w, bn.weight, bn.bias, bn.eps)
    e = F.linear(tdgcnn.gather_graph_feature(x, idx), w)
    # the selected slot holds e_sel, the max where mul >= 0 and the min elsewhere
    assert torch.equal(e.gather(2, sel[:, :, None, :].long())[:, :, 0], esel)
    up = stats[2] >= 0
    assert up.any() and (~up).any()
    assert torch.equal(esel, torch.where(up, e.amax(2), e.amin(2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_autograd_of_composed(shape, dtype):
    x, idx, w, bn, gf = _inputs(shape, dtype, seed=1)
    bn2 = _copy(bn)
    adj = ec.adjacency(idx)
    x1, w1 = _leaves(x, w)
    x2, w2 = _leaves(x, w)
    got = torch.autograd.grad(ec.edgeconv_train(x1, adj, w1, bn), (x1, w1, bn.weight, bn.bias),
                              gf)
    want = torch.autograd.grad(_composed(x2, idx, w2, bn2), (x2, w2, bn2.weight, bn2.bias), gf)
    tol = {torch.float64: dict(rtol=1e-10, atol=1e-12), torch.float32: dict(rtol=1e-4, atol=2e-5)}
    for name, u, v in zip(("x", "W", "gamma", "beta"), got, want):
        torch.testing.assert_close(u, v, **tol[dtype], msg=name)


def test_gradcheck():
    x, idx, w, bn, _ = _inputs((2, 15, 4, 3, 8), seed=2)
    adj = ec.adjacency(idx)
    gamma, beta = (t.detach().clone().requires_grad_(True) for t in (bn.weight, bn.bias))

    def fn(x, w, gamma, beta):
        b = _copy(bn)
        with torch.no_grad():
            b.weight.copy_(gamma)
            b.bias.copy_(beta)
        return ec._EdgeConv.apply(x, w, gamma, beta, *adj, b)

    assert torch.autograd.gradcheck(fn, tuple(_leaves(x, w)) + (gamma, beta))


def _emulate(x, idx, w, bn, gf):
    """The kernels' algorithm in float64 torch ops: (f, ∂x, ∂W, ∂γ, ∂β)."""
    B, N, k = idx.shape
    Din, Dout, G = x.shape[-1], w.shape[0], idx.shape[0] * idx.shape[1]
    adj = ec.adjacency(idx)
    wa, wb = w[:, :Din], w[:, Din:]
    pq = x.reshape(G, Din) @ torch.cat([wa, wb - wa]).t()
    p, q = pq[:, :Dout], pq[:, Dout:]
    nbr = (idx + N * torch.arange(B)[:, None, None]).reshape(G, k)  # global neighbour ids
    e = p[nbr] + q[:, None, :]  # (G, k, Dout): e_ij = P_j + Q_i
    M = G * k
    mean = e.sum((0, 1)) / M
    d = (e * e).sum((0, 1)) / M - mean * mean
    rstd = 1.0 / torch.sqrt(d.clamp(min=0) + bn.eps)
    mul = rstd * bn.weight.detach()
    emax, smax = e.max(1)
    emin, smin = e.min(1)
    up = mul >= 0
    esel, sel = torch.where(up, emax, emin), torch.where(up, smax, smin)
    f = F.leaky_relu((esel - mean) * mul + bn.bias.detach(), 0.2)
    u = torch.where(f > 0, gf.reshape(G, Dout), 0.2 * gf.reshape(G, Dout))
    su, sux = u.sum(0), (u * (esel - mean) * rstd).sum(0)
    a1, a2 = su / M, rstd * (d >= 0) * sux / M
    gc = mul * (u - k * a1 - a2 * (e - mean).sum(1))
    gn = torch.zeros_like(gc)
    for g in range(G):  # the in-edges, as the kernel walks the reverse adjacency
        for eid in adj.edges[adj.offsets[g]:adj.offsets[g + 1]].tolist():
            i, slot = divmod(eid, k)
            hit = (sel[i] == slot).to(x.dtype)
            gn[g] += mul * (hit * u[i] - a1 - a2 * (p[g] + q[i] - mean))
    h = torch.cat([gn - gc, gc], 1)
    hx = h.t() @ x.reshape(G, Din)
    dw = torch.cat([hx[:Dout], hx[Dout:]], 1)
    dx = (h @ torch.cat([wa, wb])).reshape(x.shape)
    return f.reshape(B, N, Dout), dx, dw, sux, su


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_kernel_algorithm_matches_plain_versions(shape):
    """The point-level product (e_ij = P_j + Q_i) and the out- and in-edge
    sums through the reverse adjacency give the plain versions' values."""
    x, idx, w, bn, gf = _inputs(shape, seed=3)
    f, stats, esel, sel, _ = ec.forward_ref(x, idx, w, bn.weight.detach(), bn.bias.detach(),
                                            bn.eps)
    want = ec.backward_ref(gf, x, idx, w, stats, esel, sel, f)
    got_f, *got = _emulate(x, idx, w, bn, gf)
    torch.testing.assert_close(got_f, f, rtol=1e-12, atol=1e-12)
    for name, u, v in zip(("x", "W", "gamma", "beta"), got, want):
        torch.testing.assert_close(u, v, rtol=1e-10, atol=1e-12, msg=name)


def test_adjacency_is_the_reverse_csr():
    idx = torch.tensor([[[0, 2], [1, 0], [2, 0]], [[0, 1], [1, 2], [2, 1]]])
    adj = ec.adjacency(idx)
    assert adj.idx.dtype == adj.offsets.dtype == adj.edges.dtype == torch.int32
    assert torch.equal(adj.idx, idx.int())
    # point g's in-edges g'·k + slot, ascending
    assert adj.offsets.tolist() == [0, 3, 4, 6, 7, 10, 12]
    assert adj.edges.tolist() == [0, 3, 5, 2, 1, 4, 6, 7, 8, 11, 9, 10]
    with pytest.raises(ValueError):
        ec.adjacency(torch.zeros((1, 300, 256), dtype=torch.int64))


def test_plain_versions_are_counted():
    x, idx, w, bn, gf = _inputs((2, 12, 4, 3, 8), seed=4)
    before = (ec.forward_ref.calls, ec.backward_ref.calls)
    launches = dict(ec.edgeconv_train.launches)
    lx = x.clone().requires_grad_(True)
    ec.edgeconv_train(lx, ec.adjacency(idx), w, bn).backward(gf)
    assert (ec.forward_ref.calls, ec.backward_ref.calls) == (before[0] + 1, before[1] + 1)
    assert ec.edgeconv_train.launches == launches  # no kernel on the CPU


def test_rejects_what_the_unit_does_not_take():
    x, idx, w, bn, _ = _inputs((2, 12, 4, 3, 8))
    adj = ec.adjacency(idx)
    with pytest.raises(ValueError):
        ec.edgeconv_train(x, adj, w[:, :5], bn)
    with pytest.raises(ValueError):
        ec.edgeconv_train(x[:1], adj, w, bn)
    with pytest.raises(ValueError):
        ec.edgeconv_train(x, adj, w, nn.BatchNorm1d(8, affine=False).double())


def test_routing_by_what_the_encoder_sees():
    """A CUDA float32 input in train mode with grad enabled takes the unit;
    eval mode, the CPU, float64 and grad-off calls keep the composed path."""
    cuda_x = mock.Mock(is_cuda=True, dtype=torch.float32)
    assert tdgcnn.fused(True, cuda_x)
    assert not tdgcnn.fused(False, cuda_x)
    assert not tdgcnn.fused(True, torch.zeros(2, 3, 3))
    assert not tdgcnn.fused(True, mock.Mock(is_cuda=True, dtype=torch.float64))
    with torch.no_grad():
        assert not tdgcnn.fused(True, cuda_x)


def _dgcnn(seed=0):
    enc = tdgcnn.Dgcnn(8, k=6).double().random_init_(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for i in range(1, 6):  # γ of both signs and off 0 (no ties over k), β off 0
            bn = getattr(enc, f"bn_{i}")
            bn.weight.copy_(torch.linspace(-1.2, 1.5, bn.num_features, dtype=torch.float64) + 0.02)
            bn.bias.copy_(torch.linspace(-0.3, 0.2, bn.num_features, dtype=torch.float64))
    return enc.train()


def test_dgcnn_on_the_cpu_is_composed_and_keeps_its_keys():
    enc = _dgcnn()
    keys = list(enc.state_dict())
    assert keys == list(tdgcnn.Dgcnn(8, k=6).state_dict())
    assert not any("adj" in k or "edgeconv" in k for k in keys)
    plain = kernel_calls()["plain_calls"]
    pts = torch.randn(2, 30, 3, dtype=torch.float64, requires_grad=True)
    for train in (True, False):
        enc.train(train)(pts).sum().backward()
    assert kernel_calls()["plain_calls"] == plain


def test_dgcnn_train_on_the_plain_unit_matches_composed():
    """A whole train-mode Dgcnn (four edge blocks and the latent's block):
    the latents bit for bit, every parameter's gradient and the running
    buffers, the edge blocks on the plain unit against the composed path."""
    pts = torch.randn(2, 40, 3, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    cot = torch.randn(2, 8, generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    out = []
    for route in (tdgcnn.fused, lambda training, x: training):
        enc = _dgcnn()
        calls = ec.forward_ref.calls
        with mock.patch.object(tdgcnn, "fused", route):
            lat = enc(pts)
            grads = torch.autograd.grad(lat, list(enc.parameters()), cot)
        out.append((lat, grads, enc.state_dict(), ec.forward_ref.calls - calls))
    (lat1, g1, sd1, ran1), (lat2, g2, sd2, ran2) = out
    assert (ran1, ran2) == (0, 4)
    assert torch.equal(lat1, lat2)
    for (name, _), u, v in zip(_dgcnn().named_parameters(), g2, g1):
        torch.testing.assert_close(u, v, rtol=1e-10, atol=1e-12, msg=name)
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k
