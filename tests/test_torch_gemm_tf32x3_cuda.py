"""The 3xTF32 GEMM (`ops/gemm_tf32x3.py`, `ops/csrc/gemm_tf32x3.cu`) on the
card: each form at the AE step's shape and at odd shapes against float64,
with a planted single-pass TF32 GEMM that the bars must reject; two runs
bit-equal; NaN propagation; a second-order loss against the composed f32
path; the current stream; the decoder's routing.

Every test needs a CUDA card and skips without one. The file imports only
torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gemm_tf32x3_cuda.py
"""

import pytest
import torch

from surfd_tpu_torch.ops import gemm_tf32x3 as gm
from surfd_tpu_torch.ops.decoder_kernel import round_tf32

# The kernel against float64 on the same f32 operands: max |C - C64| over
# max |C64|. 3xTF32 drops A_lo B_lo (~2^-22 of a product) and truncates in
# the tensor cores' f32 sums (48 steps a fresh sum), then sums those in f32:
# it reads 0.93e-6 to 1.1e-6 at the AE step's three shapes on an H100 (PERF.md's
# kernel table). A single-pass TF32 product rounds each operand to 11 bits
# (2^-12 each): the planted fault below reads 2.8e-4 to 3.3e-4 there. The
# bar sits 18 times above the one and 14 times below the other.
BAR = 2e-5
# (form, M, N, K): the AE step's three GEMMs (cell 4: 8 x 20,000 rows of
# 512 channels), then odd shapes: ragged tiles with 16-byte copies, 4-byte
# copies (a width not a multiple of 4), one element, K split over many CTAs
# with a ragged last chunk.
FULL = [("nt", 160_000, 512, 512), ("nn", 160_000, 512, 512), ("tn", 512, 512, 160_000)]
ODD = [("nt", 260, 132, 96), ("nn", 300, 257, 500), ("tn", 37, 129, 61), ("nt", 1, 1, 1),
       ("tn", 130, 200, 40_000), ("nn", 129, 128, 33), ("tt", 64, 96, 1000)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    from surfd_tpu_torch.utils import use_full_f32

    use_full_f32()
    return torch.device("cuda")


def _operands(form, M, N, K, dev, seed=0):
    """a (M, K) and b (K, N) in the layouts of `form` (t: a transposed view
    of a contiguous tensor), values of either sign."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((K, M) if form[0] == "t" else (M, K), generator=g, device=dev)
    b = torch.randn((N, K) if form[1] == "t" else (K, N), generator=g, device=dev)
    return (a.t() if form[0] == "t" else a), (b.t() if form[1] == "t" else b)


def _gap(got, want) -> float:
    return float((got.double() - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FULL + ODD, ids=lambda c: "-".join(map(str, c)))
def test_form_against_f64_and_planted_tf32(cuda, case, record_property):
    form, M, N, K = case
    a, b = _operands(form, M, N, K, cuda)
    bias = torch.randn(N, device=cuda) if K % 2 else None
    want = a.double() @ b.double() + (0 if bias is None else bias.double())
    before = dict(gm.mm_tf32x3.launches)
    got = gm.mm_tf32x3(a, b, bias)
    tf32 = round_tf32(a).double() @ round_tf32(b).double() + (0 if bias is None
                                                               else bias.double())
    torch.cuda.synchronize()
    read = {"kernel": _gap(got, want), "tf32": _gap(tf32, want)}
    record_property("gaps", read)
    print(case, read)
    assert read["kernel"] <= BAR < read["tf32"] or (K == 1 and read["kernel"] <= BAR), read
    ran = gm.operands(a, b)[0]  # tt runs as tn; a 1 x 1 b reads as row-major
    assert gm.mm_tf32x3.launches == {f: n + (f == ran) for f, n in before.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [FULL[2], ("tn", 130, 200, 40_000), FULL[0]],
                         ids=lambda c: "-".join(map(str, c)))
def test_two_runs_are_bit_equal(cuda, case):
    """K split over CTAs (the TN forms) sums the partials in a fixed order."""
    form, M, N, K = case
    a, b = _operands(form, M, N, K, cuda, seed=1)
    assert torch.equal(gm.mm_tf32x3(a, b), gm.mm_tf32x3(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["nt", "nn", "tn"])
def test_nan_propagates(cuda, form):
    """A NaN in row 3 of a makes row 3 of the product NaN and no other (in
    the TN form a's row 3 is a column of the transposed source), so the AE
    step's non-finite skip still sees it."""
    M, N, K = (300, 256, 2000) if form == "tn" else (2000, 256, 300)
    a, b = _operands(form, M, N, K, cuda, seed=2)
    a = a.clone()
    a[3, 7] = float("nan")
    out = gm.mm_tf32x3(a, b)
    assert torch.isnan(out[3]).all()
    assert not torch.isnan(out[torch.arange(M, device=cuda) != 3]).any()


@pytest.mark.cuda
def test_second_order_loss_matches_composed(cuda, record_property):
    """A loss on the create-graph input gradient of two stacked projections
    (tanh between, squared after), differentiated again, at 4 x 3,000 x
    512: the kernel's gradients (x, both weights and biases) and the
    composed F.linear f32 path's, each against the composed path in float64. Each form runs four
    times: the forward (nt), the input gradient (nn), and in the backward
    the forward graph's (nn, tn) and the gradient graph's (nt, tn)."""
    B, Q, C = 4, 3000, 512
    g = torch.Generator(device=cuda).manual_seed(3)
    x0 = torch.randn((B, Q, C), generator=g, device=cuda)
    ws = [torch.randn((C, C), generator=g, device=cuda) / C ** 0.5 for _ in range(2)]
    bs = [0.1 * torch.randn(C, generator=g, device=cuda) for _ in range(2)]
    gh, go = (torch.randn((B, Q, C), generator=g, device=cuda) for _ in range(2))
    wsum = torch.randn(C, device=cuda)

    def lin_kernel(x, w, b):
        return gm.mm_tf32x3(x.reshape(-1, C), w.t(), b).reshape(x.shape)

    def grads(lin, dtype=torch.float32):
        x = x0.to(dtype).requires_grad_(True)
        params = [t.to(dtype).requires_grad_(True) for t in (*ws, *bs)]
        out = lin(torch.tanh(lin(x, params[0], params[2])), params[1], params[3])
        s = (out.square() * wsum.to(dtype)).sum()
        gx = torch.autograd.grad(s, x, create_graph=True)[0]
        loss = (gx * gh.to(dtype)).sum() + (out * go.to(dtype)).sum()
        return torch.autograd.grad(loss, (x, *params))

    want = grads(torch.nn.functional.linear, torch.float64)
    before = dict(gm.mm_tf32x3.launches)
    kern = [_gap(u, v) for u, v in zip(grads(lin_kernel), want)]
    assert gm.mm_tf32x3.launches == {f: n + 4 for f, n in before.items()}
    comp = [_gap(u, v) for u, v in zip(grads(torch.nn.functional.linear), want)]
    record_property("gaps", {"kernel": kern, "composed": comp})
    print("kernel", kern, "composed", comp)
    assert max(kern) <= max(4 * max(comp), 1e-5), (kern, comp)


@pytest.mark.cuda
def test_launches_on_the_current_stream(cuda):
    """Captured into a CUDA graph on a side stream (a launch on another
    stream breaks the capture) and replayed: the TN form with its split
    reduction, then the NT form with a bias."""
    a, b = _operands("tn", 256, 384, 20_000, cuda, seed=4)
    x, w = _operands("nt", 1000, 256, 512, cuda, seed=5)
    bias = torch.randn(256, device=cuda)
    eager = (gm.mm_tf32x3(a, b), gm.mm_tf32x3(x, w, bias))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (gm.mm_tf32x3(a, b), gm.mm_tf32x3(x, w, bias))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(out, eager))


@pytest.mark.cuda
def test_decoder_routing(cuda):
    """A CbnDecoder 128 wide with 2 blocks in train mode on the card: its 4
    hidden projections take the kernel, each form 2 x 4 times a step (the
    forward, the create-graph gradient, the backward of both); fc_p, fc_out
    and the γ/β projections keep F.linear. Eval mode and the CPU launch
    nothing and call no plain version."""
    from surfd_tpu_torch.models import CbnDecoder
    from surfd_tpu_torch.ops import kernel_calls

    g = torch.Generator().manual_seed(0)
    dec = CbnDecoder(8, 128, 2).random_init_(g)
    coords = torch.randn(2, 300, 63, generator=g)
    lat = torch.randn(2, 8, generator=g)

    def step(dev, train):
        d = dec.to(dev).train(train)
        c = coords.to(dev).requires_grad_(True)
        out = d(c, lat.to(dev))
        gx = torch.autograd.grad(out.sum(), c, create_graph=True)[0]
        (gx.square().sum() + out.sum()).backward()

    plain = kernel_calls()["plain_calls"]
    before = dict(gm.mm_tf32x3.launches)
    step(cuda, True)
    assert gm.mm_tf32x3.launches == {f: n + 2 * 4 for f, n in before.items()}
    for dev, train in ((cuda, False), (torch.device("cpu"), True), (torch.device("cpu"), False)):
        before = dict(gm.mm_tf32x3.launches)
        step(dev, train)
        assert gm.mm_tf32x3.launches == before, (dev, train)
    assert kernel_calls()["plain_calls"] == plain


@pytest.mark.cuda
def test_rejects_what_the_kernel_does_not_take(cuda):
    a, b = _operands("nn", 64, 64, 64, cuda)
    with pytest.raises(ValueError):
        gm.mm_tf32x3(a.double(), b.double())
    with pytest.raises(ValueError):
        gm.mm_tf32x3(a, b.cpu())
    with pytest.raises(ValueError):
        gm.mm_tf32x3(a, b[:5])
