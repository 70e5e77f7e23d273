"""The 3xTF32 GEMM `mm_tf32x3` (`ops/gemm_tf32x3.py`) on the CPU, through
its plain version: the product against float64 in every layout and at ragged
shapes, `gradcheck` and `gradgradcheck` in float64, the products a backward
pass runs (only those it uses), the kernel's form read from the strides, the
split of K, the decoder's routing, and a whole AE loss gradient with the
decoder's projections on the Function against the composed decoder, in
float64. The kernel itself runs on the card (tests/test_torch_gemm_tf32x3_cuda.py)."""

from unittest import mock

import numpy as np
import pytest
import torch

from surfd_tpu_torch.models import decoder as tdecoder
from surfd_tpu_torch.ops import gemm_tf32x3 as gm
from surfd_tpu_torch.ops import kernel_calls
from surfd_tpu_torch.training import ae_trainer

# (M, N, K): ragged against the kernel's 128-wide tiles and 32-deep k-blocks,
# one element, a long K
SHAPES = [(7, 5, 3), (130, 129, 33), (1, 1, 1), (3, 4, 300)]
LAYOUTS = ["nn", "nt", "tn", "tt"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _operands(layout, M, N, K, dtype=torch.float64, seed=0):
    """a (M, K) and b (K, N), each row-major or (t) a transposed view of a
    contiguous tensor; with a bias (N,)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((K, M) if layout[0] == "t" else (M, K), generator=g, dtype=dtype)
    b = torch.randn((N, K) if layout[1] == "t" else (K, N), generator=g, dtype=dtype)
    bias = torch.randn(N, generator=g, dtype=dtype)
    return (a.t() if layout[0] == "t" else a), (b.t() if layout[1] == "t" else b), bias


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_route_matches_f64(layout, shape):
    a, b, bias = _operands(layout, *shape, dtype=torch.float32)
    want = a.double() @ b.double() + bias.double()
    calls = gm.mm_ref.calls
    got = gm.mm_tf32x3(a, b, bias)
    assert got.dtype == torch.float32 and got.shape == shape[:2]
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gm.mm_tf32x3(a, b).double(), want - bias.double(),
                               rtol=1e-5, atol=1e-5)
    assert gm.mm_ref.calls == calls + 2


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", [(4, 3, 5), (2, 6, 1)])
def test_gradcheck_and_gradgradcheck(layout, shape):
    a, b, bias = (t.detach().requires_grad_(True) for t in _operands(layout, *shape, seed=1))
    assert torch.autograd.gradcheck(gm.mm_tf32x3, (a, b, bias))
    assert torch.autograd.gradgradcheck(gm.mm_tf32x3, (a, b, bias))
    assert torch.autograd.gradgradcheck(lambda u, v: gm.mm_tf32x3(u, v).square(), (a, b))


def test_backward_runs_only_the_products_it_uses():
    """The create-graph gradient of the input runs one product (not the
    weight's); its double backward then runs both of that node's; a
    backward to every leaf runs the forward node's two."""
    a, b, bias = (t.detach().requires_grad_(True) for t in _operands("nt", 6, 5, 4, seed=2))
    calls = gm.mm_ref.calls
    out = gm.mm_tf32x3(a, b, bias)
    assert gm.mm_ref.calls == calls + 1
    ga = torch.autograd.grad(out.square().sum(), a, create_graph=True)[0]
    assert gm.mm_ref.calls == calls + 2
    torch.autograd.grad(ga.square().sum(), (a, b, bias))
    assert gm.mm_ref.calls == calls + 2 + 2 + 2


def test_plain_versions_are_counted_and_launch_nothing():
    a, b, _ = _operands("nn", 3, 4, 5, dtype=torch.float32)
    before = kernel_calls()
    gm.mm_tf32x3(a, b)
    after = kernel_calls()
    assert after["plain_calls"] == before["plain_calls"] + 1
    assert after["launches"] == before["launches"]
    assert not any(k.startswith("gemm_tf32x3") for k in after["launches"])


def test_form_read_from_the_strides():
    """nn, nt and tn from the layouts without a copy; tt copies b to
    row-major (tn); any other strides are copied to row-major."""
    for layout, want in (("nn", "nn"), ("nt", "nt"), ("tn", "tn"), ("tt", "tn")):
        a, b, _ = _operands(layout, 6, 5, 7, dtype=torch.float32)
        form, a2, b2 = gm.operands(a, b)
        assert form == want, layout
        assert a2.data_ptr() == a.data_ptr()
        assert (b2.data_ptr() == b.data_ptr()) == (layout != "tt")
        assert b2.stride(0 if want[1] == "t" else 1) == 1
    strided = torch.zeros(6, 14)[:, ::2]
    form, a2, _ = gm.operands(strided, torch.zeros(7, 5))
    assert (form, a2.is_contiguous()) == ("nn", True)


def test_operands_padded_for_the_tma_loads():
    """A leading dimension that is not a multiple of 4 (or unaligned data)
    is copied into a padded buffer in the same layout; an aligned one is
    kept as it is."""
    for row in (True, False):
        t = torch.randn(7, 5) if row else torch.randn(5, 7).t()
        got, ld = gm._tma_ready(t, row)
        assert ld % 4 == 0 and got.data_ptr() % 16 == 0 and torch.equal(got, t)
        assert (got.stride(1) if row else got.stride(0)) == 1
        _, ld = gm._tma_ready(torch.randn(7, 8) if row else torch.randn(8, 7).t(), row)
        assert ld == 8


@pytest.mark.parametrize("M,N,K,sms,want", [
    (160_000, 512, 512, 132, (1, 512)),     # the forward and input gradients: no split
    (512, 512, 160_000, 132, (8, 20_096)),  # the weight gradients: 16 tiles x 8
    (512, 512, 100, 132, (1, 128)),         # too short to split
    (130, 200, 40_000, 132, (32, 1280)),    # 4 tiles x 32, a ragged last chunk
])
def test_plan_splits_k_to_fill_the_sms(M, N, K, sms, want):
    splits, chunk = gm.plan(M, N, K, sms)
    assert (splits, chunk) == want
    assert chunk % gm.K_STEP == 0 and (splits - 1) * chunk < K <= splits * chunk


def test_routing_by_what_the_projection_sees():
    """Train mode, CUDA, float32 and both widths multiples of the tile: the
    blocks' projections; eval, the CPU, float64, fc_p (63 in), fc_out (1
    out) and the γ/β projections (latent in) keep F.linear."""
    cuda_x = mock.Mock(is_cuda=True, dtype=torch.float32)
    w = torch.zeros(512, 512)
    assert tdecoder.routed(True, cuda_x, w)
    assert tdecoder.routed(True, cuda_x, torch.zeros(256, 128))
    assert not tdecoder.routed(False, cuda_x, w)
    assert not tdecoder.routed(True, torch.zeros(2, 512), w)
    assert not tdecoder.routed(True, mock.Mock(is_cuda=True, dtype=torch.float64), w)
    for shape in ((512, 63), (1, 512), (512, 32)):
        assert not tdecoder.routed(True, cuda_x, torch.zeros(shape)), shape


def test_decoder_on_the_cpu_calls_no_plain_version():
    dec = tdecoder.CbnDecoder(8, 128, 1).random_init_(torch.Generator().manual_seed(0)).train()
    calls = gm.mm_ref.calls
    c = torch.randn(2, 5, 63, requires_grad=True)
    out = dec(c, torch.randn(2, 8))
    torch.autograd.grad(out.sum(), c)
    assert gm.mm_ref.calls == calls


def _ae_grads(ae, batch, routed: bool):
    """The AE step's loss and its gradients in float64, the decoder's square
    projections on mm_tf32x3's plain route or on F.linear."""
    saved = {k: v.clone() for k, v in ae.state_dict().items()}
    step = ae_trainer.make_ae_train_step(ae)
    route = (lambda training, x, w: training and w.shape[0] == w.shape[1]) if routed \
        else tdecoder.routed
    with mock.patch.object(tdecoder, "routed", route), \
            mock.patch.object(ae_trainer, "on_device",
                              lambda t, d, dtype=None: torch.as_tensor(np.asarray(t),
                                                                       dtype=torch.float64)):
        calls = gm.mm_ref.calls
        loss, _ = step.loss_fn(batch)
        grads = torch.autograd.grad(loss, list(ae.parameters()), allow_unused=True)
        ran = gm.mm_ref.calls - calls
    ae.load_state_dict(saved)
    return loss, grads, ran


def test_ae_loss_gradient_routed_against_composed():
    """The whole AE loss (BCE + the gradient term, its second-order part
    through every projection) and its gradient with respect to every
    parameter, the decoder's block projections on the Function and on
    F.linear, float64: six products each (forward, create-graph gradient,
    and the backward's four)."""
    cfg = ae_trainer.AETrainConfig(latent_size=8, hidden_dim=16, num_hidden_layers=2)
    ae = ae_trainer.init_ae(cfg, torch.Generator().manual_seed(0)).double()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # no zero kernels: every path carries gradient
        for p in ae.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g, dtype=p.dtype))
    rng = np.random.default_rng(0)
    batch = {"pcd": rng.uniform(-0.5, 0.5, (2, 64, 3)), "coords": rng.uniform(-1, 1, (2, 96, 3)),
             "udf": rng.uniform(0, 0.1, (2, 96)), "gradients": rng.normal(size=(2, 96, 3))}
    loss1, g1, ran1 = _ae_grads(ae, batch, routed=False)
    loss2, g2, ran2 = _ae_grads(ae, batch, routed=True)
    assert (ran1, ran2) == (0, 6 * 2 * 2)
    torch.testing.assert_close(loss2, loss1, rtol=1e-12, atol=0)
    for (name, _), u, v in zip(ae.named_parameters(), g2, g1):
        if v is None:
            assert u is None or not u.any(), name
            continue
        torch.testing.assert_close(u, v, rtol=1e-9, atol=1e-12, msg=name)
