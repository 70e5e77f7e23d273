"""The denoiser's graphed call (`ops.cuda_graph.GraphedCall`, which
`models.make_cfg_model_fn` returns) where it stays eager: on the CPU and
under grad its output is the eager function's bit for bit, no graph is
captured, and the three samplers give the eager function's latents.
`tests/test_torch_graph_cuda.py` holds the replayed graph to the eager
call on the card."""

import pytest
import torch

from surfd_tpu_torch.diffusion import named_schedule
from surfd_tpu_torch.models import MDM, make_cfg_model_fn
from surfd_tpu_torch.ops import GraphedCall, kernel_calls
from surfd_tpu_torch.pipelines import sample_latents

L = 8  # latent length


def _mdm(cond_mode: str) -> MDM:
    mdm = MDM(cond_mode=cond_mode, num_actions=3, clip_dim=16, model_channels=32,
              channel_mult=(1, 2), num_heads=2)
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    return mdm.eval()


def _cond(cond_mode: str, B: int) -> dict:
    g = torch.Generator().manual_seed(1)
    if cond_mode == "category":
        return {"action": torch.tensor([2, 0, 1][:B])}
    if cond_mode == "text":
        return {"context": torch.randn((B, 16), generator=g)}
    return {}


def _inputs(B: int):
    g = torch.Generator().manual_seed(2)
    return torch.randn((B, L, 1), generator=g), torch.tensor([3, 700, 41][:B])


def _explicit(mdm, guidance, x, t, cond):
    """The guided call written out: one pass of 2B, the second half under the
    null class or a zero context."""
    if guidance == 1.0 or mdm.cond_mode == "no_cond":
        return mdm(x, t, **cond)
    if mdm.cond_mode == "category":
        a = cond["action"]
        out = mdm(torch.cat([x, x]), torch.cat([t, t]),
                  action=torch.cat([a, torch.full_like(a, mdm.null_action)]))
    else:
        c = cond["context"]
        out = mdm(torch.cat([x, x]), torch.cat([t, t]),
                  context=torch.cat([c, torch.zeros_like(c)]))
    out_cond, out_uncond = out.chunk(2)
    return out_uncond + guidance * (out_cond - out_uncond)


@pytest.mark.parametrize("cond_mode,guidance", [
    ("no_cond", 1.0), ("category", 1.0), ("category", 2.5), ("text", 1.0), ("text", 2.5)])
def test_cpu_call_is_the_eager_function(cond_mode, guidance):
    mdm, (x, t) = _mdm(cond_mode), _inputs(2)
    cond = _cond(cond_mode, 2)
    fn = make_cfg_model_fn(mdm, guidance, **cond)
    assert isinstance(fn, GraphedCall) and fn.module is mdm
    captures = GraphedCall.captures
    with torch.no_grad():
        got, eager, want = fn(x, t), fn.fn(x, t), _explicit(mdm, guidance, x, t, cond)
    assert torch.equal(got, eager) and torch.equal(got, want)
    assert GraphedCall.captures == captures


@pytest.mark.parametrize("cond_mode", ["category", "text"])
def test_call_under_grad_is_eager(cond_mode):
    """Under grad (training, a guidance gradient) the call records autograd
    and its gradient is the eager function's."""
    mdm, (x, t) = _mdm(cond_mode), _inputs(2)
    fn = make_cfg_model_fn(mdm, 2.5, **_cond(cond_mode, 2))
    grads = []
    for f in (fn, fn.fn):
        xi = x.clone().requires_grad_(True)
        out = f(xi, t)
        assert out.grad_fn is not None
        grads.append((out, torch.autograd.grad(out.square().sum(), xi)[0]))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "plms"])
def test_samplers_through_the_call_match_eager(sampler):
    """Each loop (PLMS keeps its ε history) gives the eager function's
    latents bit for bit, from the same generator."""
    mdm = _mdm("category")
    sched = named_schedule("cosine", 6)
    fn = make_cfg_model_fn(mdm, 2.5, **_cond("category", 2))
    got, want = (sample_latents(sched, f, 2, L, torch.Generator().manual_seed(5), sampler=sampler,
                                device="cpu") for f in (fn, fn.fn))
    assert got.shape == (2, L) and torch.equal(got, want)


def test_kernel_calls_rows_for_graphs(monkeypatch):
    """Captures and replays are rows of the launches once a graph exists."""
    monkeypatch.setattr(GraphedCall, "captures", 0)
    monkeypatch.setattr(GraphedCall, "replays", 0)
    rows = kernel_calls()["launches"]
    assert "cuda_graph_capture" not in rows and "cuda_graph_replay" not in rows
    monkeypatch.setattr(GraphedCall, "captures", 2)
    monkeypatch.setattr(GraphedCall, "replays", 97)
    rows = kernel_calls()["launches"]
    assert rows["cuda_graph_capture"] == 2 and rows["cuda_graph_replay"] == 97
