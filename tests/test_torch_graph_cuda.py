"""The denoiser's call replayed from a CUDA graph (`ops.cuda_graph.GraphedCall`,
which `models.make_cfg_model_fn` returns) against the eager call, on the card:
the full-width MDMs' latents bit for bit through DDPM, DDIM and PLMS (category
at guidance 1 and 2.5, latent 32; text under CFG at latent 64), K2's launch
counter equal to the eager run's, a graph per closure, memory flat over 20
closures, and the eager fallbacks (grad on, train mode, another shape).

Every test here needs a CUDA card and skips without one. The file imports
only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_cuda.py
"""

import functools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from surfd_tpu_torch.diffusion import named_beta_schedule, space_timesteps, spaced_schedule
from surfd_tpu_torch.models import MDM, make_cfg_model_fn
from surfd_tpu_torch.ops import GraphedCall
from surfd_tpu_torch.ops import attention_kernel as ak
from surfd_tpu_torch.pipelines import sample_latents
from surfd_tpu_torch.utils import profiling

STEPS = 20  # cosine 1000 respaced
SAMPLERS = ("ddpm", "ddim", "plms")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU form")
    from surfd_tpu_torch.utils import use_full_f32

    use_full_f32()
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _mdm(cond_mode: str) -> MDM:
    """The full-width MDM (224 channels) with seeded random weights, on the
    card, in eval mode."""
    mdm = MDM(cond_mode=cond_mode, num_actions=9, clip_dim=512)
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    return mdm.to("cuda").eval()


@functools.lru_cache(maxsize=None)
def _sched():
    return spaced_schedule(named_beta_schedule("cosine", 1000),
                           space_timesteps(1000, f"ddim{STEPS}"))


def _k2() -> int:
    return sum(ak.qkv_attention.launches.values())


def _sample(fn, sampler: str, B: int, L: int, seed: int = 7) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    lat = sample_latents(_sched(), fn, B, L, g, sampler=sampler, device="cuda")
    torch.cuda.synchronize()
    return lat


def _graphed_equals_eager(fn, sampler: str, B: int, L: int, record_property) -> None:
    """The graphed sampling against the eager one from the same generator:
    bit-equal latents, one capture, a replay a later call, and K2's counter
    moved as much by the replays as by the eager calls."""
    calls = STEPS + (sampler == "plms")  # PLMS's first step calls twice
    c0, r0, k0 = GraphedCall.captures, GraphedCall.replays, _k2()
    got = _sample(fn, sampler, B, L)
    k_graph = _k2() - k0
    assert (GraphedCall.captures - c0, GraphedCall.replays - r0) == (1, calls - 1)
    k1 = _k2()
    want = _sample(fn.fn, sampler, B, L)
    assert _k2() - k1 == k_graph > 0
    gap = float((got - want).abs().max())
    record_property("graphed_vs_eager_max_abs", gap)
    assert torch.equal(got, want), f"graphed vs eager max abs {gap!r}"


@pytest.mark.cuda
@pytest.mark.parametrize("guidance", [1.0, 2.5])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_graphed_category_latents_equal_eager(cuda, sampler, guidance, record_property):
    """The category MDM at latent 32, B 2 (the CFG pass at B 4)."""
    fn = make_cfg_model_fn(_mdm("category"), guidance,
                           action=torch.tensor([3, 8], device=cuda))
    _graphed_equals_eager(fn, sampler, 2, 32, record_property)


@pytest.mark.cuda
@pytest.mark.parametrize("samples", [2, 4])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_graphed_text_cfg_latent64_equals_eager(cuda, sampler, samples, record_property):
    """The text MDM at latent 64 under CFG 2.5 (the pass at 2 × samples)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    ctx = 0.4 * torch.randn((samples, 512), generator=g, device=cuda)
    fn = make_cfg_model_fn(_mdm("text"), 2.5, context=ctx)
    _graphed_equals_eager(fn, sampler, samples, 64, record_property)


def _inputs(B: int, L: int = 32, seed: int = 3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, L, 1), generator=g, device="cuda")
    return x, torch.randint(0, 1000, (B,), generator=g, device="cuda")


@pytest.mark.cuda
def test_second_closure_captures_anew(cuda):
    """Two closures, two graphs; their replays interleaved, each call equal
    to its own eager function's."""
    mdm, c0 = _mdm("category"), GraphedCall.captures
    fns = [make_cfg_model_fn(mdm, 2.5, action=torch.tensor(a, device=cuda))
           for a in ([0, 1], [5, 7])]
    with torch.no_grad():
        for k in range(3):
            for fn in fns:
                x, t = _inputs(2, seed=k)
                assert torch.equal(fn(x, t), fn.fn(x, t))
    assert GraphedCall.captures - c0 == 2


@pytest.mark.cuda
def test_closures_leave_memory_flat(cuda):
    """20 closures in a row, each captured and replayed: the memory in use
    after each is dropped is what it was after the first, and emptying the
    cache gives back every graph's pool."""
    mdm = _mdm("category")
    x, t = _inputs(2)

    def job(k: int) -> None:
        fn = make_cfg_model_fn(mdm, 2.5, action=torch.tensor([k % 9, 2], device=cuda))
        with torch.no_grad():
            for _ in range(3):
                fn(x, t)
        torch.cuda.synchronize()

    job(0)
    torch.cuda.empty_cache()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    c0 = GraphedCall.captures
    for k in range(1, 21):
        job(k)
        assert torch.cuda.memory_allocated() == allocated, k
    assert GraphedCall.captures - c0 == 20
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= reserved


@pytest.mark.cuda
def test_grad_and_train_mode_stay_eager(cuda):
    """Under grad the call records autograd; in train mode it runs eagerly;
    neither captures."""
    mdm, c0 = _mdm("category"), GraphedCall.captures
    fn = make_cfg_model_fn(mdm, 2.5, action=torch.tensor([1, 4], device=cuda))
    x, t = _inputs(2)
    xi = x.clone().requires_grad_(True)
    out = fn(xi, t)
    assert out.grad_fn is not None and torch.equal(out.detach(), fn.fn(x, t).detach())
    mdm.train()
    try:
        with torch.no_grad():
            assert torch.equal(fn(x, t), fn.fn(x, t))
    finally:
        mdm.eval()
    assert GraphedCall.captures == c0


@pytest.mark.cuda
def test_other_shape_runs_eager(cuda):
    """After a capture at latent 32, a call at latent 16 runs eagerly and
    captures nothing; the captured shape still replays."""
    fn = make_cfg_model_fn(_mdm("category"), 1.0, action=torch.tensor([1, 4], device=cuda))
    with torch.no_grad():
        fn(*_inputs(2))
        c0, r0 = GraphedCall.captures, GraphedCall.replays
        xs, ts = _inputs(2, L=16)
        assert torch.equal(fn(xs, ts), fn.fn(xs, ts))
        assert (GraphedCall.captures, GraphedCall.replays) == (c0, r0)
        x, t = _inputs(2, seed=9)
        assert torch.equal(fn(x, t), fn.fn(x, t))
        assert GraphedCall.replays == r0 + 1


@pytest.mark.cuda
def test_capture_span_under_the_profiler(cuda):
    """Under torch.profiler the capture is a `sample.capture` span with a
    device duration, and the replays still give the eager outputs."""
    fn = make_cfg_model_fn(_mdm("category"), 2.5, action=torch.tensor([2, 6], device=cuda))
    x, t = _inputs(2)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]), torch.no_grad():
        first, again = fn(x, t), fn(x, t)
        torch.cuda.synchronize()
    captured = [s for s in profiling.spans() if s["name"] == "sample.capture"]
    profiling.clear()
    assert len(captured) == 1 and captured[0]["device_ms"] is not None
    with torch.no_grad():
        want = fn.fn(x, t)
    assert torch.equal(first, want) and torch.equal(again, want)
