"""The denoiser's call `fn(x, t)` replayed from a CUDA graph.

A sampler step calls the denoiser once, and the full-width MDM's forward is
about 585 kernel launches of a few microseconds of device work each: eager,
the host's launches take longer than the card's work. `GraphedCall` wraps
such a call. On CUDA, with grad off and the module in eval mode, its first
call runs `fn` eagerly on a side stream (that call's result, and the warm-up
that initialises cuDNN's plans and K2's library for the stream), then
captures `fn` on that stream into a CUDA graph with its own memory pool,
reading static copies of `x` and `t`. Every later call copies `x` and `t`
into those buffers, replays the graph on the current stream and returns a
clone of its output, so that a sampler may keep earlier outputs (PLMS keeps
its ε history and may return an x₀ prediction that is the output itself).

Eager, unchanged: CPU tensors, a call with grad on (training, a guidance
gradient), the module in train mode (its dropout draws from a generator),
and any call whose `x` or `t` differs in shape, dtype or device from the
captured one, or that runs in another inference mode; such a call does not
capture again. Work outside the call (the sampler's noise draws, its
arithmetic) stays eager: nothing of it is in the graph.

The graph and its pool live as long as the `GraphedCall`: a new closure is a
new graph, and dropping the closure frees both. The captured kernels read
what `fn` closes over (the job's labels or context) at its address, so those
must not be resized or replaced while the closure lives.

Counters: `GraphedCall.captures` and `.replays`, rows of `ops.kernel_calls()`.
The launch counters of the hand-written kernels count device launches: the
launches recorded while capturing are taken back out and added again on
each replay. The capture runs inside a `sample.capture` span.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .attention_kernel import qkv_attention, qkv_attention_bwd
from .decoder_kernel import folded_udf


def _counters() -> tuple:
    """The launch counters a captured call can move (per-shape dicts). The
    Laplacian's reads a flag back on the host, so it cannot be captured."""
    return folded_udf.launches, qkv_attention.launches, qkv_attention_bwd.launches


_side: dict = {}  # device -> the stream every capture on it runs on


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One stream per device for every capture: a library's per-stream state
    (cuBLAS's workspace) is made once, by the first warm-up, not per graph."""
    stream = _side.get(device)
    if stream is None:
        stream = _side[device] = torch.cuda.Stream(device)
    return stream


def _key(x: torch.Tensor, t: torch.Tensor) -> tuple:
    return (x.shape, x.dtype, x.device, t.shape, t.dtype, t.device,
            torch.is_inference_mode_enabled())


class GraphedCall:
    """`fn(x, t)` as a CUDA graph where it can be one (see the module's
    docstring); `fn` is the eager function, `module` the network it runs,
    whose `training` flag is read at each call."""

    captures = 0  # graphs captured in this process
    replays = 0  # graph replays in this process

    def __init__(self, fn, module: torch.nn.Module):
        self.fn = fn
        self.module = module
        self._graph = None

    def __call__(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda or torch.is_grad_enabled() or self.module.training:
            return self.fn(x, t)
        if self._graph is None:
            return self._capture(x, t)
        if _key(x, t) != self._captured:
            return self.fn(x, t)
        self._x.copy_(x)
        self._t.copy_(t)
        self._graph.replay()
        for counter, delta in self._launched:
            for k, n in delta.items():
                counter[k] = counter.get(k, 0) + n
        GraphedCall.replays += 1
        return self._out.clone()

    def _capture(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """This call's output, computed eagerly on a side stream; the graph
        captured after it on that stream."""
        with span("sample.capture"):
            current = torch.cuda.current_stream(x.device)
            static_x, static_t = x.clone(), t.clone()
            side = _side_stream(x.device)
            side.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                out = self.fn(static_x, static_t)
                before = [dict(c) for c in _counters()]
                # thread_local: another thread's CUDA calls (the batch
                # generator's pool threads extract while their caller may
                # sample) do not break this capture
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static_out = self.fn(static_x, static_t)
                finally:
                    graph.capture_end()
                launched = []
                for counter, was in zip(_counters(), before):
                    delta = {k: n - was.get(k, 0) for k, n in counter.items()
                             if n != was.get(k, 0)}
                    counter.clear()
                    counter.update(was)  # recorded, not launched
                    if delta:
                        launched.append((counter, delta))
            current.wait_stream(side)
            out.record_stream(current)
        self._x, self._t, self._out = static_x, static_t, static_out
        self._launched = launched
        self._captured = _key(x, t)
        self._graph = graph
        GraphedCall.captures += 1
        return out
