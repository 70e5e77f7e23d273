"""Training-loop utilities (counterpart of surfd_tpu/training/common.py): the
train state, AdamW with the reference's staircase anneal, EMA, norms, the
non-finite skip, preemption and the stall watchdog.

PyTorch updates in place, so where the JAX package returns a new state
(`select_update_if_finite`), `apply_update_if_finite` decides before the
update: when the loss or the gradient norm is not finite it applies nothing
(params, optimizer state and its count, EMA stay), and only the step
counter advances. The decision reads two device scalars: one host sync a step.
A train-mode forward has already moved the BatchNorm running statistics by
then, so a step with BatchNorm takes `snapshot_buffers` before its forward
and hands it over, and a skip puts them back, as JAX carries its old
`batch_stats` forward.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..utils.profiling import span


@dataclasses.dataclass
class TrainState:
    """step: steps taken (skipped ones included); count: updates applied
    (optax's `count`, which the anneal reads); ema_rate: the EMA's decay,
    0 for none; ema: one tensor per `model.parameters()` entry, or None
    without EMA. `create_train_state` keeps the two consistent."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    count: int = 0
    ema_rate: float = 0.0
    ema: Optional[list] = None

    def ema_state_dict(self) -> Optional[dict]:
        """The model's state dict with the EMA in place of each parameter."""
        if self.ema is None:
            return None
        sd = self.model.state_dict()
        for (name, _), e in zip(self.model.named_parameters(), self.ema):
            sd[name] = e
        return sd


def staircase_lr(group: dict, count: int) -> float:
    """lr · decay_rate^⌊count / decay_every⌋, floored at lr_floor (optax
    `exponential_decay(staircase=True, end_value=lr_floor)`)."""
    lr = group["base_lr"] * group["decay_rate"] ** (count // group["decay_every"])
    return max(lr, group["lr_floor"])


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.0, decay_rate: float = 0.9,
                   decay_every: int = 1000, lr_floor: float = 1e-7) -> torch.optim.AdamW:
    """AdamW (β 0.9 / 0.999, ε 1e-8, decoupled weight decay) whose groups
    carry the reference's staircase anneal, lr ← lr·0.9 every 1000 applied
    updates floored at 1e-7: `apply_update_if_finite` sets each group's lr
    from `staircase_lr` before each update."""
    return torch.optim.AdamW(
        [{"params": list(params), "base_lr": lr, "decay_rate": decay_rate,
          "decay_every": decay_every, "lr_floor": lr_floor}],
        lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
    )


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       ema_rate: float = 0.0) -> TrainState:
    """A state at step 0; an EMA of the params, starting at them, iff
    `ema_rate` > 0: one setting, so that whether an EMA is kept and its
    rate cannot disagree."""
    if not 0.0 <= ema_rate < 1.0:
        raise ValueError(f"ema_rate {ema_rate} outside [0, 1)")
    ema = [p.detach().clone() for p in model.parameters()] if ema_rate > 0 else None
    return TrainState(model, optimizer, ema_rate=ema_rate, ema=ema)


@torch.no_grad()
def ema_update(ema: list, params, rate: float) -> None:
    """ema ← ema · rate + params · (1 − rate), in place."""
    params = [p.detach() for p in params]
    torch._foreach_mul_(ema, rate)
    torch._foreach_add_(ema, params, alpha=1.0 - rate)


def on_device(x, device, dtype=None) -> torch.Tensor:
    """A tensor on `device`; arrays are copied (they may be read-only views)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


@torch.no_grad()
def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ‖x‖²) over tensors, a 0-d f32 tensor on their device."""
    tensors = [t.detach() for t in tensors]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@torch.no_grad()
def snapshot_buffers(model: nn.Module) -> list:
    """(buffer, copy) pairs of the model's floating-point buffers (the
    BatchNorm running statistics), taken before a forward moves them."""
    return [(b, b.clone()) for b in model.buffers() if b.is_floating_point()]


@torch.no_grad()
def apply_update_if_finite(state: TrainState, loss: torch.Tensor,
                           buffers: Optional[list] = None) -> tuple[bool, torch.Tensor]:
    """After `loss.backward()`: when the loss and the gradients' global norm
    are finite, one AdamW update at the annealed lr and the EMA at the
    state's rate; else nothing, and each of `buffers` (`snapshot_buffers`
    from before the forward) back to its copy. The step counter advances
    either way and the gradients are cleared. Returns (applied, gradient
    norm). A `train.update` span."""
    with span("train.update"):
        params = [p for p in state.model.parameters() if p.grad is not None]
        gnorm = global_norm([p.grad for p in params])
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))  # the step's one host sync
        if ok:
            for group in state.optimizer.param_groups:
                group["lr"] = staircase_lr(group, state.count)
            state.optimizer.step()
            state.count += 1
            if state.ema is not None:
                ema_update(state.ema, state.model.parameters(), state.ema_rate)
        else:
            for live, saved in buffers or ():
                live.copy_(saved)
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
    return ok, gnorm


class GracefulShutdown:
    """SIGTERM / SIGINT set `requested`; loops poll it once per step, then
    checkpoint and leave resumably. Restores the previous handlers on exit.
    Use as a context manager."""

    def __init__(self, signals=None):
        self.signals = signals or (signal.SIGTERM, signal.SIGINT)
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


class StallWatchdog:
    """Exit the process with code 42 when a loop stops completing steps.

    A wedged device call raises nothing and cannot be interrupted, so the
    only recovery is to leave with a distinctive code and let a restart loop
    resume (the CLIs' `--resume`). Loops call `tick()` once per completed
    step. Before the first tick the loop gets `first_grace_s` (start-up and
    kernel builds); after it, `timeout_s` of silence ends the process from
    a daemon thread. `timeout_s=0` disables. Use as a context manager.
    """

    EXIT_CODE = 42

    def __init__(self, timeout_s: float = 480.0, first_grace_s: float = 3600.0):
        self.timeout_s = float(timeout_s)
        self.first_grace_s = float(first_grace_s)
        self._last = None  # monotonic time of the last tick; None before the first
        self._t0 = None
        self._stop = threading.Event()

    def tick(self):
        self._last = time.monotonic()

    def _watch(self):
        while not self._stop.wait(min(30.0, self.timeout_s / 4)):
            now = time.monotonic()
            if self._last is None:
                if now - self._t0 > self.first_grace_s:
                    self._bark(now - self._t0, "no first step")
            elif now - self._last > self.timeout_s:
                self._bark(now - self._last, "no step completed")

    def _bark(self, silent_s: float, why: str):
        print(f"StallWatchdog: {why} in {silent_s:.0f}s; the device is presumed wedged, "
              f"exiting {self.EXIT_CODE} for the restart loop", file=sys.stderr, flush=True)
        os._exit(self.EXIT_CODE)

    def __enter__(self):
        self._t0 = time.monotonic()
        if self.timeout_s > 0:
            threading.Thread(target=self._watch, daemon=True, name="stall-watchdog").start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        return False
