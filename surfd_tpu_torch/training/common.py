"""Training-loop utilities (counterpart of surfd_tpu/training/common.py): the
train state, AdamW with the reference's staircase anneal, EMA, norms, the
non-finite skip, preemption and the stall watchdog.

PyTorch updates in place, so where the JAX package returns a new state
(`select_update_if_finite`), `apply_update_if_finite` gates the update on
the device: when the loss or the gradient norm is not finite it applies
nothing (params, AdamW's moments and per-param steps, the count of applied
updates, the EMA stay), and only the step counter advances. The decision
stays a device bool that the host never reads, so a step holds no host sync
and the host can enqueue the next step while the card runs this one. A
train-mode forward has already moved the BatchNorm running statistics by
then, so a step with BatchNorm takes `snapshot_buffers` before its forward
and hands it over, and a skip selects them back, as JAX carries its old
`batch_stats` forward.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import signal
import sys
import threading
import time
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..utils.profiling import span


@dataclasses.dataclass
class TrainState:
    """step: steps taken (skipped ones included), a host int; count:
    updates applied (optax's `count`, which the anneal reads), a 0-d int64
    tensor on the model's device that the update advances there (an int is
    taken too, as a restored checkpoint sets it); ema_rate: the EMA's decay,
    0 for none; ema: one tensor per `model.parameters()` entry, or None
    without EMA. `create_train_state` keeps the two consistent."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    count: Union[int, torch.Tensor] = 0
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
    updates floored at 1e-7: `apply_update_if_finite` sets each group's lr,
    a 0-d f32 tensor, from `staircase_lr` of the device count before each
    update. It runs the fused kernel, which reads the lr from the device and
    skips a step on a device flag (`found_inf`, as `torch.amp.GradScaler`
    hands it)."""
    return torch.optim.AdamW(
        [{"params": list(params), "base_lr": lr, "decay_rate": decay_rate,
          "decay_every": decay_every, "lr_floor": lr_floor}],
        lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay, fused=True,
    )


@functools.lru_cache(maxsize=None)
def _lr_stages(base_lr: float, decay_rate: float, decay_every: int, lr_floor: float,
               device: torch.device) -> torch.Tensor:
    """`staircase_lr` at each stage ⌊count / decay_every⌋ until it stops
    changing (the floor), as f32 on `device`: the anneal as a table that a
    device count indexes. Built once per setting and device; a decay that
    never reaches a floor stops at 4096 stages."""
    group = {"base_lr": base_lr, "decay_rate": decay_rate, "decay_every": decay_every,
             "lr_floor": lr_floor}
    lrs = [staircase_lr(group, 0)]
    while len(lrs) < 4096:
        nxt = staircase_lr(group, len(lrs) * decay_every)
        if nxt == lrs[-1]:
            break
        lrs.append(nxt)
    return torch.tensor(lrs, dtype=torch.float32).to(device)


def annealed_lr(group: dict, count: torch.Tensor) -> torch.Tensor:
    """The group's staircase lr at a device count, a 0-d f32 tensor on the
    count's device: `staircase_lr(group, count)` rounded to f32, with no
    host read."""
    table = _lr_stages(group["base_lr"], group["decay_rate"], group["decay_every"],
                       group["lr_floor"], count.device)
    stage = torch.div(count, group["decay_every"], rounding_mode="floor")
    return torch.take(table, stage.clamp_(max=len(table) - 1))


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       ema_rate: float = 0.0) -> TrainState:
    """A state at step 0, its count on the model's device; an EMA of the
    params, starting at them, iff `ema_rate` > 0: one setting, so that
    whether an EMA is kept and its rate cannot disagree."""
    if not 0.0 <= ema_rate < 1.0:
        raise ValueError(f"ema_rate {ema_rate} outside [0, 1)")
    ema = [p.detach().clone() for p in model.parameters()] if ema_rate > 0 else None
    count = torch.zeros((), dtype=torch.int64, device=next(model.parameters()).device)
    return TrainState(model, optimizer, count=count, ema_rate=ema_rate, ema=ema)


@torch.no_grad()
def ema_update(ema: list, params, rate) -> None:
    """ema ← ema · rate + params · (1 − rate), in place; `rate` a float or
    a 0-d tensor on the EMA's device (1 leaves the EMA as it is)."""
    params = [p.detach() for p in params]
    torch._foreach_mul_(ema, rate)
    torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - rate))


def on_device(x, device, dtype=None) -> torch.Tensor:
    """A tensor on `device`; host arrays are copied (they may be read-only
    views). To CUDA, host data goes up from pinned memory with non_blocking:
    a copy from pageable memory waits for every kernel queued before it, so
    the host could not stay ahead of the card. The caching host allocator
    keeps the pinned buffer until its copy is done."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        if device.type == "cuda" and x.device.type == "cpu":
            return x.contiguous().pin_memory().to(device, dtype, non_blocking=True)
        return x.to(device=device, dtype=dtype)
    if device.type != "cuda":
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)
    a = np.asarray(x)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")
    return torch.from_numpy(a).pin_memory().to(device, dtype, non_blocking=True)


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
                           buffers: Optional[list] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """After `loss.backward()`: when the loss and the gradients' global norm
    are finite, one AdamW update at the annealed lr and the EMA at the
    state's rate; else nothing, and each of `buffers` (`snapshot_buffers`
    from before the forward) back to its copy. All of it is decided on the
    device, with no host read: the fused AdamW kernel skips on its
    `found_inf` flag (and steps its per-param counts back), the count
    advances by the flag, the EMA's rate becomes 1 and the buffers are
    selected back. The step counter advances either way and the gradients
    are cleared. Returns (applied, a 0-d device bool; gradient norm). A
    `train.update` span."""
    with span("train.update"):
        params = [p for p in state.model.parameters() if p.grad is not None]
        gnorm = global_norm([p.grad for p in params])
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        if not isinstance(state.count, torch.Tensor) or state.count.device != gnorm.device:
            # an int (a restored checkpoint) or another device: read once
            state.count = torch.full((), int(state.count), dtype=torch.int64, device=gnorm.device)
        for group in state.optimizer.param_groups:
            group["lr"] = annealed_lr(group, state.count)
        state.optimizer.found_inf = torch.logical_not(ok).float()
        try:
            state.optimizer.step()
        finally:
            del state.optimizer.found_inf
        state.count = state.count + ok
        if state.ema is not None:
            ema_update(state.ema, state.model.parameters(), torch.where(ok, state.ema_rate, 1.0))
        for live, saved in buffers or ():
            torch.where(ok, live, saved, out=live)
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
    return ok, gnorm


def skipped_flag(ok) -> torch.Tensor:
    """The `nonfinite_skipped` metric of `apply_update_if_finite`'s `ok` (a
    device bool, or a Python bool): 1.0 for a skipped update, else 0.0, a
    0-d f32 tensor on ok's device."""
    return torch.logical_not(torch.as_tensor(ok)).float()


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
