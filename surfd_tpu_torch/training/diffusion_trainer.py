"""Latent-diffusion training step and loop (counterpart of
surfd_tpu/training/diffusion_trainer.py:33-342).

A step: the frozen encoder's latents (or precomputed ones) → conditioning
dropout → q_sample → denoise → the START_X L1 loss × importance weights →
backward (K2-bwd in every attention block on the card) → AdamW at the
annealed lr, EMA, unless the loss or the gradient norm is not finite.
`train_step` takes optional injected `noise` (B, L, 1) and `cond_drop` (B,)
so that a test can replay another implementation's draws; otherwise both
come from the caller's `torch.Generator`, as do the dropout masks.

The loop is a Python loop over the step. `run` and `run_chunked` differ
only in their draws: `run_chunked` keeps the JAX package's chunked draws
(epoch permutations of a bank of latents, K steps' rows and timesteps at
once, a chunk ending at each log and save step) and feeds them to the same
loop one step at a time.

Data parallel (`mesh`, a DeviceMesh from `parallel.make_mesh`): one process
a card, the model wrapped in DDP over the mesh's 'data' group. Every rank
draws the global batch, its t and weights, the training noise and the
conditioning-dropout mask from identically seeded generators, then takes
its equal shard, as the JAX package's `shard_batch` splits one global
batch; so R ranks × B / R take the steps one process takes at B (up to the
order of the gradient sums). The res-block dropout masks are per rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import sys

import numpy as np
import torch

from ..diffusion import LossType, MeanType, Schedule, VarType, training_losses
from ..diffusion.resample import create_named_schedule_sampler
from ..models.mdm import MDM
from ..models.unet1d import SeededDropout
from ..parallel.mesh import all_gather_rows, data_axis
from ..parallel.multihost import is_main_process
from .common import (
    GracefulShutdown,
    StallWatchdog,
    TrainState,
    apply_update_if_finite,
    global_norm,
    on_device,
    skipped_flag,
)


@dataclass
class DiffusionTrainConfig:
    """The loop's settings. The model's (latent size, conditioning, dropout)
    are MDM's, the optimizer's (lr, weight decay) make_optimizer's and the
    EMA's rate the train state's: each is set in one place."""

    batch_size: int = 2  # the reference's train_diffcloth.py:143; run_chunked's rows
    num_steps: int = 600_000
    log_interval: int = 100
    save_interval: int = 50_000
    l1_weight: float = 1000.0
    schedule_sampler: str = "uniform"
    # with probability p per example, context → zeros and action →
    # null_action, so that the unconditional branch of CFG is trained
    cond_mask_prob: float = 0.0
    # exit 42 when no step completes for this long (StallWatchdog); 0 disables
    stall_exit_s: float = 480.0


def batch_to_device(batch: dict, device) -> dict:
    """A batch's arrays as tensors on `device`: latents, pcd and context
    f32, action int64."""
    out = {}
    for k, v in batch.items():
        if k in ("latents", "pcd", "context"):
            out[k] = on_device(v, device, torch.float32)
        elif k == "action":
            out[k] = on_device(v, device, torch.int64)
    return out


def make_train_step(
    mdm: MDM,
    sched: Schedule,
    encoder: Optional[Callable] = None,
    l1_weight: float = 1000.0,
    cond_mask_prob: float = 0.0,
    mesh=None,
):
    """The train step `train_step(state, batch, t, weights, *, noise=None,
    cond_drop=None, generator=None) -> metrics`, updating `state` in place
    (the EMA at `state.ema_rate`).

    With `mesh`, the module runs under DDP over the 'data' group; the step
    takes the global batch, t, weights (and injected noise and mask), draws
    what is not injected for the global batch, and computes this rank's
    shard. Its metrics are the global batch's: per-example terms gathered,
    the loss their weighted mean, the gradient norm of the averaged
    gradients; so every rank decides the non-finite skip alike.

    batch: 'latents' (B, L), or 'pcd' (B, N, 3) through the frozen `encoder`;
    optional 'context' (B, 512) or 'action' (B,). t: (B,) steps from the
    schedule sampler; weights: (B,) importance weights. Arrays may be numpy.
    Metrics, device tensors that the step never reads: loss, latent_l1,
    per_example_loss (B,), grad_norm, param_norm, nonfinite_skipped (1.0 on
    a skipped step).
    `train_step.loss_fn(batch, t, weights, ...)` is the step's loss alone,
    (loss, terms), for tests.
    """
    device = next(mdm.parameters()).device
    dropouts = [m for m in mdm.modules() if isinstance(m, SeededDropout)]
    model, rank, n = mdm, 0, 1
    if mesh is not None:
        from torch.nn.parallel import DistributedDataParallel

        group, rank, n = data_axis(mesh)
        # broadcasts rank 0's parameters at construction
        model = DistributedDataParallel(
            mdm, device_ids=[device.index] if device.type == "cuda" else None,
            process_group=group, broadcast_buffers=False)

    def loss_fn(batch, t, weights, *, noise=None, cond_drop=None, generator=None):
        """This rank's loss on its shard of the global inputs, and its terms."""
        batch = batch_to_device(batch, device)
        t = on_device(t, device, torch.int64)
        weights = on_device(weights, device, torch.float32)
        B = len(t)
        if B % n:
            raise ValueError(f"batch of {B} does not split over {n} data ranks")
        sl = slice(rank * B // n, (rank + 1) * B // n)
        if "latents" in batch:
            latents = batch["latents"][sl]
        else:
            with torch.no_grad():
                latents = encoder(batch["pcd"][sl])
        x0 = latents[..., None]  # (B / n, L, 1)
        context, action = batch.get("context"), batch.get("action")
        context = None if context is None else context[sl]
        action = None if action is None else action[sl]
        if cond_mask_prob > 0.0:
            if cond_drop is None:
                cond_drop = torch.rand(B, generator=generator, device=device) < cond_mask_prob
            cond_drop = on_device(cond_drop, device, torch.bool)[sl]
            if context is not None:
                context = torch.where(cond_drop[:, None], 0.0, context)
            if action is not None:
                action = torch.where(cond_drop, mdm.null_action, action)
        if noise is None:  # the draw training_losses makes, for the global batch
            noise = torch.randn((B,) + tuple(x0.shape[1:]), generator=generator, device=device)
        noise = on_device(noise, device, torch.float32)[sl]
        mdm.train(mdm.dropout > 0.0)
        for m in dropouts:
            m.generator = generator
        terms = training_losses(
            sched, lambda x, tt: model(x, tt, context=context, action=action), x0, t[sl],
            noise=noise, generator=generator, mean_type=MeanType.START_X,
            var_type=VarType.FIXED_SMALL, loss_type=LossType.MSE, l1_weight=l1_weight,
        )
        return (terms["loss"] * weights[sl]).mean(), terms

    def train_step(state: TrainState, batch, t, weights, *, noise=None, cond_drop=None,
                   generator=None) -> dict:
        loss, terms = loss_fn(batch, t, weights, noise=noise, cond_drop=cond_drop,
                              generator=generator)
        loss.backward()  # under DDP: the gradients averaged over 'data'
        per_ex, l1 = terms["loss"].detach(), terms["latent_l1"].detach()
        if mesh is not None:
            both = all_gather_rows(mesh, torch.stack([per_ex, l1], dim=1))
            per_ex, l1 = both[:, 0], both[:, 1]
            loss = (per_ex * on_device(weights, device, torch.float32)).mean()
        ok, gnorm = apply_update_if_finite(state, loss)
        return {
            "loss": loss.detach(),
            "latent_l1": l1.mean(),
            "per_example_loss": per_ex,
            "grad_norm": gnorm,
            "param_norm": global_norm(state.model.parameters()),
            "nonfinite_skipped": skipped_flag(ok),
        }

    train_step.loss_fn = loss_fn
    return train_step


def _scalars(metrics: dict) -> dict:
    """The scalar metrics as floats: one device-to-host copy."""
    keys = [k for k, v in metrics.items() if not isinstance(v, torch.Tensor) or v.dim() == 0]
    vals = [torch.as_tensor(metrics[k], dtype=torch.float32).reshape(()) for k in keys]
    vals = torch.stack([v.to(vals[0].device) for v in vals]).cpu().tolist() if vals else []
    return dict(zip(keys, vals))


class DiffusionTrainer:
    """The host loop around `make_train_step`: batches from `data_iter`,
    timesteps from the schedule sampler on a numpy `default_rng(0)`, the
    sampler's loss feedback (finite losses only), the log and save cadence,
    preemption (SIGTERM/SIGINT: checkpoint and return) and the watchdog.
    `generator`: the step's torch.Generator on the model's device.

    `mesh`: train data parallel over its 'data' axis (`make_train_step`);
    every rank runs the loop on the same seeded draws and the same
    `data_iter` contents. The schedule sampler sees the global batch's
    losses on every rank. Only the main process logs and writes
    checkpoints; a resume restores the same state on every rank."""

    def __init__(self, cfg: DiffusionTrainConfig, mdm: MDM, sched: Schedule, state: TrainState,
                 data_iter, encoder=None, schedule_sampler=None, checkpointer=None, logger=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        self.cfg = cfg
        self.mdm = mdm
        self.sched = sched
        self.state = state
        self.data_iter = data_iter
        self.schedule_sampler = schedule_sampler or create_named_schedule_sampler(
            cfg.schedule_sampler, sched.num_timesteps)
        main = is_main_process()
        self.checkpointer = checkpointer if main else None
        self.logger = logger if main else None
        self.mesh = mesh
        self.encoder = encoder
        device = next(mdm.parameters()).device
        self.generator = generator or torch.Generator(device=device).manual_seed(0)
        self._step_fn = make_train_step(mdm, sched, encoder, cfg.l1_weight,
                                        cond_mask_prob=cfg.cond_mask_prob, mesh=mesh)
        self._np_rng = np.random.default_rng(0)

    def run(self, num_steps: Optional[int] = None) -> TrainState:
        """Train to `num_steps` (cfg.num_steps by default) on batches from
        `data_iter`, B timesteps drawn per step."""

        def draws():
            while True:
                batch = next(self.data_iter)
                B = len(next(iter(batch.values())))
                yield (batch, *self.schedule_sampler.sample(B, self._np_rng))

        return self._loop(draws(), num_steps or self.cfg.num_steps)

    def run_chunked(self, bank: dict, steps_per_call: int,
                    num_steps: Optional[int] = None) -> TrainState:
        """Train from a bank of per-item tensors ('latents' (N, L), optional
        'action' / 'context' rows) with the JAX package's chunked draws: per
        chunk of K ≤ `steps_per_call` steps the host draws K batch-index rows
        (epoch permutations of the bank), then K·B timesteps. A chunk ends
        at the next log or save step. Uniform sampler only. Under a mesh it
        runs single-device on every rank, as the JAX package's CLI does."""
        if self.schedule_sampler.needs_losses:
            raise ValueError("chunked training requires the uniform sampler")
        if self.mesh is not None:
            print("steps_per_call > 1 runs single-device; ignoring mesh", file=sys.stderr)
            self.mesh = None
            self._step_fn = make_train_step(self.mdm, self.sched, self.encoder,
                                            self.cfg.l1_weight,
                                            cond_mask_prob=self.cfg.cond_mask_prob)
        num_steps = num_steps or self.cfg.num_steps
        B, n = self.cfg.batch_size, len(bank["latents"])
        if n < B:
            raise ValueError(f"bank of {n} items < batch size {B}")

        def index_rows():
            while True:
                order = self._np_rng.permutation(n)
                for s in range(0, n - B + 1, B):
                    yield order[s: s + B]

        def draws():
            rows = index_rows()
            while True:
                step = self.state.step  # the loop has taken every step drawn so far
                K = min(steps_per_call, num_steps - step)
                for interval in (self.cfg.log_interval, self.cfg.save_interval):
                    if interval:
                        K = min(K, interval - step % interval)
                idx = np.stack([next(rows) for _ in range(K)]).astype(np.int64)
                t, w = self.schedule_sampler.sample(K * B, self._np_rng)
                t, w = np.asarray(t).reshape(K, B), np.asarray(w).reshape(K, B)
                for k in range(K):
                    rows_k = torch.as_tensor(idx[k], device=bank["latents"].device)
                    yield {key: v[rows_k] for key, v in bank.items()}, t[k], w[k]

        return self._loop(draws(), num_steps)

    def _any_rank(self, flag: bool) -> bool:
        """`flag` on any 'data' rank: under a mesh a preemption signal that
        reaches one rank a step late must not leave the others in a step's
        collectives."""
        if self.mesh is None:
            return flag
        group, _, _ = data_axis(self.mesh)
        t = torch.tensor([float(flag)], device=next(self.mdm.parameters()).device)
        torch.distributed.all_reduce(t, torch.distributed.ReduceOp.MAX, group=group)
        return bool(t.item())

    def _loop(self, draws: Iterator, num_steps: int) -> TrainState:
        """Steps on `draws`' (batch, t, weights) until `num_steps`. A logged
        `nonfinite_skipped` counts the steps skipped since the last log: a
        device sum, read with the logged scalars."""
        skipped = 0.0
        with GracefulShutdown() as stop, StallWatchdog(self.cfg.stall_exit_s) as wd:
            while self.state.step < num_steps:
                if self._any_rank(stop.requested):
                    if self.checkpointer:
                        self.checkpointer.save(self.state.step, self.state, force=True)
                        self.checkpointer.wait()
                    if self.logger:
                        self.logger.log_metrics({"preempted": 1.0}, self.state.step)
                    return self.state
                batch, t, weights = next(draws)
                metrics = self._step_fn(self.state, batch, t, weights, generator=self.generator)
                wd.tick()
                skipped += metrics["nonfinite_skipped"]
                if self.schedule_sampler.needs_losses:
                    per_ex = metrics["per_example_loss"].cpu().numpy()
                    if np.isfinite(per_ex).all():  # a poisoned batch stays out of the history
                        self.schedule_sampler.update_with_all_losses(t, per_ex)
                step = self.state.step
                if self.logger and step % self.cfg.log_interval == 0:
                    self.logger.log_metrics(_scalars({**metrics, "nonfinite_skipped": skipped}),
                                            step=step)
                    skipped = 0.0
                if self.checkpointer and step % self.cfg.save_interval == 0:
                    self.checkpointer.save(step, self.state)
        return self.state
