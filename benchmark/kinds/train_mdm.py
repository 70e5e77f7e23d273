"""Diffusion training cells: the port's train step
(`training.diffusion_trainer.make_train_step`) as `train_diffusion
--precompute_latents` drives it, one step after another.

The feed: a bank of precomputed latents and class labels drawn from the
seed, served in epoch permutations of the bank (every row of a step
differs), each step's timesteps and importance weights from the uniform
schedule sampler on a seeded numpy generator, as host numpy batches through
`data.prefetch_iterator` (the CLI's feed); the step draws its noise from a
seeded generator on the card. The train state is AdamW with the anneal and
the EMA (`training.create_train_state`).

Set-up builds the state once and takes its first three steps through the
window's own call and feed; the window then goes on with that same state.
The check holds those three steps to the plain reference
(`reference.diffusion_train`): each loss, each leaf's first gradient (from
AdamW's first moment after one step), each leaf's change after the three.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from .. import compare, flops, trace, weights
from ..reference import diffusion_train as ref_train
from ..reference import mdm as ref_mdm
from ..reference.precision import F32, TF32
from ..weights import stream_seed
from ..window import gaps as window_gaps
from ..window import percentile

CHECKED_STEPS = 3


class Program:
    def __init__(self, cell, seed: int, device):
        from surfd_tpu_torch.diffusion import named_schedule
        from surfd_tpu_torch.models import MDM
        from surfd_tpu_torch.ops import _build
        from surfd_tpu_torch.training import create_train_state, make_optimizer
        from surfd_tpu_torch.training.diffusion_trainer import make_train_step
        from surfd_tpu_torch.utils.device import resolve_device

        resolve_device(device)  # the CLI's first step: on CUDA, TF32 off
        if device.type == "cuda":
            _build.load()
        self.device, self.seed = device, seed
        self.cfg, self.tr = cell["config"], cell["traffic"]
        m, df, opt = self.cfg["denoiser"], self.cfg["diffusion"], self.tr["optimizer"]
        self.sd0 = weights.seeded_state(ref_mdm.param_specs(m), seed, "mdm", device)
        with torch.device("meta"):
            mdm = MDM(cond_mode=m["cond_mode"], num_actions=m["num_actions"],
                      clip_dim=m.get("context_dim", 512), model_channels=m["model_channels"],
                      num_res_blocks=m["num_res_blocks"], channel_mult=tuple(m["channel_mult"]),
                      num_heads=m["num_heads"])
        self.mdm = mdm.to_empty(device=device)
        self.mdm.load_state_dict(self.sd0, strict=True)
        self.sched = named_schedule(df["noise_schedule"], df["diffusion_steps"])
        self.state = create_train_state(
            self.mdm, make_optimizer(self.mdm.parameters(), opt["lr"], opt["weight_decay"],
                                     opt["decay_rate"], opt["decay_every"], opt["lr_floor"]),
            self.tr["ema_rate"])
        self.step_fn = make_train_step(self.mdm, self.sched, l1_weight=opt["l1_weight"],
                                       cond_mask_prob=0.0)
        self.generator = torch.Generator(device=device).manual_seed(stream_seed(seed, "train-noise"))
        self.feed = self._feed()

    def _feed(self):
        from surfd_tpu_torch.data.prefetch import prefetch_iterator
        from surfd_tpu_torch.diffusion import UniformSampler

        m, B = self.cfg["denoiser"], self.tr["batch_size"]
        rng = np.random.default_rng(stream_seed(self.seed, "bank"))
        n = self.tr["bank_rows"]
        bank = {"latents": rng.standard_normal((n, m["latent_size"])).astype(np.float32),
                "action": rng.integers(0, m["num_actions"], n).astype(np.int64)}
        sampler = UniformSampler(self.cfg["diffusion"]["diffusion_steps"])
        draws = np.random.default_rng(stream_seed(self.seed, "draws"))

        def batches():
            while True:
                order = draws.permutation(n)
                for s in range(0, n - B + 1, B):
                    rows = order[s:s + B]
                    t, w = sampler.sample(B, draws)
                    yield {k: v[rows] for k, v in bank.items()}, t, w

        return prefetch_iterator(batches(), depth=2)

    def step(self, record=None):
        batch, t, w = next(self.feed)
        if record is not None:
            record.append((batch, t, w))
        return self.step_fn(self.state, batch, t, w, generator=self.generator)

    def first_steps(self) -> dict:
        """The first CHECKED_STEPS steps, with what the check compares."""
        batches, losses, grad = [], [], None
        for i in range(CHECKED_STEPS):
            out = self.step(batches)
            losses.append(float(out["loss"]))
            if i == 0:
                b1 = self.state.optimizer.param_groups[0]["betas"][0]
                # the optimizer holds no moment of a leaf it did not update
                st = self.state.optimizer.state
                grad = {k: st[p]["exp_avg"] / (1.0 - b1) if "exp_avg" in st.get(p, {})
                        else torch.zeros_like(p) for k, p in self.mdm.named_parameters()}
        delta = {k: p.detach() - self.sd0[k] for k, p in self.mdm.named_parameters()}
        return {"batches": batches, "losses": losses, "grad": grad, "delta": delta}

    def release(self) -> None:
        self.mdm = self.state = self.step_fn = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class _Marks:
    """Step ends: CUDA events recorded on the step's stream (read after the
    window), or the host clock on a CPU rehearsal."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list:
        """Each mark's time after the first, in seconds."""
        if self.cuda:
            torch.cuda.synchronize()
            return [self.marks[0].elapsed_time(e) / 1e3 for e in self.marks]
        return [t - self.marks[0] for t in self.marks]


def run(cell, seed: int, seconds: float, traced: bool, device, opened) -> dict:
    return window(Program(cell, seed, device), cell, seconds, traced, device, opened, check)


def window(prog, cell, seconds: float, traced: bool, device, opened, check_fn) -> dict:
    """A training cell's run after its program is built: the checked first
    steps, the window of steps on the same state, the traced steps, the
    check."""
    first = prog.first_steps()
    if device.type == "cuda":
        torch.cuda.synchronize()
    opened()
    marks = _Marks(device)
    marks.mark()
    t_open = time.perf_counter()
    flags = []  # each step's skip decision, read only once the window has closed
    while time.perf_counter() - t_open < seconds:
        flags.append(prog.step()["nonfinite_skipped"])
        marks.mark()
    ends = marks.seconds()
    skipped = sum(int(f) for f in flags)
    steps = len(ends) - 1
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gaps = window_gaps(ends)
    layer = {"cell": cell, "steps": steps, "window_s": ends[-1], "gaps": gaps,
             "step_flops": step_flops(cell), "traced": {}}
    if traced:
        n = cell["traffic"]["traced_steps"]
        _, sess = trace.profile(lambda: [prog.step() for _ in range(n)])
        layer["traced"] = {"sessions": [sess], "spans": [("train_step", sess.t0, sess.t1)],
                           "steps": n}
    prog.release()
    checks = check_fn(prog, first)
    checks.append(("skipped_steps", skipped, 0, "max"))
    name = cell["traffic"]["step_metric"]  # the cell's names: <name>_ms, <name>_p90_ms
    e2e = {f"{name}_ms": 1000.0 * ends[-1] / max(steps, 1),
           f"{name}_p90_ms": 1000.0 * percentile(gaps, 90) if gaps else float("inf")}
    return {"attempted": steps, "failed": skipped, "e2e": e2e, "layer": layer,
            "memory_peak": peak, "checks": checks}


def step_flops(cell) -> int:
    """One train step's FLOPs, counted over the reference on the meta
    device: the denoiser's forward and backward at the batch, or the AE's
    (its loss with the second-order term, and that loss's backward)."""
    B = cell["traffic"]["batch_size"]
    if cell["traffic"]["kind"] == "train_ae":
        return flops.ae_train_flops(json.dumps(cell["config"]["ae"], sort_keys=True), B)
    return flops.mdm_train_flops(json.dumps(cell["config"]["denoiser"], sort_keys=True), B)


def reference(prog: Program, first: dict, p=F32, half: bool = False) -> dict:
    """The reference's first steps on the program's batches and the same
    noise draws; `half` plants the fault of a loss over half the batch."""
    dev, B = prog.device, prog.tr["batch_size"]
    batches = []
    for batch, t, w in first["batches"]:
        t = torch.as_tensor(np.asarray(t), device=dev, dtype=torch.int64)
        w = torch.as_tensor(np.asarray(w), device=dev, dtype=torch.float32)
        lat = torch.as_tensor(batch["latents"], device=dev)
        act = torch.as_tensor(batch["action"], device=dev)
        if half:
            k = B // 2
            lat, act, t, w = lat[:k], act[:k], t[:k], w[:k]
        batches.append((lat, act, None, t, w))
    gen = torch.Generator(device=dev).manual_seed(stream_seed(prog.seed, "train-noise"))
    L = prog.cfg["denoiser"]["latent_size"]

    def noise(shape):
        # the program's draw of the whole batch; with `half`, its first rows
        return torch.randn((B, L, 1), generator=gen, device=dev)[:shape[0]]

    return ref_train.run(prog.sd0, {**prog.cfg["denoiser"], **prog.cfg["diffusion"]}, batches,
                         noise, prog.tr["optimizer"], p)


def numbers(first: dict, ref: dict) -> dict:
    """The first steps against the reference's: each step's loss (the first
    alone, and the widest of all), the first gradient and the change after
    the steps by the worst leaf, and the change by the median leaf. The
    change leaves out leaves whose reference gradient is nought to rounding
    (`compare.moving_leaves`)."""
    leaves = compare.moving_leaves(ref["grad"])
    change = compare.leaf_gaps(first["delta"], ref["delta"], leaves)
    return {"loss_gap_first": compare.loss_gap(first["losses"][:1], ref["losses"][:1]),
            "loss_gap": compare.loss_gap(first["losses"], ref["losses"]),
            "grad_gap": compare.worst_leaf_gap(first["grad"], ref["grad"])[0],
            "update_gap": max(change.values()),
            "update_gap_median": statistics.median(change.values())}


def check(prog: Program, first: dict) -> list:
    """The numbers that the cell's limits name, against those limits."""
    lim = prog.tr["check"]["limits"]
    got = numbers(first, reference(prog, first))
    return [(k, got[k], v, "max") for k, v in lim.items()]


def readings(cell, seeds: list, device) -> list:
    """Sound (the program's first steps) and control (the reference in TF32
    in its place) numbers a seed, and the planted half-batch fault's."""
    rows = []
    for seed in seeds:
        prog = Program(cell, seed, device)
        first = prog.first_steps()
        prog.release()
        ref = reference(prog, first)
        row = {"seed": seed, **numbers(first, ref)}
        ctl = reference(prog, first, TF32)
        ctl_first = {"losses": ctl["losses"], "grad": ctl["grad"], "delta": ctl["delta"]}
        row.update({f"{k}_control": v for k, v in numbers(ctl_first, ref).items()})
        half = reference(prog, first, half=True)
        row.update({f"{k}_halfbatch": v for k, v in numbers(half, ref).items()})
        rows.append(row)
    return rows
