"""AE training cells: the port's AutoEncoder train step
(`training.make_ae_train_step`) as `train_ae` drives it, one step after
another.

The feed is the CLI's: a corpus of items in the layout `data.UdfDataset`
reads, served by `data.ae_batch_iterator` over `data.SequenceSamplerTrain`
through `data.prefetch_iterator`. Set-up writes the corpus from the seed
under TMPDIR (removed when the run ends): analytic surfaces with exact
unsigned distances, spheres (closed) and discs (open), each item a surface
cloud and queries in Gaussian shells around it and uniform in the cube, as
`data.preprocess` places them, with the distance clipped at max_dist and its
unit gradient.

Set-up builds the state once and takes its first three steps through the
window's own call and feed; the window goes on with that same state. The
check holds those steps to `reference.ae_train`.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from .. import weights
from ..reference import ae_train as ref_ae
from ..reference.precision import F32, TF32
from ..weights import stream_seed
from . import train_mdm

CHECKED_STEPS = train_mdm.CHECKED_STEPS


def _surface(rng: np.random.Generator):
    """(sample(n) → (n, 3) surface points, udf_grad(x) → (distance, unit
    gradient)) of a random sphere or disc inside the cube."""
    c = rng.uniform(-0.3, 0.3, 3)
    if rng.random() < 0.5:
        r = rng.uniform(0.3, 0.6)

        def sample(n):
            v = rng.normal(size=(n, 3))
            return c + r * v / np.linalg.norm(v, axis=1, keepdims=True)

        def udf_grad(x):
            d = x - c
            nd = np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
            return np.abs(nd[:, 0] - r), np.sign(nd - r) * d / nd

        return sample, udf_grad
    n = rng.normal(size=3)
    n /= np.linalg.norm(n)
    a = rng.uniform(0.4, 0.65)
    e1 = np.cross(n, [1.0, 0.0, 0.0] if abs(n[0]) < 0.9 else [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)

    def sample(k):
        rad = a * np.sqrt(rng.random(k))
        th = rng.uniform(0, 2 * np.pi, k)
        return c + rad[:, None] * (np.cos(th)[:, None] * e1 + np.sin(th)[:, None] * e2)

    def udf_grad(x):
        d = x - c
        h = d @ n
        u = d - h[:, None] * n
        rho = np.linalg.norm(u, axis=1)
        nearest = c + np.where((rho > a)[:, None], u * (a / np.maximum(rho, 1e-12))[:, None], u)
        diff = x - nearest
        dist = np.linalg.norm(diff, axis=1)
        return dist, diff / np.maximum(dist, 1e-12)[:, None]

    return sample, udf_grad


def write_corpus(root: str, seed: int, tr: dict, max_dist: float) -> None:
    """tr["corpus_items"] items under root/train, from the seed."""
    os.makedirs(os.path.join(root, "train"))
    rng = np.random.default_rng(stream_seed(seed, "corpus"))
    c = tr["corpus"]
    for i in range(c["items"]):
        sample, udf_grad = _surface(rng)
        pcd = sample(c["cloud_points"])
        parts = []
        for std, share in zip(c["shell_stds"], c["shell_shares"]):
            cnt = int(round(share * c["queries"]))
            parts.append(pcd[rng.integers(0, len(pcd), cnt)] + rng.normal(scale=std, size=(cnt, 3)))
        parts.append(rng.uniform(-1, 1, (c["queries"] - sum(len(q) for q in parts), 3)))
        coords = np.clip(np.concatenate(parts), -1.0, 1.0)
        dist, grad = udf_grad(coords)
        np.savez(os.path.join(root, "train", f"item_{i:04d}.npz"), pcd=pcd.astype(np.float32),
                 coords=coords.astype(np.float32),
                 labels=np.minimum(dist, max_dist).astype(np.float32),
                 gradients=grad.astype(np.float32))


class Program:
    def __init__(self, cell, seed: int, device, corpus: str):
        from surfd_tpu_torch.ops import _build
        from surfd_tpu_torch.training import (
            AutoEncoder, create_train_state, make_ae_train_step, make_optimizer)
        from surfd_tpu_torch.utils.device import resolve_device

        resolve_device(device)  # the CLI's first step: on CUDA, TF32 off
        if device.type == "cuda":
            _build.load()
        self.device, self.seed = device, seed
        self.cfg, self.tr = cell["config"], cell["traffic"]
        a, opt = self.cfg["ae"], self.tr["optimizer"]
        self.sd0 = weights.seeded_state(ref_ae.param_specs(a), seed, "ae", device)
        with torch.device("meta"):
            ae = AutoEncoder(a["latent_size"], a["hidden_dim"], a["num_hidden_layers"], a["k"])
        self.ae = ae.to_empty(device=device)
        state = dict(self.sd0)
        for k, b in self.ae.named_buffers():  # running statistics: a fresh model's
            state[k] = (torch.zeros_like(b) if not k.endswith("running_var")
                        else torch.ones_like(b))
        self.ae.load_state_dict(state, strict=True)
        self.state = create_train_state(
            self.ae, make_optimizer(self.ae.parameters(), opt["lr"], opt["weight_decay"],
                                    opt["decay_rate"], opt["decay_every"], opt["lr_floor"]))
        self.step_fn = make_ae_train_step(self.ae, a["max_dist"], a["grad_loss_weight"], 0.0)
        self.feed = self._feed(corpus)

    def _feed(self, corpus: str):
        from surfd_tpu_torch.data import UdfDataset, ae_batch_iterator
        from surfd_tpu_torch.data.curriculum import CurriculumState, SequenceSamplerTrain
        from surfd_tpu_torch.data.prefetch import prefetch_iterator

        ds = UdfDataset(corpus, "train")
        rng = np.random.default_rng(stream_seed(self.seed, "draws"))
        sampler = SequenceSamplerTrain(CurriculumState(len(ds), list(range(len(ds)))), rng)
        a = self.cfg["ae"]
        return prefetch_iterator(ae_batch_iterator(
            ds, lambda: list(sampler), self.tr["batch_size"], a["num_points_pcd"],
            a["num_points_forward"], rng), depth=2)

    def step(self, record=None):
        batch = next(self.feed)
        if record is not None:
            record.append(batch)
        return self.step_fn(self.state, batch)

    def first_steps(self) -> dict:
        batches, losses, grad = [], [], None
        for i in range(CHECKED_STEPS):
            out = self.step(batches)
            losses.append(float(out["loss"]))
            if i == 0:
                b1 = self.state.optimizer.param_groups[0]["betas"][0]
                st = self.state.optimizer.state
                grad = {k: st[p]["exp_avg"] / (1.0 - b1) if "exp_avg" in st.get(p, {})
                        else torch.zeros_like(p) for k, p in self.ae.named_parameters()}
        delta = {k: p.detach() - self.sd0[k] for k, p in self.ae.named_parameters()}
        return {"batches": batches, "losses": losses, "grad": grad, "delta": delta}

    def release(self) -> None:
        self.ae = self.state = self.step_fn = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, traced: bool, device, opened) -> dict:
    corpus = tempfile.mkdtemp(prefix="bench_ae_corpus_")
    try:
        write_corpus(corpus, seed, cell["traffic"], cell["config"]["ae"]["max_dist"])
        prog = Program(cell, seed, device, corpus)
        return train_mdm.window(prog, cell, seconds, traced, device, opened, check)
    finally:
        shutil.rmtree(corpus, ignore_errors=True)


def reference(prog: Program, first: dict, p=F32, half: bool = False) -> dict:
    """The reference's first steps on the program's batches; `half` plants
    the fault of a step over half of the batch."""
    dev, cfg = prog.device, prog.cfg["ae"]
    keep = prog.tr["batch_size"] // 2 if half else None
    batches = [{k: torch.as_tensor(np.asarray(b[k][:keep]), device=dev, dtype=torch.float32)
                for k in ("pcd", "coords", "udf", "gradients")} for b in first["batches"]]
    return ref_ae.run(prog.sd0, {**cfg, "grad_loss_weight": cfg["grad_loss_weight"]}, batches,
                      prog.tr["optimizer"], p)


def knn_rows_differ(prog: Program, first: dict) -> int:
    """Points of the first batch whose k nearest neighbours, as a set, differ
    between the program's kNN and the reference's: a look at why the
    losses of sound runs spread."""
    from surfd_tpu_torch.models.dgcnn import knn_indices

    pcd = torch.as_tensor(np.asarray(first["batches"][0]["pcd"]), device=prog.device)
    k = prog.cfg["ae"]["k"]
    with torch.no_grad():
        a = knn_indices(pcd, k).sort(dim=-1).values
        b = ref_ae.knn(pcd, k, F32).sort(dim=-1).values
    return int((a != b).any(dim=-1).sum())


def check(prog: Program, first: dict) -> list:
    """The numbers that the cell's limits name, against those limits."""
    lim = prog.tr["check"]["limits"]
    got = train_mdm.numbers(first, reference(prog, first))
    return [(k, got[k], v, "max") for k, v in lim.items()]


def readings(cell, seeds: list, device) -> list:
    rows = []
    for seed in seeds:
        corpus = tempfile.mkdtemp(prefix="bench_ae_corpus_")
        try:
            write_corpus(corpus, seed, cell["traffic"], cell["config"]["ae"]["max_dist"])
            prog = Program(cell, seed, device, corpus)
            first = prog.first_steps()
        finally:
            shutil.rmtree(corpus, ignore_errors=True)
        prog.release()
        ref = reference(prog, first)
        row = {"seed": seed, **train_mdm.numbers(first, ref)}
        ctl = reference(prog, first, TF32)
        row.update({f"{k}_control": v for k, v in train_mdm.numbers(ctl, ref).items()})
        half = reference(prog, first, half=True)
        row.update({f"{k}_halfbatch": v for k, v in train_mdm.numbers(half, ref).items()})
        row["knn_rows_differ"] = knn_rows_differ(prog, first)
        rows.append(row)
    return rows
