"""Generation cells: the path of the port's generate CLIs, job after job.

A job is one request of `generate_cat` / `generate_text` at the traffic's
settings: (text) CLIP's text encode of the job's prompt; the latents of
`samples` rows through `pipelines.sample_latents` with the guided model
function (`models.make_cfg_model_fn`) and the job's noise generator; then
one mesh per latent through `pipelines.generate_meshes_pipelined` at the
traffic's depth (`get_mesh_from_udf(make_udf_fn(...), cfg=...,
return_stats=True)` per latent). Meshes stay in memory.

The decoder is the planted sheet (`weights.planted_decoder_state`): every
latent draws the shipped sheet, so that a random denoiser gives real
extraction work. The evaluator is the program's `UdfEvaluator` with two
benchmark hooks: in the window's first jobs (the traffic's `first_jobs`),
it keeps the first points and values of each float32 field call (the fill's
K1 f32 output, which the check holds to the reference); and it counts the
gradient query's corners (for `mfu.gen`).

What is checked, after the window, against the references, in jobs drawn
from the seed among those first jobs: the latents (sampler and
denoiser; same weights, labels or prompt, and the same generator's draws),
as a whole reference trajectory (`latent_gap`) or step by step from the
program's states (`step_gap`), whichever the traffic's limits name; CLIP's
embedding (text); the field at the kept points. Every mesh of the window is
held to the sheet's ground-truth samples.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .. import flops, trace, traffic, weights
from ..reference import chamfer as ref_chamfer
from ..reference import clip as ref_clip
from ..reference import decoder as ref_decoder
from ..reference import mdm as ref_mdm
from ..reference import sampler as ref_sampler
from ..reference.precision import F32, TF32
from ..window import closed_loop

RECORD = 2048  # points kept of each float32 field call
STAGES = ("grid_fill", "marching", "face_filter", "cleanup")  # get_mesh_from_udf's, in order


class Program:
    """The program's objects of one cell, made from the seed."""

    def __init__(self, cell, seed: int, device):
        from surfd_tpu_torch import native
        from surfd_tpu_torch.models import MDM, CbnDecoder
        from surfd_tpu_torch.ops import _build
        from surfd_tpu_torch.pipelines import MeshExtractionConfig, UdfEvaluator
        from surfd_tpu_torch.utils.device import resolve_device

        resolve_device(device)  # the CLIs' first step: on CUDA, TF32 off
        if device.type == "cuda":
            _build.load()  # the CUDA kernels: built once a checkout, then loaded
        native.load()
        self.device = device
        self.cfg, self.tr = cell["config"], cell["traffic"]
        m, d = self.cfg["denoiser"], self.cfg["decoder"]
        self.sd_mdm = weights.seeded_state(ref_mdm.param_specs(m), seed, "mdm", device)
        with torch.device("meta"):
            mdm = MDM(cond_mode=m["cond_mode"], num_actions=m["num_actions"],
                      clip_dim=m.get("context_dim", 512), model_channels=m["model_channels"],
                      num_res_blocks=m["num_res_blocks"], channel_mult=tuple(m["channel_mult"]),
                      num_heads=m["num_heads"])
        self.mdm = mdm.to_empty(device=device)
        self.mdm.load_state_dict(self.sd_mdm, strict=True)
        self.mdm.eval()
        self.planted = cell["path"](d["planted"])
        self.sd_dec = weights.planted_decoder_state(self.planted, d["latent_size"], device)
        with torch.device("meta"):
            dec = CbnDecoder(d["latent_size"], d["hidden_dim"], d["num_hidden_layers"])
        self.dec = dec.to_empty(device=device)
        state = {k[len("decoder."):]: v for k, v in self.sd_dec.items()}
        for k in list(state):
            if k.endswith(".running_var"):
                state[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
        self.dec.load_state_dict(state, strict=True)
        self.dec.eval()
        self.clip = self.sd_clip = None
        if "clip" in self.cfg:
            from surfd_tpu_torch.models import Clip

            c = self.cfg["clip"]
            self.sd_clip = weights.seeded_state(ref_clip.text_param_specs(c), seed, "clip", device)
            with torch.device("meta"):
                clip = Clip(vocab_size=c["vocab_size"], context_length=c["context_length"],
                            text_width=c["text_width"], text_layers=c["text_layers"],
                            embed_dim=c["embed_dim"])
            self.clip = clip.to_empty(device=device)
            missing, unexpected = self.clip.load_state_dict(self.sd_clip, strict=False)
            stray = [k for k in missing if not (k.startswith("visual.") or k == "logit_scale")]
            if stray or unexpected:
                raise RuntimeError(f"CLIP state: missing {stray}, unexpected {unexpected}")
            self.clip.eval()
        self.sched = self._schedule()
        ex = self.tr["extraction"]
        self.ext = MeshExtractionConfig(
            resolution=ex["resolution"], max_batch=ex["max_batch"], max_dist=d["max_dist"],
            min_component_faces=ex["min_component_faces"],
            final_laplacian_iters=ex["final_laplacian_iters"], surface_bias=ex["surface_bias"],
            **ex.get("overrides", {}))

        class Recorded(UdfEvaluator):
            """The program's evaluator; keeps each f32 field call's first
            points and values where `kept` is a list, and counts gradient
            corners."""

            def __call__(self, pts):
                out = super().__call__(pts)
                if self.kept is not None:
                    self.kept.append((pts[:RECORD].clone(), out[:RECORD].clone()))
                return out

            def grad_i8_gid_async(self, gids, *a, **k):
                self.corners += len(gids)
                return super().grad_i8_gid_async(gids, *a, **k)

        self.Recorded = Recorded

    def release(self) -> None:
        """Free the program's modules (the benchmark's weights stay)."""
        self.mdm = self.dec = self.clip = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _schedule(self):
        from surfd_tpu_torch.diffusion import (
            named_beta_schedule, named_schedule, space_timesteps, spaced_schedule)

        df, rs = self.cfg["diffusion"], self.tr.get("respacing", "")
        if rs:
            base = named_beta_schedule(df["noise_schedule"], df["diffusion_steps"])
            return spaced_schedule(base, space_timesteps(df["diffusion_steps"], rs))
        return named_schedule(df["noise_schedule"], df["diffusion_steps"])

    def evaluator(self, latent, keep: bool = False):
        from surfd_tpu_torch.pipelines import make_udf_fn

        ev = make_udf_fn(self.dec, None, latent, self.cfg["decoder"]["max_dist"],
                         device=self.device, chunk=self.tr["extraction"]["max_batch"])
        ev.__class__ = self.Recorded
        ev.kept, ev.corners = ([] if keep else None), 0
        return ev

    def condition(self, seed: int, k: int):
        """Job k's conditioning as the CLI hands it to the sampler:
        (action, context, tokens)."""
        B = self.tr["samples"]
        if self.tr["condition"] == "category":
            labels = traffic.category_labels(seed, k, B, self.cfg["denoiser"]["num_actions"])
            return labels.to(self.device), None, None
        tokens = traffic.prompt_tokens(seed, k, tuple(self.tr["prompt_tokens"]),
                                       self.cfg["clip"]["context_length"]).to(self.device)
        with torch.no_grad():
            ctx = self.clip.encode_text(tokens)
        return None, ctx.to(self.device, torch.float32).repeat_interleave(B, dim=0), tokens

    def sample(self, seed: int, k: int, action, context, sched=None, record=None):
        """(latents (B, L), denoiser calls); `record`, a list, gets each
        call's (input, step) for the step-by-step check."""
        from surfd_tpu_torch.diffusion import VarType
        from surfd_tpu_torch.models import make_cfg_model_fn
        from surfd_tpu_torch.pipelines import sample_latents

        fn = make_cfg_model_fn(self.mdm, self.tr["guidance"], context=context, action=action)
        calls = [0]

        def counted(x, t):
            calls[0] += 1
            if record is not None:
                record.append((x.clone(), t.clone()))
            return fn(x, t)

        lat = sample_latents(sched or self.sched, counted, self.tr["samples"],
                             self.cfg["denoiser"]["latent_size"],
                             traffic.job_generator(seed, k, self.device),
                             sampler=self.tr["sampler"], device=self.device, clip_denoised=False,
                             var_type=VarType.FIXED_SMALL)
        _sync(self.device)
        return lat, calls[0]

    def extract(self, latents, spans=None, keep: bool = False):
        """[(mesh, stats, evaluator, seconds)] of the latents, in order;
        `keep`: the evaluators keep their field values for the check."""
        from surfd_tpu_torch.pipelines import generate_meshes_pipelined

        evs = [self.evaluator(latents[i], keep) for i in range(len(latents))]
        out = []
        t = time.perf_counter()
        tn = time.time_ns()
        for ev, (mesh, stats) in zip(evs, generate_meshes_pipelined(
                iter(evs), self.ext, depth=self.tr.get("pipeline_depth", 1), return_stats=True)):
            now, now_ns = time.perf_counter(), time.time_ns()
            if spans is not None:
                spans.extend(_stage_spans(tn, now_ns, stats.get("times", {})))
            out.append((mesh, stats, ev, now - t))
            t, tn = now, now_ns
        return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stage_spans(t0: int, t1: int, times: dict) -> list:
    """[(label, start_ns, end_ns)] of one extraction's stages, laid end to
    end from its start in the order the program runs them."""
    spans, cur = [], t0
    for name in STAGES:
        if name in times:
            end = cur + int(times[name] * 1e9)
            spans.append((f"extract.{name}", cur, end))
            cur = end
    spans.append(("extract.other", cur, t1))
    return spans


def _job(prog: Program, seed: int, k: int, checked=()) -> dict:
    """Job k; a job in `checked` keeps its field values and, where the
    limits name `step_gap`, its denoiser calls' inputs."""
    t0 = time.perf_counter()
    action, context, tokens = prog.condition(seed, k)
    t1 = time.perf_counter()
    record = [] if k in checked and "step_gap" in prog.tr["check"]["limits"] else None
    lat, calls = prog.sample(seed, k, action, context, record=record)
    t2 = time.perf_counter()
    meshes = prog.extract(lat, keep=k in checked)
    print(f"job {k}: condition {t1 - t0:.3f} s, sample {t2 - t1:.3f} s, meshes " + "; ".join(
        f"{m[3]:.3f} s " + " ".join(f"{n} {m[1]['times'].get(n)}" for n in STAGES)
        for m in meshes), file=sys.stderr)
    return {"k": k, "sample_s": t2 - t1, "calls": calls, "context": context,
            "latents": lat, "meshes": meshes, "steps": record, "checked": k in checked}


def _warm(prog: Program, seed: int) -> None:
    """The cell's shapes once: the guided denoiser at the job's batch over a
    two-step schedule, CLIP, and one extraction at the cell's resolution."""
    from surfd_tpu_torch.diffusion import named_beta_schedule, spaced_schedule

    df = prog.cfg["diffusion"]
    short = spaced_schedule(named_beta_schedule(df["noise_schedule"], df["diffusion_steps"]), {0, 1})
    action, context, _ = prog.condition(seed, -1)
    lat, _ = prog.sample(seed, -1, action, context, sched=short)
    prog.extract(lat[:1])
    _sync(prog.device)


def run(cell, seed: int, seconds: float, traced: bool, device, opened) -> dict:
    """One run of a generation cell; `opened()` is called as the window
    opens (the end of set-up)."""
    prog = Program(cell, seed, device)
    _warm(prog, seed)
    # only the first jobs keep what the check compares; it follows some of
    # them, drawn from the seed once the window has closed
    checked = range(prog.tr["check"]["first_jobs"])
    opened()
    window_s, done = closed_loop(seconds, lambda k: _job(prog, seed, k, checked))
    jobs = [out for _, _, out in done]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tr = {}
    if traced:
        tr = _traced_job(prog, seed, len(jobs))
    gen = {"window_s": window_s, "jobs": jobs, "traced": tr, "cell": cell,
           "flops": _model_flops(cell)}
    prog.release()
    kept = [j for j in jobs if j["checked"]]
    followed = [kept[i] for i in traffic.pick(seed, "check", len(kept), prog.tr["check"]["jobs"])]
    checks = check(prog, seed, followed, jobs)
    return {"attempted": len(jobs) * prog.tr["samples"],
            "failed": sum(prog.tr["samples"] - len(j["meshes"]) for j in jobs),
            "e2e": {"mesh_s": window_s / max(sum(len(j["meshes"]) for j in jobs), 1)},
            "layer": gen, "memory_peak": peak, "checks": checks}


def _traced_job(prog: Program, seed: int, k: int) -> dict:
    """One more job under the profiler, after the window: its sampling
    (CLIP included) read in memory, its extraction from the Chrome trace
    (K1's launch grids)."""
    (action, context, tokens), sess_c = trace.profile(lambda: prog.condition(seed, k))
    (lat, calls), sess_m = trace.profile(lambda: prog.sample(seed, k, action, context))
    spans = [("clip" if tokens is not None else "condition", sess_c.t0, sess_c.t1),
             ("sample", sess_m.t0, sess_m.t1)]
    meshes, sess_x = trace.profile(lambda: prog.extract(lat, spans), grids=True)
    return {"sessions": [sess_c, sess_m, sess_x], "spans": spans, "calls": calls,
            "sample_session": sess_m, "extract_session": sess_x,
            "corners": sum(ev.corners for _, _, ev, _ in meshes)}


def _model_flops(cell) -> dict:
    """FLOPs of one denoiser call (CFG's branches as rows) and of one
    prompt's CLIP encode (the decoder's come from the trace)."""
    m, tr = cell["config"]["denoiser"], cell["traffic"]
    rows = tr["samples"] * (2 if tr["guidance"] != 1.0 else 1)
    clip = cell["config"].get("clip")
    return {"denoiser_call": flops.mdm_forward_flops(json.dumps(m, sort_keys=True), rows),
            "clip": flops.clip_text_flops(json.dumps(clip, sort_keys=True), 1)
            if tr["condition"] == "text" else 0}


# ---------------------------------------------------------------------------
# the comparison with the references
# ---------------------------------------------------------------------------

def reference_condition(prog: Program, seed: int, k: int, p=F32):
    """Job k's (class ids, CLIP embedding (1, 512), context (B, 512)) by the
    references, from the benchmark's inputs alone."""
    m, tr, dev = prog.cfg["denoiser"], prog.tr, prog.device
    if tr["condition"] == "category":
        return traffic.category_labels(seed, k, tr["samples"], m["num_actions"]).to(dev), None, None
    tokens = traffic.prompt_tokens(seed, k, tuple(tr["prompt_tokens"]),
                                   prog.cfg["clip"]["context_length"]).to(dev)
    with torch.no_grad():
        emb = ref_clip.encode_text(prog.sd_clip, tokens, prog.cfg["clip"]["text_width"] // 64, p)
    return None, emb, emb.repeat_interleave(tr["samples"], dim=0)


def _reference_sampler(prog: Program, seed: int, k: int, p):
    """(the guided reference denoiser with job k's conditioning, CLIP's
    embedding included; the reference schedule; job k's generator)."""
    m, tr = prog.cfg["denoiser"], prog.tr
    y, _, ctx = reference_condition(prog, seed, k, p)
    df = prog.cfg["diffusion"]
    sched = ref_sampler.schedule(df["noise_schedule"], df["diffusion_steps"], tr.get("respacing", ""))
    fn = ref_mdm.guided(prog.sd_mdm, m, tr["guidance"], y=y, context=ctx, p=p)
    return fn, sched, traffic.job_generator(seed, k, prog.device)


def reference_latents(prog: Program, seed: int, k: int, p=F32) -> torch.Tensor:
    """Job k's latents (B, L) by the references alone: from the generator's
    first draw through every step with the job's draws replayed, with none
    of the program's states."""
    fn, sched, gen = _reference_sampler(prog, seed, k, p)
    shape = (prog.tr["samples"], prog.cfg["denoiser"]["latent_size"], 1)
    with torch.no_grad():
        x = torch.randn(shape, generator=gen, device=prog.device)
        for i in range(sched["T"]):
            noise = torch.randn(shape, generator=gen, device=prog.device)
            x = ref_sampler.step(fn, sched, x, sched["T"] - 1 - i, noise, prog.tr["sampler"])
    return x[..., 0]


def latent_gap(prog: Program, seed: int, job: dict) -> float:
    """Widest gap between the job's latents and `reference_latents`."""
    ref = reference_latents(prog, seed, job["k"])
    if tuple(job["latents"].shape) != tuple(ref.shape):
        return float("inf")
    return float((job["latents"] - ref).abs().max())


def reference_steps(prog: Program, seed: int, job: dict, p=F32) -> list:
    """One reference step (the guided reference denoiser, CLIP's embedding
    included, then the sampler's update with the job's noise draws replayed)
    from each of the program's states in turn: the states it should reach."""
    fn, sched, gen = _reference_sampler(prog, seed, job["k"], p)
    tr, dev = prog.tr, prog.device
    shape = tuple(job["steps"][0][0].shape)
    out = []
    with torch.no_grad():
        torch.randn(shape, generator=gen, device=dev)  # the initial draw
        for i, (x, _) in enumerate(job["steps"]):
            noise = torch.randn(shape, generator=gen, device=dev)
            out.append(ref_sampler.step(fn, sched, x, sched["T"] - 1 - i, noise, tr["sampler"]))
    return out


def step_gap(prog: Program, seed: int, job: dict) -> float:
    """The sampler and the denoiser, step by step from the program's own
    state: the widest gap between the program's state after each step (the
    next call's input; the latents after the last) and `reference_steps`.
    The start is held too: the first input against the generator's first
    draw."""
    df = prog.cfg["diffusion"]
    n = ref_sampler.schedule(df["noise_schedule"], df["diffusion_steps"],
                             prog.tr.get("respacing", ""))["T"]
    if len(job["steps"]) != n:  # a denoiser call per step, or the steps are not the sampler's
        return float("inf")
    states = [x for x, _ in job["steps"]] + [job["latents"][..., None]]
    gen = traffic.job_generator(seed, job["k"], prog.device)
    first = torch.randn(tuple(states[0].shape), generator=gen, device=prog.device)
    gap = float((states[0] - first).abs().max())
    for got, want in zip(states[1:], reference_steps(prog, seed, job)):
        gap = max(gap, float((got - want).abs().max()))
    return gap


def field_gap(prog: Program, latent, kept: list, p=F32) -> float:
    """Widest gap between the kept field values and the reference decoder's
    at the same points and latent."""
    if not kept:
        return float("inf")
    pts = torch.cat([a for a, _ in kept])
    vals = torch.cat([b for _, b in kept])
    with torch.no_grad():
        ref = ref_decoder.udf(prog.sd_dec, latent, pts, prog.cfg["decoder"]["max_dist"], p)
    return float((vals - ref).abs().max())


def mesh_numbers(prog: Program, seed: int, jobs: list) -> dict:
    """Every mesh of the window against the sheet's ground truth: the worst
    Chamfer-L2 of `mesh_points` vertices drawn from the seed, the fewest
    faces, the out-of-domain vertices, and the meshes missing."""
    surface = weights.sheet_surface(prog.planted, prog.device)
    n = prog.tr["check"]["mesh_points"]
    worst, fewest, oob, got = 0.0, None, 0, 0
    for j in jobs:
        for i, (mesh, stats, _, _) in enumerate(j["meshes"]):
            got += 1
            nv = len(mesh.vertices)
            fewest = len(mesh.faces) if fewest is None else min(fewest, len(mesh.faces))
            oob += int(stats.get("oob_vertices", 0))
            if nv == 0:
                worst = float("inf")
                continue
            idx = traffic.pick(seed, f"mesh/{j['k']}/{i}", nv, n)
            v = torch.from_numpy(np.asarray(mesh.vertices[idx], np.float32)).to(prog.device)
            worst = max(worst, ref_chamfer.chamfer(v, surface))
    return {"chamfer": worst, "faces_min": fewest or 0, "oob_vertices": oob,
            "meshes_missing": len(jobs) * prog.tr["samples"] - got}


def check(prog: Program, seed: int, followed: list, jobs: list) -> list:
    """[(name, value, limit, "max"|"min")] of the run: the followed jobs'
    latents or steps and field (and CLIP's embedding) against the
    references, every mesh of the window against the ground truth."""
    lim = prog.tr["check"]["limits"]
    lgap = sgap = cgap = fgap = 0.0 if followed else float("inf")
    for j in followed:
        if "latent_gap" in lim:
            lgap = max(lgap, latent_gap(prog, seed, j))
        if "step_gap" in lim:
            sgap = max(sgap, step_gap(prog, seed, j))
        _, emb, _ = reference_condition(prog, seed, j["k"])
        if emb is not None:
            cgap = max(cgap, float((j["context"][:1] - emb).abs().max()))
        for i, (_, _, ev, _) in enumerate(j["meshes"]):
            fgap = max(fgap, field_gap(prog, j["latents"][i], ev.kept))
    out = [(n, g, lim[n], "max") for n, g in (("latent_gap", lgap), ("step_gap", sgap))
           if n in lim]
    if prog.tr["condition"] == "text":
        out.append(("clip_gap", cgap, lim["clip_gap"], "max"))
    out.append(("field_gap", fgap, lim["field_gap"], "max"))
    mn = mesh_numbers(prog, seed, jobs)
    out += [("chamfer", mn["chamfer"], lim["chamfer"], "max"),
            ("faces_min", mn["faces_min"], lim["faces_min"], "min"),
            ("oob_vertices", mn["oob_vertices"], 0, "max"),
            ("meshes_missing", mn["meshes_missing"], 0, "max"),
            ("jobs", len(jobs), 1, "min")]
    return out


def readings(cell, seeds: list, device) -> list:
    """The numbers of one job a seed, sound (the program) and control (the
    references in TF32 in the program's place), for setting the limits."""
    rows = []
    for seed in seeds:
        prog = Program(cell, seed, device)
        job = _job(prog, seed, 0, checked=(0,))
        lim = prog.tr["check"]["limits"]
        row = {"seed": seed}
        if "latent_gap" in lim:
            ref = reference_latents(prog, seed, 0)
            row.update(latent_gap=float((job["latents"] - ref).abs().max()),
                       latent_gap_control=float(
                           (reference_latents(prog, seed, 0, TF32) - ref).abs().max()))
        if "step_gap" in lim:
            row.update(step_gap=step_gap(prog, seed, job),
                       step_gap_control=_step_control(prog, seed, job))
        evs = [(job["latents"][i], ev.kept) for i, (_, _, ev, _) in enumerate(job["meshes"])]
        row["field_gap"] = max(field_gap(prog, lat, kept) for lat, kept in evs)
        row["field_gap_control"] = max(_field_control(prog, lat, kept) for lat, kept in evs)
        row.update(mesh_numbers(prog, seed, [job]))
        _, emb, _ = reference_condition(prog, seed, 0)
        if emb is not None:
            row["clip_gap"] = float((job["context"][:1] - emb).abs().max())
            _, emb_t, _ = reference_condition(prog, seed, 0, TF32)
            row["clip_gap_control"] = float((emb_t - emb).abs().max())
        rows.append(row)
        del prog, job
    return rows


def _step_control(prog: Program, seed: int, job: dict) -> float:
    """The references in TF32 in the program's place: their steps from the
    program's states, held to the f32 references' steps."""
    return max(float((a - b).abs().max()) for a, b in zip(
        reference_steps(prog, seed, job, TF32), reference_steps(prog, seed, job)))


def _field_control(prog: Program, latent, kept: list) -> float:
    """The reference decoder in TF32, put where K1 gave the kept values."""
    pts = torch.cat([a for a, _ in kept])
    with torch.no_grad():
        ctl = ref_decoder.udf(prog.sd_dec, latent, pts, prog.cfg["decoder"]["max_dist"], TF32)
    return field_gap(prog, latent, [(pts, ctl)])
