"""What the per-layer readers (`metrics/<name>.py`) share: sums over the
window's jobs and the traced job's sessions. Each returns None where the run
holds nothing to read."""

from __future__ import annotations

from . import flops

# K1's kernels by name, with the points one CTA of each evaluates
# (`ops/csrc/folded_mlp.cu`: 32; `folded_mlp_bf16.cu`: 64)
K1_KERNELS = {"folded_mlp_tf32x3_kernel": 32, "folded_mlp_bf16": 64}


def meshes(run: dict) -> list:
    return [m for j in run.get("jobs", []) for m in j.get("meshes", [])]


def mean_stage(run: dict, stage: str):
    vals = [m[1]["times"][stage] for m in meshes(run) if stage in m[1].get("times", {})]
    return sum(vals) / len(vals) if vals else None


def k1(run: dict, which: str = "folded_mlp_tf32x3_kernel"):
    """(points, device seconds) of one K1 kernel in the traced job's
    extraction, from the launch grids; None without a trace or a launch."""
    sess = run.get("traced", {}).get("extract_session")
    if sess is None:
        return None
    pts = ns = 0
    for name, a, b, grid in sess.ops:
        if which in name and grid:
            pts += grid[0] * grid[1] * grid[2] * K1_KERNELS[which]
            ns += b - a
    return (pts, ns / 1e9) if pts else None


def decoder_point_flops(run: dict) -> int:
    d = run["cell"]["config"]["decoder"]
    return flops.decoder_point_flops(d["hidden_dim"], d["num_hidden_layers"])


def traced_wall(run: dict):
    tr = run.get("traced", {})
    return sum(s.wall_s for s in tr.get("sessions", [])) or None


def step_launches(run: dict):
    """Host launch calls per traced train step."""
    tr = run.get("traced", {})
    sessions, steps = tr.get("sessions"), tr.get("steps")
    if not sessions or not steps:
        return None
    return sum(len(s.launches) for s in sessions) / steps


def idle_share(run: dict):
    """The traced wall's share in which no operation ran on the card."""
    from . import trace

    sessions = run.get("traced", {}).get("sessions")
    if not sessions:
        return None
    busy, wall = trace.busy_and_window(sessions)
    return 100.0 * (1.0 - busy / wall) if wall else None


def step_mfu(run: dict):
    """A train step's FLOPs over the window's time per step, of the TF32 peak."""
    if not run.get("steps"):
        return None
    return flops.share(run["step_flops"], run["window_s"] / run["steps"], flops.peak("tf32_flops"))
