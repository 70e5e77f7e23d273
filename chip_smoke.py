"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each fatal on failure:
  1. print the card (nvidia-smi), build the CUDA kernels from ops/csrc and
     the host geometry library from native/ (set-up, outside the timings);
     count the tensor-core (HGMMA) instructions of each kernel with
     cuobjdump: both K1 kernels (f32 3xTF32, bf16) must have some;
  2. each kernel against its plain PyTorch version at main-path shapes
     (max abs error, kernel / plain / library time, bound; for K2 also the
     device-only time per call from torch.profiler); K1 f32 with its
     3xTF32 bound, and in its log line the FP32 bound and the weight bytes
     a call streams if every CTA reads every slab; K1 bf16
     also against folded_udf_mixed_tc, the same math on cuBLAS's tensor
     cores; K2 in
     both layouts it takes (token-major, and the channel-first view the
     attention block hands it, which is the one timed);
  3. sampling: 1000 DDPM steps of the full-width MDM (random weights from a
     seed), B = 2 — K2 must launch 16 x 1000 times;
  4. extraction: the shipped trained sheet decoder at 256^3 with
     surface_bias="auto" through get_mesh_from_udf — the JAX package's bars
     (tests/test_e2e_fixture.py), the face count within 1 % of the JAX
     package's, and K1 on the path, no plain version;
  5. generation at the JAX package's breadth: category CFG sampling with
     the full-width category MDM, guidance 2.5, B = 2 (K2 at B 4), ddim50 —
     DDIM at eta 0 twice (bit-equal), against the port's own CPU run on the
     same weights and noise (max abs <= 1e-3), K2 exactly 800 launches;
     PLMS order 2, K2 exactly 816; the watertight sheet at 256^3 (faces
     within 1 % of the JAX package's, one component, max |v| = 1, K1 f32
     launched); the batch generator, two 256^3 extractions on two latents
     at depth 1 and depth 2, bit-equal;
  6. the AE reconstruction eval at the deepfashion3d preset: the seeded
     DGCNN encoder at 10,000 fixture points against the port's own CPU run
     (kNN neighbour sets equal on >= 99.9 % of rows, latent max abs <=
     1e-4), timed at B 1 and B 8 with its peak memory; one 512^3 extraction
     of the sheet fixture (stage times, faces beside the JAX package's
     count); the export CLI at --config deepfashion3d on a two-item corpus
     (n_empty 0, Chamfer < 0.008 on the sample-only item), then again with
     --resume (the same recon_metrics.json); K1 f32 and bf16 launched, K2 not;
  7. K2's wrapper: host clock per call over 10,000 back-to-back calls, in
     turns with SDPA's;
  8. the generation CLIs write OBJs: generate_uncond (DDPM), generate_cat
     (DDIM, guidance 2.5, two extractions at a time) and generate_uncond
     (PLMS, watertight).

Phases 3-6 are the main path: each runs with the launch counts set to 0
just before it and read just after, and no plain version may run in them.

Not in the default run: `--phases build,profile` (where the time goes, and
device kernels per DDPM step), `--phases build,bars` (the readings behind
both K1 kernels' bars, sound and with planted faults) and `--phases
build,parity` (the sheet at 128^3 on the card against the port's own CPU
run: faces within 1 %, mean NN distance <= 0.1 voxel, the same active
blocks; and the watertight shell within 1 % of the JAX package's faces).

Prints progress lines, then a `{"kernels": [...]}` line, the nvidia-smi line
and, last, `{"ok": true, "device": {...}}`. Precision: TF32 is off for
matmuls and convolutions (float32 reference numerics).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "surfd_tpu", "assets", "bench_sheet_decoder.npz")
PHASES = ("build", "kernels", "sample", "extract", "generate", "recon", "host", "cli")  # default
MAIN_PATH = ("sample", "extract", "generate", "recon")  # counted: launches, no plain version
EXTRA_PHASES = ("profile", "bars", "parity")

# H100 SXM published peaks (dense): HBM bytes/s and FLOP/s by operand type.
HBM_BPS = 3.35e12
# "tf32x3": f32 FLOP/s done as three tf32 products on the tensor cores
# (494.7 TFLOP/s dense TF32 / 3).
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "tf32x3": 494.7e12 / 3}

K1_SRC = {"f32": "surfd_tpu_torch/ops/csrc/folded_mlp.cu",
          "bf16": "surfd_tpu_torch/ops/csrc/folded_mlp_bf16.cu"}
K1_KERNEL = {"f32": "folded_mlp_tf32x3", "bf16": "folded_mlp_bf16"}  # names in the SASS
# K1 f32's bars at 2^20 fixture points: max and mean abs against
# folded_udf_ref, tighter than the 1e-5 max first set, which a missed bias
# passes. PERF.md gives the readings (`--phases bars`) they were set from.
K1_F32_BARS = {"plain_max": 2e-6, "plain_mean": 3e-8}
# K1 bf16's bars at 2^20 fixture points: max and mean abs against
# folded_udf_mixed_tc (same math, tensor-core sums) and max abs against
# folded_udf_mixed_ref (FP32 GEMM sums). PERF.md gives the readings, sound
# and with planted faults (`--phases bars`), that they were set from.
K1_BF16_BARS = {"tc_max": 4e-3, "tc_mean": 2e-7, "plain_max": 4e-3}
K1_TPU = "surfd_tpu/ops/decoder_kernel.py:146 (_decoder_kernel, commit a9ab519^)"
K2_SRC = "surfd_tpu_torch/ops/csrc/qkv_attention.cu"
K2_TPU = "surfd_tpu/ops/attention_kernel.py:32 (_attn_kernel, commit a9ab519^)"
K2_SHAPES = ((32, 28), (16, 56), (8, 112), (4, 112))  # (T, c) at latent 32, 224 ch, 8 heads
# The JAX package's face count for the sheet fixture at 256^3, auto bias
# (surfd_tpu on the CPU, max_batch 2^16; ROADMAP queue 1 item 1). The card
# has no JAX, so the number is kept here.
JAX_FACES_256 = 1_915_484
# The JAX package's watertight face counts (get_watertight_mesh_from_udf, the
# iso-0.01 shell) for the sheet fixture, auto bias, on a CPU; read when the
# port's watertight path was added. It has 456 boundary vertices at 256^3.
JAX_WATERTIGHT_FACES = {128: 297_708, 256: 1_282_846}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, inner: int = 1) -> float:
    """Median over `reps` of CUDA-event time per call, `inner` calls a rep."""
    return time_ms_turns([fn], reps, inner)[0]


def time_ms_turns(fns, reps: int = 20, inner: int = 1) -> list:
    """time_ms of each of fns, their reps taken in turns so that all of them
    see the same host (its speed drifts over a run)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(inner):
                fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e) / inner)
    return [statistics.median(ts) for ts in times]


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def load_fixture_decoder(dev):
    from surfd_tpu_torch.models import CbnDecoder
    from surfd_tpu_torch.utils.convert import load_sheet_fixture, strip_prefix

    fx = load_sheet_fixture(FIXTURE)
    dec = CbnDecoder(len(fx["latent"]), fx["hidden_dim"], fx["num_hidden_layers"])
    dec.load_state_dict(strip_prefix(fx["state_dict"], "decoder."), strict=True)
    return dec.to(dev), fx


def fixture_points(n: int, seed: int, dev) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)
    ).to(dev)


def sass_counts(lib: str, opcode: str) -> dict:
    """Instructions of one opcode in each kernel of a built library."""
    from surfd_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    r = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr.strip()}")
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def phase_build():
    """Set-up: the CUDA kernels (nvcc) and the host geometry library (g++).
    Returns the HGMMA count of each K1 precision's kernels."""
    from surfd_tpu_torch import native
    from surfd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    out = _build.build(verbose=True)
    _build.load()
    log(f"[build] CUDA kernels in {time.perf_counter() - t0:.1f}s")
    for line in out.splitlines():
        if any(k in line for k in ("registers", "spill", "wgmma", "warning")) or line.startswith("=="):
            log("[build]   " + line.strip())
    counts = sass_counts(str(_build.LIB_PATH), "HGMMA")
    for fn, n in counts.items():
        log(f"[build] HGMMA {n:5d}  {fn}")
    hgmma = {prec: sum(n for fn, n in counts.items() if name in fn)
             for prec, name in K1_KERNEL.items()}
    for prec, n in hgmma.items():
        if n == 0:
            raise RuntimeError(f"no HGMMA instruction in {K1_KERNEL[prec]}: "
                               f"K1 {prec} misses the tensor cores")
    t0 = time.perf_counter()
    native.load()
    log(f"[build] native geometry library in {time.perf_counter() - t0:.1f}s")
    return hgmma


def device_us_per_call(fn, name: str, calls: int = 200) -> tuple[float, int]:
    """Device-only time per call of fn, from torch.profiler over `calls`
    back-to-back calls: the mean time of each kernel whose name holds `name`,
    summed over those kernels (each launches once per call). Also returns the
    fewest launches the profiler recorded of any of them, since it can drop
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key and _device_us(e) > 0]
    if not evts:
        raise RuntimeError(f"profiler saw no device time for kernels named {name!r}")
    return sum(_device_us(e) / e.count for e in evts), min(e.count for e in evts)


def phase_kernels(dev, hgmma=None):
    """K1 (f32, bf16) and K2 (four shapes, B = 1, 2 and 4) against plain versions."""
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.ops import decoder_kernel as dk

    rows = []
    dec, fx = load_fixture_decoder(dev)
    folded = dk.fold_decoder(dec, torch.from_numpy(fx["latent"]).to(dev), fx["max_dist"])
    H, L = folded.hidden, folded.layers
    P = 1 << 20
    pts = fixture_points(P, 0, dev)
    macs = 63 * H + L * 2 * H * H + H
    for prec, plain, lib in (
        ("f32", lambda: dk.folded_udf_ref(folded, pts),
         lambda: dk.folded_udf_ref(folded, pts)),  # cuBLAS f32 chain
        ("bf16", lambda: dk.folded_udf_mixed_ref(folded, pts),
         lambda: dk.folded_udf_ref(folded, pts, torch.bfloat16)),  # cuBLAS bf16 chain
    ):
        got = dk.folded_udf(folded, pts, prec)
        want = plain()
        torch.cuda.synchronize()
        extra = {"hgmma": (hgmma or {}).get(prec)}
        if prec == "f32":
            read, bars_in_force = readings(got, {"plain": want}), K1_F32_BARS
            extra["mean_abs_err"] = read["plain_mean"]
        else:
            read = readings(got, {"tc": dk.folded_udf_mixed_tc(folded, pts), "plain": want})
            bars_in_force = K1_BF16_BARS
            extra.update(tc_max_abs_err=read["tc_max"], tc_mean_abs_err=read["tc_mean"])
        err = read["plain_max"]
        over = {k: v for k, v in read.items() if k in bars_in_force and not v <= bars_in_force[k]}
        if over:
            raise RuntimeError(f"K1 {prec}: {over} over the bars {bars_in_force}")
        bars = ", ".join(f"{k} {v:.3g}" + (f" (bar {bars_in_force[k]:.3g})" if k in bars_in_force else "")
                         for k, v in read.items())
        ms = time_ms(lambda: dk.folded_udf(folded, pts, prec), reps=10)
        plain_ms = time_ms(plain, reps=5)
        lib_ms = time_ms(lib, reps=5)
        wbytes = (63 * H + 2 * L * H * H + H) * (4 if prec == "f32" else 2) + (6 * L + 3) * H * 4
        b_ms, b_by = bound(P * 16 + wbytes, 2.0 * macs * P, "tf32x3" if prec == "f32" else prec)
        note = ""
        if prec == "f32":
            # log only: the FP32-pipe bound, for rows from before 3xTF32, and
            # the weight bytes a call streams if every 32-point CTA reads
            # every slab (pack_afrag, padded) — assumed, not a counter reading
            fp32_ms, _ = bound(P * 16 + wbytes, 2.0 * macs * P, "f32")
            pk = folded.packed("f32")
            l2_bytes = -(-P // 32) * 4 * (pk.w_in.numel() + pk.w1.numel() + pk.w2.numel())
            note = (f" FP32 bound {fp32_ms:.3f} ms; weight stream from L2, assumed "
                    f"{l2_bytes / 1e9:.1f} GB, effective {l2_bytes / ms / 1e9:.2f} TB/s")
        rows.append({
            "name": f"folded_mlp_{prec}", "route": "cuda", "source": K1_SRC[prec],
            "replaces": K1_TPU, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": f"P={P} H={H} L={L}", **extra,
        })
        log(f"[kernels] K1 {prec}: {bars}; kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms cuBLAS {lib_ms:.3f} ms bound {b_ms:.3f} ms ({b_by});"
            + note)
    del pts, got, want

    heads = 8
    rng = np.random.default_rng(1)
    k2_calls = {}
    for T, c in K2_SHAPES:
        for B in (1, 2, 4):  # B 4: the CFG pass of B 2
            qkv = torch.from_numpy(
                rng.normal(size=(B, T, 3 * heads * c)).astype(np.float32)
            ).to(dev)
            # the main path's layout: the (B, T, W) view of the conv's (B, W, T) output
            qkv_cf = qkv.transpose(1, 2).contiguous().transpose(1, 2)
            errs = {}
            for layout, x in (("token-major", qkv), ("channel-first", qkv_cf)):
                got = ak.qkv_attention(x, heads)
                want = ak.qkv_attention_ref(x, heads)
                torch.cuda.synchronize()
                if got.stride() != want.stride():
                    raise RuntimeError(f"K2 {layout} T={T} c={c} B={B}: output strides "
                                       f"{got.stride()}, plain {want.stride()}")
                errs[layout] = float((got - want).abs().max())
                if not errs[layout] <= 2e-5:
                    raise RuntimeError(f"K2 {layout} T={T} c={c} B={B}: max abs err "
                                       f"{errs[layout]} > 2e-5")
            if B != 2:
                continue
            err = max(errs.values())
            q, k, v = (t.permute(0, 2, 1, 3) for t in
                       qkv.reshape(B, T, heads, 3 * c).split(c, dim=-1))
            sdpa = lambda q=q, k=k, v=v: torch.nn.functional.scaled_dot_product_attention(q, k, v)
            kern = lambda x=qkv_cf: ak.qkv_attention(x, heads)
            ms, tok_ms, lib_ms = time_ms_turns(
                [kern, lambda: ak.qkv_attention(qkv, heads), sdpa], inner=200)
            plain_ms = time_ms(lambda: ak.qkv_attention_ref(qkv_cf, heads), inner=50)
            k2_calls[f"qkv_attention_T{T}_c{c}"] = (kern, sdpa)
            flops = B * heads * (4.0 * T * T * c + 5.0 * T * T)
            b_ms, b_by = bound(4.0 * B * T * 4 * heads * c, flops, "f32")
            rows.append({
                "name": f"qkv_attention_T{T}_c{c}", "route": "cuda", "source": K2_SRC,
                "replaces": K2_TPU, "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "shape": f"B={B} T={T} H={heads} c={c} channel-first",
                "token_major_ms": tok_ms,
            })
            log(f"[kernels] K2 T={T} c={c} B={B}: err token-major {errs['token-major']:.3g} "
                f"channel-first {errs['channel-first']:.3g}; kernel {ms * 1e3:.2f} us "
                f"(token-major {tok_ms * 1e3:.2f} us) plain {plain_ms * 1e3:.2f} us "
                f"SDPA {lib_ms * 1e3:.2f} us bound {b_ms * 1e3:.3f} us ({b_by})")
    return rows, k2_calls


def k2_device_times(rows, k2_calls):
    """K2's and SDPA's device-only time per call (torch.profiler), into the
    K2 rows. Run after the main path, so that no profiler session comes
    before its timings."""
    for row in rows:
        if row["name"] not in k2_calls:
            continue
        kern, sdpa = k2_calls[row["name"]]
        row["device_us"], n_k2 = device_us_per_call(kern, "qkv_attention")
        # every kernel SDPA launches
        row["library_device_us"], n_sdpa = device_us_per_call(sdpa, "")
        log(f"[kernels] {row['name']} device-only: K2 {row['device_us']:.2f} us, "
            f"SDPA {row['library_device_us']:.2f} us (event-timed {row['ms'] * 1e3:.2f} / "
            f"{row['library_ms'] * 1e3:.2f} us; launches recorded {n_k2} / {n_sdpa} of 200)")


def planted_faults(folded, prec):
    """Folds edited the way a bug in K1 `prec` would act, each to be run
    through the kernel itself and held to the bars of the unedited fold."""
    from surfd_tpu_torch.ops import decoder_kernel as dk

    L = folded.layers

    def edit(name, i, fn):
        t = getattr(folded, name).clone()
        fn(t[i])
        return dataclasses.replace(folded, **{name: t})  # a copy packs anew

    if prec == "f32":
        def ulp(w):  # one weight one f32 ulp off
            w[0, 0] = torch.nextafter(w[0, 0], torch.full_like(w[0, 0], float("inf")))

        return [
            ("one layer's W1 rounded to tf32 (its W_lo products dropped)",
             edit("w1", L // 2, lambda w: w.copy_(dk.round_tf32(w)))),
            ("one k8 step of one M tile zeroed", edit("w1", L // 2, lambda w: w[8:16, 64:128].zero_())),
            ("one bias missed", edit("b2", L - 1, lambda b: b.zero_())),
            ("one weight one f32 ulp off", edit("w1", 0, ulp)),
        ]

    def swap(w):  # two B-operand core matrices (8 k x 8 n) trade places
        w[0:8, 0:16] = torch.cat([w[0:8, 8:16], w[0:8, 0:8]], dim=1)

    def ulp(w):  # one weight one bf16 ulp off
        w[0, 0] = w[0, 0].to(torch.bfloat16).float() * (1 + 2.0 ** -7)

    return [
        ("one k16 step of one warpgroup skipped", edit("w1", L // 2, lambda w: w[16:32, :128].zero_())),
        ("two core matrices swapped", edit("w2", L - 1, swap)),
        ("one bias missed", edit("b2", L - 1, lambda b: b.zero_())),
        ("one weight one bf16 ulp off", edit("w1", 0, ulp)),
    ]


def readings(got, refs) -> dict:
    """Max and mean abs difference of got from each named reference."""
    read = {}
    for name, ref in refs.items():
        d = (got - ref).abs()
        read[f"{name}_max"], read[f"{name}_mean"] = float(d.max()), float(d.mean())
    return read


def phase_bars(dev):
    """Readings behind K1's bars (not part of the default run), on the sheet
    fixture at 2^20 points. K1 f32: the kernel against folded_udf_ref for
    three point seeds, then, on seed 0, the kernel run on each planted
    fault. K1 bf16: the kernel against folded_udf_mixed_tc and
    folded_udf_mixed_ref for three point seeds; then, on seed 0, the two
    plain versions against each other, the f32 math (no bf16 rounding) and
    the kernel run on each planted fault."""
    from surfd_tpu_torch.ops import decoder_kernel as dk

    dec, fx = load_fixture_decoder(dev)
    folded = dk.fold_decoder(dec, torch.from_numpy(fx["latent"]).to(dev), fx["max_dist"])

    def report(label, got, refs, bars):
        read = readings(got, refs)
        for name, ref in refs.items():
            log(f"[bars] {label} vs {name}: max {read[name + '_max']!r} "
                f"mean {read[name + '_mean']!r} "
                f"above 2e-4 {int(((got - ref).abs() > 2e-4).sum())}")
        over = [k for k, bar in bars.items() if k in read and not read[k] <= bar]
        log(f"[bars] {label}: " + (f"over the bars {over}" if over else "within the bars"))

    for seed in (0, 1, 2):
        pts = fixture_points(1 << 20, seed, dev)
        refs = {"plain": dk.folded_udf_ref(folded, pts)}
        report(f"seed {seed} K1 f32", dk.folded_udf(folded, pts, "f32"), refs, K1_F32_BARS)
        if seed == 0:
            for name, fault in planted_faults(folded, "f32"):
                report(f"f32 fault: {name}", dk.folded_udf(fault, pts, "f32"), refs, K1_F32_BARS)
        refs = {"tc": dk.folded_udf_mixed_tc(folded, pts),
                "plain": dk.folded_udf_mixed_ref(folded, pts)}
        report(f"seed {seed} K1 bf16", dk.folded_udf(folded, pts, "bf16"), refs, K1_BF16_BARS)
        if seed:
            continue
        report("tc", refs["tc"], {"plain": refs["plain"]}, K1_BF16_BARS)
        report("fault: f32 math", dk.folded_udf_ref(folded, pts), refs, K1_BF16_BARS)
        for name, fault in planted_faults(folded, "bf16"):
            report(f"fault: {name}", dk.folded_udf(fault, pts, "bf16"), refs, K1_BF16_BARS)


# Kernel launches that a path's subprocesses reported, by row name.
CHILD_LAUNCHES: collections.Counter = collections.Counter()


def reset_counts():
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.ops import decoder_kernel as dk

    CHILD_LAUNCHES.clear()
    dk.folded_udf.launches.update(f32=0, bf16=0)
    ak.qkv_attention.launches.clear()
    dk.folded_udf_ref.calls = 0
    dk.folded_udf_mixed_ref.calls = 0
    ak.qkv_attention_ref.calls = 0


def launch_counts() -> dict:
    """Kernel launches since reset_counts(), by the kernels line's row
    names: this process's and those its subprocesses reported."""
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.ops import decoder_kernel as dk

    counts = collections.Counter({f"folded_mlp_{p}": n for p, n in dk.folded_udf.launches.items()})
    counts.update({f"qkv_attention_T{T}_c{c}": n
                   for (T, c), n in ak.qkv_attention.launches.items()})
    counts.update(CHILD_LAUNCHES)
    return dict(counts)


def plain_calls() -> int:
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.ops import decoder_kernel as dk

    return dk.folded_udf_ref.calls + dk.folded_udf_mixed_ref.calls + ak.qkv_attention_ref.calls


def phase_sample(dev):
    from surfd_tpu_torch.diffusion import named_schedule
    from surfd_tpu_torch.models import MDM
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.pipelines import sample_latents

    mdm = MDM(cond_mode="no_cond")
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    mdm.to(dev)
    sched = named_schedule("cosine", 1000)
    before = sum(ak.qkv_attention.launches.values())
    g = torch.Generator(device=dev).manual_seed(10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        lat = sample_latents(sched, mdm, 2, 32, g, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = sum(ak.qkv_attention.launches.values()) - before
    if tuple(lat.shape) != (2, 32) or not bool(torch.isfinite(lat).all()):
        raise RuntimeError(f"latents bad: shape {tuple(lat.shape)}")
    if n != 16 * 1000:
        raise RuntimeError(f"K2 launched {n} times in sampling, want 16000")
    log(f"[sample] 1000 DDPM steps, B=2, full-width MDM: {dt:.2f}s, K2 launches {n}, "
        f"latent std {float(lat.std()):.3f}")
    return {"sample_s": dt}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0)))


def _profiled(label, fn, steps=None):
    """Wall time of fn without the profiler, then its device kernels under
    torch.profiler: device busy share = summed kernel time / that wall time
    (the profiler's own host overhead stays out of the wall time). With
    `steps`, also the device kernels launched per step (copies and memsets
    apart)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us == 0:
        log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device time not measured")
        return
    log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, kernels {busy_us / 1e3:.1f} ms, "
        f"device busy {100 * busy_us / wall_us:.1f}%")
    if steps:
        launched = sum(e.count for e in kernels if not e.key.startswith(("Memcpy", "Memset")))
        log(f"[profile] {label}: device kernels launched per step {launched / steps:.2f} "
            f"({launched} in {steps} steps)")
    for e in sorted(kernels, key=_device_us, reverse=True)[:6]:
        log(f"[profile]   {_device_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")


def phase_profile(dev):
    """Where the time goes (not part of the default run): 20 DDPM steps of
    the full-width MDM at B = 2, and one 256^3 sheet extraction."""
    from surfd_tpu_torch.diffusion import named_schedule, p_sample
    from surfd_tpu_torch.models import MDM
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf, make_udf_fn

    mdm = MDM(cond_mode="no_cond")
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    mdm.to(dev)
    sched = named_schedule("cosine", 1000)
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((2, 32, 1), generator=g, device=dev)

    def steps(n, x=x):
        with torch.no_grad():
            for t in range(999, 999 - n, -1):
                x, _ = p_sample(sched, mdm, x, t, torch.randn(x.shape, generator=g, device=dev),
                                clip_denoised=False)
        return x

    steps(5)  # warm up
    _profiled("sample, 20 DDPM steps", lambda: steps(20), steps=20)
    dec, fx = load_fixture_decoder(dev)
    udf_fn = make_udf_fn(dec, None, torch.from_numpy(fx["latent"]), fx["max_dist"], device=dev)
    cfg = MeshExtractionConfig(resolution=256, surface_bias="auto")
    get_mesh_from_udf(udf_fn, cfg=cfg)  # warm up (band calibration, native library)
    _profiled("extract 256^3 sheet", lambda: get_mesh_from_udf(udf_fn, cfg=cfg))


def phase_host(dev, calls: int = 10_000, rounds: int = 3):
    """K2 wrapper's host cost: host clock over `calls` back-to-back calls at
    T 32, c 28, B 2 that synchronise once at the end, in `rounds` turns of
    token-major, SDPA on the same values (PyTorch's own call, for scale) and
    channel-first."""
    from surfd_tpu_torch.ops import attention_kernel as ak

    B, T, H, c = 2, 32, 8, 28
    qkv = torch.from_numpy(
        np.random.default_rng(4).normal(size=(B, T, 3 * H * c)).astype(np.float32)
    ).to(dev)
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.reshape(B, T, H, 3 * c).split(c, dim=-1))
    qkv_cf = qkv.transpose(1, 2).contiguous().transpose(1, 2)
    calls_by = {
        "K2 token-major": lambda: ak.qkv_attention(qkv, H),
        "SDPA": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
        "K2 channel-first": lambda: ak.qkv_attention(qkv_cf, H),
    }
    for rnd in range(rounds):
        for label, fn in calls_by.items():
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            us = (time.perf_counter() - t0) / calls * 1e6
            log(f"[host] round {rnd} {label} T={T} c={c} B={B}: {us:.3f} us per call "
                f"over {calls} calls")


def phase_extract(dev):
    from surfd_tpu_torch.geometry.metrics import chamfer_distance
    from surfd_tpu_torch.ops import decoder_kernel as dk
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf, make_udf_fn

    dec, fx = load_fixture_decoder(dev)
    before = dict(dk.folded_udf.launches)
    t0 = time.perf_counter()
    udf_fn = make_udf_fn(dec, None, torch.from_numpy(fx["latent"]), fx["max_dist"], device=dev)
    mesh, stats = get_mesh_from_udf(
        udf_fn, cfg=MeshExtractionConfig(resolution=256, surface_bias="auto"),
        return_stats=True,
    )
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1 = {k: dk.folded_udf.launches[k] - before[k] for k in before}
    if stats["oob_vertices"] != 0:
        raise RuntimeError(f"{stats['oob_vertices']} out-of-domain vertices")
    if stats["face_explosion"]:
        raise RuntimeError(f"face explosion: ratio {stats['face_budget_ratio']}")
    if len(mesh.faces) <= 10_000:
        raise RuntimeError(f"only {len(mesh.faces)} faces")
    face_gap = abs(len(mesh.faces) - JAX_FACES_256) / JAX_FACES_256
    if not face_gap <= 0.01:
        raise RuntimeError(f"{len(mesh.faces)} faces, {100 * face_gap:.3f} % off the JAX "
                           f"package's {JAX_FACES_256}")
    if np.abs(mesh.vertices).max() > 1.0 + 4.0 / 255:
        raise RuntimeError("vertices outside the domain")
    sub = mesh.vertices[np.random.default_rng(0).choice(
        len(mesh.vertices), min(20_000, len(mesh.vertices)), replace=False)]
    cd = chamfer_distance(sub, fx["surface_samples"])
    if not cd < 0.008:
        raise RuntimeError(f"chamfer {cd} >= 0.008")
    if k1["f32"] == 0:
        raise RuntimeError("K1 (f32) never launched during extraction")
    log(f"[extract] 256^3 sheet: {len(mesh.vertices)} verts / {len(mesh.faces)} faces "
        f"({100 * face_gap:.4f} % off JAX's {JAX_FACES_256}), chamfer {cd:.5f}, oob 0, face ratio {stats['face_budget_ratio']}, "
        f"K1 launches {k1}, ff_unsure {stats.get('ff_unsure')}, {dt:.2f}s")
    # tier 1 of the face filter runs while band < threshold / 4 = 1 / (4 R)
    log(f"[extract] two-tier filter: band {stats['ff_band']!r}, threshold "
        f"{stats['ff_threshold']!r}, tier 1 {'on' if stats['ff_two_tier'] else 'off'} "
        f"(on for resolutions below {0.25 / stats['ff_band']:.1f})")
    log(f"[extract] times {json.dumps(stats['times'])}")
    return {"extract_s": dt, "chamfer": cd, "faces": len(mesh.faces)}


CFG_STEPS = "ddim50"  # category CFG sampling: cosine 1000 respaced to 50 DDIM steps
CFG_ACTIONS = (1, 4)  # one class per sample, B = 2; guidance makes the pass B 4


def category_mdm():
    """The full-width category MDM (9 classes) with random weights from seed
    0, on the CPU."""
    from surfd_tpu_torch.models import MDM

    mdm = MDM(cond_mode="category", num_actions=9)
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    return mdm.eval()


def cfg_sample(mdm, sampler: str, dev):
    """(B, 32) latents of the CFG denoiser (guidance 2.5) on `dev`, over the
    ddim50 schedule, from injected noise (numpy seed 20); DDIM at eta 0 or
    PLMS of order 2. Returns the latents and the wall time."""
    from surfd_tpu_torch.diffusion import named_beta_schedule, space_timesteps, spaced_schedule
    from surfd_tpu_torch.models import make_cfg_model_fn
    from surfd_tpu_torch.pipelines import sample_latents

    sched = spaced_schedule(named_beta_schedule("cosine", 1000), space_timesteps(1000, CFG_STEPS))
    B, L = len(CFG_ACTIONS), 32
    rng = np.random.default_rng(20)
    noise = torch.from_numpy(rng.normal(size=(B, L, 1)).astype(np.float32))
    steps = torch.from_numpy(
        rng.normal(size=(sched.num_timesteps, B, L, 1)).astype(np.float32))
    action = torch.tensor(CFG_ACTIONS, dtype=torch.int64, device=dev)
    model_fn = make_cfg_model_fn(mdm, 2.5, action=action)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = sample_latents(sched, model_fn, B, L, sampler=sampler, device=dev,
                         noise=noise.to(dev),
                         step_noise=None if sampler == "plms" else steps.to(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return lat, time.perf_counter() - t0


def boundary_vertices(mesh) -> int:
    """Vertices on an edge that only one face has."""
    f = mesh.faces
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    keys, counts = np.unique(e[:, 0] * len(mesh.vertices) + e[:, 1], return_counts=True)
    once = keys[counts == 1]
    return len(np.unique(np.concatenate([once // len(mesh.vertices), once % len(mesh.vertices)])))


def phase_generate(dev, cfg_ref):
    """Generation at the JAX package's breadth (phase 5): category CFG DDIM
    and PLMS at full width, the watertight sheet at 256^3 and the batch
    generator at depth 1 and 2. `cfg_ref`: the CPU run's DDIM latents."""
    from surfd_tpu_torch.geometry.mesh_ops import face_components
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.ops import decoder_kernel as dk
    from surfd_tpu_torch.pipelines import (
        MeshExtractionConfig,
        generate_meshes_pipelined,
        get_watertight_mesh_from_udf,
        make_udf_fn,
    )

    def counted(sampler, want):
        """One CFG run on the card and its K2 launches, which must be `want`."""
        n0 = sum(ak.qkv_attention.launches.values())
        lat, dt = cfg_sample(mdm, sampler, dev)
        n = sum(ak.qkv_attention.launches.values()) - n0
        if n != want:
            raise RuntimeError(f"K2 launched {n} times in one {sampler} run, want {want}")
        return lat, dt

    mdm = category_mdm().to(dev)
    (a, ta), (b, tb) = counted("ddim", 16 * 50), counted("ddim", 16 * 50)
    if not torch.equal(a, b):
        raise RuntimeError(f"two DDIM runs differ: max {float((a - b).abs().max())}")
    err = float((a.cpu() - cfg_ref).abs().max())
    if not err <= 1e-3:
        raise RuntimeError(f"DDIM card vs CPU: max abs {err} > 1e-3")
    log(f"[generate] category CFG 2.5, B=2 (K2 at B 4), DDIM eta 0 over {CFG_STEPS}: "
        f"{ta:.2f}s / {tb:.2f}s, bit-equal, card vs CPU max abs {err!r}, K2 launches "
        f"800 each, latent std {float(a.std()):.3f}")
    # order 2: a second model call on the first step
    lat, tp = counted("plms", 16 * 51)
    if tuple(lat.shape) != (2, 32) or not bool(torch.isfinite(lat).all()):
        raise RuntimeError(f"PLMS latents bad: shape {tuple(lat.shape)}")
    log(f"[generate] PLMS order 2 over the same 50 steps: {tp:.2f}s, K2 launches 816, "
        f"latent std {float(lat.std()):.3f}")
    out = {"ddim_s": [ta, tb], "plms_s": tp, "ddim_card_vs_cpu": err}

    dec, fx = load_fixture_decoder(dev)
    cfg = MeshExtractionConfig(resolution=256, surface_bias="auto")
    f32_0 = dk.folded_udf.launches["f32"]
    udf_fn = make_udf_fn(dec, None, torch.from_numpy(fx["latent"]), fx["max_dist"], device=dev)
    t0 = time.perf_counter()
    mesh, stats = get_watertight_mesh_from_udf(udf_fn, cfg, return_stats=True)
    dt = time.perf_counter() - t0
    want = JAX_WATERTIGHT_FACES[256]
    gap = abs(len(mesh.faces) - want) / want
    comps = int(face_components(mesh.faces, len(mesh.vertices)).max()) + 1
    vmax = float(np.abs(mesh.vertices).max())
    if not gap <= 0.01:
        raise RuntimeError(f"watertight: {len(mesh.faces)} faces, {100 * gap:.3f} % off "
                           f"the JAX package's {want}")
    if comps != 1 or vmax != 1.0:
        raise RuntimeError(f"watertight: {comps} components, max |v| {vmax}")
    if dk.folded_udf.launches["f32"] == f32_0:
        raise RuntimeError("K1 (f32) never launched in the watertight fill")
    log(f"[generate] watertight 256^3 sheet: {len(mesh.vertices)} verts / {len(mesh.faces)} "
        f"faces ({100 * gap:.4f} % off JAX's {want}), {comps} component, max |v| {vmax}, "
        f"boundary vertices {boundary_vertices(mesh)} (JAX 456), {dt:.2f}s, "
        f"times {json.dumps(stats['times'])}")
    out["watertight_faces"] = len(mesh.faces)

    perturbed = fx["latent"] + 0.02 * np.random.default_rng(1).normal(
        size=fx["latent"].shape).astype(np.float32)
    lats = [torch.from_numpy(fx["latent"]), torch.from_numpy(perturbed)]
    meshes, walls = {}, {}
    for depth in (1, 2):
        fns = (make_udf_fn(dec, None, lat, fx["max_dist"], device=dev) for lat in lats)
        t0 = time.perf_counter()
        meshes[depth] = list(generate_meshes_pipelined(fns, cfg, depth=depth))
        walls[depth] = time.perf_counter() - t0
    for k, (m1, m2) in enumerate(zip(meshes[1], meshes[2])):
        if not (np.array_equal(m1.vertices, m2.vertices) and np.array_equal(m1.faces, m2.faces)):
            raise RuntimeError(f"batch: mesh {k} at depth 2 differs from depth 1")
    m0, m1 = meshes[1]
    if m0.vertices.shape == m1.vertices.shape and np.array_equal(m0.vertices, m1.vertices):
        raise RuntimeError("batch: the two latents gave the same mesh")
    log(f"[generate] batch, two 256^3 extractions ({len(meshes[1][0].faces)} and "
        f"{len(meshes[1][1].faces)} faces): depth 1 {walls[1]:.2f}s, depth 2 {walls[2]:.2f}s, "
        f"bit-equal")
    out["batch_s"] = walls
    return out


# The AE reconstruction eval at the deepfashion3d preset
# (surfd_tpu_torch/assets/configs/deepfashion3d.json): 10,000 encoder points,
# batch 8 in training, 512^3.
RECON_POINTS, RECON_BATCH, RECON_K = 10_000, 8, 20
# The card's encoder latent against the port's CPU run: between the sound
# reading (2.78e-5) and the TF32 switches left on (1.27e-4), both read on
# an NVIDIA H100 80GB HBM3 at 700 W.
RECON_LATENT_BAR = 6e-5
RECON_KNN_BAR = 0.999  # share of rows whose neighbour sets equal the CPU run's
# The JAX package's face count for the sheet fixture at 512^3, auto bias
# (BENCH_r05.json; a count, not a time). The JAX tree may have moved since.
JAX_FACES_512 = 11_069_489


def seeded_encoder():
    """Dgcnn(size_latent 32, k 20) with random weights from seed 3, on the CPU."""
    from surfd_tpu_torch.models import Dgcnn

    return Dgcnn(32, k=RECON_K).random_init_(torch.Generator().manual_seed(3))


def encoder_clouds(n: int) -> torch.Tensor:
    """n draws of RECON_POINTS of the fixture's 20,000 surface samples, (n, N, 3)."""
    from surfd_tpu_torch.data import random_point_sampling
    from surfd_tpu_torch.utils.convert import load_sheet_fixture

    samples = load_sheet_fixture(FIXTURE)["surface_samples"]
    rng = np.random.default_rng(5)
    return torch.from_numpy(np.stack(
        [random_point_sampling(samples, RECON_POINTS, rng) for _ in range(n)]))


def encoder_reference():
    """The port's own CPU run of the seeded encoder on the first cloud:
    kNN indices, latent and wall time."""
    from surfd_tpu_torch.models import knn_indices

    pts = encoder_clouds(1)
    t0 = time.perf_counter()
    with torch.no_grad():
        idx, lat = knn_indices(pts, RECON_K), seeded_encoder()(pts)
    return idx, lat, time.perf_counter() - t0


def dgcnn_flat(enc) -> dict:
    """The encoder's weights in the JAX package's flat-key npz layout
    (`ae_encoder.npz`: `params/...`, `batch_stats/...`)."""
    out = {}
    for i, name in enumerate([f"block{j}" for j in range(1, 5)] + ["head"], 1):
        conv, bn = getattr(enc, f"conv_{i}"), getattr(enc, f"bn_{i}")
        out[f"params/{name}_conv/kernel"] = conv.weight.detach().cpu().numpy().T
        out[f"params/{name}_bn/scale"] = bn.weight.detach().cpu().numpy()
        out[f"params/{name}_bn/bias"] = bn.bias.detach().cpu().numpy()
        out[f"batch_stats/{name}_bn/mean"] = bn.running_mean.cpu().numpy()
        out[f"batch_stats/{name}_bn/var"] = bn.running_var.cpu().numpy()
    return out


def write_recon_corpus(root: str, dev) -> None:
    """ae/ (the fixture decoder; the seeded encoder with its head planted:
    BatchNorm scale 1e-3 and shift the fixture latent, all positive, so the
    encoder outputs the fixture latent plus a small input-dependent term)
    and data/test/ with two items, both the fixture's 20,000 samples as
    their cloud; skirt_001 also carries a ground-truth mesh, the port's
    256^3 extraction of the fixture latent on the card."""
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf, make_udf_fn

    ae, data = os.path.join(root, "ae"), os.path.join(root, "data", "test")
    os.makedirs(ae)
    os.makedirs(data)
    with np.load(FIXTURE) as z:
        np.savez(os.path.join(ae, "ae_decoder.npz"),
                 **{k[4:]: np.asarray(z[k], np.float32) for k in z.files if k.startswith("dec/")})
    dec, fx = load_fixture_decoder(dev)
    enc = seeded_encoder()
    with torch.no_grad():
        enc.bn_5.weight.fill_(1e-3)
        enc.bn_5.bias.copy_(torch.from_numpy(fx["latent"]))
    np.savez(os.path.join(ae, "ae_encoder.npz"), **dgcnn_flat(enc))
    gt = get_mesh_from_udf(make_udf_fn(dec, None, torch.from_numpy(fx["latent"]),
                                       fx["max_dist"], device=dev),
                           MeshExtractionConfig(resolution=256, surface_bias="auto"))
    small = {"coords": np.zeros((8, 3), np.float32), "labels": np.zeros(8, np.float32),
             "gradients": np.zeros((8, 3), np.float32)}
    pcd = fx["surface_samples"]
    np.savez(os.path.join(data, "dress_000.npz"), pcd=pcd, **small)
    np.savez(os.path.join(data, "skirt_001.npz"), pcd=pcd, vertices=gt.vertices,
             triangles=gt.faces.astype(np.int32), **small)


def phase_recon(dev, enc_ref):
    """The AE reconstruction eval at the deepfashion3d preset: (a) the
    seeded encoder at 10,000 points against the port's CPU run and timed at
    B 1 and B 8; (b) one direct 512^3 extraction of the sheet fixture;
    (c) the export CLI at --config deepfashion3d on a two-item corpus,
    then again with --resume. `enc_ref`: encoder_reference()."""
    from surfd_tpu_torch.cli.export_meshes import K1_CALLS
    from surfd_tpu_torch.geometry.metrics import chamfer_distance
    from surfd_tpu_torch.models import dgcnn
    from surfd_tpu_torch.ops import decoder_kernel as dk
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf, make_udf_fn
    from surfd_tpu_torch.utils import use_full_f32

    out = {}
    idx_ref, lat_ref, _ = enc_ref
    enc = seeded_encoder().to(dev)
    clouds = encoder_clouds(RECON_BATCH).to(dev)

    def against_cpu(label, cloud, ref):
        """kNN sets and latent of the card's encoder on `cloud` (1, N, 3)
        against the CPU run's `ref` (indices, latent): (indices, rows
        equal, share equal, latent max abs)."""
        with torch.no_grad():
            idx, lat = dgcnn.knn_indices(cloud, RECON_K).cpu(), enc(cloud).cpu()
        same = (np.sort(idx.numpy(), -1) == np.sort(ref[0].numpy(), -1)).all(-1)
        n_same, share = int(same.sum()), float(same.mean())
        err = float((lat - ref[1]).abs().max())
        log(f"[recon] encoder{label}, {RECON_POINTS} points, k {RECON_K}: kNN sets equal to the "
            f"CPU run's on {n_same} of {same.size} rows ({100 * share:.3f} %, bar "
            f"{100 * RECON_KNN_BAR:g} %), latent max abs {err!r} (bar {RECON_LATENT_BAR:g}), "
            f"latent max |x| {float(lat.abs().max()):.4f}")
        return idx, same, share, err

    idx, same, share, err = against_cpu("", clouds[:1], (idx_ref, lat_ref))
    # where the sets differ: the float64 squared distances of the
    # neighbours only one side chose (0 means exact ties at the k-th place)
    p64, gaps = clouds[0].double().cpu().numpy(), []
    for r in np.flatnonzero(~same[0]):
        a, b = idx[0, r].numpy(), idx_ref[0, r].numpy()
        d = [np.sort(((p64[np.setdiff1d(x, y)] - p64[r]) ** 2).sum(-1)) for x, y in
             ((a, b), (b, a))]
        gaps.append(float(np.abs(d[0] - d[1]).max()))
    if gaps:
        log(f"[recon] rows with other neighbour sets: {len(gaps)}; max |difference| of the "
            f"swapped neighbours' float64 squared distances {max(gaps)!r}")
    if not (share >= RECON_KNN_BAR and err <= RECON_LATENT_BAR):
        raise RuntimeError("recon: the card's encoder is off the CPU run's bars")
    # The fixture's samples are stored in f16, so each coordinate is a tf32
    # value and a TF32 Gram would sum the same exact products. A second
    # cloud, the first plus uniform jitter of 1e-4, is not: the sound
    # encoder is held to the bars on it too, and a TF32 Gram is planted there.
    jittered = clouds[:1].cpu() + torch.from_numpy(np.random.default_rng(6).uniform(
        -1e-4, 1e-4, (1, RECON_POINTS, 3)).astype(np.float32))
    with torch.no_grad():
        ref_j = dgcnn.knn_indices(jittered, RECON_K), seeded_encoder()(jittered)
    jittered = jittered.to(dev)
    _, _, share_j, err_j = against_cpu(" on the jittered cloud", jittered, ref_j)
    out["jittered"] = {"knn_share": share_j, "latent_err": err_j}
    if not (share_j >= RECON_KNN_BAR and err_j <= RECON_LATENT_BAR):
        raise RuntimeError("recon: the card's encoder is off the CPU run's bars (jittered cloud)")
    # Planted faults the bars must reject: (i) torch's TF32 switches left on
    # (cuBLAS may then run the edge Dense and the Gram in TF32), on the
    # fixture cloud; (ii) a tensor-core TF32 Gram (operands rounded to tf32,
    # f32 sums, the norms in f32), on the jittered cloud.
    knn_f32 = dgcnn.knn_indices

    def knn_tf32_gram(points, k):
        r, sq = dk.round_tf32(points), (points * points).sum(-1)
        d = torch.bmm(r, r.transpose(1, 2)).mul_(-2.0).add_(sq[:, :, None]).add_(sq[:, None, :])
        return torch.topk(d, k, dim=-1, largest=False).indices

    for label, tf32, knn, cloud, ref in (
            (" with the TF32 switches on (planted fault)", True, knn_f32, clouds[:1],
             (idx_ref, lat_ref)),
            (" on the jittered cloud with a TF32 Gram (planted fault)", False, knn_tf32_gram,
             jittered, ref_j)):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        dgcnn.knn_indices = knn
        try:
            _, _, f_share, f_err = against_cpu(label, cloud, ref)
        finally:
            dgcnn.knn_indices = knn_f32
            use_full_f32()
        out.setdefault("tf32_faults", []).append({"fault": label, "knn_share": f_share,
                                                  "latent_err": f_err})
        if f_share >= RECON_KNN_BAR and f_err <= RECON_LATENT_BAR:
            raise RuntimeError(f"recon: the encoder's bars pass a planted fault:{label}")
    del jittered
    with torch.no_grad():
        for B in (1, RECON_BATCH):
            x = clouds[:B]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: enc(x), reps=10)
            peak = torch.cuda.max_memory_allocated()
            knn_ms = time_ms(lambda: dgcnn.knn_indices(x, RECON_K), reps=10)
            out[f"encoder_B{B}"] = {"ms": ms, "knn_ms": knn_ms, "peak_bytes": peak}
            log(f"[recon] encoder B {B} x {RECON_POINTS} points: {ms:.3f} ms (kNN alone "
                f"{knn_ms:.3f} ms), peak memory allocated {peak / 2**30:.3f} GiB")
    del clouds, enc

    dec, fx = load_fixture_decoder(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    udf_fn = make_udf_fn(dec, None, torch.from_numpy(fx["latent"]), fx["max_dist"], device=dev)
    mesh, stats = get_mesh_from_udf(
        udf_fn, cfg=MeshExtractionConfig(resolution=512, surface_bias="auto"), return_stats=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if stats["oob_vertices"] or len(mesh.faces) <= 10_000:
        raise RuntimeError(f"512^3: {stats['oob_vertices']} oob vertices, {len(mesh.faces)} faces")
    sub = mesh.vertices[np.random.default_rng(0).choice(
        len(mesh.vertices), min(20_000, len(mesh.vertices)), replace=False)]
    cd = chamfer_distance(sub, fx["surface_samples"])
    if not cd < 0.008:
        raise RuntimeError(f"512^3: chamfer {cd} >= 0.008")
    gap = (len(mesh.faces) - JAX_FACES_512) / JAX_FACES_512
    log(f"[recon] 512^3 sheet: {len(mesh.vertices)} verts / {len(mesh.faces)} faces "
        f"({100 * gap:+.4f} % from BENCH_r05's JAX count {JAX_FACES_512}), chamfer {cd:.5f}, "
        f"face ratio {stats['face_budget_ratio']} (explosion flag {stats['face_explosion']}), "
        f"ff_unsure {stats.get('ff_unsure')}, {dt:.2f}s, peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[recon] 512^3 times {json.dumps(stats['times'])}")
    out.update(extract_512_s=dt, faces_512=len(mesh.faces), times_512=stats["times"])
    del mesh, udf_fn

    with tempfile.TemporaryDirectory() as tmp:
        write_recon_corpus(tmp, dev)
        res_dir = os.path.join(tmp, "recon")
        cmd = [sys.executable, "-m", "surfd_tpu_torch.cli.export_meshes", "--config",
               "deepfashion3d", "--surface_bias", "auto", "--data_root", os.path.join(tmp, "data"),
               "--ae_dir", os.path.join(tmp, "ae"), "--output_dir", res_dir]
        summaries, walls, calls = [], [], []
        for extra in ([], ["--resume"]):
            t0 = time.perf_counter()
            r = subprocess.run(cmd + extra, cwd=ROOT, capture_output=True, text=True, timeout=600)
            walls.append(time.perf_counter() - t0)
            if r.returncode != 0:
                raise RuntimeError(f"export_meshes {extra} failed ({r.returncode}):\n"
                                   f"{r.stderr[-4000:]}")
            with open(os.path.join(res_dir, "recon_metrics.json")) as f:
                summaries.append(json.load(f))
            for line in r.stderr.strip().splitlines()[-3:]:
                log("[recon]   " + line)
            calls.append(json.loads(r.stderr.strip().splitlines()[-1].removeprefix(K1_CALLS)))
        first, resumed = summaries
        # the first run extracts both items through the kernels; the rerun extracts nothing
        if (not (calls[0]["launches"]["f32"] and calls[0]["launches"]["bf16"])
                or calls[0]["plain_calls"] or calls[1]["plain_calls"]):
            raise RuntimeError(f"export_meshes: decoder kernel calls {calls}")
        rows = {row["id"]: row for row in first["per_item"]}
        log(f"[recon] export_meshes --config deepfashion3d (latent 32, {RECON_POINTS} points, "
            f"512^3), two items: {walls[0]:.1f}s; --resume {walls[1]:.1f}s; rows "
            f"{json.dumps(first['per_item'])}")
        if first["n"] != 2 or first["n_empty"] != 0:
            raise RuntimeError(f"export_meshes: n {first['n']}, n_empty {first['n_empty']}")
        if not rows["dress_000"]["chamfer"] < 0.008:
            raise RuntimeError(f"export_meshes: chamfer {rows['dress_000']['chamfer']} >= 0.008")
        if resumed != first:
            raise RuntimeError("export_meshes --resume wrote another recon_metrics.json")
        out.update(cli_s=walls, cli_rows=first["per_item"])

    for c in calls:  # the CLI's own launches, counted by its process's wrappers
        for prec, n in c["launches"].items():
            CHILD_LAUNCHES[f"folded_mlp_{prec}"] += n
    counts = launch_counts()
    k2 = sum(n for name, n in counts.items() if name.startswith("qkv_attention"))
    if not (counts["folded_mlp_f32"] and counts["folded_mlp_bf16"]) or k2:
        raise RuntimeError(f"recon: launches {counts}; want K1 f32 and bf16, no K2")
    return out


def phase_parity(dev):
    """The sheet fixture at 128^3 (not part of the default run): the card's
    mesh against the port's own CPU mesh (faces within 1 %, symmetric mean
    NN distance <= 0.1 voxel, the same active blocks), and the card's
    watertight shell within 1 % of the JAX package's faces."""
    import copy

    from scipy.spatial import cKDTree

    from surfd_tpu_torch.pipelines import (
        MeshExtractionConfig,
        get_mesh_from_udf,
        get_watertight_mesh_from_udf,
        make_udf_fn,
    )

    R = 128
    dec, fx = load_fixture_decoder(dev)
    cfg = MeshExtractionConfig(resolution=R, surface_bias="auto", max_batch=2**16)
    lat = torch.from_numpy(fx["latent"])
    runs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = dec if where == "card" else copy.deepcopy(dec).cpu()
        t0 = time.perf_counter()
        udf_fn = make_udf_fn(model, None, lat, fx["max_dist"], device=d, chunk=2**16)
        runs[where] = (*get_mesh_from_udf(udf_fn, cfg, return_stats=True),
                       time.perf_counter() - t0)
    (cm, cs, ct), (hm, hs, ht) = runs["card"], runs["cpu"]
    gap = abs(len(cm.faces) - len(hm.faces)) / len(hm.faces)
    nn = 0.5 * float(cKDTree(hm.vertices).query(cm.vertices)[0].mean()
                     + cKDTree(cm.vertices).query(hm.vertices)[0].mean())
    voxel = 2.0 / (R - 1)
    same_ab = np.array_equal(cs["ab"], hs["ab"])
    log(f"[parity] 128^3 sheet: card {len(cm.faces)} faces ({ct:.2f}s), CPU {len(hm.faces)} "
        f"faces ({ht:.2f}s, {torch.get_num_threads()} threads): {100 * gap:.4f} % apart, mean NN "
        f"{nn!r} ({nn / voxel:.3g} voxel), active blocks {len(cs['ab'])} / {len(hs['ab'])} "
        f"{'equal' if same_ab else 'DIFFER'}, bias {cs['surface_bias']!r} / {hs['surface_bias']!r}")
    if not (gap <= 0.01 and nn <= 0.1 * voxel and same_ab):
        raise RuntimeError("parity: the card's 128^3 mesh is off the CPU's bars")
    udf_fn = make_udf_fn(dec, None, lat, fx["max_dist"], device=dev, chunk=2**16)
    wm = get_watertight_mesh_from_udf(udf_fn, cfg)
    want = JAX_WATERTIGHT_FACES[R]
    wgap = abs(len(wm.faces) - want) / want
    log(f"[parity] 128^3 watertight: {len(wm.faces)} faces, {100 * wgap:.4f} % off JAX's {want}")
    if not wgap <= 0.01:
        raise RuntimeError("parity: watertight faces off the JAX package's by more than 1 %")


CLI_RUNS = (  # (module, arguments, the OBJs it must write)
    ("generate_uncond", ["--num_samples", "1", "--timestep_respacing", "50"], ["uncond_0.obj"]),
    ("generate_cat", ["--sampler", "ddim", "--timestep_respacing", "ddim50", "--guidance_param",
                      "2.5", "--num_samples", "2", "--pipeline_depth", "2"],
     ["cat0_0.obj", "cat0_1.obj"]),
    ("generate_uncond", ["--num_samples", "1", "--sampler", "plms", "--timestep_respacing", "50",
                         "--watertight"], ["uncond_0.obj"]),
)


def phase_cli():
    for module, extra, objs in CLI_RUNS:
        with tempfile.TemporaryDirectory() as out:
            argv = ["--random-init", "--resolution", "128", "--output_dir", out] + extra
            cmd = [sys.executable, "-m", f"surfd_tpu_torch.cli.{module}", *argv]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            dt = time.perf_counter() - t0
            if r.returncode != 0:
                raise RuntimeError(f"{module} failed ({r.returncode}):\n{r.stdout}\n"
                                   f"{r.stderr[-4000:]}")
            written = sorted(os.listdir(out))
            if written != objs:
                raise RuntimeError(f"{module} wrote {written}, want {objs}:\n{r.stderr[-4000:]}")
            sizes = [os.path.getsize(os.path.join(out, f)) for f in objs]
            log(f"[cli] {module} {' '.join(extra)}: {dt:.1f}s, "
                + ", ".join(f"{f} {n} bytes" for f, n in zip(objs, sizes)))
            for line in r.stderr.strip().splitlines()[-3:]:
                log("[cli]   " + line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from surfd_tpu_torch.utils import use_full_f32

    use_full_f32()
    dev = torch.device("cuda", 0)
    card = smi()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_all = time.perf_counter()
    rows, k2_calls, hgmma = [], {}, None
    if "build" in phases:
        hgmma = phase_build()
    if "kernels" in phases:
        rows, k2_calls = phase_kernels(dev, hgmma)
    if "generate" in phases:  # the CPU reference, outside the counted paths
        cfg_ref, t_ref = cfg_sample(category_mdm(), "ddim", torch.device("cpu"))
        log(f"[generate] CPU reference DDIM run ({torch.get_num_threads()} threads): {t_ref:.2f}s")
    if "recon" in phases:  # the CPU reference of the encoder, outside the counted paths
        enc_ref = encoder_reference()
        log(f"[recon] CPU reference encoder run, B 1 x {RECON_POINTS} points "
            f"({torch.get_num_threads()} threads): {enc_ref[2]:.2f}s")
    paths = {"sample": lambda: phase_sample(dev), "extract": lambda: phase_extract(dev),
             "generate": lambda: phase_generate(dev, cfg_ref),
             "recon": lambda: phase_recon(dev, enc_ref)}
    by_path = {}
    for name in MAIN_PATH:
        if name not in phases:
            continue
        reset_counts()  # count only this path's launches
        paths[name]()
        if plain_calls():
            raise RuntimeError(f"a plain version ran on the main path, in phase {name} "
                               f"({plain_calls()} calls)")
        by_path[name] = launch_counts()
    for row in rows:
        row["launches_by_path"] = {p: c.get(row["name"], 0) for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    if all(p in phases for p in MAIN_PATH):
        unused = [r["name"] for r in rows if r["launches"] == 0]
        if unused:
            raise RuntimeError(f"kernels not launched on the main path: {unused}")
    log(f"[main path] launches by phase: {json.dumps(by_path)}")
    k2_device_times(rows, k2_calls)
    if "profile" in phases:
        phase_profile(dev)
    if "host" in phases:
        phase_host(dev)
    if "bars" in phases:
        phase_bars(dev)
    if "parity" in phases:
        phase_parity(dev)
    if "cli" in phases:
        phase_cli()
    log(f"[done] all phases in {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
