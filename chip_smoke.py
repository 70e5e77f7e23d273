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
  5. K2's wrapper: host clock per call over 10,000 back-to-back calls, in
     turns with SDPA's;
  6. the unconditional-generation CLI writes an OBJ.

Not in the default run: `--phases build,profile` (where the time goes, and
device kernels per DDPM step) and `--phases build,bars` (the readings
behind both K1 kernels' bars, sound and with planted faults).

Prints progress lines, then a `{"kernels": [...]}` line, the nvidia-smi line
and, last, `{"ok": true, "device": {...}}`. Precision: TF32 is off for
matmuls and convolutions (float32 reference numerics).
"""

from __future__ import annotations

import argparse
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
PHASES = ("build", "kernels", "sample", "extract", "host", "cli")  # the default run
EXTRA_PHASES = ("profile", "bars")

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
    """K1 (f32, bf16) and K2 (four shapes, B = 1 and 2) against plain versions."""
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
        for B in (1, 2):
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


def reset_counts():
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.ops import decoder_kernel as dk

    dk.folded_udf.launches.update(f32=0, bf16=0)
    ak.qkv_attention.launches.clear()
    dk.folded_udf_ref.calls = 0
    dk.folded_udf_mixed_ref.calls = 0
    ak.qkv_attention_ref.calls = 0


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


def phase_cli():
    with tempfile.TemporaryDirectory() as out:
        cmd = [
            sys.executable, "-m", "surfd_tpu_torch.cli.generate_uncond", "--random-init",
            "--num_samples", "1", "--resolution", "128", "--timestep_respacing", "50",
            "--output_dir", out,
        ]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"CLI failed ({r.returncode}):\n{r.stdout}\n{r.stderr[-4000:]}")
        path = os.path.join(out, "uncond_0.obj")
        if not os.path.exists(path):
            raise RuntimeError(f"CLI wrote no OBJ:\n{r.stderr[-4000:]}")
        log(f"[cli] generate_uncond --resolution 128 --timestep_respacing 50: {dt:.1f}s, "
            f"{os.path.getsize(path)} bytes → uncond_0.obj")
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
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.ops import decoder_kernel as dk

    reset_counts()  # the main path starts here: count only its launches
    if "sample" in phases:
        phase_sample(dev)
    if "extract" in phases:
        phase_extract(dev)
    if plain_calls():
        raise RuntimeError(f"a plain version ran on the main path ({plain_calls()} calls)")
    for row in rows:
        if row["name"].startswith("folded_mlp_"):
            row["launches"] = dk.folded_udf.launches[row["name"].rsplit("_", 1)[1]]
        else:
            T, c = (int(s[1:]) for s in row["name"].split("_")[2:])
            row["launches"] = ak.qkv_attention.launches.get((T, c), 0)
    if "sample" in phases and "extract" in phases:
        unused = [r["name"] for r in rows if r["launches"] == 0]
        if unused:
            raise RuntimeError(f"kernels not launched on the main path: {unused}")
    k2_device_times(rows, k2_calls)
    if "profile" in phases:
        phase_profile(dev)
    if "host" in phases:
        phase_host(dev)
    if "bars" in phases:
        phase_bars(dev)
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
