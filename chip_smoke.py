"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each fatal on failure:
  1. print the card (nvidia-smi), build the CUDA kernels from ops/csrc and
     the host geometry library from native/ (set-up, outside the timings);
     count the tensor-core (HGMMA) instructions of each kernel with
     cuobjdump: both K1 kernels (f32 3xTF32, bf16) and the 3xTF32 GEMM
     must have some;
  2. each kernel against its plain PyTorch version at main-path shapes (K2
     at latent 32 and 64; max abs error, kernel / plain / library time,
     bound; for K2 also the
     device-only time per call from torch.profiler); K1 f32 with its
     3xTF32 bound, and in its log line the FP32 bound and the weight bytes
     a call streams if every CTA reads every slab; K1 bf16
     also against folded_udf_mixed_tc, the same math on cuBLAS's tensor
     cores; K2 in
     both layouts it takes (token-major, and the channel-first view the
     attention block hands it, which is the one timed); K2-bwd at the
     training shapes (latent 32 and 64) and at ragged T (1, 3, 17, 33, 63),
     B 1, 2 and 4, in every pairing of qkv's and dO's layouts against
     qkv_attention_bwd_ref, with two planted input faults its bar must
     reject, the training shapes timed at B 2 beside SDPA's backward (its
     cluster size and CTAs in each row, read from the launch grid that the
     profiler's trace records; whether its device time is below SDPA's is
     logged, not a gate); the cleanup's Laplacian (3 iterations) on the
     sheet's finalized 256^3 mesh against numpy's pass (max abs <= 1e-6,
     two calls bit-equal), timed beside its bound in bytes, the plain
     version, three index_add_ passes, numpy on the host and the whole
     call from and back to the host; the denoiser's convolutions at the
     full-width MDM's 39 shapes at B 2, latent 32 against conv1d_ref (max
     abs <= CONV_BAR of max |plain|, two launches bit-equal), and each
     (K, stride) group of one denoiser call's 98, and the whole call,
     captured as CUDA graphs and timed beside the weight-read bound, the
     plain version (cuDNN's default algorithms), cuDNN autotuned and the
     input unfolded into a cuBLAS GEMM; the AE decoder's fused CBN + ReLU
     unit at the AE step's shape; the 3xTF32 GEMM in each form (NT, NN, TN)
     at the AE step's 160,000 x 512 x 512 against float64 (GEMM_BAR, which
     a planted single-pass TF32 product must fail; two calls bit-equal),
     timed beside its bound, torch.matmul in f32 (the plain version and
     cuBLAS) and cuBLAS in single-pass TF32 (a yardstick only); the DGCNN
     encoder's train-mode edge convolution unit at the AE step's four
     blocks against its plain versions (EDGECONV_BARS; two runs bit-equal),
     forward and backward timed beside the composed path, the plain
     versions and its bound;
  3. sampling: 1000 DDPM steps of the full-width MDM (random weights from a
     seed), B = 2, through make_cfg_model_fn (the CLIs' path: one CUDA graph
     captured, 999 replays), then eagerly through the MDM itself, in that
     order — each run K2 16 x 1000 and the conv kernel 98 x 1000 launches by
     the replay-aware counters, the two runs' latents bit-equal, both walls
     logged;
  4. extraction: the shipped trained sheet decoder at 256^3 with
     surface_bias="auto" through get_mesh_from_udf — the JAX package's bars
     (tests/test_e2e_fixture.py), the face count within 1 % of the JAX
     package's, and K1 on the path, no plain version; then in turns with
     the synchronous grid-query stream (sync, async): every mesh equal to
     the first, K1 launches equal, the stage times the overlap moves
     logged; the near-band gradient query alone, its start and fetch timed
     and its kernels profiled;
  4b. extraction settings (phase `settings`) on the same fixture: (a) at
     128^3, the unquantised face filter, no filter (the numpy cleanup) and
     no cleanup, each beside a default run (stage times; no out-of-domain
     vertex or face explosion; the unquantised run within 1 % of the
     default's faces and 0.1 voxel of mean NN), and filter_faces_by_udf
     keeping the unquantised fused filter's faces on one unfiltered mesh;
     (b) the two-tier filter engaged at 32^3 (or the largest R below where
     the calibrated band is under a quarter of the threshold): K1 bf16
     launched, ff_unsure, the mesh bit-equal to the single-tier run's; (c)
     at 128^3, one dense autograd gradient grid read as int8 units: numpy
     marching equal to the native passes, and those to native marching on
     the lazy int8 gradients by grid id (equal faces, Hausdorff < 1e-5);
     the gradient-vote oracle at 64^3, logged; (d) the analytic sphere and torus as torch callables on the card,
     RMS Chamfer < 0.5 voxel and Hausdorff < 1.5 voxel to the surface;
  5. generation at the JAX package's breadth: category CFG sampling with
     the full-width category MDM, guidance 2.5, B = 2 (K2 at B 4), ddim50 —
     DDIM at eta 0 twice (bit-equal), against the port's own CPU run on the
     same weights and noise (max abs <= 1e-3), K2 exactly 800 launches;
     PLMS order 2, K2 exactly 816; the MDM with dtype bfloat16 (one pass
     bit-equal to the f32 MDM on the bf16-rounded input, its DDIM within
     1e-3 of the port's CPU run); the watertight sheet at 256^3 (faces
     within 1 % of the JAX package's, one component, max |v| = 1, K1 f32
     launched); the batch generator, two 256^3 extractions on two latents
     at depth 1 and depth 2, bit-equal;
  6. the AE reconstruction eval at the deepfashion3d preset: the seeded
     DGCNN encoder at 10,000 fixture points against the port's own CPU run
     (kNN neighbour sets equal on >= 99.9 % of rows, latent max abs <=
     6e-5), timed at B 1 and B 8 with its peak memory; one 512^3 extraction
     of the sheet fixture (stage times, faces beside the JAX package's
     count); the export CLI at --config deepfashion3d on a one-item corpus
     (n_empty 0, Chamfer < 0.008 on the sample-only item), then again with
     --resume (the same recon_metrics.json), these two run ahead (below) and
     counted here; K1 f32 and bf16 launched, K2 not;
  7. text, sketch and image conditioning at latent 64 (the text2shape and
     pix3d presets): CLIP ViT-B/32 at its published widths with seeded
     weights, on prompts tokenised by the port's BPE copy (one past 77
     tokens) and on a masked image through image_context, against the
     port's own CPU run (max abs <= COND_CLIP_BAR; TF32 turned on, a
     planted fault, must fail it), timed at B 1 and B 16 with its peak
     memory; the full-width text MDM, CFG 2.5 at B = 2 (K2 at B 4) over
     ddim50 from that context, against the CPU run (max abs <= 1e-3), K2
     exactly 800 launches; generate_text, generate_sketch, generate_image
     and encode_contexts --mode sketch in subprocesses at 128^3 (a CLIP npz
     written by save_clip_params, the sheet fixture's decoder planted to
     ignore the latent), all four at once, each reporting its kernel launches and no
     plain-version call;
  8. diffusion training, the full-width category MDM at B 2, latent 32: 3
     train steps on the card against the port's own CPU run (same init,
     batches, t, weights, noise and conditioning-dropout masks, EMA 0.9):
     each step's loss, step 1's gradients, and the params and EMA after
     the steps within TRAIN_BARS; four planted faults (the attention output
     detached, TF32 on, the optimizer step skipped, the EMA not updated)
     must each fail their bar; the same 3 steps with use_remat and res-block
     dropout 0.1 (a seeded CUDA generator) against them without remat,
     both with cuDNN's deterministic algorithms, within TRAIN_BARS (bit
     equality logged), with equal K2 / K2-bwd launches and the generator
     in the same state after, two planted remat faults (the mask redrawn in
     the recomputation, the checkpoint's input detached) failing their bar,
     and ms a step and peak memory with remat off and on at B 2 and 32; 20
     steps timed (ms a step, peak memory, device busy share) and 20 of the
     latent-64 sketch MDM, each with exactly 16 K2 and 16 K2-bwd launches a
     step; train_diffusion --cond_mode category --precompute_latents in a
     subprocess on phase recon's two-item corpus, 10 steps, then --resume
     to 20, then generate_cat --model_path <save_dir> (ddim50, 128^3, the
     planted sheet decoder) reading the run, these subprocesses while the
     phase's checks run, its timings after them;
  9. AE training at the deepfashion3d preset (latent 32, the CBN decoder 512
     wide with 5 blocks, DGCNN k 20): 4 steps (the third skipped on a NaN
     cloud) at B 2 x 10,000 cloud points x 4,096 queries on the card against
     the port's own CPU run from one JAX-scheme init: the loss terms, every
     kept step's gradients, the params and every BatchNorm running buffer
     within AE_BARS; five planted faults (TF32 on, the coordinate gradient
     without create_graph, the decoder's batch statistics detached, momentum
     0.9 on the batch's side, on the fused CBN unit's and the edge
     convolution unit's entries, the buffers
     kept after the skip) must each fail their bar; the step timed at B 8 x
     20,000 queries (ms a step, peak memory, device busy share, kernels a
     step, the top kernels); then the
     CLI chain in subprocesses: preprocess_udfs on 14 meshes written with
     numpy (the sheet fixture's 128^3 extraction among them) at its
     defaults (both splits at once), train_ae --config deepfashion3d --curriculum for 6 epochs,
     --resume to 10 (the curriculum grows 8 -> 11 -> 12, the steps resume),
     its npz pair equal to its last checkpoint, and export_meshes at 128^3
     reading the run (K1 f32 and bf16 launched); in the train step (and
     train_ae) only the decoder's fused CBN + ReLU unit, the 3xTF32 GEMM
     and the encoder's edge convolution unit launch: 11 forward, 22
     backward and 11 backward2 calls a step, 20 calls of each GEMM form
     (the 10 block projections' forward (NT), create-graph gradient (NN),
     and backward: NN, NT and two TN), and 4 forward and 4 backward edge
     convolution calls;
  10. data parallel and the JAX package's last modules (phase `parallel`):
     a world-1 NCCL process group and make_mesh(); phase 8's 3 train steps
     under DDP against the same steps without it (TRAIN_BARS; bit-equality
     reported beside the plain run's own repeat), the DDP and plain steps
     timed in turns (16 K2 and 16 K2-bwd launches a step); the sheet at
     256^3 with cfg.mesh against the unsharded run (faces equal, vertices <=
     1e-6, K1 f32 launches equal) and the batch generator at depth 2 on the
     mesh; train_diffusion (10 steps) and generate_uncond --data_parallel
     under `torch.distributed.run --standalone --nproc_per_node 1`, both at
     once;
     classifier guidance of the full-width MDM by the default EncoderUNet1D
     over 50 DDPM steps against the port's CPU run (<= 1e-3; K2 23 and K2-bwd
     7 launches a step, the guidance gradient through K2-bwd; the
     classifier's attention output detached, a planted fault, must fail);
     the spatial-transformer UNet and the grid AE against the CPU run
     (VESTIGIAL_BARS; TF32 on must fail them; no hand-written kernel but the
     conv kernel, once for each of the UNet's convolutions);
  11. K2's wrapper: host clock per call over 10,000 back-to-back calls, in
     turns with SDPA's;
  12. the generation CLIs write OBJs, all three at once: generate_uncond (DDPM), generate_cat
     (DDIM, guidance 2.5, two extractions at a time) and generate_uncond
     (PLMS, watertight).

The CLIs of phase 12 and those of phases 6 and 7 need no state of the phases:
they run while the CPU references of the counted phases are computed (the
card is idle then) and are joined before phase 3 starts, so that every
timed phase runs alone.

Phases 3-10 and 4b are the main path: each runs with the launch counts set
to 0 just before it and read just after, and no plain version may run in
them.

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
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "surfd_tpu", "assets", "bench_sheet_decoder.npz")
PHASES = ("build", "kernels", "sample", "extract", "settings", "generate", "recon", "condition",
          "train", "ae", "parallel", "host", "cli")  # default
# counted: launches, no plain version
MAIN_PATH = ("sample", "extract", "settings", "generate", "recon", "condition", "train", "ae",
             "parallel")
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
# (T, c, B) of the main path, 224 channels, 8 heads: latent 32 at B 2 (the
# DDPM sample; CFG runs them at B 4 too), then latent 64 at B 4 (the text
# CFG pass of phase condition). A row per (T, c), timed at the first B listed;
# T 8, c 112 is at both latents, and its B 4 reading goes in its row as "B4".
K2_TIMED = ((32, 28, 2), (16, 56, 2), (8, 112, 2), (4, 112, 2),
            (64, 28, 4), (32, 56, 4), (16, 112, 4), (8, 112, 4))
K2_BWD_SRC = "surfd_tpu_torch/ops/csrc/qkv_attention_bwd.cu"
K2_BWD_TPU = (K2_TPU + "; its gradient, which the JAX package took by jax.grad of "
              "surfd_tpu/models/layers.py:67 (qkv_attention)")
# K2-bwd's (T, c) at the training batch, B 2, 224 channels, 8 heads: latent 32
# (the category MDM of phase train) and latent 64 (the text2shape / pix3d
# presets); T 8, c 112 is at both.
K2_BWD_TIMED = ((32, 28), (16, 56), (8, 112), (4, 112), (64, 28), (32, 56), (16, 112))
# Ragged T, held to the same bar: blocks of unequal rows in the cluster (17 =
# 6 + 6 + 5, 33 = 7 x 4 + 5, 63 = 7 x 8 + 7), one CTA of 3 rows, one row.
K2_BWD_EDGE = ((1, 28), (3, 112), (17, 56), (33, 28), (63, 28))
# K2-bwd against qkv_attention_bwd_ref: max abs error over max(1, max |ref|).
# PERF.md gives the readings, sound and with planted faults, it was set from.
K2_BWD_BAR = 2e-5
CONV_SRC = "surfd_tpu_torch/ops/csrc/conv1d_stream.cu"
CONV_TPU = ("none: the JAX package left the denoiser's convolutions to XLA "
            "(flax nn.Conv in surfd_tpu/models/unet1d.py)")
# The conv kernel against conv1d_ref (cuDNN in f32): max abs error over max
# |plain|. f32 sums of up to 5,376 terms in another order read ~1e-7.
CONV_BAR = 1e-5
GEMM_SRC = "surfd_tpu_torch/ops/csrc/gemm_tf32x3.cu"
GEMM_TPU = ("none: the JAX package left the decoder's matmuls to XLA (flax nn.Dense in "
            "surfd_tpu/models/decoder.py); the port called cuBLAS in f32")
# The AE step's three GEMMs (cell 4: 8 x 20,000 query rows, 512 channels):
# (form, M, N, K)
GEMM_SHAPES = (("nt", 160_000, 512, 512), ("nn", 160_000, 512, 512), ("tn", 512, 512, 160_000))
# The 3xTF32 GEMM against float64 on the same f32 operands: max |C - C64|
# over max |C64|, as in tests/test_torch_gemm_tf32x3_cuda.py. Sound 0.98e-6
# to 1.06e-6 at GEMM_SHAPES, a single-pass TF32 product 2.8e-4 to 3.3e-4
# (PERF.md's kernel table, an H100).
GEMM_BAR = 2e-5
CBN_SRC = "surfd_tpu_torch/ops/csrc/cbn_train.cu"
CBN_TPU = ("none: the JAX package left the decoder's train-mode BatchNorm to XLA "
           "(flax nn.BatchNorm in surfd_tpu/models/decoder.py)")
CBN_SHAPE = (8, 20_000, 512)  # the AE step's decoder activation (cell 4)
# The unit's kernels against its plain stages on the card (the backward
# stages handed the kernel's statistics): max abs error over max |plain|, as
# in tests/test_torch_cbn_train_cuda.py.
CBN_BAR = 5e-5
EDGECONV_SRC = "surfd_tpu_torch/ops/csrc/edgeconv_train.cu"
EDGECONV_TPU = ("none: the JAX package left the DGCNN encoder to XLA "
                "(surfd_tpu/models/dgcnn.py); the port composed it")
# The AE step's four edge convolutions (cell 4): (B, N, k, Din, Dout)
EDGECONV_SHAPES = ((8, 10_000, 20, 3, 64), (8, 10_000, 20, 64, 64), (8, 10_000, 20, 64, 128),
                   (8, 10_000, 20, 128, 256))
# The unit's kernels against its plain versions on the card, as in
# tests/test_torch_edgeconv_train_cuda.py (max abs error over max |plain|; the
# backward handed the kernels' statistics and selection; `sel_differ` the
# share of (point, channel) whose selected slot differs, a near-tie of e).
EDGECONV_BARS = {"f": 1e-5, "stats": 1e-5, "buffers": 1e-6, "sel_differ": 1e-4, "dx": 1e-4,
                 "dw": 1e-4, "dgamma": 1e-5, "dbeta": 1e-5}
LAP_SRC = "surfd_tpu_torch/ops/csrc/mesh_laplacian.cu"
LAP_TPU = ("none: the JAX package smooths in float64 numpy "
           "(surfd_tpu/geometry/mesh_ops.py:184-200, laplacian_smooth)")
# The Laplacian against numpy's pass: float64 sums in another order would
# differ by at most one float32 ulp after the cast; the kernel sums in
# numpy's order and is expected to read 0.
LAP_BAR = 1e-6
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
    if not sum(n for fn, n in counts.items() if "gemm_tf32x3_kernel" in fn):
        raise RuntimeError("no HGMMA instruction in gemm_tf32x3_kernel: the GEMM misses "
                           "the tensor cores")
    t0 = time.perf_counter()
    native.load()
    log(f"[build] native geometry library in {time.perf_counter() - t0:.1f}s")
    return hgmma


def device_us_per_call(fn, name: str, calls: int = 100, grids: bool = False) -> tuple:
    """Device-only time per call of fn, from torch.profiler over `calls`
    back-to-back calls: the mean time of each kernel whose name holds `name`,
    summed over those kernels (each launches once per call). Also returns the
    fewest launches the profiler recorded of any of them, since it can drop
    events (a session that records none of them is taken again, three at
    most), and with `grids` the set of launch grids (x, y, z) that the trace
    records for them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session of ~1.5 ms can record none of its kernels: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key and _device_us(e) > 0]
        if evts:
            break
    else:
        raise RuntimeError(f"profiler saw no device time for kernels named {name!r} "
                           "in three sessions")
    us, n = sum(_device_us(e) / e.count for e in evts), min(e.count for e in evts)
    if not grids:
        return us, n
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    seen = {tuple(e["args"]["grid"]) for e in events if e.get("cat") == "kernel"
            and name in e.get("name", "") and "grid" in e.get("args", {})}
    return us, n, seen


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
    k2_calls, k2_rows = {}, {}
    for T, c in dict.fromkeys((T, c) for T, c, _ in K2_TIMED):
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
            if (T, c, B) not in K2_TIMED:
                continue
            err = max(errs.values())
            q, k, v = (t.permute(0, 2, 1, 3) for t in
                       qkv.reshape(B, T, heads, 3 * c).split(c, dim=-1))
            sdpa = lambda q=q, k=k, v=v: torch.nn.functional.scaled_dot_product_attention(q, k, v)
            kern = lambda x=qkv_cf: ak.qkv_attention(x, heads)
            ms, tok_ms, lib_ms = time_ms_turns(
                [kern, lambda: ak.qkv_attention(qkv, heads), sdpa], inner=200)
            plain_ms = time_ms(lambda: ak.qkv_attention_ref(qkv_cf, heads), inner=50)
            name = f"qkv_attention_T{T}_c{c}"
            k2_calls[name, B] = (kern, sdpa, "qkv_attention_kernel")
            flops = B * heads * (4.0 * T * T * c + 5.0 * T * T)
            b_ms, b_by = bound(4.0 * B * T * 4 * heads * c, flops, "f32")
            reading = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": lib_ms, "token_major_ms": tok_ms}
            if name in k2_rows:  # the shape at a second batch size
                k2_rows[name][f"B{B}"] = reading
            else:
                k2_rows[name] = {
                    "name": name, "route": "cuda", "source": K2_SRC, "replaces": K2_TPU,
                    "launches": 0, **reading, "shape": f"B={B} T={T} H={heads} c={c} channel-first",
                }
                rows.append(k2_rows[name])
            log(f"[kernels] K2 T={T} c={c} B={B}: err token-major {errs['token-major']:.3g} "
                f"channel-first {errs['channel-first']:.3g}; kernel {ms * 1e3:.2f} us "
                f"(token-major {tok_ms * 1e3:.2f} us) plain {plain_ms * 1e3:.2f} us "
                f"SDPA {lib_ms * 1e3:.2f} us bound {b_ms * 1e3:.3f} us ({b_by})")
    rows += kernels_bwd(dev, k2_calls)
    rows.append(kernels_laplacian(dev))
    rows += kernels_conv1d(dev)
    rows.append(kernels_cbn(dev))
    rows += kernels_gemm(dev)
    rows.append(kernels_edgeconv(dev))
    return rows, k2_calls


def _graph_of(fn, sites):
    """fn(*site) for every site, in order, captured as one CUDA graph after
    two warm-up passes on a side stream (cuDNN's autotuner, where on, picks
    its algorithms there). Returns the graph; its outputs stay alive with it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            for site in sites:
                fn(*site)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graph.outs = [fn(*site) for site in sites]
    return graph


def _unfold_cublas(x, w, b, stride, pad):
    """The conv as the input unfolded (pad, unfold) and one cuBLAS f32 GEMM."""
    B, cin, _ = x.shape
    cout, _, k = w.shape
    cols = torch.nn.functional.pad(x, (pad, pad)).unfold(2, k, stride)  # (B, Cin, Lout, K)
    lout = cols.shape[2]
    cols = cols.permute(0, 2, 1, 3).reshape(B * lout, cin * k)
    out = torch.addmm(b, cols, w.reshape(cout, cin * k).t())
    return out.reshape(B, lout, cout).permute(0, 2, 1)


def kernels_conv1d(dev) -> list:
    """The denoiser's 98 convolutions at cell 1's shapes: the full-width
    category MDM (seeded weights) at B 2, latent 32, each conv's input read
    by a forward hook on the card. At each of the 39 distinct shapes the
    kernel against conv1d_ref (F.conv1d: cuDNN's default algorithms in f32,
    what the port ran before), max abs error over max |plain| <= CONV_BAR,
    two launches bit-equal. Then each (K, stride) group of one call's
    convolutions, in the call's order, and the whole call, each captured as
    a CUDA graph and timed by CUDA events over replays: the kernel, the plain
    version, and two library yardsticks that the port does not call — cuDNN
    autotuned (torch.backends.cudnn.benchmark) and the input unfolded into a
    cuBLAS f32 GEMM — beside the bound, the weight bytes at 3.35 TB/s (the
    group's 124 M weights do not fit the 50 MB L2: every replay reads them
    from HBM). The kernel's device time per site from a profiled replay is
    logged where the profiler records every launch. One row per group."""
    from surfd_tpu_torch.ops import conv1d_kernel as ck

    mdm = category_mdm().to(dev)
    sites = []

    def hook(mod, inp, out):
        sites.append((inp[0].clone(), mod.weight, mod.bias, mod.stride[0], mod.padding[0]))

    convs = [m for m in mdm.modules() if isinstance(m, torch.nn.Conv1d)]
    handles = [m.register_forward_hook(hook) for m in convs]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 32, 1)).astype(np.float32)).to(dev)
    with torch.no_grad():
        mdm(x, torch.tensor([3, 700], device=dev), action=category_actions(dev))
    for h in handles:
        h.remove()
    if len(sites) != 98:
        raise RuntimeError(f"the MDM ran {len(sites)} convolutions, want 98")

    def shape(site):
        x, w, _, stride, _ = site
        return (w.shape[1], w.shape[0], w.shape[2], stride, x.shape[0] * (x.shape[2] // stride))

    errs, seen = {}, set()
    with torch.no_grad():
        for site in sites:
            if shape(site) in seen:
                continue
            seen.add(shape(site))
            got, again, want = ck.conv1d(*site), ck.conv1d(*site), ck.conv1d_ref(*site)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise RuntimeError(f"conv1d {shape(site)}: two launches differ")
            errs[shape(site)] = float((got - want).abs().max()) / float(want.abs().max())
    over = {k: v for k, v in errs.items() if not v <= CONV_BAR}
    if len(errs) != 39 or over:
        raise RuntimeError(f"conv1d: {len(errs)} shapes, over the bar {CONV_BAR}: {over}")
    worst = max(errs, key=errs.get)
    log(f"[kernels] conv1d: 39 shapes of the MDM at B 2 latent 32 against conv1d_ref: max "
        f"err/max|ref| {errs[worst]:.3g} at (Cin, Cout, K, s, M) {worst} (bar {CONV_BAR:g}), "
        f"two launches bit-equal at each")

    groups = {(3, 1): [], (3, 2): [], (1, 1): []}
    for site in sites:
        groups[site[1].shape[2], site[3]].append(site)
    rows, whole = [], {}
    with torch.no_grad():
        for key, group in [*groups.items(), ("call", sites)]:
            nbytes = sum(4.0 * s[1].numel() for s in group)
            graphs = [_graph_of(ck.conv1d, group), _graph_of(torch.nn.functional.conv1d, group)]
            torch.backends.cudnn.benchmark = True
            try:
                graphs.append(_graph_of(torch.nn.functional.conv1d, group))
            finally:
                torch.backends.cudnn.benchmark = False
            graphs.append(_graph_of(_unfold_cublas, group))
            ms, plain_ms, tuned_ms, unfold_ms = time_ms_turns([g.replay for g in graphs], reps=20)
            b_ms, b_by = bound(nbytes, 2.0 * sum(s[1].numel() * s[0].shape[0] * s[0].shape[2]
                                                 // s[3] for s in group), "f32")
            reading = {"ms": ms, "plain_ms": plain_ms, "library_ms": tuned_ms,
                       "unfold_cublas_ms": unfold_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "weight_mb": nbytes / 1e6, "convs": len(group)}
            label = "the whole call" if key == "call" else f"k{key[0]} s{key[1]}"
            log(f"[kernels] conv1d {label}: {len(group)} convs, {nbytes / 1e6:.1f} MB of weights, "
                f"graphed: kernel {ms:.4f} ms plain (cuDNN default) {plain_ms:.4f} ms cuDNN "
                f"autotuned {tuned_ms:.4f} ms unfold+cuBLAS {unfold_ms:.4f} ms bound "
                f"{b_ms:.4f} ms ({b_by}); kernel at {b_ms / ms:.1%} of the bound")
            if key == "call":
                whole, kernel_graph = reading, graphs[0]
                continue
            rows.append({
                "name": f"conv1d_k{key[0]}_s{key[1]}", "route": "cuda", "source": CONV_SRC,
                "replaces": CONV_TPU, "launches": 0,
                "max_abs_err": max(errs[shape(s)] for s in group), **reading,
                "shape": f"the {len(group)} k{key[0]} s{key[1]} convolutions of one denoiser "
                         "call, B 2, latent 32 (graphed)",
            })
            del graphs
    for row in rows:
        row["whole_call"] = whole
    conv1d_site_times(kernel_graph, sites, shape)
    return rows


def conv1d_site_times(graph, sites, shape) -> None:
    """The conv kernel's device time at each distinct shape, from three
    profiled replays of the whole call's graph (its launches in the call's
    order), beside each shape's weight-read bound; logged only, and skipped
    where the profiler dropped launches."""
    from torch.profiler import ProfilerActivity, profile

    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kern = sorted((e for e in events if e.get("cat") == "kernel"
                   and "conv1d_stream" in e.get("name", "")), key=lambda e: e["ts"])
    if len(kern) != 3 * len(sites):
        log(f"[kernels] conv1d per shape: the profiler recorded {len(kern)} of "
            f"{3 * len(sites)} launches; not read")
        return
    by_shape = {}
    for i, e in enumerate(kern):
        by_shape.setdefault(shape(sites[i % len(sites)]), []).append(float(e["dur"]))
    total = sum(float(e["dur"]) for e in kern) / 3
    log(f"[kernels] conv1d per shape (Cin, Cout, K, s, M): device us median, bound us, "
        f"ratio; the call's kernels {total:.1f} us of device time")
    for key, durs in by_shape.items():
        cin, cout, k, _, _ = key
        b_us = 4.0 * cin * cout * k / HBM_BPS * 1e6
        med = statistics.median(durs)
        log(f"[kernels]   {key}: {med:.2f} us, bound {b_us:.2f} us, {med / b_us:.2f}x "
            f"({len(durs) // 3} sites)")


def kernels_cbn(dev) -> dict:
    """The AE decoder's fused train-mode CBN + ReLU at the AE step's shape
    (CBN_SHAPE): each stage's kernels against the plain stages, two runs
    bit-equal; the unit as the step runs it (the forward, the create-graph
    input gradient, then the backward of both: one forward, two backward,
    one backward2) timed (CUDA events, in turns) against the composed
    batch_norm + γ/β + ReLU under autograd and the plain stages, beside its
    bound in bytes (x, gh and a read once and h, gx, ggh and the x gradient
    written once a stage: 13 activations); each stage timed alone against
    the activations its passes move (3, 5 and 8)."""
    from surfd_tpu_torch.models.layers import batch_norm
    from surfd_tpu_torch.ops import cbn_train as cb

    B, Q, C = CBN_SHAPE
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(CBN_SHAPE, generator=g, device=dev) + torch.linspace(-1, 2, C, device=dev)
    gamma = 1.0 + 0.3 * torch.randn((B, C), generator=g, device=dev)
    beta = 0.2 * torch.randn((B, C), generator=g, device=dev)
    gh, a = (torch.randn(CBN_SHAPE, generator=g, device=dev) for _ in range(2))
    ga, ba = torch.zeros_like(gamma), torch.zeros_like(beta)  # as the AE step hands them
    bn = torch.nn.BatchNorm1d(C, affine=False).to(dev)

    def gap(u, v):
        return float((u - v).abs().max()) / float(v.abs().max())

    h, stats = cb._forward(x, gamma, beta, bn)
    errs = {"forward": gap(h, cb.forward_ref(x, gamma, beta, bn.eps)[0])}
    for name, kern, plain in (("backward", cb._backward, cb.backward_ref),
                              ("backward2", cb._backward2, cb.backward2_ref)):
        args = (gh, x, gamma, beta, stats) if name == "backward" else (
            a, ga, ba, gh, x, gamma, beta, stats)
        got, again, want = kern(*args), kern(*args), plain(*args)
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise RuntimeError(f"cbn_train {name}: two runs differ")
        errs[name] = max(gap(u, v) for u, v in zip(got, want))
    if not max(errs.values()) <= CBN_BAR:
        raise RuntimeError(f"cbn_train: errors {errs} over the bar {CBN_BAR}")
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]

    def step(unit):
        def run():
            out = unit(*leaves)
            gx = torch.autograd.grad(out, leaves[0], gh, create_graph=True)[0]
            return torch.autograd.grad((gx, out), leaves, (a, gh))
        return run

    fused = step(lambda x, g, b: cb.cbn_relu_train(x, g, b, bn))
    composed = step(lambda x, g, b: torch.relu(g[:, None] * batch_norm(x, bn, True)
                                               + b[:, None]))

    def plain():
        _, st, _ = cb.forward_ref(x, gamma, beta, bn.eps)
        cb.backward_ref(gh, x, gamma, beta, st)
        cb.backward_ref(gh, x, gamma, beta, st)
        cb.backward2_ref(a, ga, ba, gh, x, gamma, beta, st)

    ms, lib_ms = time_ms_turns([fused, composed], reps=10)
    plain_ms = time_ms(plain, reps=3)
    act = 4.0 * B * Q * C
    stage = dict(zip(("forward", "backward", "backward2"), time_ms_turns([
        lambda: cb._forward(x, gamma, beta, bn),
        lambda: cb._backward(gh, x, gamma, beta, stats),
        lambda: cb._backward2(a, ga, ba, gh, x, gamma, beta, stats)], reps=20)))
    moved = {"forward": 3, "backward": 5, "backward2": 8}
    b_ms, b_by = bound(13 * act, 0.0, "f32")
    row = {"name": "cbn_train", "keys": [f"cbn_train_{k}" for k in moved], "route": "cuda",
           "source": CBN_SRC, "replaces": CBN_TPU, "launches": 0,
           "max_abs_err": max(errs.values()), "errors": errs, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "stage_ms": stage,
           "stage_tb_per_s": {k: moved[k] * act / (stage[k] * 1e9) for k in moved},
           "shape": f"B={B} Q={Q} C={C}, forward + 2 backward + backward2"}
    log(f"[kernels] cbn_train {CBN_SHAPE}: errors {json.dumps(errs)} (bar {CBN_BAR:g}), two runs "
        f"equal; the step's unit {ms:.3f} ms, composed under autograd {lib_ms:.3f} ms, plain "
        f"stages {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); stages "
        + ", ".join(f"{k} {stage[k]:.3f} ms ({row['stage_tb_per_s'][k]:.2f} TB/s over "
                    f"{moved[k]} activations)" for k in moved))
    return row


def kernels_gemm(dev) -> list:
    """The 3xTF32 GEMM in each form at the AE step's shapes (GEMM_SHAPES):
    against float64 on the same f32 operands, within GEMM_BAR, which a
    planted single-pass TF32 product (each operand rounded to tf32, the
    products summed in float64) must fail; two calls bit-equal; timed (CUDA
    events, in turns) beside torch.matmul in f32 (the plain version, which
    is cuBLAS) and cuBLAS in single-pass TF32 (a yardstick only, never on
    the path), and its bound (three tf32 products at the dense TF32 peak;
    the operands read and the product written once)."""
    from surfd_tpu_torch.ops import gemm_tf32x3 as gm
    from surfd_tpu_torch.ops.decoder_kernel import round_tf32
    from surfd_tpu_torch.utils import use_full_f32

    def tf32_matmul(a, b):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return a @ b
        finally:
            use_full_f32()

    def gap(u, v):
        return float((u.double() - v).abs().max()) / float(v.abs().max())

    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for form, M, N, K in GEMM_SHAPES:
        g = torch.Generator(device=dev).manual_seed(6)
        a = torch.randn((K, M) if form[0] == "t" else (M, K), generator=g, device=dev)
        b = torch.randn((N, K) if form[1] == "t" else (K, N), generator=g, device=dev)
        a, b = (a.t() if form[0] == "t" else a), (b.t() if form[1] == "t" else b)
        want = a.double() @ b.double()
        got = gm.mm_tf32x3(a, b)
        if not torch.equal(got, gm.mm_tf32x3(a, b)):
            raise RuntimeError(f"gemm_tf32x3 {form}: two calls differ")
        err = gap(got, want)
        planted = gap(round_tf32(a).double() @ round_tf32(b).double(), want)
        cublas_tf32 = gap(tf32_matmul(a, b), want)
        del want
        if not err <= GEMM_BAR < planted:
            raise RuntimeError(f"gemm_tf32x3 {form}: error {err:.3g}, planted single-pass TF32 "
                               f"{planted:.3g}, against the bar {GEMM_BAR:g}")
        ms, plain_ms, tf32_ms = time_ms_turns(
            [lambda: gm.mm_tf32x3(a, b), lambda: gm.mm_ref(a, b), lambda: tf32_matmul(a, b)],
            reps=10)
        b_ms, b_by = bound(4.0 * (M * K + K * N + M * N), 2.0 * M * N * K, "tf32x3")
        name = f"gemm_tf32x3_{form}"
        rows.append({"name": name, "route": "cuda", "source": GEMM_SRC, "replaces": GEMM_TPU,
                     "launches": 0, "max_abs_err": err, "planted_tf32_err": planted,
                     "cublas_tf32_err": cublas_tf32, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": plain_ms,
                     "library_tf32_ms": tf32_ms, "splits": gm.plan(M, N, K, sms)[0],
                     "shape": f"M={M} N={N} K={K}, {form.upper()}"})
        log(f"[kernels] {name} {M} x {N} x {K}: error {err:.3e} (bar {GEMM_BAR:g}; planted "
            f"single-pass TF32 {planted:.3e}, cuBLAS TF32 {cublas_tf32:.3e}), two calls equal; "
            f"{ms:.3f} ms ({100 * b_ms / ms:.1f} % of the bound {b_ms:.3f} ms, {b_by}), "
            f"torch.matmul f32 (plain, cuBLAS) {plain_ms:.3f} ms, cuBLAS TF32 {tf32_ms:.3f} ms")
    return rows


def kernels_edgeconv(dev) -> dict:
    """The DGCNN encoder's train-mode edge convolution unit at the AE step's
    four blocks (EDGECONV_SHAPES): the kernels against the plain versions
    (EDGECONV_BARS), two runs bit-equal; each block's forward and backward
    (given the output's gradient) timed in turns through the unit, the
    composed path under autograd and the plain versions, beside its bound:
    the point-level products (12·B·N·Din·Dout FLOPs) at the FP32 peak
    against x, f, their gradients read or written once."""
    from surfd_tpu_torch.models import dgcnn
    from surfd_tpu_torch.ops import edgeconv_train as ec

    def gap(u, v):
        return float((u - v).abs().max()) / max(float(v.abs().max()), 1e-30)

    errs, times, flops, nbytes = {}, [], 0.0, 0.0
    for B, N, k, Din, Dout in EDGECONV_SHAPES:
        g = torch.Generator(device=dev).manual_seed(7)
        cloud = torch.randn((B, N, 3), generator=g, device=dev)
        idx = dgcnn.knn_indices(cloud, k)
        x = cloud if Din == 3 else torch.nn.functional.leaky_relu(
            torch.randn((B, N, Din), generator=g, device=dev) + 0.3, 0.2)
        w = torch.randn((Dout, 2 * Din), generator=g, device=dev) / (2 * Din) ** 0.5
        gf = torch.randn((B, N, Dout), generator=g, device=dev)
        bn = torch.nn.BatchNorm1d(Dout).to(dev)
        with torch.no_grad():
            bn.weight.copy_(1.0 + 0.5 * torch.randn(Dout, generator=g, device=dev))
            bn.weight[::7] *= -1.0
        adj = ec.adjacency(idx)
        rm, rv = bn.running_mean.clone(), bn.running_var.clone()
        runs = []
        for _ in range(2):
            with torch.no_grad():
                bn.running_mean.copy_(rm)
                bn.running_var.copy_(rv)
            f, (stats, esel, sel, pq) = ec._forward(x, w, adj, bn)
            runs.append((f, stats, esel, sel, bn.running_mean.clone(), bn.running_var.clone(),
                         *ec._backward(gf, x, w, adj, f, stats, esel, sel, pq, True)))
        if not all(torch.equal(u, v) for u, v in zip(*runs)):
            raise RuntimeError(f"edgeconv_train {Din}->{Dout}: two runs differ")
        f, stats, esel, sel, run_mean, run_var, *got = runs[0]
        f_ref, stats_ref, esel_ref, sel_ref, var = ec.forward_ref(x, idx, w, bn.weight, bn.bias,
                                                                  bn.eps)
        m = bn.momentum
        read = {"f": gap(f, f_ref), "stats": max(gap(stats[i], stats_ref[i]) for i in range(3)),
                "buffers": max(gap(run_mean, rm * (1 - m) + m * stats_ref[0]),
                               gap(run_var, rv * (1 - m) + m * var)),
                "sel_differ": 1.0 - float((sel == sel_ref).double().mean())}
        want = ec.backward_ref(gf, x, idx, w, stats, esel, sel, f)
        read.update({n: gap(u, v) for n, u, v in zip(("dx", "dw", "dgamma", "dbeta"), got, want)})
        del f_ref, stats_ref, esel_ref, sel_ref, want, runs
        over = {n: v for n, v in read.items() if not v <= EDGECONV_BARS[n]}
        if over:
            raise RuntimeError(f"edgeconv_train {Din}->{Dout}: {over} over the bars "
                               f"{EDGECONV_BARS}")
        errs[f"{Din}->{Dout}"] = read
        leaves = [x.clone().requires_grad_(Din != 3), w.clone().requires_grad_(True),
                  bn.weight, bn.bias]
        wrt = leaves[Din == 3:]

        def unit(leaves=leaves, wrt=wrt, adj=adj, bn=bn, gf=gf):
            return torch.autograd.grad(ec.edgeconv_train(leaves[0], adj, leaves[1], bn), wrt, gf)

        def composed(leaves=leaves, wrt=wrt, idx=idx, bn=bn, gf=gf):
            e = torch.nn.functional.linear(dgcnn.gather_graph_feature(leaves[0], idx), leaves[1])
            out = torch.nn.functional.leaky_relu(dgcnn.batch_norm(e, bn, True), 0.2,
                                                 inplace=True).amax(dim=2)
            return torch.autograd.grad(out, wrt, gf)

        def plain(x=x, idx=idx, w=w, bn=bn, gf=gf):
            f, st, es, sl, _ = ec.forward_ref(x, idx, w, bn.weight, bn.bias, bn.eps)
            ec.backward_ref(gf, x, idx, w, st, es, sl, f)

        times.append(time_ms_turns([unit, composed, plain], reps=3))
        flops += 12.0 * B * N * Din * Dout
        nbytes += 4.0 * B * N * 2 * (Din + Dout)
        del leaves, wrt, unit, composed, plain
    ms, lib_ms, plain_ms = (sum(t[i] for t in times) for i in range(3))
    b_ms, b_by = bound(nbytes, flops, "f32")
    blocks = {f"{s[3]}->{s[4]}": {"unit_ms": t[0], "composed_ms": t[1], "plain_ms": t[2]}
              for s, t in zip(EDGECONV_SHAPES, times)}
    row = {"name": "edgeconv_train", "keys": ["edgeconv_train_forward", "edgeconv_train_backward"],
           "route": "cuda", "source": EDGECONV_SRC, "replaces": EDGECONV_TPU, "launches": 0,
           "max_abs_err": max(max(v for n, v in r.items() if n != "sel_differ")
                              for r in errs.values()),
           "errors": errs, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib_ms, "blocks": blocks,
           "shape": "the AE step's four blocks, B 8 x 10,000 points x k 20, forward + backward"}
    log(f"[kernels] edgeconv_train, the four blocks at B 8 x 10,000 x k 20: errors "
        f"{json.dumps(errs)} (bars {json.dumps(EDGECONV_BARS)}), two runs equal; forward + "
        f"backward {ms:.3f} ms, composed under autograd {lib_ms:.3f} ms, plain {plain_ms:.3f} "
        f"ms, bound {b_ms:.3f} ms ({b_by}); by block {json.dumps(blocks)}")
    return row


def kernels_laplacian(dev, iterations: int = 3) -> dict:
    """The cleanup's Laplacian on the sheet's finalized 256^3 mesh (the
    fixture decoder, the default extraction without the final passes)
    against numpy's pass, two calls bit-equal; timed (CUDA events) beside
    its bound in bytes (the f32 vertices and int64 faces read once, the f32
    vertices written once), the plain version on the card, three passes of
    index_add_ over the directed edges built beforehand (the library's
    scatter-add doing the sums), numpy's pass on this host, and the whole
    call as the cleanup makes it (host arrays up through to_device, the
    vertices back; host clock)."""
    from surfd_tpu_torch.geometry import mesh_ops
    from surfd_tpu_torch.geometry.grid import to_device
    from surfd_tpu_torch.ops import mesh_laplacian as ml
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf, make_udf_fn

    dec, fx = load_fixture_decoder(dev)
    udf_fn = make_udf_fn(dec, None, torch.from_numpy(fx["latent"]), fx["max_dist"], device=dev)
    mesh = get_mesh_from_udf(udf_fn, cfg=MeshExtractionConfig(resolution=256, surface_bias="auto"))
    V, F = len(mesh.vertices), len(mesh.faces)
    v, f = torch.from_numpy(mesh.vertices).to(dev), torch.from_numpy(mesh.faces).to(dev)
    numpy_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        want = mesh_ops.laplacian_smooth(mesh, iterations, 0.5).vertices
        numpy_s.append(time.perf_counter() - t0)
    kern = lambda: ml.laplacian_smooth(v, f, iterations, 0.5)
    got = kern().cpu().numpy()
    if not np.array_equal(kern().cpu().numpy(), got):
        raise RuntimeError("mesh_laplacian: two calls differ")
    err = float(np.abs(got.astype(np.float64) - want).max())
    differing = int((got != want).sum())
    if not err <= LAP_BAR:
        raise RuntimeError(f"mesh_laplacian: max abs err {err} > {LAP_BAR}")
    plain = lambda: ml.laplacian_smooth_ref(v, f, iterations, 0.5)
    e = torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]],
                   f[:, [1, 0]], f[:, [2, 1]], f[:, [0, 2]]])
    cnt = torch.zeros(V, dtype=torch.float64, device=dev).index_add_(
        0, e[:, 0], torch.ones(len(e), dtype=torch.float64, device=dev)).clamp(min=1)[:, None]
    v64 = v.double()

    def index_add_passes():
        p = v64
        for _ in range(iterations):
            p = p + 0.5 * (torch.zeros_like(p).index_add_(0, e[:, 0], p[e[:, 1]]) / cnt - p)
        return p

    ms, lib_ms = time_ms_turns([kern, index_add_passes], reps=20)
    plain_ms = time_ms(plain, reps=5)
    call_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        ml.laplacian_smooth(to_device(mesh.vertices, dev), to_device(mesh.faces, dev),
                            iterations, 0.5).cpu().numpy()
        call_s.append(time.perf_counter() - t0)
    b_ms, b_by = bound(24.0 * V + 24.0 * F, 0.0, "f32")
    row = {"name": "mesh_laplacian", "route": "cuda", "source": LAP_SRC, "replaces": LAP_TPU,
           "launches": 0, "max_abs_err": err, "coordinates_differing": differing, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "numpy_host_ms": 1e3 * statistics.median(numpy_s),
           "call_from_host_ms": 1e3 * statistics.median(call_s),
           "shape": f"V={V} F={F} iterations={iterations} (the sheet's 256^3 mesh)"}
    log(f"[kernels] mesh_laplacian V={V} F={F}: max abs err {err:.3g} (bar {LAP_BAR:g}), "
        f"{differing} coordinates differ from numpy, two calls equal; kernel {ms:.3f} ms "
        f"plain {plain_ms:.3f} ms index_add_ {lib_ms:.3f} ms bound {b_ms:.4f} ms ({b_by}); "
        f"numpy on the host {row['numpy_host_ms']:.1f} ms (runs {numpy_s}); the call from "
        f"the host {row['call_from_host_ms']:.2f} ms (runs {call_s})")
    return row


def _bwd_err(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def kernels_bwd(dev, k2_calls) -> list:
    """K2-bwd against qkv_attention_bwd_ref at the training shapes and the
    ragged edges, B 1, 2 and 4, every pairing of qkv's and dO's layouts, with
    two planted input faults the bar must reject; the training shapes at B 2
    timed in the main path's layouts (both channel-first) beside the plain
    version and SDPA's backward on the same (B, H, T, c). Adds each timed
    row's callables to k2_calls for the device times."""
    from surfd_tpu_torch.ops import attention_kernel as ak

    heads, rows = 8, []
    rng = np.random.default_rng(2)

    def channel_first(x):
        return x.transpose(1, 2).contiguous().transpose(1, 2)

    for T, c in K2_BWD_TIMED + K2_BWD_EDGE:
        for B in (1, 2, 4):
            qkv = torch.from_numpy(rng.normal(size=(B, T, 3 * heads * c)).astype(np.float32)).to(dev)
            g = torch.from_numpy(rng.normal(size=(B, T, heads * c)).astype(np.float32)).to(dev)
            errs = {}
            for lq, x in (("token", qkv), ("channel", channel_first(qkv))):
                for lg, dy in (("token", g), ("channel", channel_first(g))):
                    got = ak.qkv_attention_bwd(x, dy, heads)
                    want = ak.qkv_attention_bwd_ref(x, dy, heads)
                    torch.cuda.synchronize()
                    if got.stride() != x.stride():
                        raise RuntimeError(f"K2-bwd T={T} c={c} B={B}: strides {got.stride()}, "
                                           f"qkv {x.stride()}")
                    errs[lq, lg] = _bwd_err(got, want)
            err = max(errs.values())
            if not err <= K2_BWD_BAR:
                raise RuntimeError(f"K2-bwd T={T} c={c} B={B}: error {errs} over {K2_BWD_BAR}")
            if B != 2:
                continue
            x, dy = channel_first(qkv), channel_first(g)
            want = ak.qkv_attention_bwd_ref(x, dy, heads)
            faults = {}
            bumped = dy.clone()
            bumped[0, T // 2, 5] += 0.01
            faults["one dO value +0.01"] = _bwd_err(ak.qkv_attention_bwd(x, bumped, heads), want)
            if T > 1:  # at T 1 the softmax is 1 whatever k holds: k has no gradient path
                rounded = x.clone()
                rounded[0, :, c:2 * c] = rounded[0, :, c:2 * c].bfloat16().float()
                faults["head 0's k rounded to bf16"] = _bwd_err(
                    ak.qkv_attention_bwd(rounded, dy, heads), want)
            passed = [f for f, e in faults.items() if e <= K2_BWD_BAR]
            if passed:
                raise RuntimeError(f"K2-bwd T={T} c={c}: the bar passes planted faults {passed}")
            if (T, c) not in K2_BWD_TIMED:
                log(f"[kernels] K2-bwd T={T} c={c}: err at B 2 over the layouts "
                    f"{err:.3g} (bar {K2_BWD_BAR:g}; B 1 and 4 held to it too); planted faults "
                    + ", ".join(f"{f} {e:.3g}" for f, e in faults.items()))
                continue
            q, k, v = (t.permute(0, 2, 1, 3).detach().requires_grad_(True) for t in
                       qkv.reshape(B, T, heads, 3 * c).split(c, dim=-1))
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
            g4 = g.reshape(B, T, heads, c).permute(0, 2, 1, 3)
            sdpa_bwd = lambda o=sdpa_out, q=q, k=k, v=v, g4=g4: torch.autograd.grad(  # noqa: E731
                o, (q, k, v), g4, retain_graph=True)
            kern = lambda x=x, dy=dy: ak.qkv_attention_bwd(x, dy, heads)  # noqa: E731
            ms, lib_ms = time_ms_turns([kern, sdpa_bwd], inner=200)
            plain_ms = time_ms(lambda: ak.qkv_attention_bwd_ref(x, dy, heads), inner=50)
            name = f"qkv_attention_bwd_T{T}_c{c}"
            k2_calls[name, B] = (kern, sdpa_bwd, "qkv_attention_bwd")
            # read qkv and dO once, write dqkv once; per (b, h): QKᵀ, dP, dV, dQ, dK
            # (2·T²·c each) and the softmax, D and dS (~8·T²)
            nbytes = 4.0 * B * T * heads * c * 7
            flops = B * heads * (10.0 * T * T * c + 8.0 * T * T)
            b_ms, b_by = bound(nbytes, flops, "f32")
            rows.append({
                "name": name, "route": "cuda", "source": K2_BWD_SRC, "replaces": K2_BWD_TPU,
                "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "shape": f"B={B} T={T} H={heads} c={c} channel-first qkv and dO",
                "err_by_layout": {f"{a}/{b}": e for (a, b), e in errs.items()},
                "planted_faults": faults,
            })
            log(f"[kernels] K2-bwd T={T} c={c} B={B}: err (qkv/dO layouts) "
                + ", ".join(f"{a}/{b} {e:.3g}" for (a, b), e in errs.items())
                + f" (bar {K2_BWD_BAR:g}); planted faults "
                + ", ".join(f"{f} {e:.3g}" for f, e in faults.items())
                + f"; kernel {ms * 1e3:.2f} us plain {plain_ms * 1e3:.2f} us SDPA backward "
                f"{lib_ms * 1e3:.2f} us bound {b_ms * 1e3:.3f} us ({b_by})")
    return rows


def k2_device_times(rows, k2_calls):
    """K2's and SDPA's device-only time per call (torch.profiler), into the
    K2 rows. Run after the main path, so that no profiler session comes
    before its timings."""
    by_name = {row["name"]: row for row in rows}
    for (name, B), (kern, sdpa, kernel_name) in k2_calls.items():
        row = by_name[name]
        reading = row.get(f"B{B}", row)
        bwd = kernel_name == "qkv_attention_bwd"
        if bwd:
            reading["device_us"], n_k2, grids = device_us_per_call(kern, kernel_name, grids=True)
        else:
            reading["device_us"], n_k2 = device_us_per_call(kern, kernel_name)
        # every kernel SDPA (or its backward) launches
        reading["library_device_us"], n_sdpa = device_us_per_call(sdpa, "")
        log(f"[kernels] {name} B {B} device-only: kernel {reading['device_us']:.2f} us, "
            f"SDPA {reading['library_device_us']:.2f} us (event-timed {reading['ms'] * 1e3:.2f} / "
            f"{reading['library_ms'] * 1e3:.2f} us; launches recorded {n_k2} / {n_sdpa} of 100)")
        if bwd:
            # K2-bwd's grid is (R, H, B) for a cluster of R CTAs per (batch, head)
            if len(grids) != 1:
                raise RuntimeError(f"{name}: the trace records launch grids {grids}; want one")
            (grid,) = grids
            reading["cluster"], reading["ctas"] = grid[0], grid[0] * grid[1] * grid[2]
            below = reading["device_us"] < reading["library_device_us"]  # logged, not a gate
            log(f"[kernels] {name}: launch grid {grid} (cluster {grid[0]}, {reading['ctas']} "
                f"CTAs); device time {'below' if below else 'NOT below'} SDPA backward's")


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
_CHILD_LOCK = threading.Lock()  # run_clis adds from several threads


def reset_counts():
    from surfd_tpu_torch.ops import GraphedCall
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.ops import cbn_train as cb
    from surfd_tpu_torch.ops import conv1d_kernel as ck
    from surfd_tpu_torch.ops import decoder_kernel as dk
    from surfd_tpu_torch.ops import edgeconv_train as ec
    from surfd_tpu_torch.ops import gemm_tf32x3 as gm
    from surfd_tpu_torch.ops import mesh_laplacian as ml

    CHILD_LAUNCHES.clear()
    dk.folded_udf.launches.update(f32=0, bf16=0)
    ak.qkv_attention.launches.clear()
    ak.qkv_attention_bwd.launches.clear()
    dk.folded_udf_ref.calls = 0
    dk.folded_udf_mixed_ref.calls = 0
    ak.qkv_attention_ref.calls = 0
    ak.qkv_attention_bwd_ref.calls = 0
    ml.laplacian_smooth.launches = 0
    ml.laplacian_smooth_ref.calls = 0
    ck.conv1d.launches.clear()
    ck.conv1d_ref.calls = 0
    GraphedCall.captures = GraphedCall.replays = 0
    cb.cbn_relu_train.launches.update(forward=0, backward=0, backward2=0)
    cb.forward_ref.calls = cb.backward_ref.calls = cb.backward2_ref.calls = 0
    gm.mm_tf32x3.launches.update(nt=0, nn=0, tn=0)
    gm.mm_ref.calls = 0
    ec.edgeconv_train.launches.update(forward=0, backward=0)
    ec.forward_ref.calls = ec.backward_ref.calls = 0


def launch_counts() -> dict:
    """Kernel launches since reset_counts(), by the kernels line's row
    names: this process's and those its subprocesses reported."""
    from surfd_tpu_torch.ops import kernel_calls

    counts = collections.Counter(kernel_calls()["launches"])
    counts.update(CHILD_LAUNCHES)
    return dict(counts)


def plain_calls() -> int:
    from surfd_tpu_torch.ops import kernel_calls

    return kernel_calls()["plain_calls"]


def run_cli(module: str, argv: list, label: str, sink=None):
    """One CLI of the port in a subprocess, which must make no plain-version
    call: its wall time, stderr lines and kernel launches (its last stderr
    line), which go into `sink` (a Counter), else into CHILD_LAUNCHES."""
    from surfd_tpu_torch.cli._common import KERNEL_CALLS

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"surfd_tpu_torch.cli.{module}", *argv], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{module} failed ({r.returncode}):\n{r.stderr[-4000:]}")
    lines = r.stderr.strip().splitlines()
    calls = json.loads(lines[-1].removeprefix(KERNEL_CALLS))
    log("\n".join(f"[{label}]   " + line for line in lines[-4:]))
    if calls["plain_calls"]:
        raise RuntimeError(f"{module}: {calls['plain_calls']} plain-version calls")
    with _CHILD_LOCK:
        (CHILD_LAUNCHES if sink is None else sink).update(calls["launches"])
    return dt, lines, calls["launches"]


def run_clis(jobs) -> list:
    """run_cli over (module, argv, label) jobs, all at once: their
    subprocesses' start-ups overlap. Each wall is taken while the others
    run. The results come in the order of the jobs."""
    with ThreadPoolExecutor(len(jobs)) as ex:
        return [f.result() for f in [ex.submit(run_cli, *job) for job in jobs]]


def phase_sample(dev):
    from surfd_tpu_torch.diffusion import named_schedule
    from surfd_tpu_torch.models import MDM, make_cfg_model_fn
    from surfd_tpu_torch.ops import GraphedCall
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.ops import conv1d_kernel as ck
    from surfd_tpu_torch.pipelines import sample_latents

    mdm = MDM(cond_mode="no_cond")
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    mdm.to(dev)
    sched = named_schedule("cosine", 1000)

    def run(model_fn):
        before = sum(ak.qkv_attention.launches.values())
        convs = dict(ck.conv1d.launches)
        g = torch.Generator(device=dev).manual_seed(10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = sample_latents(sched, model_fn, 2, 32, g, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = sum(ak.qkv_attention.launches.values()) - before
        n_conv = {k: v - convs.get(k, 0) for k, v in ck.conv1d.launches.items()}
        if tuple(lat.shape) != (2, 32) or not bool(torch.isfinite(lat).all()):
            raise RuntimeError(f"latents bad: shape {tuple(lat.shape)}")
        if n != 16 * 1000:
            raise RuntimeError(f"K2 launched {n} times in sampling, want 16000")
        if n_conv != {(3, 1): 49000, (3, 2): 3000, (1, 1): 46000}:
            raise RuntimeError(f"conv1d launched {n_conv} in sampling, want 98 a step")
        return lat, dt

    graphs = (GraphedCall.captures, GraphedCall.replays)
    lat, dt = run(make_cfg_model_fn(mdm, 1.0))
    graphs = (GraphedCall.captures - graphs[0], GraphedCall.replays - graphs[1])
    if graphs != (1, 999):
        raise RuntimeError(f"graphed sampling: {graphs} captures and replays, want (1, 999)")
    eager, dt_eager = run(mdm)
    if not torch.equal(lat, eager):
        raise RuntimeError(f"graphed vs eager latents: max abs {float((lat - eager).abs().max())}")
    log(f"[sample] 1000 DDPM steps, B=2, full-width MDM: graphed {dt:.2f}s (1 capture, 999 "
        f"replays), eager {dt_eager:.2f}s, bit-equal, K2 launches 16000 and conv1d 98000 each, "
        f"latent std {float(lat.std()):.3f}")
    return {"sample_s": dt, "sample_eager_s": dt_eager}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0)))


def _profiled(label, fn, steps=None, named=()):
    """Wall time of fn without the profiler, then its device kernels under
    torch.profiler: device busy share = summed kernel time / that wall time
    (the profiler's own host overhead stays out of the wall time). With
    `steps`, also the device kernels launched per step (copies and memsets
    apart); for each name in `named`, the summed time and launches of the
    kernels whose names hold it. Returns (wall µs, kernel µs or None)."""
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
    # device-side ranges of user annotations (the optimizer's step) are not
    # kernels and overlap the kernels they enclose
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us == 0:
        log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device time not measured")
        return wall_us, None
    log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, kernels {busy_us / 1e3:.1f} ms, "
        f"device busy {100 * busy_us / wall_us:.1f}%")
    if steps:
        launched = sum(e.count for e in kernels if not e.key.startswith(("Memcpy", "Memset")))
        log(f"[profile] {label}: device kernels launched per step {launched / steps:.2f} "
            f"({launched} in {steps} steps)")
    for e in sorted(kernels, key=_device_us, reverse=True)[:6]:
        log(f"[profile]   {_device_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")
    for name in named:
        mine = [e for e in kernels if name in e.key]
        log(f"[profile] {label}: kernels named {name} {sum(map(_device_us, mine)) / 1e3:.4f} ms "
            f"in {sum(e.count for e in mine)} launches")
    return wall_us, busy_us


def phase_profile(dev):
    """Where the time goes (not part of the default run): 20 DDPM steps of
    the full-width MDM at B = 2, eager and through make_cfg_model_fn's CUDA
    graph, and one 256^3 sheet extraction."""
    from surfd_tpu_torch.diffusion import named_schedule, p_sample
    from surfd_tpu_torch.models import MDM, make_cfg_model_fn
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf, make_udf_fn

    mdm = MDM(cond_mode="no_cond")
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    mdm.to(dev)
    sched = named_schedule("cosine", 1000)
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((2, 32, 1), generator=g, device=dev)

    def steps(n, model_fn, x=x):
        with torch.no_grad():
            for t in range(999, 999 - n, -1):
                x, _ = p_sample(sched, model_fn, x, t,
                                torch.randn(x.shape, generator=g, device=dev), clip_denoised=False)
        return x

    graphed = make_cfg_model_fn(mdm, 1.0)
    for label, model_fn in (("eager", mdm), ("graphed", graphed)):
        steps(5, model_fn)  # warm up (the graph's capture)
        _profiled(f"sample, 20 DDPM steps, {label}", lambda: steps(20, model_fn), steps=20)
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


def blocking_stream():
    """The synchronous grid-query stream in place of QueryStream.start for
    the block: each query is fetched as soon as it is started, as before the
    overlap (test code, not a setting of the package)."""
    from unittest import mock

    from surfd_tpu_torch.geometry import QueryStream
    from surfd_tpu_torch.geometry.grid import to_device

    def blocking(self, fn, pts):
        pts = pts if torch.is_tensor(pts) else to_device(pts, self.device)
        res = self.run(fn, pts).detach().cpu().numpy()
        return lambda: res

    return mock.patch.object(QueryStream, "start", blocking)


# the stage times the overlap moves, logged side by side in phase extract
OVERLAP_STAGES = ("mt_unique", "mt_grads", "marching", "ff_prep", "ff_fetch", "face_filter")


def phase_extract(dev):
    """The sheet at 256^3 by the default (async) route against the JAX
    package's bars, then in turns with the synchronous stream (sync, async):
    every mesh the first one, equal K1 launches in the turns, stage times
    logged; the gradient query alone (`gradient_query`)."""
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
    # the turns reuse the evaluator: its band calibration (one K1 launch of
    # each precision) is cached, so their K1 launches are held to each other
    turns, k1_turns = {"async": [(dt, stats["times"])], "sync": []}, []
    for route in ("sync", "async"):
        with blocking_stream() if route == "sync" else contextlib.nullcontext():
            m, st, secs, k1_r = _extract(udf_fn, dev, resolution=256, surface_bias="auto")
        k1_turns.append(k1_r)
        if not _same_mesh(m, mesh) or k1_r != k1_turns[0]:
            raise RuntimeError(f"extract: the {route} route's mesh or K1 launches {k1_r} differ "
                               f"from the first run's ({len(m.faces)} faces; K1 {k1_turns[0]})")
        turns[route].append((secs, st["times"]))
    for route, runs in turns.items():
        for secs, t in runs:
            log(f"[extract] {route} route: same mesh, {secs:.2f}s, "
                + ", ".join(f"{k} {t.get(k)}" for k in OVERLAP_STAGES))
    return {"extract_s": dt, "chamfer": cd, "faces": len(mesh.faces), "turns": turns,
            "grad_query": gradient_query(udf_fn, dev)}


def gradient_query(udf_fn, dev, R: int = 256) -> dict:
    """The near-band gradient query of the sheet at R^3 alone, as marching
    starts it: host seconds until grad_i8_gid_async returns (the start) and
    until its finalize returns (the fetch), in turns with the query's device
    time under torch.profiler (kernels and their count)."""
    from surfd_tpu_torch import native
    from surfd_tpu_torch.geometry import GridFiller, QueryStream

    voxel = 2.0 / (R - 1)
    grid = GridFiller(R, max_dist=udf_fn.max_dist, surface_bias="auto",
                      queries=QueryStream(dev)).fill(udf_fn)
    _, gids = native.mt_active_cubes(grid, 1.74 * voxel, 1.05 * voxel)
    query = lambda: udf_fn.grad_i8_gid_async(gids, R, -1.0, voxel, udf_fn.queries)
    starts, fetches = [], []
    for _ in range(2):  # the extractions before warmed it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = query()
        t1 = time.perf_counter()
        pending()
        starts.append(t1 - t0)
        fetches.append(time.perf_counter() - t1)
    wall_us, busy_us = _profiled(f"extract: the gradient query at {len(gids)} corners",
                                 lambda: query()(), steps=1)
    log(f"[extract] gradient query, {len(gids)} corners: start {starts} s, fetch {fetches} s "
        f"(host clock, 2 runs)")
    return {"corners": len(gids), "start_s": starts, "fetch_s": fetches, "wall_us": wall_us,
            "busy_us": busy_us}


# Phase settings: extraction at the MeshExtractionConfig settings besides the
# default, on the sheet fixture, and the marching oracles.
SETTINGS_RUNS = {  # (a): each beside the default run at SETTINGS_R
    "unquantised": {"quantized_filter_points": False},
    "no filter": {"filter_faces": False},
    "no stabilize, no border smoothing": {"do_stabilize": False, "do_smooth_borders": False},
    # the two below hold filter_faces_by_udf to the program's own unquantised filter
    "unquantised, no cleanup": {"quantized_filter_points": False, "do_stabilize": False,
                                "do_smooth_borders": False},
    "raw": {"filter_faces": False, "do_stabilize": False, "do_smooth_borders": False},
}
SETTINGS_R = 128
TIER_R = 32  # (b): the two-tier filter engages here, else at the largest R below
ORACLE_R = 128  # (c)
VOTE_R = 64  # (c): the vote oracle (a host Python BFS), cut from ORACLE_R to keep the run short
# (c): numpy against native marching on the raw float32 gradients; faces as a
# share of native's, Hausdorff in voxels. Set from the card's reading (0.0374 %,
# 1.98 voxel on the H100): a crossing decided the other way in one cube moves
# whole triangles, so the Hausdorff distance is of the order of a voxel.
ORACLE_F32_BARS = {"faces": 1e-3, "hausdorff_voxels": 3.0}
ANALYTIC_R = 128  # (d)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mean_nn(a, b) -> float:
    """Symmetric mean nearest-neighbour distance between two vertex sets."""
    from scipy.spatial import cKDTree

    return 0.5 * float(cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def _same_mesh(a, b) -> bool:
    """Equal vertex sets and equal oriented faces, whatever the order of
    either."""
    def canonical(m):
        order = np.lexsort(m.vertices.T[::-1])
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        f = rank[m.faces]
        r = np.argmin(f, axis=1)[:, None]  # rotate the lowest first, keeping orientation
        f = np.take_along_axis(f, (r + np.arange(3)) % 3, axis=1)
        return m.vertices[order], f[np.lexsort(f.T[::-1])]

    (va, fa), (vb, fb) = canonical(a), canonical(b)
    return np.array_equal(va, vb) and np.array_equal(fa, fb)


def _k1_delta(before: dict) -> dict:
    from surfd_tpu_torch.ops import decoder_kernel as dk

    return {k: dk.folded_udf.launches[k] - before[k] for k in before}


def _extract(udf_fn, dev, **kw):
    """One sheet extraction: (mesh, stats, seconds, K1 launches)."""
    from surfd_tpu_torch.ops import decoder_kernel as dk
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf

    before = dict(dk.folded_udf.launches)
    _sync(dev)
    t0 = time.perf_counter()
    mesh, stats = get_mesh_from_udf(udf_fn, cfg=MeshExtractionConfig(**kw), return_stats=True)
    _sync(dev)
    return mesh, stats, time.perf_counter() - t0, _k1_delta(before)


def settings_filters(udf_fn, dev, R: int = SETTINGS_R) -> dict:
    """(a) The filter settings at R beside the default run: faces, stage
    times, the output guards; the unquantised run within 1 % of the default's
    faces and 0.1 voxel of mean NN; filter_faces_by_udf, then the vertex
    merge, on the raw mesh gives the mesh of the program's unquantised filter
    without cleanup (its unreferenced vertices aside)."""
    from surfd_tpu_torch.geometry import (
        QueryStream,
        merge_duplicate_vertices,
        remove_unreferenced_vertices,
    )
    from surfd_tpu_torch.pipelines import filter_faces_by_udf, make_field_bias_at

    voxel = 2.0 / (R - 1)
    base = dict(resolution=R, surface_bias="auto")
    runs = {"default": _extract(udf_fn, dev, **base)}
    for name, kw in SETTINGS_RUNS.items():
        runs[name] = _extract(udf_fn, dev, **base, **kw)
    ref = runs["default"][0]
    for name, (mesh, stats, dt, k1) in runs.items():
        gap = (len(mesh.faces) - len(ref.faces)) / len(ref.faces)
        log(f"[settings] {R}^3 {name}: {len(mesh.faces)} faces ({100 * gap:+.4f} % of the default), "
            f"raw {stats['raw_faces']}, oob {stats['oob_vertices']}, face ratio "
            f"{stats['face_budget_ratio']}, {dt:.2f}s, K1 {k1}, times {json.dumps(stats['times'])}")
        if stats["oob_vertices"] or stats["face_explosion"]:
            raise RuntimeError(f"settings {name}: {stats['oob_vertices']} out-of-domain vertices, "
                               f"face ratio {stats['face_budget_ratio']}")
    mesh = runs["unquantised"][0]
    gap = abs(len(mesh.faces) - len(ref.faces)) / len(ref.faces)
    nn = _mean_nn(mesh.vertices, ref.vertices)
    log(f"[settings] unquantised vs default: faces {100 * gap:.4f} % apart, mean NN {nn!r} "
        f"({nn / voxel:.4g} voxel)")
    if not (gap <= 0.01 and nn <= 0.1 * voxel):
        raise RuntimeError("settings: the unquantised filter is off the default run's bars")

    # filter_faces_by_udf and the merge on the unfiltered mesh against the
    # program's unquantised filter without cleanup (same fill, same field):
    # the per-point bias field where it is non-zero, else the scalar bias
    raw, stats = runs["raw"][:2]
    field = stats.get("surface_bias_field")
    thr = 1.0 / R
    if field is not None and float(field.max()) > 0:
        bias_at = make_field_bias_at(field, -1.0, (R // field.shape[0]) * voxel)
    else:
        bias_at = None
        thr += 0.0 if field is not None else float(stats.get("surface_bias") or 0.0)
    t0 = time.perf_counter()
    kept = filter_faces_by_udf(raw, udf_fn, thr, QueryStream(dev), bias_at=bias_at)
    kept = merge_duplicate_vertices(remove_unreferenced_vertices(kept))
    dt = time.perf_counter() - t0
    # the program's merge may leave a vertex whose faces all collapsed
    prog = remove_unreferenced_vertices(runs["unquantised, no cleanup"][0])
    same = _same_mesh(kept, prog)
    log(f"[settings] filter_faces_by_udf + merge on the {len(raw.faces)}-face raw mesh: "
        f"{len(kept.faces)} faces, {len(kept.vertices)} vertices, {dt:.2f}s; the program's "
        f"unquantised filter without cleanup {len(prog.faces)} faces, {len(prog.vertices)} "
        f"referenced vertices ({'the same mesh' if same else 'DIFFERENT meshes'})")
    if not same:
        raise RuntimeError("settings: filter_faces_by_udf and the program's unquantised filter "
                           "give different meshes")
    return {name: len(r[0].faces) for name, r in runs.items()}


def settings_two_tier(udf_fn, dev) -> dict:
    """(b) The two-tier filter engaged: the first R from TIER_R down at which
    the calibrated band is below a quarter of the threshold. K1 bf16 must
    launch and the mesh must be bit-equal to the single-tier run's. An audit
    of the tier-1 decisions at the near-raw mesh's filter points prints any
    sure point whose bf16 decision differs from the f32 one."""
    from surfd_tpu_torch import native
    from surfd_tpu_torch.pipelines import BiasTable

    band = udf_fn.two_tier_band(udf_fn.queries)
    for R in range(TIER_R, 7, -1):
        two, stats2, dt2, k2 = _extract(udf_fn, dev, resolution=R, surface_bias="auto")
        if stats2["ff_two_tier"]:
            break
        log(f"[settings] two-tier off at {R}^3: band {band!r} >= threshold "
            f"{stats2['ff_threshold']!r} / 4")
    else:
        raise RuntimeError(f"settings: the two-tier filter engages at no R <= {TIER_R}")
    one, stats1, dt1, k1 = _extract(udf_fn, dev, resolution=R, surface_bias="auto",
                                    two_tier_filter=False)
    equal = (np.array_equal(two.vertices, one.vertices) and np.array_equal(two.faces, one.faces))
    log(f"[settings] two-tier at {R}^3: band {band!r}, threshold {stats2['ff_threshold']!r} "
        f"(quarter {0.25 * stats2['ff_threshold']!r}), ff_unsure {stats2['ff_unsure']}, "
        f"{len(two.faces)} faces {dt2:.2f}s K1 {k2}; single-tier {len(one.faces)} faces {dt1:.2f}s "
        f"K1 {k1}: {'bit-equal' if equal else 'DIFFERENT'}; times {json.dumps(stats2['times'])}")
    # audit: every point of the filter, tier 1 against f32
    near, nstats = _extract(udf_fn, dev, resolution=R, surface_bias="auto", filter_faces=False,
                            do_stabilize=False, do_smooth_borders=False)[:2]
    qstep = 2.0 / 65535.0
    qverts = np.clip(np.rint((near.vertices + 1.0) / qstep), 0, 65535).astype(np.uint16)
    qmids = native.face_filter_prep_q16(near.vertices, near.faces, -1.0, 1.0 / qstep)[0]
    q = torch.from_numpy(np.concatenate([qverts, qmids]).astype(np.int32)).to(dev)
    thr = stats2["ff_threshold"]
    pts = q.to(torch.float32) * qstep - 1.0
    u16, u32 = udf_fn.udf_bf16(pts), udf_fn(pts)
    field = nstats.get("surface_bias_field")
    if field is not None and float(field.max()) > 0:  # the per-point bias, as the filter's
        b = BiasTable(field, -1.0, (R // field.shape[0]) * 2.0 / (R - 1), dev).at(pts)
        u16, u32 = u16 - b, u32 - b
    sure = (u16 - thr).abs() > band
    wrong = torch.nonzero(sure & ((u16 <= thr) != (u32 <= thr)))[:, 0]
    log(f"[settings] tier-1 audit at {R}^3: {len(q)} points, {int((~sure).sum())} unsure, "
        f"max |bf16 - f32| {float((u16 - u32).abs().max())!r}, sure but wrong {len(wrong)}"
        + "".join(f"; point {int(i)} bf16 {float(u16[i])!r} f32 {float(u32[i])!r}" for i in wrong[:10]))
    if dev.type == "cuda" and k2["bf16"] == 0:  # the CPU runs the plain versions
        raise RuntimeError("settings: K1 bf16 never launched in the engaged two-tier run")
    if not equal:
        raise RuntimeError(f"settings: the two-tier mesh at {R}^3 differs from the single-tier one")
    return {"tier_R": R, "ff_unsure": stats2["ff_unsure"], "band": band}


def settings_oracles(udf_fn, dev, R: int = ORACLE_R) -> dict:
    """(c) Marching's oracles on one grid and one dense gradient grid
    (GridFiller.fill_gradients over make_grad_fn: autograd through the f32
    decoder).
      * On the gradients' settled int8 units, which both paths read alike:
        the numpy path against the native one, and native marching on them
        against native marching on the lazy int8 gradients by grid id (the
        default path). Each pair: equal face counts, vertex Hausdorff < 1e-5.
      * On the raw float32 gradients, where the numpy path decides crossings
        on f32 dot products and the native one on their int8 rounding: the
        pair within ORACLE_F32_BARS.
      * The gradient-vote sign oracle on a grid and gradients of its own at
        VOTE_R: its faces and its distance to either path there, logged.
    Also logged: how many active-cube corners round to another int8 on the
    dense and lazy routes."""
    from surfd_tpu_torch import native
    from surfd_tpu_torch.geometry import (
        GridFiller,
        QueryStream,
        chamfer_distance,
        hausdorff_distance,
        make_grad_fn,
        marching_tetrahedra_udf,
        marching_tetrahedra_vote,
    )
    from surfd_tpu_torch.geometry.marching import int8_units, settled_int8_units

    def dense_starter(g):  # a dense gradient array as marching's starter
        flat = np.ascontiguousarray(g, dtype=np.float32).reshape(-1, 3)
        return lambda gids: (lambda: flat[gids])

    voxel = 2.0 / (R - 1)
    gf = GridFiller(R, max_dist=udf_fn.max_dist, surface_bias="auto", queries=QueryStream(dev))
    t0 = time.perf_counter()
    grid, stats = gf.fill(udf_fn, return_stats=True)
    dense = gf.fill_gradients(make_grad_fn(udf_fn), grid)
    g8 = settled_int8_units(dense)
    t1 = time.perf_counter()
    m_np = marching_tetrahedra_udf(grid, dense_starter(g8), use_native=False)
    t2 = time.perf_counter()
    m_cc = marching_tetrahedra_udf(grid, dense_starter(g8))
    t3 = time.perf_counter()
    lazy = lambda gids: udf_fn.grad_i8_gid_async(gids, R, -1.0, voxel, udf_fn.queries)
    m_lazy = marching_tetrahedra_udf(grid, lazy, active_blocks=(stats["ab"], stats["block"]))
    t4 = time.perf_counter()
    f_np = marching_tetrahedra_udf(grid, dense_starter(dense), use_native=False)
    f_cc = marching_tetrahedra_udf(grid, dense_starter(dense))
    t5 = time.perf_counter()
    vgf = GridFiller(VOTE_R, max_dist=udf_fn.max_dist, surface_bias="auto",
                     queries=QueryStream(dev))
    vgrid = vgf.fill(udf_fn)
    vdense = vgf.fill_gradients(make_grad_fn(udf_fn), vgrid)
    # the vote wants unit vectors toward the surface
    toward = -vdense / np.maximum(np.linalg.norm(vdense, axis=-1, keepdims=True), 1e-12)
    m_vote = marching_tetrahedra_vote(vgrid, toward)
    t6 = time.perf_counter()
    _, corners = native.mt_active_cubes(grid, 1.74 * voxel, 1.05 * voxel)
    differ = int((int8_units(dense.reshape(-1, 3)[corners]) != lazy(corners)()).any(axis=1).sum())
    hd_np = hausdorff_distance(m_np.vertices, m_cc.vertices)
    hd_lazy = hausdorff_distance(m_lazy.vertices, m_cc.vertices)
    f32_gap = abs(len(f_np.faces) - len(f_cc.faces)) / len(f_cc.faces)
    hd_f32 = hausdorff_distance(f_np.vertices, f_cc.vertices)
    log(f"[settings] oracles at {R}^3: dense gradients at {int((np.abs(dense).sum(-1) > 0).sum())} "
        f"nodes {t1 - t0:.2f}s; on their int8 units numpy marching {len(m_np.faces)} faces "
        f"{t2 - t1:.2f}s, native {len(m_cc.faces)} {t3 - t2:.2f}s, Hausdorff {hd_np!r}; native on "
        f"the lazy int8 gradients {len(m_lazy.faces)} faces {t4 - t3:.2f}s, Hausdorff {hd_lazy!r}")
    log(f"[settings] oracles at {R}^3, float32 gradients: numpy {len(f_np.faces)} faces, native "
        f"{len(f_cc.faces)} ({100 * f32_gap:.4f} % apart), Hausdorff {hd_f32!r} "
        f"({hd_f32 / voxel:.4g} voxel), {t5 - t4:.2f}s; {differ} of {len(corners)} corner "
        f"gradients round to another int8 on the dense and lazy routes")
    vvoxel = 2.0 / (VOTE_R - 1)
    for name, m in (("numpy, float32",
                     marching_tetrahedra_udf(vgrid, dense_starter(vdense), use_native=False)),
                    ("native, float32", marching_tetrahedra_udf(vgrid, dense_starter(vdense)))):
        rms = float(np.sqrt(chamfer_distance(m_vote.vertices, m.vertices) / 2.0))
        hd = hausdorff_distance(m_vote.vertices, m.vertices)
        log(f"[settings] vote oracle at {VOTE_R}^3: {len(m_vote.faces)} faces ({t6 - t5:.2f}s) "
            f"against {name} {len(m.faces)}: {len(m_vote.faces) - len(m.faces):+d} faces, RMS "
            f"{rms / vvoxel:.4g} voxel, Hausdorff {hd / vvoxel:.4g} voxel")
    if not (len(m_np.faces) == len(m_cc.faces) and hd_np < 1e-5):
        raise RuntimeError("settings: numpy marching is off the native marching's bars")
    if not (len(m_lazy.faces) == len(m_cc.faces) and hd_lazy < 1e-5):
        raise RuntimeError("settings: marching on the lazy gradients is off the dense run's bars")
    if not (f32_gap <= ORACLE_F32_BARS["faces"]
            and hd_f32 <= ORACLE_F32_BARS["hausdorff_voxels"] * voxel):
        raise RuntimeError("settings: numpy and native marching on float32 gradients are off "
                           f"{ORACLE_F32_BARS}")
    return {"oracle_faces": len(m_cc.faces), "int8_differ": differ,
            "f32_faces": (len(f_np.faces), len(f_cc.faces)), "vote_faces": len(m_vote.faces)}


def settings_analytic(dev, R: int = ANALYTIC_R) -> dict:
    """(d) Plain callables: the analytic sphere and torus as torch fields on
    the device, through get_mesh_from_udf without grad_fn (autograd
    gradients, the exact-point filter); RMS Chamfer to the analytic surface
    < 0.5 voxel, Hausdorff < 1.5 voxel."""
    from surfd_tpu_torch.geometry import (
        FIXTURES,
        TorchField,
        chamfer_distance,
        hausdorff_distance,
    )
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf

    voxel = 2.0 / (R - 1)
    out = {}
    for name in ("sphere", "torus"):
        _sync(dev)
        t0 = time.perf_counter()
        mesh, stats = get_mesh_from_udf(TorchField(name, dev), cfg=MeshExtractionConfig(
            resolution=R), return_stats=True)
        _sync(dev)
        dt = time.perf_counter() - t0
        sample = FIXTURES[name](8)[3]
        true = sample(max(len(mesh.vertices), 10000), np.random.default_rng(0))
        rms = float(np.sqrt(chamfer_distance(mesh.vertices, true) / 2.0))
        hd = hausdorff_distance(mesh.vertices, true)
        log(f"[settings] analytic {name} at {R}^3 as a torch callable on {dev.type}: "
            f"{len(mesh.faces)} faces, RMS {rms / voxel:.4f} voxel, Hausdorff {hd / voxel:.4f} "
            f"voxel, {dt:.2f}s, times {json.dumps(stats['times'])}")
        if not (rms < 0.5 * voxel and hd < 1.5 * voxel):
            raise RuntimeError(f"settings: the analytic {name} is off the Chamfer bars")
        out[name] = len(mesh.faces)
    return out


def phase_settings(dev, filter_r: int = SETTINGS_R, oracle_r: int = ORACLE_R,
                   analytic_r: int = ANALYTIC_R):
    """Extraction at the settings besides the default on the sheet fixture:
    (a) the filter settings, (b) the two-tier filter engaged, (c) the
    marching oracles, (d) plain callables."""
    from surfd_tpu_torch.pipelines import make_udf_fn

    dec, fx = load_fixture_decoder(dev)
    udf_fn = make_udf_fn(dec, None, torch.from_numpy(fx["latent"]), fx["max_dist"], device=dev)
    out = {}
    for label, step in (("a", lambda: settings_filters(udf_fn, dev, filter_r)),
                        ("b", lambda: settings_two_tier(udf_fn, dev)),
                        ("c", lambda: settings_oracles(udf_fn, dev, oracle_r)),
                        ("d", lambda: settings_analytic(dev, analytic_r))):
        t0 = time.perf_counter()
        out[label] = step()
        log(f"[settings] ({label}) {time.perf_counter() - t0:.1f}s")
    return out


CFG_STEPS = "ddim50"  # category CFG sampling: cosine 1000 respaced to 50 DDIM steps
CFG_ACTIONS = (1, 4)  # one class per sample, B = 2; guidance makes the pass B 4


def category_mdm(dtype: torch.dtype = torch.float32):
    """The full-width category MDM (9 classes) with random weights from seed
    0, on the CPU; `dtype` is MDM's (its input rounded to it)."""
    from surfd_tpu_torch.models import MDM

    mdm = MDM(cond_mode="category", num_actions=9, dtype=dtype)
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    return mdm.eval()


def cfg_sample(mdm, sampler: str, dev, L: int = 32, **cond):
    """(B, L) latents of the CFG denoiser (guidance 2.5) on `dev`, over the
    ddim50 schedule, from injected noise (numpy seed 20); DDIM at eta 0 or
    PLMS of order 2. `cond`: the B samples' `action` or `context` on `dev`.
    Returns the latents and the wall time."""
    from surfd_tpu_torch.diffusion import named_beta_schedule, space_timesteps, spaced_schedule
    from surfd_tpu_torch.models import make_cfg_model_fn
    from surfd_tpu_torch.pipelines import sample_latents

    sched = spaced_schedule(named_beta_schedule("cosine", 1000), space_timesteps(1000, CFG_STEPS))
    B = len(next(iter(cond.values())))
    rng = np.random.default_rng(20)
    noise = torch.from_numpy(rng.normal(size=(B, L, 1)).astype(np.float32))
    steps = torch.from_numpy(
        rng.normal(size=(sched.num_timesteps, B, L, 1)).astype(np.float32))
    model_fn = make_cfg_model_fn(mdm, 2.5, **cond)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = sample_latents(sched, model_fn, B, L, sampler=sampler, device=dev,
                         noise=noise.to(dev),
                         step_noise=None if sampler == "plms" else steps.to(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return lat, time.perf_counter() - t0


def category_actions(dev) -> torch.Tensor:
    return torch.tensor(CFG_ACTIONS, dtype=torch.int64, device=dev)


def boundary_vertices(mesh) -> int:
    """Vertices on an edge that only one face has."""
    f = mesh.faces
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    keys, counts = np.unique(e[:, 0] * len(mesh.vertices) + e[:, 1], return_counts=True)
    once = keys[counts == 1]
    return len(np.unique(np.concatenate([once // len(mesh.vertices), once % len(mesh.vertices)])))


def phase_generate(dev, cfg_ref, cfg_ref16):
    """Generation at the JAX package's breadth (phase 5): category CFG DDIM
    and PLMS at full width, the MDM with dtype bfloat16, the watertight
    sheet at 256^3 and the batch generator at depth 1 and 2. `cfg_ref`,
    `cfg_ref16`: the CPU run's DDIM latents, f32 and bf16-input MDM."""
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
        lat, dt = cfg_sample(mdm, sampler, dev, action=category_actions(dev))
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

    # dtype=bfloat16: the input rounded, the network f32 (the JAX package's meaning)
    from surfd_tpu_torch.models import MDM

    f32_mdm, mdm = mdm, MDM(cond_mode="category", num_actions=9, dtype=torch.bfloat16)
    mdm = mdm.to(dev).eval()
    mdm.load_state_dict(f32_mdm.state_dict())
    x = torch.from_numpy(np.random.default_rng(21).normal(size=(2, 32, 1)).astype(
        np.float32)).to(dev)
    tt, act = torch.tensor([10, 900], device=dev), category_actions(dev)
    with torch.no_grad():
        got = mdm(x, tt, action=act)
        rounded = f32_mdm(x.to(torch.bfloat16).float(), tt, action=act)
        raw = f32_mdm(x, tt, action=act)
    moved = float((got - raw).abs().max())
    if got.dtype != torch.float32 or not torch.equal(got, rounded) or moved == 0:
        raise RuntimeError(f"bf16 MDM: {got.dtype}, equal to f32 on the rounded input "
                           f"{torch.equal(got, rounded)}, moved {moved} from the raw input")
    lat16, t16 = counted("ddim", 16 * 50)
    err16 = float((lat16.cpu() - cfg_ref16).abs().max())
    if not err16 <= 1e-3:
        raise RuntimeError(f"bf16 MDM DDIM card vs CPU: max abs {err16} > 1e-3")
    log(f"[generate] MDM dtype bfloat16: one pass bit-equal to f32 on the bf16-rounded input, "
        f"{moved!r} from f32 on the raw input; CFG DDIM {t16:.2f}s, card vs CPU max abs "
        f"{err16!r}, K2 launches 800")
    out.update(bf16_ddim_card_vs_cpu=err16, bf16_moved=moved)

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


RECON_ITEMS = ("dress_000", "skirt_001")


def write_recon_corpus(root: str, dev, items=RECON_ITEMS) -> None:
    """ae/ (the fixture decoder; the seeded encoder with its head planted:
    BatchNorm scale 1e-3 and shift the fixture latent, all positive, so the
    encoder outputs the fixture latent plus a small input-dependent term)
    and data/test/ with `items` of RECON_ITEMS, each with the fixture's
    20,000 samples as its cloud; skirt_001 also carries a ground-truth mesh,
    the port's 256^3 extraction of the fixture latent on the card."""
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf, make_udf_fn
    from surfd_tpu_torch.utils.convert import dgcnn_flat_from_state

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
    np.savez(os.path.join(ae, "ae_encoder.npz"), **dgcnn_flat_from_state(enc.state_dict()))
    small = {"coords": np.zeros((8, 3), np.float32), "labels": np.zeros(8, np.float32),
             "gradients": np.zeros((8, 3), np.float32)}
    pcd = fx["surface_samples"]
    if "dress_000" in items:
        np.savez(os.path.join(data, "dress_000.npz"), pcd=pcd, **small)
    if "skirt_001" in items:
        gt = get_mesh_from_udf(make_udf_fn(dec, None, torch.from_numpy(fx["latent"]),
                                           fx["max_dist"], device=dev),
                               cfg=MeshExtractionConfig(resolution=256, surface_bias="auto"))
        np.savez(os.path.join(data, "skirt_001.npz"), pcd=pcd, vertices=gt.vertices,
                 triangles=gt.faces.astype(np.int32), **small)


def recon_cli_chain(dev) -> dict:
    """(c) of phase recon: the export CLI at --config deepfashion3d on a
    one-item corpus (phase ae's export reads ground-truth meshes), then
    again with --resume, checked here; its launches go into the returned
    Counter, which phase recon counts. It needs no state of the phases, so
    it runs while the CPU references do."""
    launches = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        write_recon_corpus(tmp, dev, items=("dress_000",))
        res_dir = os.path.join(tmp, "recon")
        argv = ["--config", "deepfashion3d", "--surface_bias", "auto", "--data_root",
                os.path.join(tmp, "data"), "--ae_dir", os.path.join(tmp, "ae"), "--output_dir",
                res_dir]
        summaries, walls, calls = [], [], []
        for extra in ([], ["--resume"]):  # run_cli: no plain-version call in either
            dt, _, launched = run_cli("export_meshes", argv + extra, "recon", sink=launches)
            walls.append(dt)
            calls.append(launched)
            with open(os.path.join(res_dir, "recon_metrics.json")) as f:
                summaries.append(json.load(f))
    first, resumed = summaries
    # the first run extracts the item through the kernels; the rerun extracts nothing
    if not (calls[0]["folded_mlp_f32"] and calls[0]["folded_mlp_bf16"]):
        raise RuntimeError(f"export_meshes: kernel launches {calls}")
    rows = {row["id"]: row for row in first["per_item"]}
    if first["n"] != 1 or first["n_empty"] != 0:
        raise RuntimeError(f"export_meshes: n {first['n']}, n_empty {first['n_empty']}")
    if not rows["dress_000"]["chamfer"] < 0.008:
        raise RuntimeError(f"export_meshes: chamfer {rows['dress_000']['chamfer']} >= 0.008")
    if resumed != first:
        raise RuntimeError("export_meshes --resume wrote another recon_metrics.json")
    return {"cli_s": walls, "cli_rows": first["per_item"], "launches": launches}


def phase_recon(dev, enc_ref, chain):
    """The AE reconstruction eval at the deepfashion3d preset: (a) the
    seeded encoder at 10,000 points against the port's CPU run and timed at
    B 1 and B 8; (b) one direct 512^3 extraction of the sheet fixture;
    (c) `recon_cli_chain`'s result, `chain`, and its launches.
    `enc_ref`: encoder_reference()."""
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

    # (c), run during the CPU references (recon_cli_chain): its launches count here
    with _CHILD_LOCK:
        CHILD_LAUNCHES.update(chain["launches"])
    log(f"[recon] export_meshes --config deepfashion3d (latent 32, {RECON_POINTS} points, "
        f"512^3), one item: {chain['cli_s'][0]:.1f}s; --resume {chain['cli_s'][1]:.1f}s (during "
        f"the CPU references); rows {json.dumps(chain['cli_rows'])}")
    out.update(cli_s=chain["cli_s"], cli_rows=chain["cli_rows"])

    counts = launch_counts()  # with the CLI's own, which run_cli added
    k2 = sum(n for name, n in counts.items() if name.startswith("qkv_attention"))
    if not (counts["folded_mlp_f32"] and counts["folded_mlp_bf16"]) or k2:
        raise RuntimeError(f"recon: launches {counts}; want K1 f32 and bf16, no K2")
    return out


# Text, sketch and image conditioning at the text2shape and pix3d presets
# (latent 64): CLIP ViT-B/32 at its published widths with seeded weights.
COND_PROMPTS = (
    "a long dress with short sleeves",
    "a pleated knee-length skirt",
    "robe à manches courtes élégante, 一件蓝色的连衣裙",
    "a very long caption about an intricate layered garment with many details " * 12,
)
COND_LATENT = 64
# The card's CLIP embeddings against the port's CPU run on the same weights:
# between the sound reading (4.53e-6) and TF32 turned on (2.00e-3), both read
# on an NVIDIA H100 80GB HBM3 at 700 W.
COND_CLIP_BAR = 1e-4
COND_RES = 128  # the CLIs' resolution in phase condition


def seeded_clip():
    """CLIP ViT-B/32 with random weights from seed 7, on the CPU."""
    from surfd_tpu_torch.models import Clip

    return Clip().random_init_(torch.Generator().manual_seed(7))


def text_mdm():
    """The full-width text-conditioned MDM (context 512) with random weights
    from seed 0, on the CPU."""
    from surfd_tpu_torch.models import MDM

    mdm = MDM(cond_mode="text", clip_dim=512)
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    return mdm.eval()


def condition_image():
    """A 480 x 640 RGB image (a smooth gradient plus noise) and an ellipse
    mask that reaches the right border, made with numpy."""
    yy, xx = np.mgrid[:480, :640]
    rng = np.random.default_rng(8)
    img = np.stack([xx * 255 // 639, yy * 255 // 479, (xx + yy) % 256], -1)
    img = np.clip(img + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)
    mask = ((yy - 250) / 170.0) ** 2 + ((xx - 520) / 200.0) ** 2 <= 1.0
    return img, mask


def condition_reference():
    """The port's CPU run of phase condition's CLIP and text MDM: the text
    embeddings of COND_PROMPTS, the image embedding of condition_image(),
    the text CFG DDIM latents from the first two prompts, and the wall times."""
    from surfd_tpu_torch.cli.generate_image import image_context
    from surfd_tpu_torch.models.clip import tokenize

    cpu = torch.device("cpu")
    clip = seeded_clip()
    t0 = time.perf_counter()
    with torch.no_grad():
        text = clip.encode_text(torch.from_numpy(tokenize(COND_PROMPTS)))
    image = image_context(*condition_image(), clip, cpu)
    t_clip = time.perf_counter() - t0
    lat, t_mdm = cfg_sample(text_mdm(), "ddim", cpu, L=COND_LATENT, context=text[:2])
    return {"text": text, "image": image, "latents": lat, "clip_s": t_clip, "ddim_s": t_mdm}


def write_planted_decoder(ae_dir: str, latent_size: int = COND_LATENT) -> None:
    """ae_dir/ae_decoder.npz at `latent_size`: the sheet fixture's decoder with
    its latent projections folded into their biases at the fixture latent
    (kernels zero), so the decoder draws the fixture's sheet whatever latent
    the random denoiser samples; and args.json with its settings."""
    os.makedirs(ae_dir)
    out = {}
    with np.load(FIXTURE) as z:
        latent = np.asarray(z["latent"], np.float32)
        for k in z.files:
            if not k.startswith("dec/"):
                continue
            v = np.asarray(z[k], np.float32)
            if k.endswith(("gamma/kernel", "beta/kernel")):
                out[k[4:-6] + "bias"] = latent @ v + np.asarray(z[k[:-6] + "bias"], np.float32)
                v = np.zeros((latent_size, v.shape[1]), np.float32)
            out.setdefault(k[4:], v)
        settings = {"latent_size": latent_size, "hidden_dim": int(z["hidden_dim"]),
                    "num_hidden_layers": int(z["num_hidden_layers"]),
                    "max_dist": round(float(z["max_dist"]), 6)}
    np.savez(os.path.join(ae_dir, "ae_decoder.npz"), **out)
    with open(os.path.join(ae_dir, "args.json"), "w") as f:
        json.dump(settings, f)


def sketch_image(seed: int) -> np.ndarray:
    """Black strokes on a white 256 x 256 RGB canvas."""
    img = np.full((256, 256, 3), 255, np.uint8)
    rng = np.random.default_rng(seed)
    for _ in range(12):
        y, x = rng.integers(10, 240, 2)
        img[y:y + 3, x:min(x + int(rng.integers(20, 120)), 256)] = 0
    return img


def condition_cli_chain() -> dict:
    """(c) of phase condition: generate_text, encode_contexts --mode sketch,
    generate_sketch and generate_image in subprocesses at 128^3, all at
    once, with a CLIP npz of seeded_clip() written by save_clip_params and a
    planted decoder; their outputs checked here, their launches into the
    returned Counter. It needs no state of the phases, so it runs while the
    CPU references do. Returns the temp dir too: phase condition holds the
    contexts to its own CLIP, then removes it."""
    import re

    from PIL import Image

    from surfd_tpu_torch.utils.convert import save_clip_params

    launches = collections.Counter()
    tmpdir = tempfile.TemporaryDirectory()
    tmp = tmpdir.name
    try:
        npz = os.path.join(tmp, "clip.npz")
        save_clip_params(npz, seeded_clip())
        ae = os.path.join(tmp, "ae")
        write_planted_decoder(ae)
        img, mask = condition_image()
        paths = {"image": os.path.join(tmp, "image.png"), "mask": os.path.join(tmp, "mask.png")}
        Image.fromarray(img).save(paths["image"])
        Image.fromarray(mask.astype(np.uint8) * 255).save(paths["mask"])
        for fid, seed in (("a01", 1), ("b02", 2)):
            os.makedirs(os.path.join(tmp, "data", "train", "chair"), exist_ok=True)
            np.savez(os.path.join(tmp, "data", "train", "chair", f"{fid}.npz"), x=np.zeros(1))
            os.makedirs(os.path.join(tmp, "sketches", fid))
            Image.fromarray(sketch_image(seed)).save(
                os.path.join(tmp, "sketches", fid, "sketch_0.png"))
        gen = ["--random-init", "--ae_dir", ae, "--clip_npz", npz, "--resolution", str(COND_RES),
               "--sampler", "ddim", "--timestep_respacing", CFG_STEPS, "--guidance_param", "2.5",
               "--num_samples", "1"]
        sketch_png = os.path.join(tmp, "sketches", "a01", "sketch_0.png")
        runs = (("generate_text", ["--text_prompt", COND_PROMPTS[0]], "text"),
                ("generate_sketch", ["--sketch_path", sketch_png], "sketch"),
                ("generate_image", ["--image_path", paths["image"], "--mask_path",
                                    paths["mask"]], "img"))
        results = run_clis(
            [(module, gen + extra + ["--output_dir", os.path.join(tmp, f"out_{tag}")],
              "condition", launches) for module, extra, tag in runs]
            + [("encode_contexts", ["--data_root", os.path.join(tmp, "data"), "--image_root",
                                    os.path.join(tmp, "sketches"), "--mode", "sketch",
                                    "--clip_npz", npz], "condition", launches)])
        walls, done = {}, []
        for (module, _, tag), (dt, lines, launched) in zip(runs, results):
            res = os.path.join(tmp, f"out_{tag}")
            faces = [int(m.group(1)) for m in map(re.compile(r"verts / (\d+) faces").search, lines)
                     if m]
            k2 = sum(n for name, n in launched.items() if name.startswith("qkv_attention"))
            if (os.listdir(res) != [f"{tag}_0.obj"] or not faces or faces[0] <= 10_000
                    or not launched["folded_mlp_f32"] or k2 != 800):
                raise RuntimeError(f"{module}: wrote {os.listdir(res)}, faces {faces}, "
                                   f"launches {launched}")
            walls[module] = dt
            done.append((module, faces[0], dt, launched))
        walls["encode_contexts"] = results[-1][0]
    except BaseException:
        tmpdir.cleanup()
        raise
    return {"tmp": tmpdir, "runs": done, "walls": walls, "launches": launches}


def phase_condition(dev, ref, chain):
    """Text, sketch and image conditioning at latent 64: (a) CLIP ViT-B/32
    at its published widths (seeded) on prompts and on a masked image
    through image_context, against the port's CPU run, with TF32 planted as
    a fault, timed at B 1 and 16; (b) the full-width text MDM, CFG 2.5 at
    B 2 over ddim50 from (a)'s context, against the CPU run (K2 exactly
    800 launches); (c) `condition_cli_chain`'s result, `chain`: its
    contexts held to this CLIP, its launches counted. `ref`:
    condition_reference()."""
    from surfd_tpu_torch.cli.generate_image import clip_input, image_context
    from surfd_tpu_torch.cli._common import read_rgb
    from surfd_tpu_torch.models.clip import get_tokenizer, tokenize
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.utils import use_full_f32

    out = {}
    clip = seeded_clip().to(dev)
    tokens = torch.from_numpy(tokenize(COND_PROMPTS)).to(dev)
    img, mask = condition_image()

    def embed():
        with torch.no_grad():
            return clip.encode_text(tokens).cpu(), image_context(img, mask, clip, dev).cpu()

    text, image = embed()
    gaps = {"text": float((text - ref["text"]).abs().max()),
            "image": float((image - ref["image"]).abs().max())}
    scale = max(float(ref["text"].abs().max()), float(ref["image"].abs().max()))
    n_tok = [len(get_tokenizer().encode(p)) + 2 for p in COND_PROMPTS]
    log(f"[condition] CLIP ViT-B/32 (seeded), card vs CPU: text max abs {gaps['text']!r}, image "
        f"max abs {gaps['image']!r} (bar {COND_CLIP_BAR:g}; embeddings up to {scale:.3f}); prompt "
        f"lengths {n_tok} tokens (cut at 77); tokenizer unicode_ok {get_tokenizer().unicode_ok}")
    if not max(gaps.values()) <= COND_CLIP_BAR:
        raise RuntimeError(f"condition: CLIP card vs CPU {gaps} over the bar {COND_CLIP_BAR}")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:  # planted fault: TF32 for CLIP's matmuls and the patch convolution
        f_text, f_image = embed()
    finally:
        use_full_f32()
    f_gaps = {"text": float((f_text - ref["text"]).abs().max()),
              "image": float((f_image - ref["image"]).abs().max())}
    log(f"[condition] CLIP with TF32 on (planted fault): text max abs {f_gaps['text']!r}, image "
        f"max abs {f_gaps['image']!r}")
    if max(f_gaps.values()) <= COND_CLIP_BAR:
        raise RuntimeError(f"condition: the CLIP bar passes TF32 (planted fault): {f_gaps}")
    out.update(clip_gaps=gaps, clip_tf32_gaps=f_gaps)
    x1 = torch.from_numpy(clip_input(img, mask)[None]).to(dev)
    with torch.no_grad():
        for B in (1, 16):
            tok_b, img_b = tokens[torch.arange(B) % len(COND_PROMPTS)], x1.expand(B, -1, -1, -1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_ms, i_ms = time_ms_turns([lambda: clip.encode_text(tok_b),
                                        lambda: clip.encode_image(img_b)], reps=10)
            peak = torch.cuda.max_memory_allocated()
            out[f"clip_B{B}"] = {"text_ms": t_ms, "image_ms": i_ms, "peak_bytes": peak}
            log(f"[condition] CLIP at B {B}: text tower {t_ms:.3f} ms, image tower {i_ms:.3f} ms, "
                f"peak memory allocated {peak / 2**30:.3f} GiB")

    mdm = text_mdm().to(dev)
    n0 = sum(ak.qkv_attention.launches.values())
    lat, dt = cfg_sample(mdm, "ddim", dev, L=COND_LATENT, context=text[:2].to(dev))
    n = sum(ak.qkv_attention.launches.values()) - n0
    err = float((lat.cpu() - ref["latents"]).abs().max())
    log(f"[condition] text MDM (224 ch, latent {COND_LATENT}), CFG 2.5, B=2 (K2 at B 4), DDIM over "
        f"{CFG_STEPS}: {dt:.2f}s, card vs CPU max abs {err!r} (bar 1e-3), K2 launches {n}, "
        f"latent std {float(lat.std()):.3f}")
    if n != 16 * 50 or not err <= 1e-3:
        raise RuntimeError(f"condition: text DDIM K2 launches {n} (want 800), card vs CPU {err}")
    out.update(ddim_s=dt, ddim_card_vs_cpu=err)
    del mdm

    # (c), run during the CPU references (condition_cli_chain): its launches count here
    try:
        for module, faces, dt, launched in chain["runs"]:
            log(f"[condition] {module} (latent {COND_LATENT}, {COND_RES}^3, ddim50 CFG 2.5): "
                f"{dt:.1f}s (the four CLIs at once, during the CPU references), {faces} faces, "
                f"launches {json.dumps(launched)}")
        tmp = chain["tmp"].name
        ctx_dir = os.path.join(tmp, "data", "train", "chair")
        with torch.no_grad():
            for fid in ("a01", "b02"):
                want = clip.encode_image(torch.from_numpy(clip_input(read_rgb(
                    os.path.join(tmp, "sketches", fid, "sketch_0.png")))[None]).to(dev))[0].cpu()
                got = torch.from_numpy(np.load(os.path.join(ctx_dir, f"{fid}.context.npy")))
                gap = float((got - want).abs().max())
                if not gap <= COND_CLIP_BAR:
                    raise RuntimeError(f"encode_contexts: {fid} {gap} from the in-process encode")
    finally:
        chain["tmp"].cleanup()
    log(f"[condition] encode_contexts --mode sketch, two items: "
        f"{chain['walls']['encode_contexts']:.1f}s, .context.npy within {COND_CLIP_BAR:g} of "
        f"this process's encode")
    with _CHILD_LOCK:
        CHILD_LAUNCHES.update(chain["launches"])
    out["cli_s"] = chain["walls"]
    counts = launch_counts()
    k2_64 = {f"qkv_attention_T{T}_c{c}": counts.get(f"qkv_attention_T{T}_c{c}", 0)
             for T, c, B in K2_TIMED if B == 4}
    if not (all(k2_64.values()) and counts["folded_mlp_f32"] and counts["folded_mlp_bf16"]):
        raise RuntimeError(f"condition: launches {counts}; want K2 at latent 64, K1 f32 and bf16")
    return out


# Diffusion training (phase train): the full-width category MDM at the
# reference's batch of 2, latent 32 (what generate_cat samples).
TRAIN_STEPS = 3
TRAIN_EMA = 0.9  # fast enough that 3 steps move the EMA off its init
TRAIN_COND_P = 0.1
# cond_mask_prob 0.1, injected: one of the six examples dropped, so that the
# null class's row trains within the three steps
TRAIN_DROP = ((False, False), (False, True), (False, False))
# Card against the port's CPU run from the same init, batches, t, weights,
# noise and masks: the relative loss gap of each step; step 1's gradient
# gap, max |Δg| / max |g| per tensor and over all tensors; after the 3
# steps, the params' and the EMA's max abs gap where step 1's |g| > 1e-4
# (nearer 0 Adam's m / (√v + ε) turns f32 rounding into lr-sized moves).
# PERF.md gives the readings, sound and with the planted faults, they were
# set from. Readings on an NVIDIA H100 80GB HBM3 at 700 W, loss / tensor /
# global / params / EMA: sound 9.39e-7 / 4.07e-5 / 3.17e-6 / 7.48e-6 /
# 1.42e-6; TF32 on 3.05e-4 / 1.93e-3 / 8.00e-4 / 4.79e-4 / 9.67e-5; the
# attention output detached 0.424 / 1.43 / 0.118 / 6.01e-4 / 1.12e-4 (the 64
# qkv-conv and norm tensors get no gradient); the optimizer step skipped
# params 3.01e-4, EMA 5.62e-5; the EMA not updated, EMA 5.62e-5. Each bar
# sits between the sound reading and the nearest fault.
TRAIN_BARS = {"loss": 1e-5, "grad_tensor": 3e-4, "grad_global": 5e-5, "params": 3e-5,
              "ema": 1e-5}
# The planted faults of phase train, each with the bar that must catch it.
TRAIN_FAULTS = {"attention output detached": "grad_global", "TF32 on": "grad_global",
                "optimizer step skipped": "params", "EMA not updated": "ema"}
TRAIN_TIMED = 20  # steps timed at latent 32
TRAIN_TIMED_64 = 20  # steps of the latent-64 MDM (text2shape / pix3d presets)
# use_remat (phase train): the category MDM with res-block dropout 0.1 from a
# seeded CUDA generator, remat on against off, within TRAIN_BARS; each planted
# fault must fail its bar, and the generator must end in the same state. The
# runs compared take cuDNN's deterministic algorithms: with its default ones
# two plain runs with dropout read params 1.96e-4 and EMA 5.31e-5 apart on an
# NVIDIA H100 80GB HBM3 at 700 W, over TRAIN_BARS (remat_checks logs that
# spread in every run); deterministic, they and the remat run are bit-equal.
REMAT_DROPOUT = 0.1
REMAT_FAULTS = {"mask redrawn in the recomputation": "grad_global",
                "checkpoint input detached": "grad_global"}
REMAT_TIMED = 10  # steps timed at each batch, remat on and off
REMAT_BATCHES = (2, 32)


def train_inputs(L: int = 32, steps: int = TRAIN_STEPS, seed: int = 30):
    """`steps` of (batch, t, weights, noise, cond_drop), numpy, seeded: the
    category batch of 2 (latents, class ids), uniform t, weights around 1."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(steps):
        batch = {"latents": (0.5 * rng.normal(size=(2, L))).astype(np.float32),
                 "action": rng.integers(0, 9, size=2).astype(np.int32)}
        t = rng.integers(0, 1000, size=2).astype(np.int32)
        w = rng.uniform(0.5, 1.5, size=2).astype(np.float32)
        noise = rng.normal(size=(2, L, 1)).astype(np.float32)
        out.append((batch, t, w, noise, np.asarray(TRAIN_DROP[k % len(TRAIN_DROP)])))
    return out


def train_run(dev, init: dict, mesh=None, generator=None, **mdm_kw) -> dict:
    """The category MDM from the state dict `init` trained TRAIN_STEPS steps
    on `dev` from train_inputs(), EMA on: each step's loss, step 1's
    gradients (on the CPU; a parameter that got none reads zeros), then the
    params and EMA. `mesh`: data parallel (DDP) over its 'data' axis.
    `generator`: the steps' torch.Generator (the res-block dropout's draws);
    `mdm_kw`: MDM's settings (dropout, use_remat)."""
    from surfd_tpu_torch.diffusion import named_schedule
    from surfd_tpu_torch.models import MDM
    from surfd_tpu_torch.training import create_train_state, make_optimizer, make_train_step

    mdm = MDM(cond_mode="category", num_actions=9, **mdm_kw)
    mdm.load_state_dict(init, strict=True)
    mdm.to(dev)
    state = create_train_state(mdm, make_optimizer(mdm.parameters(), 1e-4), ema_rate=TRAIN_EMA)
    step = make_train_step(mdm, named_schedule("cosine", 1000), cond_mask_prob=TRAIN_COND_P,
                           mesh=mesh)
    out = {"loss": []}
    for k, (batch, t, w, noise, drop) in enumerate(train_inputs()):
        if k == 0:
            loss, _ = step.loss_fn(batch, t, w, noise=noise, cond_drop=drop, generator=generator)
            loss.backward()
            out["grads"] = {n: (p.grad if p.grad is not None else torch.zeros_like(p)
                                ).detach().cpu() for n, p in mdm.named_parameters()}
            mdm.zero_grad(set_to_none=True)
        out["loss"].append(float(step(state, batch, t, w, noise=noise, cond_drop=drop,
                                      generator=generator)["loss"]))
    out["params"] = {n: p.detach().cpu() for n, p in mdm.named_parameters()}
    out["ema"] = {n: e.cpu() for n, e in zip(out["params"], state.ema)}
    return out


def train_gaps(got: dict, ref: dict) -> dict:
    """A run's gaps to the CPU reference, under TRAIN_BARS' keys."""
    mask = {n: g.abs() > 1e-4 for n, g in ref["grads"].items()}

    def masked(key):
        return max(float((got[key][n] - r)[mask[n]].abs().max())
                   for n, r in ref[key].items() if mask[n].any())

    per = {}
    for n, r in ref["grads"].items():
        scale = float(r.abs().max())
        per[n] = float((got["grads"][n] - r).abs().max()) / scale if scale else 0.0
    top = max(float(r.abs().max()) for r in ref["grads"].values())
    worst = max(per, key=per.get)
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
        "grad_tensor": per[worst], "grad_tensor_name": worst,
        "grad_global": max(float((got["grads"][n] - r).abs().max())
                           for n, r in ref["grads"].items()) / top,
        "attention_grads_zero": sum(int(not got["grads"][n].any()) for n in ref["grads"]
                                    if ".qkv." in n or ".norm." in n),
        "params": masked("params"), "ema": masked("ema"),
    }


def within_train_bars(gaps: dict) -> bool:
    return all(gaps[k] <= bar for k, bar in TRAIN_BARS.items())


@contextlib.contextmanager
def planted_train_fault(name: str):
    """One of TRAIN_FAULTS in place for the block, undone after it."""
    from unittest import mock

    from surfd_tpu_torch.models import unet1d
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.training import common
    from surfd_tpu_torch.utils import use_full_f32

    with contextlib.ExitStack() as undo:
        undo.callback(use_full_f32)
        if name == "attention output detached":  # K2 as the port had it before K2-bwd
            undo.enter_context(mock.patch.object(
                unet1d, "qkv_attention", lambda qkv, h: ak.qkv_attention(qkv.detach(), h)))
        elif name == "TF32 on":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        elif name == "optimizer step skipped":  # params and AdamW's moments stay as they were
            undo.enter_context(mock.patch.object(torch.optim.AdamW, "step",
                                                 lambda self, closure=None: None))
        elif name == "EMA not updated":
            undo.enter_context(mock.patch.object(common, "ema_update", lambda *args: None))
        else:
            raise ValueError(name)
        yield


def train_reference() -> dict:
    """The port's CPU run of train_run from category_mdm()'s weights (kept
    as ref["init"] for the card's runs), outside the counted paths."""
    init = category_mdm().state_dict()
    t0 = time.perf_counter()
    ref = train_run(torch.device("cpu"), init)
    ref["s"] = time.perf_counter() - t0
    ref["init"] = init
    return ref


def _k2_counts() -> tuple:
    from surfd_tpu_torch.ops import attention_kernel as ak

    return (sum(ak.qkv_attention.launches.values()),
            sum(ak.qkv_attention_bwd.launches.values()))


def time_train_steps(mdm, dev, cond: str, L: int, steps: int, label: str,
                     profiled: bool = False, mesh=None, B: int = 2) -> dict:
    """`steps` train steps of `mdm` at batch B through DiffusionTrainer.run
    (numpy batches, uniform timesteps, noise and masks from a CUDA
    generator), after 5 steps of warm-up: ms a step on the host clock, peak
    memory allocated, K2 and K2-bwd launches (exactly 16 each a step); with
    `profiled`, the device busy share of 10 more steps under torch.profiler;
    `mesh`: DDP."""
    from surfd_tpu_torch.diffusion import named_schedule
    from surfd_tpu_torch.training import (
        DiffusionTrainConfig,
        DiffusionTrainer,
        create_train_state,
        make_optimizer,
    )

    rng = np.random.default_rng(31)

    def batches():
        while True:
            b = {"latents": (0.5 * rng.normal(size=(B, L))).astype(np.float32)}
            if cond == "category":
                b["action"] = rng.integers(0, 9, size=B).astype(np.int32)
            else:
                b["context"] = rng.normal(size=(B, 512)).astype(np.float32)
            yield b

    cfg = DiffusionTrainConfig(batch_size=B, cond_mask_prob=TRAIN_COND_P, log_interval=10**9,
                               save_interval=10**9, stall_exit_s=0)
    state = create_train_state(mdm, make_optimizer(mdm.parameters(), 1e-4))
    trainer = DiffusionTrainer(cfg, mdm, named_schedule("cosine", 1000), state, batches(),
                               generator=torch.Generator(device=dev).manual_seed(11), mesh=mesh)
    trainer.run(5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k2, bwd = _k2_counts()
    t0 = time.perf_counter()
    trainer.run(5 + steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    k2, bwd = _k2_counts()[0] - k2, _k2_counts()[1] - bwd
    peak = torch.cuda.max_memory_allocated()
    if (k2, bwd) != (16 * steps, 16 * steps):
        raise RuntimeError(f"{label}: K2 {k2}, K2-bwd {bwd} launches in {steps} steps; "
                           f"want {16 * steps} each")
    busy = None
    if profiled:
        wall_us, busy_us = _profiled(f"train {label}, 10 steps",
                                     lambda: trainer.run(state.step + 10), steps=10,
                                     named=("qkv_attention_kernel", "qkv_attention_bwd"))
        busy = None if busy_us is None else busy_us / wall_us
    log(f"[train] {label}: {ms:.2f} ms a step over {steps} steps, peak memory allocated "
        f"{peak / 2**30:.3f} GiB, K2 {k2} and K2-bwd {bwd} launches, device busy "
        + ("not measured" if busy is None else f"{100 * busy:.1f} %"))
    return {"ms_per_step": ms, "peak_bytes": peak, "k2": k2, "k2_bwd": bwd, "busy_share": busy}


@contextlib.contextmanager
def planted_remat_fault(name: str):
    """One of REMAT_FAULTS in ResBlock1D's remat route for the block."""
    from unittest import mock

    from torch.utils.checkpoint import checkpoint

    from surfd_tpu_torch.models.unet1d import ResBlock1D

    def faulty(self, x, emb):
        if not (self.use_remat and torch.is_grad_enabled()):
            return self._forward(x, emb)
        if name == "mask redrawn in the recomputation":  # the mask drawn inside
            return checkpoint(self._forward, x, emb, use_reentrant=False)
        if name == "checkpoint input detached":
            keep = self.out_layers[2].draw(
                x.new_empty((x.shape[0], self.out_channels) + tuple(x.shape[2:])))
            return checkpoint(self._forward, x.detach(), emb, keep, use_reentrant=False)
        raise ValueError(name)

    with mock.patch.object(ResBlock1D, "forward", faulty):
        yield


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the block."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def remat_run(dev, init: dict, remat: bool) -> dict:
    """train_run with res-block dropout REMAT_DROPOUT drawn from a CUDA
    generator of seed 12, remat on or off: also the K2 and K2-bwd launches
    and the generator's state after the steps."""
    g = torch.Generator(device=dev).manual_seed(12)
    k0 = _k2_counts()
    out = train_run(dev, init, generator=g, dropout=REMAT_DROPOUT, use_remat=remat)
    out["k2"] = tuple(b - a for a, b in zip(k0, _k2_counts()))
    out["rng"] = g.get_state()
    return out


def remat_checks(dev, init: dict) -> dict:
    """use_remat on the card: 3 steps with dropout against the same steps
    without remat (TRAIN_BARS; cuDNN deterministic), equal launches and
    generator state; each of REMAT_FAULTS fails its bar. Logged first, not
    held: two plain runs and a remat run with cuDNN's default algorithms,
    the spread that the deterministic ones remove."""
    a, b, r = (remat_run(dev, init, remat) for remat in (False, False, True))
    spread = {"plain vs plain": train_gaps(b, a), "remat vs plain": train_gaps(r, a)}
    log("[train] cuDNN's default algorithms, dropout 0.1: "
        + "; ".join(f"{k} {json.dumps(v)}" for k, v in spread.items()))
    with cudnn_deterministic():
        plain = remat_run(dev, init, False)
        got = remat_run(dev, init, True)
        gaps = train_gaps(got, plain)
        same_rng = torch.equal(got["rng"], plain["rng"])
        bit_equal = all(torch.equal(got[k][n], plain[k][n]) for k in ("grads", "params", "ema")
                        for n in plain[k])
        log(f"[train] remat vs plain, 3 steps of the full-width category MDM, dropout "
            f"{REMAT_DROPOUT}, cuDNN deterministic: gaps {json.dumps(gaps)}; bit-equal "
            f"{bit_equal}; K2 / K2-bwd {got['k2']} vs {plain['k2']}; generator state "
            f"{'equal' if same_rng else 'differs'}")
        if not within_train_bars(gaps) or got["k2"] != plain["k2"] or not same_rng:
            raise RuntimeError("train: remat is off the plain steps")
        faults = {}
        for name, key in REMAT_FAULTS.items():
            with planted_remat_fault(name):
                f = faults[name] = train_gaps(remat_run(dev, init, True), plain)
            log(f"[train] planted remat fault, {name}: " + json.dumps(f))
            if not f[key] > TRAIN_BARS[key]:
                raise RuntimeError(f"train: bar {key} passes a planted remat fault: {name}")
    return {"gaps": gaps, "bit_equal": bit_equal, "faults": faults, "default_cudnn": spread}


def remat_timed(dev, init: dict) -> dict:
    """ms a step and peak memory at REMAT_BATCHES, remat off and on in
    turns (cuDNN's default algorithms)."""
    from surfd_tpu_torch.models import MDM

    timed = {}
    for B in REMAT_BATCHES:
        for remat in (False, True):
            mdm = MDM(cond_mode="category", num_actions=9, dropout=REMAT_DROPOUT,
                      use_remat=remat)
            mdm.load_state_dict(init)
            timed[f"B{B}_{'remat' if remat else 'plain'}"] = time_train_steps(
                mdm.to(dev), dev, "category", 32, REMAT_TIMED,
                f"category MDM, latent 32, B {B}, dropout {REMAT_DROPOUT}, remat "
                + ("on" if remat else "off"), B=B)
            del mdm
    return timed


def write_class_list(path: str) -> None:
    """The nine garment classes, one line each, naming phase recon's items."""
    from surfd_tpu_torch.cli.generate_cat import GARMENT_CLASSES

    items = {"dress": "dress_000", "long-skirt": "skirt_001"}
    with open(path, "w") as f:
        f.writelines(f"{c} {items[c]}\n" if c in items else f"{c}\n" for c in GARMENT_CLASSES)


TRAIN_CLI_STEPS = (10, 20)  # train_diffusion's first run, then --resume to the second


def train_cli_chain(tmp: str) -> dict:
    """(c) of phase train in subprocesses, on the corpus in `tmp`:
    train_diffusion for TRAIN_CLI_STEPS[0] steps, --resume to [1], then
    generate_cat reading the run."""
    first, last = TRAIN_CLI_STEPS
    save = os.path.join(tmp, "run")
    argv = ["--data_root", os.path.join(tmp, "data", "test"), "--ae_dir",
            os.path.join(tmp, "ae"), "--save_dir", save, "--cond_mode", "category",
            "--category_list", os.path.join(tmp, "classes.txt"), "--precompute_latents",
            "--cond_mask_prob", str(TRAIN_COND_P), "--save_interval", "10",
            "--log_interval", "10"]
    walls = []
    for extra in (["--num_steps", str(first)], ["--num_steps", str(last), "--resume"]):
        dt, lines, launches = run_cli("train_diffusion", argv + extra, "train")
        walls.append(dt)
        steps = int(extra[1]) - (first if "--resume" in extra else 0)
        k2 = sum(n for k, n in launches.items() if k.startswith("qkv_attention_T"))
        bwd = sum(n for k, n in launches.items() if k.startswith("qkv_attention_bwd"))
        if (k2, bwd) != (16 * steps, 16 * steps):
            raise RuntimeError(f"train_diffusion: K2 {k2}, K2-bwd {bwd} in {steps} steps")
        if "--resume" in extra and not any(f"resumed at step {first}" in x for x in lines):
            raise RuntimeError(f"train_diffusion --resume did not resume at step {first}")
    ckpts = sorted(os.listdir(os.path.join(save, "ckpt")))
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    saved = list(range(10, last + 1, 10))
    if ckpts != [f"step_{s:09d}.pt" for s in saved] or [r["step"] for r in rows] != saved or (
            not all(np.isfinite(r["loss"]) for r in rows)):
        raise RuntimeError(f"train_diffusion wrote {ckpts}, metrics {rows}")
    gen = os.path.join(tmp, "gen")
    dt, lines, _ = run_cli("generate_cat", [
        "--model_path", save, "--ae_dir", os.path.join(tmp, "planted"), "--category",
        "dress", "--category_list", os.path.join(tmp, "classes.txt"), "--sampler", "ddim",
        "--timestep_respacing", "ddim50", "--resolution", "128", "--num_samples", "1",
        "--output_dir", gen], "train")
    walls.append(dt)
    if not any(f"denoiser: step {last} of {os.path.join(save, 'ckpt')}" in x for x in lines):
        raise RuntimeError("generate_cat did not read the trained run")
    obj = os.path.join(gen, "cat0_0.obj")
    if not os.path.getsize(obj):
        raise RuntimeError("generate_cat wrote an empty OBJ")
    log(f"[train] train_diffusion {first} steps {walls[0]:.1f}s, --resume to {last} "
        f"{walls[1]:.1f}s, generate_cat from the run {walls[2]:.1f}s ({os.path.getsize(obj)} "
        f"bytes of OBJ); losses at {saved}: {[r['loss'] for r in rows]}")
    return {"cli_s": walls, "metrics": rows, "obj_bytes": os.path.getsize(obj)}


def phase_train(dev, ref):
    """Diffusion training at the full-width category MDM, B 2, latent 32:
    (a) 3 steps on the card against the port's CPU run (`ref`:
    train_reference()) from the same init, batches, t, weights, noise and
    masks, EMA on; each of TRAIN_FAULTS (the attention output detached, K2
    without its gradient as before K2-bwd; TF32 on; the optimizer step
    skipped; the EMA not updated) must fail its bar; (a') use_remat with
    dropout 0.1 against the same steps without it (`remat_checks`); (c)
    `train_cli_chain` in subprocesses, which runs while (a) and (a')'s
    checks do; then, alone on the card, (a')'s timings and (b) 20 steps
    timed, and 20 of the latent-64 MDM."""
    from surfd_tpu_torch.models import MDM

    out = {"cpu_reference_s": ref["s"]}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as ex:
        t0 = time.perf_counter()
        write_recon_corpus(tmp, dev)
        write_class_list(os.path.join(tmp, "classes.txt"))
        write_planted_decoder(os.path.join(tmp, "planted"), latent_size=32)
        out["corpus_s"] = time.perf_counter() - t0
        chain = ex.submit(train_cli_chain, tmp)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = train_run(dev, ref["init"])
        torch.cuda.synchronize()
        out["card_s"] = time.perf_counter() - t0
        gaps = out["sound"] = train_gaps(got, ref)
        log(f"[train] card vs CPU, 3 steps of the full-width category MDM ({out['card_s']:.2f}s, "
            f"CPU {ref['s']:.2f}s): losses {got['loss']} vs {ref['loss']}; gaps "
            + json.dumps(gaps) + f" (bars {json.dumps(TRAIN_BARS)})")
        if not within_train_bars(gaps) or gaps["attention_grads_zero"]:
            raise RuntimeError("train: the card's train step is off the CPU run's bars")

        faults = {}
        for name, key in TRAIN_FAULTS.items():
            with planted_train_fault(name):
                f = faults[name] = train_gaps(train_run(dev, ref["init"]), ref)
            log(f"[train] planted fault, {name}: " + json.dumps(f))
            if not f[key] > TRAIN_BARS[key]:
                raise RuntimeError(f"train: bar {key} passes a planted fault: {name}")
        out["faults"] = faults
        log(f"[train] (a) with the faults: {time.perf_counter() - t0:.1f}s")

        t0 = time.perf_counter()
        out["remat"] = remat_checks(dev, ref["init"])
        log(f"[train] (a') remat checks: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        out.update(chain.result())
        log(f"[train] (c) waited {time.perf_counter() - t0:.1f}s more for the CLIs")

    t0 = time.perf_counter()
    out["remat"]["timed"] = remat_timed(dev, ref["init"])
    mdm = MDM(cond_mode="category", num_actions=9)
    mdm.load_state_dict(ref["init"])
    out["timed"] = time_train_steps(mdm.to(dev), dev, "category", 32, TRAIN_TIMED,
                                    "category MDM, latent 32, B 2", profiled=True)
    mdm = MDM(cond_mode="sketch")
    mdm.Unet.random_init_(torch.Generator().manual_seed(1))
    out["timed_64"] = time_train_steps(mdm.to(dev), dev, "sketch", 64, TRAIN_TIMED_64,
                                       "sketch MDM, latent 64, B 2")
    del mdm
    log(f"[train] (a') timings and (b): {time.perf_counter() - t0:.1f}s")
    return out


# AE training (phase ae): the deepfashion3d preset (latent 32, the CBN decoder
# 512 wide with 5 blocks, DGCNN k 20, 10,000 cloud points and 20,000 queries
# an item, batch 8, max_dist 0.1, lr 1e-4, grad-loss weight 0.1).
AE_LATENT, AE_HIDDEN, AE_LAYERS, AE_B, AE_Q = 32, 512, 5, 8, 20_000
# Card against the port's CPU run: the batch cut to 2 x 4,096 queries (the
# clouds stay 10,000 points), so that the CPU side takes about a minute.
AE_CHECK_B, AE_CHECK_Q = 2, 4096
AE_NAN_STEP = 2  # of 4 steps: a NaN in this batch's cloud, the step skipped
# Biases that only BatchNorms read (through the residual stream): their
# gradient is 0 in exact arithmetic, so each side reads rounding noise. They
# are held by the global gradient bar only.
AE_BN_CANCELLED = ("decoder.fc_p.bias", ".fc_0.bias", ".fc_1.bias")
# Card against the port's CPU run from the same init and batches, over the
# steps not skipped: the loss terms' relative gaps; the gradient gaps, max
# |Δg| / max |g| per tensor (decoder and encoder apart) and over all tensors;
# after the steps, the params' max abs gap where every step's |g| is > 1e-4
# or exactly 0, and every BatchNorm running buffer's max |Δ| / max(1, |CPU|).
# PERF.md gives the readings, sound and with the planted faults, they were
# set from. Readings on an NVIDIA H100 80GB HBM3 at 700 W,
# loss / decoder / encoder / global / params / buffers: sound 1.83e-6 /
# 1.03e-2 / 6.71e-3 / 2.07e-4 / 1.24e-6 / 5.17e-5; TF32 on 4.83e-5 / 6.44e-2 /
# 0.724 / 1.34e-2 / 3.19e-4 / 4.43e-4; without create_graph 2.98e-2 / 0.904 /
# 0.711 / 0.158 / 6.00e-4 / 1.34e-3; statistics detached 1.90 / 20.1 / 0.309 /
# 0.777 / 6.01e-4 / 2.67e-2; momentum 0.9, buffers 1.12; buffers kept, NaN.
# Each bar sits between the sound reading and the nearest fault.
AE_BARS = {"loss": 1e-5, "grad_decoder": 3e-2, "grad_encoder": 5e-2, "grad_global": 2e-3,
           "params": 2e-5, "buffers": 2e-4}
# The planted faults of phase ae, each with the bar that must catch it.
AE_FAULTS = {"TF32 on": "grad_global",
             "coordinate gradient without create_graph": "grad_global",
             "batch statistics detached in the decoder": "loss",
             "momentum 0.9 on the batch's side": "buffers",
             "BatchNorm buffers kept after a skipped step": "buffers"}
AE_TIMED = 10  # steps timed at the preset's batch
AE_CBN_UNITS = 2 * AE_LAYERS + 1  # the decoder's conditional BatchNorm + ReLU units
AE_GEMMS = 2 * AE_LAYERS  # the blocks' 512 x 512 projections, on the 3xTF32 GEMM
AE_EDGE_BLOCKS = 4  # the DGCNN's edge convolutions, on the edge convolution unit


def ae_step_calls(steps: int) -> dict:
    """The hand-written kernels' calls in `steps` AE steps on the card: the
    fused CBN unit's stages (each unit's forward, its backward in the
    create-graph gradient and in loss.backward(), and its second derivative
    there), the GEMM's forms (each projection's forward NT, create-graph
    input gradient NN, and in loss.backward() the forward's input (NN) and
    weight (TN) gradients and the gradient graph's (NT, TN)) and the
    encoder's edge convolution units (a forward, and a backward in
    loss.backward())."""
    n, p, e = AE_CBN_UNITS * steps, AE_GEMMS * steps, AE_EDGE_BLOCKS * steps
    return {"cbn_train_forward": n, "cbn_train_backward": 2 * n, "cbn_train_backward2": n,
            "gemm_tf32x3_nt": 2 * p, "gemm_tf32x3_nn": 2 * p, "gemm_tf32x3_tn": 2 * p,
            "edgeconv_train_forward": e, "edgeconv_train_backward": e}


def launches_since(before: dict) -> dict:
    """The launch rows of kernel_calls() that grew since `before` (an
    earlier kernel_calls()), by how much."""
    from surfd_tpu_torch.ops import kernel_calls

    now = kernel_calls()
    if now["plain_calls"] != before["plain_calls"]:
        raise RuntimeError(f"plain-version calls: {now['plain_calls']} vs {before['plain_calls']}")
    return {k: n - before["launches"].get(k, 0) for k, n in now["launches"].items()
            if n != before["launches"].get(k, 0)}


def ae_batches(B: int, Q: int, steps: int, seed: int) -> list:
    """`steps` AE batches, numpy, seeded: item i's cloud on a sphere of
    radius 0.35 + 0.1 i (10,000 points, 0.005 of noise), its queries within
    0.15 of it, the clipped UDF labels (about two thirds inside the grad
    loss's mask) and the unit radial gradients."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        rad = (0.35 + 0.1 * np.arange(B))[:, None, None]
        d = rng.normal(size=(B, RECON_POINTS, 3))
        pcd = rad * d / np.linalg.norm(d, axis=-1, keepdims=True)
        r = rad + rng.uniform(-0.15, 0.15, (B, Q, 1))
        d = rng.normal(size=(B, Q, 3))
        unit = d / np.linalg.norm(d, axis=-1, keepdims=True)
        out.append({"pcd": (pcd + 0.005 * rng.normal(size=pcd.shape)).astype(np.float32),
                    "coords": (r * unit).astype(np.float32),
                    "udf": np.minimum(np.abs(r - rad)[..., 0], 0.1).astype(np.float32),
                    "gradients": (np.sign(r - rad) * unit).astype(np.float32)})
    return out


def ae_inputs() -> list:
    """Phase ae's card-vs-CPU batches: 4 steps at AE_CHECK_B x AE_CHECK_Q, a
    NaN planted in the cloud of step AE_NAN_STEP (that step is skipped)."""
    batches = ae_batches(AE_CHECK_B, AE_CHECK_Q, 4, seed=40)
    batches[AE_NAN_STEP]["pcd"][1, 17] = np.nan
    return batches


def ae_run(dev, init: dict) -> dict:
    """The AutoEncoder from the state dict `init` on `dev`, trained on
    ae_inputs(): each step's loss terms, skip flag and gradients (on the
    CPU, read as the step hands them to its update), then the params and the
    BatchNorm buffers."""
    from unittest import mock

    from surfd_tpu_torch.training import (
        AutoEncoder,
        ae_trainer,
        create_train_state,
        make_ae_train_step,
        make_optimizer,
    )

    ae = AutoEncoder(AE_LATENT, AE_HIDDEN, AE_LAYERS, k=RECON_K)
    ae.load_state_dict(init, strict=True)
    ae.to(dev)
    state = create_train_state(ae, make_optimizer(ae.parameters(), 1e-4))
    step = make_ae_train_step(ae, max_dist=0.1, grad_loss_weight=0.1)
    out = {"steps": [], "grads": []}
    update = ae_trainer.apply_update_if_finite

    def recorded(st, loss, buffers=None):
        out["grads"].append({n: p.grad.detach().cpu() for n, p in ae.named_parameters()})
        return update(st, loss, buffers)

    with mock.patch.object(ae_trainer, "apply_update_if_finite", recorded):
        for batch in ae_inputs():
            m = step(state, batch)
            out["steps"].append({key: float(m[key]) for key in
                                 ("loss", "udf_loss", "grad_loss", "nonfinite_skipped")})
    out["params"] = {n: p.detach().cpu() for n, p in ae.named_parameters()}
    out["buffers"] = {n: b.detach().cpu() for n, b in ae.named_buffers()
                      if b.is_floating_point()}
    return out


def ae_gaps(got: dict, ref: dict) -> dict:
    """A run's gaps to the CPU reference, under AE_BARS' keys, over the
    steps the reference did not skip (NaN where a side reads NaN: it fails
    every bar). Gradient gaps are per tensor over that step's max |g| (the
    tensors whose reference gradient is 0 at a step are held by the global
    bar there: at the JAX-scheme init the zero CBN kernels cut the latent
    off, so the encoder's step-1 gradient is 0). The params' gap is read
    where every step's |g| is > 1e-4 or exactly 0."""
    def rel(a, b):
        return abs(a - b) / abs(b) if np.isfinite(a) and np.isfinite(b) else float("nan")

    def nan_max(vals):
        vals = list(vals)
        return float("nan") if any(np.isnan(v) for v in vals) else max(vals)

    kept = [k for k, r in enumerate(ref["steps"]) if not r["nonfinite_skipped"]]
    per, glob = {}, []
    for k in kept:
        g, r = got["grads"][k], ref["grads"][k]
        for n, rv in r.items():
            scale = float(rv.abs().max())
            if scale and not n.endswith(AE_BN_CANCELLED):
                per[(k, n)] = float((g[n] - rv).abs().max()) / scale
        glob.append(max(float((g[n] - rv).abs().max()) for n, rv in r.items())
                    / max(float(rv.abs().max()) for rv in r.values()))
    worst = {part: max((key for key in per if key[1].startswith(part)), key=per.get)
             for part in ("decoder.", "encoder.")}
    mask = {}
    for n in ref["params"]:
        g = torch.stack([ref["grads"][k][n].abs() for k in kept])
        mask[n] = ((g > 1e-4) | (g == 0)).all(0) & (g > 1e-4).any(0)
    return {
        "loss": nan_max(rel(got["steps"][k][key], ref["steps"][k][key]) for k in kept
                        for key in ("loss", "udf_loss", "grad_loss")),
        "grad_decoder": per[worst["decoder."]], "grad_decoder_at": worst["decoder."],
        "grad_encoder": per[worst["encoder."]], "grad_encoder_at": worst["encoder."],
        "grad_global": nan_max(glob),
        "params": nan_max(float((got["params"][n] - r)[mask[n]].abs().max())
                          for n, r in ref["params"].items() if mask[n].any()),
        "buffers": nan_max(float(((got["buffers"][n] - r).abs() / r.abs().clamp(min=1.0)).max())
                           for n, r in ref["buffers"].items()),
        "skips": [g["nonfinite_skipped"] for g in got["steps"]],
    }


def within_ae_bars(gaps: dict) -> bool:
    """Every gap within its bar (a NaN is not), and only the NaN step skipped."""
    return all(gaps[k] <= bar for k, bar in AE_BARS.items()) and gaps["skips"] == [
        float(k == AE_NAN_STEP) for k in range(4)]


def _cbn_stats_detached(x, gamma, beta, bn):
    """The decoder's train-mode CBN + ReLU unit (the fused unit's entry) with
    the batch statistics cut out of the graph (the running buffers move as
    the sound one moves them)."""
    flat = x.reshape(-1, x.shape[-1])
    mean = flat.mean(0).detach()
    var = torch.clamp(flat.square().mean(0) - mean.square(), min=0.0).detach()
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
    return torch.relu(gamma[:, None] * ((x - mean) * torch.rsqrt(var + bn.eps)) + beta[:, None])


@contextlib.contextmanager
def planted_ae_fault(name: str):
    """One of AE_FAULTS in place for the block, undone after it."""
    from unittest import mock

    from surfd_tpu_torch.models import decoder, dgcnn, layers
    from surfd_tpu_torch.ops import cbn_train, edgeconv_train
    from surfd_tpu_torch.training import ae_trainer
    from surfd_tpu_torch.utils import use_full_f32

    def momentum_09(x, bn, training):  # torch's 0.1 read as flax's 0.9
        bn.momentum = 0.9
        return layers.batch_norm(x, bn, training)

    def cbn_momentum_09(x, gamma, beta, bn):
        bn.momentum = 0.9
        return cbn_train.cbn_relu_train(x, gamma, beta, bn)

    def edgeconv_momentum_09(x, adj, weight, bn):
        bn.momentum = 0.9
        return edgeconv_train.edgeconv_train(x, adj, weight, bn)

    with contextlib.ExitStack() as undo:
        undo.callback(use_full_f32)
        if name == "TF32 on":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        elif name == "coordinate gradient without create_graph":  # the grad loss trains nothing
            undo.enter_context(mock.patch.object(
                ae_trainer, "coords_gradient",
                lambda u, c: torch.autograd.grad(u, c, torch.ones_like(u), retain_graph=True)[0]))
        elif name == "batch statistics detached in the decoder":  # the fused unit's entry
            undo.enter_context(mock.patch.object(decoder, "cbn_relu_train", _cbn_stats_detached))
        elif name == "momentum 0.9 on the batch's side":
            undo.enter_context(mock.patch.object(decoder, "cbn_relu_train", cbn_momentum_09))
            undo.enter_context(mock.patch.object(dgcnn, "batch_norm", momentum_09))
            undo.enter_context(mock.patch.object(dgcnn, "edgeconv_train", edgeconv_momentum_09))
        elif name == "BatchNorm buffers kept after a skipped step":
            undo.enter_context(mock.patch.object(ae_trainer, "snapshot_buffers",
                                                 lambda model: []))
        else:
            raise ValueError(name)
        yield


def ae_init() -> dict:
    """The AutoEncoder at the preset's widths, initialised as the JAX
    package's init_ae initialises it, from seed 12: its state dict."""
    from surfd_tpu_torch.training import AETrainConfig, init_ae

    cfg = AETrainConfig(latent_size=AE_LATENT, hidden_dim=AE_HIDDEN, num_hidden_layers=AE_LAYERS)
    return init_ae(cfg, torch.Generator().manual_seed(12)).state_dict()


def ae_reference() -> dict:
    """The port's CPU run of ae_run from ae_init() (kept as ref["init"] for
    the card's runs), outside the counted paths."""
    init = ae_init()
    t0 = time.perf_counter()
    ref = ae_run(torch.device("cpu"), init)
    ref["s"] = time.perf_counter() - t0
    ref["init"] = init
    return ref


def param_mesh(fn, nu: int, nv: int, wrap_u: bool, wrap_v: bool):
    """A triangle mesh of the surface fn(u, v) -> (..., 3) over a nu x nv
    grid of [0, 1]^2, closed along u and / or v where wrapped."""
    from surfd_tpu_torch.geometry import Mesh

    u = np.linspace(0, 1, nu, endpoint=not wrap_u)
    v = np.linspace(0, 1, nv, endpoint=not wrap_v)
    U, V = np.meshgrid(u, v, indexing="ij")
    I, J = np.meshgrid(np.arange(nu if wrap_u else nu - 1), np.arange(nv if wrap_v else nv - 1),
                       indexing="ij")
    a, b = I * nv + J, (I + 1) % nu * nv + J
    c, d = (I + 1) % nu * nv + (J + 1) % nv, I * nv + (J + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    return Mesh(fn(U, V).reshape(-1, 3).astype(np.float32), faces.astype(np.int64))


def write_ae_meshes(root: str, dev) -> None:
    """root/train: 12 OBJ meshes, open and closed: the sheet fixture's 128^3
    extraction (on the card), spheres, a bowl, tori, open cylinders and wavy
    sheets at several sizes; root/test: a torus and a cylinder."""
    from surfd_tpu_torch.geometry import write_obj
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf, make_udf_fn

    tau = 2 * np.pi

    def sphere(r, top=1.0):  # top < 1: an open bowl
        return param_mesh(lambda U, V: np.stack([
            r * np.sin(np.pi * top * V) * np.cos(tau * U), r * np.sin(np.pi * top * V)
            * np.sin(tau * U), r * np.cos(np.pi * top * V)], -1), 64, 33, True, False)

    def torus(R, r):
        return param_mesh(lambda U, V: np.stack([
            (R + r * np.cos(tau * V)) * np.cos(tau * U), (R + r * np.cos(tau * V))
            * np.sin(tau * U), r * np.sin(tau * V)], -1), 96, 32, True, True)

    def cylinder(r, h):
        return param_mesh(lambda U, V: np.stack([
            r * np.cos(tau * U), r * np.sin(tau * U), h * (V - 0.5)], -1), 96, 24, True, False)

    def wavy(a, f):
        return param_mesh(lambda U, V: np.stack([
            2 * U - 1, 2 * V - 1, a * np.sin(f * tau * U) * np.cos(f * tau * V)], -1),
            64, 64, False, False)

    dec, fx = load_fixture_decoder(dev)
    sheet = get_mesh_from_udf(make_udf_fn(dec, None, torch.from_numpy(fx["latent"]),
                                          fx["max_dist"], device=dev),
                              cfg=MeshExtractionConfig(resolution=128, surface_bias="auto"))
    splits = {
        "train": {"sheet_128": sheet, "sphere_a": sphere(0.5), "sphere_b": sphere(0.8),
                  "bowl": sphere(0.6, 0.6), "torus_a": torus(0.6, 0.2),
                  "torus_b": torus(0.5, 0.3), "torus_c": torus(0.7, 0.1),
                  "cylinder_a": cylinder(0.5, 1.0), "cylinder_b": cylinder(0.3, 1.5),
                  "cylinder_c": cylinder(0.7, 0.6), "wavy_a": wavy(0.2, 1.0),
                  "wavy_b": wavy(0.1, 2.0)},
        "test": {"torus_t": torus(0.55, 0.25), "cylinder_t": cylinder(0.4, 1.2)},
    }
    for split, meshes in splits.items():
        os.makedirs(os.path.join(root, split))
        for name, mesh in meshes.items():
            write_obj(os.path.join(root, split, f"{name}.obj"), mesh)


def time_ae_steps(dev, init: dict) -> dict:
    """The AE step at the preset's batch (AE_B x 10,000 cloud points x AE_Q
    queries) from `init`: AE_TIMED steps on the host clock after 2 of
    warm-up, with the peak memory allocated; then 5 more under
    torch.profiler (device busy share, kernels a step, the top kernels). Of
    the hand-written kernels only the decoder's fused CBN unit, the 3xTF32
    GEMM and the encoder's edge convolution unit run in it (K1 is the folded
    eval decoder of extraction; the step runs the unfolded one), and no
    plain version."""
    from surfd_tpu_torch.training import (
        AutoEncoder,
        create_train_state,
        make_ae_train_step,
        make_optimizer,
    )

    ae = AutoEncoder(AE_LATENT, AE_HIDDEN, AE_LAYERS, k=RECON_K)
    ae.load_state_dict(init, strict=True)
    ae.to(dev)
    state = create_train_state(ae, make_optimizer(ae.parameters(), 1e-4))
    step = make_ae_train_step(ae, max_dist=0.1, grad_loss_weight=0.1)
    batches = ae_batches(AE_B, AE_Q, 2, seed=41)

    def run(n):
        for k in range(n):
            m = step(state, batches[k % 2])
        return m

    run(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = run(AE_TIMED)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / AE_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated()
    wall_us, busy_us = _profiled(f"ae step, B {AE_B} x {AE_Q} queries, 5 steps",
                                 lambda: run(5), steps=5)
    busy = None if busy_us is None else busy_us / wall_us
    log(f"[ae] step at B {AE_B} x {RECON_POINTS} cloud points x {AE_Q} queries: {ms:.2f} ms a "
        f"step over {AE_TIMED} steps, peak memory allocated {peak / 2**30:.3f} GiB, device busy "
        + ("not measured" if busy is None else f"{100 * busy:.1f} %")
        + f"; last loss {float(m['loss']):.5f}")
    return {"ms_per_step": ms, "peak_bytes": peak, "busy_share": busy,
            "device_ms_per_step": None if busy_us is None else busy_us / 5e3}


def phase_ae(dev, ref):
    """AE training at the deepfashion3d preset: (a) 4 steps (one skipped on a
    NaN cloud) on the card against the port's CPU run (`ref`:
    ae_reference()) from the same JAX-scheme init and batches at B 2 x 4,096
    queries; each of AE_FAULTS must fail its bar; (b) the step timed and
    profiled at B 8 x 20,000 queries; (c) the CLI chain in subprocesses:
    preprocess_udfs on 14 numpy-written meshes at its defaults, train_ae
    --config deepfashion3d --curriculum for 6 epochs, then --resume to 10,
    then export_meshes reading the run (its K1 launches count here)."""
    from surfd_tpu_torch.ops import kernel_calls
    from surfd_tpu_torch.utils import Checkpointer
    from surfd_tpu_torch.utils.convert import (
        decoder_state_from_flax,
        dgcnn_state_from_flax,
        load_flax_npz,
    )

    out = {"cpu_reference_s": ref["s"]}
    calls = kernel_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ae_run(dev, ref["init"])
    torch.cuda.synchronize()
    out["card_s"] = time.perf_counter() - t0
    # the step runs the unfolded decoder, not K1 (nor its plain version): of
    # the kernels only the fused CBN unit, the GEMM and the edge convolution
    # unit, each step
    if launches_since(calls) != ae_step_calls(4):
        raise RuntimeError(f"ae: the train steps launched {launches_since(calls)}, want "
                           f"{ae_step_calls(4)}")
    gaps = out["sound"] = ae_gaps(got, ref)
    log(f"[ae] card vs CPU, 4 steps (step {AE_NAN_STEP + 1} a NaN cloud) at B {AE_CHECK_B} x "
        f"{RECON_POINTS} points x {AE_CHECK_Q} queries ({out['card_s']:.2f}s, CPU "
        f"{ref['s']:.2f}s): "
        f"losses {[s['loss'] for s in got['steps']]} vs {[s['loss'] for s in ref['steps']]}; "
        f"gaps {json.dumps(gaps)} (bars {json.dumps(AE_BARS)})")
    faults = {}
    for name, key in AE_FAULTS.items():
        with planted_ae_fault(name):
            f = faults[name] = ae_gaps(ae_run(dev, ref["init"]), ref)
        log(f"[ae] planted fault, {name}: " + json.dumps(f))
    out["faults"] = faults
    passed = [name for name, key in AE_FAULTS.items() if faults[name][key] <= AE_BARS[key]]
    if passed:
        raise RuntimeError(f"ae: the bars pass planted faults: {passed}")
    if not within_ae_bars(gaps):
        raise RuntimeError("ae: the card's train step is off the CPU run's bars")
    log(f"[ae] (a) with the faults: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    calls = kernel_calls()
    out["timed"] = time_ae_steps(dev, ref["init"])
    if launches_since(calls) != ae_step_calls(2 + AE_TIMED + 2 * 5):  # _profiled runs twice
        raise RuntimeError(f"ae: the timed steps launched {launches_since(calls)}")
    torch.cuda.empty_cache()  # the step's ~44 GiB go back to the card for the CLIs
    log(f"[ae] (b): {time.perf_counter() - t0:.1f}s")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        meshes, data, run = (os.path.join(tmp, d) for d in ("meshes", "data", "run"))
        write_ae_meshes(meshes, dev)
        out["meshes_s"] = time.perf_counter() - t0
        walls = {}
        for split, (dt, _, _) in zip(("train", "test"), run_clis([("preprocess_udfs", [
                "--mesh_root", os.path.join(meshes, split), "--out_root", data,
                "--split", split], "ae") for split in ("train", "test")])):
            walls[f"preprocess_{split}"] = dt  # both at once
        argv = ["--config", "deepfashion3d", "--data_root", data, "--save_dir", run,
                "--curriculum", "--curriculum_init", "8", "--curriculum_add", "1",
                "--val_every", "2", "--log_interval", "1"]
        sizes, steps = [], []
        for label, extra in (("train_ae", ["--num_epochs", "6"]),
                             ("train_ae_resume", ["--num_epochs", "10", "--resume"])):
            walls[label], lines, launches = run_cli("train_ae", argv + extra, "ae")
            if not launches.get("cbn_train_backward2") or not all(
                    launches.get(f"gemm_tf32x3_{f}") for f in ("nt", "nn", "tn")) or not all(
                    launches.get(f"edgeconv_train_{s}") for s in ("forward", "backward")) or any(
                    n for k, n in launches.items()
                    if not k.startswith(("cbn_train_", "gemm_tf32x3_", "edgeconv_train_"))):
                raise RuntimeError(f"train_ae launched {launches}: want the CBN unit's, the "
                                   f"GEMM's and the edge convolution unit's alone")
            with open(os.path.join(run, "training_idxes.txt")) as f:
                sizes.append(len(f.read().split()))
            steps.append(Checkpointer(os.path.join(run, "ckpt")).latest_step())
            if "--resume" in extra and not any(f"resumed at step {steps[0]}, epoch 6" in x
                                               for x in lines):
                raise RuntimeError("train_ae --resume did not resume at epoch 6")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(x) for x in f]
        losses = [r["loss"] for r in rows if "loss" in r]
        # curriculum 8 items, one more every 2 epochs: 11 after 6 epochs, 12 after 10;
        # one step an epoch (11 // 8 = 1), 6 then 4
        if sizes != [11, 12] or steps != [6, 10] or len(losses) != 10 or not all(
                np.isfinite(losses)):
            raise RuntimeError(f"train_ae: curriculum {sizes}, steps {steps}, losses {losses}")
        # the npz pair equals the run's last checkpoint
        ckpt = Checkpointer(os.path.join(run, "ckpt")).read()["model"]
        enc = dgcnn_state_from_flax(load_flax_npz(os.path.join(run, "ae_encoder.npz")))
        dec = decoder_state_from_flax(load_flax_npz(os.path.join(run, "ae_decoder.npz")))
        pairs = [(f"encoder.{k}", v) for k, v in enc.items()] + list(dec.items())
        bad = [k for k, v in pairs if not k.endswith("num_batches_tracked")
               and not torch.equal(ckpt[k], v)]
        if bad or len(pairs) != len(ckpt):
            raise RuntimeError(f"train_ae: the npz pair differs from the checkpoint at {bad}")
        recon = os.path.join(tmp, "recon")
        walls["export_meshes"], _, launches = run_cli("export_meshes", [
            "--config", "deepfashion3d", "--data_root", data, "--ae_dir", run,
            "--output_dir", recon, "--resolution", "128"], "ae")
        if not launches["folded_mlp_f32"]:
            raise RuntimeError(f"export_meshes: kernel launches {launches}")
        with open(os.path.join(recon, "recon_metrics.json")) as f:
            summary = json.load(f)
        out.update(cli_s=walls, curriculum=sizes, steps=steps, losses=losses,
                   recon={k: summary[k] for k in ("n", "n_empty", "mean_chamfer",
                                                  "mean_f_score@0.01")},
                   recon_rows=[{k: r.get(k) for k in ("id", "faces", "chamfer", "f_score@0.01")}
                               for r in summary["per_item"]])
        log(f"[ae] meshes {out['meshes_s']:.1f}s; CLI walls {json.dumps(walls)}; curriculum "
            f"{sizes}, steps {steps}; losses {losses}; export_meshes at 128^3 after 10 steps "
            f"from scratch: {json.dumps(out['recon'])}, rows {json.dumps(out['recon_rows'])}")
    counts = launch_counts()
    if not counts["folded_mlp_f32"]:
        raise RuntimeError(f"ae: launches {counts}; want K1 f32 through export_meshes")
    return out


# Data parallel and the last model modules (phase parallel): one process and
# one card, so the process group has world 1 (NCCL); worlds of 2 run on the
# CPU over gloo (tests/test_torch_parallel*.py).
PARALLEL_TIMED = 15  # DDP and plain train steps timed, in turns
PARALLEL_R = 256  # the sharded sheet extraction
GUIDE_STEPS = "50"  # classifier guidance: cosine 1000 respaced to 50 DDPM steps
GUIDE_CLASSES = (2, 7)
GUIDE_SCALE = 1.0  # moves the latents by ~0.96 (max abs) from the unguided run on the CPU
GUIDE_BAR = 1e-3  # card vs the port's CPU run, phase generate's bar
# K2 / K2-bwd launches a guided DDPM step: the MDM's 16 attention blocks, and
# the classifier's 7 (T/c 32/28 twice, 16/56 twice, 8/112 twice, 4/112 once)
# forward under autograd and backward
GUIDE_K2, GUIDE_K2_BWD = 16 + 7, 7
# (f) card vs the port's CPU run: max abs over max(1, max |CPU|). Readings on
# an NVIDIA H100 80GB HBM3 at 700 W, sound / TF32 on: the transformer UNet
# 4.19e-6 / 1.26e-3, the grid AE's latent 1.96e-6 / 9.73e-4, its
# reconstruction 4.34e-6 / 1.49e-3. Each bar sits between the two.
VESTIGIAL_BARS = {"transformer_unet": 1e-4, "grid_ae_latent": 1e-4, "grid_ae": 1e-4}


def seeded_classifier():
    """EncoderUNet1D at its defaults (224 channels, mult (1,2,4,4), attention
    at (4,2,1), 8 heads, the adaptive pool) over the 9 garment classes, LeCun
    weights from seed 12, on the CPU."""
    from surfd_tpu_torch.models import EncoderUNet1D

    return EncoderUNet1D(out_channels=9).random_init_(torch.Generator().manual_seed(12)).eval()


def guidance_denoiser():
    """The unconditional full-width MDM of phase sample (seed 0), on the CPU."""
    from surfd_tpu_torch.models import MDM

    mdm = MDM(cond_mode="no_cond")
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    return mdm.eval()


def guided_sample(mdm, clf, dev):
    """(2, 32) latents of p_sample_loop over GUIDE_STEPS with the classifier's
    cond_fn (toward GUIDE_CLASSES; clf None: unguided) under torch.no_grad(),
    as the samplers run it; injected noise (numpy seed 21). Returns the
    latents and the wall."""
    from surfd_tpu_torch.diffusion import (
        named_beta_schedule,
        p_sample_loop,
        space_timesteps,
        spaced_schedule,
    )
    from surfd_tpu_torch.models import make_classifier_cond_fn

    sched = spaced_schedule(named_beta_schedule("cosine", 1000), space_timesteps(1000, GUIDE_STEPS))
    rng = np.random.default_rng(21)
    noise = torch.from_numpy(rng.normal(size=(2, 32, 1)).astype(np.float32)).to(dev)
    steps = torch.from_numpy(rng.normal(size=(sched.num_timesteps, 2, 32, 1)).astype(np.float32))
    cond_fn = None if clf is None else make_classifier_cond_fn(
        clf, torch.tensor(GUIDE_CLASSES, device=dev), GUIDE_SCALE)
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        lat = p_sample_loop(sched, mdm, (2, 32, 1), device=dev, noise=noise,
                            step_noise=steps.to(dev), cond_fn=cond_fn)
    _sync(dev)
    return lat[..., 0], time.perf_counter() - t0


def vestigial_models():
    """(f)'s two modules with seeded weights, on the CPU, and their inputs:
    UNet1D with the spatial transformer (224 channels, context 512, depth 1)
    at B 2, latent 32, a (2, 1, 512) context; GridAutoencoder (base 32, mult
    (1,2,4), latent 8) on one 32^3 grid."""
    from surfd_tpu_torch.models import GridAutoencoder, UNet1D

    g = torch.Generator().manual_seed(13)
    unet = UNet1D(context_dim=512, use_spatial_transformer=True, transformer_depth=1)
    unet.random_init_(g)
    ae = GridAutoencoder(base_channels=32, channel_mult=(1, 2, 4), latent_channels=8)
    ae.random_init_(g)
    rng = np.random.default_rng(22)
    inputs = {"x": rng.normal(size=(2, 1, 32)), "t": np.array([10, 900]),
              "context": rng.normal(size=(2, 1, 512)),
              "grid": np.abs(rng.normal(size=(1, 1, 32, 32, 32))) * 0.1}
    return unet.eval(), ae.eval(), {k: torch.from_numpy(np.asarray(
        v, np.int64 if k == "t" else np.float32)) for k, v in inputs.items()}


def vestigial_run(unet, ae, inp, dev) -> dict:
    """The transformer UNet's output and the grid AE's latent and
    reconstruction on `dev`, back on the CPU."""
    i = {k: v.to(dev) for k, v in inp.items()}
    with torch.no_grad():
        z = ae.to(dev).encode(i["grid"])
        out = {"transformer_unet": unet.to(dev)(i["x"], i["t"], context=i["context"]),
               "grid_ae_latent": z, "grid_ae": ae.decode(z)}
    _sync(dev)
    return {k: v.cpu() for k, v in out.items()}


def parallel_reference() -> dict:
    """The port's CPU runs of phase parallel's (e) and (f), outside the
    counted paths."""
    t0 = time.perf_counter()
    lat, _ = guided_sample(guidance_denoiser(), seeded_classifier(), torch.device("cpu"))
    unet, ae, inp = vestigial_models()
    return {"guided": lat, "vestigial": vestigial_run(unet, ae, inp, torch.device("cpu")),
            "s": time.perf_counter() - t0}


def _rel_gap(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def run_torchrun(module: str, argv: list, label: str):
    """One CLI of the port under `torch.distributed.run --standalone
    --nproc_per_node 1` in a subprocess; its wall, stderr lines and kernel
    launches (the `kernel calls:` line), which go into CHILD_LAUNCHES. No
    plain-version call may run."""
    from surfd_tpu_torch.cli._common import KERNEL_CALLS

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "1", "-m", f"surfd_tpu_torch.cli.{module}", *argv],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"torchrun {module} failed ({r.returncode}):\n{r.stderr[-4000:]}")
    lines = r.stderr.strip().splitlines()
    calls = [x for x in lines if x.startswith(KERNEL_CALLS)]
    if len(calls) != 1:
        raise RuntimeError(f"torchrun {module}: {len(calls)} kernel-calls lines")
    calls = json.loads(calls[0].removeprefix(KERNEL_CALLS))
    log("\n".join(f"[{label}]   " + line for line in lines[-4:]))
    if calls["plain_calls"]:
        raise RuntimeError(f"{module}: {calls['plain_calls']} plain-version calls")
    with _CHILD_LOCK:
        CHILD_LAUNCHES.update(calls["launches"])
    return dt, lines, calls["launches"]


def phase_parallel(dev, ref):
    """Data parallel over torch.distributed and the JAX package's last
    modules: (a) a world-1 NCCL process group on a FileStore, make_mesh();
    (b) DDP training of phase train's category MDM (its init, batches, t,
    weights, noise, masks): 3 steps against the same steps without the mesh
    within TRAIN_BARS, then the DDP step and the plain one timed in turns
    (16 K2 and 16 K2-bwd launches a step); (c) the sheet at 256^3 with
    cfg.mesh against the unsharded run: faces equal, vertices <= 1e-6, K1 f32
    launches equal; (d) train_diffusion (10 steps on phase recon's corpus)
    and generate_uncond --data_parallel (128^3, the planted sheet decoder)
    under torchrun; (e) classifier guidance of the full-width MDM by the
    default EncoderUNet1D over 50 DDPM steps against the port's CPU run
    (`ref`, GUIDE_BAR), K2 and K2-bwd launches exact, the classifier's
    attention output detached failing the bar; (f) the spatial-transformer
    UNet and the grid AE against the CPU run, TF32 on failing their bars,
    no hand-written kernel launched."""
    from unittest import mock

    from surfd_tpu_torch import parallel
    from surfd_tpu_torch.models import MDM, unet1d
    from surfd_tpu_torch.ops import attention_kernel as ak
    from surfd_tpu_torch.parallel.multihost import shutdown
    from surfd_tpu_torch.pipelines import (
        MeshExtractionConfig,
        generate_meshes_pipelined,
        make_udf_fn,
    )
    from surfd_tpu_torch.utils import use_full_f32

    out = {"cpu_reference_s": ref["s"]}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parallel.initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0, device=dev,
                            timeout_s=300)
        mesh = parallel.make_mesh()
        log(f"[parallel] (a) NCCL group of {parallel.process_count()}, mesh "
            f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names} on {mesh.device_type}: "
            f"{time.perf_counter() - t0:.2f}s")
        try:
            # (b) DDP training
            init = category_mdm().state_dict()
            plain = train_run(dev, init)
            k0 = _k2_counts()
            ddp = train_run(dev, init, mesh)
            k1 = _k2_counts()
            plain2 = train_run(dev, init)  # the card's own run-to-run spread

            def bit_equal(a, b):
                return a["loss"] == b["loss"] and all(
                    torch.equal(a[k][n], b[k][n]) for k in ("grads", "params", "ema")
                    for n in b[k])

            gaps = train_gaps(ddp, plain)
            out["ddp_gaps"], out["plain_repeat_gaps"] = gaps, train_gaps(plain2, plain)
            out["ddp_bit_equal"], out["plain_bit_equal"] = (bit_equal(ddp, plain),
                                                           bit_equal(plain2, plain))
            log(f"[parallel] (b) DDP vs plain, 3 steps: losses {ddp['loss']} vs {plain['loss']}; "
                f"bit-equal {out['ddp_bit_equal']} (plain vs plain {out['plain_bit_equal']}, "
                f"gaps {json.dumps(out['plain_repeat_gaps'])}); gaps {json.dumps(gaps)}; "
                f"K2 {k1[0] - k0[0]}, K2-bwd {k1[1] - k0[1]} launches")
            if not within_train_bars(gaps) or gaps["attention_grads_zero"]:
                raise RuntimeError("parallel: the DDP steps are off the plain steps' bars")
            if (k1[0] - k0[0], k1[1] - k0[1]) != (16 * (TRAIN_STEPS + 1),) * 2:
                raise RuntimeError("parallel: DDP steps launched K2 / K2-bwd off 16 a pass")
            timed = {}
            for name, m in (("plain", None), ("ddp", mesh), ("plain", None), ("ddp", mesh)):
                mdm = MDM(cond_mode="category", num_actions=9)
                mdm.load_state_dict(init)
                r = time_train_steps(mdm.to(dev), dev, "category", 32, PARALLEL_TIMED,
                                     f"{name}, category MDM, latent 32, B 2", mesh=m)
                timed.setdefault(name, []).append(r["ms_per_step"])
            out["timed_ms"] = timed
            del mdm

            # (c) the sharded extraction
            dec, fx = load_fixture_decoder(dev)
            runs = {}
            for name, m in (("unsharded", None), ("sharded", mesh)):
                fn = make_udf_fn(dec, None, torch.from_numpy(fx["latent"]), fx["max_dist"],
                                 device=dev)
                runs[name] = _extract(fn, dev, resolution=PARALLEL_R, surface_bias="auto",
                                      mesh=m)
            (a, sa, ta, ka), (b, sb, tb, kb) = runs["unsharded"], runs["sharded"]
            vgap = float(np.abs(a.vertices - b.vertices).max()) if len(a.vertices) == len(
                b.vertices) else float("inf")
            out["extract"] = {"faces": len(b.faces), "vertex_gap": vgap, "s": (ta, tb),
                              "k1": (ka, kb)}
            log(f"[parallel] (c) sheet at {PARALLEL_R}^3: unsharded {len(a.faces)} faces "
                f"{ta:.2f}s K1 {ka}, sharded {len(b.faces)} faces {tb:.2f}s K1 {kb}, "
                f"vertices max abs {vgap:.3g}")
            if not (np.array_equal(a.faces, b.faces) and vgap <= 1e-6 and ka == kb):
                raise RuntimeError("parallel: the sharded extraction differs from the unsharded")
            # the batch generator at depth 2 on the mesh: each slot on its own fork
            lats = [torch.from_numpy(fx["latent"]), torch.from_numpy(0.9 * fx["latent"])]
            cfg = MeshExtractionConfig(resolution=128, surface_bias="auto")
            meshes = {}
            for name, depth, c in (("depth 1", 1, cfg),
                                   ("depth 2 sharded", 2, dataclasses.replace(cfg, mesh=mesh))):
                fns = (make_udf_fn(dec, None, lat, fx["max_dist"], device=dev) for lat in lats)
                meshes[name] = list(generate_meshes_pipelined(fns, c, depth=depth))
            if not all(np.array_equal(p.faces, q.faces) and np.array_equal(p.vertices, q.vertices)
                       for p, q in zip(*meshes.values())):
                raise RuntimeError("parallel: the sharded depth-2 batch differs from depth 1")
            log(f"[parallel] (c) the batch generator at 128^3, depth 2 on the mesh: "
                f"{[len(m.faces) for m in meshes['depth 2 sharded']]} faces, equal to depth 1")
        finally:
            shutdown()

        # (d) the CLIs under torchrun
        t0 = time.perf_counter()
        write_recon_corpus(tmp, dev)
        write_class_list(os.path.join(tmp, "classes.txt"))
        write_planted_decoder(os.path.join(tmp, "planted"), latent_size=32)
        save, gen = os.path.join(tmp, "run"), os.path.join(tmp, "gen")
        # the two torchruns at once (each its own free rendezvous port): their start-ups overlap
        with ThreadPoolExecutor(2) as ex:
            train = ex.submit(run_torchrun, "train_diffusion", [
                "--data_root", os.path.join(tmp, "data", "test"), "--ae_dir",
                os.path.join(tmp, "ae"), "--save_dir", save, "--cond_mode", "category",
                "--category_list", os.path.join(tmp, "classes.txt"), "--precompute_latents",
                "--num_steps", "10", "--save_interval", "10", "--log_interval", "5"], "parallel")
            sample = ex.submit(run_torchrun, "generate_uncond", [
                "--random-init", "--ae_dir", os.path.join(tmp, "planted"), "--data_parallel",
                "--sampler", "ddim", "--timestep_respacing", "ddim50", "--num_samples", "1",
                "--resolution", "128", "--output_dir", gen], "parallel")
            (dt, lines, launches), (dt2, lines2, _) = train.result(), sample.result()
        k2 = sum(n for k, n in launches.items() if k.startswith("qkv_attention_T"))
        bwd = sum(n for k, n in launches.items() if k.startswith("qkv_attention_bwd"))
        ckpts = sorted(os.listdir(os.path.join(save, "ckpt")))
        if (k2, bwd) != (160, 160) or ckpts != ["step_000000010.pt"]:
            raise RuntimeError(f"torchrun train_diffusion: K2 {k2}, K2-bwd {bwd}, wrote {ckpts}")
        written = sorted(os.listdir(gen))
        if written != ["uncond_0.obj"] or not any("--data_parallel: one process" in x
                                                  for x in lines2):
            raise RuntimeError(f"torchrun generate_uncond --data_parallel wrote {written}")
        out["torchrun_s"] = (dt, dt2)
        log(f"[parallel] (d) torchrun train_diffusion 10 steps {dt:.1f}s (K2 {k2}, K2-bwd "
            f"{bwd}, {ckpts}); generate_uncond --data_parallel {dt2:.1f}s, both at once "
            f"({os.path.getsize(os.path.join(gen, written[0]))} bytes of OBJ); phase recon's "
            f"corpus and both runs {time.perf_counter() - t0:.1f}s")

    # (e) classifier guidance
    mdm, clf = guidance_denoiser().to(dev), seeded_classifier().to(dev)
    k0 = _k2_counts()
    lat, dt = guided_sample(mdm, clf, dev)
    k1 = _k2_counts()
    n_steps = int(GUIDE_STEPS)
    gap = float((lat.cpu() - ref["guided"]).abs().max())
    unguided, dt_plain = guided_sample(mdm, None, dev)
    with mock.patch.object(unet1d, "qkv_attention",
                           lambda qkv, h: ak.qkv_attention(qkv.detach(), h)):
        detached, _ = guided_sample(mdm, clf, dev)
    fault = float((detached.cpu() - ref["guided"]).abs().max())
    out["guided"] = {"gap": gap, "fault_gap": fault, "s": dt, "s_unguided": dt_plain,
                     "k2": k1[0] - k0[0], "k2_bwd": k1[1] - k0[1],
                     "shift": float((lat - unguided).abs().max())}
    log(f"[parallel] (e) classifier-guided DDPM, 50 steps, B 2: {dt:.2f}s "
        f"({1e3 * dt / n_steps:.2f} ms a step; unguided {1e3 * dt_plain / n_steps:.2f} ms a step); "
        f"card vs CPU {gap:.3g} (bar {GUIDE_BAR}); guidance moved the latents "
        f"{out['guided']['shift']:.3g}; K2 {k1[0] - k0[0]}, K2-bwd {k1[1] - k0[1]} launches; "
        f"planted fault, the classifier's attention output detached: {fault:.3g}")
    if gap > GUIDE_BAR or not fault > GUIDE_BAR:
        raise RuntimeError("parallel: guided sampling off its bar, or the bar passes the fault")
    if (k1[0] - k0[0], k1[1] - k0[1]) != (GUIDE_K2 * n_steps, GUIDE_K2_BWD * n_steps):
        raise RuntimeError(f"parallel: guided sampling launched K2 {k1[0] - k0[0]}, K2-bwd "
                           f"{k1[1] - k0[1]}; want {GUIDE_K2 * n_steps}, {GUIDE_K2_BWD * n_steps}")
    del mdm, clf

    # (f) the spatial-transformer UNet and the grid AE: no hand-written kernel
    # but the conv kernel, once for each of the UNet's convolutions
    unet, ae, inp = vestigial_models()
    before = launch_counts()
    got = vestigial_run(unet, ae, inp, dev)
    after = launch_counts()
    launched = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    n_convs = sum(isinstance(m, unet1d.Conv1d) for m in unet.modules())
    if (any(not k.startswith("conv1d_") for k in launched)
            or sum(launched.values()) != n_convs):
        raise RuntimeError(f"parallel: (f) launched {launched}; want only the conv kernel, "
                           f"{n_convs} times")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = vestigial_run(unet, ae, inp, dev)
    finally:
        use_full_f32()
    want = ref["vestigial"]
    gaps = {k: _rel_gap(got[k], want[k]) for k in want}
    faults = {k: _rel_gap(tf32[k], want[k]) for k in want}
    out["vestigial"] = {"gaps": gaps, "tf32": faults}
    log(f"[parallel] (f) card vs CPU, max abs / max(1, max |CPU|): {json.dumps(gaps)}; TF32 on: "
        f"{json.dumps(faults)} (bars {json.dumps(VESTIGIAL_BARS)}); hand-written kernels: "
        f"the conv kernel {sum(launched.values())} times ({n_convs} convs), no other")
    for k, bar in VESTIGIAL_BARS.items():
        if gaps[k] > bar or not faults[k] > bar:
            raise RuntimeError(f"parallel: {k} off its bar, or the bar passes TF32")
    return out


def phase_parity(dev):
    """The sheet fixture at 128^3 (not part of the default run): the card's
    mesh against the port's own CPU mesh (faces within 1 %, symmetric mean
    NN distance <= 0.1 voxel, the same active blocks), and the card's
    watertight shell within 1 % of the JAX package's faces."""
    import copy

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
        runs[where] = (*get_mesh_from_udf(udf_fn, cfg=cfg, return_stats=True),
                       time.perf_counter() - t0)
    (cm, cs, ct), (hm, hs, ht) = runs["card"], runs["cpu"]
    gap = abs(len(cm.faces) - len(hm.faces)) / len(hm.faces)
    nn = _mean_nn(cm.vertices, hm.vertices)
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
    """The CLI_RUNS, all at once (run_clis)."""
    with contextlib.ExitStack() as stack:
        outs = [stack.enter_context(tempfile.TemporaryDirectory()) for _ in CLI_RUNS]
        results = run_clis([(module, ["--random-init", "--resolution", "128", "--output_dir",
                                      out] + extra, "cli")
                            for (module, extra, _), out in zip(CLI_RUNS, outs)])
        for (module, extra, objs), out, (dt, _, _) in zip(CLI_RUNS, outs, results):
            written = sorted(os.listdir(out))
            if written != objs:
                raise RuntimeError(f"{module} wrote {written}, want {objs}")
            sizes = [os.path.getsize(os.path.join(out, f)) for f in objs]
            log(f"[cli] {module} {' '.join(extra)}: {dt:.1f}s (the three at once), "
                + ", ".join(f"{f} {n} bytes" for f, n in zip(objs, sizes)))


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
        t0 = time.perf_counter()
        rows, k2_calls = phase_kernels(dev, hgmma)
        log(f"[kernels] phase in {time.perf_counter() - t0:.1f}s")
    # CLIs that need no phase's state run while the CPU references do (the card
    # is idle then); they are joined before the main path, which runs alone
    early = ThreadPoolExecutor(3)
    pending = {}
    if "recon" in phases:
        pending["recon"] = early.submit(recon_cli_chain, dev)
    if "condition" in phases:
        pending["condition"] = early.submit(condition_cli_chain)
    if "cli" in phases:
        pending["cli"] = early.submit(phase_cli)
    t_refs = time.perf_counter()
    if "generate" in phases:  # the CPU reference, outside the counted paths
        cpu = torch.device("cpu")
        cfg_ref, t_ref = cfg_sample(category_mdm(), "ddim", cpu, action=category_actions(cpu))
        cfg_ref16, t16 = cfg_sample(category_mdm(torch.bfloat16), "ddim", cpu,
                                    action=category_actions(cpu))
        log(f"[generate] CPU reference DDIM runs ({torch.get_num_threads()} threads): f32 "
            f"{t_ref:.2f}s, bf16 input {t16:.2f}s")
    if "recon" in phases:  # the CPU reference of the encoder, outside the counted paths
        enc_ref = encoder_reference()
        log(f"[recon] CPU reference encoder run, B 1 x {RECON_POINTS} points "
            f"({torch.get_num_threads()} threads): {enc_ref[2]:.2f}s")
    if "condition" in phases:  # the CPU reference of CLIP and the text MDM
        cond_ref = condition_reference()
        log(f"[condition] CPU reference ({torch.get_num_threads()} threads): CLIP "
            f"{cond_ref['clip_s']:.2f}s, text DDIM {cond_ref['ddim_s']:.2f}s")
    if "train" in phases:  # the CPU reference of the train steps
        train_ref = train_reference()
        log(f"[train] CPU reference, 3 steps ({torch.get_num_threads()} threads): "
            f"{train_ref['s']:.2f}s")
    if "ae" in phases:  # the CPU reference of the AE steps
        ae_ref = ae_reference()
        log(f"[ae] CPU reference, 4 steps ({torch.get_num_threads()} threads): {ae_ref['s']:.2f}s")
    if "parallel" in phases:  # the CPU reference of guided sampling and the last modules
        par_ref = parallel_reference()
        log(f"[parallel] CPU reference ({torch.get_num_threads()} threads): {par_ref['s']:.2f}s")
    log(f"[main path] CPU references in {time.perf_counter() - t_refs:.1f}s")
    t0 = time.perf_counter()
    chains = {k: f.result() for k, f in pending.items()}
    early.shutdown()
    log(f"[main path] waited {time.perf_counter() - t0:.1f}s more for the CLIs run beside them")
    paths = {"sample": lambda: phase_sample(dev), "extract": lambda: phase_extract(dev),
             "settings": lambda: phase_settings(dev),
             "generate": lambda: phase_generate(dev, cfg_ref, cfg_ref16),
             "recon": lambda: phase_recon(dev, enc_ref, chains["recon"]),
             "condition": lambda: phase_condition(dev, cond_ref, chains["condition"]),
             "train": lambda: phase_train(dev, train_ref), "ae": lambda: phase_ae(dev, ae_ref),
             "parallel": lambda: phase_parallel(dev, par_ref)}
    by_path = {}
    for name in MAIN_PATH:
        if name not in phases:
            continue
        reset_counts()  # count only this path's launches
        t_path = time.perf_counter()
        paths[name]()
        log(f"[main path] phase {name}: {time.perf_counter() - t_path:.1f}s")
        if plain_calls():
            raise RuntimeError(f"a plain version ran on the main path, in phase {name} "
                               f"({plain_calls()} calls)")
        by_path[name] = launch_counts()
    for row in rows:
        row["launches_by_path"] = {p: sum(c.get(k, 0) for k in row.get("keys", [row["name"]]))
                                   for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    if all(p in phases for p in MAIN_PATH):
        unused = [r["name"] for r in rows if r["launches"] == 0]
        if unused:
            raise RuntimeError(f"kernels not launched on the main path: {unused}")
    log(f"[main path] launches by phase: {json.dumps(by_path)}")
    t0 = time.perf_counter()
    k2_device_times(rows, k2_calls)
    log(f"[kernels] device-only times in {time.perf_counter() - t0:.1f}s")
    if "profile" in phases:
        phase_profile(dev)
    if "host" in phases:
        phase_host(dev)
    if "bars" in phases:
        phase_bars(dev)
    if "parity" in phases:
        phase_parity(dev)
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
