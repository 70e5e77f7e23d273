"""Shared plumbing of the generation CLIs: load models → sample latents →
fill UDF grids → extract and clean meshes → write OBJs.

Weights: the denoiser from a `.pt` state dict with upstream `Unet.*` keys,
the decoder from the JAX package's `ae_decoder.npz` (read with numpy, bridged
by utils/convert.py); `--random-init` runs with seeded random weights. The
architecture the checkpoints were trained with comes from the run
directories' `args.json` (`merge_saved_args`). TF32 is off for matmuls and
convolutions (float32 reference numerics).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def base_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--ae_dir", default="",
                    help="AE run dir holding ae_decoder.npz (and args.json)")
    ap.add_argument("--model_path", default="",
                    help="denoiser .pt state dict (Unet.* keys), or its run dir's args.json beside it")
    ap.add_argument("--random-init", action="store_true", help="seeded random weights (smoke test)")
    ap.add_argument("--num_samples", type=int, default=2)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--latent_size", type=int, default=32)
    ap.add_argument("--model_channels", type=int, default=224)
    ap.add_argument("--decoder_hidden", type=int, default=512)
    ap.add_argument("--decoder_layers", type=int, default=5)
    ap.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "plms"])
    ap.add_argument("--timestep_respacing", default="")
    ap.add_argument("--noise_schedule", default="cosine", choices=["linear", "cosine"])
    ap.add_argument("--diffusion_steps", type=int, default=1000)
    # FIXED_SMALL posterior variance; --no-sigma_small selects FIXED_LARGE
    ap.add_argument("--sigma_small", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--guidance_param", type=float, default=1.0)
    ap.add_argument("--clip_denoised", action=argparse.BooleanOptionalAction, default=False)
    # 0 = auto: the --category_list length when one is given, else 9
    ap.add_argument("--num_actions", type=int, default=0)
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--output_dir", default="outputs")
    ap.add_argument("--watertight", action="store_true",
                    help="the iso-0.01 shell of the UDF (signed marching) instead of the open surface")
    ap.add_argument("--min_component_faces", type=int, default=2500)
    ap.add_argument("--smooth_iters", type=int, default=3)
    ap.add_argument("--max_batch", type=int, default=2**17)
    ap.add_argument(
        "--surface_bias", default="auto",
        help="decoder surface-bias calibration: auto, none, or a float",
    )
    ap.add_argument("--max_dist", type=float, default=0.1,
                    help="UDF clip distance the decoder was trained with "
                    "(default: the AE run's args.json, else 0.1)")
    ap.add_argument("--pipeline_depth", type=int, default=1,
                    help="extractions run at once, overlapping one's host passes with "
                    "another's device passes (pipelines/batch.py)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    return ap


def parse_surface_bias(s) -> float | str:
    """--surface_bias value: "auto" | "none"/"off" | a float in UDF units."""
    s = str(s).strip().lower()
    if s == "auto":
        return "auto"
    if s in ("none", "off", ""):
        return 0.0
    return float(s)


# Training-time settings that sampling must reproduce, or the checkpoint
# loads into the wrong architecture: saved key → attribute of the CLI args.
_DIFFUSION_MERGE_KEYS = {
    "latent_size": "latent_size",
    "model_channels": "model_channels",
    "num_actions": "num_actions",
    "noise_schedule": "noise_schedule",
    "diffusion_steps": "diffusion_steps",
}
_AE_MERGE_KEYS = {
    "latent_size": "latent_size",
    "hidden_dim": "decoder_hidden",
    "num_hidden_layers": "decoder_layers",
    "max_dist": "max_dist",
}


def _explicit_cli_keys(argv) -> set:
    """Attribute names passed on the command line (`--x v` or `--x=v`)."""
    if argv is None:
        argv = sys.argv[1:]
    return {tok[2:].split("=", 1)[0].replace("-", "_") for tok in argv if tok.startswith("--")}


def merge_saved_args(args, argv=None):
    """Overlay the training-time args of the run directories onto `args`.

    Reads `{model_path}/args.json` (the run dir itself, or the directory the
    `.pt` file sits in) and `{ae_dir}/args.json`. Flags passed explicitly on
    the command line win. The AE's `max_dist` sets `args.max_dist`, which
    both the evaluator and the extraction use.

    Deliberate deviation from the JAX package, whose evaluator keeps
    `make_udf_fn`'s default 0.1 while its fill and filter use the saved
    value; the two agree when the AE trained at 0.1.
    """
    explicit = _explicit_cli_keys(argv)

    def overlay(run_dir: str, key_map: dict, label: str):
        path = os.path.join(run_dir, "args.json")
        if not (run_dir and os.path.isfile(path)):
            return
        with open(path) as f:
            saved = json.load(f)
        for saved_key, attr in key_map.items():
            if saved_key not in saved or attr in explicit:
                continue
            cur = getattr(args, attr, None)
            if cur != saved[saved_key]:
                print(f"[{label} args.json] {attr}: {cur} -> {saved[saved_key]}", file=sys.stderr)
            setattr(args, attr, saved[saved_key])

    mp = args.model_path
    overlay(mp if os.path.isdir(mp) else os.path.dirname(mp), _DIFFUSION_MERGE_KEYS, "diffusion")
    overlay(args.ae_dir, _AE_MERGE_KEYS, "ae")
    return args


def build_schedule(args):
    from ..diffusion import named_beta_schedule, named_schedule, space_timesteps, spaced_schedule

    if args.timestep_respacing:
        base = named_beta_schedule(args.noise_schedule, args.diffusion_steps)
        return spaced_schedule(base, space_timesteps(args.diffusion_steps, args.timestep_respacing))
    return named_schedule(args.noise_schedule, args.diffusion_steps)


def load_denoiser(args, cond_mode: str, device):
    """MDM from --model_path (.pt state dict) or seeded random weights."""
    from ..models import MDM
    from ..utils.convert import pad_null_class_row

    num_actions = args.num_actions or 9
    mdm = MDM(cond_mode=cond_mode, model_channels=args.model_channels, num_actions=num_actions)
    if args.random_init or not args.model_path:
        if not args.random_init:
            print("WARNING: no --model_path given; using random weights", file=sys.stderr)
        mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    else:
        sd = torch.load(args.model_path, map_location="cpu", weights_only=True)
        mdm.load_state_dict(pad_null_class_row(sd, num_actions), strict=True)
    return mdm.to(device).eval()


def load_decoder(args, device):
    """CbnDecoder from --ae_dir/ae_decoder.npz or seeded random weights."""
    from ..models import CbnDecoder
    from ..utils.convert import decoder_state_from_flax, load_flax_npz, strip_prefix

    dec = CbnDecoder(args.latent_size, args.decoder_hidden, args.decoder_layers)
    path = os.path.join(args.ae_dir, "ae_decoder.npz") if args.ae_dir else ""
    if path and os.path.exists(path):
        sd = decoder_state_from_flax(load_flax_npz(path))
        dec.load_state_dict(strip_prefix(sd, "decoder."), strict=True)
    else:
        if not args.random_init:
            print("WARNING: no AE decoder weights found; using random weights", file=sys.stderr)
        dec.random_init_(torch.Generator().manual_seed(1))
    return dec.to(device).eval()


def run_generation(args, cond_mode: str, context=None, action=None, tag: str = "sample",
                   argv=None):
    """Sample latents and extract one mesh per sample through the batch
    generator; returns the OBJ paths. `argv` is the command line the args
    came from (flags passed there win over the run dirs' args.json)."""
    from ..diffusion import VarType
    from ..geometry import write_obj
    from ..models import make_cfg_model_fn
    from ..pipelines import (
        MeshExtractionConfig,
        generate_meshes_pipelined,
        make_udf_fn,
        sample_latents,
    )
    from ..utils.device import resolve_device

    merge_saved_args(args, argv)
    device = resolve_device(args.device)  # on CUDA: TF32 off
    sched = build_schedule(args)
    mdm = load_denoiser(args, cond_mode, device)
    if action is not None and not bool(((action >= 0) & (action < mdm.num_actions)).all()):
        raise ValueError(f"category ids must be in [0, {mdm.num_actions})")
    decoder = load_decoder(args, device)
    model_fn = make_cfg_model_fn(mdm, args.guidance_param, context=context, action=action)
    var_type = VarType.FIXED_SMALL if args.sigma_small else VarType.FIXED_LARGE
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    latents = sample_latents(
        sched, model_fn, args.num_samples, args.latent_size, generator, sampler=args.sampler,
        device=device, clip_denoised=args.clip_denoised, var_type=var_type,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"sampled {args.num_samples} latents ({args.sampler}) in "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)

    os.makedirs(args.output_dir, exist_ok=True)
    cfg = MeshExtractionConfig(
        resolution=args.resolution,
        max_batch=args.max_batch,
        max_dist=args.max_dist,
        min_component_faces=args.min_component_faces,
        final_laplacian_iters=args.smooth_iters,
        surface_bias=parse_surface_bias(args.surface_bias),
    )
    fns = (make_udf_fn(decoder, None, latents[k], args.max_dist, device=device,
                       chunk=args.max_batch) for k in range(args.num_samples))
    out_paths = []
    t0 = time.perf_counter()
    gen = generate_meshes_pipelined(fns, cfg, watertight=args.watertight,
                                    depth=args.pipeline_depth)
    for k, mesh in enumerate(gen):
        path = os.path.join(args.output_dir, f"{tag}_{k}.obj")
        write_obj(path, mesh)
        print(
            f"[{k}] {len(mesh.vertices)} verts / {len(mesh.faces)} faces "
            f"at t+{time.perf_counter() - t0:.2f}s → {path}",
            file=sys.stderr,
        )
        out_paths.append(path)
    return out_paths
