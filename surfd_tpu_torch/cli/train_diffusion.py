"""Diffusion training CLI: the MDM on frozen-encoder latents, the START_X L1
loss, AdamW with the staircase anneal, checkpoints with resume (optimizer
state included). CUDA by default:

  python -m surfd_tpu_torch.cli.train_diffusion --data_root DATA --cond_mode category \\
      --category_list garment_type_list.txt --ae_dir runs/ae --save_dir runs/diffusion

Data parallel under torchrun, one process a card (each takes
cuda:LOCAL_RANK): `torchrun --nproc_per_node N -m surfd_tpu_torch.cli.train_diffusion
... --batch_size B` trains DDP over N ranks when N divides B (else each rank
runs single-device, with a message); only rank 0 writes.

Writes `args.json`, `metrics.jsonl`, `metrics.csv` and `ckpt/` under
--save_dir; `generate_* --model_path <save_dir>` samples from the run. The
last stderr line is the process's kernel launches (`kernel calls: {...}`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--cond_mode", default="no_cond",
                    choices=["no_cond", "text", "sketch", "img", "category"])
    ap.add_argument("--ae_dir", default="", help="AE run dir holding ae_encoder.npz")
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--latent_size", type=int, default=32)
    ap.add_argument("--model_channels", type=int, default=224)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--noise_schedule", default="cosine", choices=["linear", "cosine"])
    ap.add_argument("--diffusion_steps", type=int, default=1000)
    ap.add_argument("--num_steps", type=int, default=600_000)
    ap.add_argument("--log_interval", type=int, default=100)
    ap.add_argument("--save_interval", type=int, default=50_000)
    ap.add_argument("--num_points_pcd", type=int, default=10_000)
    ap.add_argument("--precompute_latents", action="store_true",
                    help="encode each shape once through the frozen encoder and train from "
                    "the cached latents (save_dir/latents_cache.npz) instead of encoding "
                    "a fresh subsample every step")
    ap.add_argument("--schedule_sampler", default="uniform",
                    choices=["uniform", "loss-second-moment"])
    ap.add_argument("--steps_per_call", type=int, default=1,
                    help="K > 1: train in chunks of K steps from a device bank of the "
                    "latents (needs --precompute_latents and the uniform sampler)")
    ap.add_argument("--cond_mask_prob", type=float, default=0.0,
                    help="conditioning-dropout probability, for CFG")
    ap.add_argument("--dropout", type=float, default=0.0, help="UNet res-block dropout")
    ap.add_argument("--stall_exit_s", type=float, default=480.0,
                    help="exit 42 when no step completes for this long; 0 disables")
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--captions_csv", default="")
    ap.add_argument("--clip_npz", default="",
                    help="CLIP weights (npz in the JAX package's layout, or an OpenAI .pt) "
                    "for --cond_mode text: captions are encoded once per batch")
    ap.add_argument("--category_list", default="",
                    help="garment_type_list.txt-format class map (sets --num_actions when 0)")
    ap.add_argument("--num_actions", type=int, default=0,
                    help="0: the --category_list length, else 9")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    return ap


def load_encoder(args, device):
    """The frozen DGCNN from --ae_dir/ae_encoder.npz, else seeded random
    weights with a warning; eval mode on device."""
    from ..models import Dgcnn
    from ..utils.convert import dgcnn_state_from_flax, load_flax_npz

    encoder = Dgcnn(size_latent=args.latent_size)
    path = os.path.join(args.ae_dir, "ae_encoder.npz") if args.ae_dir else ""
    if path and os.path.exists(path):
        encoder.load_state_dict(dgcnn_state_from_flax(load_flax_npz(path)), strict=True)
    else:
        print("WARNING: no AE encoder weights; using a random encoder", file=sys.stderr)
        encoder.random_init_(torch.Generator().manual_seed(0))
    return encoder.to(device).eval()


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..parallel import broadcast_from_main, initialize, is_main_process, make_mesh
    from ..parallel.multihost import process_count, shutdown

    # a no-op unless torchrun started several processes (or a caller's group exists)
    joined = initialize(device=args.device)
    main_rank = is_main_process()
    # rank 0's verdict, taken before any rank writes
    if broadcast_from_main(os.path.exists(args.save_dir) and bool(os.listdir(args.save_dir))
                           and not (args.resume or args.overwrite)):
        raise SystemExit(f"save_dir {args.save_dir} exists; pass --resume or --overwrite")
    if main_rank:
        os.makedirs(args.save_dir, exist_ok=True)

    category_map = None
    if args.category_list:
        from ..data import load_garment_categories

        category_map, cat2name = load_garment_categories(args.category_list)
        if not args.num_actions:
            args.num_actions = len(cat2name)
    if not args.num_actions:
        args.num_actions = 9
    if main_rank:
        with open(os.path.join(args.save_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=2)

    from ..cli._common import print_kernel_calls
    from ..data import DiffusionDataset, diffusion_batch_iterator, prefetch_iterator
    from ..data.datasets import latent_diffusion_batch_iterator, precompute_latents
    from ..diffusion import named_schedule
    from ..models import MDM
    from ..training import (
        DiffusionTrainConfig,
        DiffusionTrainer,
        create_train_state,
        make_optimizer,
    )
    from ..utils import Checkpointer, Logger, fixseed
    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # on CUDA: TF32 off
    init_gen = fixseed(args.seed)
    np_rng = np.random.default_rng(args.seed)
    dataset = DiffusionDataset(args.data_root, "train", cond_mode=args.cond_mode,
                               captions_csv=args.captions_csv or None, category_map=category_map)
    encoder = load_encoder(args, device)

    def encode(pcd: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return encoder(torch.from_numpy(np.ascontiguousarray(pcd, np.float32)).to(device)
                           ).cpu().numpy()

    encode_text = None
    if args.cond_mode == "text":
        if not args.clip_npz:
            raise SystemExit("--cond_mode text requires --clip_npz (CLIP weights)")
        from ..models.clip import tokenize
        from ..utils.convert import load_clip

        clip = load_clip(args.clip_npz).to(device)

        def encode_text(texts):
            with torch.no_grad():
                return clip.encode_text(torch.from_numpy(tokenize(texts)).to(device)).cpu().numpy()

    lat_map = None
    if args.precompute_latents:
        if main_rank:
            lat_map = precompute_latents(dataset, encode, args.num_points_pcd, np_rng,
                                         cache_path=os.path.join(args.save_dir,
                                                                 "latents_cache.npz"))
        # every rank trains on rank 0's latents and continues its numpy stream
        lat_map, rng_state = broadcast_from_main((lat_map, np_rng.bit_generator.state))
        np_rng.bit_generator.state = rng_state
        print(f"precomputed {len(lat_map)} latents", file=sys.stderr)
        data_iter = latent_diffusion_batch_iterator(dataset, lat_map, args.batch_size, np_rng,
                                                    encode_text=encode_text)
        step_encoder = None
    else:
        data_iter = diffusion_batch_iterator(dataset, args.batch_size, args.num_points_pcd,
                                             np_rng, encode_text=encode_text)
        step_encoder = encoder
    if args.steps_per_call == 1:
        # the next batches are assembled on a thread while the card runs the step
        # (np_rng belongs to that thread from here on)
        data_iter = prefetch_iterator(data_iter, depth=2)

    mdm = MDM(cond_mode=args.cond_mode, model_channels=args.model_channels,
              num_actions=args.num_actions, dropout=args.dropout)
    mdm.Unet.training_init_(init_gen, mdm.null_action if args.cond_mode == "category" else None)
    mdm.to(device)
    sched = named_schedule(args.noise_schedule, args.diffusion_steps)
    cfg = DiffusionTrainConfig(
        batch_size=args.batch_size, num_steps=args.num_steps, log_interval=args.log_interval,
        save_interval=args.save_interval, schedule_sampler=args.schedule_sampler,
        cond_mask_prob=args.cond_mask_prob, stall_exit_s=args.stall_exit_s,
    )
    state = create_train_state(mdm, make_optimizer(mdm.parameters(), args.lr, args.weight_decay))
    ck = Checkpointer(os.path.join(args.save_dir, "ckpt"))
    if args.resume and ck.latest_step() is not None:
        ck.restore(state)
        print(f"resumed at step {state.step}", file=sys.stderr)
    world = process_count()
    # DP needs the batch to split evenly over 'data', as the reference's DDP does
    mesh = make_mesh() if world > 1 and args.batch_size % world == 0 else None
    if world > 1 and mesh is None:
        print(f"batch {args.batch_size} not divisible by {world} devices; "
              "running single-device", file=sys.stderr)
    logger = Logger(args.save_dir, formats=("stdout", "jsonl", "csv")) if main_rank else None
    generator = torch.Generator(device=device).manual_seed(args.seed)
    trainer = DiffusionTrainer(cfg, mdm, sched, state, data_iter, encoder=step_encoder,
                               checkpointer=ck, logger=logger, generator=generator, mesh=mesh)
    if args.steps_per_call > 1:
        if lat_map is None:
            raise SystemExit("--steps_per_call > 1 requires --precompute_latents")
        if args.schedule_sampler != "uniform":
            raise SystemExit("--steps_per_call > 1 requires the uniform sampler")
        items = [dataset.cond_item(i) for i in range(len(dataset))]
        bank = {"latents": torch.from_numpy(np.stack([lat_map[it["id"]] for it in items]))}
        if args.cond_mode == "category":
            bank["action"] = torch.tensor([int(it["action"]) for it in items])
        elif args.cond_mode == "text":
            bank["context"] = torch.from_numpy(np.concatenate(
                [encode_text([it["text"] for it in items[s:s + 16]])
                 for s in range(0, len(items), 16)]))
        elif args.cond_mode in ("sketch", "img"):
            bank["context"] = torch.from_numpy(np.stack([it["context"] for it in items]))
        final = trainer.run_chunked({k: v.to(device) for k, v in bank.items()},
                                    args.steps_per_call)
    else:
        final = trainer.run()
    if main_rank:
        ck.save(final.step, final)  # writes are atomic: a step already on disk is whole
        ck.wait()
        logger.close()
    print(f"done at step {final.step}", file=sys.stderr)
    if joined:
        shutdown()
    print_kernel_calls()
    return final


if __name__ == "__main__":
    main()
