"""AutoEncoder training with curriculum learning (counterpart of
surfd_tpu/cli/train_ae.py): BCE-UDF + 0.1 × gradient-matching loss, AdamW
with the staircase anneal; with --curriculum, every --val_every epochs the
--curriculum_add items of lowest validation loss join the training set.
One device, CUDA by default:

  python -m surfd_tpu_torch.cli.train_ae --config deepfashion3d --data_root DATA \\
      --save_dir runs/ae --curriculum

Writes under --save_dir: `args.json`; `training_idxes.txt` (the curriculum,
one index per line); `metrics.jsonl` and `metrics.csv`; `ckpt/` (the train
state with the BatchNorm statistics, AdamW's moments and the epoch reached);
`ae_encoder.npz` and `ae_decoder.npz` in the JAX package's flat-key layout,
which `export_meshes`, `train_diffusion --ae_dir`, the generation CLIs and
the JAX package's `load_params_npz` read. `--resume` continues from the
latest checkpoint and the saved curriculum up to --num_epochs in all; a
save_dir that holds a checkpoint needs it. The last stderr line is the
process's kernel launches (`kernel calls: {...}`): on CUDA those of the
decoder's fused CBN + ReLU unit (`cbn_train_*`), the step's one hand-written
kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="", help="shipped dataset preset "
                    "(deepfashion3d|pix3d|text2shape) or a JSON path; explicit flags win")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--latent_size", type=int, default=32)
    ap.add_argument("--hidden_dim", type=int, default=512)
    ap.add_argument("--num_hidden_layers", type=int, default=5)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--num_epochs", type=int, default=6000)
    ap.add_argument("--num_points_pcd", type=int, default=10_000)
    ap.add_argument("--num_points_forward", type=int, default=20_000)
    ap.add_argument("--max_dist", type=float, default=0.1)
    ap.add_argument("--latent_reg", type=float, default=0.0,
                    help="L2 pull on the latent codes, w · mean(latent²); 0 keeps the "
                    "reference's loss")
    ap.add_argument("--augment_rotations", action="store_true",
                    help="a random rotation per item (cloud, queries and gradients together)")
    ap.add_argument("--curriculum", action="store_true")
    ap.add_argument("--curriculum_init", type=int, default=100)
    ap.add_argument("--curriculum_add", type=int, default=100)
    ap.add_argument("--val_every", type=int, default=64)
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--log_interval", type=int, default=10)
    ap.add_argument("--save_every_epochs", type=int, default=50)
    ap.add_argument("--stall_exit_s", type=float, default=480.0,
                    help="exit 42 when no step completes for this long; 0 disables")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    return ap


def main(argv=None):
    from ..utils.config import apply_preset_defaults

    ap = build_parser()
    apply_preset_defaults(ap, argv)
    args = ap.parse_args(argv)
    ckpt_dir = os.path.join(args.save_dir, "ckpt")
    if not args.resume and os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        raise SystemExit(f"{ckpt_dir} holds checkpoints; pass --resume")
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    from ..data import (
        CurriculumState,
        SequenceSamplerTrain,
        UdfDataset,
        ae_batch_iterator,
        prefetch_iterator,
    )
    from ..training import (
        AETrainConfig,
        GracefulShutdown,
        StallWatchdog,
        create_train_state,
        curriculum_validate,
        init_ae,
        make_ae_eval_step,
        make_ae_train_step,
        make_optimizer,
    )
    from ..utils import Checkpointer, Logger, fixseed
    from ..utils.checkpoint import save_params_npz
    from ..utils.convert import decoder_flat_from_state, dgcnn_flat_from_state
    from ..utils.device import resolve_device
    from ._common import print_kernel_calls

    device = resolve_device(args.device)  # on CUDA: TF32 off
    init_gen = fixseed(args.seed)
    np_rng = np.random.default_rng(args.seed)  # curriculum draws, main thread
    dataset = UdfDataset(args.data_root, "train")
    n = len(dataset)
    cur_path = os.path.join(args.save_dir, "training_idxes.txt")
    if not args.curriculum:
        state_cur = CurriculumState(n, list(range(n)))
    elif args.resume and os.path.exists(cur_path):
        state_cur = CurriculumState.load(cur_path, n)
    else:
        init_idx = np_rng.choice(n, size=min(args.curriculum_init, n), replace=False)
        state_cur = CurriculumState(n, init_idx.tolist())
        state_cur.save(cur_path)

    cfg = AETrainConfig(latent_size=args.latent_size, hidden_dim=args.hidden_dim,
                        num_hidden_layers=args.num_hidden_layers, max_dist=args.max_dist,
                        lr=args.lr)
    ae = init_ae(cfg, init_gen).to(device)
    state = create_train_state(ae, make_optimizer(ae.parameters(), cfg.lr))
    train_step = make_ae_train_step(ae, cfg.max_dist, cfg.grad_loss_weight, args.latent_reg)
    eval_step = make_ae_eval_step(ae, cfg.max_dist)
    ck = Checkpointer(ckpt_dir)
    start_epoch = 0
    if args.resume and ck.latest_step() is not None:
        ck.restore(state)
        start_epoch = ck.read()["extra"].get("epoch", 0)
        print(f"resumed at step {state.step}, epoch {start_epoch}", file=sys.stderr)
    logger = Logger(args.save_dir, formats=("stdout", "jsonl", "csv"))

    # The next batches are assembled on a thread while the device runs the
    # step, from a generator of their own (np_rng stays on this thread, for
    # validation). Curriculum growth reaches the thread through the live
    # sampler at its next pass.
    np_rng_data = np.random.default_rng(args.seed + 1)
    sampler = SequenceSamplerTrain(state_cur, np_rng_data)
    train_iter = prefetch_iterator(ae_batch_iterator(
        dataset, lambda: list(sampler), args.batch_size, args.num_points_pcd,
        args.num_points_forward, np_rng_data, augment_rotations=args.augment_rotations,
    ), depth=2)

    def run_val_and_grow():
        """Validate the items outside the curriculum, add the easiest."""
        comp = state_cur.complement
        if not comp:
            return
        losses = curriculum_validate(eval_step, dataset, comp, args.num_points_pcd,
                                     args.num_points_forward, np_rng, args.batch_size)
        state_cur.add_easiest(comp, losses, args.curriculum_add)
        state_cur.save(cur_path)
        logger.log_metrics({"curriculum_size": len(state_cur.training_idxes)}, state.step)

    def save_all(epoch: int):
        ck.save(state.step, state, force=True, extra={"epoch": epoch})
        save_params_npz(os.path.join(args.save_dir, "ae_encoder.npz"),
                        dgcnn_flat_from_state(ae.encoder.state_dict()))
        save_params_npz(os.path.join(args.save_dir, "ae_decoder.npz"),
                        decoder_flat_from_state(ae.state_dict()))

    with GracefulShutdown() as stop, StallWatchdog(args.stall_exit_s) as wd:
        for epoch in range(start_epoch, args.num_epochs):
            for _ in range(max(len(state_cur.training_idxes) // args.batch_size, 1)):
                metrics = train_step(state, next(train_iter))
                wd.tick()
                if state.step % args.log_interval == 0:
                    logger.log_metrics({k: float(v) for k, v in metrics.items()}, state.step)
                if stop.requested:
                    break
            if stop.requested:  # preemption: save a resumable state, the epoch unfinished
                print(f"preempted at step {state.step}; saving", file=sys.stderr)
                save_all(epoch)
                break
            if args.curriculum and (epoch + 1) % args.val_every == 0:
                run_val_and_grow()
            if (epoch + 1) % args.save_every_epochs == 0 or epoch == args.num_epochs - 1:
                save_all(epoch + 1)
    ck.wait()
    logger.close()
    print(f"done at step {state.step}", file=sys.stderr)
    print_kernel_calls()
    return state


if __name__ == "__main__":
    main()
