"""Point-cloud AutoEncoder training (counterpart of
surfd_tpu/training/ae_trainer.py): the BCE-UDF + gradient-matching step,
the per-item validation loss and the curriculum's batched validation.

A step: the DGCNN encodes the clouds → the queries' positional encoding →
the unfolded CbnDecoder, both in train mode (BatchNorm over the batch, flax's
statistics, `models.layers.batch_norm`) → udf = (1 − σ(logit))·max_dist →
its gradient with respect to the query coordinates, `autograd.grad` with a
ones cotangent and `create_graph=True` (JAX's `jax.vjp` in its step), from
the same forward pass → BCE on 1 − udf/max_dist + grad_loss_weight × the
masked MSE of that gradient (+ latent_reg_weight · mean(latent²)) →
backward through both graphs → AdamW at the annealed lr, unless the loss or
the gradient norm is not finite; a skipped step also puts the BatchNorm
running statistics back. On CUDA the step holds no host sync: the batch goes
up from pinned memory without blocking and the skip is decided on the card,
so the host enqueues the next step while the card runs this one.

On CUDA in f32 three hand-written units run in the step: the decoder's
train-mode conditional BatchNorm + ReLU (`ops/cbn_train.py`: forward,
backward and the backward's backward as kernels), its ten 512 × 512 block
projections on the 3xTF32 tensor-core GEMM (`ops/gemm_tf32x3.py`, to any
order of derivative), and the encoder's four edge convolutions
(`ops/edgeconv_train.py`: gather, Linear, BatchNorm, LeakyReLU and the max
over the neighbours, forward and first derivative; the latent reaches the
decoder only through the CBN γ/β projections, so `loss.backward()` is the
one pass that differentiates the encoder). Everything else is composed: kNN,
the latent's block, the decoder's other projections (cuBLAS in f32, TF32
off), as the JAX step runs its unfolded decoder and DGCNN through XLA. The
eval step and the CPU take the composed path throughout (K1 is the folded
eval-mode decoder of extraction).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.decoder import CbnDecoder, Conv1x1, coords_encode
from ..models.dgcnn import Dgcnn
from ..utils.profiling import span
from .common import (
    TrainState,
    apply_update_if_finite,
    on_device,
    skipped_flag,
    snapshot_buffers,
)


@dataclass
class AETrainConfig:
    """The AE's widths and the step's settings, at the deepfashion3d preset.
    The data and loop settings (points, batch, epochs, curriculum) are the
    CLI's flags: nothing here reads them."""

    latent_size: int = 32
    hidden_dim: int = 512
    num_hidden_layers: int = 5
    max_dist: float = 0.1
    lr: float = 1e-4
    grad_loss_weight: float = 0.1


class AutoEncoder(nn.Module):
    """The DGCNN `encoder` and the CBN `decoder`: (B, N, 3) clouds and
    (B, Q, 3) queries → ((B, Q) UDF logits, (B, latent) codes). Its state
    dict holds the encoder's upstream keys under `encoder.` and the
    decoder's under `decoder.` (`utils.convert`'s layout)."""

    def __init__(self, latent_size: int = 32, hidden_dim: int = 512,
                 num_hidden_layers: int = 5, k: int = 20):
        super().__init__()
        self.encoder = Dgcnn(latent_size, k=k)
        self.decoder = CbnDecoder(latent_size, hidden_dim, num_hidden_layers)

    def forward(self, pcd: torch.Tensor, coords: torch.Tensor):
        latent = self.encoder(pcd)
        return self.decoder(coords_encode(coords), latent), latent


# std of the standard normal truncated to [-2, 2]: flax's lecun_normal
# divides by it so that the truncated draws keep variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def make_ae_apply_fns(ae: AutoEncoder):
    """(encode(pcd, train=False) → (B, latent), decode(coords, latent,
    train=False) → (B, Q) logits) over the AutoEncoder's modules: the JAX
    package's pair, its variables being the modules' own. `train` switches
    the module to train mode (BatchNorm over the batch, its running
    statistics updated), else to eval mode."""

    def encode(pcd: torch.Tensor, train: bool = False) -> torch.Tensor:
        return ae.encoder.train(train)(pcd)

    def decode(coords: torch.Tensor, latent: torch.Tensor, train: bool = False) -> torch.Tensor:
        return ae.decoder.train(train)(coords_encode(coords), latent)

    return encode, decode


@torch.no_grad()
def init_ae(cfg: AETrainConfig, generator: torch.Generator) -> AutoEncoder:
    """An AutoEncoder at cfg's widths, initialised as the JAX package's
    `init_ae` initialises its flax modules (the same distributions; JAX's
    draws cannot be replayed): every Dense kernel lecun-normal (a normal
    truncated at ±2σ, σ = 1 / (√fan_in · 0.8796)) with a zero bias; the CBN
    γ and β projections at kernel 0 with bias 1 and 0; each block's `fc_1`
    at kernel 0; the DGCNN's BatchNorm scale 1 and bias 0; every running
    mean 0 and variance 1. The model comes in eval mode, on the CPU."""
    ae = AutoEncoder(cfg.latent_size, cfg.hidden_dim, cfg.num_hidden_layers)
    for m in ae.modules():
        if isinstance(m, (Conv1x1, nn.Linear)):
            std = 1.0 / math.sqrt(m.weight.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()
    dec = ae.decoder
    for cbn in [c for b in dec.blocks for c in (b.bn_0, b.bn_1)] + [dec.bn]:
        cbn.conv_gamma.weight.zero_()
        cbn.conv_gamma.bias.fill_(1.0)
        cbn.conv_beta.weight.zero_()
    for block in dec.blocks:
        block.fc_1.weight.zero_()
    return ae.eval()


def coords_gradient(udf: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """∂udf/∂coords for a ones cotangent, kept in the autograd graph
    (`create_graph`) so that a loss on it trains the parameters."""
    return torch.autograd.grad(udf, coords, torch.ones_like(udf), create_graph=True)[0]


def make_ae_train_step(ae: AutoEncoder, max_dist: float = 0.1, grad_loss_weight: float = 0.1,
                       latent_reg_weight: float = 0.0):
    """The train step `train_step(state, batch) -> metrics`, updating
    `state` (whose model is `ae`) in place.

    batch: 'pcd' (B, N, 3), 'coords' (B, Q, 3), 'udf' (B, Q) clipped
    distances, 'gradients' (B, Q, 3); numpy or tensors. The grad loss is
    the MSE of the coordinate gradient over the queries whose target
    1 − udf/max_dist lies strictly inside (0, 1), divided by
    max(3 · their count, 1). Metrics, 0-d device tensors that the step
    never reads: loss, udf_loss, grad_loss, grad_norm, nonfinite_skipped
    (1.0 on a skipped step). `train_step.loss_fn(batch)` is the step's loss alone,
    (loss, terms), for tests. Spans: `train.step`, and below it
    `train.forward` (the batch's upload, the forward with the coordinate
    gradient, the loss), `train.backward` and `train.update`.
    """
    device = next(ae.parameters()).device

    def loss_fn(batch):
        pcd, coords, gt_udf, gt_grad = (on_device(batch[k], device, torch.float32)
                                        for k in ("pcd", "coords", "udf", "gradients"))
        coords = coords.detach().requires_grad_(True)
        bce_target = 1.0 - gt_udf / max_dist
        ae.train()
        logits, latent = ae(pcd, coords)
        udf_pred = (1.0 - torch.sigmoid(logits)) * max_dist
        grads_wrt_coords = coords_gradient(udf_pred, coords)
        udf_loss = F.binary_cross_entropy_with_logits(logits, bce_target)
        mask = (bce_target > 0.0) & (bce_target < 1.0)
        denom = torch.clamp(mask.sum() * 3, min=1)
        grad_err = (grads_wrt_coords - gt_grad) ** 2
        grad_loss = torch.where(mask[..., None], grad_err, 0.0).sum() / denom
        loss = udf_loss + grad_loss_weight * grad_loss
        if latent_reg_weight:
            loss = loss + latent_reg_weight * latent.square().mean()
        return loss, {"udf_loss": udf_loss, "grad_loss": grad_loss}

    def train_step(state: TrainState, batch) -> dict:
        with span("train.step"):
            with span("train.forward"):
                # the forward moves the running statistics
                buffers = snapshot_buffers(state.model)
                loss, terms = loss_fn(batch)
            with span("train.backward"):
                loss.backward()
            ok, gnorm = apply_update_if_finite(state, loss, buffers)
        return {
            "loss": loss.detach(),
            "udf_loss": terms["udf_loss"].detach(),
            "grad_loss": terms["grad_loss"].detach(),
            "grad_norm": gnorm,
            "nonfinite_skipped": skipped_flag(ok),
        }

    train_step.loss_fn = loss_fn
    return train_step


def make_ae_eval_step(ae: AutoEncoder, max_dist: float = 0.1):
    """`eval_step(batch) -> (B,)`: each item's mean BCE over its queries in
    eval mode (running statistics); batch as the train step's, without
    'gradients'."""
    device = next(ae.parameters()).device

    @torch.no_grad()
    def eval_step(batch) -> torch.Tensor:
        ae.eval()
        pcd, coords, udf = (on_device(batch[k], device, torch.float32)
                            for k in ("pcd", "coords", "udf"))
        logits, _ = ae(pcd, coords)
        target = 1.0 - udf / max_dist
        return F.binary_cross_entropy_with_logits(logits, target, reduction="none").mean(-1)

    return eval_step


def curriculum_validate(eval_step, dataset, candidate_idxes, num_points_pcd: int,
                        num_points_forward: int, rng: np.random.Generator,
                        batch_size: int = 8) -> list:
    """Per-item validation losses of `candidate_idxes`, as floats. Every
    item's cloud and queries are drawn first, in index order (the same
    draws whatever the batch size), then the items go through `eval_step`
    in batches of `batch_size`, the last padded with copies of the last
    item, so that each loss is the item's own."""
    from ..data.datasets import random_point_sampling

    items = []
    for i in candidate_idxes:
        item = dataset[i]
        pcd = random_point_sampling(item["pcd"], num_points_pcd, rng)
        sel = random_point_sampling(
            np.concatenate([item["coords"], item["labels"][:, None]], -1),
            num_points_forward, rng,
        )
        items.append((pcd, sel[:, :3], sel[:, 3]))
    padded = items + items[-1:] * ((-len(items)) % batch_size)
    losses: list = []
    for s in range(0, len(padded), batch_size):
        chunk = padded[s: s + batch_size]
        batch = {key: np.stack([c[j] for c in chunk])
                 for j, key in enumerate(("pcd", "coords", "udf"))}
        losses.extend(eval_step(batch).cpu().tolist())
    return losses[: len(items)]
