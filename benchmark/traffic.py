"""The one general generator: a traffic mix is a data file of parameters
(`workloads/<cell>.json`), and every input a job needs is drawn here from
the run's seed and the job's index. Two runs of one seed get the same
inputs; every seed gets the same sizes."""

from __future__ import annotations

import numpy as np
import torch

from .weights import stream_seed

# CLIP's BPE vocabulary: ordinary tokens below these two
SOT, EOT = 49406, 49407


def _rng(seed: int, stream: str, k: int) -> np.random.Generator:
    return np.random.default_rng([stream_seed(seed, stream), k + 1])  # k -1: the warm-up


def job_generator(seed: int, k: int, device) -> torch.Generator:
    """Job k's torch.Generator on the device: the sampler draws its noise
    from it, and the reference replays the same draws."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, f"noise/{k}"))


def category_labels(seed: int, k: int, n: int, num_classes: int) -> torch.Tensor:
    """Job k's n class ids, uniform over the classes (int64, host)."""
    return torch.from_numpy(_rng(seed, "labels", k).integers(0, num_classes, n).astype(np.int64))


def prompt_tokens(seed: int, k: int, lengths: tuple, context_length: int = 77) -> torch.Tensor:
    """Job k's prompt as a (1, context_length) row of CLIP token ids:
    start-of-text, a length drawn from [lo, hi] of ordinary BPE ids, end of
    text, zeros."""
    rng = _rng(seed, "prompt", k)
    n = int(rng.integers(lengths[0], lengths[1] + 1))
    row = np.zeros((1, context_length), np.int64)
    row[0, 0] = SOT
    row[0, 1:n + 1] = rng.integers(0, SOT, n)
    row[0, n + 1] = EOT
    return torch.from_numpy(row)


def pick(seed: int, stream: str, population: int, n: int) -> list:
    """n distinct indices of range(population), drawn from the seed."""
    n = min(n, population)
    return sorted(int(i) for i in _rng(seed, stream, 0).choice(population, n, replace=False))
