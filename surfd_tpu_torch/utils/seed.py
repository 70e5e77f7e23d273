"""Seeding (counterpart of surfd_tpu/utils/seed.py)."""

from __future__ import annotations

import random

import numpy as np
import torch


def fixseed(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators and return a
    CPU torch.Generator seeded with `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
