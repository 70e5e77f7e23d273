"""Timestep samplers for diffusion training (numpy copy of
surfd_tpu/diffusion/resample.py, which it draws bit-equal to on the same
`default_rng`).

The samplers live on the host: their state is a small (T, K) array updated
once per step from the batch's per-example losses.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """"uniform" or "loss-second-moment"."""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler(ABC):
    """Importance-sampling distribution over timesteps."""

    # whether update_with_all_losses reads the per-example losses: the train
    # loop fetches them from the device only for such a sampler
    needs_losses: bool = False

    @abstractmethod
    def weights(self) -> np.ndarray:
        """Unnormalized per-timestep sampling weights."""

    def sample(self, batch_size: int, rng: np.random.Generator):
        """(int32 timestep indices, float32 importance weights), drawn from `rng`."""
        w = self.weights()
        p = w / w.sum()
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[indices])
        return indices.astype(np.int32), weights.astype(np.float32)

    def update_with_all_losses(self, ts, losses) -> None:
        """Update the state with a batch's (timestep, loss) pairs."""


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._weights = np.ones([num_timesteps])

    def weights(self) -> np.ndarray:
        return self._weights


class LossSecondMomentResampler(ScheduleSampler):
    """Sampling proportional to E[loss²]^½ per timestep once every timestep
    holds `history_per_term` losses (uniform until then), mixed with
    `uniform_prob` of the uniform distribution."""

    needs_losses = True

    def __init__(self, num_timesteps: int, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros([num_timesteps, history_per_term], dtype=np.float64)
        self._loss_counts = np.zeros([num_timesteps], dtype=np.int64)

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        w = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_all_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts).tolist(), np.asarray(losses).tolist()):
            if self._loss_counts[t] == self.history_per_term:
                # shift out the oldest loss
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())
