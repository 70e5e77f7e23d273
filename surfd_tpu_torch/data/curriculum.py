"""Curriculum learning's index state and samplers (counterpart of
surfd_tpu/data/curriculum.py), host-side numpy: the train step never sees
them, only which items feed each batch."""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class CurriculumState:
    """The dataset indices in the curriculum, sorted. Saved as
    `training_idxes.txt`, one index per line."""

    def __init__(self, dataset_size: int, initial: Sequence[int] | None = None):
        self.dataset_size = dataset_size
        self.training_idxes: List[int] = sorted(set(initial or []))

    @property
    def complement(self) -> List[int]:
        cur = set(self.training_idxes)
        return [i for i in range(self.dataset_size) if i not in cur]

    def add(self, idxes: Sequence[int]) -> None:
        cur = set(self.training_idxes)
        cur.update(int(i) for i in idxes)
        self.training_idxes = sorted(cur)

    def add_easiest(self, candidate_idxes: Sequence[int], losses: Sequence[float], k: int):
        """Add the k candidates of lowest loss."""
        order = np.argsort(np.asarray(losses))[:k]
        self.add([candidate_idxes[i] for i in order])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for i in self.training_idxes:
                f.write(f"{i}\n")

    @classmethod
    def load(cls, path: str, dataset_size: int) -> "CurriculumState":
        with open(path) as f:
            idxes = [int(line) for line in f if line.strip()]
        return cls(dataset_size, idxes)


class SequenceSamplerTrain:
    """The curriculum's indices, shuffled by `rng` at each iteration."""

    def __init__(self, state: CurriculumState, rng: np.random.Generator):
        self.state = state
        self.rng = rng

    def __iter__(self) -> Iterator[int]:
        idxes = np.array(self.state.training_idxes)
        self.rng.shuffle(idxes)
        return iter(idxes.tolist())

    def __len__(self) -> int:
        return len(self.state.training_idxes)


class SequenceSamplerComplement:
    """The indices not yet in the curriculum, in order (the validation pass)."""

    def __init__(self, state: CurriculumState):
        self.state = state

    def __iter__(self) -> Iterator[int]:
        return iter(self.state.complement)

    def __len__(self) -> int:
        return len(self.state.complement)


class WeightedDynamicSampler:
    """Draws indices with probability proportional to their last loss (1 at first)."""

    def __init__(self, dataset_size: int, rng: np.random.Generator):
        self.weights = np.ones(dataset_size, dtype=np.float64)
        self.rng = rng

    def update_weights(self, idxes: Sequence[int], losses: Sequence[float]) -> None:
        self.weights[np.asarray(idxes)] = np.asarray(losses)

    def sample(self, n: int) -> np.ndarray:
        p = self.weights / self.weights.sum()
        return self.rng.choice(len(p), size=n, p=p)


def batched(indices: Iterator[int], batch_size: int, drop_last: bool = False):
    """Lists of `batch_size` consecutive indices (the last one shorter
    unless `drop_last`)."""
    batch: List[int] = []
    for i in indices:
        batch.append(i)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch
