"""Train-state checkpoints on `torch.save` (counterpart of
surfd_tpu/utils/checkpoint.py, which writes Orbax directories).

One file per step, `<directory>/step_<step:09d>.pt`: a dict of `step`,
`count` (updates applied), `model` (the model's state dict: the MDM's with
upstream `Unet.*` keys, so `MDM.load_state_dict` reads it unchanged, or the
AE's, BatchNorm buffers included), `ema` (the same layout, or None),
`optimizer` (AdamW's state dict, the anneal's settings in its groups) and
`extra` (the loop's own counters, e.g. `train_ae`'s epoch). A write goes to a
temporary file first and is renamed into place, so a reader sees a whole
checkpoint or none. Saves are synchronous; `wait` and `close` exist for the
loops' and the CLI's sake.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_NAME = re.compile(r"^step_(\d{9,})\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> Path:
        return self.directory / f"step_{step:09d}.pt"

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, force: bool = False, extra: Optional[dict] = None) -> bool:
        """Write `state` (a training.TrainState) and `extra` as `step`; a step
        already on disk is kept unless `force`. Keeps the newest
        `max_to_keep` steps."""
        path = self.path(step)
        if path.exists() and not force:
            return False
        payload = {
            "step": int(state.step), "count": int(state.count),
            "model": state.model.state_dict(), "ema": state.ema_state_dict(),
            "optimizer": state.optimizer.state_dict(), "extra": dict(extra or {}),
        }
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            self.path(old).unlink(missing_ok=True)
        return True

    def read(self, step: Optional[int] = None) -> dict:
        """The checkpoint's dict, on the CPU (the latest step by default)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load a checkpoint into `state` (model, optimizer, EMA, counters),
        in place; returns it."""
        payload = self.read(step)
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        if state.ema is not None:
            ema = payload["ema"] or payload["model"]
            with torch.no_grad():
                for (name, _), e in zip(state.model.named_parameters(), state.ema):
                    e.copy_(ema[name])
        state.step, state.count = payload["step"], payload["count"]
        return state

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release."""


def save_params_npz(path: str, tree: dict) -> None:
    """A nested dict of arrays as the JAX package's flat npz: one f32 entry
    per leaf under its '/'-joined key path (`params/fc_p/kernel`). A dict
    whose keys are already flat (`utils.convert.*_flat_from_state`) is
    written as it is. JAX's `load_params_npz` and the port's `load_flax_npz`
    read it."""
    out: dict = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}/")
            else:
                out[f"{prefix}{key}"] = np.asarray(val, np.float32)

    walk(tree, "")
    np.savez(path, **out)
