"""Dataset presets applied as argparse defaults (counterpart of
surfd_tpu/utils/config.py `load_preset` / `apply_preset_defaults`).

The port ships its own copy of the presets in `assets/configs/`."""

from __future__ import annotations

import argparse
import json
import os

_PRESET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "configs"
)


def available_presets() -> list[str]:
    return sorted(p[:-5] for p in os.listdir(_PRESET_DIR) if p.endswith(".json"))


def load_preset(name_or_path: str) -> dict:
    """A shipped preset (`deepfashion3d`, `pix3d`, `text2shape`) or a JSON
    file → flat dict of hyperparameters."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_PRESET_DIR, f"{name_or_path}.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no preset '{name_or_path}' (shipped: {', '.join(available_presets())})"
            )
    with open(path) as f:
        return json.load(f)


def apply_preset_defaults(parser: argparse.ArgumentParser, argv=None) -> None:
    """If argv carries `--config NAME`, install the preset's keys that the
    parser knows as its defaults; flags given explicitly still win."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default="")
    known, _ = pre.parse_known_args(argv)
    if not known.config:
        return
    preset = load_preset(known.config)
    dests = {a.dest for a in parser._actions}
    parser.set_defaults(**{k: v for k, v in preset.items() if k in dests})
