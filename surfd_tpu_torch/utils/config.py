"""Typed configs with a JSON round trip, `section.key=value` overrides and
the dataset presets applied as argparse defaults (counterpart of
surfd_tpu/utils/config.py).

The port ships its own copy of the presets in `assets/configs/`."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    cond_mode: str = "no_cond"  # no_cond | text | sketch | img | category
    latent_size: int = 32
    model_channels: int = 224
    num_res_blocks: int = 2
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    num_actions: int = 9
    clip_dim: int = 512
    clip_version: str = "ViT-B/32"


@dataclass
class DiffusionConfig:
    noise_schedule: str = "cosine"
    diffusion_steps: int = 1000
    timestep_respacing: str = ""  # "" | "ddimN" | comma-separated counts
    predict_xstart: bool = True
    sigma_small: bool = True  # FIXED_SMALL
    l1_weight: float = 1000.0
    guidance_param: float = 1.0


@dataclass
class AEConfig:
    latent_size: int = 32
    hidden_dim: int = 512
    num_hidden_layers: int = 5
    num_points_pcd: int = 10_000
    num_points_forward: int = 20_000
    max_dist: float = 0.1
    knn_k: int = 20


@dataclass
class TrainConfig:
    batch_size: int = 2
    lr: float = 1e-4
    weight_decay: float = 0.0
    num_steps: int = 600_000
    log_interval: int = 100
    save_interval: int = 50_000
    seed: int = 10
    save_dir: str = "runs/diffusion"
    resume_checkpoint: str = ""
    schedule_sampler: str = "uniform"


@dataclass
class GenerateConfig:
    num_samples: int = 2
    resolution: int = 256
    sampler: str = "ddpm"  # ddpm | ddim | plms
    guidance_param: float = 1.0
    watertight: bool = False
    output_dir: str = "outputs"
    seed: int = 10
    min_component_faces: int = 0
    smooth_iters: int = 0


@dataclass
class SurfDConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    ae: AEConfig = field(default_factory=AEConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    generate: GenerateConfig = field(default_factory=GenerateConfig)


def _from_dict(cls, d: dict):
    """`cls` from a dict of its fields: nested dataclasses from their dicts,
    lists as tuples, unknown keys ignored."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        factory = fields[k].default_factory
        if factory is not dataclasses.MISSING and dataclasses.is_dataclass(factory()):
            kwargs[k] = _from_dict(factory, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def save_config(cfg: SurfDConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_config(path: str) -> SurfDConfig:
    with open(path) as f:
        return _from_dict(SurfDConfig, json.load(f))


def apply_overrides(cfg, overrides: list[str]):
    """Apply `section.key=value` overrides in place, each value parsed as
    the type of the field's current value (a tuple as comma-separated ints);
    returns cfg."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        current = getattr(obj, parts[-1])
        if isinstance(current, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            val = int(raw)
        elif isinstance(current, float):
            val = float(raw)
        elif isinstance(current, tuple):
            val = tuple(int(x) for x in raw.split(","))
        else:
            val = raw
        setattr(obj, parts[-1], val)
    return cfg

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
