from .checkpoint import Checkpointer
from .config import apply_preset_defaults, load_preset
from .device import resolve_device, use_full_f32
from .logging import Logger
from .seed import fixseed

__all__ = ["Checkpointer", "Logger", "apply_preset_defaults", "fixseed", "load_preset",
           "resolve_device", "use_full_f32"]
