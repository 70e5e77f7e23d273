from .config import apply_preset_defaults, load_preset
from .device import resolve_device, use_full_f32

__all__ = ["apply_preset_defaults", "load_preset", "resolve_device", "use_full_f32"]
