from .common import StallWatchdog

__all__ = ["StallWatchdog"]
