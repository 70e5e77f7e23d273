"""Trainer (the AE train step): host launch calls (runtime and driver launch API,
graph launches) per step, over the traced steps."""

from benchmark.readers import step_launches as read  # noqa: F401
