"""Device: the share of the traced job's wall in which no operation ran on
the card (1 − union of kernel, copy and memset intervals / wall)."""

from benchmark.readers import idle_share as read  # noqa: F401
