"""The diffusion train step: its model FLOPs (forward and backward, counted over the plain
reference on the meta device) over the window's time per step, as a share of
the dense TF32 peak."""

from benchmark.readers import step_mfu as read  # noqa: F401
