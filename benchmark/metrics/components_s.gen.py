"""Seconds per mesh of the program's `times["cleanup_components"]`: the
cleanup's small-component filter (`cleanup.components`, a host-clock span
of `get_mesh_from_udf`), over the window's meshes."""

from benchmark.readers import mean_stage


def read(run):
    return mean_stage(run, "cleanup_components")
