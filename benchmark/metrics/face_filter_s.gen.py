"""Seconds per mesh of the program's `times["face_filter"]` stage (a host-clock span
of `get_mesh_from_udf` that ends in a host copy), over the window's meshes."""

from benchmark.readers import mean_stage


def read(run):
    return mean_stage(run, "face_filter")
