"""Pipelines: seconds per mesh from the request to the mesh (the benchmark's
span around each `get_mesh_from_udf` of the batch generator), over the window."""

from benchmark.readers import meshes


def read(run):
    ms = meshes(run)
    return sum(m[3] for m in ms) / len(ms) if ms else None
