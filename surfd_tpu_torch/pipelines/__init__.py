from .batch import generate_meshes, generate_meshes_pipelined
from .generate import (
    BiasTable,
    MeshExtractionConfig,
    UdfEvaluator,
    get_mesh_from_udf,
    get_watertight_mesh_from_udf,
    make_udf_fn,
    sample_latents,
)

__all__ = [
    "BiasTable", "MeshExtractionConfig", "UdfEvaluator", "generate_meshes",
    "generate_meshes_pipelined", "get_mesh_from_udf", "get_watertight_mesh_from_udf",
    "make_udf_fn", "sample_latents",
]
