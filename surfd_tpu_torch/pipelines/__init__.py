from .batch import generate_meshes, generate_meshes_pipelined
from .generate import (
    BiasTable,
    MeshExtractionConfig,
    UdfEvaluator,
    filter_faces_by_udf,
    get_mesh_from_udf,
    get_watertight_mesh_from_udf,
    make_field_bias_at,
    make_udf_fn,
    sample_latents,
)

__all__ = [
    "BiasTable", "MeshExtractionConfig", "UdfEvaluator", "filter_faces_by_udf",
    "generate_meshes", "generate_meshes_pipelined", "get_mesh_from_udf",
    "get_watertight_mesh_from_udf", "make_field_bias_at", "make_udf_fn", "sample_latents",
]
