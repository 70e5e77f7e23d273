from .grid import (
    GridFiller,
    auto_block_size,
    estimate_surface_bias,
    estimate_surface_bias_field,
    fill_grid_dense,
)
from .marching import Mesh, marching_tetrahedra, marching_tetrahedra_udf
from .mesh_io import write_obj
from .mesh_ops import (
    filter_small_components,
    keep_largest_component,
    laplacian_smooth,
    remove_unreferenced_vertices,
)
from .metrics import (
    chamfer_distance,
    f_score,
    hausdorff_distance,
    mesh_surface_metrics,
    one_nn_accuracy,
    point_mesh_distances,
)

__all__ = [
    "GridFiller", "auto_block_size", "estimate_surface_bias", "estimate_surface_bias_field",
    "fill_grid_dense", "Mesh", "marching_tetrahedra", "marching_tetrahedra_udf", "write_obj",
    "filter_small_components", "keep_largest_component", "laplacian_smooth",
    "remove_unreferenced_vertices",
    "chamfer_distance", "f_score", "hausdorff_distance", "mesh_surface_metrics",
    "one_nn_accuracy", "point_mesh_distances",
]
