from .analytic import FIXTURES, TorchField, sheet_fields, sphere_fields, torus_fields
from .grid import (
    GridFiller,
    QueryStream,
    auto_block_size,
    estimate_surface_bias,
    estimate_surface_bias_field,
    fill_grid_dense,
    make_grad_fn,
)
from .marching import Mesh, marching_tetrahedra, marching_tetrahedra_udf
from .mesh_io import read_obj, write_obj, write_ply
from .mesh_ops import (
    boundary_vertices,
    face_components,
    fill_triangle_holes,
    filter_small_components,
    keep_largest_component,
    laplacian_smooth,
    merge_duplicate_vertices,
    remove_degenerate_faces,
    remove_duplicate_faces,
    remove_unreferenced_vertices,
    smooth_borders,
    stabilize,
    vertex_normals,
)
from .metrics import (
    chamfer_distance,
    f_score,
    hausdorff_distance,
    mesh_surface_metrics,
    one_nn_accuracy,
    point_mesh_distances,
)
from .vote_signs import marching_tetrahedra_vote, vote_sign_field

__all__ = [
    "FIXTURES", "TorchField", "sheet_fields", "sphere_fields", "torus_fields",
    "GridFiller", "QueryStream", "auto_block_size", "estimate_surface_bias",
    "estimate_surface_bias_field", "fill_grid_dense", "make_grad_fn",
    "Mesh", "marching_tetrahedra", "marching_tetrahedra_udf",
    "read_obj", "write_obj", "write_ply",
    "boundary_vertices", "face_components", "fill_triangle_holes", "filter_small_components",
    "keep_largest_component", "laplacian_smooth", "merge_duplicate_vertices",
    "remove_degenerate_faces", "remove_duplicate_faces", "remove_unreferenced_vertices",
    "smooth_borders", "stabilize", "vertex_normals",
    "chamfer_distance", "f_score", "hausdorff_distance", "mesh_surface_metrics",
    "one_nn_accuracy", "point_mesh_distances",
    "marching_tetrahedra_vote", "vote_sign_field",
]
