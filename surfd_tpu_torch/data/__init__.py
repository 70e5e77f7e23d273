from .datasets import UdfDataset, random_point_sampling
from .manifests import load_garment_categories
from .preprocess import sample_points_on_mesh

__all__ = ["UdfDataset", "load_garment_categories", "random_point_sampling",
           "sample_points_on_mesh"]
