from .datasets import (
    DiffusionDataset,
    UdfDataset,
    diffusion_batch_iterator,
    latent_diffusion_batch_iterator,
    precompute_latents,
    random_point_sampling,
)
from .manifests import load_garment_categories, load_text2shape_captions
from .prefetch import prefetch_iterator
from .preprocess import sample_points_on_mesh

__all__ = ["DiffusionDataset", "UdfDataset", "diffusion_batch_iterator",
           "latent_diffusion_batch_iterator", "load_garment_categories",
           "load_text2shape_captions", "precompute_latents", "prefetch_iterator",
           "random_point_sampling", "sample_points_on_mesh"]
