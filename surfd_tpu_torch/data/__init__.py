from .curriculum import (
    CurriculumState,
    SequenceSamplerComplement,
    SequenceSamplerTrain,
    WeightedDynamicSampler,
    batched,
)
from .datasets import (
    DiffusionDataset,
    UdfDataset,
    ae_batch_iterator,
    diffusion_batch_iterator,
    latent_diffusion_batch_iterator,
    precompute_latents,
    random_point_sampling,
    random_rotation_matrix,
)
from .manifests import (
    build_manifest,
    category_for_id,
    load_garment_categories,
    load_text2shape_captions,
)
from .prefetch import prefetch_iterator
from .preprocess import (
    PreprocessConfig,
    compute_udf_from_mesh,
    normalize_mesh,
    prepare_udf_sample,
    sample_points_around_pcd,
    sample_points_on_mesh,
)

__all__ = ["CurriculumState", "SequenceSamplerComplement", "SequenceSamplerTrain",
           "WeightedDynamicSampler", "batched",
           "DiffusionDataset", "UdfDataset", "ae_batch_iterator", "diffusion_batch_iterator",
           "latent_diffusion_batch_iterator", "precompute_latents", "random_point_sampling",
           "random_rotation_matrix", "build_manifest", "category_for_id",
           "load_garment_categories", "load_text2shape_captions", "prefetch_iterator",
           "PreprocessConfig", "compute_udf_from_mesh", "normalize_mesh", "prepare_udf_sample",
           "sample_points_around_pcd", "sample_points_on_mesh"]
