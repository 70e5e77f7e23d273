from .clip import Clip
from .decoder import CbnDecoder, coords_encode, udf_from_logits
from .dgcnn import Dgcnn, gather_graph_feature, knn_indices
from .layers import GroupNorm32, timestep_embedding
from .mdm import MDM, make_cfg_model_fn
from .unet1d import UNet1D

__all__ = [
    "Clip", "CbnDecoder", "coords_encode", "udf_from_logits", "Dgcnn", "gather_graph_feature",
    "knn_indices", "GroupNorm32",
    "timestep_embedding", "MDM", "make_cfg_model_fn", "UNet1D",
]
