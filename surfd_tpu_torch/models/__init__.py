from .attention import (
    GEGLU,
    BasicTransformerBlock,
    CrossAttention,
    FeedForward,
    LinearAttention,
    SpatialTransformer1D,
)
from .clip import Clip
from ..ops.attention_kernel import qkv_attention
from .decoder import (
    CbnDecoder,
    ConditionalBatchNorm,
    ConditionalResnetBlock,
    coords_encode,
    udf_from_logits,
)
from .dgcnn import Dgcnn, gather_graph_feature, knn_indices
from .encoder_unet import AttentionPool1D, EncoderUNet1D, make_classifier_cond_fn
from .grid_ae import GridAutoencoder
from .layers import GroupNorm32, timestep_embedding
from .mdm import MDM, make_cfg_model_fn
from .unet1d import UNet1D

__all__ = [
    "AttentionPool1D", "BasicTransformerBlock", "Clip", "CbnDecoder", "ConditionalBatchNorm",
    "ConditionalResnetBlock", "CrossAttention",
    "EncoderUNet1D", "FeedForward", "GEGLU", "GridAutoencoder", "LinearAttention",
    "SpatialTransformer1D", "coords_encode", "udf_from_logits", "Dgcnn", "gather_graph_feature",
    "knn_indices", "GroupNorm32", "make_classifier_cond_fn", "qkv_attention",
    "timestep_embedding", "MDM", "make_cfg_model_fn", "UNet1D",
]
