"""Hand-written CUDA kernels with their plain PyTorch versions.

K1 `decoder_kernel.folded_udf` (csrc/folded_mlp.cu, csrc/folded_mlp_bf16.cu),
K2 `attention_kernel.qkv_attention` (csrc/qkv_attention.cu) and its gradient
K2-bwd `attention_kernel.qkv_attention_bwd` (csrc/qkv_attention_bwd.cu), the
denoiser's convolutions `conv1d_kernel.conv1d` (csrc/conv1d_stream.cu), the
cleanup's `mesh_laplacian.laplacian_smooth` (csrc/mesh_laplacian.cu) and the AE
decoder's train-mode conditional BatchNorm + ReLU `cbn_train.cbn_relu_train`
(csrc/cbn_train.cu) and its train-mode projections `gemm_tf32x3.mm_tf32x3`
(csrc/gemm_tf32x3.cu, 3xTF32), and the DGCNN encoder's train-mode edge
convolutions `edgeconv_train.edgeconv_train` (csrc/edgeconv_train.cu). The
library is built by `_build` at first use on a CUDA tensor, never at import.
`cuda_graph.GraphedCall` replays the denoiser's call from a CUDA graph.
"""

from . import cbn_train, edgeconv_train, gemm_tf32x3
from .attention_kernel import (
    qkv_attention,
    qkv_attention_bwd,
    qkv_attention_bwd_ref,
    qkv_attention_ref,
)
from .cbn_train import cbn_relu_train
from .conv1d_kernel import conv1d, conv1d_ref
from .cuda_graph import GraphedCall
from .decoder_kernel import (
    FoldedDecoder,
    fold_decoder,
    folded_udf,
    folded_udf_mixed_ref,
    folded_udf_ref,
    posenc_f32,
)
from .gemm_tf32x3 import mm_tf32x3
from .mesh_laplacian import laplacian_smooth, laplacian_smooth_ref

__all__ = [
    "qkv_attention", "qkv_attention_bwd", "qkv_attention_bwd_ref", "qkv_attention_ref",
    "cbn_relu_train", "conv1d", "conv1d_ref",
    "FoldedDecoder", "fold_decoder",
    "folded_udf", "folded_udf_mixed_ref", "folded_udf_ref", "posenc_f32",
    "laplacian_smooth", "laplacian_smooth_ref", "mm_tf32x3", "GraphedCall", "kernel_calls",
]


def kernel_calls() -> dict:
    """This process's kernel launches, K1 by precision, K2 and K2-bwd by
    (T, c), the convolutions by (K, stride), the Laplacian and the CBN unit's
    stages (`cbn_train_<stage>`, three kernels a call; only once launched),
    the 3xTF32 GEMM's calls by form (`gemm_tf32x3_nt`, `_nn`, `_tn`; a split
    call launches its reduction too; only once launched), the edge
    convolution unit's stages (`edgeconv_train_forward`, `_backward`, three
    kernels a call; only once launched),
    under the row names of chip_smoke.py's kernels line (those replayed from
    a CUDA graph included), the CUDA graphs
    captured and replayed (`cuda_graph_capture`, `cuda_graph_replay`), and
    its calls of the kernels' plain versions."""
    launches = {f"folded_mlp_{p}": n for p, n in folded_udf.launches.items()}
    launches.update({f"qkv_attention_T{T}_c{c}": n for (T, c), n in qkv_attention.launches.items()})
    launches.update({f"qkv_attention_bwd_T{T}_c{c}": n
                     for (T, c), n in qkv_attention_bwd.launches.items()})
    launches.update({f"conv1d_k{k}_s{s}": n for (k, s), n in conv1d.launches.items()})
    if laplacian_smooth.launches:  # as K2's rows: only once launched
        launches["mesh_laplacian"] = laplacian_smooth.launches
    launches.update({f"cbn_train_{s}": n for s, n in cbn_relu_train.launches.items() if n})
    launches.update({f"gemm_tf32x3_{f}": n for f, n in mm_tf32x3.launches.items() if n})
    launches.update({f"edgeconv_train_{s}": n
                     for s, n in edgeconv_train.edgeconv_train.launches.items() if n})
    if GraphedCall.captures:
        launches["cuda_graph_capture"] = GraphedCall.captures
        launches["cuda_graph_replay"] = GraphedCall.replays
    plain = (folded_udf_ref.calls + folded_udf_mixed_ref.calls + qkv_attention_ref.calls
             + qkv_attention_bwd_ref.calls + conv1d_ref.calls + laplacian_smooth_ref.calls
             + cbn_train.forward_ref.calls + cbn_train.backward_ref.calls
             + cbn_train.backward2_ref.calls + gemm_tf32x3.mm_ref.calls
             + edgeconv_train.forward_ref.calls + edgeconv_train.backward_ref.calls)
    return {"launches": launches, "plain_calls": plain}
