"""se3_transformer_torch — the PyTorch/CUDA port of se3_transformer_tpu.

Imports torch and numpy only; the CUDA kernels build at their first launch,
never at import. Entry points default to device='cuda' and raise when CUDA
is absent; pass device='cpu' to run the plain PyTorch versions.
"""
__version__ = '0.1.0'

from .basis import basis_transformation_Q_J, get_basis
from .convert import convert_flax_params
from .inference import InferenceEngine, pad_to_bucket
from .kernels.pairwise import (
    fused_pairwise_conv, fused_pairwise_conv_bwd,
    fused_pairwise_conv_bwd_plain, fused_pairwise_conv_bxf,
    fused_pairwise_conv_bxf_plain, fused_pairwise_conv_plain,
    pairwise_contract, pairwise_contract_bxf,
)
from .models import SE3Transformer, SE3TransformerModule
from .ops import (
    EGNN, AttentionBlockSE3, AttentionSE3, ConvSE3, EGnnNetwork,
    FeedForwardBlockSE3, FeedForwardSE3, Fiber, HtypesNorm, LinearSE3,
    NormSE3, OneHeadedKVAttentionSE3, PairwiseConvSE3,
)
from .training import (
    RECIPES, BatchProducer, CheckpointManager, DenoiseConfig, DenoiseTrainer,
    ModelFamilyMismatch, PipelineStats, PointCloudDataset, af2_refinement,
    convert_sidechainnet, dataset_batch_source, denoise_loss,
    denoise_loss_fn, device_prefetch, egnn_stress, flagship, flagship_batch,
    flagship_fast, molecular_batch, molecular_edges, property_loss,
    synthetic_protein_batch, synthetic_protein_batch_host, toy_denoise,
)
from .utils.graph import chain_adjacency
