from .attention import (
    AttentionBlockSE3, AttentionSE3, OneHeadedKVAttentionSE3,
)
from .conv import (
    ConvSE3, PairwiseConvSE3, RadialFunc, pairwise_conv_contract,
)
from .core import (
    FeedForwardBlockSE3, FeedForwardSE3, LinearSE3, NormSE3, residual_se3,
)
from .egnn import EGNN, EGnnNetwork, HtypesNorm
from .fiber import Fiber, fiber_of
from .neighbors import (
    Neighborhood, exclude_self_indices, expand_adjacency, remove_self,
    select_neighbors, sparse_neighbor_mask,
)
from .rotary import apply_rotary_pos_emb, sinusoidal_embeddings
from .trunk import SequentialTrunk
