from .attention import AttentionBlockSE3, AttentionSE3
from .conv import ConvSE3, PairwiseConvSE3
from .core import (
    FeedForwardBlockSE3, FeedForwardSE3, LinearSE3, NormSE3, residual_se3,
)
from .egnn import EGNN, EGnnNetwork, HtypesNorm
from .fiber import Fiber
from .neighbors import (
    exclude_self_indices, expand_adjacency, remove_self, select_neighbors,
    sparse_neighbor_mask,
)
from .trunk import SequentialTrunk
