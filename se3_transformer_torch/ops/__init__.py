from .attention import AttentionBlockSE3, AttentionSE3
from .conv import ConvSE3, PairwiseConvSE3
from .core import (
    FeedForwardBlockSE3, FeedForwardSE3, LinearSE3, NormSE3, residual_se3,
)
from .fiber import Fiber
from .neighbors import exclude_self_indices, remove_self, select_neighbors
from .trunk import SequentialTrunk
