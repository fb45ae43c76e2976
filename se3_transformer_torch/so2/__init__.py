"""The SO(2)-reduced contraction backend (conv_backend='so2'): the port of
se3_transformer_tpu/so2 (eSCN, arXiv:2302.03655).

Each edge's features are rotated so that the edge lies on the z axis; there
the dense Clebsch-Gordan contraction is a banded per-(+/-m) multiply by the
canonical blocks, the radial product is the dense path's, and the result is
rotated back. Same parameters as the dense path.

  * canonical: the canonical-axis blocks per degree pair (the package's
    seed first, then the user cache, then the Q_J construction);
  * frames: per-edge frame harmonics and the factored Wigner rotations;
  * contract: the banded contraction and so2_pair_contract.
"""
from .canonical import canonical_blocks, canonical_kernel
from .contract import banded_z, so2_pair_contract
from .frames import edge_frames, rotate_in, rotate_out, wigner_from_frames

__all__ = [
    'banded_z', 'canonical_blocks', 'canonical_kernel', 'edge_frames',
    'rotate_in', 'rotate_out', 'so2_pair_contract', 'wigner_from_frames',
]
