"""Model recipes: the port of se3_transformer_tpu/training/recipes.py's
`flagship_fast`, with the same defaults."""
from __future__ import annotations

from ..models.se3_transformer import SE3TransformerModule


def flagship_fast(dim: int = 64, num_neighbors: int = 32,
                  valid_radius: float = 1e5, depth: int = 6,
                  **overrides) -> SE3TransformerModule:
    """n-node kNN (k=32) SE(3)-transformer, 4 degrees, 8 heads, with the
    shared radial trunk, the basis-fused pairwise kernel and the bf16
    radial trunk. `overrides` are extra SE3TransformerModule fields,
    including `device` (default 'cuda', which raises without CUDA) and
    `generator` for the random weights."""
    overrides.setdefault('reversible', True)
    overrides.setdefault('edge_chunks', None)
    if overrides['reversible']:
        overrides.setdefault('remat_policy', 'save_conv_outputs')
    return SE3TransformerModule(
        dim=dim, depth=depth, num_degrees=4, heads=8,
        dim_head=max(8, dim // 8), attend_self=True,
        num_neighbors=num_neighbors, valid_radius=valid_radius,
        shared_radial_hidden=True, fuse_basis=True, radial_bf16=True,
        **overrides)

