"""Model recipes: the port of se3_transformer_tpu/training/recipes.py's
`flagship`, `flagship_fast` and `af2_refinement`, with the same defaults."""
from __future__ import annotations

from ..models.se3_transformer import SE3TransformerModule


def flagship(dim: int = 64, num_neighbors: int = 32,
             valid_radius: float = 1e5, depth: int = 6,
             **overrides) -> SE3TransformerModule:
    """The conservative recipe (bench.py's default record): n-node kNN
    (k=32) SE(3)-transformer, 4 degrees, 8 heads, the shared radial trunk
    in float32, V2 built by einsum and contracted once per output degree,
    reversible blocks replayed whole (no remat policy), and every
    contraction streamed over 8 node chunks (edge_chunks=8). `overrides`
    are extra SE3TransformerModule fields: `output_degrees=2,
    reduce_dim_out=True` give the vector head of the denoise training
    step, `device` defaults to 'cuda' (which raises without CUDA) and
    `generator` draws the random weights."""
    overrides.setdefault('reversible', True)
    overrides.setdefault('edge_chunks', 8)
    return SE3TransformerModule(
        dim=dim, depth=depth, num_degrees=4, heads=8,
        dim_head=max(8, dim // 8), attend_self=True,
        num_neighbors=num_neighbors, valid_radius=valid_radius,
        shared_radial_hidden=True, **overrides)


def flagship_fast(dim: int = 64, num_neighbors: int = 32,
                  valid_radius: float = 1e5, depth: int = 6,
                  **overrides) -> SE3TransformerModule:
    """n-node kNN (k=32) SE(3)-transformer, 4 degrees, 8 heads, with the
    shared radial trunk, the basis-fused pairwise kernel and the bf16
    radial trunk. `overrides` are extra SE3TransformerModule fields:
    `output_degrees=2, reduce_dim_out=True` give the vector head of the
    denoise training step, `device` defaults to 'cuda' (which raises
    without CUDA) and `generator` draws the random weights."""
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


def af2_refinement(dim: int = 32, **overrides) -> SE3TransformerModule:
    """AlphaFold2-style coordinate refinement: a depth-2 kNN (k=12)
    SE(3)-transformer over degrees 0 and 1 with a vector head
    (output_degrees=2, reduce_dim_out) and coordinate gradients
    (differentiable_coors), on the JAX default model surface: a radial
    trunk per degree pair (no shared trunk), float32, V2 by einsum
    contracted once per pair (kernel #3), 8 heads of 24. `overrides`
    replace or add SE3TransformerModule fields (the recipe's own included,
    e.g. `depth`); `device` defaults to 'cuda' (which raises without CUDA)
    and `generator` draws the random weights."""
    fields = dict(depth=2, input_degrees=1, num_degrees=2, output_degrees=2,
                  differentiable_coors=True, reduce_dim_out=True,
                  attend_self=True, num_neighbors=12)
    fields.update(overrides)
    return SE3TransformerModule(dim=dim, **fields)
