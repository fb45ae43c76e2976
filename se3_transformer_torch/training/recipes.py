"""Model recipes: the port of se3_transformer_tpu/training/recipes.py's
`flagship`, `flagship_fast`, `af2_refinement`, `molecular_edges`,
`toy_denoise` and `egnn_stress`, with the same defaults, and its
`RECIPES` table."""
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


# flagship_fast's width: its features are [n, FLAGSHIP_FAST_DIM]
FLAGSHIP_FAST_DIM = 64


def flagship_fast(dim: int = FLAGSHIP_FAST_DIM, num_neighbors: int = 32,
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


def _recipe(fields: dict, overrides: dict) -> SE3TransformerModule:
    """SE3TransformerModule of a recipe's fields, `overrides` replacing or
    adding fields (the recipe's own included, e.g. `depth`; `device`
    defaults to 'cuda', which raises without CUDA, and `generator` draws
    the random weights)."""
    return SE3TransformerModule(**dict(fields, **overrides))


def af2_refinement(dim: int = 32, **overrides) -> SE3TransformerModule:
    """AlphaFold2-style coordinate refinement: a depth-2 kNN (k=12)
    SE(3)-transformer over degrees 0 and 1 with a vector head
    (output_degrees=2, reduce_dim_out) and coordinate gradients
    (differentiable_coors), on the JAX default model surface: a radial
    trunk per degree pair (no shared trunk), float32, V2 by einsum
    contracted once per pair (kernel #3), 8 heads of 24."""
    return _recipe(dict(dim=dim, depth=2, input_degrees=1, num_degrees=2,
                        output_degrees=2, differentiable_coors=True,
                        reduce_dim_out=True, attend_self=True,
                        num_neighbors=12), overrides)


def molecular_edges(dim: int = 32, **overrides) -> SE3TransformerModule:
    """Edge-conditioned small molecules: atom tokens (28), bond-type edge
    tokens (4) embedded into 4 edge features, the chain adjacency grown to
    2 hops with 4-wide ring embeddings, and attention over the bonded
    neighbors only (num_neighbors=0, up to 6 bonded a row); depth 2,
    degrees 0 and 1, a scalar head, 8 heads of 24, on the JAX default
    model surface. Call it with adj_mat and edges."""
    return _recipe(dict(num_tokens=28, num_edge_tokens=4, edge_dim=4,
                        dim=dim, depth=2, num_degrees=2, attend_self=True,
                        num_neighbors=0, attend_sparse_neighbors=True,
                        max_sparse_neighbors=6, num_adj_degrees=2,
                        adj_dim=4, output_degrees=1), overrides)


def toy_denoise(**overrides) -> SE3TransformerModule:
    """denoise.py's toy point cloud model: tokens (24), dim 8, 2 heads of
    8, depth 2, degrees 0 and 1 with a vector head, bonded attention only
    (num_neighbors=0, up to 8 bonded a row, 2-hop adjacency with 4-wide
    ring embeddings)."""
    return _recipe(dict(num_tokens=24, dim=8, dim_head=8, heads=2, depth=2,
                        attend_self=True, input_degrees=1, num_degrees=2,
                        output_degrees=2, reduce_dim_out=True,
                        differentiable_coors=True, num_neighbors=0,
                        attend_sparse_neighbors=True,
                        max_sparse_neighbors=8, num_adj_degrees=2,
                        adj_dim=4), overrides)


def egnn_stress(dim: int = 16, depth: int = 12,
                **overrides) -> SE3TransformerModule:
    """The EGNN backbone at depth: degrees 0 and 1 of width 16, 12 EGNN
    layers each followed by a feedforward block, the higher-degree weights
    clamped to +-2, kNN k = 16, each layer and feedforward checkpointed
    (reversible). No conv_out: the output is the hidden fiber's
    (return_type 1: [b, n, dim, 3])."""
    return _recipe(dict(dim=dim, depth=depth, num_degrees=2, use_egnn=True,
                        egnn_feedforward=True, egnn_weights_clamp_value=2.0,
                        num_neighbors=16, reversible=True), overrides)


RECIPES = {
    'toy_denoise': toy_denoise,
    'flagship': flagship,
    'flagship_fast': flagship_fast,
    'af2_refinement': af2_refinement,
    'molecular_edges': molecular_edges,
    'egnn_stress': egnn_stress,
}
