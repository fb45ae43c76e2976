"""Static-shape neighborhood construction: the port of
se3_transformer_tpu/ops/neighbors.py (kNN, sparse adjacency, causal).

Self-exclusion is by construction (query row i enumerates the n-1 other
nodes in ascending index order), the neighbor count K is static, and
validity is a mask. Ties in the ranking break toward the lower source
index, as the JAX package's top-k does: bonded pairs rank exactly 0 and
masked or future pairs the float32 maximum, so ties among them are the
rule, not the exception.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.helpers import batched_index_select, safe_norm

FINF = float(np.finfo(np.float32).max)


def exclude_self_indices(n: int, device=None) -> torch.Tensor:
    """[n, n-1] int64: row i lists all j != i in ascending order."""
    j = torch.arange(n - 1, device=device)[None, :]
    i = torch.arange(n, device=device)[:, None]
    return j + (j >= i).to(j.dtype)


def remove_self(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Drop the diagonal of a pairwise [b, n, n, ...] tensor ->
    [b, n, n-1, ...] using exclude_self_indices."""
    b, n = t.shape[0], t.shape[1]
    return batched_index_select(t, idx[None].expand(b, n, n - 1), dim=2)


def expand_adjacency(adj_mat: torch.Tensor, num_adj_degrees: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grow a bool adjacency [b, n, n] to `num_adj_degrees` hops, labelling
    each newly reached ring with its hop count: (the expanded adjacency,
    int64 ring labels in 0..num_adj_degrees, 0 = unreachable). Each hop
    squares the adjacency in float32 and thresholds it at > 0."""
    adj_indices = adj_mat.long()
    adj = adj_mat
    for degree in range(2, num_adj_degrees + 1):
        adj_f = adj.float()
        next_adj = torch.matmul(adj_f, adj_f) > 0
        adj_indices = torch.where(next_adj & ~adj,
                                  torch.full_like(adj_indices, degree),
                                  adj_indices)
        adj = next_adj
    return adj, adj_indices


def sparse_neighbor_mask(adj_mat_noself: torch.Tensor, num_sparse: int,
                         noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Up to num_sparse adjacent nodes per query as 'bonded' neighbors: the
    top num_sparse of the adjacency (+ tie-breaking noise), kept where
    their value exceeds 0.5. Without noise the top-k breaks ties by index.
    """
    values = adj_mat_noself.float()
    if noise is not None:
        values = values + noise
    # a stable descending sort: equal values keep the lower index first
    top_vals, top_idx = torch.sort(values, dim=-1, descending=True,
                                   stable=True)
    selected = torch.zeros_like(values).scatter(
        -1, top_idx[..., :num_sparse], top_vals[..., :num_sparse])
    return selected > 0.5


class Neighborhood(NamedTuple):
    indices: torch.Tensor          # [b, n, k] source-node ids
    mask: torch.Tensor             # [b, n, k] validity
    rel_pos: torch.Tensor          # [b, n, k, 3]
    rel_dist: torch.Tensor         # [b, n, k]


def top_k_smallest(ranking: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact smallest-k over the last axis, ascending, ties toward the
    lower index (a stable sort; torch.topk promises no tie order)."""
    vals, idx = torch.sort(ranking, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def select_neighbors(
    rel_pos: torch.Tensor,          # [b, n, n-1, 3] self-excluded offsets
    indices: torch.Tensor,          # [b, n, n-1] self-excluded source ids
    total_neighbors: int,           # static K
    valid_radius: float,
    pair_mask: Optional[torch.Tensor] = None,      # [b, n, n-1] node pairs
    neighbor_mask: Optional[torch.Tensor] = None,  # [b, n, n-1] user mask
    sparse_mask: Optional[torch.Tensor] = None,    # [b, n, n-1] bonded
    causal: bool = False,
) -> Tuple[Neighborhood, torch.Tensor]:
    """Fixed-K nearest-neighbor selection with bonded priority and causal
    masking. The ranking is the distance with user-masked pairs set to
    FINF, bonded pairs to 0 (they always win) and, with `causal`, future
    pairs to FINF: entry (i, j) of the self-excluded layout is source
    j + (j >= i), future iff j >= i. A slot is valid where its rank is
    within valid_radius (and its pair is in pair_mask, which invalidates
    slots without changing the ranking); the returned distances are the
    unmodified ones. Also returns the selected columns of the
    self-excluded layout [b, n, K]."""
    n = rel_pos.shape[1]
    rel_dist = safe_norm(rel_pos, dim=-1)  # [b, n, n-1]
    ranking = rel_dist
    if neighbor_mask is not None:
        ranking = ranking.masked_fill(~neighbor_mask.bool(), FINF)
    if sparse_mask is not None:
        ranking = ranking.masked_fill(sparse_mask.bool(), 0.)
    if causal:
        future = torch.ones(n, n - 1, dtype=torch.bool,
                            device=rel_pos.device).triu()
        ranking = ranking.masked_fill(future, FINF)
    dist_rank, nearest = top_k_smallest(ranking, total_neighbors)
    valid = dist_rank <= valid_radius

    out_dist = batched_index_select(rel_dist, nearest, dim=2)
    out_pos = batched_index_select(rel_pos, nearest, dim=2)
    out_idx = batched_index_select(indices, nearest, dim=2)
    if pair_mask is not None:
        valid = valid & batched_index_select(pair_mask, nearest, dim=2)
    return Neighborhood(out_idx, valid, out_pos, out_dist), nearest
