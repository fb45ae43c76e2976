"""Static-shape neighborhood construction: the plain-kNN part of
se3_transformer_tpu/ops/neighbors.py.

Self-exclusion is by construction (query row i enumerates the n-1 other
nodes in ascending index order), the neighbor count K is static, and
validity is a mask. Ties in distance break toward the lower source index,
as the JAX package's top-k does.
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
    pair_mask: Optional[torch.Tensor] = None,    # [b, n, n-1] node-pair mask
) -> Tuple[Neighborhood, torch.Tensor]:
    """Fixed-K nearest-neighbor selection. The pair mask invalidates
    slots; it does not change the ranking (as in the JAX package)."""
    rel_dist = safe_norm(rel_pos, dim=-1)  # [b, n, n-1]
    dist_rank, nearest = top_k_smallest(rel_dist, total_neighbors)
    valid = dist_rank <= valid_radius

    out_dist = batched_index_select(rel_dist, nearest, dim=2)
    out_pos = batched_index_select(rel_pos, nearest, dim=2)
    out_idx = batched_index_select(indices, nearest, dim=2)
    if pair_mask is not None:
        valid = valid & batched_index_select(pair_mask, nearest, dim=2)
    return Neighborhood(out_idx, valid, out_pos, out_dist), nearest
