"""The E(n)-GNN backbone generalized to higher-degree features: the port of
se3_transformer_tpu/ops/egnn.py (HtypesNorm, EGNN, EGnnNetwork), the model's
trunk with use_egnn.

As in JAX, the neighbors are gathered first, so everything stays O(n * k):
the relative higher-degree features are formed on the [b, n, k]
neighborhood. JAX's documented deviation from the reference is kept: the
neighbor mask is applied for real, to the higher-degree weights and to the
messages. EGnnNetwork prepends each node itself to its neighbor list (a
valid slot at distance 0 with zero edge features). No kernel: the layers
are plain torch ops. Parameter names are the flax ones (`edge_mlp0`,
`htypes_mlp1`, `node_norm`, `htype_gate{d}`, `htype_norm{d}/scale`, ...);
models.se3_transformer.init_parameters draws them as flax does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F_
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.helpers import batched_index_select, safe_norm
from .conv import EdgeInfo, dense, layer_norm
from .core import FeedForwardBlockSE3
from .fiber import Fiber

Features = Dict[str, torch.Tensor]


class HtypesNorm(nn.Module):
    """Norm-and-affine rescaling of higher-degree vectors: each channel's
    direction times (norm * scale + bias), scale and bias [c, 1]
    (constants 1e-2 at init, as flax draws them)."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(dim, 1))
        self.bias = nn.Parameter(torch.zeros(dim, 1))

    def forward(self, htype: torch.Tensor) -> torch.Tensor:
        """htype [..., c, m] -> [..., c, m]."""
        norm = safe_norm(htype, dim=-1, keepdim=True)
        normed = htype / norm.clamp(min=self.eps)
        return normed * (norm * self.scale + self.bias)


class EGNN(nn.Module):
    """One EGNN layer over precomputed neighborhoods: edge messages from
    both nodes' scalars, the relative higher-degree norms, the distance
    and the edges; the higher degrees move along their normalized relative
    vectors by message-weighted sums; the scalars by a residual MLP of the
    summed messages; each higher degree is gated by its node's scalars.
    edge_dim is the width of edge_info's edges (0 without)."""

    def __init__(self, fiber: Fiber, hidden_dim: int = 32, edge_dim: int = 0,
                 coor_weights_clamp_value: Optional[float] = None):
        super().__init__()
        structure = dict(fiber.structure)
        node_dim = structure[0]
        self.htype_degrees = [d for d, _ in fiber if d != 0]
        htype_dims = [structure[d] for d in self.htype_degrees]
        self.clamp = coor_weights_clamp_value
        edge_in = 2 * node_dim + sum(htype_dims) + 1 + edge_dim
        self.edge_mlp0 = nn.Linear(edge_in, edge_in * 2)
        self.edge_mlp1 = nn.Linear(edge_in * 2, hidden_dim)
        self.htypes_mlp0 = nn.Linear(hidden_dim, hidden_dim * 4)
        self.htypes_mlp1 = nn.Linear(hidden_dim * 4, sum(htype_dims))
        for d, dim in zip(self.htype_degrees, htype_dims):
            self.add_module(f'htype_norm{d}', HtypesNorm(dim))
        self.node_norm = nn.LayerNorm(node_dim, eps=1e-6)
        self.node_mlp0 = nn.Linear(node_dim + hidden_dim, node_dim * 2)
        self.node_mlp1 = nn.Linear(node_dim * 2, node_dim)
        for d, dim in zip(self.htype_degrees, htype_dims):
            self.add_module(f'htype_gate{d}', nn.Linear(node_dim, dim))

    def forward(self, features: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor) -> Features:
        """features {d: [b, n, c, 2d+1]}; edge_info (indices [b, n, k],
        mask [b, n, k] or None, edges [b, n, k, e] or None); rel_dist [b,
        n, k] -> the updated features."""
        neighbor_indices, neighbor_mask, edges = edge_info
        nodes = features['0'][..., 0]                          # [b, n, d]
        k = neighbor_indices.shape[-1]
        rel, dists = {}, []
        for d in self.htype_degrees:
            t = features[str(d)]
            r = t[:, :, None] - batched_index_select(t, neighbor_indices,
                                                     dim=1)  # [b, n, k, c, m]
            rel[d] = r
            dists.append(safe_norm(r, dim=-1))
        nodes_i = nodes[:, :, None].expand(-1, -1, k, -1)
        nodes_j = batched_index_select(nodes, neighbor_indices, dim=1)
        inp = torch.cat((nodes_i, nodes_j, *dists, rel_dist[..., None]), -1)
        if edges is not None:
            inp = torch.cat((inp, edges.to(inp.dtype)), dim=-1)
        m = F_.silu(dense(F_.silu(dense(inp, self.edge_mlp0)),
                          self.edge_mlp1))
        w = dense(F_.silu(dense(m, self.htypes_mlp0)), self.htypes_mlp1)
        if self.clamp is not None:
            w = w.clamp(-self.clamp, self.clamp)
        if neighbor_mask is not None:
            w = torch.where(neighbor_mask[..., None], w, torch.zeros_like(w))
            m = torch.where(neighbor_mask[..., None], m, torch.zeros_like(m))
        out = dict(features)
        node_in = torch.cat((layer_norm(nodes, self.node_norm), m.sum(-2)),
                            dim=-1)
        node_out = dense(F_.silu(dense(node_in, self.node_mlp0)),
                         self.node_mlp1) + nodes
        out['0'] = node_out[..., None]
        offset = 0
        for d in self.htype_degrees:
            t = features[str(d)]
            dim = t.shape[-2]
            normed = getattr(self, f'htype_norm{d}')(rel[d])
            update = torch.einsum('bijcm,bijc->bicm', normed,
                                  w[..., offset:offset + dim])
            offset += dim
            gate = torch.sigmoid(dense(node_out, getattr(self,
                                                         f'htype_gate{d}')))
            out[str(d)] = (t + update) * gate[..., None]
        return out


class EGnnNetwork(nn.Module):
    """depth x (EGNN [+ FeedForwardBlockSE3]) with each node prepended to
    its own neighbor list (JAX EGnnNetwork). reversible checkpoints each
    layer and each feedforward with a non-reentrant torch.utils.checkpoint,
    as JAX wraps them in nn.remat: their activations are recomputed in the
    backward."""

    def __init__(self, fiber: Fiber, depth: int, edge_dim: int = 0,
                 hidden_dim: int = 32,
                 coor_weights_clamp_value: Optional[float] = None,
                 feedforward: bool = False, reversible: bool = False):
        super().__init__()
        self.depth = depth
        self.feedforward = feedforward
        self.reversible = reversible
        for i in range(depth):
            self.add_module(f'egnn{i}', EGNN(
                fiber, hidden_dim=hidden_dim, edge_dim=edge_dim,
                coor_weights_clamp_value=coor_weights_clamp_value))
            if feedforward:
                self.add_module(f'ff{i}', FeedForwardBlockSE3(fiber))

    def _run(self, layer: nn.Module, *args):
        if not (self.reversible and torch.is_grad_enabled()):
            return layer(*args)
        return checkpoint(layer, *args, use_reentrant=False)

    def forward(self, features: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis=None, global_feats=None,
                pos_emb=None) -> Features:
        """The trunk's call (basis, global_feats and pos_emb are not
        read, as in JAX)."""
        neighbor_indices, neighbor_mask, edges = edge_info
        b, n, _ = neighbor_indices.shape
        self_idx = torch.arange(n, dtype=neighbor_indices.dtype,
                                device=neighbor_indices.device)
        neighbor_indices = torch.cat(
            (self_idx[None, :, None].expand(b, n, 1), neighbor_indices), -1)
        if neighbor_mask is not None:
            neighbor_mask = F_.pad(neighbor_mask, (1, 0), value=True)
        rel_dist = F_.pad(rel_dist, (1, 0))
        if edges is not None:
            edges = F_.pad(edges, (0, 0, 1, 0))
        edge_info = (neighbor_indices, neighbor_mask, edges)
        for i in range(self.depth):
            features = self._run(getattr(self, f'egnn{i}'), features,
                                 edge_info, rel_dist)
            if self.feedforward:
                features = self._run(getattr(self, f'ff{i}'), features)
        return features
