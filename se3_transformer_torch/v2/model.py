"""SE3TransformerV2, the eSCN-direct model family: the port of
se3_transformer_tpu/v2/model.py.

A sibling of models/se3_transformer.py, deliberately not checkpoint
compatible with it (its radial parameterization is the per-m banded blocks
of v2/conv.py); `model_family = 'se3_v2'` is the stamp that makes
training.checkpoint's family guard refuse a cross-family restore before any
tensor is read. The user contract is v1's:

    module(feats, coors, mask=mask, adj_mat=adj, return_type=1)

with the same feats normalization (tokens -> token_emb, arrays -> {'0'}),
the same Cartesian <-> irrep degree-1 permutation, the same
`output_degrees == 1 -> return_type = 0` and '0'-squeeze conventions and
the same return_pooled masked mean, so the InferenceEngine, the trainer and
the checkpoints take it unchanged. `adj_mat` is accepted and unused, as in
JAX.

Architecture: conv_in -> depth x (SeparableS2Activation -> V2ConvSE3 +
residual) -> SeparableS2Activation -> conv_out (-> linear_out with
reduce_dim_out), on the per-m radial path with the edge frames as the only
geometry: no basis anywhere. Every contraction is kernels.pairwise's #3
at mid 32 (A and B under autograd) on a card.

The module runs on `device` ('cuda' by default; 'cpu' takes the plain
versions) with its parameters drawn from `generator` (seeded 0 by default)
the way the flax module initializes them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.se3_transformer import (
    SE3Transformer, _CART_TO_IRREP, _IRREP_TO_CART, _permute_degree1,
    init_parameters,
)
from ..observability import named_scope
from ..ops.core import LinearSE3, residual_se3
from ..ops.fiber import Fiber
from ..ops.neighbors import exclude_self_indices, remove_self, select_neighbors
from ..so2.frames import edge_frames
from ..utils.helpers import batched_index_select, masked_mean, resolve_device
from .conv import DEFAULT_V2_MID_DIM, V2ConvSE3
from .s2act import SeparableS2Activation


class SE3TransformerV2Module(nn.Module):
    """The v2 family's module (module docstring). Fields are the JAX
    module's; pallas_interpret and matmul_precision ('highest': float32
    products run in float32 here) are JAX fields with nothing to choose."""

    model_family = 'se3_v2'

    def __init__(self, dim: int, depth: int = 2, num_degrees: int = 4,
                 output_degrees: int = 1, input_degrees: int = 1,
                 dim_in: Optional[int] = None, dim_out: Optional[int] = None,
                 num_tokens: Optional[int] = None, num_neighbors: int = 12,
                 valid_radius: float = 1e5, reduce_dim_out: bool = False,
                 edge_dim: int = 0, mid_dim: int = DEFAULT_V2_MID_DIM,
                 max_m: Optional[int] = None, s2_grid_nonlin: bool = True,
                 s2_resolution: Optional[int] = None,
                 differentiable_coors: bool = False,
                 matmul_precision: Optional[str] = 'highest',
                 pallas: Optional[bool] = None, pallas_interpret: bool = False,
                 edge_chunks: Optional[int] = None, radial_bf16: bool = False,
                 conv_bf16: bool = False, *, device='cuda',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if input_degrees != 1:
            raise ValueError('v2 takes scalar (degree-0) inputs')
        if matmul_precision not in (None, 'highest') or pallas_interpret:
            raise NotImplementedError(
                'matmul_precision and pallas_interpret are JAX fields: only '
                "their defaults ('highest', False) are ported")
        self.depth, self.num_degrees = depth, num_degrees
        self.output_degrees = output_degrees
        self.num_neighbors, self.valid_radius = num_neighbors, valid_radius
        self.differentiable_coors = differentiable_coors
        self.edge_dim = edge_dim
        dim_in = dim if dim_in is None else dim_in
        dim_out = dim if dim_out is None else dim_out
        self.fiber_in = Fiber.create(1, dim_in)
        fiber_hidden = Fiber.create(num_degrees, dim)
        fiber_out = Fiber.create(output_degrees, dim_out)
        if num_tokens is not None:
            self.token_emb = nn.Embedding(num_tokens, dim_in)
        conv_kwargs = dict(mid_dim=mid_dim, max_m=max_m, edge_dim=edge_dim,
                           pallas=pallas, edge_chunks=edge_chunks,
                           radial_bf16=radial_bf16, conv_bf16=conv_bf16)
        act_kwargs = dict(grid_nonlin=s2_grid_nonlin,
                          resolution=s2_resolution)
        self.conv_in = V2ConvSE3(self.fiber_in, fiber_hidden, **conv_kwargs)
        for i in range(depth):
            self.add_module(f'act{i}', SeparableS2Activation(fiber_hidden,
                                                             **act_kwargs))
            self.add_module(f'block{i}', V2ConvSE3(fiber_hidden, fiber_hidden,
                                                   **conv_kwargs))
        self.act_out = SeparableS2Activation(fiber_hidden, **act_kwargs)
        self.conv_out = V2ConvSE3(fiber_hidden, fiber_out, **conv_kwargs)
        self.linear_out = LinearSE3(fiber_out, fiber_out.to(1)) \
            if reduce_dim_out else None
        init_parameters(self, generator if generator is not None
                        else torch.Generator().manual_seed(0))
        self.to(device)

    def forward(self, feats, coors: torch.Tensor,
                mask: Optional[torch.Tensor] = None, adj_mat=None,
                edges: Optional[torch.Tensor] = None,
                return_type: Optional[int] = None,
                return_pooled: bool = False,
                neighbor_mask: Optional[torch.Tensor] = None):
        """feats [b, n, dim_in] (integer tokens [b, n] with num_tokens) or
        {'0': [b, n, dim_in, 1]}, coors [b, n, 3], mask [b, n] bool, edges
        [b, n, n, edge_dim] features, neighbor_mask [b, n, n] bool ->
        SE3TransformerModule.forward's outputs and conventions."""
        if self.output_degrees == 1:
            return_type = 0
        if hasattr(self, 'token_emb'):
            feats = self.token_emb(feats)
        if not isinstance(feats, dict):
            feats = {'0': feats[..., None]}
        feats = _permute_degree1(feats, _CART_TO_IRREP)
        b, n = feats['0'].shape[0], feats['0'].shape[1]
        if feats['0'].shape[2] != self.fiber_in[0]:
            raise ValueError(f"feature dim {feats['0'].shape[2]} != "
                             f"configured {self.fiber_in[0]}")
        num_neighbors = int(min(self.num_neighbors, n - 1))
        if num_neighbors <= 0:
            raise ValueError('must fetch at least 1 neighbor')
        if (edges is None) != (self.edge_dim == 0):
            raise ValueError(f'edges of width {self.edge_dim} must be given '
                             f'iff edge_dim is set')

        # fixed-K neighbor selection, self excluded (the v1 dense path)
        self_excl = exclude_self_indices(n, device=coors.device)
        rel_pos = remove_self(coors[:, :, None, :] - coors[:, None, :, :],
                              self_excl)                   # [b, n, n-1, 3]
        indices = self_excl[None].expand(b, n, n - 1)
        pair_mask = None
        if mask is not None:
            pair_mask = remove_self(mask[:, :, None] & mask[:, None, :],
                                    self_excl)
        if edges is not None:
            edges = remove_self(edges, self_excl)
        if neighbor_mask is not None:
            neighbor_mask = remove_self(neighbor_mask, self_excl)
        with named_scope('neighbors'):
            hood, nearest = select_neighbors(
                rel_pos, indices, num_neighbors, self.valid_radius,
                pair_mask=pair_mask, neighbor_mask=neighbor_mask)
        if edges is not None:
            edges = batched_index_select(edges, nearest, dim=2)

        # the only geometry payload: the edge frames
        with named_scope('frames'):
            frames = edge_frames(hood.rel_pos, self.num_degrees - 1,
                                 differentiable=self.differentiable_coors)
        edge_info = (hood.indices, hood.mask, edges)

        with named_scope('conv_in'):
            x = self.conv_in(feats, edge_info, hood.rel_dist, frames)
        for i in range(self.depth):
            y = getattr(self, f'act{i}')(x)
            y = getattr(self, f'block{i}')(y, edge_info, hood.rel_dist,
                                           frames)
            x = residual_se3(y, x)
        x = self.act_out(x)
        with named_scope('conv_out'):
            x = self.conv_out(x, edge_info, hood.rel_dist, frames)

        if self.linear_out is not None:
            x = {d: t[..., 0, :] for d, t in self.linear_out(x).items()}
        x = _permute_degree1(x, _IRREP_TO_CART)
        if return_pooled:
            x = {d: masked_mean(t, mask, dim=1) for d, t in x.items()}
        if '0' in x:
            x['0'] = x['0'][..., 0]
        if return_type is not None:
            return x[str(return_type)]
        return x


class SE3TransformerV2(SE3Transformer):
    """Eager convenience wrapper mirroring SE3Transformer's:

        model = SE3TransformerV2(dim=8, depth=1, num_degrees=7,
                                 device='cpu')
        out = model(feats, coors, mask, return_type=1)

    The module is built, its parameters drawn from a generator seeded
    `seed`, on the first call (or init())."""

    model_family = 'se3_v2'
    module_class = SE3TransformerV2Module
