"""Multi-degree SE(3)-equivariant attention over kNN neighborhoods: the port
of se3_transformer_tpu/ops/attention.py's unfused kNN path (AttentionSE3
with kv_heads == heads, and AttentionBlockSE3).

The attention core is plain einsums, as in the JAX package's default. KV
slot order along the neighbor axis is [self, neighbors]; the neighbor mask
is left-padded with True over the self slot, and masked logits are filled
with the finite float32 minimum.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.helpers import to_order
from .conv import ConvSE3, EdgeInfo
from .core import LinearSE3, NormSE3, residual_se3
from .fiber import Fiber

Features = Dict[str, torch.Tensor]


class AttentionSE3(nn.Module):
    def __init__(self, fiber: Fiber, dim_head: int = 64, heads: int = 8,
                 radial_bf16: bool = False, fuse_basis: bool = False,
                 edge_chunks: Optional[int] = None):
        super().__init__()
        self.fiber, self.dim_head, self.heads = fiber, dim_head, heads
        hidden_fiber = fiber.to(dim_head * heads)
        self.to_q = LinearSE3(fiber, hidden_fiber)
        conv_kwargs = dict(pool=False, self_interaction=False,
                           radial_bf16=radial_bf16, fuse_basis=fuse_basis,
                           edge_chunks=edge_chunks)
        self.to_v = ConvSE3(fiber, hidden_fiber, **conv_kwargs)
        self.to_k = ConvSE3(fiber, hidden_fiber, **conv_kwargs)
        self.to_self_k = LinearSE3(fiber, hidden_fiber)
        self.to_self_v = LinearSE3(fiber, hidden_fiber)
        project_out = not (heads == 1 and len(fiber.dims) == 1
                           and dim_head == fiber.dims[0])
        self.to_out = LinearSE3(hidden_fiber, fiber) if project_out else None

    def forward(self, features: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor]
                ) -> Features:
        h, dh = self.heads, self.dim_head
        neighbor_mask = edge_info[1]
        queries = self.to_q(features)
        values = self.to_v(features, edge_info, rel_dist, basis)
        keys = self.to_k(features, edge_info, rel_dist, basis)
        self_keys = self.to_self_k(features)
        self_values = self.to_self_v(features)

        outputs = {}
        for degree in features.keys():
            m = to_order(int(degree))
            q = queries[degree]
            b, n = q.shape[0], q.shape[1]
            # q [b, h, n, d, m]; k/v [b, h, n, j, d, m]
            q = q.reshape(b, n, h, dh, m).permute(0, 2, 1, 3, 4)
            k, v = [t.reshape(b, n, t.shape[2], h, dh, m)
                    .permute(0, 3, 1, 2, 4, 5)
                    for t in (keys[degree], values[degree])]
            s_k, s_v = [t.reshape(b, n, h, dh, m).permute(0, 2, 1, 3, 4)
                        [:, :, :, None]
                        for t in (self_keys[degree], self_values[degree])]
            k = torch.cat((s_k, k), dim=3)
            v = torch.cat((s_v, v), dim=3)

            sim = torch.einsum('bhidm,bhijdm->bhij', q, k) * dh ** -0.5
            if neighbor_mask is not None:
                padded = F.pad(neighbor_mask,
                               (k.shape[3] - neighbor_mask.shape[-1], 0),
                               value=True)
                sim = sim.masked_fill(~padded[:, None],
                                      torch.finfo(sim.dtype).min)
            attn = sim.softmax(dim=-1)
            out = torch.einsum('bhij,bhijdm->bhidm', attn, v)
            outputs[degree] = out.permute(0, 2, 1, 3, 4).reshape(
                b, n, h * dh, m)

        if self.to_out is not None:
            outputs = self.to_out(outputs)
        return outputs


class AttentionBlockSE3(nn.Module):
    """Prenorm + attention + residual."""

    def __init__(self, fiber: Fiber, dim_head: int = 24, heads: int = 8,
                 radial_bf16: bool = False, fuse_basis: bool = False,
                 edge_chunks: Optional[int] = None):
        super().__init__()
        self.prenorm = NormSE3(fiber)
        self.attn = AttentionSE3(fiber, dim_head=dim_head, heads=heads,
                                 radial_bf16=radial_bf16,
                                 fuse_basis=fuse_basis,
                                 edge_chunks=edge_chunks)

    def forward(self, features: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor]
                ) -> Features:
        out = self.attn(self.prenorm(features), edge_info, rel_dist, basis)
        return residual_se3(out, features)
