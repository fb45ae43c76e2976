"""Tensor-field-network convolution: the port of se3_transformer_tpu/ops/conv.py
on its `shared_radial_hidden=True, fuse_basis=True` branch.

One radial trunk (Dense -> LayerNorm -> GELU, twice) is shared by every
(d_in, d_out) pair of a ConvSE3; each pair then makes one call of
kernels.pairwise.fused_pairwise_conv_bxf with its own grouped parameters
w3_{d_in}_{d_out} [mid, c_in*F, c_out] and b3_{d_in}_{d_out} [c_in*F, c_out],
contracting the flat (p, f, q) basis with the gathered neighbor features
inside the kernel.

radial_bf16 runs the trunk and the radial operands (h, w3) in bfloat16; the
bias and every accumulation stay float32, and LayerNorm statistics are
float32 as in flax.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.pairwise import fused_pairwise_conv_bxf
from ..utils.helpers import batched_index_select, masked_mean, to_order
from .core import LinearSE3, gelu, residual_se3
from .fiber import Fiber

Features = Dict[str, torch.Tensor]
# edge_info = (neighbor_indices [b,n,k], neighbor_mask [b,n,k] | None)
EdgeInfo = Tuple[torch.Tensor, Optional[torch.Tensor]]

# radial-MLP hidden width (the JAX package's DEFAULT_MID_DIM)
DEFAULT_MID_DIM = 128


def dense(x: torch.Tensor, layer: nn.Linear, dtype=None) -> torch.Tensor:
    """flax nn.Dense(dtype=...): input, kernel and bias cast to `dtype`,
    the product rounded to it, then the bias added in it."""
    dtype = dtype or x.dtype
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).t())
    return y + layer.bias.to(dtype)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    """flax nn.LayerNorm: float32 statistics with the one-pass variance
    E[x^2] - E[x]^2 (clipped at 0), result cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp(min=0.)
    mul = torch.rsqrt(var + layer.eps) * layer.weight
    return ((x32 - mean) * mul + layer.bias).to(x.dtype)


class ConvSE3(nn.Module):
    """Graph TFN convolution over precomputed neighborhoods."""

    def __init__(self, fiber_in: Fiber, fiber_out: Fiber,
                 self_interaction: bool = True, pool: bool = True,
                 radial_bf16: bool = False):
        super().__init__()
        if self_interaction and not pool:
            raise ValueError('must pool edges if followed with self '
                             'interaction')
        self.fiber_in, self.fiber_out = fiber_in, fiber_out
        self.pool = pool
        self.radial_dtype = torch.bfloat16 if radial_bf16 else None
        mid = DEFAULT_MID_DIM
        # the shared radial trunk, under the flax module's names
        self.Dense_0 = nn.Linear(1, mid)
        self.LayerNorm_0 = nn.LayerNorm(mid, eps=1e-6)
        self.Dense_1 = nn.Linear(mid, mid)
        self.LayerNorm_1 = nn.LayerNorm(mid, eps=1e-6)
        for d_out, m_out in fiber_out:
            for d_in, m_in in fiber_in:
                F = to_order(min(d_in, d_out))
                self.register_parameter(
                    f'w3_{d_in}_{d_out}',
                    nn.Parameter(torch.zeros(mid, m_in * F, m_out)))
                self.register_parameter(
                    f'b3_{d_in}_{d_out}',
                    nn.Parameter(torch.zeros(m_in * F, m_out)))
        self.self_interact = LinearSE3(fiber_in, fiber_out) \
            if self_interaction else None

    def radial_hidden(self, x: torch.Tensor) -> torch.Tensor:
        """Dense -> LayerNorm -> GELU, twice, in the radial dtype."""
        dt = self.radial_dtype
        x = gelu(layer_norm(dense(x, self.Dense_0, dt), self.LayerNorm_0))
        return gelu(layer_norm(dense(x, self.Dense_1, dt), self.LayerNorm_1))

    def forward(self, inp: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor]
                ) -> Features:
        """inp {d: [b, n, c, 2d+1]}; rel_dist [b, n, k]; basis
        {'d_in,d_out': [b, n, k, P*F*Q]} (layout 'pfq_flat').
        Pooled: {d: [b, n, c_out, 2d+1]}; else [b, n, k, c_out, 2d+1]."""
        neighbor_indices, neighbor_mask = edge_info
        b, n, k = neighbor_indices.shape
        E = b * n * k
        gathered = {str(d): batched_index_select(inp[str(d)],
                                                 neighbor_indices, dim=1)
                    for d, _ in self.fiber_in}       # [b, n, k, c_in, Q]
        hidden = self.radial_hidden(rel_dist[..., None])
        h = hidden.reshape(E, DEFAULT_MID_DIM)

        outputs = {}
        for d_out, m_out in self.fiber_out:
            P = to_order(d_out)
            acc = None
            for d_in, m_in in self.fiber_in:
                Q, F = to_order(d_in), to_order(min(d_in, d_out))
                w3 = getattr(self, f'w3_{d_in}_{d_out}').to(h.dtype)
                b3 = getattr(self, f'b3_{d_in}_{d_out}')
                # the kernel takes contiguous rows; a gather from an
                # einsum's permuted output can keep the source's strides
                y = fused_pairwise_conv_bxf(
                    h, w3,
                    basis[f'{d_in},{d_out}'].reshape(E, P * F * Q)
                    .contiguous(),
                    gathered[str(d_in)].reshape(E, m_in, Q).contiguous(),
                    (P, Q, F), b3)
                acc = y if acc is None else acc + y
            acc = acc.reshape(b, n, k, P, m_out).transpose(-1, -2)
            if self.pool:
                acc = masked_mean(acc, neighbor_mask, dim=2)
            outputs[str(d_out)] = acc

        if self.self_interact is not None:
            outputs = residual_se3(outputs, self.self_interact(inp))
        return outputs
