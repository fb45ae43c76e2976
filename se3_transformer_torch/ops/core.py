"""Core equivariant modules: Linear, Norm, Residual, FeedForward.

Port of se3_transformer_tpu/ops/core.py. Feature dicts are
{str(degree): [..., channels, 2*degree+1]}. Parameter names follow the flax
module's (`w{degree}`, `scale{degree}`) so that a converted flax tree
(convert.convert_flax_params) loads key for key. Parameters are created
with placeholder values; models.se3_transformer.init_parameters draws them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn

from ..utils.helpers import safe_norm
from .fiber import Fiber

Features = Dict[str, torch.Tensor]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's nn.gelu, the tanh approximation, evaluated op by op in x's
    dtype with its constants in that dtype — for bfloat16 that is the
    rounding after every op that the JAX package's bf16 radial trunk has
    (one fused F.gelu rounds once and differs in ~40% of the elements).
    The constants are 0-dim CPU tensors: rounded to x's dtype, and passed
    to a CUDA kernel as scalars, with no host-to-device copy that would
    block the host."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype)
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def residual_se3(x: Features, res: Features) -> Features:
    """Degree-wise residual add; keys may differ."""
    return {d: t + res[d] if d in res else t for d, t in x.items()}


class LinearSE3(nn.Module):
    """Per-degree channel-mixing linear map over the degrees present in
    both fibers; w{d} is [dim_in, dim_out] as in flax."""

    def __init__(self, fiber_in: Fiber, fiber_out: Fiber):
        super().__init__()
        self.pairs = fiber_in & fiber_out
        for degree, dim_in, dim_out in self.pairs:
            self.register_parameter(
                f'w{degree}', nn.Parameter(torch.zeros(dim_in, dim_out)))

    def forward(self, x: Features) -> Features:
        return {str(d): torch.einsum('...cm,ce->...em', x[str(d)],
                                     getattr(self, f'w{d}'))
                for d, _, _ in self.pairs}


class NormSE3(nn.Module):
    """Norm-gated equivariant nonlinearity: the invariant norm goes through
    a learned per-channel scale and `nonlin`, the direction is kept."""

    def __init__(self, fiber: Fiber, nonlin: Callable = gelu,
                 eps: float = 1e-12):
        super().__init__()
        self.nonlin = nonlin
        self.eps = eps
        for degree, chan in fiber:
            self.register_parameter(
                f'scale{degree}', nn.Parameter(torch.ones(1, 1, chan)))

    def forward(self, features: Features) -> Features:
        out = {}
        for degree, t in features.items():
            norm = safe_norm(t, dim=-1, keepdim=True).clamp(min=self.eps)
            phase = t / norm
            scalars = norm[..., 0]                       # [..., c]
            scale = getattr(self, f'scale{degree}')
            scaled = scalars * scale.reshape(scale.shape[-1])
            out[degree] = self.nonlin(scaled)[..., None] * phase
        return out


class FeedForwardSE3(nn.Module):
    """Linear -> norm nonlinearity -> Linear, widened by `mult`."""

    def __init__(self, fiber: Fiber, mult: int = 4):
        super().__init__()
        hidden = fiber.scale(mult)
        self.project_in = LinearSE3(fiber, hidden)
        self.nonlin = NormSE3(hidden)
        self.project_out = LinearSE3(hidden, fiber)

    def forward(self, features: Features) -> Features:
        return self.project_out(self.nonlin(self.project_in(features)))


class FeedForwardBlockSE3(nn.Module):
    """Prenorm + feedforward + residual."""

    def __init__(self, fiber: Fiber):
        super().__init__()
        self.prenorm = NormSE3(fiber)
        self.feedforward = FeedForwardSE3(fiber)

    def forward(self, features: Features) -> Features:
        out = self.feedforward(self.prenorm(features))
        return residual_se3(out, features)
