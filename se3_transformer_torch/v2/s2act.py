"""Separable S2 activation: the v2 replacement for NormSE3, the port of
se3_transformer_tpu/v2/s2act.py.

Two degree-local parts:

  1. an exactly equivariant per-degree scalar gate: a Dense head `gate{l}`
     on the invariant l = 0 channels, sigmoid, multiplying each l > 0
     degree's channels (the only learned piece);
  2. with `grid_nonlin`, a pointwise nonlinearity on a fixed S2 grid: each
     degree's channel is synthesized to f(omega) = sum_m x_m Y_lm(omega) on
     a Gauss-Legendre x uniform-phi grid, passed through gelu pointwise
     and analyzed back onto the same degree's harmonics. Rotation commutes
     with a pointwise map in the continuum, so the only equivariance cost
     is the quadrature's aliasing of gelu(f)'s tail spectrum.

The synthesis and analysis matrices are host float64 constants (the
analysis solved against the grid's Gram matrix, so analysis . synthesis =
I to float64 whatever the harmonics' normalization), cast once per
(degree, grid, dtype, device). Zero features stay exactly zero through the
round trip (gelu(0) = 0): what makes a padded forward agree with an
unpadded one. gelu is flax's, the tanh approximation.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import dense
from ..ops.fiber import Fiber
from ..so3.spherical_harmonics import angles_to_xyz, real_spherical_harmonics
from ..utils.helpers import device_constant

Features = Dict[str, torch.Tensor]


@lru_cache(maxsize=None)
def s2_grid_matrices(degree: int, n_theta: int, n_phi: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(synthesis [G, 2l+1], analysis [2l+1, G]) for one degree on the
    Gauss-Legendre(cos theta) x uniform(phi) grid, host float64;
    analysis @ synthesis == I to quadrature exactness (n_theta > l,
    n_phi > 2l)."""
    nodes, glw = np.polynomial.legendre.leggauss(n_theta)
    theta = np.arccos(nodes)                       # [n_theta]
    phi = 2.0 * np.pi * np.arange(n_phi) / n_phi   # [n_phi]
    tt, pp = np.meshgrid(theta, phi, indexing='ij')
    xyz = angles_to_xyz(tt.reshape(-1), pp.reshape(-1))
    Y = np.asarray(real_spherical_harmonics(degree, xyz),
                   dtype=np.float64)               # [G, 2l+1]
    w = np.repeat(glw, n_phi) * (2.0 * np.pi / n_phi)  # [G]
    Yw = Y.T * w[None, :]                          # [2l+1, G]
    gram = Yw @ Y                                  # [2l+1, 2l+1]
    return Y, np.linalg.solve(gram, Yw)


def default_grid(degree: int, resolution: Optional[int] = None
                 ) -> Tuple[int, int]:
    """(n_theta, n_phi) for one degree: 4(l+1) theta nodes (at least 8),
    about twice what the linear round trip needs, so that gelu's alias tail
    lands below ~1e-6; `resolution` overrides the theta nodes."""
    n_theta = resolution if resolution is not None \
        else max(4 * (degree + 1), 8)
    if n_theta < degree + 1:
        raise ValueError(f's2 grid resolution {n_theta} cannot resolve '
                         f'degree {degree}')
    return n_theta, 2 * n_theta + 1


@device_constant
def _grid_tensors(degree: int, n_theta: int, n_phi: int, dtype: torch.dtype,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    Y, A = s2_grid_matrices(degree, n_theta, n_phi)
    with torch.inference_mode(False):
        return (torch.as_tensor(Y, dtype=dtype, device=device),
                torch.as_tensor(A, dtype=dtype, device=device))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate='tanh')


class SeparableS2Activation(nn.Module):
    """Features -> Features over one fiber (module docstring): degree 0
    through gelu, each l > 0 degree (optionally through the grid
    nonlinearity) times sigmoid(gate{l}(the degree-0 channels))."""

    def __init__(self, fiber: Fiber, grid_nonlin: bool = True,
                 resolution: Optional[int] = None):
        super().__init__()
        self.fiber = fiber
        self.grid_nonlin = grid_nonlin
        self.resolution = resolution
        for degree, channels in fiber:
            if degree > 0:
                self.add_module(f'gate{degree}',
                                nn.Linear(fiber[0], channels))

    def forward(self, features: Features) -> Features:
        scalars = features['0'][..., 0]                # [..., C0]
        out = {}
        for degree, _ in self.fiber:
            key = str(degree)
            x = features[key]
            if degree == 0:
                out[key] = _gelu(x)
                continue
            if self.grid_nonlin:
                grid = default_grid(degree, self.resolution)
                synth, analy = _grid_tensors(degree, *grid, x.dtype,
                                             x.device)
                f = torch.einsum('...cp,gp->...cg', x, synth)
                x = torch.einsum('...cg,pg->...cp', _gelu(f), analy)
            gate = torch.sigmoid(dense(scalars, getattr(self,
                                                        f'gate{degree}')))
            out[key] = x * gate[..., None]
        return out
