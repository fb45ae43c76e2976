"""Per-edge frame alignment of the SO(2) backend: the port of
se3_transformer_tpu/so2/frames.py.

Every edge's offset factors as rhat = R(alpha, beta, 0) e_z (ZYZ Euler
angles), and the Wigner rotation of any degree factors through the
J-involution identity

    D_l(R(alpha, beta, 0)) = Dz_l(alpha) @ J_l @ Dz_l(beta) @ J_l^T

with Dz_l the z-rotation (a 2x2 block [[cos m t, sin m t], [-sin m t,
cos m t]] over each (-m, +m) index pair) and J_l = D_l(Rx(-pi/2)) a host
float64 constant per degree, from so3.wigner. Applying a rotation costs two
banded elementwise passes and two constant matmuls.

The angle harmonics come from the Cartesian components without trig:
cos(beta) = z, sin(beta) = rho = sqrt(x^2 + y^2), cos(alpha) = x / rho,
sin(alpha) = y / rho, and cos/sin(m t) by the angle-addition recursion. An
edge on the z axis (rho <= eps) takes alpha = 0; a zero-length edge takes
the identity rotation. sin(beta) is the clamped rho, so that the gradient
stays finite at the pole and at zero-length edges.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from ..so3.wigner import wigner_d_from_rotation
from ..utils.helpers import device_constant

Frames = Dict[str, torch.Tensor]

# the frame payload's keys, in the packed order of kernels.flash.pack_frames
FRAME_KEYS = ('cos_a', 'sin_a', 'cos_b', 'sin_b')

_EPS = 1e-8


@lru_cache(maxsize=None)
def j_matrix(l: int) -> np.ndarray:
    """J_l = D_l(Rx(-pi/2)), a float64 host constant."""
    rx = np.array([[1., 0., 0.],
                   [0., 0., 1.],
                   [0., -1., 0.]])  # Rx(-pi/2): y -> -z, z -> y
    return wigner_d_from_rotation(l, rx)


@device_constant
def _j_tensor(l: int, dtype: torch.dtype, device: torch.device
              ) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(j_matrix(l), dtype=dtype, device=device)


def harmonics(c1: torch.Tensor, s1: torch.Tensor, l_max: int):
    """cos/sin(m t) for m = 0..l_max by angle-addition recursion, stacked on
    a new last axis."""
    cs, sn = [torch.ones_like(c1)], [torch.zeros_like(s1)]
    for _ in range(l_max):
        cs.append(cs[-1] * c1 - sn[-1] * s1)
        sn.append(sn[-1] * c1 + cs[-2] * s1)
    return torch.stack(cs, dim=-1), torch.stack(sn, dim=-1)


def edge_frames(rel_pos: torch.Tensor, max_degree: int,
                differentiable: bool = False) -> Frames:
    """rel_pos [..., 3] (any length) -> {'cos_a', 'sin_a', 'cos_b',
    'sin_b': [..., max_degree + 1]}, entry m holding cos/sin(m angle);
    detached unless `differentiable`."""
    sq = (rel_pos * rel_pos).sum(dim=-1)
    norm = torch.sqrt(torch.clamp(sq, min=_EPS * _EPS))
    rhat = rel_pos / norm[..., None]
    x, y, z = rhat[..., 0], rhat[..., 1], rhat[..., 2]
    rho_sq = x * x + y * y
    rho = torch.sqrt(torch.clamp(rho_sq, min=_EPS * _EPS))
    on_axis = rho_sq <= _EPS * _EPS
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    cos_a = torch.where(on_axis, one, x / rho)
    sin_a = torch.where(on_axis, zero, y / rho)
    degenerate = norm <= _EPS
    cos_b = torch.where(degenerate, one, z)
    sin_b = torch.where(degenerate, zero, rho)
    out = dict(zip(('cos_a', 'sin_a'), harmonics(cos_a, sin_a, max_degree)))
    out.update(zip(('cos_b', 'sin_b'), harmonics(cos_b, sin_b, max_degree)))
    if not differentiable:
        out = {k: v.detach() for k, v in out.items()}
    return out


@device_constant
def _dz_tables(l: int, dtype: torch.dtype, device: torch.device):
    """|m_q| for q = 0..2l and the block signs s_q = sign(-m_q), made once
    per device."""
    m = np.arange(-l, l + 1)
    with torch.inference_mode(False):
        return (torch.as_tensor(np.abs(m), device=device),
                torch.as_tensor(np.sign(-m), dtype=dtype, device=device))


def _dz_apply(x: torch.Tensor, cos_m: torch.Tensor, sin_m: torch.Tensor,
              l: int, sign: float) -> torch.Tensor:
    """Dz_l(sign * t) over the last axis of x [..., 2l+1] (any leading
    shape broadcastable from the frames' edge shape):
    y[q] = cos(|m_q| t) x[q] + sign s_q sin(|m_q| t) x[2l - q]."""
    if l == 0:
        return x
    idx, s_q = _dz_tables(l, x.dtype, x.device)
    cv = cos_m.index_select(-1, idx)
    sv = sin_m.index_select(-1, idx) * (s_q * sign)
    while cv.ndim < x.ndim:
        cv, sv = cv[..., None, :], sv[..., None, :]
    return cv * x + sv * x.flip(-1)


def _apply_j(x: torch.Tensor, l: int, transpose: bool = False
             ) -> torch.Tensor:
    """J_l x (J_l^T x with `transpose`) over the last axis."""
    J = _j_tensor(l, x.dtype, x.device)
    return torch.matmul(x, J if transpose else J.t())


def rotate_in(x: torch.Tensor, frames: Frames, l: int) -> torch.Tensor:
    """Features into the edge frame, D_l(R_e)^T x over the last axis:
    Dz(-alpha), J^T, Dz(-beta), J."""
    if l == 0:
        return x
    t = _dz_apply(x, frames['cos_a'], frames['sin_a'], l, -1.0)
    t = _apply_j(t, l, transpose=True)
    t = _dz_apply(t, frames['cos_b'], frames['sin_b'], l, -1.0)
    return _apply_j(t, l)


def rotate_out(y: torch.Tensor, frames: Frames, l: int) -> torch.Tensor:
    """Edge-frame outputs back to the lab frame, D_l(R_e) y over the last
    axis: J^T, Dz(+beta), J, Dz(+alpha) (rotate_in's inverse)."""
    if l == 0:
        return y
    t = _apply_j(y, l, transpose=True)
    t = _dz_apply(t, frames['cos_b'], frames['sin_b'], l, 1.0)
    t = _apply_j(t, l)
    return _dz_apply(t, frames['cos_a'], frames['sin_a'], l, 1.0)


def wigner_from_frames(frames: Frames, l: int) -> torch.Tensor:
    """Dense per-edge Wigner matrices D_l(R_e) [..., 2l+1, 2l+1]: the
    reference for the factored application (the model never makes them)."""
    P = 2 * l + 1
    shape = frames['cos_a'].shape[:-1]
    eye = torch.eye(P, dtype=frames['cos_a'].dtype,
                    device=frames['cos_a'].device).expand(*shape, P, P)
    return rotate_out(eye.transpose(-1, -2), frames, l).transpose(-1, -2)
