"""Rotation utilities and real Wigner-D matrices (host-side, float64).

The port's own copy of se3_transformer_tpu/so3/wigner.py (the port imports
nothing of the JAX package). The real Wigner-D matrices are *derived* from
the spherical-harmonic implementation: sample well-spread unit vectors p_i,
evaluate Y(p_i) and Y(R p_i), solve the (overdetermined) linear system
D Y(p) = Y(R p) in float64 and project the solution onto the orthogonal
group (SVD polar projection). The SH code is thus the single source of
truth for conventions — the representation property holds by construction.

Everything here is cold-path host code (NumPy float64): it only runs when
building the Q_J intertwiner constants and in tests.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .spherical_harmonics import real_spherical_harmonics


def rot_z(gamma) -> np.ndarray:
    """3x3 rotation about the z axis (reference irr_repr.py:54-62)."""
    c, s = np.cos(gamma), np.sin(gamma)
    return np.array([[c, -s, 0.], [s, c, 0.], [0., 0., 1.]])


def rot_y(beta) -> np.ndarray:
    """3x3 rotation about the y axis (reference irr_repr.py:64-72)."""
    c, s = np.cos(beta), np.sin(beta)
    return np.array([[c, 0., s], [0., 1., 0.], [-s, 0., c]])


def rot(alpha, beta, gamma) -> np.ndarray:
    """ZYZ Euler-angle rotation R = Rz(alpha) Ry(beta) Rz(gamma)
    (reference irr_repr.py:86-90)."""
    return rot_z(alpha) @ rot_y(beta) @ rot_z(gamma)


def rot_to_euler(R: np.ndarray):
    """Extract ZYZ Euler angles (alpha, beta, gamma) from a rotation matrix."""
    beta = np.arccos(np.clip(R[2, 2], -1.0, 1.0))
    if abs(R[2, 2]) > 1 - 1e-12:  # gimbal: R is a pure z-rotation
        alpha = np.arctan2(R[1, 0], R[0, 0])
        if R[2, 2] < 0:
            alpha = -alpha
        return alpha, beta, 0.0
    alpha = np.arctan2(R[1, 2], R[0, 2])
    gamma = np.arctan2(R[2, 1], -R[2, 0])
    return alpha, beta, gamma


def compose(a, b, c, d, e, f):
    """Compose two ZYZ angle triples: R(out) = R(a,b,c) @ R(d,e,f)
    (reference irr_repr.py:92-101)."""
    return rot_to_euler(rot(a, b, c) @ rot(d, e, f))


def x_to_alpha_beta(x):
    """Unit vector -> (alpha, beta) with x = R(alpha, beta, 0) e_z
    (reference irr_repr.py:76-84)."""
    x = np.asarray(x, dtype=np.float64)
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    beta = np.arccos(np.clip(x[..., 2], -1.0, 1.0))
    alpha = np.arctan2(x[..., 1], x[..., 0])
    return alpha, beta


@lru_cache(maxsize=None)
def _sample_points(l: int) -> np.ndarray:
    """Deterministic well-spread unit vectors, enough to overdetermine D_l."""
    n = max(8 * (2 * l + 1), 32)
    rng = np.random.RandomState(12345 + l)
    pts = rng.normal(size=(n, 3))
    return pts / np.linalg.norm(pts, axis=-1, keepdims=True)


def wigner_d_from_rotation(l: int, R: np.ndarray) -> np.ndarray:
    """Real Wigner-D matrix D_l(R) with D_l Y_l(p) = Y_l(R p), float64.

    Solved by least squares over sampled points and polished to an exactly
    orthogonal matrix via SVD polar projection (D is orthogonal because the
    real SH basis is orthonormal).
    """
    if l == 0:
        return np.ones((1, 1))
    R = np.asarray(R, dtype=np.float64)
    pts = _sample_points(l)
    Y = real_spherical_harmonics(l, pts)                   # [n, 2l+1]
    Yr = real_spherical_harmonics(l, pts @ R.T)            # [n, 2l+1]
    # Yr = Y @ D^T  =>  D^T = lstsq(Y, Yr)
    Dt, *_ = np.linalg.lstsq(Y, Yr, rcond=None)
    U, _, Vt = np.linalg.svd(Dt.T)
    return U @ Vt


def irr_repr(order: int, alpha, beta, gamma) -> np.ndarray:
    """Irreducible representation of SO(3) in the real SH basis
    (reference irr_repr.py:44-52)."""
    return wigner_d_from_rotation(order, rot(alpha, beta, gamma))
