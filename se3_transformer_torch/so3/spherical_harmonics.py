"""Real spherical harmonics, evaluated polynomially from Cartesian coordinates.

Port of se3_transformer_tpu/so3/spherical_harmonics.py. The tesseral
harmonics are polynomials in the unit-vector components (x, y, z):

    Y_{l, m>0} = sqrt(2) K_{lm} Ptil_l^m(z) A_m(x, y)
    Y_{l, 0}   =         K_{l0} Ptil_l^0(z)
    Y_{l, m<0} = sqrt(2) K_{l|m|} Ptil_l^{|m|}(z) B_{|m|}(x, y)

where A_m + i B_m = (x + i y)^m and Ptil_l^m(z) = P_l^m(cos t)/sin^m t is
the Condon-Shortley-free associated Legendre polynomial divided by sin^m,
itself a polynomial in z. No trigonometry, no pole singularities.

The same code evaluates torch tensors (the model's basis) and NumPy arrays
(the float64 host computations of so3.wigner), so both share one
convention. Y_1 is ordered (y, z, x) up to a positive constant.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _norm_const(l: int, m: int) -> float:
    """Orthonormalization constant K_{lm} (m >= 0), including sqrt(2) for m>0."""
    k = math.sqrt((2 * l + 1) / (4 * math.pi)
                  * math.factorial(l - m) / math.factorial(l + m))
    if m > 0:
        k *= math.sqrt(2.0)
    return k


@lru_cache(maxsize=None)
def _double_factorial(n: int) -> int:
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return out


def real_spherical_harmonics_all(l_max: int, xyz) -> list:
    """All real SH for l = 0..l_max at unit vectors xyz[..., 3] (a torch
    tensor or a NumPy array). Returns a list whose entry l has shape
    [..., 2l+1], m = -l..l, of the input's type."""
    xp = torch if isinstance(xyz, torch.Tensor) else np
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    # A_m + i B_m = (x + i y)^m by recursion
    A = [xp.ones_like(x)]
    B = [xp.zeros_like(x)]
    for m in range(1, l_max + 1):
        A.append(x * A[m - 1] - y * B[m - 1])
        B.append(x * B[m - 1] + y * A[m - 1])

    # Ptil_l^m(z): CS-phase-free associated Legendre / sin^m, polynomial in z
    P = {}
    for m in range(0, l_max + 1):
        pmm = float(_double_factorial(2 * m - 1))
        P[(m, m)] = pmm * xp.ones_like(z)
        if m + 1 <= l_max:
            P[(m + 1, m)] = (2 * m + 1) * pmm * z
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    out = []
    for l in range(l_max + 1):
        cols = []
        for m in range(l, 0, -1):  # m = -l..-1 stored via B terms
            cols.append(_norm_const(l, m) * P[(l, m)] * B[m])
        cols.append(_norm_const(l, 0) * P[(l, 0)])
        for m in range(1, l + 1):
            cols.append(_norm_const(l, m) * P[(l, m)] * A[m])
        out.append(xp.stack(cols, -1))
    return out


def real_spherical_harmonics(l: int, xyz):
    """Real SH of a single degree l at unit vectors xyz[..., 3] -> [..., 2l+1]."""
    return real_spherical_harmonics_all(l, xyz)[l]


def angles_to_xyz(theta, phi):
    """Unit vectors [..., 3] from polar angles theta (from +z) and azimuths
    phi (NumPy arrays, host float64; the S2 grids of v2.s2act)."""
    theta, phi = np.asarray(theta), np.asarray(phi)
    return np.stack([np.sin(theta) * np.cos(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(theta)], axis=-1)
