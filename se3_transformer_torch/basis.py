"""Equivariant kernel basis construction (port of se3_transformer_tpu/basis.py).

  * Q_J intertwiners — cold path, computed once per (J, d_in, d_out) on the
    host in NumPy float64 (SVD null space of a stacked Sylvester system over
    fixed rotations), lru-cached in memory and persisted to a versioned
    .npz under the port's own cache directory. Same rotations, same SVD,
    same sign rule as the JAX package, so the constants are identical.

  * get_basis — the per-edge bases: real spherical harmonics of the unit
    offsets contracted with the Q_J constants, in float32 at full precision.
"""
from __future__ import annotations

import os
from functools import lru_cache
from itertools import product

import numpy as np
import torch

from .so3.spherical_harmonics import real_spherical_harmonics_all
from .so3.wigner import rot, wigner_d_from_rotation
from .utils.helpers import device_constant

# the fixed, well-conditioned rotations of the Sylvester system
# (se3_transformer_tpu/basis.py::_RANDOM_ANGLES, value for value)
_RANDOM_ANGLES = np.array([
    [4.41301023, 5.56684102, 4.59384642],
    [4.93325116, 6.12697327, 4.14574096],
    [0.53878964, 4.14301185, 2.62721626],
    [2.67997558, 4.66598984, 0.41322213],
    [0.14730622, 4.18146178, 0.78533526],
])

_CACHE_VERSION = 1


def cache_dir() -> str:
    """Where the Q_J constants persist: $SE3_TORCH_CACHE_PATH, else
    ~/.cache/se3_transformer_torch. An empty value disables the file
    cache."""
    return os.environ.get('SE3_TORCH_CACHE_PATH', os.path.expanduser(
        '~/.cache/se3_transformer_torch'))


def _sylvester_nullspace(mats) -> np.ndarray:
    """Orthonormal basis of the common null space of stacked matrices,
    float64 SVD."""
    A = np.concatenate(mats, axis=0)
    _, s, Vt = np.linalg.svd(A, full_matrices=False)
    return Vt[s < 1e-10]


@lru_cache(maxsize=None)
def basis_transformation_Q_J(J: int, d_in: int, d_out: int) -> np.ndarray:
    """The unique (up to sign) intertwiner Q_J with
        (D_out(R) ⊗ D_in(R)) Q_J = Q_J D_J(R)   for all R in SO(3),
    shape [(2*d_out+1)*(2*d_in+1), 2*J+1], float64. Row index =
    m_out * (2*d_in+1) + m_in."""
    cached = _load_cached_qj(J, d_in, d_out)
    if cached is not None:
        return cached

    dim = (2 * d_out + 1) * (2 * d_in + 1)
    mats = []
    for a, b, c in _RANDOM_ANGLES:
        R = rot(a, b, c)
        R_tensor = np.kron(wigner_d_from_rotation(d_out, R),
                           wigner_d_from_rotation(d_in, R))
        D_J = wigner_d_from_rotation(J, R)
        # A Q - Q B = 0  <=>  (A ⊗ I - I ⊗ B^T) vec_row(Q) = 0
        mats.append(np.kron(R_tensor, np.eye(2 * J + 1))
                    - np.kron(np.eye(dim), D_J.T))
    null = _sylvester_nullspace(mats)
    if null.shape[0] != 1:
        raise ValueError(
            f'expected a 1-dimensional intertwiner space for (J={J}, '
            f'd_in={d_in}, d_out={d_out}), got {null.shape[0]}')
    Q = null[0].reshape(dim, 2 * J + 1)
    # deterministic sign: largest-|.| element made positive
    flat = Q.ravel()
    Q = Q * np.sign(flat[np.argmax(np.abs(flat))])
    _store_cached_qj(J, d_in, d_out, Q)
    return Q


def _qj_cache_file() -> str:
    return os.path.join(cache_dir(), f'qj_v{_CACHE_VERSION}.npz')


def _load_cached_qj(J, d_in, d_out):
    path = _qj_cache_file()
    if not cache_dir() or not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            key = f'{J}_{d_in}_{d_out}'
            if key in data:
                return data[key]
    except (OSError, ValueError):  # corrupted/truncated cache: a miss
        return None
    return None


def _store_cached_qj(J, d_in, d_out, Q):
    directory = cache_dir()
    if not directory:
        return
    try:
        os.makedirs(directory, exist_ok=True)
        path = _qj_cache_file()
        # inter-process mutex around the read-modify-write: concurrent
        # writers would otherwise drop each other's entries
        with open(os.path.join(directory, 'qj.lock'), 'w') as lock_fh:
            try:
                import fcntl
                fcntl.flock(lock_fh, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass
            existing = {}
            if os.path.exists(path):
                try:
                    with np.load(path) as data:
                        existing = {k: data[k] for k in data.files}
                except (OSError, ValueError):
                    existing = {}
            existing[f'{J}_{d_in}_{d_out}'] = Q
            # np.savez appends '.npz' when the name lacks it
            tmp = path + f'.{os.getpid()}.tmp.npz'
            np.savez(tmp, **existing)
            os.replace(tmp, path)
    except OSError:
        pass  # best effort: a miss only costs a recompute


@device_constant
def _qj_tensor(J: int, d_in: int, d_out: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Q_J as a tensor on `device`, made once: a copy per forward would
    block the host until the device caught up. Made outside inference
    mode, so that a constant first built while serving can later be used
    under autograd."""
    with torch.inference_mode(False):
        return torch.as_tensor(basis_transformation_Q_J(J, d_in, d_out),
                               dtype=dtype, device=device)


def safe_normalize(vec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Unit vectors, with the norm clamped at eps at the origin."""
    sq = (vec * vec).sum(dim=-1, keepdim=True)
    return vec / torch.sqrt(torch.clamp(sq, min=eps ** 2))


def get_basis(rel_pos: torch.Tensor, max_degree: int,
              differentiable: bool = False, layout: str = 'pqf') -> dict:
    """Pairwise equivariant kernel bases for all degree pairs.

    rel_pos: [..., 3] relative offsets (need not be normalized). Unless
    `differentiable`, the bases carry no gradient to rel_pos (the JAX
    get_basis's stop_gradient on its output).
    layout='pqf': {f'{d_in},{d_out}': [..., 2*d_out+1, 2*d_in+1, n_freq]}.
    layout='pfq_flat': the same values flattened per edge to
    [..., P*F*Q] in (p, f, q) order — the operand layout of
    kernels.pairwise.fused_pairwise_conv_bxf.

    The Y·Q_J product is an explicit float32 multiply-and-sum, so no
    matmul precision setting (TF32) can reach it.
    """
    if layout not in ('pqf', 'pfq_flat'):
        raise ValueError(f'unknown basis layout {layout!r}')
    if not differentiable:
        rel_pos = rel_pos.detach()
    rhat = safe_normalize(rel_pos)
    Ys = real_spherical_harmonics_all(2 * max_degree, rhat)

    out = {}
    for d_in, d_out in product(range(max_degree + 1), repeat=2):
        Ks = []
        for J in range(abs(d_in - d_out), d_in + d_out + 1):
            Q = _qj_tensor(J, d_in, d_out, rel_pos.dtype, rel_pos.device)
            K_flat = (Ys[J][..., None, :] * Q).sum(-1)
            Ks.append(K_flat.reshape(*K_flat.shape[:-1],
                                     2 * d_out + 1, 2 * d_in + 1))
        if layout == 'pfq_flat':
            k = torch.stack(Ks, dim=-2)              # [..., P, F, Q]
            out[f'{d_in},{d_out}'] = k.reshape(*k.shape[:-3], -1)
        else:
            out[f'{d_in},{d_out}'] = torch.stack(Ks, dim=-1)
    return out
