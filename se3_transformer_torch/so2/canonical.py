"""Canonical-axis kernel blocks of the SO(2) backend: the port of
se3_transformer_tpu/so2/canonical.py.

For a degree pair (d_in, d_out) and frequency J the dense path's angular
kernel is K_J(rhat) = reshape(Q_J @ Y_J(rhat)). At rhat = e_z the real
spherical harmonics keep only m = 0, and the kernel Kc_J = K_J(e_z) is
banded: nonzero only where |m_out| == |m_in|, a 2x2 block [[a, b], [-b, a]]
over each (-m, +m) index pair and a scalar a at m = 0. A pair's whole
[F, P, Q] kernel family is two [F, min(d_in, d_out) + 1] tables (a, b).

Resolution order: the in-memory lru, the package's seed
(_canonical_seed.npz, every pair of degree <= 6; a byte-identical copy of
the JAX package's), the user cache under basis.cache_dir(), then the Q_J
construction of this package's basis.basis_transformation_Q_J (persisted
to the cache).

The seed is what the JAX so2 backend reads, and it is not what the Q_J
construction gives everywhere: for the pairs (1, 3), (2, 3), (3, 2) and
(3, 3) one frequency row of the seed has its sign flipped (every pair of
degree <= 2 agrees to ~1e-16). A sign-flipped intertwiner is still an
intertwiner, so the so2 model stays equivariant; it computes another
function than the dense model at degree 3, in JAX and here alike. The port
holds its so2 backend to JAX's, so the seed comes first.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Tuple

import numpy as np

from ..basis import basis_transformation_Q_J, cache_dir

SEED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         '_canonical_seed.npz')
_CACHE_VERSION = 1


def _cache_file() -> str:
    return os.path.join(cache_dir(), f'so2_canonical_v{_CACHE_VERSION}.npz')


def _load_npz_pair(path: str, d_in: int, d_out: int):
    """The pair's (a, b) from an npz file, None when the file is missing,
    unreadable or lacks the pair."""
    try:
        with np.load(path) as data:
            ka, kb = f'{d_in}_{d_out}_a', f'{d_in}_{d_out}_b'
            if ka in data and kb in data:
                return np.array(data[ka]), np.array(data[kb])
    except (OSError, ValueError, KeyError):
        return None
    return None


def _store_cached(d_in: int, d_out: int, a: np.ndarray, b: np.ndarray):
    """Best-effort persist of one pair: read-modify-write under a file lock,
    then an atomic rename."""
    directory = cache_dir()
    if not directory:
        return
    try:
        os.makedirs(directory, exist_ok=True)
        path = _cache_file()
        with open(os.path.join(directory, 'so2.lock'), 'w') as lock_fh:
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
            existing[f'{d_in}_{d_out}_a'] = a
            existing[f'{d_in}_{d_out}_b'] = b
            tmp = path + f'.{os.getpid()}.tmp.npz'
            np.savez(tmp, **existing)
            os.replace(tmp, path)
    except OSError:
        pass


def _compute_from_qj(d_in: int, d_out: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The construction from first principles: each Q_J contracted with the
    1-sparse Y_J(e_z), the band coefficients read off the [P, Q] kernel,
    and the band structure asserted."""
    from ..so3.spherical_harmonics import real_spherical_harmonics

    P, Q = 2 * d_out + 1, 2 * d_in + 1
    mmin = min(d_in, d_out)
    ez = np.array([0., 0., 1.])
    a = np.zeros((2 * mmin + 1, mmin + 1))
    b = np.zeros((2 * mmin + 1, mmin + 1))
    for f, J in enumerate(range(abs(d_in - d_out), d_in + d_out + 1)):
        Kc = (basis_transformation_Q_J(J, d_in, d_out)
              @ real_spherical_harmonics(J, ez)).reshape(P, Q)
        for m in range(mmin + 1):
            a[f, m] = Kc[d_out - m, d_in - m]
            if m > 0:
                b[f, m] = Kc[d_out - m, d_in + m]
        residual = np.abs(_reconstruct(a[f], b[f], d_in, d_out) - Kc).max()
        if residual >= 1e-10:
            raise AssertionError(
                f'canonical kernel for (d_in={d_in}, d_out={d_out}, J={J}) '
                f'is not m-banded (off-band residual {residual:.2e}): the '
                f'SH/Wigner conventions no longer match the SO(2) reduction')
    return a, b


def _reconstruct(a_f: np.ndarray, b_f: np.ndarray, d_in: int,
                 d_out: int) -> np.ndarray:
    """One frequency's dense [P, Q] canonical kernel from its band."""
    K = np.zeros((2 * d_out + 1, 2 * d_in + 1))
    for m in range(min(d_in, d_out) + 1):
        K[d_out - m, d_in - m] = a_f[m]
        K[d_out + m, d_in + m] = a_f[m]
        if m > 0:
            K[d_out - m, d_in + m] = b_f[m]
            K[d_out + m, d_in - m] = -b_f[m]
    return K


@lru_cache(maxsize=None)
def canonical_blocks(d_in: int, d_out: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(a, b), each float64 [F, min(d_in, d_out) + 1] with F = 2 min(d_in,
    d_out) + 1 frequencies (J = |d_in - d_out| .. d_in + d_out, the dense
    basis's frequency order) and b[:, 0] == 0."""
    for path in (SEED_PATH, _cache_file()):
        got = _load_npz_pair(path, d_in, d_out) if os.path.exists(path) \
            else None
        if got is not None:
            return got
    a, b = _compute_from_qj(d_in, d_out)
    _store_cached(d_in, d_out, a, b)
    return a, b


def canonical_kernel(d_in: int, d_out: int) -> np.ndarray:
    """The dense [F, P, Q] canonical-axis kernels of the pair."""
    a, b = canonical_blocks(d_in, d_out)
    return np.stack([_reconstruct(a[f], b[f], d_in, d_out)
                     for f in range(a.shape[0])])
