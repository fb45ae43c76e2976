"""The port's geometry against the JAX package: spherical harmonics, the
Q_J intertwiners, get_basis in both layouts, and kNN neighbor selection.
Inputs are made from a seed with numpy and fed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu import basis as jax_basis
from se3_transformer_tpu.ops import neighbors as jax_nb
from se3_transformer_tpu.so3 import spherical_harmonics as jax_sh
from se3_transformer_torch import basis as t_basis
from se3_transformer_torch.ops import neighbors as t_nb
from se3_transformer_torch.so3 import spherical_harmonics as t_sh

# one intra-op thread: these models are tiny, and pytest-xdist's workers
# would otherwise oversubscribe the CPU with spinning thread pools
torch.set_num_threads(1)

# float32 evaluations of the same polynomials / contractions in different
# summation orders: a few float32 ulps of the O(1) values
F32_TOL = 2e-6


def test_spherical_harmonics_match_jax():
    rng = np.random.RandomState(0)
    v = rng.normal(size=(50, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    ref = jax_sh.real_spherical_harmonics_all(6, v, xp=np)    # float64
    ours = t_sh.real_spherical_harmonics_all(6, v)            # numpy path
    ours_t = t_sh.real_spherical_harmonics_all(
        6, torch.from_numpy(v.astype(np.float32)))            # torch path
    for l in range(7):
        assert np.array_equal(ours[l], ref[l])
        assert np.abs(ours_t[l].numpy() - ref[l]).max() < F32_TOL


def test_q_j_bit_identical_to_jax():
    for d_in in range(4):
        for d_out in range(4):
            for J in range(abs(d_in - d_out), d_in + d_out + 1):
                ours = t_basis.basis_transformation_Q_J(J, d_in, d_out)
                ref = jax_basis.basis_transformation_Q_J(J, d_in, d_out)
                assert ours.dtype == np.float64
                assert np.array_equal(ours, ref), (J, d_in, d_out)


def test_q_j_cache_roundtrip(tmp_path, monkeypatch):
    """The file cache lives in the port's own directory and returns the
    stored constants unchanged."""
    monkeypatch.setenv('SE3_TORCH_CACHE_PATH', str(tmp_path))
    t_basis.basis_transformation_Q_J.cache_clear()
    try:
        first = t_basis.basis_transformation_Q_J(2, 1, 2)
        assert (tmp_path / 'qj_v1.npz').exists()
        t_basis.basis_transformation_Q_J.cache_clear()
        assert np.array_equal(t_basis._load_cached_qj(2, 1, 2), first)
    finally:
        t_basis.basis_transformation_Q_J.cache_clear()


@pytest.mark.parametrize('layout', ['pqf', 'pfq_flat'])
def test_get_basis_matches_jax(layout):
    rng = np.random.RandomState(1)
    rel = rng.normal(size=(2, 6, 5, 3)).astype(np.float32) * 3
    ref = jax_basis.get_basis(jnp.asarray(rel), 3, layout=layout)
    ours = t_basis.get_basis(torch.from_numpy(rel), 3, layout=layout)
    assert set(ours) == set(ref) and len(ours) == 16
    for key in ref:
        r = np.asarray(ref[key])
        assert ours[key].shape == r.shape, key
        assert np.abs(ours[key].numpy() - r).max() < F32_TOL, key


def _jax_select(coors, mask, k, radius):
    b, n = coors.shape[:2]
    excl = jax_nb.exclude_self_indices(n)
    c = jnp.asarray(coors)
    rel = jax_nb.remove_self(c[:, :, None] - c[:, None], excl)
    idx = jnp.broadcast_to(excl[None], (b, n, n - 1))
    m = jnp.asarray(mask)
    pm = jax_nb.remove_self(m[:, :, None] & m[:, None, :], excl)
    hood, nearest = jax_nb.select_neighbors(rel, idx, k, radius, pair_mask=pm)
    return [np.asarray(t) for t in (hood.indices, hood.mask, hood.rel_dist,
                                    hood.rel_pos, nearest)]


def _torch_select(coors, mask, k, radius):
    b, n = coors.shape[:2]
    excl = t_nb.exclude_self_indices(n)
    c = torch.from_numpy(coors)
    rel = t_nb.remove_self(c[:, :, None] - c[:, None], excl)
    idx = excl[None].expand(b, n, n - 1)
    m = torch.from_numpy(mask)
    pm = t_nb.remove_self(m[:, :, None] & m[:, None, :], excl)
    hood, nearest = t_nb.select_neighbors(rel, idx, k, radius, pair_mask=pm)
    return [t.numpy() for t in (hood.indices, hood.mask, hood.rel_dist,
                                hood.rel_pos, nearest)]


@pytest.mark.parametrize('n,k,grid', [(12, 5, False), (12, 5, True),
                                      (200, 8, True)])
def test_select_neighbors_exact(n, k, grid):
    """Indices and masks identical to the JAX selection, including exact
    distance ties (integer grid coordinates), which must break toward the
    lower source index, and rows longer than the JAX blockwise top-k's
    128-wide block (n=200)."""
    rng = np.random.RandomState(n + k)
    if grid:
        coors = rng.randint(-2, 3, size=(2, n, 3)).astype(np.float32)
    else:
        coors = rng.normal(size=(2, n, 3)).astype(np.float32)
    mask = rng.rand(2, n) > 0.2
    radius = 2.5 if grid else 1e5
    ref = _jax_select(coors, mask, k, radius)
    ours = _torch_select(coors, mask, k, radius)
    for name, r, o in zip(('indices', 'mask', 'rel_dist', 'rel_pos',
                           'nearest'), ref, ours):
        assert o.shape == r.shape, name
        if name in ('indices', 'mask', 'nearest'):
            assert np.array_equal(o, r), name
        else:
            assert np.abs(o - r).max() < F32_TOL, name
