"""The SO(2) contraction backend (conv_backend='so2') of the port against
the JAX package on the CPU: the canonical blocks (the seed and its copy,
and the seed's four sign-flipped degree-3 rows against the port's own Q_J
construction), the edge frames and rotations with their pole and
zero-length edges, banded_z, so2_pair_contract, ConvSE3 grouped and per
pair (output and gradients), the backend rules, the kNN model's output,
loss and every gradient on converted weights (with coordinate gradients
through a pole and a coincident pair), and rotation equivariance.
Inputs come from a numpy seed. The streaming and global paths are in
tests/test_torch_so2_flash.py."""
import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.ops.conv import ConvSE3 as JaxConv
from se3_transformer_tpu.ops.conv import \
    resolve_conv_backend as jax_resolve_conv_backend
from se3_transformer_tpu.ops.fiber import Fiber as JaxFiber
from se3_transformer_tpu.so2 import canonical as jcan
from se3_transformer_tpu.so2 import contract as jcon
from se3_transformer_tpu.so2 import frames as jfr
from se3_transformer_torch import SE3TransformerModule, convert_flax_params
from se3_transformer_torch.ops.conv import (
    ConvSE3, get_conv_backend, resolve_conv_backend,
)
from se3_transformer_torch.ops.fiber import Fiber
from se3_transformer_torch.so2 import canonical as pcan
from se3_transformer_torch.so2 import contract as pcon
from se3_transformer_torch.so2 import frames as pfr
from se3_transformer_torch.so3 import rot
from se3_transformer_torch.so3.spherical_harmonics import \
    real_spherical_harmonics
from se3_transformer_torch.so3.wigner import wigner_d_from_rotation

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

# float32 paths: the same products in other orders, relative to the
# largest magnitude of each output or gradient leaf
RTOL = 1e-5
# the equivariance bound of tests/test_equivariance.py
EQUIVARIANCE_ATOL = 1e-4
# where so2 and dense differ (degree 3): one sign-flipped frequency row of
# a block changes the output at this scale or more
DIFFERS_RTOL = 1e-3


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _offsets(n, seed=0):
    """n random offsets, then the awkward ones: +z and -z poles, a
    near-pole offset and a zero-length one."""
    rng = np.random.RandomState(seed)
    rel = rng.normal(size=(n, 3)) * 2.0
    rel = np.concatenate([rel, [[0., 0., 1.7], [0., 0., -0.4],
                                [1e-9, 0., 2.], [0., 0., 0.]]])
    return rel.astype(np.float32)


# ---------------------------------------------------------------------- #
# the canonical blocks
# ---------------------------------------------------------------------- #
def test_seed_is_a_byte_identical_copy():
    assert pcan.SEED_PATH != jcan._SEED_PATH
    assert filecmp.cmp(pcan.SEED_PATH, jcan._SEED_PATH, shallow=False)


@pytest.mark.parametrize('d_in', range(7))
def test_canonical_blocks_match_jax(d_in):
    """Every pair of degree <= 6 (the seed's whole range) the same bits as
    JAX's, and canonical_kernel's dense form likewise."""
    for d_out in range(7):
        got, want = pcan.canonical_blocks(d_in, d_out), \
            jcan.canonical_blocks(d_in, d_out)
        F, M = 2 * min(d_in, d_out) + 1, min(d_in, d_out) + 1
        for g, w in zip(got, want):
            assert g.shape == (F, M) and np.array_equal(g, w)
        assert np.array_equal(pcan.canonical_kernel(d_in, d_out),
                              jcan.canonical_kernel(d_in, d_out))


# the seed's rows that the Q_J construction gives with the other sign
SIGN_FLIPPED = {(1, 3): 1, (2, 3): 1, (3, 2): 4, (3, 3): 5}


@pytest.mark.parametrize('d_in', range(4))
def test_seed_differs_from_qj_by_one_sign_flipped_row(d_in):
    """The finding the port keeps: the seed (what the JAX so2 backend
    reads) equals the port's Q_J construction for every pair of degree
    <= 2 and for (0, 3), (3, 0), (3, 1); for (1, 3), (2, 3), (3, 2) and
    (3, 3) exactly one frequency row has its sign flipped. The port's
    blocks are the seed's."""
    for d_out in range(4):
        a, b = pcan.canonical_blocks(d_in, d_out)
        qa, qb = pcan._compute_from_qj(d_in, d_out)
        same = [np.abs(a[f] - qa[f]).max() + np.abs(b[f] - qb[f]).max()
                <= 1e-10 for f in range(a.shape[0])]
        flipped = [np.abs(a[f] + qa[f]).max() + np.abs(b[f] + qb[f]).max()
                   <= 1e-10 for f in range(a.shape[0])]
        row = SIGN_FLIPPED.get((d_in, d_out))
        if row is None:
            assert all(same), (d_in, d_out)
        else:
            assert [f for f, s in enumerate(same) if not s] == [row]
            assert flipped[row]
            assert max(np.abs(a[row]).max(), np.abs(b[row]).max()) > 0.1


def _conv_pair(max_degree, backend, seed=3):
    """A grouped ConvSE3 of degrees 0..max_degree (4 channels) with seeded
    parameters, its inputs and frames/basis."""
    fiber = Fiber.create(max_degree + 1, 4)
    conv = ConvSE3(fiber, fiber, shared_radial_hidden=True, backend=backend,
                   self_interaction=False, pool=False)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / p.shape[0] ** 0.5)
    return conv


def test_so2_equals_dense_to_degree_2_and_not_at_3():
    """One grouped conv, the same parameters, dense and so2: equal at max
    degree 2 (the seed agrees with Q_J there); apart at degree 3 (the
    sign-flipped rows), as in JAX."""
    from se3_transformer_torch.basis import get_basis
    rng = np.random.RandomState(1)
    n, k = 7, 4
    rel = torch.from_numpy(rng.normal(size=(1, n, k, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, n, (1, n, k)))
    errs = []
    for degree in (2, 3):
        feats = {str(d): torch.from_numpy(
            rng.normal(size=(1, n, 4, 2 * d + 1)).astype(np.float32))
            for d in range(degree + 1)}
        basis = get_basis(rel, degree)
        basis['so2'] = pfr.edge_frames(rel, degree)
        dense, so2 = (_conv_pair(degree, b) for b in ('dense', 'so2'))
        args = (feats, (idx, None, None), rel.norm(dim=-1), basis)
        with torch.no_grad():
            out_d, out_s = dense(*args), so2(*args)
        errs.append(max(_rel_err(out_s[d], out_d[d]) for d in out_d))
    assert errs[0] <= RTOL and errs[1] >= DIFFERS_RTOL


# ---------------------------------------------------------------------- #
# frames and rotations
# ---------------------------------------------------------------------- #
def test_edge_frames_match_jax():
    """The harmonics of random, pole, near-pole and zero-length offsets;
    the zero-length one takes the identity frame, the poles alpha = 0;
    detached unless differentiable."""
    rel = _offsets(20)
    got = pfr.edge_frames(torch.from_numpy(rel), 4)
    want = jfr.edge_frames(jnp.asarray(rel), 4)
    for key in pfr.FRAME_KEYS:
        assert got[key].shape == (24, 5)
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() <= 1e-6
    ident = {k: got[k][-1].numpy() for k in pfr.FRAME_KEYS}
    assert np.all(ident['cos_a'] == 1) and np.all(ident['sin_a'] == 0)
    assert np.all(ident['cos_b'] == 1) and np.all(ident['sin_b'] == 0)
    assert np.all(got['cos_a'][-4:-2].numpy() == 1)
    t = torch.from_numpy(rel).requires_grad_()
    assert not pfr.edge_frames(t, 2)['cos_b'].requires_grad
    assert pfr.edge_frames(t, 2, differentiable=True)['cos_b'].requires_grad


def test_frames_gradient_is_finite_at_poles_and_zero_length():
    """The clamped rho keeps the offsets' gradient finite where the bare
    sqrt's derivative is infinite, as jax.grad of the JAX frames."""
    rel = _offsets(3, seed=2)
    w = np.random.RandomState(3).normal(size=(4, 7, 4)).astype(np.float32)

    def loss_jax(r):
        fr = jfr.edge_frames(r, 3, differentiable=True)
        return sum((fr[k] * w[i]).sum() for i, k in enumerate(pfr.FRAME_KEYS))
    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(rel)))
    t = torch.from_numpy(rel).requires_grad_()
    fr = pfr.edge_frames(t, 3, differentiable=True)
    sum((fr[k] * torch.from_numpy(w[i])).sum()
        for i, k in enumerate(pfr.FRAME_KEYS)).backward()
    assert np.isfinite(t.grad.numpy()).all()
    assert _rel_err(t.grad.numpy(), want) <= RTOL


@pytest.mark.parametrize('l', range(4))
def test_rotations_match_jax_and_host_wigner(l):
    """rotate_in and rotate_out against JAX's on random features, their
    round trip, wigner_from_frames against JAX's and against the host
    Wigner matrix of R(alpha, beta, 0), and the orientation a transposed
    J would break: D_l(R_e) Y_l(e_z) = Y_l(rhat)."""
    rel = _offsets(12, seed=4)[:-1]                     # no zero length
    fr = pfr.edge_frames(torch.from_numpy(rel), 3)
    jfr_ = jfr.edge_frames(jnp.asarray(rel), 3)
    x = np.random.RandomState(l).normal(size=(15, 2, 2 * l + 1)) \
        .astype(np.float32)
    xin = pfr.rotate_in(torch.from_numpy(x), fr, l)
    assert _rel_err(xin, jfr.rotate_in(jnp.asarray(x), jfr_, l)) <= RTOL
    xout = pfr.rotate_out(torch.from_numpy(x), fr, l)
    assert _rel_err(xout, jfr.rotate_out(jnp.asarray(x), jfr_, l)) <= RTOL
    assert _rel_err(pfr.rotate_out(xin, fr, l), x) <= RTOL
    D = pfr.wigner_from_frames(fr, l).numpy()
    assert _rel_err(D, jfr.wigner_from_frames(jfr_, l)) <= RTOL
    rhat = rel / np.linalg.norm(rel, axis=-1, keepdims=True)
    for e in range(len(rel)):
        x_, y_, z_ = rhat[e].astype(np.float64)
        beta = np.arccos(np.clip(z_, -1, 1))
        alpha = np.arctan2(y_, x_) if x_ * x_ + y_ * y_ > 1e-16 else 0.
        R = rot(alpha, beta, 0.)
        assert np.abs(D[e] - wigner_d_from_rotation(l, R)).max() <= 1e-5
        y_axis = real_spherical_harmonics(l, np.array([0., 0., 1.]))
        y_edge = real_spherical_harmonics(l, rhat[e].astype(np.float64))
        assert np.abs(D[e] @ y_axis - y_edge).max() <= 1e-5


# ---------------------------------------------------------------------- #
# banded_z and so2_pair_contract
# ---------------------------------------------------------------------- #
PAIRS = [(d_in, d_out) for d_in in range(4) for d_out in range(4)]


@pytest.mark.parametrize('pad_rows', [True, False])
def test_banded_z_matches_jax(pad_rows):
    rng = np.random.RandomState(5)
    for d_in, d_out in PAIRS:
        xr = rng.normal(size=(3, 5, 2 * d_in + 1)).astype(np.float32)
        got = pcon.banded_z(torch.from_numpy(xr), d_in, d_out, pad_rows)
        want = jcon.banded_z(jnp.asarray(xr), d_in, d_out, pad_rows)
        rows = 2 * d_out + 1 if pad_rows else 2 * min(d_in, d_out) + 1
        assert got.shape == (3, rows, 5 * (2 * min(d_in, d_out) + 1))
        assert _rel_err(got, want) <= RTOL


@pytest.mark.parametrize('edge_chunks', [None, 2])
def test_so2_pair_contract_matches_jax(edge_chunks):
    """Every pair of degree <= 3 (every third pair in two node chunks)
    over [b, n, k] = [1, 5, 3] edges, the rotations inside (even pairs)
    or the caller's (odd pairs)."""
    rng = np.random.RandomState(6)
    mid, C, O = 8, 3, 4
    rel = rng.normal(size=(1, 5, 3, 3)).astype(np.float32)
    rel[0, 0, 0] = [0., 0., 2.]
    fr = pfr.edge_frames(torch.from_numpy(rel), 3)
    jfr_ = jfr.edge_frames(jnp.asarray(rel), 3)
    h = rng.normal(size=(1, 5, 3, mid)).astype(np.float32)
    for i, (d_in, d_out) in enumerate(PAIRS):
        if edge_chunks and i % 3:
            continue
        F = 2 * min(d_in, d_out) + 1
        w3 = (rng.normal(size=(mid, C * F, O)) / mid ** 0.5) \
            .astype(np.float32)
        b3 = rng.normal(size=(C * F, O)).astype(np.float32)
        x = rng.normal(size=(1, 5, 3, C, 2 * d_in + 1)).astype(np.float32)
        io = bool(i % 2)
        got = pcon.so2_pair_contract(
            *map(torch.from_numpy, (h, w3, b3)), fr, torch.from_numpy(x),
            d_in=d_in, d_out=d_out, edge_chunks=edge_chunks,
            edge_frame_io=io)
        want = jcon.so2_pair_contract(
            *map(jnp.asarray, (h, w3, b3)), jfr_, jnp.asarray(x),
            d_in=d_in, d_out=d_out, pallas=False, pallas_interpret=False,
            edge_chunks=edge_chunks, edge_frame_io=io)
        assert got.shape == (1, 5, 3, O, 2 * d_out + 1)
        assert _rel_err(got, want) <= RTOL


# ---------------------------------------------------------------------- #
# ConvSE3
# ---------------------------------------------------------------------- #
def _random_params(shapes, seed):
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name.startswith('scale'):
            v = 1 + 0.1 * rng.normal(size=s.shape)
        elif name in ('bias', 'b3') or name.startswith('b3_'):
            v = 0.1 * rng.normal(size=s.shape)
        else:
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize('shared', [True, False])
def test_conv_matches_jax(shared):
    """ConvSE3(backend='so2') of degrees 0..3 (3 channels), grouped (the
    shared trunk) and per pair, pooled with self interaction: output and
    the gradients of every parameter and input feature against jax.grad,
    on converted parameters."""
    rng = np.random.RandomState(7)
    n, k, degrees = 6, 4, 4
    feats = {str(d): rng.normal(size=(1, n, 3, 2 * d + 1)).astype(np.float32)
             for d in range(degrees)}
    idx = rng.randint(0, n, (1, n, k))
    mask = rng.rand(1, n, k) > 0.2
    rel = rng.normal(size=(1, n, k, 3)).astype(np.float32)
    rel[0, 1, 2] = [0., 0., -1.]
    dist = np.linalg.norm(rel, axis=-1)
    jconv = JaxConv(JaxFiber.create(degrees, 3), JaxFiber.create(degrees, 3),
                    shared_radial_hidden=shared, backend='so2', pallas=False)
    jbasis = {'so2': jfr.edge_frames(jnp.asarray(rel), degrees - 1)}
    edge_info = (jnp.asarray(idx), jnp.asarray(mask), None)
    shapes = jax.eval_shape(lambda: jconv.init(
        jax.random.PRNGKey(0), feats, edge_info, jnp.asarray(dist),
        jbasis))['params']
    params = _random_params(shapes, 8)

    def loss_jax(p, f):
        out = jconv.apply({'params': p}, f, edge_info, jnp.asarray(dist),
                          jbasis)
        return sum((o ** 2).sum() for o in out.values()), out
    (loss, out_j), (gp, gf) = jax.jit(jax.value_and_grad(
        loss_jax, argnums=(0, 1), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in feats.items()})

    conv = ConvSE3(Fiber.create(degrees, 3), Fiber.create(degrees, 3),
                   shared_radial_hidden=shared, backend='so2')
    conv.load_state_dict(convert_flax_params(params, conv))
    tf = {k: torch.from_numpy(v).requires_grad_() for k, v in feats.items()}
    basis = {'so2': pfr.edge_frames(torch.from_numpy(rel), degrees - 1)}
    out = conv(tf, (torch.from_numpy(idx), torch.from_numpy(mask), None),
               torch.from_numpy(dist), basis)
    sum((o ** 2).sum() for o in out.values()).backward()
    for d in out:
        assert _rel_err(out[d].detach(), out_j[d]) <= RTOL
        assert _rel_err(tf[d].grad, gf[d]) <= RTOL
    want = convert_flax_params(gp, conv)
    for name, p in conv.named_parameters():
        assert _rel_err(p.grad, want[name]) <= RTOL, name


# ---------------------------------------------------------------------- #
# the backend rules
# ---------------------------------------------------------------------- #
RULES = (('attn_block1/to_[vk]', 'so2'), ('conv_(in|out)', 'so2'),
         ('.*', 'dense'))
NAMES = ('conv_in', 'preconv0', 'attn_block0/to_v', 'attn_block1/to_k',
         'attn_block1/to_v', 'conv_out', 'attn_block10/to_v')


@pytest.mark.parametrize('spec', ['so2', 'dense', RULES,
                                  (('to_v', 'so2'),)])
def test_resolve_conv_backend_matches_jax(spec):
    """A string for every layer, or first-match-wins rules (the last with
    the implicit ('.*', 'dense') tail)."""
    for name in NAMES:
        assert resolve_conv_backend(spec, name) == \
            jax_resolve_conv_backend(spec, name)


def test_unknown_backend_refuses():
    with pytest.raises(KeyError, match='unknown conv backend'):
        get_conv_backend('banded')
    with pytest.raises(KeyError, match='unknown conv backend'):
        SE3TransformerModule(dim=4, depth=1, num_degrees=2,
                             conv_backend=(('.*', 'banded'),), device='cpu')


MODEL = dict(dim=4, depth=2, num_degrees=3, heads=2, dim_head=4,
             attend_self=True, num_neighbors=4, output_degrees=2,
             reduce_dim_out=True)


@pytest.mark.parametrize('spec,keys', [
    ('so2', {'so2'}),
    ('dense', {'0,0', '2,2'}),
    ((('attn_block1/to_v', 'so2'),), {'0,0', '2,2', 'so2'}),
    ((('attn_block0', 'so2'), ('.*', 'dense')), {'0,0', '2,2', 'so2'})])
def test_payloads_follow_the_layers_backends(spec, keys):
    """An all-so2 model builds the frames and no basis; a mixed rule list
    both; per layer the backend its rule names."""
    model = SE3TransformerModule(**MODEL, conv_backend=spec, device='cpu')
    rel = torch.randn(1, 5, 4, 3, generator=torch.Generator().manual_seed(0))
    got = set(model._payloads(rel))
    assert keys <= got and ('so2' in got) == ('so2' in keys)
    assert (len(got) == 1) == (spec == 'so2')
    for name, backend in model.backends.items():
        assert backend == resolve_conv_backend(model.conv_backend, name)
    assert model.trunk.attn_block1.attn.to_v.backend == \
        resolve_conv_backend(model.conv_backend, 'attn_block1/to_v')


def test_fused_blocks_take_sh_only_for_dense_kv_convs():
    """fuse_pairwise with to_v so2 and to_k dense: the fused block's
    payloads are the frames and the SH stack, and no per-pair basis
    (conv_in and conv_out are so2 too)."""
    model = SE3TransformerModule(
        **dict(MODEL, depth=1), shared_radial_hidden=True,
        fuse_pairwise=True, device='cpu',
        conv_backend=(('to_k', 'dense'), ('.*', 'so2')))
    rel = torch.randn(1, 5, 4, 3, generator=torch.Generator().manual_seed(1))
    assert set(model._payloads(rel)) == {'so2', 'flash_sh'}


def test_one_tree_serves_dense_and_so2():
    """The so2 model's parameter tree is the dense model's: one converted
    tree loads into both, grouped and per pair."""
    for shared in (True, False):
        models = [SE3TransformerModule(**MODEL, shared_radial_hidden=shared,
                                       conv_backend=b, device='cpu')
                  for b in ('dense', 'so2')]
        state = models[1].state_dict()
        models[0].load_state_dict(state)
        assert set(models[0].state_dict()) == set(state)


# ---------------------------------------------------------------------- #
# the model
# ---------------------------------------------------------------------- #
TWIN = dict(dim=8, depth=1, num_degrees=4, heads=2, dim_head=4,
            attend_self=True, num_neighbors=5, output_degrees=2,
            reduce_dim_out=True, conv_backend='so2')
N = 12


def _batch(seed=0):
    """Coordinates with a pole pair (nodes 0 and 1 differ along z only)
    and a coincident pair (nodes 2 and 3), three nodes masked."""
    rng = np.random.RandomState(seed)
    coords = (rng.normal(size=(1, N, 3)) * 2).astype(np.float32)
    coords[0, 1] = coords[0, 0] + [0., 0., 0.8]
    coords[0, 3] = coords[0, 2]
    mask = np.ones((1, N), bool)
    mask[0, -3:] = False
    return (rng.normal(size=(1, N, 8)).astype(np.float32), coords, mask,
            rng.normal(size=(1, N, 3)).astype(np.float32))


@pytest.fixture(scope='module')
def twin():
    """One JAX so2 model with flagship_fast's layout (the shared trunk,
    reversible with save_conv_outputs, float32 trunk) and its value,
    parameter and coordinate gradients of a loss on the vector output,
    with differentiable_coors; computed once. The per-pair layout is held
    to JAX at the layer (test_conv_matches_jax)."""
    cfg = dict(TWIN, differentiable_coors=True, shared_radial_hidden=True,
               reversible=True, remat_policy='save_conv_outputs')
    feats, coords, mask, target = _batch()
    jm = JaxModule(pallas=False, **cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coords, mask=mask,
        return_type=1))['params']
    params = _random_params(shapes, 9)

    def loss(p, c):
        out = jm.apply({'params': p}, feats, c, mask=mask, return_type=1)
        return ((out - target) ** 2).sum(), out
    (value, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(coords))
    return cfg, params, (float(value), np.asarray(out), grads)


def test_model_matches_jax(twin):
    """The output, the loss, every parameter's gradient and the coordinate
    gradient (through the frames of a pole and a coincident pair) against
    jax.grad, on converted weights."""
    cfg, params, (value, out_j, (gp, gc)) = twin
    feats, coords, mask, target = _batch()
    tm = SE3TransformerModule(**cfg, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    c = torch.from_numpy(coords).requires_grad_()
    out = tm(torch.from_numpy(feats), c, mask=torch.from_numpy(mask),
             return_type=1)
    loss = ((out - torch.from_numpy(target)) ** 2).sum()
    loss.backward()
    assert _rel_err(out.detach(), out_j) <= RTOL
    assert abs(loss.item() - value) <= RTOL * abs(value)
    assert np.isfinite(c.grad.numpy()).all() and c.grad.abs().max() > 0
    assert _rel_err(c.grad, gc) <= RTOL
    want = convert_flax_params(gp, tm)
    for name, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert _rel_err(got, want[name]) <= RTOL, name


@pytest.mark.parametrize('shared', [True, False])
def test_model_is_rotation_equivariant(shared):
    """f(x, R c) = f(x, c) R for the vector output at degree 3, rotation in
    float64 on the host."""
    feats, coords, mask, _ = _batch(seed=2)
    tm = SE3TransformerModule(**TWIN, shared_radial_hidden=shared,
                              device='cpu',
                              generator=torch.Generator().manual_seed(3))
    R = rot(0.3, -1.1, 2.2)

    def f(c):
        with torch.no_grad():
            return tm(torch.from_numpy(feats),
                      torch.from_numpy(c.astype(np.float32)),
                      mask=torch.from_numpy(mask),
                      return_type=1).double().numpy()
    c64 = coords.astype(np.float64)
    assert np.abs(f(c64 @ R.T) - f(c64) @ R.T).max() <= EQUIVARIANCE_ATOL
