"""The JAX default model surface in the port: a radial trunk per degree pair
(PairwiseConvSE3), differentiable_coors, fourier_encode_dist, input degrees
above 1 and the fiber fields. A reduced af2_refinement twin against the JAX
SE3TransformerModule on converted parameters (output, loss, every gradient
and the coordinate gradient, with the flat and the structured basis); the
nine configurations of tests/test_equivariance.py that the port builds
(equivariant at their own widths, JAX parity at reduced widths; those
with edges, an adjacency or causal masking on the reference tests' own
inputs); the per-pair basis-fused conv; the fiber fields; the backward's
plain versions at O = 192; the converter on per-pair trees. Parameters and
inputs are made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.basis import get_basis as jax_get_basis
from se3_transformer_tpu.ops.conv import ConvSE3 as JConv
from se3_transformer_tpu.ops.conv import _radial_contract as jax_contract
from se3_transformer_tpu.ops.fiber import Fiber as JFiber
from se3_transformer_tpu.training.recipes import af2_refinement as jax_af2
from se3_transformer_tpu.utils.helpers import fourier_encode as jax_fourier
from se3_transformer_torch import (
    AttentionSE3, ConvSE3, Fiber, SE3TransformerModule, af2_refinement,
    convert_flax_params, get_basis,
)
from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.so3 import rot
from se3_transformer_torch.utils.helpers import cast_tuple, fourier_encode

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

# float32 throughout: summation order only
RTOL_F32 = 1e-4
# the equivariance bound of tests/test_equivariance.py
EQUIVARIANCE_ATOL = 1e-4
# af2_refinement's fields at reduced width and depth (8 heads of 24 kept:
# the kv convs' O = 192)
AF2_TWIN = dict(dim=8, depth=1, num_neighbors=5)
N = 14


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


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _torch_feats(feats):
    if isinstance(feats, dict):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in feats.items()}
    return torch.from_numpy(np.asarray(feats))


def _jax_feats(feats):
    if isinstance(feats, dict):
        return {k: jnp.asarray(v) for k, v in feats.items()}
    return feats


def _twins(cfg, feats, coors, mask, return_type, seed=1, jax_cfg=None,
           **extra):
    """(JAX output, port output, params) of one configuration on shared
    random parameters; `jax_cfg` are more fields of the JAX module only
    (pallas_interpret), `extra` more forward inputs (numpy arrays: edges,
    adj_mat)."""
    jm = JaxModule(**cfg, **(jax_cfg or {}))
    jf = _jax_feats(feats)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jf, coors, mask=mask,
        return_type=return_type, **extra))['params']
    params = _random_params(shapes, seed)
    ref = jax.jit(lambda p: jm.apply({'params': p}, jf, coors, mask=mask,
                                     return_type=return_type,
                                     **extra))(params)
    tm = SE3TransformerModule(**cfg, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    with torch.no_grad():
        out = tm(_torch_feats(feats), torch.from_numpy(coors),
                 None if mask is None else torch.from_numpy(mask),
                 return_type=return_type,
                 **{k: torch.from_numpy(v) for k, v in extra.items()})
    return jax.tree_util.tree_map(np.asarray, ref), out, params


def _inputs(seed=0, n=N, dim=8):
    rng = np.random.RandomState(seed)
    feats = rng.normal(size=(1, n, dim)).astype(np.float32)
    coors = (rng.normal(size=(1, n, 3)) * 2).astype(np.float32)
    mask = np.ones((1, n), bool)
    mask[0, -3:] = False
    return feats, coors, mask


# ---------------------------------------------------------------------- #
# helpers and layer defaults
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('num_encodings,include_self', [(4, True), (3, False)])
def test_fourier_encode_matches_jax(num_encodings, include_self):
    x = np.random.RandomState(0).uniform(0, 9, size=(2, 5, 4, 1)) \
        .astype(np.float32)
    ref = jax_fourier(jnp.asarray(x), num_encodings=num_encodings,
                      include_self=include_self)
    out = fourier_encode(torch.from_numpy(x), num_encodings=num_encodings,
                         include_self=include_self)
    assert out.shape == ref.shape == (2, 5, 4, 2 * num_encodings
                                      + include_self)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-6


def test_cast_tuple():
    assert cast_tuple(3, 2) == (3, 3)
    assert cast_tuple((4, 2), 2) == (4, 2)


def test_layer_defaults_are_jax():
    """ConvSE3 and AttentionSE3 default to JAX's fields: a radial trunk per
    degree pair (pair_{d_in}_{d_out}) and no self slot."""
    fiber = Fiber.create(2, 4)
    conv = ConvSE3(fiber, fiber)
    names = {k.split('.')[0] for k, _ in conv.named_parameters()}
    assert names == {'pair_0_0', 'pair_1_0', 'pair_0_1', 'pair_1_1',
                     'self_interact'}
    attn = AttentionSE3(fiber, dim_head=4, heads=2)
    assert not hasattr(attn, 'to_self_k') and not hasattr(attn, 'to_self_v')
    assert isinstance(attn.to_v.pair_1_1.w3, torch.nn.Parameter)
    with pytest.raises(ValueError):
        ConvSE3(fiber, fiber, pool=False, self_interaction=False,
                fuse_pairwise=True)


def test_af2_refinement_recipe():
    """The recipe's fields as in JAX (training/recipes.py:87-91), on the
    per-pair trunk; its default device is the card."""
    model = af2_refinement(device='cpu')
    assert model.differentiable_coors and model.output_degrees == 2
    assert model.fiber_hidden.structure == ((0, 32), (1, 32))
    assert model.num_neighbors == 12 and model.trunk.depth == 2
    assert hasattr(model.trunk.attn_block1.attn, 'to_self_k')
    conv = model.trunk.attn_block0.attn.to_k
    assert not conv.shared_radial_hidden
    assert tuple(conv.pair_1_1.w3.shape) == (128, 96, 192)
    assert tuple(model.conv_in.pair_0_1.w3.shape) == (128, 32, 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            af2_refinement()


# ---------------------------------------------------------------------- #
# af2_refinement's reduced twin: output, loss and every gradient
# ---------------------------------------------------------------------- #
def _af2_inputs():
    feats, coors, mask = _inputs(seed=3)
    noise = np.random.RandomState(4).normal(size=coors.shape) \
        .astype(np.float32)
    return feats, coors, mask, noise


@pytest.fixture(scope='module')
def af2_jax():
    """The JAX twin's parameters, output, denoise loss and its gradients
    with respect to every parameter and to the noised coordinates."""
    feats, coors, mask, noise = _af2_inputs()
    jm = jax_af2(dim=AF2_TWIN['dim']).clone(
        **{k: v for k, v in AF2_TWIN.items() if k != 'dim'})
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coors, mask=mask,
        return_type=1))['params']
    params = _random_params(shapes, seed=5)

    def loss_fn(p, noised):
        out = jm.apply({'params': p}, feats, noised, mask=mask,
                       return_type=1)
        sq = (((noised + out) - coors) ** 2).sum(-1)
        return jnp.where(mask, sq, 0.).sum() / mask.sum(), out

    (loss, out), (dp, dc) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, coors + noise)
    return params, np.asarray(out), float(loss), dp, np.asarray(dc)


@pytest.fixture(scope='module')
def af2_port(af2_jax):
    """{basis layout: (output, loss, parameter gradients, coordinate
    gradient)} of the port's twin: the structured basis (V2 by einsum,
    kernel #3's op) and the flat one (fuse_basis: kernel #1's op)."""
    params = af2_jax[0]
    feats, coors, mask, noise = _af2_inputs()
    results = {}
    for layout, fuse_basis in (('structured', False), ('flat', True)):
        model = af2_refinement(device='cpu', fuse_basis=fuse_basis,
                               **AF2_TWIN)
        model.load_state_dict(convert_flax_params(params, model))
        noised = torch.from_numpy(coors + noise).requires_grad_()
        out = model(torch.from_numpy(feats), noised,
                    torch.from_numpy(mask), return_type=1)
        m = torch.from_numpy(mask)
        sq = (((noised + out) - torch.from_numpy(coors)) ** 2).sum(-1)
        loss = torch.where(m, sq, torch.zeros_like(sq)).sum() / m.sum()
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        results[layout] = (out.detach().numpy(), loss.item(), grads,
                           noised.grad.numpy())
    return results


@pytest.mark.parametrize('layout', ['structured', 'flat'])
def test_af2_twin_output_and_loss_match_jax(af2_jax, af2_port, layout):
    _, ref, ref_loss, _, _ = af2_jax
    out, loss, _, _ = af2_port[layout]
    assert out.shape == ref.shape == (1, N, 3)
    assert np.isfinite(out).all()
    assert _rel_err(out, ref) <= RTOL_F32
    assert abs(loss - ref_loss) <= RTOL_F32 * abs(ref_loss)


@pytest.mark.parametrize('layout', ['structured', 'flat'])
def test_af2_twin_gradients_match_jax(af2_jax, af2_port, layout):
    """Every parameter's gradient (the JAX tree converted like its
    parameters) within RTOL_F32 of its largest value."""
    _, _, _, dp, _ = af2_jax
    grads = af2_port[layout][2]
    model = af2_refinement(device='cpu', **AF2_TWIN)
    ref = convert_flax_params(jax.tree_util.tree_map(np.asarray, dp), model)
    assert set(ref) == set(grads)
    for key, r in ref.items():
        # no autograd path (the degree-0 head, which the loss does not
        # read): JAX's gradient there is zero
        got = torch.zeros_like(r) if grads[key] is None else grads[key]
        if not r.abs().max():
            assert not got.abs().max(), key
            continue
        assert _rel_err(got.numpy(), r.numpy()) <= RTOL_F32, key


@pytest.mark.parametrize('layout', ['structured', 'flat'])
def test_af2_coordinate_gradient_matches_jax(af2_jax, af2_port, layout):
    """differentiable_coors: the gradient to the coordinates runs through
    the basis (which keeps it) as well as the distances."""
    ref = af2_jax[4]
    got = af2_port[layout][3]
    assert np.abs(got).max() > 0
    assert _rel_err(got, ref) <= RTOL_F32


def test_differentiable_coors_reaches_the_basis():
    """With differentiable_coors the coordinate gradient differs from the
    one through the distances alone (the basis detached)."""
    feats, coors, mask, noise = _af2_inputs()
    grads = []
    for differentiable in (True, False):
        model = af2_refinement(device='cpu', depth=1, dim=8,
                               differentiable_coors=differentiable,
                               generator=torch.Generator().manual_seed(0))
        c = torch.from_numpy(coors).requires_grad_()
        model(torch.from_numpy(feats), c, torch.from_numpy(mask),
              return_type=1).sum().backward()
        grads.append(c.grad)
    assert (grads[0] - grads[1]).abs().max() > 1e-3 * grads[0].abs().max()


# ---------------------------------------------------------------------- #
# the equivariance gate: the configurations of tests/test_equivariance.py
# that this surface makes buildable
# ---------------------------------------------------------------------- #
# name -> (model fields, batch, input dims per degree, return type, the
# extra inputs), as the reference tests build them
EQUIVARIANCE_CASES = {
    'test_transformer': (dict(dim=64, depth=1, num_degrees=2,
                              num_neighbors=4, valid_radius=10), 1, (64,), 0,
                         None),
    'test_causal_se3_transformer': (
        dict(dim=64, depth=1, num_degrees=2, num_neighbors=4,
             valid_radius=10, causal=True), 1, (64,), 0, None),
    'test_transformer_with_edges': (
        dict(dim=64, depth=1, num_degrees=2, num_neighbors=4, edge_dim=4,
             num_edge_tokens=4), 1, (64,), 0, 'edge_tokens'),
    'test_transformer_with_continuous_edges': (
        dict(dim=64, depth=1, attend_self=True, num_degrees=2,
             output_degrees=2, edge_dim=34), 1, (64,), 1,
        'continuous_edges'),
    'test_different_input_dimensions_for_types': (
        dict(dim_in=(4, 2), dim=4, depth=1, input_degrees=2, num_degrees=2,
             output_degrees=2, reduce_dim_out=True), 2, (4, 2), 1, None),
    'test_equivariance': (dict(dim=64, depth=1, attend_self=True,
                               num_neighbors=4, num_degrees=2,
                               output_degrees=2, fourier_encode_dist=True),
                          1, (64,), 1, None),
    'test_equivariance_only_sparse_neighbors': (
        dict(dim=64, depth=1, attend_self=True, num_degrees=2,
             output_degrees=2, num_neighbors=0, attend_sparse_neighbors=True,
             num_adj_degrees=2, adj_dim=4), 1, (64,), 1, 'band_adjacency'),
    'test_equivariance_with_reversible_network': (
        dict(dim=64, depth=1, attend_self=True, num_neighbors=4,
             num_degrees=2, output_degrees=2, reversible=True), 1, (64,), 1,
        None),
    'test_equivariance_with_type_one_input': (
        dict(dim=64, depth=1, attend_self=True, num_neighbors=4,
             num_degrees=2, input_degrees=2, output_degrees=2), 1, (64, 64),
        1, None),
    # the EGNN trunk: no conv_out, the output is the hidden fiber's
    'test_equivariance_with_egnn_backbone': (
        dict(dim=64, depth=1, attend_self=True, num_neighbors=4,
             num_degrees=2, output_degrees=2, fourier_encode_dist=True,
             use_egnn=True), 1, (64,), 1, None),
}


def _extra_inputs(kind, b, n, rng):
    """The reference tests' edge and adjacency inputs (invariant under a
    rotation): edge tokens constant along a row, Fourier features of
    random integer pairs (8 scales and the values, 34 wide), the band
    |i - j| <= 1 with the diagonal set."""
    if kind == 'edge_tokens':
        tokens = rng.randint(0, 4, (b, n))
        return dict(edges=np.broadcast_to(tokens[:, :, None],
                                          (b, n, n)).copy())
    if kind == 'continuous_edges':
        values = rng.randint(0, 4, (b, n, n, 2)).astype(np.float32)
        return dict(edges=fourier_encode(torch.from_numpy(values),
                                         num_encodings=8).numpy())
    if kind == 'band_adjacency':
        seq = np.arange(n)
        return dict(adj_mat=np.abs(seq[:, None] - seq[None, :]) <= 1)
    return {}


def _equivariance_inputs(b, dims, n, seed=0, extra=None):
    """feats (a [b, n, d] array, or the degrees' dict with degree 1 in
    Cartesian order), coordinates, mask, the extra inputs."""
    rng = np.random.RandomState(seed)
    if len(dims) == 1:
        feats = rng.normal(size=(b, n, dims[0])).astype(np.float32)
    else:
        feats = {str(d): rng.normal(size=(b, n, c, 2 * d + 1))
                 .astype(np.float32) for d, c in enumerate(dims)}
    coors = rng.normal(size=(b, n, 3)).astype(np.float32)
    return feats, coors, np.ones((b, n), bool), \
        _extra_inputs(extra, b, n, rng)


def _rotate(x, R):
    """x @ R in float64, back to float32 (the reference tests' rotation)."""
    return (np.asarray(x, np.float64) @ R).astype(np.float32)


@pytest.mark.parametrize('case', sorted(EQUIVARIANCE_CASES))
def test_equivariance_config_is_equivariant(case):
    """At the reference test's own widths (n 32): the vector output rotates
    with the coordinates (and the degree-1 input), the scalar one does not
    move, within the reference's 1e-4."""
    fields, b, dims, return_type, kind = EQUIVARIANCE_CASES[case]
    model = SE3TransformerModule(**fields, device='cpu',
                                 generator=torch.Generator().manual_seed(0))
    feats, coors, mask, extra = _equivariance_inputs(b, dims, 32,
                                                     extra=kind)
    extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    R = rot(15, 0, 45)
    feats_r = {k: (_rotate(v, R) if k == '1' else v)
               for k, v in feats.items()} if isinstance(feats, dict) \
        else feats
    with torch.no_grad():
        out, out_r = (model(_torch_feats(f), torch.from_numpy(c),
                            torch.from_numpy(mask),
                            return_type=return_type, **extra).numpy()
                      for f, c in ((feats, coors),
                                   (feats_r, _rotate(coors, R))))
    want_shape = (b, 32) + ((64,) if not fields.get('reduce_dim_out')
                            else ()) + ((3,) if return_type else ())
    assert out.shape == want_shape and np.isfinite(out).all()
    expected = _rotate(out, R) if return_type else out
    assert np.abs(out_r - expected).max() < EQUIVARIANCE_ATOL


@pytest.mark.parametrize('case', sorted(EQUIVARIANCE_CASES))
def test_equivariance_config_matches_jax(case):
    """The same configuration at reduced widths (dim 8, 2 heads of 8, n
    12) against the JAX module on converted parameters."""
    fields, b, dims, return_type, kind = EQUIVARIANCE_CASES[case]
    fields = dict(fields, heads=2, dim_head=8)
    if fields['dim'] == 64:
        fields['dim'] = 8
        dims = tuple(8 for _ in dims)
    feats, coors, mask, extra = _equivariance_inputs(b, dims, 12, seed=1,
                                                     extra=kind)
    ref, out, _ = _twins(fields, feats, coors, mask, return_type, **extra)
    assert out.shape == ref.shape
    assert _rel_err(out.numpy(), ref) <= RTOL_F32


# ---------------------------------------------------------------------- #
# the per-pair conv with fuse_basis, and the fiber fields
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('pool,fourier,edge_chunks', [
    (True, False, None), (False, True, 2)])
def test_per_pair_fuse_basis_conv_matches_jax(pool, fourier, edge_chunks):
    """ConvSE3(shared_radial_hidden=False, fuse_basis=True): one
    basis-fused contraction per pair (kernel #1's op, the flat basis)
    against the JAX layer on its plain XLA path (the structured basis)."""
    rng = np.random.RandomState(7)
    b, n, k = 1, 9, 4
    fin, fout = Fiber.create(3, 3), Fiber.create(2, 5)
    feats = {str(d): rng.normal(size=(b, n, 3, 2 * d + 1)).astype(np.float32)
             for d in range(3)}
    idx = rng.randint(0, n, size=(b, n, k))
    mask = rng.rand(b, n, k) > 0.2
    rel_pos = rng.normal(size=(b, n, k, 3)).astype(np.float32)
    rel_dist = np.linalg.norm(rel_pos, axis=-1).astype(np.float32)
    kw = dict(pool=pool, self_interaction=pool, fourier_encode_dist=fourier,
              edge_chunks=edge_chunks)
    jmod = JConv(JFiber.create(3, 3), JFiber.create(2, 5), fuse_basis=True,
                 **kw)
    j_args = ({d: jnp.asarray(v) for d, v in feats.items()},
              (jnp.asarray(idx), jnp.asarray(mask), None),
              jnp.asarray(rel_dist),
              jax_get_basis(jnp.asarray(rel_pos), 2, layout='pqf'))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              *j_args))['params']
    params = _random_params(shapes, seed=8)
    ref = jax.jit(lambda p: jmod.apply({'params': p}, *j_args))(params)
    conv = ConvSE3(fin, fout, fuse_basis=True, **kw)
    conv.load_state_dict(convert_flax_params(params, conv))
    with torch.no_grad():
        out = conv({d: torch.from_numpy(v) for d, v in feats.items()},
                   (torch.from_numpy(idx).long(),
                    torch.from_numpy(mask), None),
                   torch.from_numpy(rel_dist),
                   get_basis(torch.from_numpy(rel_pos), 2,
                             layout='pfq_flat'))
    assert set(out) == set(ref)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    for d in ref:
        assert out[d].shape == ref[d].shape
        assert np.abs(out[d].numpy() - np.asarray(ref[d])).max() \
            <= RTOL_F32 * scale, d


# name -> (model fields, return type); 2 heads of 8, n 12
FIBER_CASES = {
    'attend_self=False': (dict(dim=8, num_degrees=2, output_degrees=2,
                               attend_self=False), 1),
    'num_conv_layers=1': (dict(dim=8, num_degrees=2, output_degrees=2,
                               num_conv_layers=1), 1),
    'hidden_fiber_dict,out_fiber_dict': (
        dict(dim=8, num_degrees=3, hidden_fiber_dict={0: 8, 1: 4, 2: 4},
             out_fiber_dict={0: 4, 1: 6}), None),
    'num_degrees=None,dim_out': (
        dict(dim=8, num_degrees=None, hidden_fiber_dict={0: 6, 1: 4},
             output_degrees=2, dim_out=5), None),
}


@pytest.mark.parametrize('case', sorted(FIBER_CASES))
def test_fiber_fields_match_jax(case):
    fields, return_type = FIBER_CASES[case]
    fields = dict(fields, depth=1, heads=2, dim_head=8, num_neighbors=5)
    feats, coors, mask = _inputs(seed=9, n=12)
    ref, out, _ = _twins(fields, feats, coors, mask, return_type)
    if return_type is None:
        assert set(out) == set(ref)
        for d in ref:
            assert out[d].shape == ref[d].shape, d
            assert _rel_err(out[d].numpy(), ref[d]) <= RTOL_F32, d
    else:
        assert out.shape == ref.shape
        assert _rel_err(out.numpy(), ref) <= RTOL_F32


# ---------------------------------------------------------------------- #
# the backward's plain versions at af2_refinement's O, and the converter
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('di,do', [(0, 0), (1, 1)])
def test_backward_plain_matches_jax_vjp_at_o192(di, do):
    """fused_pairwise_conv_bwd_plain (dh, dw3, dv2, db3) against jax.vjp of
    the JAX package's XLA contraction (ops/conv.py::_radial_contract with
    pallas=False) at O = 192, C = 32."""
    rng = np.random.RandomState(10 + di + do)
    E, C, O = 40, 32, 192
    P, F = 2 * do + 1, 2 * min(di, do) + 1
    IF = C * F
    h = rng.normal(size=(E, kp.MID)).astype(np.float32)
    w3 = (rng.normal(size=(kp.MID, IF, O)) / np.sqrt(kp.MID)) \
        .astype(np.float32)
    b3 = (0.1 * rng.normal(size=(IF, O))).astype(np.float32)
    v2 = rng.normal(size=(E, P, IF)).astype(np.float32)
    g = rng.normal(size=(E, P, O)).astype(np.float32)
    _, vjp = jax.vjp(lambda h_, w_, b_, v_: jax_contract(
        h_, w_, b_, v_, pallas=False, pallas_interpret=False,
        edge_chunks=None), h, w3, b3, v2)
    ref_h, ref_w3, ref_b3, ref_v2 = vjp(g)
    outs = kp.fused_pairwise_conv_bwd_plain(
        *(torch.from_numpy(a) for a in (h, w3, v2, g, b3)))
    for name, out, ref in zip(('dh', 'dw3', 'dv2', 'db3'), outs,
                              (ref_h, ref_w3, ref_v2, ref_b3)):
        assert out.shape == ref.shape, name
        assert _rel_err(out.numpy(), ref) <= RTOL_F32, name


def test_convert_is_total_on_per_pair_trees():
    """The JAX tree of a model with per-pair trunks, pre-convs and no self
    slot converts leaf for leaf; a leftover, a missing leaf or a wrong
    shape raises."""
    fields = dict(dim=4, depth=1, num_degrees=2, output_degrees=2,
                  attend_self=False, num_conv_layers=1, heads=2, dim_head=4,
                  num_neighbors=3)
    feats, coors, mask = _inputs(seed=11, n=6, dim=4)
    shapes = jax.eval_shape(lambda: JaxModule(**fields).init(
        jax.random.PRNGKey(0), feats, coors, mask=mask,
        return_type=1))['params']
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    params = jax.tree_util.tree_map(np.asarray, params)
    params = {k: v for k, v in params.items()}
    assert 'pair_0_1' in params['conv_in'] and 'preconv0' in params
    model = SE3TransformerModule(**fields, device='cpu')
    state = convert_flax_params(params, model)
    assert set(state) == set(model.state_dict())
    attn = params['trunk']['attn_block0']['attn']
    attn['to_self_k'] = {'w0': np.zeros((4, 8), np.float32)}
    with pytest.raises(ValueError):
        convert_flax_params(params, model)
    del attn['to_self_k']
    w3 = params['conv_in']['pair_0_1']['w3']
    params['conv_in']['pair_0_1']['w3'] = w3[:, :1]
    with pytest.raises(ValueError, match='shape'):
        convert_flax_params(params, model)
    params['conv_in']['pair_0_1']['w3'] = w3
    del params['preconv0']
    with pytest.raises(ValueError):
        convert_flax_params(params, model)
