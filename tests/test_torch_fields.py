"""The smaller fields of the JAX model surface in the port, against the JAX
package on converted parameters: conv_bf16 (the plain versions of #1/#2,
#3, A and B on bf16 operands against the JAX kernels in interpret mode;
flagship-, flagship_fast- and so2-shaped twins; their equivariance; the
refusals), norm_gated_scale (NormSE3, and the two test_config_fuzz.py
configurations that set it), the forward's precomputed `neighbors`,
PairwiseConvSE3(fused=False) (JAX's RadialFunc oracle), pallas=False and
the converter on the new parameter trees. Parameters and inputs are made
from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_surface as tsurf
from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.basis import get_basis as jax_get_basis
from se3_transformer_tpu.kernels.pallas_pairwise import (
    fused_pairwise_conv as jax_fwd,
    fused_pairwise_conv_bwd as jax_bwd,
    fused_pairwise_conv_bx as jax_bx,
    fused_pairwise_conv_bxf as jax_bxf,
)
from se3_transformer_tpu.ops.conv import PairwiseConvSE3 as JPairwise
from se3_transformer_tpu.ops.core import NormSE3 as JNormSE3
from se3_transformer_tpu.ops.fiber import Fiber as JFiber
from se3_transformer_torch import (
    Fiber, NormSE3, PairwiseConvSE3, SE3TransformerModule,
    convert_flax_params, get_basis,
)
from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.kernels import routing
from se3_transformer_torch.ops import AttentionSE3
from se3_transformer_torch.ops.attention import (
    FUSED_CONV_BF16, GLOBAL_CONV_BF16,
)
from se3_transformer_torch.so3 import rot

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

# float32 on both sides: summation order only
RTOL = 1e-4
# a plain version against the JAX kernel on the same bf16 operands: both
# upcast them exactly, then sum the same float32 products in other orders
KERNEL_RTOL = 1e-5
# conv_bf16 models against JAX, relative to max|ref|, per case: V2 (or the
# basis and x) is rounded to bf16 on each side from float32 values that
# differ in their last bits (their own summation orders), so an element may
# round to the neighbouring bf16 (2**-8 relative). Read here: flagship
# 4.2e-5, so2 2.1e-5 (up to 1.3e-4 on other seeds), against 1.4e-3-2.4e-3
# for the float32 model, which a port that skipped the cast would give.
# flagship_fast_f32_trunk runs JAX's basis-fused kernel in interpret mode
# (its default CPU path builds V2 in float32 and rounds V2, where the
# kernel rounds the basis and x, as the port does): 3.3e-7, float32 on
# both sides. flagship_fast adds the bf16 radial trunk, whose own rounding
# differences (up to 1e-2 relative, tests/test_torch_model.py) hide the
# cast's (5.4e-3 read, against JAX's default CPU path): it alone keeps the
# loose limit, and the float32-trunk case holds the cast.
CONV_BF16_RTOLS = {'flagship': 5e-4, 'so2': 5e-4,
                   'flagship_fast_f32_trunk': RTOL, 'flagship_fast': 2e-2}
BF16 = jnp.bfloat16
E, MID, C, O = 70, 16, 3, 4


def _bf16(a):
    """A float32 array's bf16 storage, the tensor the port takes (JAX gets
    jnp.asarray(a, bfloat16): the same values)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _operands(di, do, seed):
    rng = np.random.RandomState(seed)
    P, Q, F = 2 * do + 1, 2 * di + 1, 2 * min(di, do) + 1
    return dict(
        h=rng.normal(size=(E, MID)).astype(np.float32),
        w3=(rng.normal(size=(MID, C * F, O)) / np.sqrt(MID)).astype(np.float32),
        basis=rng.normal(size=(E, P * F * Q)).astype(np.float32),
        x=rng.normal(size=(E, C, Q)).astype(np.float32),
        v2=rng.normal(size=(E, P, C * F)).astype(np.float32),
        g=rng.normal(size=(E, P, O)).astype(np.float32),
        b3=rng.normal(size=(C * F, O)).astype(np.float32), pqf=(P, Q, F))


def _h_w3(a, dtype):
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(a['h']).to(tdt),
            torch.from_numpy(a['w3']).to(tdt),
            jnp.asarray(a['h'], dtype), jnp.asarray(a['w3'], dtype))


# ---------------------------------------------------------------------- #
# conv_bf16: the plain versions on bf16 operands
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('di,do,dtype', [(2, 1, 'float32'),
                                         (1, 2, 'bfloat16')])
def test_conv_bf16_bxf_and_bx_plain_match_jax(di, do, dtype):
    """#1 and #2's plain versions given the bf16 basis and x against the
    JAX _fwd_bx_kernel in interpret mode on the same bf16 operands (it
    upcasts them exactly, pallas_pairwise.py:606-616)."""
    a = _operands(di, do, seed=10 * di + do)
    P, Q, F = a['pqf']
    h, w3, h_j, w3_j = _h_w3(a, dtype)
    basis, x = _bf16(a['basis']), _bf16(a['x'])
    b3 = torch.from_numpy(a['b3'])
    basis_j, x_j = jnp.asarray(a['basis'], BF16), jnp.asarray(a['x'], BF16)
    ref = np.asarray(jax_bxf(h_j, w3_j, basis_j, x_j, a['pqf'], b3=a['b3'],
                             interpret=True))
    out = kp.fused_pairwise_conv_bxf(h, w3, basis, x, a['pqf'], b3).numpy()
    assert np.abs(out - ref).max() <= KERNEL_RTOL * np.abs(ref).max()
    structured = basis.reshape(E, P, F, Q).transpose(2, 3).contiguous()
    ref_bx = np.asarray(jax_bx(h_j, w3_j, basis_j.reshape(E, P, F, Q)
                               .transpose(0, 1, 3, 2), x_j, b3=a['b3'],
                               interpret=True))
    out_bx = kp.fused_pairwise_conv_bx(h, w3, structured, x, b3).numpy()
    assert np.abs(out_bx - ref_bx).max() <= KERNEL_RTOL * np.abs(ref_bx).max()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_conv_bf16_fwd_plain_matches_jax(dtype):
    """#3's plain version given bf16 V2 against the JAX _fwd_kernel in
    interpret mode on the same bf16 V2 (pallas_pairwise.py:347-351)."""
    a = _operands(3, 2, seed=5)
    h, w3, h_j, w3_j = _h_w3(a, dtype)
    v2 = _bf16(a['v2'])
    ref = np.asarray(jax_fwd(h_j, w3_j, jnp.asarray(a['v2'], BF16),
                             b3=a['b3'], interpret=True))
    out = kp.fused_pairwise_conv(h, w3, v2, torch.from_numpy(a['b3']))
    assert np.abs(out.numpy() - ref).max() <= \
        KERNEL_RTOL * np.abs(ref).max()


def test_conv_bf16_backward_plain_matches_jax():
    """Kernels A's and B's plain versions given bf16 V2 against the JAX
    _bwd_a_kernel and _bwd_b_kernel in interpret mode on the same bf16 V2
    (pallas_pairwise.py:946-949): dh, dw3, dv2 (float32, as JAX's
    out_shape) and db3."""
    a = _operands(2, 3, seed=6)
    h, w3, h_j, w3_j = _h_w3(a, 'float32')
    v2 = _bf16(a['v2'])
    refs = jax_bwd(h_j, w3_j, jnp.asarray(a['v2'], BF16), a['g'],
                   b3=a['b3'], interpret=True)
    outs = kp.fused_pairwise_conv_bwd(h, w3, v2, torch.from_numpy(a['g']),
                                      torch.from_numpy(a['b3']))
    for name, out, ref in zip(('dh', 'dw3', 'dv2', 'db3'), outs, refs):
        ref = np.asarray(ref)
        assert out.dtype == torch.float32, name
        assert np.abs(out.numpy() - ref).max() <= \
            KERNEL_RTOL * np.abs(ref).max(), name


# ---------------------------------------------------------------------- #
# conv_bf16 models
# ---------------------------------------------------------------------- #
SMALL = dict(dim=8, depth=1, num_degrees=3, heads=2, dim_head=8,
             attend_self=True, num_neighbors=5, shared_radial_hidden=True,
             reversible=True, conv_bf16=True, output_degrees=2)
CONV_BF16_CASES = {
    # flagship: float32 trunk, V2 by einsum, node chunks
    'flagship': dict(SMALL, edge_chunks=2),
    # flagship_fast: the basis-fused contraction, bf16 trunk
    'flagship_fast': dict(SMALL, fuse_basis=True, radial_bf16=True,
                          remat_policy='save_conv_outputs'),
    # the basis-fused contraction with the float32 trunk
    'flagship_fast_f32_trunk': dict(SMALL, fuse_basis=True,
                                    remat_policy='save_conv_outputs'),
    # the so2 backend's band z in place of V2, per pair and grouped
    'so2': dict(SMALL, conv_backend='so2', shared_radial_hidden=False),
}
# the JAX module's own fields per case (CONV_BF16_RTOLS)
CONV_BF16_JAX = {'flagship_fast_f32_trunk': dict(pallas_interpret=True)}


@pytest.mark.parametrize('case', sorted(CONV_BF16_CASES))
def test_conv_bf16_model_matches_jax(case):
    """Each conv_bf16 twin against the JAX module within its
    CONV_BF16_RTOLS of max|ref|; its output differs from the float32
    model's, as the rounding of V2 predicts, and but for the bf16 trunk's
    case the float32 model on the same weights falls outside the limit."""
    fields, limit = CONV_BF16_CASES[case], CONV_BF16_RTOLS[case]
    feats, coors, mask = tsurf._inputs()
    ref, out, params = tsurf._twins(fields, feats, coors, mask, 1,
                                    jax_cfg=CONV_BF16_JAX.get(case))
    assert out.shape == ref.shape
    assert tsurf._rel_err(out.numpy(), ref) <= limit
    f32 = SE3TransformerModule(**dict(fields, conv_bf16=False), device='cpu')
    f32.load_state_dict(convert_flax_params(params, f32))
    with torch.no_grad():
        plain = f32(torch.from_numpy(feats), torch.from_numpy(coors),
                    torch.from_numpy(mask), return_type=1)
    assert not torch.equal(plain, out)
    if not fields.get('radial_bf16'):
        assert tsurf._rel_err(plain.numpy(), ref) > limit


def test_conv_bf16_equivariance_is_jaxs():
    """conv_bf16 rounds tensors that rotate, so the model is equivariant
    only to bf16 precision, in both packages: on the same weights and
    rotation the port's error is at most twice the JAX package's own."""
    fields = CONV_BF16_CASES['flagship']
    feats, coors, mask = tsurf._inputs(seed=3)
    R = rot(0.4, 0.9, -0.2)
    rotated = tsurf._rotate(coors, R)
    jm = JaxModule(**fields)
    params = tsurf._random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coors, mask=mask,
        return_type=1))['params'], 2)
    apply = jax.jit(lambda c: jm.apply({'params': params}, feats, c,
                                       mask=mask, return_type=1))
    jax_err = np.abs(np.asarray(apply(rotated)) -
                     tsurf._rotate(apply(coors), R)).max()
    tm = SE3TransformerModule(**fields, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    with torch.no_grad():
        out, out_r = (tm(torch.from_numpy(feats), torch.from_numpy(c),
                         torch.from_numpy(mask), return_type=1).numpy()
                      for c in (coors, rotated))
    err = np.abs(out_r - tsurf._rotate(out, R)).max()
    assert 0 < err <= 2 * jax_err


def test_conv_bf16_refusals():
    """Where no conv operand is materialized JAX asserts: with
    fuse_pairwise and in global mode, at the model and at the layer, with
    JAX's messages."""
    with pytest.raises(ValueError, match='fuse_pairwise does not apply'):
        SE3TransformerModule(**dict(SMALL, fuse_pairwise=True),
                             device='cpu')
    with pytest.raises(ValueError, match='no materialized conv operand'):
        SE3TransformerModule(dim=8, depth=1, num_degrees=2, conv_bf16=True,
                             attention_mode='global', device='cpu')
    fiber = Fiber.create(2, 8)
    with pytest.raises(ValueError) as fused:
        AttentionSE3(fiber, conv_bf16=True, fuse_pairwise=True,
                     shared_radial_hidden=True)
    assert str(fused.value) == FUSED_CONV_BF16
    with pytest.raises(ValueError) as glob:
        AttentionSE3(fiber, conv_bf16=True, attention_mode='global')
    assert str(glob.value) == GLOBAL_CONV_BF16


# ---------------------------------------------------------------------- #
# norm_gated_scale
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('identity', [False, True])
def test_gated_norm_matches_jax(identity):
    """NormSE3(gated_scale=True): the norms mixed by w_gate{d} [c, c]
    (uniform(+-1e-3) at init, as flax draws it) before the nonlinearity."""
    fiber = ((0, 4), (1, 3), (2, 5))
    rng = np.random.RandomState(1)
    feats = {str(d): rng.normal(size=(2, 6, c, 2 * d + 1)).astype(np.float32)
             for d, c in fiber}
    kwargs = dict(nonlin=lambda t: t) if identity else {}
    jm = JNormSE3(JFiber(fiber), gated_scale=True, **kwargs)
    init = jm.init(jax.random.PRNGKey(0), feats)['params']
    assert sorted(init) == ['w_gate0', 'w_gate1', 'w_gate2']
    assert max(np.abs(np.asarray(v)).max() for v in init.values()) <= 1e-3
    params = tsurf._random_params(init, 3)
    ref = jm.apply({'params': params}, feats)
    tm = NormSE3(Fiber(fiber), gated_scale=True, **kwargs)
    tm.load_state_dict(convert_flax_params(params, tm))
    out = tm({k: torch.from_numpy(v) for k, v in feats.items()})
    for d in ref:
        assert tsurf._rel_err(out[d].detach().numpy(), ref[d]) <= RTOL, d


# test_config_fuzz.py's two configurations with norm_gated_scale (:16-17,
# :44-45), with their return types
FUZZ_CASES = {
    'memory_lean': (dict(dim=6, depth=2, num_degrees=2, num_neighbors=4,
                         attend_self=True, one_headed_key_values=True,
                         use_null_kv=True, norm_gated_scale=True,
                         fourier_encode_dist=True, num_conv_layers=1,
                         output_degrees=2), 1),
    'pooled_readout': (dict(dim=6, dim_out=3, depth=1, num_degrees=3,
                            num_neighbors=4, attend_self=True,
                            use_null_kv=True, norm_gated_scale=True,
                            output_degrees=1), 0),
}


@pytest.mark.parametrize('case', sorted(FUZZ_CASES))
def test_gated_fuzz_config_matches_jax(case):
    """The fuzz configurations through the port against JAX at 1e-4: every
    NormSE3 of the model (prenorms, preconv_norm0) gated."""
    fields, return_type = FUZZ_CASES[case]
    feats, coors, mask = tsurf._inputs(seed=4, n=10, dim=6)
    ref, out, _ = tsurf._twins(fields, feats, coors, mask, return_type)
    assert out.shape == ref.shape
    assert tsurf._rel_err(out.numpy(), ref) <= RTOL


# ---------------------------------------------------------------------- #
# precomputed neighbors
# ---------------------------------------------------------------------- #
NEIGHBOR_MODEL = dict(dim=8, depth=1, num_degrees=2, heads=2, dim_head=8,
                      attend_self=True, num_neighbors=4, output_degrees=2,
                      valid_radius=4.)


def _knn_lists(coors, k, self_inclusive=False):
    """Each node's k nearest others (numpy), optionally with the node
    itself first, as sklearn's kneighbors returns it."""
    d = np.linalg.norm(coors[0][:, None] - coors[0][None], axis=-1)
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=1, kind='stable')[:, :k]
    if self_inclusive:
        idx = np.concatenate((np.arange(len(idx))[:, None], idx), axis=1)
    return idx[None].astype(np.int32)


@pytest.mark.parametrize('kind', ['knn', 'self_inclusive', 'sentinel'])
def test_precomputed_neighbors_match_jax(kind):
    """neighbors=(indices, mask) against JAX at 1e-4: plain kNN lists, a
    self-inclusive list (its self slot invalid), and lists padded with the
    out-of-range sentinel n (clamped onto node n - 1; masked, and one left
    unmasked, which the clamp maps onto a real node: valid unless it is
    the node itself)."""
    feats, coors, mask = tsurf._inputs(seed=6)
    n = coors.shape[1]
    idx = _knn_lists(coors, 4, self_inclusive=kind == 'self_inclusive')
    nbr_mask = np.ones(idx.shape, bool)
    if kind == 'sentinel':
        idx[0, ::2, -1] = n
        nbr_mask[0, ::2, -1] = False
        nbr_mask[0, 0, -1] = True
    neighbors = dict(neighbors=(idx, nbr_mask))
    jm = JaxModule(**NEIGHBOR_MODEL)
    params = tsurf._random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coors, mask=mask, return_type=1,
        **neighbors))['params'], 5)
    ref = np.asarray(jax.jit(lambda p: jm.apply(
        {'params': p}, feats, coors, mask=mask, return_type=1,
        **neighbors))(params))
    tm = SE3TransformerModule(**NEIGHBOR_MODEL, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(coors),
                 torch.from_numpy(mask), return_type=1,
                 neighbors=(torch.from_numpy(idx),
                            torch.from_numpy(nbr_mask))).numpy()
    assert tsurf._rel_err(out, ref) <= RTOL


def test_precomputed_neighbors_refusals():
    """Precomputed lists take plain kNN semantics only, as JAX asserts."""
    feats, coors, mask = (torch.from_numpy(a) for a in tsurf._inputs())
    idx = torch.from_numpy(_knn_lists(coors.numpy(), 4))
    neighbors = (idx, None)
    causal = SE3TransformerModule(**dict(NEIGHBOR_MODEL, causal=True),
                                  device='cpu')
    plain = SE3TransformerModule(**NEIGHBOR_MODEL, device='cpu')
    with pytest.raises(ValueError, match='plain kNN'):
        causal(feats, coors, mask, neighbors=neighbors)
    with pytest.raises(ValueError, match='plain kNN'):
        plain(feats, coors, mask, neighbors=neighbors,
              neighbor_mask=torch.ones(1, 14, 14, dtype=torch.bool))
    # no kNN budget is needed with the lists
    budgetless = SE3TransformerModule(**dict(NEIGHBOR_MODEL,
                                             num_neighbors=0), device='cpu')
    out = budgetless(feats, coors, mask, return_type=1, neighbors=neighbors)
    assert out.shape == (1, 14, 8, 3) and torch.isfinite(out).all()


# ---------------------------------------------------------------------- #
# PairwiseConvSE3(fused=False), the RadialFunc oracle
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('di,do', [(1, 2), (2, 1)])
def test_unfused_pairwise_conv_matches_jax(di, do):
    """fused=False: R = RadialFunc(edge features) [c_out, c_in, F] per
    edge, contracted with x and then the basis in the reference order,
    against JAX at 1e-4 (its own parameters under `radial`, Dense_2
    included), and against the fused layout's math on the same
    numbers."""
    rng = np.random.RandomState(7)
    b, n, k, ci, co = 1, 6, 3, 3, 2
    rel_pos = rng.normal(size=(b, n, k, 3)).astype(np.float32)
    edge_feats = np.linalg.norm(rel_pos, axis=-1, keepdims=True)
    basis = jax_get_basis(jnp.asarray(rel_pos), max(di, do))[f'{di},{do}']
    x = rng.normal(size=(b, n, k, ci, 2 * di + 1)).astype(np.float32)
    jm = JPairwise(di, ci, do, co, fused=False)
    params = tsurf._random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), edge_feats, basis, x))['params'], 8)
    assert sorted(params['radial']) == ['Dense_0', 'Dense_1', 'Dense_2',
                                        'LayerNorm_0', 'LayerNorm_1']
    ref = np.asarray(jm.apply({'params': params}, edge_feats, basis, x))
    tm = PairwiseConvSE3(di, ci, do, co, edge_dim=1, fused=False)
    tm.load_state_dict(convert_flax_params(params, tm))
    t_basis = get_basis(torch.from_numpy(rel_pos), max(di, do))[f'{di},{do}']
    out = tm(torch.from_numpy(edge_feats), t_basis,
             torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape == (b, n, k, co, 2 * do + 1)
    assert tsurf._rel_err(out, ref) <= RTOL


def test_unfused_pairwise_conv_refuses_other_backends():
    with pytest.raises(ValueError, match='fused parameterization'):
        PairwiseConvSE3(1, 3, 1, 2, fused=False, backend='so2')


# ---------------------------------------------------------------------- #
# pallas=False
# ---------------------------------------------------------------------- #
def test_pallas_false_runs_the_plain_versions(monkeypatch):
    """pallas=False: the plain versions with no route consulted (so
    nothing counted in .routed, on any device) and no launch, the 'pqf'
    basis with fuse_basis, as JAX's XLA path; the same output as
    pallas=None (the plain path on the CPU) within 1e-4, and as the JAX
    module with pallas=False."""
    fields = dict(SMALL, conv_bf16=False, fuse_basis=True,
                  remat_policy='save_conv_outputs')
    feats, coors, mask = tsurf._inputs(seed=8)
    ref, out, params = tsurf._twins(dict(fields, pallas=False), feats, coors,
                                    mask, 1)
    assert tsurf._rel_err(out.numpy(), ref) <= RTOL
    consulted = []
    monkeypatch.setattr(routing, 'route',
                        lambda *a, **k: consulted.append(a) or False)
    model = SE3TransformerModule(**fields, pallas=False, device='cpu')
    model.load_state_dict(convert_flax_params(params, model))
    assert model.basis_layout == 'pqf' and not model.conv_in.fuse_basis
    launches = (kp.fused_pairwise_conv.launches,
                kp.fused_pairwise_conv_bxf.launches)
    inputs = (torch.from_numpy(feats), torch.from_numpy(coors),
              torch.from_numpy(mask))
    with torch.no_grad():
        out_false = model(*inputs, return_type=1)
    assert consulted == []
    assert launches == (kp.fused_pairwise_conv.launches,
                        kp.fused_pairwise_conv_bxf.launches)
    default = SE3TransformerModule(**fields, device='cpu')
    default.load_state_dict(convert_flax_params(params, default))
    assert default.basis_layout == 'pfq_flat'
    with torch.no_grad():
        out_none = default(*inputs, return_type=1)
    assert tsurf._rel_err(out_false.numpy(), out_none.numpy()) <= RTOL
    assert consulted            # the default path asks the route


def test_pallas_false_global_mode_runs_the_plain_stream(monkeypatch):
    """In global mode pallas=False takes the plain stream without asking
    the route, and gives the default path's output."""
    fields = dict(dim=8, depth=1, num_degrees=2, heads=2, dim_head=8,
                  output_degrees=2, attend_self=True,
                  attention_mode='global')
    gen = torch.Generator().manual_seed(3)
    model = SE3TransformerModule(**fields, device='cpu', generator=gen)
    plain = SE3TransformerModule(**fields, pallas=False, device='cpu')
    plain.load_state_dict(model.state_dict())
    feats, coors, mask = (torch.from_numpy(a) for a in tsurf._inputs())
    consulted = []
    monkeypatch.setattr(routing, 'route',
                        lambda *a, **k: consulted.append(a) or False)
    with torch.no_grad():
        out = plain(feats, coors, mask, return_type=1)
        assert consulted == []
        ref = model(feats, coors, mask, return_type=1)
    assert tsurf._rel_err(out.numpy(), ref.numpy()) <= RTOL


def test_pallas_values():
    with pytest.raises(ValueError, match='pallas'):
        SE3TransformerModule(**dict(SMALL, pallas='xla'), device='cpu')


# ---------------------------------------------------------------------- #
# the converter on the new trees
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('fields', [
    dict(dim=6, depth=1, num_degrees=2, num_neighbors=4,
         norm_gated_scale=True, num_conv_layers=1, reversible=True),
    dict(dim=6, depth=2, num_degrees=3, num_neighbors=4, use_egnn=True,
         egnn_feedforward=True, edge_dim=3)],
    ids=['gated', 'egnn'])
def test_convert_is_total_on_new_trees(fields):
    """Every leaf of a gated and an EGNN JAX tree fills one port parameter
    (w_gate{d}; egnn{i}/edge_mlp0 .. htype_gate{d}, htype_norm{d}/scale,
    node_norm/scale, ff{i}), and a missing leaf raises."""
    feats, coors, mask = tsurf._inputs(n=10, dim=6)
    extra = {}
    if fields.get('edge_dim'):
        extra['edges'] = np.random.RandomState(0).normal(
            size=(1, 10, 10, 3)).astype(np.float32)
    jm = JaxModule(**fields)
    params = tsurf._random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coors, mask=mask, return_type=0,
        **extra))['params'], 9)
    tm = SE3TransformerModule(**fields, device='cpu')
    state = convert_flax_params(params, tm)
    assert set(state) == set(tm.state_dict())
    key = 'w_gate0' if 'norm_gated_scale' in fields else 'node_norm'
    assert any(key in k for k in state)
    pruned = jax.tree_util.tree_map(np.asarray, params)
    if 'norm_gated_scale' in fields:
        del pruned['preconv_norm0']['w_gate1']
    else:
        del pruned['egnn_net']['egnn1']['node_norm']
    with pytest.raises(ValueError, match='no leaf fills'):
        convert_flax_params(pruned, tm)
