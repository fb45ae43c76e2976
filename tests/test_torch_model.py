"""The whole slice: a reduced flagship_fast twin of the port against the
JAX SE3TransformerModule on converted parameters, the port's equivariance,
its serving engine, its parameter converter, and its import boundary.
Parameters and inputs are made from a seed with numpy."""
import inspect
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_torch import (
    InferenceEngine, SE3TransformerModule, convert_flax_params, flagship,
    flagship_fast, get_basis, pad_to_bucket,
)
from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.so3 import rot

# one intra-op thread: these models are tiny, and pytest-xdist's workers
# would otherwise oversubscribe the CPU with spinning thread pools
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the flagship_fast fields at reduced width and depth
TWIN = dict(dim=8, depth=1, num_degrees=4, heads=8, dim_head=8,
            attend_self=True, num_neighbors=5, valid_radius=1e5,
            shared_radial_hidden=True, fuse_basis=True, reversible=True,
            remat_policy='save_conv_outputs')
N = 14
# float32 radial trunk: summation order only
RTOL_F32 = 1e-4
# bf16 radial trunk: both round the trunk to bf16, but XLA keeps excess
# float32 precision across some ops the port rounds, so single bf16 steps
# (2**-8 relative) differ in a fraction of the hidden units; the JAX
# package's own bf16-vs-float32 gap is of the same order
RTOL_BF16 = 1e-2


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.normal(size=(1, N, 8)).astype(np.float32)
    coors = (rng.normal(size=(1, N, 3)) * 2).astype(np.float32)
    mask = np.ones((1, N), bool)
    mask[0, -3:] = False
    return feats, coors, mask


def _random_params(shapes, seed):
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name.startswith('scale'):
            v = 1 + 0.1 * rng.normal(size=s.shape)
        elif name == 'bias' or name.startswith('b3_'):
            v = 0.1 * rng.normal(size=s.shape)
        else:
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope='module')
def twin_outputs():
    """{radial_bf16: (jax output, port output)} on shared params."""
    feats, coors, mask = _inputs()
    results = {}
    for bf16 in (False, True):
        cfg = dict(TWIN, radial_bf16=bf16)
        jm = JaxModule(**cfg)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), feats, coors, mask=mask,
            return_type=0))['params']
        params = _random_params(shapes, seed=1)
        ref = np.asarray(jax.jit(lambda p: jm.apply(
            {'params': p}, feats, coors, mask=mask, return_type=0))(params))
        tm = SE3TransformerModule(**cfg, device='cpu')
        tm.load_state_dict(convert_flax_params(params, tm))
        with torch.no_grad():
            out = tm(*(torch.from_numpy(a) for a in (feats, coors, mask)))
        results[bf16] = (ref, out.numpy())
    return results


@pytest.mark.parametrize('bf16,rtol', [(False, RTOL_F32), (True, RTOL_BF16)])
def test_slice_matches_jax(twin_outputs, bf16, rtol):
    ref, out = twin_outputs[bf16]
    assert out.shape == ref.shape == (1, N, 8)
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= rtol * np.abs(ref).max()


def test_bf16_radial_trunk_is_on(twin_outputs):
    """radial_bf16 reaches the trunk: same params, a different answer."""
    assert np.abs(twin_outputs[True][1] - twin_outputs[False][1]).max() > 0


@pytest.mark.parametrize('bf16', [False, True])
def test_slice_rotation_invariant(bf16):
    """The scalar output is invariant under rotating the coordinates
    (rotation in float64), within the JAX package's 1e-4 bound."""
    feats, coors, mask = _inputs(seed=2)
    tm = SE3TransformerModule(**dict(TWIN, radial_bf16=bf16), device='cpu',
                              generator=torch.Generator().manual_seed(3))
    R = rot(15, 0, 45)
    coors_r = (coors.astype(np.float64) @ R.T).astype(np.float32)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (feats, coors, mask)))
        out_r = tm(*(torch.from_numpy(a) for a in (feats, coors_r, mask)))
    assert (out - out_r).abs().max() < 1e-4


# the kNN paths that take the per-pair basis: flat basis (kernel #1's
# layout), structured basis (#2's), and fuse_pairwise, whose conv_in and
# conv_out take the per-pair basis and whose attention takes the SH stack
COORS_GRAD_CASES = {'fuse_basis': dict(),
                    'structured basis': dict(fuse_basis=False),
                    'fuse_pairwise': dict(fuse_pairwise=True)}


@pytest.mark.parametrize('case', list(COORS_GRAD_CASES))
def test_coordinate_gradient_matches_jax_grad(case):
    """With differentiable_coors=False the basis takes no gradient (JAX's
    stop_gradient), and only the radial distances carry one to the
    coordinates: the port's gradient of the summed output with respect to
    the coordinates matches jax.grad within RTOL_F32 of its largest value
    (float32 trunk)."""
    cfg = dict(TWIN, radial_bf16=False, **COORS_GRAD_CASES[case])
    feats, coors, mask = _inputs()
    jm = JaxModule(**cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coors, mask=mask,
        return_type=0))['params']
    params = _random_params(shapes, seed=1)
    ref = np.asarray(jax.jit(jax.grad(lambda c: jm.apply(
        {'params': params}, feats, c, mask=mask, return_type=0).sum()))(
            coors))
    tm = SE3TransformerModule(**cfg, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    tc = torch.from_numpy(coors).requires_grad_()
    tm(torch.from_numpy(feats), tc, torch.from_numpy(mask)).sum().backward()
    got = tc.grad.numpy()
    assert got.shape == ref.shape == (1, N, 3)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= RTOL_F32 * np.abs(ref).max()


@pytest.mark.parametrize('layout', ['pqf', 'pfq_flat'])
def test_basis_takes_no_gradient_unless_differentiable(layout):
    """get_basis(..., differentiable=False), the default, returns tensors
    with no grad path to rel_pos; differentiable=True keeps the path."""
    rel = torch.from_numpy(np.random.RandomState(6).normal(
        size=(5, 3)).astype(np.float32)).requires_grad_()
    for differentiable in (False, True):
        basis = get_basis(rel, 2, differentiable=differentiable,
                          layout=layout)
        # the (0, 0) basis is a constant either way
        assert [k for k, v in basis.items() if v.requires_grad] == (
            [k for k in basis if k != '0,0'] if differentiable else [])
    assert all(v.grad_fn is None for v in
               get_basis(rel, 2, layout=layout).values())
    outs = [v for k, v in basis.items() if k != '0,0']
    torch.autograd.backward(outs, [torch.ones_like(v) for v in outs])
    assert rel.grad is not None and torch.isfinite(rel.grad).all()


# the call that raised before attend_self defaulted to True: every other
# field at its default on both sides
DEFAULTS_CALL = dict(dim=8, heads=2, dim_head=4, depth=1, num_degrees=2,
                     shared_radial_hidden=True, num_neighbors=4)


def test_attend_self_defaults_to_true_as_in_jax():
    """SE3TransformerModule's attend_self default is JAX's (True), so the
    same call builds the same model: JAX's module built with its own
    defaults, the port's from converted weights, outputs within RTOL_F32."""
    assert inspect.signature(SE3TransformerModule).parameters[
        'attend_self'].default is True
    assert JaxModule.attend_self is True
    feats, coors, mask = _inputs(seed=4)
    jm = JaxModule(**DEFAULTS_CALL)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coors, mask=mask))['params']
    params = _random_params(shapes, seed=5)
    ref = np.asarray(jax.jit(lambda p: jm.apply(
        {'params': p}, feats, coors, mask=mask))(params))
    tm = SE3TransformerModule(**DEFAULTS_CALL, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (feats, coors, mask))).numpy()
    assert out.shape == ref.shape == (1, N, 8)
    assert np.abs(out - ref).max() <= RTOL_F32 * np.abs(ref).max()


def test_cpu_forward_counts_no_launch():
    feats, coors, mask = _inputs()
    tm = SE3TransformerModule(**TWIN, device='cpu')
    before = kp.fused_pairwise_conv_bxf.launches
    with torch.no_grad():
        tm(*(torch.from_numpy(a) for a in (feats, coors, mask)))
    assert kp.fused_pairwise_conv_bxf.launches == before


def test_engine_pads_to_bucket_and_serves():
    tm = SE3TransformerModule(**TWIN, device='cpu')
    engine = InferenceEngine(tm, buckets=(12, 16), device='cpu')
    feats, coors, _ = _inputs()
    out = engine.predict(feats[0, :11], coors[0, :11])
    assert out.shape == (11, 8) and np.isfinite(out).all()
    # the padded request equals the same nodes run unpadded with a mask
    f, c, m = pad_to_bucket([feats[0, :11]], [coors[0, :11]], 12)
    assert m.sum() == 11 and (f[0, 11:] == 0).all() and (c[0, 11:] == 0).all()
    with torch.no_grad():
        direct = tm(*(torch.from_numpy(a) for a in (f, c, m)))[0, :11]
    assert np.abs(direct.numpy() - out).max() == 0
    stats = engine.stats()
    assert stats['batches_served'] == {'12': 1}
    assert stats['rows_served'] == {'12': 1}
    with pytest.raises(ValueError):
        engine.predict(np.zeros((17, 8)), np.zeros((17, 3)))


def test_entry_points_default_to_cuda():
    """Without CUDA, building the recipe, the module or the engine with no
    device argument raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    with pytest.raises(RuntimeError):
        flagship_fast()
    with pytest.raises(RuntimeError):
        flagship()
    with pytest.raises(RuntimeError):
        SE3TransformerModule(**TWIN)
    with pytest.raises(RuntimeError):
        InferenceEngine(SE3TransformerModule(**TWIN, device='cpu'))


@pytest.mark.parametrize('field,value', [
    ('pallas_attention_interpret', True), ('flash_interpret', True),
    ('mesh', 'a mesh'), ('ring_overlap', False),
    ('sequence_parallel', 'ring'), ('matmul_precision', 'highest'),
    ('ring_exchange', False), ('matmul_precision', 'float32'),
    ('pallas_interpret', True), ('matmul_precision', 'bfloat16')])
def test_unported_fields_raise(field, value):
    with pytest.raises(NotImplementedError):
        SE3TransformerModule(**dict(TWIN, **{field: value}), device='cpu')


def test_convert_is_total():
    tm = SE3TransformerModule(**TWIN, device='cpu')
    flax_like = {}
    for key, value in tm.state_dict().items():
        *path, layer, name = key.split('.')
        if layer.startswith('Dense_') and name == 'weight':
            value, name = value.T, 'kernel'
        elif layer.startswith('LayerNorm_') and name == 'weight':
            name = 'scale'
        node = flax_like
        for p in (*path, layer):
            node = node.setdefault(p, {})
        node[name] = value.numpy()
    sd = convert_flax_params(flax_like, tm)
    for key, value in tm.state_dict().items():
        assert torch.equal(sd[key], value), key
    flax_like['conv_in']['w3_9_9'] = np.zeros((1,), np.float32)
    with pytest.raises(ValueError):
        convert_flax_params(flax_like, tm)
    del flax_like['conv_in']['w3_9_9']
    w3 = flax_like['conv_in']['w3_0_0']
    flax_like['conv_in']['w3_0_0'] = w3[:, :1]
    with pytest.raises(ValueError, match='shape'):
        convert_flax_params(flax_like, tm)
    flax_like['conv_in']['w3_0_0'] = w3
    del flax_like['norm_out']
    with pytest.raises(ValueError):
        convert_flax_params(flax_like, tm)


def test_import_leaves_jax_out():
    code = ('import sys, se3_transformer_torch, se3_transformer_torch.kernels.'
            'build, se3_transformer_torch.kernels.attention, '
            'se3_transformer_torch.kernels.flash, '
            'se3_transformer_torch.kernels.routing, '
            'se3_transformer_torch.inference.serve, '
            'se3_transformer_torch.observability, '
            'se3_transformer_torch.training.guardian, '
            'se3_transformer_torch.training.cli, '
            'se3_transformer_torch.faults, se3_transformer_torch.v2; '
            'bad = [m for m in '
            'sys.modules if m.split(".")[0] in ("jax", "flax", '
            '"se3_transformer_tpu")]; assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=120)
