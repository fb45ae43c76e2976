"""The EGNN backbone of the port (se3_transformer_torch.ops.egnn, the model's
use_egnn trunk and the egnn_stress recipe) against the JAX package's
ops/egnn.py and SE3TransformerModule on converted parameters: HtypesNorm,
one EGNN layer (masked neighbors, with and without edges), EGnnNetwork
(feedforward, clamp, reversible on and off), the model's
test_model_surface.py EGNN configurations (forward and one step's
gradients) and the recipe's fields. Parameters and inputs are made from a
seed with numpy.

The EGNN Dense kernels are drawn at a standard deviation of about 1 /
sqrt(fan in) (0.2-0.35 here), not flax's 1e-3: at 1e-3 every update is
~1e-6 of the features, where a wrong term would hide under the tolerance.

Gradients are compared in float64, at the model's level (the port's model
in double with its pairwise contractions' plain version in float64, JAX
under enable_x64, unjitted). The EGNN's self-loop slot has a zero relative
vector, which HtypesNorm divides by its clamped norm (1e-8): the backward
sends a cotangent ~1e8 times the upstream one into both ends of that zero
vector, the node itself as i and as j, where it cancels. Wherever that
happens in float32 the cancellation leaves a residue of the size of the
true gradient, in float64 ~1e-8 of it. The JAX package's own jitted
gradients (XLA on the CPU) differ from its eager ones by up to ~6% of a
leaf's largest value for a bare two-layer EGnnNetwork on random features,
in float32 and float64 alike, and by ~1% for the adjacency model in
float64, while the port's float64 gradients agree with the eager ones to
~1e-5 (its LayerNorm statistics stay float32, as in flax). So the eager gradient is the
reference, and the network test holds the port's gradients to themselves,
reversible on and off.
"""
import jax
import numpy as np
import pytest
import torch

from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.ops.egnn import EGNN as JEGNN
from se3_transformer_tpu.ops.egnn import EGnnNetwork as JEGnnNetwork
from se3_transformer_tpu.ops.egnn import HtypesNorm as JHtypesNorm
from se3_transformer_tpu.ops.fiber import Fiber as JFiber
from se3_transformer_tpu.training.recipes import egnn_stress as jax_egnn_stress
from se3_transformer_torch import (
    EGNN, RECIPES, EGnnNetwork, Fiber, HtypesNorm, SE3TransformerModule,
    convert_flax_params, egnn_stress,
)
from se3_transformer_torch.kernels import pairwise as kp

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

# float32 on both sides: summation order only, relative to max|ref|
RTOL = 1e-4
B, N, K = 1, 12, 4
FIBER = ((0, 6), (1, 5), (2, 3))


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _random_params(shapes, seed):
    """Kernels normal / sqrt(fan in), scales 1 + 0.1 normal (HtypesNorm's
    0.5 + 0.1 normal), biases 0.1 normal."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = str(path[-1].key)
        parent = str(path[-2].key) if len(path) > 1 else ''
        if parent.startswith('htype_norm'):
            v = 0.5 + 0.1 * rng.normal(size=s.shape)
        elif name.startswith('scale'):
            v = 1 + 0.1 * rng.normal(size=s.shape)
        elif name == 'bias' or name.startswith('b3'):
            v = 0.1 * rng.normal(size=s.shape)
        else:
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _features(seed, fiber=FIBER, b=B, n=N):
    rng = np.random.RandomState(seed)
    return {str(d): rng.normal(size=(b, n, c, 2 * d + 1)).astype(np.float32)
            for d, c in fiber}


def _edge_info(seed, edge_dim=0, masked=True):
    """kNN-shaped neighbor lists (no self), a mask with a few padded slots,
    distances and edges."""
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.choice([j for j in range(N) if j != i], K,
                               replace=False) for i in range(N)])[None]
    mask = np.ones((B, N, K), bool)
    if masked:
        mask[0, ::3, -1] = False
    dist = rng.uniform(0.5, 3.0, size=(B, N, K)).astype(np.float32)
    edges = rng.normal(size=(B, N, K, edge_dim)).astype(np.float32) \
        if edge_dim else None
    return idx.astype(np.int32), mask, dist, edges


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if tree is None:
        return None
    t = torch.from_numpy(np.asarray(tree))
    return t.long() if t.dtype == torch.int32 else t


def _f64(tree):
    """Floating leaves of a tree (dict or pytree) as float64 numpy."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def _load(module, params):
    module.load_state_dict(convert_flax_params(params, module))
    return module


def test_htypes_norm_matches_jax():
    x = np.random.RandomState(0).normal(size=(2, 5, 4, 3)).astype(np.float32)
    x[0, 0, 0] = 0.                       # the self slot's zero vector
    jm = JHtypesNorm(4)
    init = jm.init(jax.random.PRNGKey(0), x)['params']
    assert np.allclose(init['scale'], 1e-2) and np.allclose(init['bias'],
                                                            1e-2)
    params = _random_params(init, 1)
    ref = np.asarray(jm.apply({'params': params}, x))
    out = _load(HtypesNorm(4), params)(torch.from_numpy(x)).detach().numpy()
    assert np.isfinite(out).all()
    assert _rel_err(out, ref) <= RTOL


@pytest.mark.parametrize('edge_dim,clamp', [(0, None), (3, 0.5)])
def test_egnn_layer_matches_jax(edge_dim, clamp):
    """One layer on masked neighbors, without and with edges (and the
    higher-degree weights clamped): every output degree at 1e-4."""
    feats = _features(2)
    idx, mask, dist, edges = _edge_info(3, edge_dim)
    jm = JEGNN(JFiber(FIBER), hidden_dim=8, edge_dim=edge_dim,
               coor_weights_clamp_value=clamp)
    edge_info = (idx, mask, edges)
    params = _random_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), feats, edge_info,
                        dist))['params'], 4)
    ref = jm.apply({'params': params}, feats, edge_info, dist)
    tm = _load(EGNN(Fiber(FIBER), hidden_dim=8, edge_dim=edge_dim,
                    coor_weights_clamp_value=clamp), params)
    out = tm(_torch(feats), (_torch(idx), _torch(mask), _torch(edges)),
             _torch(dist))
    assert set(out) == set(ref)
    for d in ref:
        assert _rel_err(out[d].detach().numpy(), ref[d]) <= RTOL, d


@pytest.mark.parametrize('feedforward,clamp', [(True, 2.0), (False, None)])
def test_egnn_network_matches_jax(feedforward, clamp):
    """EGnnNetwork (self-loops prepended, depth 2) with and without the
    feedforward blocks: the forward against JAX at 1e-4 with reversible on
    and off, and the same gradients (every parameter's and the input
    features') bit for bit with reversible on and off (module docstring:
    the model test holds gradients to JAX)."""
    feats = _features(5)
    idx, mask, dist, edges = _edge_info(6, 2)
    kwargs = dict(depth=2, edge_dim=2, hidden_dim=8,
                  coor_weights_clamp_value=clamp, feedforward=feedforward)
    jm = JEGnnNetwork(JFiber(FIBER), reversible=True, **kwargs)
    edge_info = (idx, mask, edges)
    params = _random_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), feats, edge_info,
                        dist))['params'], 7)
    ref = jax.jit(lambda p: jm.apply({'params': p}, feats, edge_info,
                                     dist))(params)
    t_edges = (_torch(idx), _torch(mask), _torch(edges))
    grads = []
    for reversible in (False, True):
        tm = _load(EGnnNetwork(Fiber(FIBER), reversible=reversible,
                               **kwargs), params)
        f = {k: v.requires_grad_() for k, v in _torch(feats).items()}
        out = tm(f, t_edges, _torch(dist))
        assert set(out) == set(ref)
        for d in ref:
            assert _rel_err(out[d].detach().numpy(), ref[d]) <= RTOL, d
        sum((v ** 2).mean() for v in out.values()).backward()
        grads.append({**{n: p.grad for n, p in tm.named_parameters()},
                      **{f'feats{d}': v.grad for d, v in f.items()}})
    for name in grads[0]:
        assert torch.isfinite(grads[0][name]).all(), name
        assert torch.equal(grads[0][name], grads[1][name]), name


def _plain_f64(h, w3, v2, b3=None, w3_scale=None):
    """kernels.pairwise.fused_pairwise_conv_plain in float64."""
    E, mid = h.shape
    R = torch.matmul(h, w3.reshape(mid, -1)).reshape(E, *w3.shape[1:])
    return torch.bmm(v2, R + b3)


def _data(seed=0, n=16, dim=8):
    """test_model_surface.py's _data: [1, 16, 8] features, coordinates and
    a full mask."""
    rng = np.random.RandomState(seed)
    feats = rng.normal(size=(1, n, dim)).astype(np.float32)
    coors = rng.normal(size=(1, n, 3)).astype(np.float32)
    return feats, coors, np.ones((1, n), bool)


# test_model_surface.py's two EGNN models, with their forward inputs
MODEL_CASES = {
    'test_egnn_options': (
        dict(dim=8, depth=2, num_degrees=2, num_neighbors=4, use_egnn=True,
             egnn_hidden_dim=16, egnn_weights_clamp_value=2.0,
             egnn_feedforward=True), False),
    'test_egnn_with_adjacency_edges': (
        dict(dim=8, depth=2, num_degrees=2, num_neighbors=0, use_egnn=True,
             attend_sparse_neighbors=True, max_sparse_neighbors=4,
             num_adj_degrees=2, adj_dim=4), True),
}


@pytest.mark.parametrize('case', sorted(MODEL_CASES))
def test_egnn_model_matches_jax(case, monkeypatch):
    """The model with the EGNN trunk (no conv_out: the output is the hidden
    fiber's degree 1, [1, 16, 8, 3]) against the JAX module: the output in
    float32; then in float64 (module docstring; the port's pairwise
    contractions keep their float32 plain versions) the output, the
    mean-square objective of scripts/run_baselines.py and every parameter's
    gradient; all at 1e-4."""
    fields, adjacency = MODEL_CASES[case]
    feats, coors, mask = _data()
    extra = {}
    if adjacency:
        i = np.arange(16)
        extra['adj_mat'] = np.abs(i[:, None] - i[None, :]) == 1
    jm = JaxModule(**fields)
    params = _random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coors, mask=mask, return_type=1,
        **extra))['params'], 8)
    ref32 = jax.jit(lambda p: jm.apply({'params': p}, feats, coors,
                                       mask=mask, return_type=1,
                                       **extra))(params)
    tm = SE3TransformerModule(**fields, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    t_extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    with torch.no_grad():
        out32 = tm(torch.from_numpy(feats), torch.from_numpy(coors),
                   torch.from_numpy(mask), return_type=1, **t_extra)
    assert _rel_err(out32.numpy(), ref32) <= RTOL

    feats, coors, params = _f64(feats), _f64(coors), _f64(params)
    with jax.enable_x64(True):
        def jloss(p):
            out = jm.apply({'params': p}, feats, coors, mask=mask,
                           return_type=1, **extra)
            return (out ** 2).mean(), out
        (ref_loss, ref), ref_g = jax.value_and_grad(jloss,
                                                    has_aux=True)(params)
        ref_g = _f64(ref_g)
    # float64 end to end: the contractions through their plain version
    # (pallas=False), kept in float64 here
    monkeypatch.setattr(kp, 'fused_pairwise_conv_plain', _plain_f64)
    tm = SE3TransformerModule(**fields, pallas=False, device='cpu').double()
    tm.load_state_dict(convert_flax_params(params, tm))
    out = tm(torch.from_numpy(feats), torch.from_numpy(coors),
             torch.from_numpy(mask), return_type=1, **t_extra)
    assert out.shape == ref.shape == (1, 16, 8, 3)
    assert _rel_err(out.detach().numpy(), ref) <= RTOL
    loss = (out ** 2).mean()
    assert abs(loss.item() - float(ref_loss)) <= RTOL * float(ref_loss)
    loss.backward()
    ref_g = convert_flax_params(ref_g, tm)
    for name, p in tm.named_parameters():
        if p.grad is None:
            # the last feedforward's degree-0 path does not reach the
            # degree-1 output: JAX's gradient is exactly zero there
            assert not np.abs(ref_g[name].numpy()).any(), name
            continue
        assert _rel_err(p.grad.numpy(), ref_g[name]) <= RTOL, name


def test_egnn_stress_recipe_is_jax():
    """egnn_stress has the JAX recipe's fields (dim 16, depth 12, 2
    degrees, EGNN with feedforward, clamp 2, k 16, reversible) and its
    parameter tree; RECIPES names the six JAX recipes."""
    jm = jax_egnn_stress()
    tm = egnn_stress(device='cpu')
    assert RECIPES['egnn_stress'] is egnn_stress
    assert sorted(RECIPES) == sorted(
        ('toy_denoise', 'flagship', 'flagship_fast', 'af2_refinement',
         'molecular_edges', 'egnn_stress'))
    feats, coors, mask = _data(dim=16, n=20)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coors, mask=mask,
        return_type=1))['params']
    state = convert_flax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), tm)
    assert set(state) == set(tm.state_dict())
    assert len([k for k in state if k.startswith('egnn_net.egnn')]) > 0
    assert not hasattr(tm, 'conv_out') and not hasattr(tm, 'trunk')


def test_egnn_refusals():
    """remat_policy has nothing to tag in the EGNN trunk, and the global
    mode presumes no neighbor list: both refused, as JAX asserts."""
    with pytest.raises(ValueError, match='remat_policy'):
        SE3TransformerModule(dim=8, depth=1, num_degrees=2, use_egnn=True,
                             reversible=True,
                             remat_policy='save_conv_outputs', device='cpu')
    with pytest.raises(ValueError, match='egnn'):
        SE3TransformerModule(dim=8, depth=1, num_degrees=2, use_egnn=True,
                             attention_mode='global', device='cpu')


def test_egnn_init_is_flax():
    """The EGNN's parameters are drawn as flax draws them: Dense kernels
    normal(1e-3), zero biases, HtypesNorm's constants 1e-2, node_norm
    ones and zeros."""
    tm = egnn_stress(dim=8, depth=1, device='cpu',
                     generator=torch.Generator().manual_seed(0))
    layer = tm.egnn_net.egnn0
    for name in ('edge_mlp0', 'htypes_mlp1', 'node_mlp0', 'htype_gate1'):
        w = getattr(layer, name).weight
        assert 0.5e-3 < w.std().item() < 2e-3, name
        assert torch.equal(getattr(layer, name).bias,
                           torch.zeros_like(getattr(layer, name).bias))
    assert torch.all(layer.htype_norm1.scale == 1e-2)
    assert torch.all(layer.htype_norm1.bias == 1e-2)
    assert torch.all(layer.node_norm.weight == 1.)
