"""The public-API leftovers of the port against the JAX package on the CPU:
the eager SE3Transformer wrapper (lazy seeded init) held to the JAX module
on converted parameters, OneHeadedKVAttentionSE3 (AttentionSE3 with one
key/value head), fiber_of, and the ops package's exports (RadialFunc,
pairwise_conv_contract, Neighborhood, sinusoidal_embeddings,
apply_rotary_pos_emb) with the numerics of the first two. Inputs come
from a numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import se3_transformer_tpu.ops as jops
from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.ops.fiber import Fiber as JaxFiber
import se3_transformer_torch as st
import se3_transformer_torch.ops as pops
from se3_transformer_torch import convert_flax_params
from se3_transformer_torch.ops.fiber import Fiber
# helpers of the attention variants' tests (pytest puts tests/ on the path)
from test_torch_variants import (
    LAYER_C, _layer_geometry, _layer_inputs, _random_params, _rel_err,
)

torch.set_num_threads(1)

# float32 paths: the same products in other orders
RTOL = 1e-5


@pytest.mark.parametrize('name', [
    'RadialFunc', 'pairwise_conv_contract', 'Neighborhood',
    'sinusoidal_embeddings', 'apply_rotary_pos_emb',
    'OneHeadedKVAttentionSE3', 'fiber_of', 'Fiber', 'ConvSE3', 'LinearSE3',
    'NormSE3', 'AttentionSE3', 'AttentionBlockSE3', 'residual_se3',
    'select_neighbors', 'SequentialTrunk'])
def test_ops_exports_what_jax_exports(name):
    """Each public name of the JAX ops package is a public name of the
    port's."""
    assert hasattr(jops, name)
    assert callable(getattr(pops, name))


def test_fiber_of_matches_jax():
    rng = np.random.RandomState(0)
    feats = {str(d): rng.normal(size=(2, 5, c, 2 * d + 1)).astype(np.float32)
             for d, c in ((0, 3), (1, 7), (3, 2))}
    want = jops.fiber_of({k: jnp.asarray(v) for k, v in feats.items()})
    got = pops.fiber_of({k: torch.from_numpy(v) for k, v in feats.items()})
    assert isinstance(got, Fiber)
    assert tuple(got) == tuple(want) == ((0, 3), (1, 7), (3, 2))


def test_pairwise_conv_contract_and_radial_func_match_jax():
    """The reference-ordered contraction and the unfused radial MLP
    (RadialFunc: the trunk, then Dense_2 to [c_out, c_in, F]) on converted
    parameters."""
    rng = np.random.RandomState(1)
    R = rng.normal(size=(2, 4, 4, 3, 3)).astype(np.float32)
    B = rng.normal(size=(2, 4, 5, 3, 3)).astype(np.float32)
    x = rng.normal(size=(2, 4, 3, 3)).astype(np.float32)
    want = jops.pairwise_conv_contract(*map(jnp.asarray, (R, B, x)))
    got = pops.pairwise_conv_contract(*map(torch.from_numpy, (R, B, x)))
    assert _rel_err(got.numpy(), np.asarray(want)) <= RTOL
    feats = rng.normal(size=(6, 1)).astype(np.float32)
    jr = jops.RadialFunc(num_freq=3, in_dim=2, out_dim=4)
    params = _random_params(jax.eval_shape(lambda: jr.init(
        jax.random.PRNGKey(0), feats))['params'], 2)
    want = jr.apply({'params': params}, feats)
    radial = pops.RadialFunc(3, 2, 4, edge_dim=1)
    radial.load_state_dict(convert_flax_params(params, radial))
    with torch.no_grad():
        got = radial(torch.from_numpy(feats))
    assert got.shape == (6, 4, 2, 3)
    assert _rel_err(got.numpy(), np.asarray(want)) <= RTOL


def test_one_headed_attention_matches_jax():
    """OneHeadedKVAttentionSE3 (2 query heads of 8, one kv head) on the
    attention variants' inputs (masked neighbors, the self slot):
    its parameters are AttentionSE3(kv_heads=1)'s, its output the JAX
    layer's on converted parameters."""
    feats, _, extra = _layer_inputs('one_headed')
    fields = dict(dim_head=8, heads=2, attend_self=True)
    jlayer = jops.OneHeadedKVAttentionSE3(JaxFiber.create(2, LAYER_C),
                                          **fields)
    edge_info, rel_dist, basis = _layer_geometry(jnp, extra, 'einsum')
    jf = {d: jnp.asarray(t) for d, t in feats.items()}
    params = _random_params(jax.eval_shape(lambda: jlayer.init(
        jax.random.PRNGKey(0), jf, edge_info, rel_dist, basis))['params'], 3)
    want = jlayer.apply({'params': params}, jf, edge_info, rel_dist, basis)
    layer = pops.OneHeadedKVAttentionSE3(Fiber.create(2, LAYER_C), **fields)
    twin = pops.AttentionSE3(Fiber.create(2, LAYER_C), kv_heads=1, **fields)
    assert {k: v.shape for k, v in layer.state_dict().items()} == \
        {k: v.shape for k, v in twin.state_dict().items()}
    layer.load_state_dict(convert_flax_params(params, layer))
    edge_info, rel_dist, basis = _layer_geometry(torch, extra, 'einsum')
    with torch.no_grad():
        got = layer({d: torch.from_numpy(t) for d, t in feats.items()},
                    edge_info, rel_dist, basis)
    assert set(got) == set(want) == {'0', '1'}
    for d in got:
        assert _rel_err(got[d].numpy(), np.asarray(want[d])) <= RTOL, d


EAGER = dict(dim=8, depth=1, num_degrees=2, heads=2, dim_head=8,
             num_neighbors=4, output_degrees=2, reduce_dim_out=True)


def test_eager_se3_transformer_matches_the_jax_module():
    """SE3Transformer builds its module on the first call with parameters
    drawn from a generator seeded `seed` (the module's, seeded alike), and
    serves what the JAX module computes on the same converted
    parameters."""
    rng = np.random.RandomState(4)
    feats = rng.normal(size=(1, 10, 8)).astype(np.float32)
    coors = (rng.normal(size=(1, 10, 3)) * 2).astype(np.float32)
    mask = np.ones((1, 10), bool)
    mask[0, -2:] = False
    f, c, m = (torch.from_numpy(a) for a in (feats, coors, mask))

    model = st.SE3Transformer(seed=5, device='cpu', **EAGER)
    assert model.params is None and model.model_family == 'se3_v1'
    with torch.no_grad():
        first = model(f, c, m, return_type=1)
    seeded = st.SE3TransformerModule(
        **EAGER, device='cpu', generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        torch.testing.assert_close(seeded(f, c, mask=m, return_type=1),
                                   first)
    assert set(model.params) == set(seeded.state_dict())

    jm = JaxModule(pallas=False, **EAGER)
    params = _random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coors, mask=mask,
        return_type=1))['params'], 6)
    want = jm.apply({'params': params}, feats, coors, mask=mask,
                    return_type=1)
    model.module.load_state_dict(convert_flax_params(params, model.module))
    with torch.no_grad():
        got = model(f, c, m, return_type=1)
    assert _rel_err(got.numpy(), np.asarray(want)) <= RTOL
