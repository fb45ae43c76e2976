"""The conservative `flagship` recipe on the port against the JAX package on
the CPU: a reduced twin of its fields (the grouped convs with V2 given, a
float32 radial trunk, reversible blocks replayed whole, edge_chunks that do
not divide n) — its outputs, denoise loss and every parameter gradient
against jax.grad on converted params — plus the recipe's defaults, the
parameter converter on the recipe's tree, the pairwise op's call counts
per training step, equivariance and serving. Parameters, inputs and noise
are made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.training.recipes import flagship as jax_flagship
from se3_transformer_torch import (
    InferenceEngine, SE3TransformerModule, convert_flax_params, denoise_loss,
    flagship, flagship_fast,
)
from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.so3 import rot

# one intra-op thread: these models are tiny, and pytest-xdist's workers
# would otherwise oversubscribe the CPU with spinning thread pools
torch.set_num_threads(1)

# flagship's fields with the denoise vector head, at reduced width and
# depth; 14 nodes in 3 chunks pad the node axis to 15
TWIN = dict(dim=8, depth=1, num_degrees=4, heads=8, dim_head=8,
            attend_self=True, num_neighbors=5, valid_radius=1e5,
            shared_radial_hidden=True, reversible=True, edge_chunks=3,
            output_degrees=2, reduce_dim_out=True)
N = 14
# float32 throughout: the two sides differ in summation order only;
# relative to each output's or leaf's largest magnitude
RTOL = 1e-4


def _batch(seed=0, n=N, masked_tail=3):
    rng = np.random.RandomState(seed)
    feats = rng.normal(size=(1, n, 8)).astype(np.float32)
    coords = (rng.normal(size=(1, n, 3)) * 2).astype(np.float32)
    mask = np.ones((1, n), bool)
    if masked_tail:
        mask[0, -masked_tail:] = False
    noise = rng.normal(size=(1, n, 3)).astype(np.float32)
    return dict(feats=feats, coords=coords, masks=mask), noise


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


def _param_shapes(jm, batch):
    return jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch['feats'], batch['coords'],
        mask=batch['masks'], return_type=1))['params']


def _jax_loss(jm):
    """training/denoise.py::denoise_loss_fn's masked MSE with the noise
    passed in the batch."""
    def loss_fn(params, batch):
        noised = batch['coords'] + batch['noise']
        out = jm.apply({'params': params}, batch['feats'], noised,
                       mask=batch['masks'], return_type=1)
        sq = (((noised + out) - batch['coords']) ** 2).sum(-1)
        m = batch['masks']
        return jnp.where(m, sq, 0.).sum() / jnp.maximum(m.sum(), 1)
    return loss_fn


@pytest.fixture(scope='module')
def twin():
    """(jax outputs, loss, grads), (port outputs, loss, grads): outputs
    are {degree: array}, grads state_dict-keyed float32 numpy arrays."""
    batch, noise = _batch()
    jm = JaxModule(**TWIN)
    params = _random_params(_param_shapes(jm, batch), seed=1)
    ref_out = jax.jit(lambda p: jm.apply(
        {'params': p}, batch['feats'], batch['coords'],
        mask=batch['masks']))(params)
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss(jm)))(
        params, dict(batch, noise=noise))

    tm = SE3TransformerModule(**TWIN, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    ref_grads = {k: v.numpy() for k, v in
                 convert_flax_params(grads, tm).items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = tm(tb['feats'], tb['coords'], mask=tb['masks'])
    tloss = denoise_loss(tm, tb, torch.from_numpy(noise))
    tloss.backward()
    # a parameter off the degree-1 path (the degree-0 head) gets no
    # gradient in torch and a zero one in JAX
    port_grads = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
                  else p.grad.numpy() for k, p in tm.named_parameters()}
    return (({k: np.asarray(v) for k, v in ref_out.items()}, float(loss),
             ref_grads),
            ({k: v.numpy() for k, v in out.items()}, float(tloss.detach()),
             port_grads))


def test_twin_outputs_match_jax(twin):
    (ref, _, _), (out, _, _) = twin
    assert set(out) == set(ref) == {'0', '1'}
    assert out['1'].shape == ref['1'].shape == (1, N, 3)
    for d in ref:
        assert np.isfinite(out[d]).all(), d
        assert np.abs(out[d] - ref[d]).max() <= RTOL * np.abs(ref[d]).max(), d


def test_twin_loss_and_gradients_match_jax_grad(twin):
    (_, ref_loss, ref), (_, loss, got) = twin
    assert abs(loss - ref_loss) <= RTOL * abs(ref_loss)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        assert np.isfinite(got[key]).all(), key
        scale = np.abs(ref[key]).max()
        assert np.abs(got[key] - ref[key]).max() <= RTOL * scale, key


def test_recipe_defaults():
    """flagship() is the JAX recipe: float32 radial trunk, no basis
    fusion, reversible with no remat policy, 8 node chunks."""
    model = flagship(dim=8, depth=1, num_neighbors=5, device='cpu')
    assert model.basis_layout == 'pqf'
    assert model.trunk.reversible and model.trunk._context_fn is None
    convs = [m for m in model.modules()
             if type(m).__name__ == 'ConvSE3']
    assert len(convs) == 4
    for conv in convs:
        assert (conv.fuse_basis, conv.edge_chunks, conv.radial_dtype) == \
            (False, 8, None)


def test_converter_takes_the_flagship_tree():
    """The JAX flagship recipe's parameter tree converts totally onto the
    port's flagship, and the names are flagship_fast's."""
    batch, _ = _batch()
    kw = dict(dim=8, depth=1, num_neighbors=5, output_degrees=2,
              reduce_dim_out=True)
    params = _random_params(_param_shapes(jax_flagship(**kw), batch), seed=2)
    model = flagship(**kw, device='cpu')
    state = convert_flax_params(params, model)
    model.load_state_dict(state)
    fast = flagship_fast(**kw, device='cpu')
    assert set(fast.state_dict()) == set(state)
    fast.load_state_dict(convert_flax_params(params, fast))


def test_call_counts_per_training_step(monkeypatch):
    """The pairwise op's CPU calls in one training step of a depth-2
    twin, 3 chunks each: the forward contracts every output degree of
    every conv once per chunk; the whole-block replay (no remat policy)
    runs the trunk's once more; save_conv_outputs saves them instead. The
    backward runs once per chunk of each contraction the loss reaches:
    not conv_out's degree-0 head. Gradients agree across the policies and
    with the model run without checkpointing. No call counts a launch.
    Two hidden degrees suffice for the counts: the rule is per output
    degree."""
    fwd, bwd = [], []
    plain_fwd, plain_bwd = kp.fused_pairwise_conv_plain, \
        kp.fused_pairwise_conv_bwd_plain
    monkeypatch.setattr(kp, 'fused_pairwise_conv_plain',
                        lambda *a: fwd.append(1) or plain_fwd(*a))
    monkeypatch.setattr(kp, 'fused_pairwise_conv_bwd_plain',
                        lambda *a: bwd.append(1) or plain_bwd(*a))
    batch, noise = _batch(seed=3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    depth, chunks, degrees = 2, 3, 2
    trunk = depth * 2 * degrees
    forward = (degrees + trunk + 2) * chunks
    backward = (degrees + trunk + 1) * chunks
    launches = (kp.fused_pairwise_conv.launches,
                kp.fused_pairwise_conv_bwd.launches_a,
                kp.fused_pairwise_conv_bwd.launches_b)
    grads = {}
    for policy, checkpointed, want in (
            (None, True, forward + trunk * chunks),
            ('save_conv_outputs', True, forward), (None, False, forward)):
        model = SE3TransformerModule(
            **dict(TWIN, depth=depth, num_degrees=degrees,
                   remat_policy=policy), device='cpu',
            generator=torch.Generator().manual_seed(4))
        model.trunk.reversible = checkpointed
        fwd.clear()
        bwd.clear()
        denoise_loss(model, tb, torch.from_numpy(noise)).backward()
        assert (len(fwd), len(bwd)) == (want, backward), (policy, checkpointed)
        grads[policy, checkpointed] = {k: p.grad for k, p in
                                       model.named_parameters()}
    ref = grads[None, False]
    for key in (None, True), ('save_conv_outputs', True):
        for name, g in grads[key].items():
            assert (g is None and ref[name] is None) or \
                torch.equal(g, ref[name]), (key, name)
    assert (kp.fused_pairwise_conv.launches,
            kp.fused_pairwise_conv_bwd.launches_a,
            kp.fused_pairwise_conv_bwd.launches_b) == launches


def test_vector_output_is_equivariant():
    """out(x R^T) = out(x) R^T for the degree-1 output of a depth-2 twin,
    float32, within the JAX package's 1e-4 bound (rotation in float64)."""
    batch, _ = _batch(seed=5)
    model = SE3TransformerModule(**dict(TWIN, depth=2), device='cpu',
                                 generator=torch.Generator().manual_seed(6))
    R = rot(0.3, -1.1, 2.0)
    coords_r = (batch['coords'].astype(np.float64) @ R.T).astype(np.float32)
    with torch.no_grad():
        args = [torch.from_numpy(batch[k]) for k in ('feats', 'coords',
                                                      'masks')]
        out = model(*args, return_type=1).double().numpy()
        args[1] = torch.from_numpy(coords_r)
        out_r = model(*args, return_type=1).double().numpy()
    assert np.abs(out).max() > 1e-2
    assert np.abs(out_r - out @ R.T).max() < 1e-4


def test_engine_serves_the_recipe():
    model = flagship(dim=8, depth=1, num_neighbors=5, device='cpu',
                     generator=torch.Generator().manual_seed(7))
    engine = InferenceEngine(model, buckets=(16,), device='cpu')
    batch, _ = _batch(seed=8)
    before = kp.fused_pairwise_conv.launches
    out = engine.predict(batch['feats'][0, :11], batch['coords'][0, :11])
    assert out.shape == (11, 8) and np.isfinite(out).all()
    assert kp.fused_pairwise_conv.launches == before


@pytest.mark.parametrize('value', [0, -1, 2.0, True])
def test_edge_chunks_must_be_a_positive_int(value):
    with pytest.raises(ValueError):
        SE3TransformerModule(**dict(TWIN, edge_chunks=value), device='cpu')
