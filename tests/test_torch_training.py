"""The training slice of the port against the JAX package on the CPU: the
vector-head twin's output, denoise loss and every parameter gradient
(against jax.grad on converted params), Adam steps against optax through
make_sharded_train_step / make_accumulating_train_step, the vector
output's equivariance, and the remat policies' pairwise-op call counts.
Parameters, inputs and noise are made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.parallel.sharding import (
    make_accumulating_train_step, make_sharded_train_step,
)
from se3_transformer_torch import (
    DenoiseTrainer, SE3TransformerModule, convert_flax_params, denoise_loss,
    flagship_batch,
)
from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.so3 import rot

# one intra-op thread: these models are tiny, and pytest-xdist's workers
# would otherwise oversubscribe the CPU with spinning thread pools
torch.set_num_threads(1)

# flagship_fast's fields with the denoise vector head, at reduced width and
# depth
TWIN = dict(dim=8, depth=1, num_degrees=4, heads=8, dim_head=8,
            attend_self=True, num_neighbors=5, valid_radius=1e5,
            shared_radial_hidden=True, fuse_basis=True, reversible=True,
            remat_policy='save_conv_outputs', output_degrees=2,
            reduce_dim_out=True)
N = 14
# float32 radial trunk: the two sides differ in summation order only;
# relative to each leaf's largest magnitude
RTOL_F32 = 1e-4
# bf16 radial trunk: XLA on the CPU keeps excess float32 precision across
# some bf16 ops that the port rounds (tests/test_torch_model.py), so single
# bf16 steps (2**-8 relative) differ in a fraction of the radial hidden
# units; the seeded case moves the vector output and the gradients by up
# to 2.3e-2 of their largest magnitude, and the bound leaves 2x room
RTOL_BF16 = 5e-2
LR = 1e-4


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


def _jax_loss(jm):
    """The masked MSE of training/denoise.py::denoise_loss_fn with the
    noise passed in the batch (bench.py's loss when the mask is all
    true)."""
    def loss_fn(params, batch, rng=None):
        noised = batch['coords'] + batch['noise']
        out = jm.apply({'params': params}, batch['feats'], noised,
                       mask=batch['masks'], return_type=1)
        sq = (((noised + out) - batch['coords']) ** 2).sum(-1)
        m = batch['masks']
        loss = jnp.where(m, sq, 0.).sum() / jnp.maximum(m.sum(), 1)
        return loss, dict(out=out)
    return loss_fn


_SHAPES = {}


def _jax_twin(cfg, batch, seed=1):
    """The JAX module and seeded params; each configuration's param shapes
    are traced once per module (they depend on the batch's shape only)."""
    jm = JaxModule(**cfg)
    key = tuple(sorted(cfg.items())) + (batch['feats'].shape,)
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), batch['feats'], batch['coords'],
            mask=batch['masks'], return_type=1))['params']
    return jm, _random_params(_SHAPES[key], seed)


def _port(cfg, params):
    tm = SE3TransformerModule(**cfg, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    return tm


@pytest.fixture(scope='module')
def twin_grads():
    """{radial_bf16: (jax (out, loss, grads), port (out, loss, grads))}:
    grads are state_dict-keyed float32 numpy arrays."""
    batch, noise = _batch()
    results = {}
    for bf16 in (False, True):
        cfg = dict(TWIN, radial_bf16=bf16)
        jm, params = _jax_twin(cfg, batch)
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            _jax_loss(jm), has_aux=True))(params, dict(batch, noise=noise))
        tm = _port(cfg, params)
        ref_grads = {k: v.numpy() for k, v in
                     convert_flax_params(grads, tm).items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        out = tm(tb['feats'], tb['coords'] + torch.from_numpy(noise),
                 mask=tb['masks'], return_type=1)
        tloss = denoise_loss(tm, tb, torch.from_numpy(noise))
        tloss.backward()
        # a parameter off the degree-1 path (the degree-0 head) gets no
        # gradient in torch and a zero one in JAX
        port_grads = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
                      else p.grad.numpy() for k, p in tm.named_parameters()}
        results[bf16] = ((np.asarray(aux['out']), float(loss), ref_grads),
                         (out.detach().numpy(), float(tloss), port_grads))
    return results


@pytest.mark.parametrize('bf16,rtol', [(False, RTOL_F32), (True, RTOL_BF16)])
def test_twin_vector_output_and_loss_match_jax(twin_grads, bf16, rtol):
    (ref, ref_loss, _), (out, loss, _) = twin_grads[bf16]
    assert out.shape == ref.shape == (1, N, 3)
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= rtol * np.abs(ref).max()
    assert abs(loss - ref_loss) <= rtol * abs(ref_loss)


@pytest.mark.parametrize('bf16,rtol', [(False, RTOL_F32), (True, RTOL_BF16)])
def test_twin_gradients_match_jax_grad(twin_grads, bf16, rtol):
    """Every parameter's gradient, leaf by leaf, relative to the leaf's
    largest JAX gradient."""
    (_, _, ref), (_, _, got) = twin_grads[bf16]
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        assert np.isfinite(got[key]).all(), key
        scale = np.abs(ref[key]).max()
        assert np.abs(got[key] - ref[key]).max() <= rtol * scale, key


def _adam_case(accum_steps):
    """The JAX step and the port's trainer from the same params, on a
    float32 trunk: (jax step, params, opt state, port trainer, batches)."""
    cfg = dict(TWIN, radial_bf16=False)
    batch, noise = _batch(seed=3)
    jm, params = _jax_twin(cfg, batch, seed=4)
    rng = np.random.RandomState(5)
    if accum_steps == 1:
        step = make_sharded_train_step(_jax_loss(jm), optax.adam(LR))
        noises = [rng.normal(size=noise.shape).astype(np.float32)
                  for _ in range(3)]
        batches = [(batch, n) for n in noises]
    else:
        step = make_accumulating_train_step(_jax_loss(jm), optax.adam(LR),
                                            accum_steps)
        micro = {k: np.stack([v, _batch(seed=6)[0][k]]) for k, v in
                 batch.items()}
        batches = [(micro, rng.normal(size=(2,) + noise.shape)
                    .astype(np.float32))]
    trainer = DenoiseTrainer(_port(cfg, params), lr=LR,
                             accum_steps=accum_steps, device='cpu')
    return step, params, optax.adam(LR).init(params), trainer, batches


def _deltas(trainer, start):
    return {k: p.detach().numpy() - start[k]
            for k, p in trainer.model.named_parameters()}


@pytest.mark.parametrize('accum_steps', [1, 2])
def test_adam_steps_match_optax(accum_steps):
    """Three DenoiseTrainer steps against three make_sharded_train_step
    steps with optax.adam(1e-4) (and one accumulated step of two
    micro-batches against make_accumulating_train_step): the losses to
    RTOL_F32, and each parameter's total update to 1e-3 of its norm.
    Adam scales every entry's update to about the learning rate whatever
    the gradient's size, so an entry whose gradient is near zero carries
    the float32 summation noise into its update at full size; a per-leaf
    norm bounds the update rule without betting on single entries."""
    step, params, opt_state, trainer, batches = _adam_case(accum_steps)
    start = {k: v.detach().numpy().copy()
             for k, v in trainer.model.named_parameters()}
    for batch, noise in batches:
        params, opt_state, ref_loss, _ = step(
            params, opt_state, dict(batch, noise=noise),
            jax.random.PRNGKey(0))
        loss = float(trainer.train_step(batch, noise=noise))
        assert abs(loss - float(ref_loss)) <= RTOL_F32 * abs(float(ref_loss))
    ref = {k: v.numpy() - start[k] for k, v in
           convert_flax_params(params, trainer.model).items()}
    got = _deltas(trainer, start)
    moved = 0
    for key in ref:
        norm = np.linalg.norm(ref[key])
        moved += norm > 0
        assert np.linalg.norm(got[key] - ref[key]) <= 1e-3 * norm, key
    assert moved > len(ref) // 2


def test_loss_decreases_over_steps():
    batch, noise = _batch(seed=8, masked_tail=0)
    model = SE3TransformerModule(**TWIN, device='cpu',
                                 generator=torch.Generator().manual_seed(9))
    trainer = DenoiseTrainer(model, lr=1e-3, device='cpu')
    losses = [float(trainer.train_step(batch, noise=noise)) for _ in range(4)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_vector_output_is_equivariant():
    """out(x R^T) = out(x) R^T for the degree-1 (vector) output, float32,
    within the JAX package's 1e-4 bound (rotation in float64)."""
    batch, _ = _batch(seed=10)
    model = SE3TransformerModule(**dict(TWIN, depth=2), device='cpu',
                                 generator=torch.Generator().manual_seed(11))
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


def test_remat_policies_call_counts_and_gradients(monkeypatch):
    """Calls of the pairwise op's CPU implementation per training step:
    save_conv_outputs runs each pair once (the replay reads the saved
    output), remat_policy=None once more per trunk pair. The gradients
    equal those of the same model run without checkpointing, and no CPU
    call counts a kernel launch."""
    calls = []
    plain = kp.fused_pairwise_conv_bxf_plain
    monkeypatch.setattr(kp, 'fused_pairwise_conv_bxf_plain',
                        lambda *a: calls.append(1) or plain(*a))
    batch, noise = _batch(seed=12)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    depth, degrees = 2, TWIN['num_degrees']
    # conv_in: 1 -> 4 degrees; trunk: 2 convs of 4 -> 4 per block;
    # conv_out: 4 -> 2 degrees
    pairs = degrees + depth * 2 * degrees ** 2 + degrees * 2
    trunk_pairs = depth * 2 * degrees ** 2
    launches = (kp.fused_pairwise_conv_bxf.launches,
                kp.fused_pairwise_conv_bwd.launches_a,
                kp.fused_pairwise_conv_bwd.launches_b)
    grads = {}
    for policy, checkpointed, want in (
            ('save_conv_outputs', True, pairs), (None, True,
                                                 pairs + trunk_pairs),
            ('save_conv_outputs', False, pairs)):
        model = SE3TransformerModule(
            **dict(TWIN, depth=depth, remat_policy=policy), device='cpu',
            generator=torch.Generator().manual_seed(13))
        model.trunk.reversible = checkpointed
        calls.clear()
        denoise_loss(model, tb, torch.from_numpy(noise)).backward()
        assert len(calls) == want, (policy, checkpointed)
        grads[policy, checkpointed] = {k: p.grad for k, p in
                                       model.named_parameters()}
    plain_grads = grads['save_conv_outputs', False]
    for key in ('save_conv_outputs', True), (None, True):
        for name, g in grads[key].items():
            ref = plain_grads[name]
            assert (g is None and ref is None) or torch.equal(g, ref), \
                (key, name)
    assert (kp.fused_pairwise_conv_bxf.launches,
            kp.fused_pairwise_conv_bwd.launches_a,
            kp.fused_pairwise_conv_bwd.launches_b) == launches


def test_return_type_conventions():
    batch, _ = _batch(seed=14)
    args = [torch.from_numpy(batch[k]) for k in ('feats', 'coords', 'masks')]
    model = SE3TransformerModule(**TWIN, device='cpu')
    with torch.no_grad():
        both = model(*args)
        assert set(both) == {'0', '1'}
        assert both['0'].shape == (1, N) and both['1'].shape == (1, N, 3)
        assert torch.equal(model(*args, return_type=1), both['1'])
        wide = SE3TransformerModule(**dict(TWIN, reduce_dim_out=False),
                                    device='cpu')(*args, return_type=1)
        assert wide.shape == (1, N, 8, 3)
        scalar = SE3TransformerModule(
            **dict(TWIN, output_degrees=1, reduce_dim_out=False),
            device='cpu')(*args, return_type=1)
        assert scalar.shape == (1, N, 8)


def test_flagship_batch_draws_like_bench():
    """bench.py's flagship batch (bench.py:310-320), draw for draw."""
    batch = flagship_batch(np.random.RandomState(0), 2, 16, 8)
    rng = np.random.RandomState(0)
    feats = rng.normal(size=(2, 16, 8))
    coords = np.cumsum(rng.normal(size=(2, 16, 3)), axis=1)
    coords = coords - coords.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(batch['feats'], feats, rtol=1e-6)
    np.testing.assert_allclose(batch['coords'], coords, atol=1e-5)
    assert batch['masks'].all() and batch['masks'].shape == (2, 16)


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    model = SE3TransformerModule(**TWIN, device='cpu')
    with pytest.raises(RuntimeError):
        DenoiseTrainer(model)
