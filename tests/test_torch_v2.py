"""The SE3TransformerV2 family of the port (se3_transformer_torch.v2)
against the JAX package (se3_transformer_tpu.v2) on the CPU: the S2 grid
matrices and the separable S2 activation at degrees 2 and 6, V2ConvSE3
at num_degrees 3 and 5 with max_m None and 1, the module's output and
every gradient against jax.grad on converted parameters, the port's own
rotation equivariance at degrees 4, 6 and 8 and its zero-in, zero-out
padding, the mid-32 / P = 2 plain versions of kernels #3, A and B against
JAX's Pallas kernel and its backward in interpret mode, pairwise_limit's
mid-32 and P = 2 arms and refusals, and a train-save-serve round trip
through the port's trainer, checkpoints and engine with the family guard
both ways. Inputs come from a numpy seed; JAX runs pallas=False, float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu.kernels import pallas_pairwise as jpp
from se3_transformer_tpu.ops.fiber import Fiber as JaxFiber
from se3_transformer_tpu.so2 import frames as jfr
from se3_transformer_tpu.v2 import (
    SE3TransformerV2Module as JaxV2Module, SeparableS2Activation as JaxAct,
    V2ConvSE3 as JaxV2Conv, s2_grid_matrices as jax_grid_matrices,
)
from se3_transformer_tpu.v2.s2act import default_grid as jax_default_grid
from se3_transformer_torch import (
    CheckpointManager, DenoiseTrainer, InferenceEngine, ModelFamilyMismatch,
    SE3TransformerModule, convert_flax_params, flagship_batch,
)
from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.ops.fiber import Fiber
from se3_transformer_torch.so2 import frames as pfr
from se3_transformer_torch.so3 import rot
from se3_transformer_torch.v2 import (
    DEFAULT_V2_MID_DIM, SE3TransformerV2, SE3TransformerV2Module,
    SeparableS2Activation, V2ConvSE3, s2_grid_matrices, v2_band_rows,
)
from se3_transformer_torch.v2.s2act import default_grid

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

# float32 paths: the same products in other orders, relative to the
# largest magnitude of each output or gradient leaf
RTOL = 1e-5
# the model and its gradients, as the family's contract states them
MODEL_RTOL = 1e-4
# the equivariance bound of tests/test_equivariance.py and tests/test_v2.py
EQUIVARIANCE_ATOL = 1e-4


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _random_params(shapes, seed):
    """Every leaf drawn from a numpy seed: LayerNorm scales near 1, biases
    (bm blocks included) small and nonzero, the rest fan-in scaled."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name == 'scale':
            v = 1 + 0.1 * rng.normal(size=s.shape)
        elif name == 'bias' or name.startswith('bm'):
            v = 0.1 * rng.normal(size=s.shape)
        else:
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


# ---------------------------------------------------------------------- #
# the separable S2 activation
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('degree', range(1, 9))
def test_s2_grid_matrices_match_jax_and_invert(degree):
    """The port's host grid matrices are JAX's, and analysis . synthesis
    is the identity to float64 at every degree the family serves."""
    grid = default_grid(degree)
    assert grid == jax_default_grid(degree)
    Y, A = s2_grid_matrices(degree, *grid)
    Yj, Aj = jax_grid_matrices(degree, *grid)
    np.testing.assert_allclose(Y, Yj, rtol=0, atol=1e-13)
    np.testing.assert_allclose(A, Aj, rtol=0, atol=1e-13)
    np.testing.assert_allclose(A @ Y, np.eye(2 * degree + 1), atol=1e-12)


def _act_features(fiber, n=5, seed=0):
    rng = np.random.RandomState(seed)
    return {str(d): (0.3 * rng.normal(size=(1, n, c, 2 * d + 1))
                     ).astype(np.float32) for d, c in fiber}


@pytest.mark.parametrize('degree', [2, 6])
@pytest.mark.parametrize('grid_nonlin', [True, False])
def test_s2_activation_matches_jax(degree, grid_nonlin):
    """SeparableS2Activation on degrees 0, 1 and `degree`: the output on
    converted gate weights against the flax module's."""
    structure = {0: 4, 1: 3, degree: 4}
    x = _act_features(JaxFiber(structure), seed=degree)
    jact = JaxAct(JaxFiber(structure), grid_nonlin=grid_nonlin)
    params = _random_params(jax.eval_shape(lambda: jact.init(
        jax.random.PRNGKey(0), x))['params'], 1)
    want = jact.apply({'params': params}, x)
    act = SeparableS2Activation(Fiber(structure), grid_nonlin=grid_nonlin)
    act.load_state_dict(convert_flax_params(params, act))
    with torch.no_grad():
        got = act({k: torch.from_numpy(v) for k, v in x.items()})
    for key in want:
        assert _rel_err(got[key], want[key]) <= RTOL, key


def test_s2_activation_zero_in_zero_out():
    """Zero (pad) rows stay exactly zero through the gate and the grid
    round trip (gelu(0) = 0), and the real rows do not see them:
    the property that lets a padded forward agree with an unpadded one."""
    fiber = Fiber.create(7, 4)
    act = SeparableS2Activation(fiber)
    x = {k: torch.from_numpy(v) for k, v in
         _act_features(fiber, n=6, seed=5).items()}
    x_pad = {k: torch.cat([v, torch.zeros_like(v[:, :3])], dim=1)
             for k, v in x.items()}
    with torch.no_grad():
        out, out_pad = act(x), act(x_pad)
    for key in out:
        assert torch.equal(out_pad[key][:, 6:],
                           torch.zeros_like(out_pad[key][:, 6:]))
        # the real rows: the same values, up to the order of the grid sums
        torch.testing.assert_close(out_pad[key][:, :6], out[key],
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------- #
# the per-m convolution
# ---------------------------------------------------------------------- #
def _conv_inputs(degrees, channels=3, n=6, k=4, seed=7):
    rng = np.random.RandomState(seed)
    feats = {str(d): rng.normal(size=(1, n, channels, 2 * d + 1)).astype(
        np.float32) for d in range(degrees)}
    idx = rng.randint(0, n, (1, n, k))
    mask = rng.rand(1, n, k) > 0.2
    rel = rng.normal(size=(1, n, k, 3)).astype(np.float32)
    rel[0, 1, 2] = [0., 0., -1.]      # an edge along the pole
    return feats, idx, mask, rel, np.linalg.norm(rel, axis=-1)


@pytest.mark.parametrize('degrees', [3, 5])
@pytest.mark.parametrize('max_m', [None, 1])
def test_v2_conv_matches_jax(degrees, max_m):
    """V2ConvSE3 from degrees 0..degrees-1 to the same fiber (3 channels),
    pooled with self interaction: the output and the gradients of every
    parameter and input feature against jax.grad, on converted
    parameters."""
    feats, idx, mask, rel, dist = _conv_inputs(degrees)
    fiber = JaxFiber.create(degrees, 3)
    jconv = JaxV2Conv(fiber, fiber, max_m=max_m, pallas=False)
    frames = jfr.edge_frames(jnp.asarray(rel), degrees - 1)
    edge_info = (jnp.asarray(idx), jnp.asarray(mask), None)
    params = _random_params(jax.eval_shape(lambda: jconv.init(
        jax.random.PRNGKey(0), feats, edge_info, jnp.asarray(dist),
        frames))['params'], 8)

    def loss_jax(p, f):
        out = jconv.apply({'params': p}, f, edge_info, jnp.asarray(dist),
                          frames)
        return sum((o ** 2).sum() for o in out.values()), out
    (_, out_j), (gp, gf) = jax.jit(jax.value_and_grad(
        loss_jax, argnums=(0, 1), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in feats.items()})

    conv = V2ConvSE3(Fiber.create(degrees, 3), Fiber.create(degrees, 3),
                     max_m=max_m)
    conv.load_state_dict(convert_flax_params(params, conv))
    tf = {k: torch.from_numpy(v).requires_grad_() for k, v in feats.items()}
    out = conv(tf, (torch.from_numpy(idx), torch.from_numpy(mask), None),
               torch.from_numpy(dist),
               pfr.edge_frames(torch.from_numpy(rel), degrees - 1))
    sum((o ** 2).sum() for o in out.values()).backward()
    for d in out:
        assert _rel_err(out[d].detach(), out_j[d]) <= RTOL
        assert _rel_err(tf[d].grad, gf[d]) <= RTOL
    want = convert_flax_params(gp, conv)
    for name, p in conv.named_parameters():
        assert _rel_err(p.grad, want[name]) <= RTOL, name


@pytest.mark.parametrize('d_in,d_out,max_m,rows', [
    (0, 3, None, 1), (2, 3, None, 5), (3, 3, None, 7), (3, 3, 1, 3),
    (6, 6, 2, 5)])
def test_v2_band_rows_and_blocks(d_in, d_out, max_m, rows):
    """2 M + 1 band rows a pair, and the layer's per-m blocks follow it: a
    (d_in -> d_out) pair has M + 1 blocks wm{m}, K = C for m = 0 and 2 C
    past it, with mid 32 by default."""
    assert v2_band_rows(d_in, d_out, max_m) == rows
    conv = V2ConvSE3(Fiber({d_in: 3}), Fiber({d_out: 2}), max_m=max_m,
                     self_interaction=d_in == d_out)
    blocks = sorted((name, tuple(p.shape)) for name, p in
                    conv.named_parameters() if name.startswith('wm'))
    assert blocks == [(f'wm{m}_{d_in}_{d_out}',
                       (DEFAULT_V2_MID_DIM, 3 if m == 0 else 6, 2))
                      for m in range((rows - 1) // 2 + 1)]


# ---------------------------------------------------------------------- #
# the module
# ---------------------------------------------------------------------- #
N = 16
TWIN = dict(dim=8, depth=1, num_degrees=5, output_degrees=2,
            reduce_dim_out=True, num_neighbors=6)


def _batch(n=N, seed=0):
    """A chain with a pole pair (nodes 0 and 1 differ along z only), the
    last two nodes masked."""
    rng = np.random.RandomState(seed)
    coords = np.cumsum(rng.normal(size=(1, n, 3)), axis=1).astype(np.float32)
    coords[0, 1] = coords[0, 0] + [0., 0., 0.8]
    mask = np.ones((1, n), bool)
    mask[0, -2:] = False
    return (rng.normal(size=(1, n, 8)).astype(np.float32), coords, mask,
            rng.normal(size=(1, n, 3)).astype(np.float32))


@pytest.fixture(scope='module')
def twin():
    """The JAX module at TWIN with differentiable_coors, its loss on the
    vector output and the parameter and coordinate gradients, computed
    once."""
    cfg = dict(TWIN, differentiable_coors=True)
    feats, coords, mask, target = _batch()
    jm = JaxV2Module(pallas=False, **cfg)
    params = _random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coords, mask=mask,
        return_type=1))['params'], 9)

    def loss(p, c):
        out = jm.apply({'params': p}, feats, c, mask=mask, return_type=1)
        return ((out - target) ** 2).sum(), out
    (value, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(coords))
    return cfg, params, (float(value), np.asarray(out), grads)


def test_v2_module_matches_jax(twin):
    """The output, the loss, every parameter's gradient and the coordinate
    gradient (through the edge frames, a pole pair among them) against
    jax.grad, on converted weights."""
    cfg, params, (value, out_j, (gp, gc)) = twin
    feats, coords, mask, target = _batch()
    tm = SE3TransformerV2Module(**cfg, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    c = torch.from_numpy(coords).requires_grad_()
    out = tm(torch.from_numpy(feats), c, mask=torch.from_numpy(mask),
             return_type=1)
    loss = ((out - torch.from_numpy(target)) ** 2).sum()
    loss.backward()
    assert _rel_err(out.detach(), out_j) <= MODEL_RTOL
    assert abs(loss.item() - value) <= MODEL_RTOL * abs(value)
    assert c.grad.abs().max() > 0
    assert _rel_err(c.grad, gc) <= MODEL_RTOL
    want = convert_flax_params(gp, tm)
    for name, p in tm.named_parameters():
        # the degree-0 output's parameters: no gradient here, zeros in JAX
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert _rel_err(got, want[name]) <= MODEL_RTOL, name


def test_v2_module_surface(twin):
    """The family stamp, the JAX conventions (one output degree forces
    return_type 0, reduce_dim_out squeezes, return_pooled averages the
    real nodes) and the eager wrapper's lazy seeded init."""
    cfg, params, _ = twin
    feats, coords, mask, _ = _batch()
    tm = SE3TransformerV2Module(**cfg, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    f, c, m = (torch.from_numpy(a) for a in (feats, coords, mask))
    with torch.no_grad():
        outs = tm(f, c, mask=m)
        pooled = tm(f, c, mask=m, return_pooled=True)
    assert SE3TransformerV2Module.model_family == 'se3_v2'
    assert set(outs) == {'0', '1'}
    assert outs['0'].shape == (1, N) and outs['1'].shape == (1, N, 3)
    torch.testing.assert_close(pooled['1'], outs['1'][:, :-2].mean(1))
    wrapper = SE3TransformerV2(seed=3, device='cpu', **TWIN)
    assert wrapper.params is None and wrapper.model_family == 'se3_v2'
    with torch.no_grad():
        first = wrapper(f, c, m, return_type=1)
    again = SE3TransformerV2Module(
        **TWIN, device='cpu', generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        torch.testing.assert_close(again(f, c, mask=m, return_type=1), first)
    assert set(wrapper.params) == set(again.state_dict())


@pytest.mark.parametrize('degree', [4, 6, 8])
def test_v2_module_is_rotation_equivariant(degree):
    """f(x, R c) = f(x, c) R for the vector output with hidden degrees up
    to `degree` and the S2 grid nonlinearity on, rotation in float64 on the
    host."""
    feats, coords, mask, _ = _batch(n=12, seed=2)
    tm = SE3TransformerV2Module(
        dim=4, depth=1, num_degrees=degree + 1, output_degrees=2,
        reduce_dim_out=True, num_neighbors=5, device='cpu',
        generator=torch.Generator().manual_seed(degree))
    R = rot(0.3, -1.1, 2.2)

    def f(c):
        with torch.no_grad():
            return tm(torch.from_numpy(feats[:, :12, :4]),
                      torch.from_numpy(c.astype(np.float32)),
                      mask=torch.from_numpy(mask[:, :12]),
                      return_type=1).double().numpy()
    c64 = coords.astype(np.float64)
    out = f(c64)
    assert np.abs(out).max() > 1e-3
    assert np.abs(f(c64 @ R.T) - out @ R.T).max() <= EQUIVARIANCE_ATOL


def test_v2_padded_forward_matches_unpadded():
    """Pad nodes (masked, far from the chain, zero features) change nothing
    on the real nodes: no real node selects them, and what they carry
    stays zero through every activation."""
    feats, coords, mask, _ = _batch(seed=4)
    mask[:] = True
    tm = SE3TransformerV2Module(**TWIN, device='cpu',
                                generator=torch.Generator().manual_seed(5))
    pad = 5
    f_pad = np.concatenate([feats, np.zeros((1, pad, 8), np.float32)], 1)
    c_pad = np.concatenate([coords, 1e4 + np.arange(3 * pad, dtype=np.float32
                                                    ).reshape(1, pad, 3)], 1)
    m_pad = np.concatenate([mask, np.zeros((1, pad), bool)], 1)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (feats, coords)),
                 mask=torch.from_numpy(mask), return_type=1)
        out_pad = tm(*(torch.from_numpy(a) for a in (f_pad, c_pad)),
                     mask=torch.from_numpy(m_pad), return_type=1)
    assert _rel_err(out_pad[:, :N], out) <= RTOL


# ---------------------------------------------------------------------- #
# kernels #3, A and B at mid 32 and P = 2: the plain versions
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('O', [8, 64])
def test_mid32_two_row_plain_versions_match_the_tpu_kernels(O):
    """fused_pairwise_conv_plain and the backward's plain versions at V2's
    widths (mid 32, P = 2, K = 2C = 24) against the JAX package's Pallas
    kernel #3 and its backward (kernels A and B) in interpret mode."""
    rng = np.random.RandomState(O)
    E, IF, P = 20, 24, 2
    h = rng.normal(size=(E, DEFAULT_V2_MID_DIM)).astype(np.float32)
    w3 = (rng.normal(size=(DEFAULT_V2_MID_DIM, IF, O))
          / np.sqrt(DEFAULT_V2_MID_DIM)).astype(np.float32)
    b3 = (0.1 * rng.normal(size=(IF, O))).astype(np.float32)
    v2 = rng.normal(size=(E, P, IF)).astype(np.float32)
    g = rng.normal(size=(E, P, O)).astype(np.float32)
    want = jpp.fused_pairwise_conv(*map(jnp.asarray, (h, w3, v2, b3)),
                                   interpret=True)
    t = [torch.from_numpy(a) for a in (h, w3, v2, b3, g)]
    assert _rel_err(kp.fused_pairwise_conv_plain(*t[:4]), want) <= RTOL
    assert _rel_err(kp.fused_pairwise_conv(*t[:4]), want) <= RTOL
    want_b = jpp.fused_pairwise_conv_bwd(
        *map(jnp.asarray, (h, w3, v2, g, b3)), interpret=True)
    got_b = kp.fused_pairwise_conv_bwd(t[0], t[1], t[2], t[4], t[3])
    for name, got, ref in zip(('dh', 'dw3', 'dv2', 'db3'), got_b, want_b):
        assert _rel_err(got, ref) <= RTOL, name


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize('kernel,mid,O,P,kw,fits', [
    ('fwd', 32, 64, 1, dict(), True), ('fwd', 32, 64, 2, dict(), True),
    ('fwd', 32, 128, 2, dict(), True), ('fwd', 32, 8, 2, dict(), True),
    ('fwd', 32, 64, 2, dict(dtype=BF16), True),
    ('bwd', 32, 64, 2, dict(), True), ('bwd', 32, 8, 1, dict(), True),
    ('bwd', 32, 32, 2, dict(dtype=BF16), True),
    ('fwd', 128, 64, 2, dict(), True), ('bwd', 128, 16, 2, dict(), True),
    ('fwd', 32, 64, 2, dict(scaled=True), 'scaled arm'),
    ('fwd', 32, 64, 1, dict(operand_dtype=BF16), 'conv_bf16'),
    ('bwd', 32, 64, 1, dict(operand_dtype=BF16), 'conv_bf16'),
    ('fwd', 32, 64, 3, dict(), 'V2 rows'),
    ('bwd', 32, 8, 7, dict(), 'V2 rows'),
    ('fwd', 128, 64, 2, dict(scaled=True), 'scaled arm'),
    ('bwd', 128, 64, 2, dict(operand_dtype=BF16), 'conv_bf16'),
    ('fwd', 64, 64, 1, dict(), 'mids'), ('bwd', 16, 64, 2, dict(), 'mids'),
    ('fwd', 128, 64, 4, dict(), 'orders'), ('fwd', 32, 24, 2, dict(), 'O'),
    ('bxf', 32, 64, 3, dict(), 'mid = 128'),
    ('bx', 128, 64, 2, dict(), 'orders')])
def test_pairwise_limit_mid32_and_two_row_arms(kernel, mid, O, P, kw, fits):
    """#3, A and B take mid 32 (with V2's P = 1 or 2) beside 128 and P = 2
    beside the odd orders, wide and narrow O, either h dtype; the scaled
    and conv_bf16 arms refuse both, with a limit that names the arm, a
    mid-32 call of more rows is refused, and #1 and #2 stay at mid 128 and
    odd P."""
    limit = kp.pairwise_limit(kernel, mid, O, P, 3, **kw)
    if fits is True:
        assert limit is None
    else:
        assert limit is not None and 'exceeds' in limit and fits in limit


def test_mid32_wrapper_checks_follow_the_predicates():
    """The wrappers' checks take h's width: w3 must be [mid, IF, O] with
    mid h's, and a mid-32 call with bf16 V2 raises its limit."""
    h = torch.zeros(5, 32)
    assert kp._check_fwd(h, torch.zeros(32, 12, 64), torch.zeros(5, 2, 12),
                         torch.zeros(12, 64)) == (5, 12, 64, 2)
    with pytest.raises(ValueError, match=r'w3 must be \[32, IF, O\]'):
        kp._check_bwd(h, torch.zeros(128, 12, 64), torch.zeros(5, 2, 12),
                      torch.zeros(5, 2, 64), torch.zeros(12, 64))
    with pytest.raises(ValueError, match='conv_bf16'):
        kp._check_fwd(h, torch.zeros(32, 12, 64),
                      torch.zeros(5, 2, 12, dtype=BF16), torch.zeros(12, 64))


# ---------------------------------------------------------------------- #
# train, save, serve
# ---------------------------------------------------------------------- #
def test_v2_train_save_serve_and_family_guard(tmp_path):
    """Two Adam steps of the port's trainer on a degree-2 V2 model, a
    checkpoint stamped 'se3_v2', an engine restored from it that serves
    what the trained module computes (a bucket of the request's size); a
    v1 module refuses the checkpoint and a V2 module refuses a v1 one,
    before any tensor is read."""
    cfg = dict(dim=8, depth=1, num_degrees=3, output_degrees=2,
               reduce_dim_out=True, num_neighbors=5)
    model = SE3TransformerV2Module(**cfg, device='cpu')
    trainer = DenoiseTrainer(model, device='cpu')
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(v)
             for k, v in flagship_batch(rng, 1, 12, 8).items()}
    losses = [float(trainer.train_step(batch)) for _ in range(2)]
    assert all(np.isfinite(losses))
    v2_dir, v1_dir = str(tmp_path / 'v2'), str(tmp_path / 'v1')
    with CheckpointManager(v2_dir, model_family=model.model_family) as cm:
        cm.save(trainer.step_count, (trainer.params, trainer.opt_state,
                                     trainer.step_count))
    engine = InferenceEngine.from_checkpoint(
        SE3TransformerV2Module(**cfg, device='cpu',
                               generator=torch.Generator().manual_seed(1)),
        v2_dir, buckets=(12,), device='cpu', return_type=1)
    assert engine.model_family == 'se3_v2'
    got = engine.predict(batch['feats'][0].numpy(),
                         batch['coords'][0].numpy())
    with torch.no_grad():
        want = model(batch['feats'], batch['coords'],
                     mask=batch['masks'], return_type=1)[0]
    assert _rel_err(got, want) <= RTOL
    v1 = SE3TransformerModule(dim=8, depth=1, num_degrees=2,
                              output_degrees=2, reduce_dim_out=True,
                              num_neighbors=5, device='cpu')
    with pytest.raises(ModelFamilyMismatch):
        InferenceEngine.from_checkpoint(v1, v2_dir, buckets=(12,),
                                        device='cpu', return_type=1)
    with CheckpointManager(v1_dir, model_family=v1.model_family) as cm:
        cm.save(1, (v1.state_dict(), {}, 1))
    with pytest.raises(ModelFamilyMismatch):
        InferenceEngine.from_checkpoint(
            SE3TransformerV2Module(**cfg, device='cpu'), v1_dir,
            buckets=(12,), device='cpu', return_type=1)
