"""The fused attention of the port (kernels/attention.py, the
pallas_attention=True path) against the JAX package on the CPU: the plain
forward against attention_reference and the interpret-mode Pallas kernel,
the plain backward against jax.vjp, the custom op's autograd, and a
flagship_fast twin with pallas_attention=True (vector head: output, loss and
every gradient) against the JAX model's einsum path under converted
weights. Inputs and parameters are made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.kernels import pallas_attention as pa
from se3_transformer_torch import (
    SE3TransformerModule, convert_flax_params, denoise_loss,
)
from se3_transformer_torch.kernels import attention as ka

# one intra-op thread: these models are tiny, and pytest-xdist's workers
# would otherwise oversubscribe the CPU with spinning thread pools
torch.set_num_threads(1)

# plain version vs JAX: the same float32 products in other orders
RTOL = 1e-5


def _case(BH=4, BKV=4, n=13, J=6, D=10, masked=True, full_row=False, seed=0):
    """q, k, v, mask, g (numpy float32 / bool) and heads: `BH // BKV` query
    heads per kv head, `full_row` masks every slot of one row."""
    rng = np.random.RandomState(seed)
    f = [rng.normal(size=s).astype(np.float32)
         for s in ((BH, n, D), (BKV, n, J, D), (BKV, n, J, D), (BH, n, D))]
    heads = BH // 2          # two batch elements
    mask = None
    if masked:
        mask = rng.rand(2, n, J) > 0.3
        if full_row:
            mask[1, 5] = False
    return f[0], f[1], f[2], mask, f[3], heads


CASES = {
    'masked': dict(),
    'no_mask': dict(masked=False),
    'full_row': dict(full_row=True),
    'padded_n': dict(n=21, J=33),
    'group2': dict(BH=4, BKV=2, full_row=True),
}
SCALE = 0.37


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('name', list(CASES))
def test_plain_forward_matches_jax_reference(name):
    q, k, v, mask, _, heads = _case(**CASES[name])
    ref = np.asarray(pa.attention_reference(q, k, v, mask, SCALE))
    out = ka.fused_attention_plain(*_torch(q, k, v, mask), heads, SCALE)
    assert out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize('name', ['full_row', 'group2'])
def test_plain_forward_matches_interpret_kernel(name):
    """The JAX Pallas kernel in interpret mode (padding n to its block with
    True mask rows)."""
    q, k, v, mask, _, heads = _case(**CASES[name])
    ref = np.asarray(pa.fused_attention(q, k, v, mask, heads, SCALE, True))
    out = ka.fused_attention_plain(*_torch(q, k, v, mask), heads, SCALE)
    assert np.abs(out.numpy() - ref).max() <= RTOL * np.abs(ref).max()


def test_fully_masked_row_is_uniform_average():
    q, k, v, mask, _, heads = _case(full_row=True)
    out = ka.fused_attention_plain(*_torch(q, k, v, mask), heads, SCALE)
    # row 5 of batch element 1: bh = heads .. 2*heads - 1
    uni = v[heads:2 * heads, 5].mean(axis=1)
    assert np.abs(out[heads:2 * heads, 5].numpy() - uni).max() <= 1e-6


def _assert_close(got, want):
    for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
        b = np.asarray(b)
        a = a.detach().numpy()
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= RTOL * np.abs(b).max(), name


@pytest.mark.parametrize('name', ['masked', 'no_mask', 'padded_n'])
def test_plain_backward_matches_jax_grad(name):
    """dq, dk, dv against jax.vjp of attention_reference (rows with a valid
    slot: there the kernel's formula is the softmax's derivative)."""
    q, k, v, mask, g, heads = _case(**CASES[name])
    _, vjp = jax.vjp(lambda a, b, c: pa.attention_reference(
        a, b, c, mask, SCALE), q, k, v)
    got = ka.fused_attention_bwd_plain(*_torch(q, k, v, mask, g), heads, SCALE)
    _assert_close(got, vjp(jnp.asarray(g)))


@pytest.mark.parametrize('name', ['full_row', 'group2'])
def test_plain_backward_matches_jax_kernel_vjp(name):
    """dq, dk, dv against jax.vjp of the JAX fused_attention (its custom
    VJP, the interpret-mode backward kernel): the kernel's formula also on
    a fully masked row, where it differs from differentiating the
    reference (whose masked slots have no derivative), and dk/dv summed
    over a group of two query heads."""
    q, k, v, mask, g, heads = _case(**CASES[name])
    _, vjp = jax.vjp(lambda a, b, c: pa.fused_attention(
        a, b, c, mask, heads, SCALE, True), q, k, v)
    got = ka.fused_attention_bwd_plain(*_torch(q, k, v, mask, g), heads, SCALE)
    _assert_close(got, vjp(jnp.asarray(g)))


def test_custom_op_autograd_runs_the_backward():
    """The op's gradients are the backward's outputs, and the CPU path
    counts no launch."""
    q, k, v, mask, g, heads = _case(**CASES['group2'])
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    before = (ka.fused_attention_fwd.launches, ka.fused_attention_bwd.launches)
    out = ka.fused_attention(tq, tk, tv, torch.from_numpy(mask), heads, SCALE)
    out.backward(torch.from_numpy(g))
    want = ka.fused_attention_bwd_plain(*_torch(q, k, v, mask, g), heads,
                                        SCALE)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(got, ref)
    assert (ka.fused_attention_fwd.launches,
            ka.fused_attention_bwd.launches) == before


# ---------------------------------------------------------------------- #
# the model: flagship_fast's fields with pallas_attention=True
# ---------------------------------------------------------------------- #
TWIN = dict(dim=8, depth=1, num_degrees=4, heads=8, dim_head=8,
            attend_self=True, num_neighbors=5, valid_radius=1e5,
            shared_radial_hidden=True, fuse_basis=True, reversible=True,
            remat_policy='save_conv_outputs', output_degrees=2,
            reduce_dim_out=True, radial_bf16=False)
N = 14
# float32 trunk: summation order only (relative to each leaf's largest
# magnitude)
MODEL_RTOL = 1e-4


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    batch = dict(feats=rng.normal(size=(1, N, 8)).astype(np.float32),
                 coords=(rng.normal(size=(1, N, 3)) * 2).astype(np.float32),
                 masks=np.ones((1, N), bool))
    batch['masks'][0, -3:] = False
    return batch, rng.normal(size=(1, N, 3)).astype(np.float32)


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
    def loss_fn(params, batch):
        noised = batch['coords'] + batch['noise']
        out = jm.apply({'params': params}, batch['feats'], noised,
                       mask=batch['masks'], return_type=1)
        sq = (((noised + out) - batch['coords']) ** 2).sum(-1)
        m = batch['masks']
        return jnp.where(m, sq, 0.).sum() / jnp.maximum(m.sum(), 1), out
    return loss_fn


@pytest.fixture(scope='module')
def twin():
    """(jax (out, loss, grads), port (out, loss, grads)): the JAX model on
    its einsum attention, the port with pallas_attention=True."""
    batch, noise = _batch()
    jm = JaxModule(**dict(TWIN, pallas_attention=False))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch['feats'], batch['coords'],
        mask=batch['masks'], return_type=1))['params']
    params = _random_params(shapes, seed=1)
    (loss, out), grads = jax.jit(jax.value_and_grad(
        _jax_loss(jm), has_aux=True))(params, dict(batch, noise=noise))
    tm = SE3TransformerModule(**dict(TWIN, pallas_attention=True),
                              device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    ref_grads = {k: v.numpy() for k, v in
                 convert_flax_params(grads, tm).items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tnoise = torch.from_numpy(noise)
    tout = tm(tb['feats'], tb['coords'] + tnoise, mask=tb['masks'],
              return_type=1)
    tloss = denoise_loss(tm, tb, tnoise)
    tloss.backward()
    port_grads = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
                  else p.grad.numpy() for k, p in tm.named_parameters()}
    return ((np.asarray(out), float(loss), ref_grads),
            (tout.detach().numpy(), tloss.item(), port_grads))


def test_twin_output_and_loss_match_jax(twin):
    (ref, ref_loss, _), (out, loss, _) = twin
    assert out.shape == ref.shape == (1, N, 3)
    assert np.abs(out - ref).max() <= MODEL_RTOL * np.abs(ref).max()
    assert abs(loss - ref_loss) <= MODEL_RTOL * abs(ref_loss)


def test_twin_gradients_match_jax_grad(twin):
    (_, _, ref), (_, _, got) = twin
    assert set(got) == set(ref)
    for key in ref:
        assert np.isfinite(got[key]).all(), key
        scale = np.abs(ref[key]).max()
        assert np.abs(got[key] - ref[key]).max() <= MODEL_RTOL * scale, key


def test_attention_calls_per_forward_and_step(monkeypatch):
    """The fused op's CPU calls: one per degree and block in a forward;
    in a save_conv_outputs training step the checkpoint replay runs the
    forward again (the policy saves only the pairwise convs), and the
    backward once."""
    calls = {'fwd': 0, 'bwd': 0}
    fwd, bwd = ka.fused_attention_plain, ka.fused_attention_bwd_plain

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(ka, 'fused_attention_plain', count('fwd', fwd))
    monkeypatch.setattr(ka, 'fused_attention_bwd_plain', count('bwd', bwd))
    depth, degrees = 2, TWIN['num_degrees']
    model = SE3TransformerModule(**dict(TWIN, depth=depth,
                                        pallas_attention=True),
                                 device='cpu',
                                 generator=torch.Generator().manual_seed(2))
    batch, noise = _batch(seed=3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        model(tb['feats'], tb['coords'], mask=tb['masks'])
    assert calls == {'fwd': depth * degrees, 'bwd': 0}
    calls.update(fwd=0)
    denoise_loss(model, tb, torch.from_numpy(noise)).backward()
    assert calls == {'fwd': 2 * depth * degrees, 'bwd': depth * degrees}


def test_pallas_attention_takes_none_false_true():
    for value in (None, False, True):
        SE3TransformerModule(**dict(TWIN, pallas_attention=value),
                             device='cpu')
    with pytest.raises(ValueError):
        SE3TransformerModule(**dict(TWIN, pallas_attention='auto'),
                             device='cpu')
