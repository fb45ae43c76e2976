"""The kNN-free global attention of the port (kernels/flash.py global mode,
attention_mode='global') against the JAX package on the CPU: the plain
global stream against the JAX XLA stream and the interpret-mode Pallas
kernel (node mask, the [null, self] prefix slots, n = 37 in ragged row
chunks, d_out 0 and 1), its recompute backward against jax.grad, the
assembly model's twin (streaming and materialized arms, output and
gradients), its rotation equivariance, the engine serving token sequences
at a bucket, and every field the JAX _global_forward refuses. Inputs and
parameters are made from a seed with numpy; weights come over by
convert_flax_params."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.kernels import pallas_flash as pf
from se3_transformer_torch import (
    InferenceEngine, SE3TransformerModule, convert_flax_params,
)
from se3_transformer_torch.kernels import flash as kf
from se3_transformer_torch.so3 import rot

# one intra-op thread: these models are tiny, and pytest-xdist's workers
# would otherwise oversubscribe the CPU with spinning thread pools
torch.set_num_threads(1)

# the plain stream vs the JAX one: the same float32 products in other orders
RTOL = 1e-5
# the model and its gradients: relative to the largest magnitude
MODEL_RTOL = 1e-4
# the JAX package's own global bar (tests/test_assembly.py)
EQ_TOL = 1e-5

HEADS, DIM_HEAD, MID = 2, 8, 128
PAIRS = ((0, 8), (1, 8))
O = HEADS * DIM_HEAD
SCALE = DIM_HEAD ** -0.5


def _inputs(d_out, n=37, pad=5, seed=0):
    """numpy operands of one call: random-walk coordinates with the last
    `pad` nodes at the origin and masked (as a padded bucket), two prefix
    slots, trunk parameters of the served widths."""
    rng = np.random.RandomState(seed + d_out)
    P = 2 * d_out + 1
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in PAIRS)

    def f(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    def trunk():
        return (f(1, MID), f(MID, s=0.1), 1 + f(MID, s=0.1), f(MID, s=0.1),
                f(MID, MID, s=MID ** -0.5), f(MID, s=0.1), 1 + f(MID, s=0.1),
                f(MID, s=0.1))
    coords = np.cumsum(f(1, n, 3), axis=1)
    coords[:, n - pad:] = 0.
    w = (MID * IF) ** -0.5
    return dict(q=f(1, n, HEADS, DIM_HEAD * P),
                xs=tuple(f(1, n, c, 2 * d + 1) for d, c in PAIRS),
                coords=coords, rp_v=trunk(), rp_k=trunk(),
                wv=f(MID, IF, O, s=w), bv=f(IF, O, s=0.1),
                wk=f(MID, IF, O, s=w), bk=f(IF, O, s=0.1),
                node_mask=(np.arange(n) < n - pad)[None],
                prefix_k=f(1, n, 2, O * P), prefix_v=f(1, n, 2, O * P))


def _kw(d_out):
    return dict(pairs=PAIRS, d_out=d_out, heads=HEADS, kv_heads=HEADS,
                scale=SCALE)


def _run_jax(ops, d_out, **over):
    j = {k: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
             else jnp.asarray(v)) for k, v in ops.items()}
    return pf.flash_global_attention(
        j['q'], j['xs'], j['coords'], j['rp_v'], j['wv'], j['bv'],
        rp_k=j['rp_k'], wk=j['wk'], bk=j['bk'], node_mask=j['node_mask'],
        prefix_k=j['prefix_k'], prefix_v=j['prefix_v'], **_kw(d_out), **over)


def _torch(ops):
    return {k: (tuple(torch.from_numpy(np.asarray(t)) for t in v)
                if isinstance(v, tuple) else torch.from_numpy(np.asarray(v)))
            for k, v in ops.items()}


def _run_port(t, d_out, **over):
    return kf.flash_global_attention(
        t['q'], t['xs'], t['coords'], t['rp_v'], t['wv'], t['bv'],
        rp_k=t['rp_k'], wk=t['wk'], bk=t['bk'], node_mask=t['node_mask'],
        prefix_k=t['prefix_k'], prefix_v=t['prefix_v'], **_kw(d_out),
        **over)


def _close(out, ref, rtol=RTOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize('interpret', [False, True])
@pytest.mark.parametrize('d_out', [0, 1])
def test_plain_matches_jax_global(d_out, interpret):
    """n = 37 in two row chunks (19 + 18), the last 5 nodes padded at the
    origin and masked, the [null, self] prefix: against the JAX XLA stream
    (pallas=False) and the Pallas kernel in interpret mode (online softmax
    over kv blocks)."""
    ops = _inputs(d_out)
    ref = _run_jax(ops, d_out, pallas=False, interpret=interpret)
    _close(_run_port(_torch(ops), d_out), ref)


@pytest.mark.parametrize('d_out', [0, 1])
def test_materialized_arm_is_the_stream(d_out):
    """materialize=True (one chunk, plain autograd) computes the stream's
    function; exclude_self=False lets every node see itself."""
    t = _torch(_inputs(d_out, seed=3))
    for over in (dict(), dict(exclude_self=False)):
        _close(_run_port(t, d_out, materialize=True, **over),
               _run_port(t, d_out, **over).numpy())
    assert not torch.allclose(_run_port(t, d_out),
                              _run_port(t, d_out, exclude_self=False))


def test_replay_backward_matches_jax_grad():
    """The op's backward (the plain stream replayed chunk by chunk under
    autograd) against jax.grad of the JAX custom_vjp, for q, a node
    feature, the coordinates, a trunk's Dense_1, wv, bk and the prefix."""
    d_out = 1
    ops = _inputs(d_out, seed=5)
    names = ('q', 'x1', 'coords', 'w2_v', 'wv', 'bk', 'prefix_k')

    def loss_jax(q, x1, coords, w2_v, wv, bk, pk):
        j = {k: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
                 else jnp.asarray(v)) for k, v in ops.items()}
        rp_v = j['rp_v'][:4] + (w2_v,) + j['rp_v'][5:]
        out = pf.flash_global_attention(
            q, (j['xs'][0], x1), coords, rp_v, wv, j['bv'], rp_k=j['rp_k'],
            wk=j['wk'], bk=bk, node_mask=j['node_mask'], prefix_k=pk,
            prefix_v=j['prefix_v'], pallas=False, **_kw(d_out))
        return (out ** 2).sum()
    vals = [ops['q'], ops['xs'][1], ops['coords'], ops['rp_v'][4],
            ops['wv'], ops['bk'], ops['prefix_k']]
    ref = jax.jit(jax.grad(loss_jax, argnums=tuple(range(7))))(
        *map(jnp.asarray, vals))
    t = _torch(ops)
    leaves = [torch.from_numpy(v.copy()).requires_grad_() for v in vals]
    t.update(q=leaves[0], coords=leaves[2], wv=leaves[4], bk=leaves[5],
             prefix_k=leaves[6])
    t['xs'] = (t['xs'][0], leaves[1])
    t['rp_v'] = t['rp_v'][:4] + (leaves[3],) + t['rp_v'][5:]
    (_run_port(t, d_out) ** 2).sum().backward()
    for name, leaf, want in zip(names, leaves, ref):
        assert leaf.grad is not None, name
        _close(leaf.grad, want, MODEL_RTOL)


# kernel 7g's products (csrc/flash_global.cu): both trunks' Dense_1 and
# the k/v radial products run on the tensor cores as bf16 passes over
# operands split into hi + lo (hi = bf16(t), lo = bf16(t - hi)), each pass a
# product of bf16 values (exact in float32) summed in float32
def _bf16_split(t):
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _passes(a, b, passes):
    """a @ b as the kernel's bf16 passes: a_hi.b_hi + a_hi.b_lo + a_lo.b_hi
    (passes=3), or a_hi.b_hi alone (passes=1)."""
    (a_hi, a_lo), (b_hi, b_lo) = _bf16_split(a), _bf16_split(b)
    terms = ((a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi))[:passes]
    return sum(torch.matmul(x, y) for x, y in terms)


def _kernel_stream(monkeypatch, t, d_out, passes):
    """The plain stream with Dense_1 and the radial products replaced by
    their bf16 passes: the kernel's arithmetic, on the CPU."""
    def radial_apply(x, rp):
        w1, b1, s1, o1, w2, b2, s2, o2 = rp
        h = kf._gelu_tanh(kf._radial_ln(torch.matmul(x, w1) + b1, s1, o1))
        h = _passes(h, w2, passes) + b2
        return kf._gelu_tanh(kf._radial_ln(h, s2, o2))

    def kv_block(pairs, d_out, xg, h, sh, w3, b3):
        segs = []
        for (d_in, _), x in zip(pairs, xg):
            lo, hi = abs(d_in - d_out), d_in + d_out
            T = kf._pair_cg_tensor(d_in, d_out, x.device)
            y = sh[..., lo * lo:(hi + 1) * (hi + 1)]
            basis = torch.einsum('...s,spqf->...pqf', y, T)
            v2 = torch.einsum('...pqf,...cq->...pcf', basis, x)
            segs.append(v2.reshape(*v2.shape[:-2], -1))
        z = torch.cat(segs, dim=-1)
        R = _passes(h.float(), w3.reshape(w3.shape[0], -1), passes)
        R = R.reshape(*R.shape[:-1], *w3.shape[1:]) + b3
        return torch.einsum('...pi,...io->...po', z, R).transpose(-1, -2)

    with monkeypatch.context() as m:
        m.setattr(kf, '_radial_apply', radial_apply)
        m.setattr(kf, '_kv_block', kv_block)
        return _run_port(t, d_out)


@pytest.mark.parametrize('d_out', [0, 1])
def test_kernel_bf16_passes_match_float32_and_jax(monkeypatch, d_out):
    """Three bf16 passes for Dense_1 and three for the radial products,
    chained through LayerNorm, GELU and the online softmax, at the assembly
    widths (n = 64, 5 padded): within RTOL of max|plain| of the float32
    plain stream and of the JAX XLA stream."""
    ops = _inputs(d_out, n=64, seed=9)
    t = _torch(ops)
    out = _kernel_stream(monkeypatch, t, d_out, passes=3).numpy()
    _close(out, _run_port(t, d_out).numpy())
    _close(out, _run_jax(ops, d_out, pallas=False))


def test_one_bf16_pass_misses_the_float32_stream(monkeypatch):
    """bf16 hi operands alone (one pass) are not within RTOL: the lo
    passes are needed."""
    d_out = 1
    t = _torch(_inputs(d_out, n=64, seed=9))
    out = _kernel_stream(monkeypatch, t, d_out, passes=1).numpy()
    ref = _run_port(t, d_out).numpy()
    assert np.abs(out - ref).max() > RTOL * np.abs(ref).max()


def test_unported_options_raise():
    """An unknown contraction arm refuses; tied keys (no wk) take no
    rp_k."""
    t = _torch(_inputs(0))
    with pytest.raises(ValueError, match='unknown contraction arm'):
        _run_port(t, 0, arm='banded')
    with pytest.raises(ValueError, match='tied'):
        kf.flash_global_attention(t['q'], t['xs'], t['coords'], t['rp_v'],
                                  t['wv'], t['bv'], rp_k=t['rp_k'],
                                  **_kw(0))


# ---------------------------------------------------------------------- #
# the assembly model (tests/test_assembly.py's keyword set)
# ---------------------------------------------------------------------- #
KW = dict(num_tokens=24, dim=8, depth=1, num_degrees=2, output_degrees=2,
          reduce_dim_out=True, attend_self=True, use_null_kv=True, heads=2,
          dim_head=8, attention_mode='global')
N, PAD = 61, 5


def _batch(seed=0, n=N, pad=PAD):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 24, (1, n))
    coords = np.cumsum(rng.normal(size=(1, n, 3)), axis=1).astype(np.float32)
    coords[:, n - pad:] = 0.
    return tokens, coords, (np.arange(n) < n - pad)[None]


def _random_params(shapes, seed):
    """Seeded values for every leaf, the null slots included (they start
    at zero in both packages)."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name.startswith('scale'):
            v = 1 + 0.1 * rng.normal(size=s.shape)
        elif name == 'bias' or name.startswith(('b3_', 'null_')):
            v = 0.1 * rng.normal(size=s.shape)
        else:
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_model(batch, seed=1, **over):
    jm = JaxModule(pallas=False, **dict(KW, **over))
    tokens, coords, mask = batch
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), tokens, coords, mask=mask,
        return_type=1))['params']
    return jm, _random_params(shapes, seed)


def _port_model(params, **over):
    tm = SE3TransformerModule(**dict(KW, **over), device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    return tm


@pytest.mark.parametrize('materialize', [False, True])
def test_global_twin_matches_jax(materialize):
    """The vector output (return_type=1) of n = 61 nodes, 5 padded, on
    converted weights; the streaming arm and global_materialize=True."""
    batch = _batch()
    jm, params = _jax_model(batch)
    ref = np.asarray(jax.jit(lambda p: jm.apply(
        {'params': p}, *batch[:2], mask=batch[2], return_type=1))(params))
    tm = _port_model(params, global_materialize=materialize)
    assert tm.fused_attention == (False,)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in batch), return_type=1)
    assert out.shape == (1, N, 3)
    _close(out, ref, MODEL_RTOL)


def test_global_twin_gradients_match_jax():
    """Every parameter's gradient of a loss on the vector output, through
    the replay backward, against jax.grad of the JAX model."""
    batch = _batch(seed=2, n=40)
    jm, params = _jax_model(batch, seed=3)
    target = np.random.RandomState(4).normal(size=(1, 40, 3)) \
        .astype(np.float32)

    def loss(p):
        out = jm.apply({'params': p}, *batch[:2], mask=batch[2],
                       return_type=1)
        return ((out - target) ** 2).sum()
    ref = jax.jit(jax.grad(loss))(params)
    tm = _port_model(params)
    out = tm(*(torch.from_numpy(a) for a in batch), return_type=1)
    ((out - torch.from_numpy(target)) ** 2).sum().backward()
    want = {k: v.numpy() for k, v in convert_flax_params(ref, tm).items()}
    for name, p in tm.named_parameters():
        # with depth 1 the degree-0 attention never reaches the vector
        # output: no gradient here, zeros in JAX
        got = np.zeros(tuple(p.shape), np.float32) if p.grad is None \
            else p.grad.numpy()
        scale = np.abs(want[name]).max()
        assert np.abs(got - want[name]).max() \
            <= MODEL_RTOL * max(scale, 1e-30), name


def test_global_equivariance():
    """tests/test_assembly.py's bar, computed as its equivariance_l2: the
    max per-node L2 error of f(R c) against f(c) R, the rotation applied
    in float64 on the host."""
    tokens, coords, mask = _batch(seed=5, n=29, pad=0)
    # the flax-scheme init, as the JAX test takes it: the null slots of
    # degree 1 start at zero (nonzero ones would add a vector that does
    # not rotate)
    tm = SE3TransformerModule(**KW, device='cpu',
                              generator=torch.Generator().manual_seed(6))
    R = rot(0.37, 1.12, -0.64)
    c64 = coords.astype(np.float64)

    def f(c):
        with torch.no_grad():
            return tm(torch.from_numpy(tokens),
                      torch.from_numpy(c.astype(np.float32)),
                      torch.from_numpy(mask), return_type=1).double().numpy()
    err = np.sqrt(((f(c64 @ R) - f(c64) @ R) ** 2).sum(-1)).max()
    assert err < EQ_TOL


def test_engine_serves_tokens_at_a_bucket():
    """Integer token requests pad to the bucket with token 0 and mask
    False; return_type defaults to 1; the real rows equal the unpadded
    forward (padded columns are masked, and every other op is per node)."""
    batch = _batch(seed=7, n=50, pad=0)
    _, params = _jax_model(batch, seed=8)
    tm = _port_model(params)
    engine = InferenceEngine(tm, buckets=(64,), device='cpu')
    tokens, coords = batch[0][0], batch[1][0]
    out = engine.predict(tokens, coords)
    assert out.shape == (50, 3)
    with torch.no_grad():
        ref = tm(torch.from_numpy(batch[0]), torch.from_numpy(batch[1]),
                 return_type=1)[0].numpy()
    _close(out, ref, RTOL)
    assert engine.stats()['rows_served'] == {'64': 1}


@pytest.mark.parametrize('field,value', [
    ('attend_sparse_neighbors', True), ('causal', True),
    ('num_adj_degrees', 1), ('edge_dim', 4), ('use_egnn', True),
    ('rotary_position', True), ('rotary_rel_dist', True),
    ('linear_proj_keys', True), ('fourier_encode_dist', True),
    ('num_conv_layers', 1), ('fuse_pairwise', True),
    ('remat_policy', 'save_conv_outputs'), ('output_degrees', 3),
    ('attention_mode', 'ring')])
def test_global_refuses_what_jax_asserts(field, value):
    """Each assertion of the JAX _global_forward (and an unknown mode) is
    an error at construction."""
    cfg = dict(KW, **{field: value})
    if field == 'remat_policy':
        cfg['reversible'] = True
    with pytest.raises(ValueError):
        SE3TransformerModule(**cfg, device='cpu')
