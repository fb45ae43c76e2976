"""Edges, sparse adjacency and causal masking in the port against the JAX
package on the CPU: expand_adjacency, sparse_neighbor_mask and
select_neighbors (causal, neighbor_mask, bonded priority) on the same
indices, masks and distances; chain_adjacency against the JAX numpy
fallback; a reduced molecular_edges twin (output, property_loss and every
gradient against jax.grad), toy_denoise at its own widths, fuse_pairwise
with edges (the program's h and the block output against the JAX stream),
a causal model with num_positions, a neighbor_mask and a pooled output,
the engine's chain adjacency against module.apply(..., adj_mat=chain), the
converter on the new embeddings, and every refusal. Parameters and inputs
are made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.basis import get_basis as jax_get_basis
from se3_transformer_tpu.kernels.pallas_flash import \
    flash_sh_payload as jax_sh_payload
from se3_transformer_tpu.native import loader as jax_loader
from se3_transformer_tpu.ops import neighbors as jax_nb
from se3_transformer_tpu.ops.attention import \
    AttentionBlockSE3 as JAttentionBlock
from se3_transformer_tpu.ops.conv import ConvSE3 as JConv
from se3_transformer_tpu.ops.fiber import Fiber as JFiber
from se3_transformer_tpu.training.recipes import \
    molecular_edges as jax_molecular_edges
from se3_transformer_tpu.training.recipes import toy_denoise as jax_toy
from se3_transformer_torch import (
    AttentionBlockSE3, ConvSE3, DenoiseTrainer, Fiber, InferenceEngine,
    SE3TransformerModule, chain_adjacency, convert_flax_params, get_basis,
    molecular_batch, molecular_edges, property_loss, toy_denoise,
)
from se3_transformer_torch.kernels.flash import flash_sh_payload
from se3_transformer_torch.models.se3_transformer import _JAX_ONLY_DEFAULTS
from se3_transformer_torch.ops import neighbors as t_nb

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

# float32 throughout: summation order only
RTOL_F32 = 1e-4
# molecular_edges at reduced width: dim 8, 2 heads of 8, n 24 (2-hop chain
# adjacency: at most 4 bonds a row, under the recipe's 6, so the jitter
# picks nothing and the port's bits need not be JAX's)
MOLECULAR_TWIN = dict(heads=2, dim_head=8)
N_MOL = 24


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


# ---------------------------------------------------------------------- #
# the neighbor functions
# ---------------------------------------------------------------------- #
def _adjacency(rng, b, n, p=0.15, diagonal=False):
    adj = rng.rand(b, n, n) < p
    adj = adj | adj.transpose(0, 2, 1)
    idx = np.arange(n)
    adj[:, idx, idx] = diagonal
    return adj


@pytest.mark.parametrize('degrees,diagonal', [(1, False), (2, False),
                                              (3, True)])
def test_expand_adjacency_matches_jax(degrees, diagonal):
    adj = _adjacency(np.random.RandomState(degrees), 2, 11,
                     diagonal=diagonal)
    ref = jax_nb.expand_adjacency(jnp.asarray(adj), degrees)
    out = t_nb.expand_adjacency(torch.from_numpy(adj), degrees)
    for r, o in zip(ref, out):
        assert np.array_equal(o.numpy(), np.asarray(r))
    assert out[1].max() == (degrees if degrees > 1 else 1)


@pytest.mark.parametrize('num_sparse,with_noise', [(3, True), (3, False),
                                                   (7, True)])
def test_sparse_neighbor_mask_matches_jax(num_sparse, with_noise):
    """The same bonded subset from the same noise, including rows with
    more bonds than the cap (the top-k picks among them by value, or by
    index without noise)."""
    rng = np.random.RandomState(num_sparse)
    b, n = 2, 12
    adj = rng.rand(b, n, n - 1) < 0.5
    adj[0, 0] = True                        # a row over every cap
    noise = rng.uniform(-0.01, 0.01, size=adj.shape).astype(np.float32) \
        if with_noise else None
    ref = jax_nb.sparse_neighbor_mask(
        jnp.asarray(adj), num_sparse,
        None if noise is None else jnp.asarray(noise))
    out = t_nb.sparse_neighbor_mask(
        torch.from_numpy(adj), num_sparse,
        None if noise is None else torch.from_numpy(noise))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy().sum(-1) <= num_sparse).all()
    assert out.numpy()[0, 0].sum() == num_sparse


def _select_inputs(rng, b, n, grid):
    coors = rng.randint(-2, 3, size=(b, n, 3)).astype(np.float32) if grid \
        else rng.normal(size=(b, n, 3)).astype(np.float32)
    mask = rng.rand(b, n) > 0.15
    neighbor_mask = rng.rand(b, n, n) > 0.3
    bonded = rng.rand(b, n, n - 1) < 0.2
    bonded[0, 1] = True                     # more bonds than slots
    return coors, mask, neighbor_mask, bonded


def _run_select(nb, to, coors, mask, neighbor_mask, bonded, k, radius,
                causal, use_nmask, use_bonded):
    b, n = coors.shape[:2]
    excl = nb.exclude_self_indices(n)
    c, m = to(coors), to(mask)
    rel = nb.remove_self(c[:, :, None] - c[:, None], excl)
    idx = excl[None]
    idx = idx.expand(b, n, n - 1) if isinstance(idx, torch.Tensor) \
        else jnp.broadcast_to(idx, (b, n, n - 1))
    pm = nb.remove_self(m[:, :, None] & m[:, None, :], excl)
    hood, nearest = nb.select_neighbors(
        rel, idx, k, radius, pair_mask=pm,
        neighbor_mask=nb.remove_self(to(neighbor_mask), excl)
        if use_nmask else None,
        sparse_mask=to(bonded) if use_bonded else None, causal=causal)
    return [np.asarray(t) for t in (hood.indices, hood.mask, hood.rel_dist,
                                    hood.rel_pos, nearest)]


@pytest.mark.parametrize('causal,use_nmask,use_bonded,grid,radius', [
    (True, False, False, False, 1e5),
    (False, True, False, True, 1e5),
    (False, False, True, True, 0.),
    (True, True, True, True, 2.5)])
def test_select_neighbors_masks_match_jax(causal, use_nmask, use_bonded,
                                          grid, radius):
    """Indices, validity and distances identical to the JAX selection:
    bonded ranks exactly 0 (ties toward the lower index), masked and
    future ranks FINF (ties likewise), the unmodified distances out."""
    rng = np.random.RandomState(int(causal) + 2 * use_nmask + 4 * use_bonded)
    k = 6
    inputs = _select_inputs(rng, 2, 13, grid)
    args = (*inputs, k, radius, causal, use_nmask, use_bonded)
    ref = _run_select(jax_nb, jnp.asarray, *args)
    out = _run_select(t_nb, torch.from_numpy, *args)
    for name, r, o in zip(('indices', 'mask', 'rel_dist', 'rel_pos',
                           'nearest'), ref, out):
        assert o.shape == r.shape, name
        if name in ('indices', 'mask', 'nearest'):
            assert np.array_equal(o, r), name
        else:
            assert np.abs(o - r).max() <= 1e-6, name
    if causal:
        # row 0 has no past: every slot invalid
        assert not out[1][:, 0].any()


def test_chain_adjacency_matches_jax_fallback(monkeypatch):
    monkeypatch.setattr(jax_loader, 'get_lib', lambda: None)
    for n in (1, 2, 9):
        ref = jax_loader.chain_adjacency(n)
        out = chain_adjacency(n)
        assert out.dtype == ref.dtype == bool
        assert np.array_equal(out, ref)


# ---------------------------------------------------------------------- #
# molecular_edges: the reduced twin's output, loss and every gradient
# ---------------------------------------------------------------------- #
def _molecular_batch():
    batch = molecular_batch(np.random.RandomState(3), 1, N_MOL, 28, 4)
    batch['masks'][0, -4:] = False          # rows with no valid slot
    return batch


@pytest.fixture(scope='module')
def molecular_jax():
    """The JAX twin's parameters, pooled output, property loss and its
    gradient with respect to every parameter."""
    batch = _molecular_batch()
    jm = jax_molecular_edges(dim=8).clone(**MOLECULAR_TWIN)
    kw = dict(mask=batch['masks'], adj_mat=batch['adj_mat'],
              edges=batch['edges'], return_pooled=True, return_type=0)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch['tokens'], batch['coords'],
        **kw))['params']
    params = _random_params(shapes, seed=5)

    def loss_fn(p):
        pooled = jm.apply({'params': p}, batch['tokens'], batch['coords'],
                          **kw)
        return ((pooled.mean(-1) - batch['target']) ** 2).mean(), pooled

    (loss, pooled), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    full = jax.jit(lambda p: jm.apply(
        {'params': p}, batch['tokens'], batch['coords'],
        **dict(kw, return_pooled=False)))(params)
    return params, np.asarray(pooled), np.asarray(full), float(loss), grads


@pytest.fixture(scope='module')
def molecular_port(molecular_jax):
    params = molecular_jax[0]
    batch = {k: torch.from_numpy(v) for k, v in _molecular_batch().items()}
    model = molecular_edges(dim=8, device='cpu', **MOLECULAR_TWIN)
    model.load_state_dict(convert_flax_params(params, model))
    with torch.no_grad():
        full = model(batch['tokens'], batch['coords'], batch['masks'],
                     adj_mat=batch['adj_mat'], edges=batch['edges'])
    loss = property_loss(model, batch)
    loss.backward()
    pooled = model(batch['tokens'], batch['coords'], batch['masks'],
                   adj_mat=batch['adj_mat'], edges=batch['edges'],
                   return_pooled=True)
    grads = {k: p.grad for k, p in model.named_parameters()}
    return model, pooled.detach().numpy(), full.numpy(), loss.item(), grads


def test_molecular_twin_output_and_loss_match_jax(molecular_jax,
                                                  molecular_port):
    _, ref_pooled, ref_full, ref_loss, _ = molecular_jax
    _, pooled, full, loss, _ = molecular_port
    assert full.shape == ref_full.shape == (1, N_MOL, 8)
    assert pooled.shape == ref_pooled.shape == (1, 8)
    assert np.isfinite(full).all()
    assert _rel_err(full, ref_full) <= RTOL_F32
    assert _rel_err(pooled, ref_pooled) <= RTOL_F32
    assert abs(loss - ref_loss) <= RTOL_F32 * abs(ref_loss)


def test_molecular_twin_gradients_match_jax(molecular_jax, molecular_port):
    """Every parameter's gradient, the three embeddings' included, within
    RTOL_F32 of its largest value."""
    model, grads = molecular_port[0], molecular_port[4]
    ref = convert_flax_params(
        jax.tree_util.tree_map(np.asarray, molecular_jax[4]), model)
    assert set(ref) == set(grads)
    assert {'token_emb.weight', 'edge_emb.weight', 'adj_emb.weight'} \
        <= set(ref)
    for key, r in ref.items():
        got = torch.zeros_like(r) if grads[key] is None else grads[key]
        if not r.abs().max():
            assert not got.abs().max(), key
            continue
        assert _rel_err(got.numpy(), r.numpy()) <= RTOL_F32, key


def test_molecular_trainer_takes_property_loss():
    """DenoiseTrainer(loss_fn=property_loss) steps the molecular model on
    molecular_batch: the loss falls."""
    model = molecular_edges(dim=8, depth=1, device='cpu', **MOLECULAR_TWIN)
    trainer = DenoiseTrainer(model, lr=3e-3, device='cpu',
                             loss_fn=property_loss)
    batch = molecular_batch(np.random.RandomState(0), 2, 10, 28, 4)
    losses = [float(trainer.train_step(batch)) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ---------------------------------------------------------------------- #
# toy_denoise, a causal model, fuse_pairwise with edges
# ---------------------------------------------------------------------- #
def _twin(jm, tm, seed, args, kwargs):
    """(JAX output, port output) of one module pair on shared random
    parameters; args and kwargs are numpy arrays (or plain values)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                            **kwargs))['params']
    params = _random_params(shapes, seed)
    ref = jax.jit(lambda p: jm.apply({'params': p}, *args, **kwargs))(params)
    tm.load_state_dict(convert_flax_params(params, tm))

    def t(v):
        return torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    with torch.no_grad():
        out = tm(*map(t, args), **{k: t(v) for k, v in kwargs.items()})
    return np.asarray(ref), out.numpy()


def test_toy_denoise_matches_jax():
    batch = molecular_batch(np.random.RandomState(7), 1, 32, 24, 4)
    ref, out = _twin(jax_toy(), toy_denoise(device='cpu'), 8,
                     (batch['tokens'], batch['coords']),
                     dict(mask=batch['masks'], adj_mat=batch['adj_mat'],
                          return_type=1))
    assert out.shape == ref.shape == (1, 32, 3)
    assert _rel_err(out, ref) <= RTOL_F32


def test_causal_positions_neighbor_mask_pooled_match_jax():
    """causal with num_positions, a user neighbor_mask, continuous edges
    and a pooled, masked output: every new forward input at once."""
    rng = np.random.RandomState(9)
    b, n = 2, 10
    fields = dict(dim=8, depth=1, heads=2, dim_head=8, num_degrees=2,
                  output_degrees=2, num_neighbors=4, causal=True,
                  num_positions=12, edge_dim=3)
    args = (rng.normal(size=(b, n, 8)).astype(np.float32),
            rng.normal(size=(b, n, 3)).astype(np.float32))
    mask = np.ones((b, n), bool)
    mask[1, -3:] = False
    kwargs = dict(mask=mask, edges=rng.normal(size=(b, n, n, 3))
                  .astype(np.float32),
                  neighbor_mask=rng.rand(b, n, n) > 0.3, return_type=1,
                  return_pooled=True)
    ref, out = _twin(JaxModule(**fields),
                     SE3TransformerModule(**fields, device='cpu'), 10, args,
                     kwargs)
    assert out.shape == ref.shape == (b, 8, 3)
    assert _rel_err(out, ref) <= RTOL_F32


def _edge_graph(seed, n=9, k=4, e=5):
    rng = np.random.RandomState(seed)
    feats = {str(d): rng.normal(size=(1, n, 4, 2 * d + 1)).astype(np.float32)
             for d in range(2)}
    idx = rng.randint(0, n, size=(1, n, k))
    mask = rng.rand(1, n, k) > 0.2
    edges = rng.normal(size=(1, n, k, e)).astype(np.float32)
    rel = rng.normal(size=(1, n, k, 3)).astype(np.float32)
    return feats, idx, mask, edges, rel


def test_fuse_pairwise_program_carries_the_edges():
    """ConvSE3(fuse_pairwise=True) with edges: the radial hidden h (the
    distance then the edges through the trunk) against the JAX layer's."""
    feats, idx, mask, edges, rel = _edge_graph(11)
    kw = dict(pool=False, self_interaction=False, shared_radial_hidden=True,
              fuse_pairwise=True, edge_dim=edges.shape[-1])
    dist = np.linalg.norm(rel, axis=-1).astype(np.float32)
    jmod = JConv(JFiber.create(2, 4), JFiber.create(2, 8), **kw)
    j_args = ({d: jnp.asarray(v) for d, v in feats.items()},
              (jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(edges)),
              jnp.asarray(dist), {})
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              *j_args))['params']
    params = _random_params(shapes, seed=12)
    ref = jmod.apply({'params': params}, *j_args)
    conv = ConvSE3(Fiber.create(2, 4), Fiber.create(2, 8), **kw)
    conv.load_state_dict(convert_flax_params(params, conv))
    with torch.no_grad():
        out = conv({d: torch.from_numpy(v) for d, v in feats.items()},
                   (torch.from_numpy(idx), torch.from_numpy(mask),
                    torch.from_numpy(edges)), torch.from_numpy(dist), {})
    assert out['h'].shape == ref['h'].shape == (1, 9, 4, 128)
    assert _rel_err(out['h'].numpy(), ref['h']) <= RTOL_F32


def test_fuse_pairwise_block_with_edges_matches_jax_stream():
    """AttentionBlockSE3(fuse_pairwise=True) with edges: the streaming
    attention's block output against the JAX block's XLA stream."""
    feats, idx, mask, edges, rel = _edge_graph(13)
    kw = dict(dim_head=4, heads=2, attend_self=True, fuse_pairwise=True,
              edge_dim=edges.shape[-1])
    dist = np.linalg.norm(rel, axis=-1).astype(np.float32)
    jblock = JAttentionBlock(JFiber.create(2, 4), **kw)
    j_args = ({d: jnp.asarray(v) for d, v in feats.items()},
              (jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(edges)),
              jnp.asarray(dist),
              {'flash_sh': jax_sh_payload(jnp.asarray(rel), 1)})
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0),
                                                *j_args))['params']
    params = _random_params(shapes, seed=14)
    ref = jblock.apply({'params': params}, *j_args)
    block = AttentionBlockSE3(Fiber.create(2, 4), **kw)
    block.load_state_dict(convert_flax_params(params, block))
    with torch.no_grad():
        out = block({d: torch.from_numpy(v) for d, v in feats.items()},
                    (torch.from_numpy(idx), torch.from_numpy(mask),
                     torch.from_numpy(edges)), torch.from_numpy(dist),
                    {'flash_sh': flash_sh_payload(torch.from_numpy(rel), 1)})
    for d in ref:
        assert out[d].shape == ref[d].shape, d
        assert _rel_err(out[d].numpy(), ref[d]) <= RTOL_F32, d


def test_unfused_conv_with_edges_matches_jax():
    """A pooled per-pair ConvSE3 with edges (the dense basis) against the
    JAX layer."""
    feats, idx, mask, edges, rel = _edge_graph(15)
    kw = dict(edge_dim=edges.shape[-1])
    dist = np.linalg.norm(rel, axis=-1).astype(np.float32)
    jmod = JConv(JFiber.create(2, 4), JFiber.create(2, 6), **kw)
    j_args = ({d: jnp.asarray(v) for d, v in feats.items()},
              (jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(edges)),
              jnp.asarray(dist), jax_get_basis(jnp.asarray(rel), 1))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              *j_args))['params']
    params = _random_params(shapes, seed=16)
    ref = jmod.apply({'params': params}, *j_args)
    conv = ConvSE3(Fiber.create(2, 4), Fiber.create(2, 6), **kw)
    conv.load_state_dict(convert_flax_params(params, conv))
    with torch.no_grad():
        out = conv({d: torch.from_numpy(v) for d, v in feats.items()},
                   (torch.from_numpy(idx), torch.from_numpy(mask),
                    torch.from_numpy(edges)), torch.from_numpy(dist),
                   get_basis(torch.from_numpy(rel), 1))
    for d in ref:
        assert _rel_err(out[d].numpy(), ref[d]) <= RTOL_F32, d


# ---------------------------------------------------------------------- #
# the engine's chain adjacency, the converter, the refusals
# ---------------------------------------------------------------------- #
def test_engine_chain_adjacency_matches_jax():
    """InferenceEngine serving toy_denoise (tokens, bonded attention only)
    at bucket 24 on a request of 20 nodes: its output against the JAX
    module applied to the padded request with adj_mat = the bucket's chain
    adjacency."""
    rng = np.random.RandomState(17)
    n, bucket = 20, 24
    tokens = rng.randint(0, 24, n)
    coords = np.cumsum(rng.normal(size=(n, 3)), 0).astype(np.float32)
    jm = jax_toy()
    pad = np.zeros((1, bucket), np.int64)
    pad[0, :n] = tokens
    pc = np.zeros((1, bucket, 3), np.float32)
    pc[0, :n] = coords
    mask = np.arange(bucket)[None] < n
    kwargs = dict(mask=mask, adj_mat=chain_adjacency(bucket), return_type=1)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), pad, pc,
                                            **kwargs))['params']
    params = _random_params(shapes, seed=18)
    ref = np.asarray(jax.jit(lambda p: jm.apply(
        {'params': p}, pad, pc, **kwargs))(params))[0, :n]
    model = toy_denoise(device='cpu')
    model.load_state_dict(convert_flax_params(params, model))
    engine = InferenceEngine(model, buckets=(bucket,), device='cpu')
    out = engine.predict(tokens, coords)
    assert out.shape == ref.shape == (n, 3)
    assert _rel_err(out, ref) <= RTOL_F32
    # without the adjacency the bonded model cannot run: the warmup raises
    # out of the constructor, and an engine warmed lazily raises at its
    # first request
    with pytest.raises(ValueError, match='adjacency'):
        InferenceEngine(model, buckets=(bucket,), device='cpu',
                        with_chain_adjacency=False)
    bare = InferenceEngine(model, buckets=(bucket,), device='cpu',
                           with_chain_adjacency=False, precompile=False)
    with pytest.raises(ValueError, match='adjacency'):
        bare.predict(tokens, coords)


def test_convert_is_total_with_the_embeddings():
    """A tree with token_emb, pos_emb, edge_emb and adj_emb converts leaf
    for leaf; a missing embedding raises."""
    fields = dict(num_tokens=5, num_positions=8, num_edge_tokens=3,
                  edge_dim=2, num_adj_degrees=2, adj_dim=3, dim=4, depth=1,
                  num_degrees=2, heads=2, dim_head=4, num_neighbors=2)
    tokens = np.zeros((1, 6), np.int32)
    coors = np.random.RandomState(0).normal(size=(1, 6, 3)) \
        .astype(np.float32)
    shapes = jax.eval_shape(lambda: JaxModule(**fields).init(
        jax.random.PRNGKey(0), tokens, coors, adj_mat=chain_adjacency(6),
        edges=np.zeros((1, 6, 6), np.int32)))['params']
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    params = {k: v for k, v in params.items()}
    model = SE3TransformerModule(**fields, device='cpu')
    state = convert_flax_params(params, model)
    assert set(state) == set(model.state_dict())
    for name, rows in (('token_emb', 5), ('pos_emb', 8), ('edge_emb', 3),
                       ('adj_emb', 3)):
        assert state[f'{name}.weight'].shape[0] == rows
    del params['adj_emb']
    with pytest.raises(ValueError, match='adj_emb'):
        convert_flax_params(params, model)


def _small(**fields):
    return dict(dict(dim=4, depth=1, num_degrees=2, heads=2, dim_head=4,
                     num_neighbors=3), **fields)


@pytest.mark.parametrize('fields,match', [
    (dict(causal=True, attend_self=False), 'attend_self'),
    (dict(num_adj_degrees=0), 'num_adj_degrees'),
    (dict(num_edge_tokens=3), 'edge_dim'),
    (dict(attention_mode='global', edge_dim=2), 'edge'),
    (dict(attention_mode='global', attend_sparse_neighbors=True), 'sparse'),
    (dict(attention_mode='global', causal=True), 'causal'),
    (dict(attention_mode='global', num_adj_degrees=1), 'adjacency'),
])
def test_construction_refusals(fields, match):
    with pytest.raises(ValueError, match=match):
        SE3TransformerModule(**_small(**fields), device='cpu')


@pytest.mark.parametrize('fields,call,match', [
    (dict(attend_sparse_neighbors=True), dict(), 'adjacency matrix'),
    (dict(edge_dim=2), dict(), 'edge tokens/features'),
    (dict(), dict(edges=np.zeros((1, 6, 6, 2), np.float32)), 'edge_dim'),
    (dict(edge_dim=2), dict(edges=np.zeros((1, 6, 6, 3), np.float32)),
     'width'),
    (dict(num_adj_degrees=2), dict(), 'adjacency'),
    (dict(num_neighbors=0), dict(), 'num_neighbors > 0'),
    (dict(num_positions=5), dict(), 'num_positions'),
])
def test_forward_refusals(fields, call, match):
    """What the JAX forward asserts, and what the port's fixed edge width
    cannot take, raise ValueError."""
    model = SE3TransformerModule(**_small(**fields), device='cpu')
    rng = np.random.RandomState(0)
    call = {k: torch.from_numpy(v) for k, v in call.items()}
    with pytest.raises(ValueError, match=match):
        model(torch.from_numpy(rng.normal(size=(1, 6, 4))
                               .astype(np.float32)),
              torch.from_numpy(rng.normal(size=(1, 6, 3))
                               .astype(np.float32)), **call)


def _other_value(default):
    """A value other than a field's JAX default."""
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 1
    if isinstance(default, str):
        return default + '_other'
    return 2


@pytest.mark.parametrize('field', sorted(_JAX_ONLY_DEFAULTS))
def test_other_jax_fields_still_raise(field):
    """Every field left in _JAX_ONLY_DEFAULTS refuses any value but its
    JAX default; the edge, adjacency and causal fields left it."""
    assert not {'num_positions', 'num_edge_tokens', 'edge_dim',
                'attend_sparse_neighbors', 'num_adj_degrees', 'adj_dim',
                'max_sparse_neighbors', 'causal'} & set(_JAX_ONLY_DEFAULTS)
    value = _other_value(_JAX_ONLY_DEFAULTS[field])
    with pytest.raises(NotImplementedError, match=field):
        SE3TransformerModule(**_small(), device='cpu', **{field: value})


def test_recipes_match_jax_fields():
    """molecular_edges and toy_denoise carry the JAX recipes' fields (the
    port's names for them), take overrides and default to the card."""
    mol, toy = molecular_edges(device='cpu'), toy_denoise(device='cpu')
    assert mol.edge_width == 4 + 4 and mol.num_neighbors == 0
    assert mol.max_sparse_neighbors == 6 and mol.num_adj_degrees == 2
    assert tuple(mol.edge_emb.weight.shape) == (4, 4)
    assert tuple(mol.adj_emb.weight.shape) == (3, 4)
    assert tuple(mol.token_emb.weight.shape) == (28, 32)
    # the kv convs: O = 8 heads x 24, the trunk's input 1 + 8 wide
    conv = mol.trunk.attn_block0.attn.to_k
    assert tuple(conv.pair_1_1.w3.shape) == (128, 96, 192)
    assert tuple(conv.pair_1_1.Dense_0.weight.shape) == (128, 9)
    assert toy.max_sparse_neighbors == 8 and toy.differentiable_coors
    assert molecular_edges(device='cpu', depth=1).trunk.depth == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            molecular_edges()
