"""The attention variants in the port (one-headed keys and values,
linear_proj_keys, tied keys and values, the null kv slot in kNN mode, global
features, rotary embeddings) against the JAX package on the CPU: the rotary
functions; each variant through each attention core it takes (the einsums,
pallas_attention's plain version, the streaming attention's plain stream,
the global plain stream), output and every parameter's gradient against
jax.grad; the tied streaming and global plain streams against the JAX XLA
stream with cfg.tie and the interpret-mode Pallas kernel, and their
recompute backward against jax.grad; the four equivariance configurations
of tests/test_equivariance.py that these variants make buildable
(equivariance and JAX parity); the converter on every variant's tree; and
every refusal, with JAX's reason. Parameters and inputs are made from a
seed with numpy; weights come over by convert_flax_params."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flash as tflash
import test_torch_global as tglobal
from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.kernels import pallas_flash as pf
from se3_transformer_tpu.ops import rotary as jax_rotary
from se3_transformer_torch import SE3TransformerModule, convert_flax_params
from se3_transformer_torch.kernels import flash as kf
from se3_transformer_torch.ops import AttentionSE3, Fiber
from se3_transformer_torch.ops import rotary
from se3_transformer_torch.so3 import rot

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

# float32 throughout: summation order only, relative to the largest
# magnitude of each output or gradient leaf
RTOL_F32 = 1e-4
# the equivariance bound of tests/test_equivariance.py
EQUIVARIANCE_ATOL = 1e-4
# the plain streams against the JAX ones: the same float32 products in
# other orders (tests/test_torch_flash.py, tests/test_torch_global.py)
STREAM_RTOL = 1e-5


def _random_params(shapes, seed):
    """Every leaf drawn from a seeded normal (the null kv slots too, so
    that they carry weight)."""
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
# the rotary functions
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('dim,shape', [(4, (3, 5)), (8, (2, 4, 6))])
def test_sinusoidal_embeddings_match_jax(dim, shape):
    t = np.random.RandomState(0).uniform(0, 300, size=shape) \
        .astype(np.float32)
    ref = np.asarray(jax_rotary.sinusoidal_embeddings(jnp.asarray(t), dim))
    out = rotary.sinusoidal_embeddings(torch.from_numpy(t), dim).numpy()
    assert out.shape == ref.shape == shape + (dim,)
    # the same float32 products of the same frequencies
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize('d,m,rot_dim', [(8, 1, 4), (8, 3, 8), (6, 5, 2)])
def test_rotate_half_and_rotary_match_jax(d, m, rot_dim):
    """_rotate_half over consecutive channel pairs, exactly; the rotation
    of the first rot_dim channels (the rest pass) within float32's cos
    and sin, with the trailing m axis."""
    rng = np.random.RandomState(d + m)
    t = rng.normal(size=(2, 3, d, m)).astype(np.float32)
    freqs = rng.uniform(0, 6, size=(2, 3, rot_dim)).astype(np.float32)
    half = rotary._rotate_half(torch.from_numpy(t)).numpy()
    assert np.array_equal(half, np.asarray(jax_rotary._rotate_half(
        jnp.asarray(t))))
    out = rotary.apply_rotary_pos_emb(torch.from_numpy(t),
                                      torch.from_numpy(freqs)).numpy()
    ref = np.asarray(jax_rotary.apply_rotary_pos_emb(jnp.asarray(t),
                                                     jnp.asarray(freqs)))
    assert np.array_equal(out[:, :, rot_dim:], t[:, :, rot_dim:])
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


# ---------------------------------------------------------------------- #
# each variant through each core: output and gradients against jax.grad
# ---------------------------------------------------------------------- #
# the model's fields for the model-level tests: a depth-1 model of two
# degrees, 2 heads of 8, 4 neighbors and the self slot
BASE = dict(dim=8, depth=1, num_degrees=2, output_degrees=2, heads=2,
            dim_head=8, attend_self=True, num_neighbors=4)
GLOBAL_DIM = 6
VARIANTS = {
    'one_headed': dict(one_headed_key_values=True),
    'linear_proj_keys': dict(linear_proj_keys=True),
    'tie': dict(tie_key_values=True),
    'null_kv': dict(use_null_kv=True),
    'global_feats': dict(global_feats_dim=GLOBAL_DIM),
    'rotary': dict(rotary_position=True, rotary_rel_dist=True),
}
CORES = {
    'einsum': dict(),
    'pallas_attention': dict(pallas_attention=True),
    'flash': dict(fuse_pairwise=True, shared_radial_hidden=True),
    'global': dict(attention_mode='global', num_neighbors=float('inf')),
}
# the cores each variant takes (JAX refuses the rest: see the refusals);
# the null slot in global mode is tests/test_torch_global.py's
VARIANT_CORES = [(v, c) for v in VARIANTS for c in CORES
                 if not (v in ('linear_proj_keys', 'rotary')
                         and c in ('flash', 'global'))
                 and not (v == 'null_kv' and c == 'global')]
# the attention layer's widths: degrees 0 and 1 of 8 channels, 2 heads of
# 8, n 10 (the last 2 nodes masked), K 4 neighbors
LAYER_N, LAYER_K, LAYER_C = 10, 4, 8


def _layer_fields(variant, core):
    """AttentionSE3's fields (the JAX layer's names) for a variant and a
    core; the JAX layer's one-headed variant is kv_heads=1."""
    v = dict(VARIANTS[variant])
    fields = dict(dim_head=8, heads=2, attend_self=True)
    if v.pop('one_headed_key_values', False):
        fields['kv_heads'] = 1
    v.pop('rotary_position', None)
    v.pop('rotary_rel_dist', None)
    fields.update(v)
    fields.update({k: val for k, val in CORES[core].items()
                   if k != 'num_neighbors'})
    return fields


def _layer_inputs(variant, seed=0):
    """numpy inputs of one layer call: the features, a neighbor list with
    the self pair excluded and a mask, the coordinates, the rotary phases
    (query [1, n, 8], key over [self, neighbors] [1, n, 1 + K, 8]), global
    features, and a cotangent weight per output degree."""
    rng = np.random.RandomState(seed)
    n, K, C = LAYER_N, LAYER_K, LAYER_C
    feats = {str(d): rng.normal(size=(1, n, C, 2 * d + 1)).astype(np.float32)
             for d in range(2)}
    coords = (rng.normal(size=(1, n, 3)) * 2).astype(np.float32)
    idx = np.stack([rng.choice([j for j in range(n) if j != i], K,
                               replace=False) for i in range(n)])[None]
    nmask = rng.rand(1, n, K) > 0.2
    nmask[0, 3] = False
    node_mask = (np.arange(n) < n - 2)[None]
    weight = {d: rng.normal(size=t.shape).astype(np.float32)
              for d, t in feats.items()}
    extra = dict(idx=idx, nmask=nmask, coords=coords, node_mask=node_mask)
    if variant == 'rotary':
        extra['pos_emb'] = (rng.uniform(0, 6, size=(1, n, 8)).astype(
            np.float32), rng.uniform(0, 6, size=(1, n, 1 + K, 8)).astype(
            np.float32))
    if variant == 'global_feats':
        extra['global_feats'] = {'0': rng.normal(
            size=(1, 2, GLOBAL_DIM, 1)).astype(np.float32)}
    return feats, weight, extra


def _layer_geometry(lib, extra, core, max_degree=1):
    """(edge_info, rel_dist, basis) of the inputs in one package's
    arrays (`lib` jnp or torch)."""
    coords, idx = lib.asarray(extra['coords']) if lib is jnp else \
        torch.from_numpy(extra['coords']), extra['idx']
    if core == 'global':
        mask = extra['node_mask']
        basis = dict(global_coords=coords,
                     global_mask=jnp.asarray(mask) if lib is jnp
                     else torch.from_numpy(mask))
        return (None, None, None), None, basis
    if lib is jnp:
        from se3_transformer_tpu.basis import get_basis as jbasis
        ij = jnp.asarray(idx.astype(np.int32))
        rel_pos = coords[:, :, None] - coords[0][ij]
        rel_dist = jnp.linalg.norm(rel_pos, axis=-1)
        basis = jbasis(rel_pos, max_degree)
        if core == 'flash':
            basis['flash_sh'] = pf.flash_sh_payload(rel_pos, max_degree)
        return (ij, jnp.asarray(extra['nmask']), None), rel_dist, basis
    from se3_transformer_torch.basis import get_basis as tbasis
    it = torch.from_numpy(idx)
    rel_pos = coords[:, :, None] - coords[0][it]
    rel_dist = rel_pos.norm(dim=-1)
    basis = tbasis(rel_pos, max_degree)
    if core == 'flash':
        basis['flash_sh'] = kf.flash_sh_payload(rel_pos, max_degree)
    return (it, torch.from_numpy(extra['nmask']), None), rel_dist, basis


@functools.lru_cache(maxsize=None)
def _jax_layer(variant, core, seed=1):
    """The JAX layer's parameters, output and jax.grad of the weighted
    output sum on _layer_inputs(variant); the pallas_attention core is
    held through its plain reference, the einsum core (the Pallas kernel
    needs a TPU or interpret mode), so the two share one result."""
    if core == 'pallas_attention':
        return _jax_layer(variant, 'einsum', seed)
    from se3_transformer_tpu.ops.attention import AttentionSE3 as JAttention
    from se3_transformer_tpu.ops.fiber import Fiber as JFiber
    feats, weight, extra = _layer_inputs(variant)
    fields = {k: v for k, v in _layer_fields(variant, core).items()
              if k != 'pallas_attention'}
    layer = JAttention(JFiber.create(2, LAYER_C), **fields)
    edge_info, rel_dist, basis = _layer_geometry(jnp, extra, core)
    jf = {d: jnp.asarray(t) for d, t in feats.items()}
    gf = None if 'global_feats' not in extra else \
        {'0': jnp.asarray(extra['global_feats']['0'])}
    pos = None if 'pos_emb' not in extra else \
        tuple(map(jnp.asarray, extra['pos_emb']))
    shapes = jax.eval_shape(lambda: layer.init(
        jax.random.PRNGKey(0), jf, edge_info, rel_dist, basis, gf,
        pos))['params']
    params = _random_params(shapes, seed)

    def loss_fn(p):
        out = layer.apply({'params': p}, jf, edge_info, rel_dist, basis, gf,
                          pos)
        return sum((out[d] * weight[d]).sum() for d in out), out
    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return params, {d: np.asarray(t) for d, t in out.items()}, grads


def _port_layer(variant, core, params, inputs):
    feats, weight, extra = inputs
    layer = AttentionSE3(Fiber.create(2, LAYER_C),
                         **_layer_fields(variant, core))
    layer.load_state_dict(convert_flax_params(params, layer))
    edge_info, rel_dist, basis = _layer_geometry(torch, extra, core)
    gf = None if 'global_feats' not in extra else \
        {'0': torch.from_numpy(extra['global_feats']['0'])}
    pos = None if 'pos_emb' not in extra else \
        tuple(map(torch.from_numpy, extra['pos_emb']))
    out = layer({d: torch.from_numpy(t) for d, t in feats.items()},
                edge_info, rel_dist, basis, gf, pos)
    sum((out[d] * torch.from_numpy(weight[d])).sum() for d in out).backward()
    return layer, {d: t.detach().numpy() for d, t in out.items()}, \
        {k: p.grad for k, p in layer.named_parameters()}


@pytest.mark.parametrize('variant,core', VARIANT_CORES)
def test_variant_core_matches_jax(variant, core):
    """The variant's attention layer through the core (n 10 with masked
    neighbors; the global core with 2 masked nodes) on converted random
    parameters: every output degree and every parameter's gradient against
    the JAX layer and jax.grad."""
    params, ref, dp = _jax_layer(variant, core)
    layer, out, grads = _port_layer(variant, core, params,
                                    _layer_inputs(variant))
    assert set(out) == set(ref) == {'0', '1'}
    for d in out:
        assert out[d].shape == ref[d].shape
        assert np.isfinite(out[d]).all()
        assert _rel_err(out[d], ref[d]) <= RTOL_F32, d
    want = convert_flax_params(jax.tree_util.tree_map(np.asarray, dp), layer)
    assert set(want) == set(grads)
    for key, r in want.items():
        got = torch.zeros_like(r) if grads[key] is None else grads[key]
        if not r.abs().max():
            assert not got.abs().max(), key
            continue
        assert _rel_err(got.numpy(), r.numpy()) <= RTOL_F32, key


def _variant_inputs(fields, n=10, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.normal(size=(1, n, 8)).astype(np.float32)
    coors = (rng.normal(size=(1, n, 3)) * 2).astype(np.float32)
    mask = np.ones((1, n), bool)
    mask[0, -2:] = False
    extra = {}
    if fields.get('global_feats_dim'):
        extra['global_feats'] = rng.normal(
            size=(1, 2, fields['global_feats_dim'])).astype(np.float32)
    return feats, coors, mask, extra


def test_tied_training_step_call_counts(monkeypatch):
    """flagship_fast's fields with tie_key_values, one denoise step under
    save_conv_outputs: the pairwise op's forward runs conv_in's 4 pairs,
    each block's to_v 16 (no to_k) and conv_out's 4 x 2; its backward
    conv_in's, to_v's and the degree-1 head's (4 + 16 depth + 4): the
    counts chip_smoke.py holds kernels #1, A and B to on the card."""
    from se3_transformer_torch import denoise_loss
    from se3_transformer_torch.kernels import pairwise as kp
    import test_torch_training as ttrain
    fwd, bwd = [], []
    plain, bwd_plain = kp.fused_pairwise_conv_bxf_plain, \
        kp.fused_pairwise_conv_bwd_plain
    monkeypatch.setattr(kp, 'fused_pairwise_conv_bxf_plain',
                        lambda *a: fwd.append(1) or plain(*a))
    monkeypatch.setattr(kp, 'fused_pairwise_conv_bwd_plain',
                        lambda *a: bwd.append(1) or bwd_plain(*a))
    batch, noise = ttrain._batch(seed=12)
    depth = 2
    model = SE3TransformerModule(**dict(ttrain.TWIN, depth=depth,
                                        tie_key_values=True), device='cpu')
    denoise_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                 torch.from_numpy(noise)).backward()
    assert (len(fwd), len(bwd)) == (4 + depth * 16 + 8, 4 + depth * 16 + 4)


@pytest.mark.parametrize('fields,routed', [
    # one kv head: #7 and 7g are built for heads == kv_heads
    (dict(fuse_basis=True, fuse_pairwise=True, one_headed_key_values=True),
     dict(bxf=4, flash=2)),
    (dict(num_tokens=5, attention_mode='global', use_null_kv=True,
          one_headed_key_values=True), dict(glob=2)),
    # tied, past the kernels' widths (heads * dim_head 16 and 32): the
    # tied operands through the routed plain streams
    (dict(fuse_basis=True, fuse_pairwise=True, tie_key_values=True,
          use_null_kv=True), dict(bxf=4, flash=2)),
    (dict(num_tokens=5, attention_mode='global', use_null_kv=True,
          tie_key_values=True, dim_head=16), dict(glob=2))])
def test_variant_routed_on_a_card_runs_the_plain_bodies(monkeypatch, fields,
                                                        routed):
    """A variant's model past the kernels' limits, its route decided as on
    a card: each routed call counted in its wrapper's .routed, and the
    plain bodies under autograd give the unrouted CPU model's output and
    gradients."""
    import test_torch_modules as tmodules
    cfg = dict(tmodules.DENOISE, **fields)
    rng = np.random.RandomState(0)
    n = 10
    feats = rng.randint(0, 5, (1, n)) if 'num_tokens' in cfg else \
        rng.normal(size=(1, n, 8)).astype(np.float32)
    inputs = [torch.from_numpy(feats),
              torch.from_numpy(rng.normal(size=(1, n, 3)).astype(np.float32)),
              torch.from_numpy(np.arange(n)[None] < n - 2)]
    models = [SE3TransformerModule(**cfg, device='cpu',
                                   generator=torch.Generator().manual_seed(1))
              for _ in range(2)]
    ref_out, ref_grads = tmodules._value_and_grads(models[0], inputs)
    tmodules._on_a_card(monkeypatch)
    with pytest.warns(UserWarning, match='using the plain path'):
        out, grads = tmodules._value_and_grads(models[1], inputs)
    assert {k: w.routed for k, w in tmodules.ROUTED.items()
            if w.routed} == routed
    assert torch.equal(out, ref_out)
    assert set(grads) == set(ref_grads)
    for key, ref in ref_grads.items():
        assert (grads[key] - ref).abs().max() <= 1e-5 * ref.abs().max(), key


# ---------------------------------------------------------------------- #
# the tied plain streams against JAX's
# ---------------------------------------------------------------------- #
TIED = dict(h_k=None, wk=None, bk=None)


@pytest.mark.parametrize('case', [dict(prefix=0, masked=False),
                                  dict(n=29, prefix=2)])
def test_tied_flash_plain_matches_jax_stream(case):
    """The tied kNN stream (one kv block by h_v, wv, bv, read as k and
    as v) against the JAX XLA stream with cfg.tie."""
    ops = tflash._inputs(**case)
    ref = tflash._run_jax(ops, **TIED)
    out = tflash._run_port(tflash._torch_ops(ops), **TIED)
    tflash._close(out, ref, STREAM_RTOL)
    # and not the untied function
    untied = tflash._run_port(tflash._torch_ops(ops))
    assert np.abs(out.numpy() - untied.numpy()).max() > 1e-3


def test_tied_flash_plain_matches_jax_interpret_kernel():
    """The JAX Pallas kernel's tie branch in interpret mode."""
    ops = tflash._inputs(n=29, prefix=2)
    ref = tflash._run_jax(ops, interpret=True, **TIED)
    tflash._close(tflash._run_port(tflash._torch_ops(ops), **TIED), ref,
                  STREAM_RTOL)


def test_tied_flash_recompute_backward_matches_jax_grad():
    """The op's backward replaying the tied stream against jax.grad: q,
    a node feature, h_v, wv, bv and the prefix keys."""
    ops = tflash._inputs(n=29, prefix=1)
    names = ('q', 'x0', 'h_v', 'wv', 'bv', 'prefix_k')

    def loss_jax(q, x0, h_v, wv, bv, pk):
        xs = (x0,) + tuple(map(jnp.asarray, ops['xs'][1:]))
        j = {k: (None if v is None else jnp.asarray(v))
             for k, v in ops.items() if k != 'xs'}
        out = pf.flash_attention(
            q, xs, j['idx'].astype(jnp.int32), j['nmask'], h_v, wv, bv,
            pairs=tflash.PAIRS, d_out=tflash.D_OUT, heads=tflash.HEADS,
            kv_heads=tflash.KV_H, scale=tflash.SCALE,
            sh=pf.flash_sh_payload(j['rel'], 2), prefix_k=pk,
            prefix_v=j['prefix_v'], pallas=False)
        return (out ** 2).sum()
    vals = [ops['q'], ops['xs'][0], ops['h_v'], ops['wv'], ops['bv'],
            ops['prefix_k']]
    ref = jax.jit(jax.grad(loss_jax, argnums=tuple(range(6))))(
        *map(jnp.asarray, vals))
    t = tflash._torch_ops(ops, h_dtype=torch.float32)
    leaves = [torch.from_numpy(v).requires_grad_() for v in vals]
    t.update(q=leaves[0], h_v=leaves[2], wv=leaves[3], bv=leaves[4],
             prefix_k=leaves[5])
    t['xs'] = (leaves[1],) + t['xs'][1:]
    (tflash._run_port(t, **TIED) ** 2).sum().backward()
    for name, leaf, want in zip(names, leaves, ref):
        assert leaf.grad is not None, name
        tflash._close(leaf.grad, want, RTOL_F32)


def _global_tied(lib, ops, d_out, **over):
    """The tied global attention of one package (`lib` pf or kf) on
    tests/test_torch_global.py's operands, converted by `arr`."""
    arr = jnp.asarray if lib is pf else \
        (lambda a: torch.from_numpy(np.asarray(a)))
    return lib.flash_global_attention(
        arr(ops['q']), tuple(map(arr, ops['xs'])), arr(ops['coords']),
        tuple(map(arr, ops['rp_v'])), arr(ops['wv']), arr(ops['bv']),
        node_mask=arr(ops['node_mask']), prefix_k=arr(ops['prefix_k']),
        prefix_v=arr(ops['prefix_v']), **tglobal._kw(d_out), **over)


@pytest.mark.parametrize('interpret', [False, True])
@pytest.mark.parametrize('d_out', [0, 1])
def test_tied_global_plain_matches_jax(d_out, interpret):
    """The tied global stream (one trunk, one kv block) against the JAX
    XLA stream and the interpret-mode Pallas kernel with cfg.tie."""
    ops = tglobal._inputs(d_out)
    ref = _global_tied(pf, ops, d_out, pallas=False, interpret=interpret)
    out = _global_tied(kf, ops, d_out)
    tglobal._close(out, ref, STREAM_RTOL)
    untied = tglobal._run_port(tglobal._torch(ops), d_out)
    assert np.abs(out.numpy() - untied.numpy()).max() > 1e-3


def test_tied_global_replay_backward_matches_jax_grad():
    """The global op's backward replaying the tied stream against
    jax.grad: q, the coordinates, the values' trunk W2, wv and bv."""
    d_out = 1
    ops = tglobal._inputs(d_out, seed=4)

    def loss_jax(q, coords, w2, wv, bv):
        rp_v = tuple(map(jnp.asarray, ops['rp_v']))
        rp_v = rp_v[:4] + (w2,) + rp_v[5:]
        out = pf.flash_global_attention(
            q, tuple(map(jnp.asarray, ops['xs'])), coords, rp_v, wv, bv,
            node_mask=jnp.asarray(ops['node_mask']),
            prefix_k=jnp.asarray(ops['prefix_k']),
            prefix_v=jnp.asarray(ops['prefix_v']), pallas=False,
            **tglobal._kw(d_out))
        return (out ** 2).sum()
    vals = [ops['q'], ops['coords'], ops['rp_v'][4], ops['wv'], ops['bv']]
    ref = jax.jit(jax.grad(loss_jax, argnums=tuple(range(5))))(
        *map(jnp.asarray, vals))
    t = tglobal._torch(ops)
    leaves = [torch.from_numpy(np.asarray(v)).requires_grad_() for v in vals]
    out = kf.flash_global_attention(
        leaves[0], t['xs'], leaves[1],
        t['rp_v'][:4] + (leaves[2],) + t['rp_v'][5:], leaves[3], leaves[4],
        node_mask=t['node_mask'], prefix_k=t['prefix_k'],
        prefix_v=t['prefix_v'], **tglobal._kw(d_out))
    (out ** 2).sum().backward()
    for leaf, want in zip(leaves, ref):
        assert leaf.grad is not None
        tglobal._close(leaf.grad, want, RTOL_F32)


# ---------------------------------------------------------------------- #
# the equivariance configurations these variants make buildable
# ---------------------------------------------------------------------- #
# name -> (model fields, return type), as tests/test_equivariance.py builds
# them (batch 1, 64 input features, n 32; global_feats [1, 2, 16])
EQUIVARIANCE_CASES = {
    'test_se3_transformer_with_global_nodes': (
        dict(dim=64, depth=1, num_degrees=2, num_neighbors=4,
             valid_radius=10, global_feats_dim=16), 0),
    'test_one_headed_key_values_se3_transformer_with_global_nodes': (
        dict(dim=64, depth=1, num_degrees=2, num_neighbors=4,
             valid_radius=10, global_feats_dim=16,
             one_headed_key_values=True), 0),
    'test_rotary': (
        dict(dim=64, depth=1, attend_self=True, num_neighbors=4,
             num_degrees=2, output_degrees=2, fourier_encode_dist=True,
             rotary_position=True, rotary_rel_dist=True), 1),
    'test_equivariance_linear_proj_keys': (
        dict(dim=64, depth=1, attend_self=True, num_neighbors=4,
             num_degrees=2, output_degrees=2, fourier_encode_dist=True,
             linear_proj_keys=True), 1),
}


def _equivariance_inputs(fields, n, dim, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.normal(size=(1, n, dim)).astype(np.float32)
    coors = rng.normal(size=(1, n, 3)).astype(np.float32)
    extra = {}
    if fields.get('global_feats_dim'):
        extra['global_feats'] = rng.normal(
            size=(1, 2, fields['global_feats_dim'])).astype(np.float32)
    return feats, coors, np.ones((1, n), bool), extra


def _rotate(x, R):
    return (np.asarray(x, np.float64) @ R).astype(np.float32)


@pytest.mark.parametrize('case', sorted(EQUIVARIANCE_CASES))
def test_equivariance_config_is_equivariant(case):
    """At the reference test's own widths (n 32): the vector output
    rotates with the coordinates, the scalar one does not move, within the
    reference's 1e-4."""
    fields, return_type = EQUIVARIANCE_CASES[case]
    model = SE3TransformerModule(**fields, device='cpu',
                                 generator=torch.Generator().manual_seed(0))
    feats, coors, mask, extra = _equivariance_inputs(fields, 32, 64)
    extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    R = rot(15, 0, 45)
    with torch.no_grad():
        out, out_r = (model(torch.from_numpy(feats), torch.from_numpy(c),
                            torch.from_numpy(mask), return_type=return_type,
                            **extra).numpy()
                      for c in (coors, _rotate(coors, R)))
    assert out.shape == (1, 32, 64) + ((3,) if return_type else ())
    assert np.isfinite(out).all()
    expected = _rotate(out, R) if return_type else out
    assert np.abs(out_r - expected).max() < EQUIVARIANCE_ATOL


@pytest.mark.parametrize('case', sorted(EQUIVARIANCE_CASES))
def test_equivariance_config_matches_jax(case):
    """The same configuration at reduced widths (dim 8, 2 heads of 8, n
    12) against the JAX module on converted parameters."""
    fields, return_type = EQUIVARIANCE_CASES[case]
    fields = dict(fields, dim=8, heads=2, dim_head=8)
    feats, coors, mask, extra = _equivariance_inputs(fields, 12, 8, seed=1)
    jm = JaxModule(**fields)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats, coors, mask=mask,
        return_type=return_type, **extra))['params']
    params = _random_params(shapes, 1)
    ref = np.asarray(jax.jit(lambda p: jm.apply(
        {'params': p}, feats, coors, mask=mask, return_type=return_type,
        **extra))(params))
    model = SE3TransformerModule(**fields, device='cpu')
    model.load_state_dict(convert_flax_params(params, model))
    with torch.no_grad():
        out = model(torch.from_numpy(feats), torch.from_numpy(coors),
                    torch.from_numpy(mask), return_type=return_type,
                    **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert out.shape == ref.shape
    assert _rel_err(out.numpy(), ref) <= RTOL_F32


# ---------------------------------------------------------------------- #
# the converter on every variant's tree
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('variant,core', [
    ('one_headed', 'flash'), ('linear_proj_keys', 'einsum'),
    ('tie', 'global'), ('null_kv', 'einsum'), ('global_feats', 'flash')])
def test_convert_is_total_on_variant_trees(variant, core):
    """The JAX tree of each variant converts one for one (to_global_k/v,
    a LinearSE3 to_k, no to_k under tie, the one-headed kv widths, the
    kNN null slots); a leaf the port lacks, or a parameter no leaf fills,
    raises."""
    fields = dict(BASE, **VARIANTS[variant], **CORES[core])
    feats, coors, mask, extra = _variant_inputs(fields)
    shapes = jax.eval_shape(lambda: JaxModule(**fields).init(
        jax.random.PRNGKey(0), feats, coors, mask=mask, return_type=1,
        **extra))['params']
    params = _random_params(shapes, 0)
    model = SE3TransformerModule(**fields, device='cpu')
    state = convert_flax_params(params, model)
    assert set(state) == set(model.state_dict())
    attn = params['trunk']['attn_block0']['attn']
    extra_leaf = dict(params, trunk=dict(params['trunk'], attn_block0=dict(
        params['trunk']['attn_block0'], attn=dict(attn, stray=np.zeros(3)))))
    with pytest.raises(ValueError, match='stray'):
        convert_flax_params(extra_leaf, model)
    missing = dict(params, trunk=dict(params['trunk'], attn_block0=dict(
        params['trunk']['attn_block0'],
        attn={k: v for k, v in attn.items() if k != 'to_v'})))
    with pytest.raises(ValueError, match='to_v'):
        convert_flax_params(missing, model)


# ---------------------------------------------------------------------- #
# refusals, with JAX's reasons
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('fields,match', [
    (dict(linear_proj_keys=True, tie_key_values=True),
     'cannot do linear projection of keys and tied key/values together'),
    (dict(linear_proj_keys=True, fuse_pairwise=True), 'conv keys'),
    (dict(rotary_position=True, fuse_pairwise=True),
     'does not support rotary embeddings'),
    (dict(rotary_rel_dist=True, fuse_pairwise=True),
     'does not support rotary embeddings'),
    (dict(linear_proj_keys=True, attention_mode='global',
          num_neighbors=float('inf')), 'needs conv keys'),
    (dict(rotary_position=True, attention_mode='global',
          num_neighbors=float('inf')), 'does not support rotary embeddings'),
    (dict(global_feats_dim=4, reversible=True),
     'reversibility and global features are not compatible'),
    (dict(global_feats_dim=4, reversible=True, attention_mode='global',
          num_neighbors=float('inf')),
     'reversibility and global features are not compatible')])
def test_model_refuses_what_jax_refuses(fields, match):
    with pytest.raises(ValueError, match=match):
        SE3TransformerModule(**dict(BASE, **fields), device='cpu')


def test_global_feats_passed_iff_global_feats_dim():
    feats, coors, mask, extra = _variant_inputs(
        dict(global_feats_dim=GLOBAL_DIM))
    args = [torch.from_numpy(a) for a in (feats, coors, mask)]
    gf = torch.from_numpy(extra['global_feats'])
    with_dim = SE3TransformerModule(**dict(BASE, global_feats_dim=GLOBAL_DIM),
                                    device='cpu')
    plain = SE3TransformerModule(**BASE, device='cpu')
    for model, kwargs in ((with_dim, {}), (plain, dict(global_feats=gf))):
        with pytest.raises(ValueError, match='global features must be '
                                             'passed iff global_feats_dim'):
            model(*args, return_type=1, **kwargs)


@pytest.mark.parametrize('kwargs,match', [
    (dict(linear_proj_keys=True, tie_key_values=True), 'linear projection'),
    (dict(linear_proj_keys=True, fuse_pairwise=True), 'conv keys'),
    (dict(linear_proj_keys=True, attention_mode='global'), 'conv keys'),
    (dict(kv_heads=3), 'kv_heads')])
def test_layer_refuses_what_jax_asserts(kwargs, match):
    with pytest.raises(ValueError, match=match):
        AttentionSE3(Fiber.create(2, 8), dim_head=8, heads=2, **kwargs)


@pytest.mark.parametrize('kwargs', [dict(fuse_pairwise=True,
                                         shared_radial_hidden=True),
                                    dict(attention_mode='global')])
def test_layer_refuses_rotary_past_the_unfused_cores(kwargs):
    attn = AttentionSE3(Fiber.create(2, 8), dim_head=8, heads=2, **kwargs)
    with pytest.raises(ValueError, match='rotary'):
        attn({}, (None, None, None), None, {}, None,
             (torch.zeros(1, 3, 8), torch.zeros(1, 3, 2, 8)))


def test_tied_operands_refuse_key_leftovers():
    """flash_operands and flash_global_operands: tie is wk None, and then
    no bk (nor rp_k) may come with it."""
    t = tflash._torch_ops(tflash._inputs())
    with pytest.raises(ValueError, match='tied'):
        tflash._run_port(t, h_k=None, wk=None)
    g = tglobal._torch(tglobal._inputs(0))
    with pytest.raises(ValueError, match='tied'):
        _global_tied(kf, tglobal._inputs(0), 0, rp_k=g['rp_k'])
    with pytest.raises(ValueError, match='untied keys need'):
        _global_tied(kf, tglobal._inputs(0), 0, wk=g['wk'], bk=g['bk'])
