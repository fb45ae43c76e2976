"""Quantized serving in the port (se3_transformer_torch.quant, and the
w3_scale epilogues of kernels #3 and #7) against the JAX package
(se3_transformer_tpu.quant) on the CPU: quantize's bits, the mixes and
their refusals, the port's quantized leaves and report against
quantize_params', the plain versions of the scaled arms against JAX's
interpret-mode kernel and XLA stream, the models' outputs on the same
quantized tree (the default conv, the shared trunk's grouped #3,
fuse_pairwise untied and tied, so2, global mode, the bf16 trunk; int8 and
fp8), equivariance at degrees 2 and 4, the engine's restore-time
quantization and the refused training step. Inputs and weights come from
numpy seeds."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import test_torch_flash as tflash
import test_torch_modules as tmodules
import test_torch_so2_flash as tso2
from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu import quant as jquant
from se3_transformer_tpu.kernels.pallas_pairwise import (
    fused_pairwise_conv as jax_fused_pairwise_conv,
)
from se3_transformer_torch import (
    DenoiseTrainer, InferenceEngine, SE3TransformerModule, convert_flax_params,
    pad_to_bucket, quant,
)
from se3_transformer_torch.convert import load_flax_params
from se3_transformer_torch.kernels import flash as kf
from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.ops.core import LinearSE3
from se3_transformer_torch.ops.fiber import Fiber
from se3_transformer_torch.quant import EquivariantPrecisionError, QuantTensor
from se3_transformer_torch.so3 import rot

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

# the plain scaled arms against JAX's: the same exact products (int8 and
# e4m3 upcast exactly) summed in other orders, relative to max|JAX|
RTOL = 1e-5
# the models on one quantized tree: float32 trunk, and the bf16 trunk
# (ROADMAP C's bound: bf16 roundings differ between the packages)
MODEL_RTOL = 1e-4
MODEL_RTOL_BF16 = 5e-2
# the JAX package's equivariance bar for quantized models
# (tests/test_quant.py::test_quantized_equivariance_degrees_2_4)
EQ_TOL = 1e-4

STORAGES = ('int8', 'fp8_e4m3')
MIXES = ('int8_mix', 'fp8_mix')


def _rel_err(out, ref):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _bits(a):
    """A quantized array's bits as numpy: int8 as it is, fp8 as uint8."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


def _jax_qt(qt):
    """The port's tensors of a JAX QuantTensor (q bits kept)."""
    from se3_transformer_torch.convert import _tensor
    return _tensor(qt.q), _tensor(qt.scale)


# ---------------------------------------------------------------------- #
# quantize, the mixes, the refusals
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('storage', STORAGES)
@pytest.mark.parametrize('shape,axes', [((16, 8, 4), (0,)), ((12, 5), (0,)),
                                        ((6, 9), (1,))])
def test_quantize_bits_match_jax(storage, shape, axes):
    """The same q bits and float32 scales, rounding included (a value at
    half a step, an all-zero channel)."""
    rng = np.random.RandomState(0)
    w = (rng.normal(size=shape) * 3.0).astype(np.float32)
    w.reshape(shape[0], -1)[:, 1] = 0.0
    w.flat[5] = w.flat[7]
    ref = jquant.quantize(w, contract_axes=axes, storage=storage)
    out = quant.quantize(w, contract_axes=axes, storage=storage)
    assert out.q.dtype == dict(int8=torch.int8,
                               fp8_e4m3=torch.float8_e4m3fn)[storage]
    assert np.array_equal(_bits(out.q), _bits(ref.q))
    assert np.array_equal(out.scale.numpy(), np.asarray(ref.scale))
    assert np.array_equal(quant.dequantize(out), jquant.dequantize(ref))


def test_mixes_and_their_errors_match_jax():
    for name in ('fp32', 'bf16', 'int8_mix', 'fp8_mix'):
        assert quant.resolve_mix(name) == jquant.resolve_mix(name)
        assert quant.mix_name(name) == jquant.mix_name(name) == name
    rules = ((r'(^|/)w0$', 'int8', 2), (r'.*', 'fp32'))
    assert quant.resolve_mix(rules) == tuple(rules)
    assert quant.mix_name(rules) == jquant.mix_name(rules) == 'custom'
    for mod in (quant, jquant):
        with pytest.raises(KeyError):
            mod.resolve_mix('int4_mix')
        with pytest.raises(ValueError):
            mod.resolve_mix(((r'.*', 'int4'),))
    for path, ndim in (('trunk/attn_block0/attn/to_q/w0', 2),
                       ('conv_in/w3_0_1', 3), ('to_v/project/w3', 2),
                       ('pair_1_1/Dense_1/kernel', 2), ('to_q/w2', 2),
                       ('norm/scale1', 3), ('x/wm2_1_3', 3)):
        for name in ('bf16', 'int8_mix', 'fp8_mix'):
            assert quant.resolve_precision(quant.MIXES[name], path, ndim) \
                == jquant.resolve_precision(jquant.MIXES[name], path, ndim)


class _Tree(torch.nn.Module):
    """A module tree named like a flax params tree: `to_q` a LinearSE3 of
    degrees 0 and 1 (w0, w1); with `mixer`, `to_v/project` holding a
    degree-3 LinearSE3 (a 2-d w3) and `pair_3_3` a 3-d radial w3."""

    def __init__(self, rng, mixer=False):
        super().__init__()
        if not mixer:
            self.to_q = LinearSE3(Fiber({0: 4, 1: 4}), Fiber({0: 4, 1: 4}))
        else:
            self.to_v = torch.nn.Module()
            self.to_v.project = LinearSE3(Fiber({3: 8}), Fiber({3: 8}))
            self.pair_3_3 = torch.nn.Module()
            self.pair_3_3.w3 = torch.nn.Parameter(torch.zeros(16, 8, 4))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(
                    rng.normal(size=p.shape).astype(np.float32)))

    def flax_tree(self):
        tree = {}
        for key, p in self.state_dict().items():
            *head, leaf = key.split('.')
            node = tree
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = p.numpy().copy()
        return tree


def test_int8_rule_on_equivariant_weight_raises():
    """An int8 rule on an l > 0 mixer raises in both packages and names it;
    nothing changes; the shipped mix takes w0 to int8 and w1 to bf16."""
    tree = _Tree(np.random.RandomState(2))
    flax = tree.flax_tree()
    rules = ((r'(^|/)w[01]$', 'int8'), (r'.*', 'fp32'))
    with pytest.raises(jquant.EquivariantPrecisionError) as ref:
        jquant.quantize_params(flax, rules)
    with pytest.raises(EquivariantPrecisionError) as err:
        quant.quantize_params(tree, rules)
    assert 'to_q/w1' in str(ref.value) and 'to_q/w1' in str(err.value)
    assert not quant.is_quantized(tree)
    _, report = quant.quantize_params(tree, 'int8_mix')
    _, jreport = jquant.quantize_params(flax, 'int8_mix')
    assert report == jreport
    assert isinstance(tree.to_q.w0, QuantTensor)
    assert tree.to_q.w1.dtype == torch.bfloat16
    assert report['leaves'] == jreport['leaves'] == {'int8': 1, 'bf16': 1}


def test_w3_mixer_rank_guard():
    """A num_degrees >= 4 model's 2-d w3 channel mixer goes to bf16 under
    int8_mix, the 3-d radial w3 to int8; an explicit unguarded int8 rule
    on the mixer raises."""
    tree = _Tree(np.random.RandomState(10), mixer=True)
    flax = tree.flax_tree()
    jq, jreport = jquant.quantize_params(flax, 'int8_mix')
    bad = ((r'(^|/)w3$', 'int8'), (r'.*', 'fp32'))
    with pytest.raises(EquivariantPrecisionError):
        quant.quantize_params(tree, bad)
    with pytest.raises(jquant.EquivariantPrecisionError):
        jquant.quantize_params(flax, bad)
    _, report = quant.quantize_params(tree, 'int8_mix')
    assert report == jreport
    assert tree.to_v.project.w3.dtype == torch.bfloat16
    assert isinstance(tree.pair_3_3.w3, QuantTensor)
    assert np.array_equal(_bits(tree.pair_3_3.w3.q),
                          _bits(jq['pair_3_3']['w3'].q))


def test_concat_weights_quantized_and_mixed():
    rng = np.random.RandomState(3)
    a = quant.quantize(rng.normal(size=(8, 4, 2)).astype(np.float32))
    b = quant.quantize(rng.normal(size=(8, 6, 2)).astype(np.float32))
    cat = quant.concat_weights([a, b], axis=1)
    assert isinstance(cat, QuantTensor)
    assert tuple(cat.shape) == (8, 10, 2)
    assert tuple(cat.scale.shape) == (1, 10, 2)
    ref = np.concatenate([quant.dequantize(a), quant.dequantize(b)], axis=1)
    assert np.array_equal(quant.dequantize(cat), ref)
    plain = torch.from_numpy(rng.normal(size=(8, 3, 2)).astype(np.float32))
    mixed = quant.concat_weights([a, plain], axis=1)
    assert not isinstance(mixed, QuantTensor)
    assert np.array_equal(mixed.numpy(), np.concatenate(
        [quant.dequantize(a), plain.numpy()], axis=1))


# ---------------------------------------------------------------------- #
# the scaled arms' plain versions
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('storage', STORAGES)
@pytest.mark.parametrize('h_dtype', ['float32', 'bfloat16'])
def test_pairwise_scaled_plain_matches_jax_interpret(storage, h_dtype):
    """fused_pairwise_conv_plain(w3_scale=) against the JAX Pallas kernel's
    scale-column epilogue in interpret mode."""
    rng = np.random.RandomState(4)
    E, mid, IF, O, P = 24, 16, 12, 8, 3
    h = rng.normal(size=(E, mid)).astype(np.float32)
    w3 = rng.normal(size=(mid, IF, O)).astype(np.float32)
    b3 = rng.normal(size=(IF, O)).astype(np.float32)
    v2 = rng.normal(size=(E, P, IF)).astype(np.float32)
    qt = jquant.quantize(w3, contract_axes=(0,), storage=storage)
    ref = jax_fused_pairwise_conv(
        jnp.asarray(h).astype(getattr(jnp, h_dtype)), jnp.asarray(qt.q),
        jnp.asarray(v2), b3=jnp.asarray(b3), interpret=True,
        w3_scale=jnp.asarray(qt.scale))
    q, scale = _jax_qt(qt)
    out = kp.fused_pairwise_conv(
        torch.from_numpy(h).to(getattr(torch, h_dtype)), q,
        torch.from_numpy(v2), torch.from_numpy(b3), w3_scale=scale)
    assert _rel_err(out, ref) <= RTOL


def test_pairwise_scaled_arm_refuses_gradients():
    rng = np.random.RandomState(5)
    qt = quant.quantize(rng.normal(size=(8, 6, 4)).astype(np.float32))
    h = torch.randn(5, 8, requires_grad=True)
    v2 = torch.randn(5, 3, 6)
    with pytest.raises(RuntimeError, match='serves only'):
        kp.fused_pairwise_conv(h, qt.q, v2, torch.zeros(6, 4),
                               w3_scale=qt.scale)
    with torch.no_grad():
        kp.fused_pairwise_conv(h, qt.q, v2, torch.zeros(6, 4),
                               w3_scale=qt.scale)


def _quantized_flash(ops, jax_kw, port_kw, storage, tie):
    """Quantize the call's wv (and wk) in JAX; the JAX and port keywords
    and the port's wv, wk."""
    t = tflash._torch_ops(ops)
    for c in ('v',) if tie else ('k', 'v'):
        qt = jquant.quantize(ops[f'w{c}'], contract_axes=(0,),
                             storage=storage)
        jax_kw.update({f'w{c}': jnp.asarray(qt.q),
                       f'w{c}_scale': jnp.asarray(qt.scale)})
        q, scale = _jax_qt(qt)
        port_kw[f'w{c}_scale'] = scale
        t[f'w{c}'] = q
    return t


@pytest.mark.parametrize('storage', STORAGES)
@pytest.mark.parametrize('arm', ['dense', 'so2'])
@pytest.mark.parametrize('tie', [False, True])
def test_flash_scaled_plain_matches_jax_stream(storage, arm, tie):
    """The plain stream with wv_scale / wk_scale against JAX's XLA stream
    on the same storage: untied and tied, both arms (masked, prefixed,
    bf16 h)."""
    if arm == 'so2':
        ops, jax_kw, port_kw = tso2._knn_case(seed=7, tie=tie)
        port_kw['sh'] = None
    else:
        ops, jax_kw, port_kw = tflash._inputs(seed=7), {}, {}
        if tie:
            for kw in (jax_kw, port_kw):
                kw.update(h_k=None, wk=None, bk=None)
    t = _quantized_flash(ops, jax_kw, port_kw, storage, tie)
    wv_j = jax_kw.pop('wv')
    ref = tflash._run_jax(dict(ops, wv=wv_j), **jax_kw)
    if not tie:
        port_kw['wk'] = t['wk']
    with torch.no_grad():
        out = tflash._run_port(t, **port_kw)
    assert _rel_err(out, ref) <= RTOL


# ---------------------------------------------------------------------- #
# the models on one quantized tree
# ---------------------------------------------------------------------- #
BASE = dict(dim=8, depth=1, num_degrees=2, output_degrees=2,
            reduce_dim_out=True, attend_self=True, num_neighbors=6,
            heads=2, dim_head=8)
SHARED = dict(BASE, shared_radial_hidden=True)
CASES = {
    # a radial trunk per pair (the JAX default surface; per-pair #3)
    'default': BASE,
    # the shared trunk's grouped convs (#3 on the concatenated V2)
    'grouped': dict(SHARED, edge_chunks=2),
    # basis-fused convs (#1 on the transient dequant), the bf16 trunk
    'fuse_basis_bf16': dict(SHARED, fuse_basis=True, radial_bf16=True),
    # the streaming attention (#7's scaled arm), untied and tied
    'fuse_pairwise': dict(SHARED, fuse_pairwise=True),
    'fuse_pairwise_tied': dict(SHARED, fuse_pairwise=True,
                               tie_key_values=True, use_null_kv=True),
    # the so2 backend per pair, and through #7's so2 arm
    'so2': dict(BASE, conv_backend='so2'),
    'so2_fuse_pairwise': dict(SHARED, conv_backend='so2', fuse_pairwise=True),
    # global attention (7g on the transient dequant)
    'global': dict(num_tokens=24, dim=8, depth=1, num_degrees=2,
                   output_degrees=2, reduce_dim_out=True, attend_self=True,
                   use_null_kv=True, heads=2, dim_head=8,
                   attention_mode='global'),
}
# fp8 storage on a case of each path (#3 per pair, #7's dense and so2
# arms, the global transient dequant)
FP8_CASES = ('default', 'fuse_pairwise', 'so2_fuse_pairwise', 'global')
N = 14


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    coords = np.cumsum(rng.normal(size=(1, N, 3)), axis=1).astype(np.float32)
    mask = np.ones((1, N), bool)
    mask[0, -2:] = False
    feats = rng.randint(0, 24, (1, N)) if 'num_tokens' in cfg else \
        rng.normal(size=(1, N, 8)).astype(np.float32)
    return feats, coords, mask


@pytest.fixture(scope='module')
def jax_models():
    """Per case: the JAX module and seeded float32 params (host numpy),
    made once."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = CASES[name]
            feats, coords, mask = _batch(cfg)
            jm = JaxModule(pallas=False, **cfg)
            shapes = jax.eval_shape(lambda: jm.init(
                jax.random.PRNGKey(0), feats, coords, mask=mask,
                return_type=1))['params']
            cache[name] = (jm, tflash_params(shapes, 3))
        return cache[name]
    return get


def tflash_params(shapes, seed):
    """Seeded values for every leaf (tests/test_torch_global.py's draw:
    the null slots nonzero too)."""
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


@pytest.mark.parametrize('case,mix', [(c, 'int8_mix') for c in sorted(CASES)]
                         + [(c, 'fp8_mix') for c in FP8_CASES])
def test_quantized_model_matches_jax(jax_models, case, mix):
    """JAX's apply and the port's forward on one quantized tree (JAX's
    quantize_params, converted with its bits); the port's own
    quantization of the float32 weights gives the same leaves and the
    same report."""
    cfg = CASES[case]
    jm, params = jax_models(case)
    qtree, jreport = jquant.quantize_params(params, mix)
    feats, coords, mask = _batch(cfg)
    ref = np.asarray(jax.jit(lambda p: jm.apply(
        {'params': p}, feats, coords, mask=mask, return_type=1))(qtree))
    tm = load_flax_params(SE3TransformerModule(**cfg, device='cpu'), qtree)
    assert quant.is_quantized(tm)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(a) for a in (feats, coords, mask)),
                 return_type=1)
    tol = MODEL_RTOL_BF16 if cfg.get('radial_bf16') else MODEL_RTOL
    assert _rel_err(out, ref) <= tol
    own = SE3TransformerModule(**cfg, device='cpu')
    own.load_state_dict(convert_flax_params(params, own))
    own, report = quant.quantize_params(own, mix)
    assert report == jreport
    want = tm.state_dict()
    got = own.state_dict()
    assert set(got) == set(want)
    def bits(t):
        return _bits(t) if t.dtype in (torch.int8, torch.float8_e4m3fn) \
            else t.float().numpy()
    for key, value in got.items():
        assert value.dtype == want[key].dtype, key
        assert np.array_equal(bits(value), bits(want[key])), key


# rule lists that give the keys' and the values' W3 different storage:
# only to_v quantized, and int8 keys beside fp8 values
MIXED_KV_RULES = {
    'values_int8': ((r'to_v/w3_\d+_\d+$', 'int8', 3), (r'.*', 'fp32')),
    'keys_int8_values_fp8': ((r'to_k/w3_\d+_\d+$', 'int8', 3),
                             (r'to_v/w3_\d+_\d+$', 'fp8_e4m3', 3),
                             (r'.*', 'fp32')),
}


def test_flash_limit_routes_mixed_w3_storage():
    """Kernel #7 is built with one W3 storage for the keys and the values:
    mixed storage is past flash_limit, one storage (float32, int8 or fp8)
    is not."""
    args = (tflash.PAIRS, 1, 8, 8, 8, 32, 1)
    for dt in (torch.float32, torch.int8, torch.float8_e4m3fn):
        assert kf.flash_limit(*args, storages=(dt, dt)) is None
    for pair in ((torch.int8, torch.float32), (torch.float32, torch.int8),
                 (torch.int8, torch.float8_e4m3fn)):
        assert 'mixed W3 storage' in kf.flash_limit(*args, storages=pair)


@pytest.mark.parametrize('rules', sorted(MIXED_KV_RULES))
def test_mixed_kv_storage_matches_jax_and_routes_on_a_card(
        jax_models, monkeypatch, rules):
    """A custom rule list that leaves the keys' and the values' W3 in
    different storage: the port matches JAX's apply on the same quantized
    tree, and decided as on a card the streaming block routes to the plain
    stream (counted in .routed, one call per output degree, with the
    mixed-storage warning) and gives the same output."""
    rule_list = MIXED_KV_RULES[rules]
    cfg = CASES['fuse_pairwise']
    jm, params = jax_models('fuse_pairwise')
    qtree, jreport = jquant.quantize_params(params, rule_list)
    feats, coords, mask = _batch(cfg)
    ref = np.asarray(jax.jit(lambda p: jm.apply(
        {'params': p}, feats, coords, mask=mask, return_type=1))(qtree))
    tm = load_flax_params(SE3TransformerModule(**cfg, device='cpu'), qtree)
    own = SE3TransformerModule(**cfg, device='cpu')
    own.load_state_dict(convert_flax_params(params, own))
    assert quant.quantize_params(own, rule_list)[1] == jreport
    inputs = [torch.from_numpy(a) for a in (feats, coords, mask)]
    with torch.no_grad():
        out = tm(*inputs, return_type=1)
    assert _rel_err(out, ref) <= MODEL_RTOL
    tmodules._on_a_card(monkeypatch)
    with pytest.warns(UserWarning, match='mixed W3 storage'):
        with torch.no_grad():
            routed = tm(*inputs, return_type=1)
    assert kf.flash_attention_fwd.routed == cfg['num_degrees']
    assert torch.equal(routed, out)


@pytest.mark.parametrize('degree', [2, 4])
@pytest.mark.parametrize('mix', ['int8_mix', 'bf16'])
def test_quantized_equivariance_degrees_2_4(degree, mix):
    """Weight-only quantization of the invariant-input matmuls keeps the
    vector output equivariant: the max per-node L2 error of f(R c) - f(c) R
    (JAX's equivariance_l2, rotation in float64 on the host)."""
    rng = np.random.RandomState(7)
    n = 24
    feats = torch.from_numpy(rng.normal(size=(1, n, 8)).astype(np.float32))
    coords = np.cumsum(rng.normal(size=(1, n, 3)), axis=1)
    mask = torch.ones(1, n, dtype=torch.bool)
    tm = SE3TransformerModule(
        dim=8, depth=1, num_degrees=degree + 1, output_degrees=2,
        reduce_dim_out=True, attend_self=True, num_neighbors=8, heads=2,
        dim_head=8, tie_key_values=True, device='cpu',
        generator=torch.Generator().manual_seed(4))
    quant.quantize_params(tm, mix)
    R = rot(0.37, 1.12, -0.64)

    def f(c):
        with torch.no_grad():
            return tm(feats, torch.from_numpy(c.astype(np.float32)),
                      mask=mask, return_type=1).double().numpy()
    err = np.sqrt(((f(coords @ R) - f(coords) @ R) ** 2).sum(-1)).max()
    assert err < EQ_TOL


def test_engine_quantizes_before_placing_and_serves():
    """InferenceEngine(precision=) quantizes on the host: no float32 copy of
    a quantized weight stays in the module, the report is the mix's, and
    its answers are the quantized model's."""
    cfg = dict(SHARED, fuse_pairwise=True)
    tm = SE3TransformerModule(**cfg, device='cpu',
                              generator=torch.Generator().manual_seed(5))
    engine = InferenceEngine(tm, buckets=(16,), device='cpu',
                             precision='int8_mix')
    assert engine.precision_name == 'int8_mix'
    assert engine.quant_report['bytes_ratio'] < 0.6
    assert engine.stats()['precision'] == 'int8_mix'
    names = {k for k, _ in engine.module.named_parameters()}
    quantized = [k for k, m in engine.module.named_modules()
                 if isinstance(m, QuantTensor)]
    assert quantized and not names & set(quantized)
    for key in quantized:
        qt = engine.module.get_submodule(key)
        assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32
    assert all(p.dtype in (torch.float32, torch.bfloat16)
               for p in engine.module.parameters())
    feats, coords, mask = _batch(cfg)
    out = engine.predict(feats[0, :12], coords[0, :12])
    padded = pad_to_bucket([feats[0, :12]], [coords[0, :12]], 16)
    with torch.no_grad():
        direct = tm(*(torch.from_numpy(a) for a in padded), return_type=1)
    assert np.array_equal(out, direct[0, :12].numpy())
    # an already quantized module is served as it is; a bad mix refuses
    again = InferenceEngine(tm, buckets=(16,), device='cpu',
                            precision='int8_mix')
    assert again.quant_report is None and again.module is tm
    assert again.precision_name == 'prequantized'
    with pytest.raises(KeyError):
        InferenceEngine(SE3TransformerModule(**cfg, device='cpu'),
                        buckets=(16,), device='cpu', precision='int4_mix')


@pytest.mark.parametrize('precision', [None, 'fp32'])
def test_engine_fp32_passes_through_as_jax_does(precision):
    """ROADMAP C2: an unquantized engine reports 'fp32' (precision_name and
    stats()['precision']), as JAX's does for None and 'fp32', and
    precision='fp32' serves the module as it is: no quant_report, no
    QuantTensor, the same parameters and answers."""
    cfg = dict(SHARED, fuse_pairwise=True)
    tm = SE3TransformerModule(**cfg, device='cpu',
                              generator=torch.Generator().manual_seed(7))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    engine = InferenceEngine(tm, buckets=(16,), device='cpu',
                             precision=precision)
    assert engine.precision_name == 'fp32'
    assert engine.stats()['precision'] == 'fp32'
    assert engine.quant_report is None and engine.module is tm
    assert not any(isinstance(m, QuantTensor) for m in tm.modules())
    for key, value in tm.state_dict().items():
        assert torch.equal(value, before[key]), key
    feats, coords, _ = _batch(cfg)
    out = engine.predict(feats[0, :12], coords[0, :12])
    padded = pad_to_bucket([feats[0, :12]], [coords[0, :12]], 16)
    with torch.no_grad():
        direct = tm(*(torch.from_numpy(a) for a in padded), return_type=1)
    assert np.array_equal(out, direct[0, :12].numpy())


def test_engine_fp8_mix():
    cfg = dict(SHARED, fuse_pairwise=True)
    tm = SE3TransformerModule(**cfg, device='cpu',
                              generator=torch.Generator().manual_seed(6))
    engine = InferenceEngine(tm, buckets=(16,), device='cpu',
                             precision='fp8_mix')
    storages = {m.q.dtype for m in engine.module.modules()
                if isinstance(m, QuantTensor)}
    assert storages == {torch.float8_e4m3fn}
    feats, coords, _ = _batch(cfg)
    out = engine.predict(feats[0], coords[0])
    assert out.shape == (N, 3) and np.isfinite(out).all()


def test_quantized_training_step_raises():
    """A quantized model refuses a training step (and any forward under
    autograd) loudly: no silent dequantize-and-train."""
    cfg = dict(SHARED, fuse_basis=True)
    tm = SE3TransformerModule(**cfg, device='cpu',
                              generator=torch.Generator().manual_seed(8))
    quant.quantize_params(tm, 'int8_mix')
    feats, coords, mask = _batch(cfg)
    trainer = DenoiseTrainer(tm, device='cpu')
    batch = dict(feats=feats, coords=coords, masks=mask)
    with pytest.raises(RuntimeError, match='serves only'):
        trainer.train_step(batch, noise=torch.zeros(1, N, 3))
    with pytest.raises(RuntimeError, match='serves only'):
        tm(*(torch.from_numpy(a) for a in (feats, coords, mask)))
