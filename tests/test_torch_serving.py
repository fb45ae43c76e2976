"""The port's serving stack (se3_transformer_torch.inference) against the JAX
package's (se3_transformer_tpu.inference) on the CPU: admission, the
micro-batcher and the running stats driven through the same scenarios
with a fake runner and an injected clock (the scenarios of
tests/test_inference.py); the engine on serve.py's toy model against
JAX's AOT engine per bucket, with bf16 activations and with int8_mix;
the weight swap, the params-only restore, the one-time-work watchdog;
and the serve entry point (`python -m se3_transformer_torch.inference.serve
--cpu`): its request stream, its gates, its telemetry under both schemas,
a SIGTERM mid-stream, its refused flags. Weights and inputs come from
numpy seeds: the toy model's flax init takes ~40 s eager (~17 s jitted)
on the CPU, so its params are drawn on the init's eval_shape tree."""
import functools
import importlib.util
import os
import signal
import subprocess
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu import inference as jinf
from se3_transformer_tpu.inference import admission as jadmission
from se3_transformer_tpu.inference import stats as jstats
from se3_transformer_tpu.native.loader import chain_adjacency
from se3_transformer_tpu.observability import schema as jschema
from se3_transformer_tpu.training.denoise import DenoiseConfig as JConfig
from se3_transformer_torch import CheckpointManager, ModelFamilyMismatch
from se3_transformer_torch import convert_flax_params
from se3_transformer_torch import inference as tinf
from se3_transformer_torch.basis import _qj_tensor
from se3_transformer_torch.faults import FaultInjector, InjectedFault
from se3_transformer_torch.inference import admission as tadmission
from se3_transformer_torch.inference import serve as tserve
from se3_transformer_torch.inference import stats as tstats
from se3_transformer_torch.observability import MetricLogger, RetraceWarning
from se3_transformer_torch.observability import schema as tschema
from se3_transformer_torch.training.denoise import DenoiseConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# serve.py's toy model (both packages' DenoiseConfig with these fields)
TOY = dict(num_tokens=24, dim=8, dim_head=8, heads=2, depth=2,
           num_degrees=2, max_sparse_neighbors=4)
BUCKETS = (12, 24)
BATCH = 2
RTOL_F32 = 1e-4
# bf16 activations: both engines round the coordinates to bf16 (8
# significant bits) and the port computes in float32 from there, which
# moves its answer by <= 1.6e-3 of max|out| on the toy model. JAX also
# forms the relative positions and distances in bf16 (bf16 - bf16 stays
# bf16 until it meets a float32 operand), which moves its own answer by
# 5e-3 to 8e-3 of max|out| from its float32 one; the two bf16 answers
# differ by up to 1.0e-2 (four seeds), the scale of the ROADMAP C bf16
# note. Matching JAX closer would take rounding the model's geometry, not
# the engine's input. The port's bf16 answer is also held to its own
# float32 one at the same bound.
RTOL_BF16 = 2e-2


def _load_jax_serve():
    spec = importlib.util.spec_from_file_location(
        'jax_serve_script', os.path.join(REPO, 'scripts', 'serve.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


@functools.lru_cache(maxsize=None)
def _flax_shapes():
    """The toy module and its flax param tree's shapes (eval_shape of its
    init at bucket 12)."""
    module = JConfig(**TOY).build_module()
    L = BUCKETS[0]
    return module, jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32),
        jnp.zeros((1, L, 3), jnp.float32), mask=jnp.ones((1, L), bool),
        adj_mat=jnp.asarray(chain_adjacency(L)), return_type=1))['params']


def _flax_params(seed):
    """Seeded draws on the toy module's flax param tree."""
    module, shapes = _flax_shapes()
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
    return module, jax.tree_util.tree_map_with_path(draw, shapes)


def _port_module(params=None):
    module = DenoiseConfig(**TOY).build_module(
        device='cpu', generator=torch.Generator().manual_seed(0))
    if params is not None:
        module.load_state_dict(convert_flax_params(params, module))
    return module


@pytest.fixture(scope='module')
def flax():
    return _flax_params(seed=3)


@pytest.fixture(scope='module')
def other_params():
    """A second seeded state for the swaps."""
    return _flax_params(seed=9)[1]


@pytest.fixture(scope='module')
def jax_engine(flax):
    module, params = flax
    return jinf.InferenceEngine(module, params, buckets=BUCKETS,
                                batch_size=BATCH, return_type=1)


@pytest.fixture(scope='module')
def port_engine(flax):
    return tinf.InferenceEngine(_port_module(flax[1]), buckets=BUCKETS,
                                batch_size=BATCH, device='cpu')


def _requests(seed, lengths):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 24, size=n),
             rng.normal(size=(n, 3)).astype(np.float32) * 2.0)
            for n in lengths]


# ---------------------------------------------------------------------- #
# admission, the micro-batcher, the stats: the same scenarios through both
# ---------------------------------------------------------------------- #
class _FakeRunner:
    """Records each call; answers each row's position index (the JAX
    test's runner). `boom` raises instead."""

    def __init__(self, boom=False):
        self.calls = []
        self.boom = boom

    def __call__(self, bucket, tokens, coords, mask):
        self.calls.append((bucket, np.asarray(tokens).tolist(),
                           np.asarray(coords).tolist(), mask.tolist()))
        if self.boom:
            raise RuntimeError('device OOM')
        return np.broadcast_to(
            np.arange(tokens.shape[1], dtype=np.float32)[None, :, None],
            tokens.shape[:2] + (3,))


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _pending(p):
    return dict(id=p.request_id, length=p.length, bucket=p.bucket,
                done=p.done, ok=p.ok,
                result=None if p.result is None else p.result.tolist(),
                error=None if p.error is None else str(p.error),
                latency=p.latency_s)


def _run_scenario(ns, scenario):
    """Drive one scenario through `ns` (either package's inference) and
    return everything observable, in order."""
    cfg, steps = scenario
    clock = _FakeClock()
    runner = _FakeRunner(boom=cfg.get('boom', False))
    ctl = None
    if 'admission' in cfg:
        ctl = ns.AdmissionController(**cfg['admission'])
    mb = ns.MicroBatcher(runner, buckets=cfg['buckets'],
                         batch_size=cfg['batch'],
                         max_wait_ms=cfg.get('wait_ms', 1e9),
                         admission=ctl, clock=clock)
    rng = np.random.RandomState(0)
    seen, pending = [], []
    for step in steps:
        op, arg = step if isinstance(step, tuple) else (step, None)
        try:
            if op == 'submit':
                p = mb.submit(rng.randint(0, 8, size=arg),
                              rng.normal(size=(arg, 3)).astype(np.float32))
                pending.append(p)
                seen.append(('submit', _pending(p)))
            elif op == 'tick':
                clock.t += arg
            elif op == 'pump':
                seen.append(('pump', mb.pump()))
            elif op == 'drain':
                seen.append(('drain', mb.drain()))
            elif op == 'deadline':
                seen.append(('deadline', mb.next_deadline()))
            elif op == 'pop':
                seen.append(('pop', [p.request_id
                                     for p in mb.pop_completed()]))
        except Exception as e:   # noqa: BLE001 - the record is compared
            record = e.to_record() if hasattr(e, 'to_record') else str(e)
            seen.append((op, type(e).__name__, getattr(e, 'code', None),
                         record))
        seen.append(('depth', mb.queue_depth))
    seen.append(('pending', [_pending(p) for p in pending]))
    seen.append(('calls', runner.calls))
    seen.append(('counters', mb.batches_dispatched, mb.rows_dispatched,
                 mb.fill_history, dict(mb.fill_stats)))
    if ctl is not None:
        seen.append(('admission', ctl.snapshot()))
    return seen


SCENARIOS = {
    # test_flush_on_full_dispatches_immediately
    'flush_on_full': (dict(buckets=(8,), batch=2),
                      [('submit', 3), ('submit', 8)]),
    # test_flush_on_deadline_pads_partial_batch
    'flush_on_deadline': (dict(buckets=(4, 8), batch=3, wait_ms=10.0),
                          [('submit', 3), 'pump', 'deadline',
                           ('tick', 0.005), 'pump', ('tick', 0.006),
                           'pump', 'deadline']),
    # test_runner_failure_resolves_every_request_with_the_error
    'runner_failure': (dict(buckets=(8,), batch=2, boom=True),
                       [('submit', 3), ('submit', 4), 'pop']),
    # test_drain_flushes_all_buckets
    'drain': (dict(buckets=(4, 8), batch=4),
              [('submit', 2), ('submit', 6), 'drain', 'deadline', 'pop']),
    # test_oversize_rejected_structurally
    'oversize': (dict(buckets=(16,), batch=2,
                      admission=dict(max_len=16)), [('submit', 17)]),
    # test_oversize_counted_rejected_even_with_loose_admission_max_len
    'oversize_loose_max_len': (dict(buckets=(16,), batch=2,
                                    admission=dict(max_len=600)),
                               [('submit', 20)]),
    # test_queue_depth_sheds_load
    'queue_depth_sheds': (dict(buckets=(16,), batch=8,
                               admission=dict(max_len=16,
                                              max_queue_depth=2)),
                          [('submit', 4), ('submit', 4), ('submit', 4),
                           'drain', ('submit', 4)]),
    # the overload shed's retry hint (the router's queue-depth estimate)
    'retry_after': (dict(buckets=(8, 16), batch=4, admission=dict(
        max_len=16, max_queue_depth=3,
        retry_hint=lambda depth: 0.0123456 * depth)),
        [('submit', 5), ('submit', 12), ('submit', 7), ('submit', 3),
         ('tick', 1.0), 'pump', ('submit', 16)]),
    # a mixed stream: flushes on full and on deadline in both buckets
    'mixed_stream': (dict(buckets=(4, 8), batch=2, wait_ms=5.0,
                          admission=dict(max_len=8, max_queue_depth=3)),
                     [('submit', 3), ('submit', 7), ('tick', 0.002),
                      ('submit', 1), ('submit', 9), ('tick', 0.004),
                      'deadline', 'pump', ('submit', 5), ('submit', 8),
                      ('submit', 2), 'drain', 'pop']),
}


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_batcher_and_admission_scenario_matches_jax(name):
    """The same submits, pumps and drains give the same dispatch order and
    batch membership, the same padded batches, results, latencies,
    rejection codes and records (retry_after_s included), counters and
    fill stats as JAX's classes."""
    ours = _run_scenario(tinf, SCENARIOS[name])
    ref = _run_scenario(jinf, SCENARIOS[name])
    assert ours == ref


def test_request_failed_and_fit_bucket_match_jax():
    for mod in (jadmission, tadmission):
        assert mod.fit_bucket((4, 8), 5) == 8 and \
            mod.fit_bucket((4, 8), 9) is None
    cases = [('retries_exhausted_error', (3,), dict(
                 cause=RuntimeError('boom'), retry_after_s=-1.0)),
             ('retries_exhausted_error', (1,), {}),
             ('deadline_error', (0.25, 0.2), dict(attempts=2,
                                                  retry_after_s=0.123456)),
             ('oversize_error', (30, 24), {})]
    for fn, args, kw in cases:
        ours = getattr(tadmission, fn)(*args, **kw)
        ref = getattr(jadmission, fn)(*args, **kw)
        assert (ours.code, ours.to_record()) == (ref.code, ref.to_record())
    assert tadmission.OVERSIZE == jadmission.OVERSIZE
    assert tadmission.OVERLOADED == jadmission.OVERLOADED


def test_running_stats_match_jax():
    values = np.random.RandomState(4).exponential(3.0, size=37).tolist()
    for mod in (tstats, jstats):
        assert mod.agg_stats(mod.agg_zero()) == dict(
            count=0, mean=None, min=None, max=None)
    ours = tstats.agg_update(tstats.agg_zero(), values)
    ref = jstats.agg_update(jstats.agg_zero(), values)
    assert ours == ref
    assert tstats.agg_stats(ours) == jstats.agg_stats(ref)
    assert tstats.window_stats(values) == jstats.window_stats(values)
    assert tstats.window_stats([]) == jstats.window_stats([])


# ---------------------------------------------------------------------- #
# the engine against JAX's on serve.py's toy model
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('bucket', BUCKETS)
def test_engine_matches_jax_per_bucket(flax, jax_engine, port_engine,
                                       bucket):
    """A padded batch of two requests in each bucket: the port's engine
    answers what JAX's AOT engine answers, within 1e-4 of max|out|; each
    request alone through predict answers its batch row."""
    lo = 1 if bucket == BUCKETS[0] else BUCKETS[0] + 1
    reqs = _requests(bucket, (lo + 2, bucket))
    toks = [t for t, _ in reqs]
    crds = [c for _, c in reqs]
    jt, jc, jm = jinf.batching.pad_to_bucket(toks, crds, bucket,
                                             batch_size=BATCH)
    ref = np.asarray(jax_engine.run(bucket, jt, jc, jm))
    t, c, m = tinf.pad_to_bucket(toks, crds, bucket, batch_size=BATCH)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(m, jm)
    out = port_engine.run(bucket, t, c, m).numpy()
    assert out.shape == ref.shape == (BATCH, bucket, 3)
    for row, (tokens, coords) in enumerate(reqs):
        n = len(tokens)
        assert _rel_err(out[row, :n], ref[row, :n]) <= RTOL_F32
        alone = port_engine.predict(tokens, coords)
        assert _rel_err(alone, ref[row, :n]) <= RTOL_F32
    key = (bucket, BATCH, 'float32')
    assert key in port_engine.executables and \
        key in jax_engine.executables
    assert port_engine.bucket_for(bucket) == jax_engine.bucket_for(bucket)


def test_engine_surface_matches_jax(jax_engine, port_engine):
    ours, ref = port_engine.stats(), jax_engine.stats()
    assert set(ref) <= set(ours)
    for key in ('buckets', 'batch_size', 'dtype', 'sharding', 'precision',
                'model_family', 'quant', 'executables', 'kernel_tuning'):
        assert ours[key] == ref[key], key
    assert set(ours['compile_seconds']) == set(ref['compile_seconds'])
    # the CPU has no allocator peak: no cost record rather than a zero one
    assert port_engine.cost_payloads == {} and \
        ours['peak_hbm_by_bucket'] == {}
    assert port_engine.max_len == jax_engine.max_len
    assert tinf.bucket_phase(24) == jinf.bucket_phase(24)
    with pytest.raises(tinf.RequestRejected) as e:
        port_engine.predict(*_requests(5, (25,))[0])
    assert e.value.to_record() == jadmission.oversize_error(25, 24) \
        .to_record()
    for field, value in (('mesh', object()), ('partition_rules', 'tp')):
        with pytest.raises(ValueError, match='ROADMAP A7'):
            tinf.InferenceEngine(_port_module(), device='cpu',
                                 precompile=False, **{field: value})
    # fault_injector is ported: JAX's engine_run site, first thing in run()
    inj = FaultInjector(seed=0)
    inj.plan('engine_run', 'exception', at=(1,))
    engine = tinf.InferenceEngine(_port_module(), device='cpu',
                                  precompile=False, fault_injector=inj)
    toks, crds = zip(*_requests(5, (20,)))
    with pytest.raises(InjectedFault, match='engine_run'):
        engine.run(24, *tinf.pad_to_bucket(list(toks), list(crds), 24))
    assert inj.injected == [dict(site='engine_run', kind='exception',
                                 call=1, bucket=24)]


@pytest.mark.parametrize('mode', ['bf16', 'int8_mix'])
def test_engine_activation_dtype_and_precision_match_jax(flax, mode):
    """activation_dtype=bf16 and precision='int8_mix' at bucket 12: the
    port's engine against JAX's. int8_mix quantizes the same float32
    weights to the same bits on both sides: within 1e-4. bf16: within
    RTOL_BF16 (its comment gives the reason), and within it of the port's
    own float32 answer."""
    module, params = flax
    bucket = BUCKETS[0]
    kw = dict(activation_dtype=jnp.bfloat16) if mode == 'bf16' \
        else dict(precision=mode)
    ref_engine = jinf.InferenceEngine(module, params, buckets=(bucket,),
                                      batch_size=BATCH, return_type=1, **kw)
    kw = dict(activation_dtype=torch.bfloat16) if mode == 'bf16' \
        else dict(precision=mode)
    engine = tinf.InferenceEngine(_port_module(params), buckets=(bucket,),
                                  batch_size=BATCH, device='cpu', **kw)
    assert engine.dtype_name == ref_engine.dtype_name
    assert engine.executables == set(ref_engine.executables)
    reqs = _requests(11, (9, 12))
    t, c, m = tinf.pad_to_bucket([r[0] for r in reqs], [r[1] for r in reqs],
                                 bucket, batch_size=BATCH)
    ref = np.asarray(ref_engine.run(bucket, t.astype(np.int32), c, m))
    out = engine.run(bucket, t, c, m).numpy()
    assert out.dtype == np.float32
    for row, (tokens, _) in enumerate(reqs):
        n = len(tokens)
        if mode == 'bf16':
            assert _rel_err(out[row, :n], ref[row, :n]) <= RTOL_BF16
        else:
            assert _rel_err(out[row, :n], ref[row, :n]) <= RTOL_F32
    if mode == 'int8_mix':
        assert engine.stats()['quant'] == ref_engine.stats()['quant']
    else:
        fp32 = tinf.InferenceEngine(_port_module(params), buckets=(bucket,),
                                    batch_size=BATCH, device='cpu')
        assert _rel_err(out, fp32.run(bucket, t, c, m).numpy()) <= RTOL_BF16


# ---------------------------------------------------------------------- #
# the weight swap, the params-only restore
# ---------------------------------------------------------------------- #
def test_weight_swap_equals_a_fresh_engine_bit_for_bit(flax, other_params):
    """engine.params = other: the placed tensors are written in place (the
    same storage), and the answers are a fresh engine's on `other`, bit
    for bit; a state of the wrong shape, dtype or keys raises before
    anything is copied."""
    _, params = flax
    other = _port_module(other_params).state_dict()
    engine = tinf.InferenceEngine(_port_module(params), buckets=(12,),
                                  batch_size=BATCH, device='cpu')
    before = {k: v.data_ptr() for k, v in engine.params.items()}
    reqs = _requests(12, (7, 12))
    t, c, m = tinf.pad_to_bucket([r[0] for r in reqs], [r[1] for r in reqs],
                                 12, batch_size=BATCH)
    old = engine.run(12, t, c, m)
    engine.params = other
    assert {k: v.data_ptr() for k, v in engine.params.items()} == before
    fresh = tinf.InferenceEngine(_port_module(), buckets=(12,),
                                 batch_size=BATCH, device='cpu')
    fresh.module.load_state_dict(other)
    new = engine.run(12, t, c, m)
    assert torch.equal(new, fresh.run(12, t, c, m))
    assert not torch.equal(new, old)
    key = next(iter(other))
    for bad, match in (({**other, key: other[key][..., :1]}, 'holds'),
                       ({**other, key: other[key].double()}, 'holds'),
                       ({k: v for k, v in other.items() if k != key},
                        'lacks'),
                       ({**other, 'extra': torch.zeros(1)}, 'unknown')):
        with pytest.raises(ValueError, match=match):
            engine.params = bad
    assert torch.equal(engine.run(12, t, c, m), new)


def test_int8_swap_requantizes_as_a_fresh_int8_engine(flax, other_params):
    """An int8_mix engine given a float32 state re-quantizes it at its own
    mix: its state is a fresh int8_mix engine's on that state, bit for
    bit, and so are its answers; a state already quantized passes
    through."""
    _, params = flax
    float_state = _port_module(other_params).state_dict()
    engine = tinf.InferenceEngine(_port_module(params), buckets=(12,),
                                  batch_size=BATCH, device='cpu',
                                  precision='int8_mix')
    fresh = tinf.InferenceEngine(_port_module(other_params),
                                 buckets=(12,), batch_size=BATCH,
                                 device='cpu', precision='int8_mix')
    engine.params = float_state
    ours, ref = engine.params, fresh.params
    assert set(ours) == set(ref)
    assert any(k.endswith('.q') and v.dtype == torch.int8
               for k, v in ours.items())
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k],
                                                             ref[k]), k
    reqs = _requests(13, (12,))
    t, c, m = tinf.pad_to_bucket([reqs[0][0]], [reqs[0][1]], 12,
                                 batch_size=BATCH)
    assert torch.equal(engine.run(12, t, c, m), fresh.run(12, t, c, m))
    engine.params = {k: v.clone() for k, v in ref.items()}
    assert all(torch.equal(engine.params[k], ref[k]) for k in ref)


def test_from_checkpoint_restores_params_only(flax, tmp_path):
    _, params = flax
    trained = _port_module(params)
    state = trained.state_dict()
    opt_state = {'state': {0: {'exp_avg': torch.ones(3)}}, 'param_groups': []}
    CheckpointManager(str(tmp_path / 'v1'), model_family='se3_v1').save(
        5, (state, opt_state, 5))
    engine = tinf.InferenceEngine.from_checkpoint(
        _port_module(), str(tmp_path / 'v1'), buckets=(12,),
        batch_size=BATCH, device='cpu')
    direct = tinf.InferenceEngine(trained, buckets=(12,), batch_size=BATCH,
                                  device='cpu')
    assert engine.executables == direct.executables
    tokens, coords = _requests(14, (10,))[0]
    np.testing.assert_array_equal(engine.predict(tokens, coords),
                                  direct.predict(tokens, coords))
    # a checkpoint of another model family refuses before any tensor
    CheckpointManager(str(tmp_path / 'v2'), model_family='se3_v2').save(
        1, (state, opt_state, 1))
    with pytest.raises(ModelFamilyMismatch):
        tinf.InferenceEngine.from_checkpoint(
            _port_module(), str(tmp_path / 'v2'), buckets=(12,),
            device='cpu')


# ---------------------------------------------------------------------- #
# the watchdog and the records of a served stream
# ---------------------------------------------------------------------- #
def test_watchdog_zero_on_a_warmed_stream_and_counts_a_forced_miss(
        port_engine, tmp_path):
    """A mixed-length stream over the warmed buckets sets off no one-time
    work; a cleared device-constant cache makes the next request rebuild
    its constants, which the next flush counts and warns of. Every record
    written validates under the port's schema and JAX's."""
    path = str(tmp_path / 'serve.jsonl')
    ctl = tinf.AdmissionController(max_len=port_engine.max_len,
                                   max_queue_depth=8)
    batcher = tinf.MicroBatcher(port_engine.run, buckets=BUCKETS,
                                batch_size=BATCH, max_wait_ms=0.0,
                                admission=ctl)
    with MetricLogger(path, mirror=None) as logger:
        tele = tinf.ServeTelemetry(port_engine, batcher, ctl, logger)
        tele.arm()
        for tokens, coords in _requests(15, (3, 12, 20, 24, 5, 13, 30)):
            try:
                batcher.submit(tokens, coords)
            except tinf.RequestRejected as e:
                logger.log_record('step', mirror=False, step=0,
                                  rejected=e.to_record())
            batcher.pump(now=batcher.clock() + 1.0)
        rec = tele.flush()
        assert rec['post_warmup_compiles'] == 0
        assert set(rec['buckets']) == {'12', '24'}
        assert rec['requests']['served'] >= 6
        assert rec['requests']['rejected']['oversize'] == 1
        _qj_tensor.cache_clear()
        batcher.submit(*_requests(16, (9,))[0])
        batcher.drain()
        with pytest.warns(RetraceWarning):
            rec = tele.flush()
        assert rec['post_warmup_compiles'] > 0
        summary = tele.close()
    assert summary['post_warmup_compiles'] == rec['post_warmup_compiles']
    assert summary['retrace_warnings_total'] == 1
    assert summary['metrics']['batch_fill']['count'] == \
        batcher.batches_dispatched
    for validate in (tschema.validate_stream, jschema.validate_stream):
        info = validate(path)
        assert info['kinds'] == {'run_meta': 1, 'step': 1, 'serve': 2,
                                 'summary': 1}


# ---------------------------------------------------------------------- #
# the serve entry point
# ---------------------------------------------------------------------- #
def test_request_lengths_match_jax():
    jserve = _load_jax_serve()
    for argv, buckets in (([], (12, 24)),
                          (['--requests', '13', '--oversize', '3',
                            '--seed', '7'], (64, 128, 256))):
        ours = tserve.request_lengths(tserve.parse_args(argv), buckets,
                                      buckets[-1], np.random.RandomState(5))
        ref = jserve.request_lengths(jserve.parse_args(argv), buckets,
                                     buckets[-1], np.random.RandomState(5))
        assert ours == ref


def test_serve_cli_cpu_answers_rejects_and_validates(tmp_path, capsys):
    metrics, out = str(tmp_path / 's.jsonl'), str(tmp_path / 'r.json')
    assert tserve.main(['--cpu', '--requests', '6', '--oversize', '2',
                        '--metrics', metrics, '--out', out]) == 0
    import json
    with open(out) as f:
        report = json.load(f)
    assert report['ok'] and report['interrupted'] is None
    assert report['requests']['answered'] == report['requests']['admitted'] \
        == 6
    assert report['requests']['rejected'] == dict(oversize=2, overloaded=0)
    assert report['post_warmup_compiles'] == 0
    assert set(report['compile_seconds']) == {'12', '24'}
    for validate in (tschema.validate_stream, jschema.validate_stream):
        assert validate(metrics)['kinds']['summary'] == 1


def test_serve_cli_sigterm_drains_flushes_and_exits_zero(tmp_path):
    metrics = str(tmp_path / 's.jsonl')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'se3_transformer_torch.inference.serve',
         '--cpu', '--requests', '500', '--pace-ms', '20', '--metrics',
         metrics], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        for line in proc.stdout:
            if line.startswith('serving '):    # the guard is installed
                break
        time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        rest = proc.stdout.read()
        assert proc.wait(timeout=60) == 0, rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert 'SIGTERM: graceful shutdown' in rest
    assert '"interrupted": "SIGTERM"' in rest
    info = tschema.validate_stream(metrics)
    assert info['kinds']['summary'] == 1 and info['kinds']['serve'] >= 1


@pytest.mark.parametrize('argv', [
    ['--replicas', '2'], ['--fleet', '3'], ['--swap-at', '4'],
    ['--async-dispatch'], ['--timeout-s', '1'], ['--max-retries', '2'],
    ['--host'], ['--port', '7000'], ['--host-id', '1'],
    ['--transport', 'legacy'], ['--poison-step', '3'],
    ['--precision', 'fp32,int8_mix']])
def test_serve_cli_refuses_the_fleet_flags(argv, capsys):
    """The cross-host fleet's flags are refused with ROADMAP A8.2, and a
    comma --precision list with one replica with the fleet's name; the
    multi-replica router's flags are ported and parse."""
    ported = {'--replicas': 2, '--swap-at': 4, '--async-dispatch': True,
              '--timeout-s': 1.0, '--max-retries': 2}
    if argv[0] in ported:
        args = tserve.parse_args(argv)
        assert getattr(args, argv[0][2:].replace('-', '_')) == \
            ported[argv[0]]
        return
    with pytest.raises(SystemExit):
        tserve.parse_args(argv)
    err = capsys.readouterr().err
    assert 'ROADMAP A8.2' in err or 'fleet' in err


def test_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    with pytest.raises(RuntimeError):
        tinf.InferenceEngine(_port_module(), buckets=(12,))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with pytest.raises(RuntimeError):
            tserve.main(['--requests', '1'])
