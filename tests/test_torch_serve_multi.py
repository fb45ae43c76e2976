"""The port's multi-replica serving on the real toy model, on the CPU: two
replicas of the serve entry point's model behind `serving.Router` answer as
one engine's `predict` does, before and after a rolling swap (sync and
async dispatch); the router refuses replicas that share weights; a mixed
fp32,int8_mix fleet leaves its fp32 replica equal to a fresh fp32 engine
bit for bit; the reload from a checkpoint with a torn latest step; the
serve and fault records under both packages' schemas; the entry points:
`python -m se3_transformer_torch.inference.serve --cpu --replicas 2
--async-dispatch --swap-at 4`, its refused cross-host flags, and both arms
of `python -m se3_transformer_torch.serving.chaos --cpu`."""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from se3_transformer_tpu.observability import schema as jschema
from se3_transformer_torch.faults import FaultInjector
from se3_transformer_torch.inference import InferenceEngine, RequestRejected
from se3_transformer_torch.inference import serve as tserve
from se3_transformer_torch.observability import MetricLogger, PhaseTimer
from se3_transformer_torch.observability import schema as tschema
from se3_transformer_torch.serving import (
    ReplicaWorker, Router, RouterTelemetry,
)
from se3_transformer_torch.training.checkpoint import CheckpointManager

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (12, 24)
BATCH = 2
# a request batched beside another against the same request alone in a
# padded batch of the same shape: the same float32 arithmetic up to the
# order of a few reductions
RTOL = 1e-5


def _args(*argv):
    return tserve.parse_args(['--cpu', *argv])


def _module(seed):
    return tserve.build_module_and_params(_args(), BUCKETS, seed=seed)[1]


def _engine(module, timer=None, **kw):
    return InferenceEngine(module, buckets=BUCKETS, batch_size=BATCH,
                           timer=timer, device='cpu', **kw)


def _requests(seed, lengths):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, tserve.TOY_NUM_TOKENS, size=n),
             rng.normal(size=(n, 3)).astype(np.float32) * 2.0)
            for n in lengths]


def _rel_err(out, ref):
    """max|out - ref| over max|ref| (a lone node's answer is all zeros)."""
    return float(np.abs(out - ref).max()
                 / max(float(np.abs(ref).max()), 1e-30))


def _subprocess_env():
    # one intra-op thread per process, as the test files set for themselves
    return dict(os.environ, OMP_NUM_THREADS='1')


@pytest.mark.parametrize('async_dispatch', [False, True])
def test_replicas_answer_as_predict_across_a_rolling_swap(async_dispatch):
    """Two replicas, each over its own copy of the module: every answer
    equals the request alone through one engine holding the state in
    effect, before and after the rolling swap; the swap reaches both
    replicas and nothing is dropped."""
    module = _module(0)
    state2 = _module(1).state_dict()
    timer = PhaseTimer()
    workers = [ReplicaWorker(i, _engine(copy.deepcopy(module), timer),
                             max_wait_ms=1.0, async_dispatch=async_dispatch)
               for i in range(2)]
    requests = _requests(5, (3, 12, 20, 7, 24, 1, 15, 11))
    with Router(workers) as router:
        before = [router.submit(*r) for r in requests[:4]]
        events = router.swap_weights(state2, tag='seed_1')
        assert all(p.done and p.ok for p in before)
        after = [router.submit(*r) for r in requests[4:]]
    assert [e['replica'] for e in events] == [0, 1]
    assert all(p.done and p.ok for p in after)
    assert router.continuous_admissions >= 1
    reference = _engine(module)
    for pending, reqs in ((before, requests[:4]), (after, requests[4:])):
        if pending is after:
            reference.params = state2
        for p, (tokens, coords) in zip(pending, reqs):
            alone = reference.predict(tokens, coords)
            assert p.result.shape == alone.shape
            assert _rel_err(p.result, alone) <= RTOL


def test_router_refuses_replicas_that_share_weights():
    module = _module(0)
    shared = [ReplicaWorker(i, _engine(module)) for i in range(2)]
    with pytest.raises(ValueError, match='same storage'):
        Router(shared)
    # one module served at two mixes: the int8 engine quantizes the module
    # the fp32 engine serves
    module = _module(0)
    mixed = [ReplicaWorker(0, _engine(module)),
             ReplicaWorker(1, _engine(module, precision='int8_mix'))]
    with pytest.raises(ValueError, match='same storage'):
        Router(mixed)
    Router([ReplicaWorker(i, _engine(copy.deepcopy(_module(0))))
            for i in range(2)]).close()


def test_mixed_precision_fleet_keeps_the_fp32_replica_bit_for_bit():
    """`--precision fp32,int8_mix`: the entry's replicas are built from
    their own module copies, so quantizing replica 1 leaves replica 0
    equal to a fresh fp32 engine bit for bit, before and after a rolling
    swap that re-quantizes replica 1 at its own mix."""
    args = _args('--replicas', '2', '--precision', 'fp32,int8_mix')
    assert tserve.precision_mixes(args) == ['fp32', 'int8_mix']
    _, module, params = tserve.build_module_and_params(args, BUCKETS)
    engines = tserve.build_replica_engines(args, module, params, BUCKETS,
                                           PhaseTimer())
    assert [e.precision_name for e in engines] == ['fp32', 'int8_mix']
    fresh = _engine(_module(0))
    requests = _requests(7, (5, 17))

    def same_as_fresh():
        ours = engines[0].params
        assert all(torch.equal(ours[k], v) for k, v in fresh.params.items())
        for r in requests:
            assert np.array_equal(engines[0].predict(*r), fresh.predict(*r))
    same_as_fresh()
    int8_fresh = _engine(_module(0), precision='int8_mix')
    for r in requests:
        assert np.array_equal(engines[1].predict(*r), int8_fresh.predict(*r))
    state2 = _module(1).state_dict()
    with Router([ReplicaWorker(i, e) for i, e in enumerate(engines)]) \
            as router:
        router.swap_weights(state2)
    fresh.params = state2
    same_as_fresh()
    int8_fresh.params = state2
    for r in requests:
        assert np.array_equal(engines[1].predict(*r), int8_fresh.predict(*r))
    # the whole entry point at that mix (a wait long enough that slots
    # fill: the entry gates on a request joining an open slot)
    assert tserve.main(['--cpu', '--replicas', '2', '--precision',
                        'fp32,int8_mix', '--max-wait-ms', '1000']) == 0


def test_swap_from_checkpoint_falls_back_past_a_torn_latest(tmp_path):
    inj = FaultInjector(seed=0)
    inj.plan('checkpoint_written', 'corrupt', at=(2,))
    mgr = CheckpointManager(str(tmp_path), fault_injector=inj)
    state1, state2 = _module(1).state_dict(), _module(2).state_dict()
    mgr.save(1, dict(params=state1))
    mgr.save(2, dict(params=state2))            # torn
    workers = [ReplicaWorker(i, _engine(_module(0))) for i in range(2)]
    with Router(workers) as router:
        with pytest.warns(RuntimeWarning, match='falling back'):
            events = router.swap_from_checkpoint(str(tmp_path))
    assert [e['tag'] for e in events] == [f'{tmp_path}@1'] * 2
    for w in workers:
        assert all(torch.equal(w.engine.params[k], v)
                   for k, v in state1.items())


def test_serve_and_fault_records_validate_under_both_schemas(tmp_path):
    """A router stream with an injected replica failure, a retry, a rolling
    swap and an oversize rejection: its serve, fault, cost and summary
    records validate under the port's schema and JAX's."""
    inj = FaultInjector(seed=0)
    inj.plan('replica_dispatch', 'exception', match=dict(replica=0),
             at=(1,))
    timer = PhaseTimer()
    workers = [ReplicaWorker(i, _engine(_module(0), timer), max_wait_ms=1.0,
                             fault_injector=inj) for i in range(2)]
    path = str(tmp_path / 'router.jsonl')
    logger = MetricLogger(path, mirror=None, run_meta=dict(mode='test'))
    with Router(workers, max_retries=2, default_timeout_s=60.0) as router:
        tele = RouterTelemetry(router, None, logger)
        tele.arm()
        pending = [router.submit(*r) for r in _requests(3, (4, 9, 13, 20))]
        with pytest.raises(RequestRejected):
            router.submit(*_requests(4, (30,))[0])
        router.drain()
        router.swap_weights(_module(1).state_dict(), tag='seed_1')
        serve = tele.flush()
        fault = tele.fault_flush(injector=inj, pending=pending, label='t')
        tele.close()
    logger.close()
    assert all(p.ok for p in pending)
    assert fault['lost_requests'] == 0 and fault['retries'] >= 1
    assert fault['injections_total'] == 1
    assert serve['swaps']['count'] == 2 and set(serve['replicas']) == {'0',
                                                                        '1'}
    assert tele.post_warmup_compiles == 0
    for validate in (tschema.validate_stream, jschema.validate_stream):
        kinds = validate(path)['kinds']
        assert kinds['serve'] == 1 and kinds['fault'] == 1
    for validate in (tschema.validate_record, jschema.validate_record):
        with pytest.raises(Exception, match='lost_requests'):
            validate(dict(fault, kind='fault', run_id='r',
                          lost_requests=-1))
        with pytest.raises(Exception, match='health'):
            validate(dict(serve, kind='serve', run_id='r',
                          health={'0': dict(state='on fire')}))


def test_serve_cli_multi_replica_async_with_a_swap(tmp_path):
    metrics, out = str(tmp_path / 's.jsonl'), str(tmp_path / 'r.json')
    proc = subprocess.run(
        [sys.executable, '-m', 'se3_transformer_torch.inference.serve',
         '--cpu', '--replicas', '2', '--async-dispatch', '--swap-at', '4',
         '--metrics', metrics, '--out', out], cwd=REPO,
        env=_subprocess_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as f:
        report = json.load(f)
    assert report['ok'] and report['replicas'] == 2
    assert report['async_dispatch']
    assert report['swaps']['count'] == 2
    assert report['requests']['answered'] == report['requests']['admitted']
    assert report['post_warmup_compiles'] == 0
    for validate in (tschema.validate_stream, jschema.validate_stream):
        assert validate(metrics)['kinds']['summary'] == 1


@pytest.mark.parametrize('argv', [
    ['--fleet', '3'], ['--host'], ['--port', '7000'], ['--host-id', '1'],
    ['--transport', 'legacy'], ['--poison-step', '3']])
def test_serve_cli_refuses_the_cross_host_flags(argv, capsys):
    with pytest.raises(SystemExit):
        tserve.parse_args(['--replicas', '2', *argv])
    assert 'ROADMAP A8.2' in capsys.readouterr().err


@pytest.mark.parametrize('weaken,rc', [('none', 0), ('drop', 1)])
def test_chaos_harness_arms(weaken, rc, tmp_path):
    """The clean arm passes every gate; the weakened arm (failures past the
    budget dropped silently) must fail the zero-lost gate."""
    metrics, out = str(tmp_path / 'c.jsonl'), str(tmp_path / 'c.json')
    proc = subprocess.run(
        [sys.executable, '-m', 'se3_transformer_torch.serving.chaos',
         '--cpu', '--weaken', weaken, '--metrics', metrics, '--out', out],
        cwd=REPO, env=_subprocess_env(), capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == rc, proc.stdout[-4000:] + proc.stderr[-2000:]
    with open(out) as f:
        report = json.load(f)
    if weaken == 'none':
        assert report['requests']['lost'] == 0
        assert report['recoveries'] >= 1 and report['timeouts'] >= 2
        assert report['swap_tag'].endswith('@1')
        for validate in (tschema.validate_stream, jschema.validate_stream):
            assert validate(metrics)['kinds']['fault'] == 1
    else:
        assert report['requests']['lost'] > 0
        assert 'FAIL: ' in proc.stdout and 'lost' in proc.stdout
