"""The port's fault injection (se3_transformer_torch.faults) and its wired
sites against the JAX package's: the injector fires on the same calls as
se3_transformer_tpu.faults.FaultInjector (at=, every=, match=, a seeded
p=), tears files as corrupt_path does; the checkpoint manager's
checkpoint_write / checkpoint_written sites (a torn entry falls back,
kill-and-resume past it, a dying async writer surfaces at the barrier,
torn-step-aware GC, loud writer joins); the producer's batch_source site
(retry, skip, fail loud); and the engine's engine_run site. The replica's
replica_dispatch site is held in tests/test_torch_fleet.py; the transport
and orbax cases of tests/test_faults.py have no counterpart in the port
(ROADMAP A8.2, and the port's torch.save format)."""
import os
import threading

import numpy as np
import pytest
import torch

from se3_transformer_tpu import faults as jfaults
from se3_transformer_tpu.observability import schema as jschema
from se3_transformer_torch import faults
from se3_transformer_torch.faults import (
    FaultInjector, InjectedFault, corrupt_path,
)
from se3_transformer_torch.inference import InferenceEngine
from se3_transformer_torch.training.checkpoint import CheckpointManager
from se3_transformer_torch.training.denoise import DenoiseConfig
from se3_transformer_torch.training.pipeline import (
    BatchProducer, BatchProducerError, PipelineStats, device_prefetch,
)

torch.set_num_threads(1)


def _drive(module, seed, plans, calls):
    """Fire `calls` ((site, ctx) pairs) at an injector of `module` with
    `plans`; -> (the injected log, which calls raised, the snapshot)."""
    slept = []
    inj = module.FaultInjector(seed=seed, sleep=slept.append)
    for site, kind, kw in plans:
        inj.plan(site, kind, **kw)
    outcome = []
    for site, ctx in calls:
        try:
            outcome.append(inj.fire(site, **ctx))
        except module.InjectedFault:
            outcome.append('raised')
    snap = inj.snapshot()
    return inj.injected, outcome, slept, snap


SCENARIOS = {
    'at': ([('site', 'exception', dict(at=(2, 4)))],
           [('site', {})] * 6),
    'match_every': ([('dispatch', 'exception',
                      dict(match=dict(replica=0), every=2))],
                    [('dispatch', dict(replica=1))] * 6
                    + [('dispatch', dict(replica=0))] * 5),
    'seeded_p': ([('s', 'exception', dict(p=0.5))], [('s', {})] * 32),
    'one_action_per_fire': ([('s', 'latency', dict(every=1, latency_s=0.5)),
                             ('s', 'latency', dict(every=1,
                                                   latency_s=0.25))],
                            [('s', {})] * 3),
    'training_sites': ([('step_batch', 'nan', dict(at=(3,))),
                        ('step_dispatch', 'exception', dict(at=(2,))),
                        ('step_dispatch', 'latency', dict(every=3,
                                                          latency_s=0.01)),
                        ('emergency_save', 'exception', dict(at=(1,))),
                        ('batch_source', 'drop', dict(p=0.3))],
                       [(site, dict(step=i))
                        for i in range(6)
                        for site in ('step_dispatch', 'step_batch',
                                     'batch_source')]
                       + [('emergency_save', dict(step=6))]),
    'max_fires': ([('s', 'nan', dict(every=1, max_fires=2))],
                  [('s', dict(bucket=8))] * 4),
}


@pytest.mark.parametrize('name', sorted(SCENARIOS))
@pytest.mark.parametrize('seed', [0, 7])
def test_injector_fires_as_jax_s(name, seed):
    """The same plans and calls: the same firings (site, kind, call, ctx),
    the same outcomes, sleeps and snapshot as JAX's injector."""
    plans, calls = SCENARIOS[name]
    assert _drive(faults, seed, plans, calls) == \
        _drive(jfaults, seed, plans, calls)
    injected, outcome, _, snap = _drive(faults, seed, plans, calls)
    assert snap['injections_total'] == len(injected) > 0
    assert snap['seed'] == seed


def test_injector_seeded_probability_is_reproducible():
    def pattern(seed):
        _, outcome, _, _ = _drive(faults, seed,
                                  [('s', 'exception', dict(p=0.5))],
                                  [('s', {})] * 32)
        return [o == 'raised' for o in outcome]
    a = pattern(7)
    assert a == pattern(7) and 0 < sum(a) < 32
    assert pattern(8) != a


def test_injector_refuses_a_malformed_plan():
    inj = FaultInjector()
    with pytest.raises(ValueError, match='unknown fault kind'):
        inj.plan('s', 'meteor', at=(1,))
    with pytest.raises(ValueError, match='exactly one'):
        inj.plan('s', 'exception', at=(1,), every=2)
    inj.plan('s', 'corrupt', at=(1,))
    with pytest.raises(ValueError, match='path='):
        inj.fire('s')
    raising = FaultInjector()
    raising.plan('t', at=(1,))
    with pytest.raises(InjectedFault, match='injected fault at t') as ei:
        raising.fire('t', step=4)
    assert ei.value.site == 't' and ei.value.ctx == dict(step=4)
    assert isinstance(ei.value, RuntimeError)


def test_corrupt_path_truncates_files_and_dirs_as_jax_s(tmp_path):
    for mod, sub in ((faults, 'port'), (jfaults, 'jax')):
        root = tmp_path / sub
        d = root / 'stepdir' / 'inner'
        d.mkdir(parents=True)
        f = root / 'blob.bin'
        f.write_bytes(b'x' * 1000)
        assert mod.corrupt_path(str(f), frac=0.5) == [str(f)]
        assert os.path.getsize(f) == 500
        for name in ('a', 'b'):
            (d / name).write_bytes(b'y' * 100)
        torn = mod.corrupt_path(str(root / 'stepdir'), frac=0.25)
        assert len(torn) == 2
        assert all(os.path.getsize(p) == 25 for p in torn)


# ---------------------------------------------------------------------- #
# the checkpoint sites
# ---------------------------------------------------------------------- #
def _state(step):
    return ({'w': torch.full((64,), float(step))}, {}, step)


def test_corrupt_plan_tears_the_newest_and_restore_falls_back(tmp_path):
    inj = FaultInjector(seed=0)
    inj.plan('checkpoint_written', 'corrupt', at=(3,), frac=0.3)
    cm = CheckpointManager(str(tmp_path), fault_injector=inj)
    for step in (1, 2, 3):
        cm.save(step, _state(step))
    assert inj.injected[0]['torn'] == [cm._path(3)]
    assert cm.latest_step() == 3
    with pytest.warns(RuntimeWarning, match='corrupt or partial'):
        state = cm.restore()
    assert state[2] == 2 and cm.last_restored_step == 2
    assert torch.equal(state[0]['w'], torch.full((64,), 2.0))
    with pytest.raises(Exception):
        cm.restore(step=3)      # a named step fails hard


def test_restore_raises_only_when_no_step_is_valid(tmp_path):
    inj = FaultInjector(seed=0)
    inj.plan('checkpoint_written', 'corrupt', every=1, frac=0.2)
    cm = CheckpointManager(str(tmp_path / 'ck'), fault_injector=inj)
    cm.save(1, _state(1))
    with pytest.warns(RuntimeWarning):
        with pytest.raises(RuntimeError, match='no restorable'):
            cm.restore()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / 'empty')).restore()


def test_kill_and_resume_past_a_torn_checkpoint(tmp_path):
    """A run that checkpoints every step through a writer that tears step 3
    (the kill mid-write); the restarted process restores the newest valid
    step and reaches the state a never-killed run reaches."""
    inj = FaultInjector(seed=0)
    inj.plan('checkpoint_written', 'corrupt', at=(3,), frac=0.4)
    cm = CheckpointManager(str(tmp_path), fault_injector=inj)

    def train_step(state):
        w, _, step = state
        return ({'w': w['w'] + 1.0}, {}, step + 1)

    state = ({'w': torch.zeros(4)}, {}, 0)
    for _ in range(3):
        state = train_step(state)
        cm.save(state[2], state)
    assert inj.injections_total == 1 and cm.latest_step() == 3
    resumed_cm = CheckpointManager(str(tmp_path))
    with pytest.warns(RuntimeWarning, match='corrupt or partial'):
        resumed = resumed_cm.restore()
    assert resumed[2] == 2
    while resumed[2] < 5:
        resumed = train_step(resumed)
        resumed_cm.save(resumed[2], resumed)
    assert torch.equal(resumed[0]['w'], torch.full((4,), 5.0))
    assert resumed_cm.restore()[2] == 5


def test_save_async_writer_crash_surfaces_at_the_barrier(tmp_path):
    inj = FaultInjector(seed=0)
    inj.plan('checkpoint_write', 'exception', at=(1,))
    cm = CheckpointManager(str(tmp_path), fault_injector=inj)
    cm.save_async(1, _state(1))
    with pytest.raises(RuntimeError, match='async checkpoint write'):
        cm.wait_until_finished()
    cm.save(2, _state(2))       # the manager is usable again
    assert cm.latest_step() == 2 and cm.all_steps() == [2]


def test_gc_never_deletes_the_newest_restorable_step(tmp_path):
    inj = FaultInjector(seed=0)
    inj.plan('checkpoint_written', 'corrupt', at=(2, 3), frac=0.2)
    cm = CheckpointManager(str(tmp_path), max_to_keep=1,
                           fault_injector=inj)
    with pytest.warns(RuntimeWarning, match='newest restorable'):
        for step in (1, 2, 3):
            cm.save(step, _state(step))
    assert inj.injections_total == 2
    assert 1 in cm.all_steps() and 3 in cm.all_steps()
    fresh = CheckpointManager(str(tmp_path))
    with pytest.warns(RuntimeWarning, match='corrupt or partial'):
        state = fresh.restore()
    assert fresh.last_restored_step == 1
    assert torch.equal(state[0]['w'], torch.full((64,), 1.0))


def test_verify_step_probe_cache_and_rewrite(tmp_path):
    """verify_step caches a proof; rewriting a step voids it, so a torn
    rewrite is seen (the guardian saves one step twice: at the window end
    and on the emergency path)."""
    cm = CheckpointManager(str(tmp_path / 'a'))
    cm.save(1, _state(1))
    assert cm.verify_step(1)
    corrupt_path(cm._path(1), frac=0.2)
    assert cm.verify_step(1)             # cached: proven before
    cm._verified.clear()
    assert not cm.verify_step(1)         # a fresh probe sees the tear
    inj = FaultInjector(seed=0)
    inj.plan('checkpoint_written', 'corrupt', at=(2,), frac=0.2)
    cm = CheckpointManager(str(tmp_path / 'b'), fault_injector=inj)
    cm.save(1, _state(1))
    assert cm.verify_step(1)
    cm.save(1, _state(1))                # the rewrite lands torn
    assert not cm.verify_step(1)         # its proof was voided


def test_writer_join_timeout_is_loud_and_keeps_the_thread(tmp_path):
    cm = CheckpointManager(str(tmp_path), writer_timeout_s=0.1)
    gate = threading.Event()
    inner = cm._write_state

    def gated_write(step, state):
        assert gate.wait(timeout=30)
        inner(step, state)

    cm._write_state = gated_write
    cm.save_async(1, _state(1))
    with pytest.warns(RuntimeWarning, match='still alive'):
        with pytest.raises(RuntimeError, match='wedged'):
            cm.close()
    gate.set()
    cm.wait_until_finished(timeout=30)
    assert cm.latest_step() == 1


def test_save_barrier_warns_but_waits_for_a_slow_write(tmp_path):
    inj = FaultInjector(seed=0, sleep=lambda s: None)
    inj.plan('checkpoint_write', 'latency', at=(1,), latency_s=5.0)
    cm = CheckpointManager(str(tmp_path), writer_timeout_s=0.05,
                           fault_injector=inj)
    gate = threading.Event()
    inner = cm._write_state

    def slow_write(step, state):
        assert gate.wait(timeout=30)
        inner(step, state)

    cm._write_state = slow_write
    cm.save_async(1, _state(1))
    threading.Timer(0.3, gate.set).start()
    with pytest.warns(RuntimeWarning, match='still alive'):
        cm.wait_until_finished()
    assert cm.latest_step() == 1
    assert inj.injected[0]['latency_s'] == 5.0


# ---------------------------------------------------------------------- #
# the producer's batch_source site
# ---------------------------------------------------------------------- #
def test_producer_retries_injected_source_faults_in_order():
    inj = FaultInjector(seed=0)
    inj.plan('batch_source', 'exception', at=(2, 5))
    with BatchProducer(lambda i: {'x': np.full((2,), i, np.float32)},
                       capacity=2, max_retries=2, retry_backoff_s=0.01,
                       fault_injector=inj) as bp:
        got = [float(next(bp)['x'][0]) for _ in range(5)]
    assert got == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert bp.retries == 2 and bp.skipped == 0
    assert [e['index'] for e in inj.injected] == [1, 3]


def test_producer_retries_injected_faults_on_an_iterator_source():
    """An injected fault is raised before the pull, so even a generator
    source retries it (the guarded loop's segments are generators)."""
    inj = FaultInjector(seed=0)
    inj.plan('batch_source', 'exception', at=(1, 3))
    gen = ({'x': np.full((2,), i, np.float32)} for i in range(4))
    with BatchProducer(gen, capacity=2, max_retries=1, retry_backoff_s=0.01,
                       fault_injector=inj) as bp:
        got = [float(b['x'][0]) for b in bp]
    assert got == [0.0, 1.0, 2.0, 3.0] and bp.retries == 2


def test_producer_skips_a_poison_batch_and_counts_it():
    def build(i):
        if i == 1:
            raise ValueError('poison batch')
        return {'x': np.full((2,), i, np.float32)}

    with BatchProducer(build, capacity=2, max_retries=1,
                       retry_backoff_s=0.01, max_skips=1) as bp:
        got = [float(next(bp)['x'][0]) for _ in range(3)]
    assert got == [0.0, 2.0, 3.0]
    assert bp.skipped == 1 and bp.retries == 1


def test_producer_iterator_source_errors_stay_fail_loud():
    def gen():
        yield {'x': np.zeros((2,), np.float32)}
        raise ValueError('in-generator failure')

    with BatchProducer(gen(), capacity=2, max_retries=3,
                       retry_backoff_s=0.01, max_skips=3,
                       fault_injector=FaultInjector(seed=0)) as bp:
        assert next(bp)['x'].shape == (2,)
        with pytest.raises(BatchProducerError) as ei:
            next(bp)
    assert isinstance(ei.value.__cause__, ValueError)
    assert bp.retries == 0 and bp.skipped == 0


def test_producer_spent_budgets_fail_structured():
    inj = FaultInjector(seed=0)
    inj.plan('batch_source', 'exception', every=1)
    with pytest.raises(BatchProducerError) as ei:
        with BatchProducer(lambda i: {'x': np.zeros(2)}, capacity=2,
                           max_retries=1, retry_backoff_s=0.01,
                           fault_injector=inj) as bp:
            next(bp)
    assert isinstance(ei.value.__cause__, InjectedFault)


def test_pipeline_stats_surface_the_source_counters():
    inj = FaultInjector(seed=0)
    inj.plan('batch_source', 'exception', at=(2,))
    stats = PipelineStats(depth=2, capacity=2)
    with BatchProducer(lambda i: {'x': np.zeros((2,), np.float32)},
                       capacity=2, max_retries=1, retry_backoff_s=0.01,
                       fault_injector=inj) as bp:
        stats.bind_source(bp)
        it = device_prefetch(bp, depth=2, device='cpu', stats=stats)
        for _ in range(4):
            next(it)
    snap = stats.snapshot()
    assert snap['source'] == dict(retries=1, skipped=0)
    jschema.validate_record(dict(kind='pipeline', run_id='t', **snap))


def test_producer_close_of_a_wedged_source_warns_and_raises():
    release = threading.Event()

    def blocked_source():
        yield 1
        release.wait()
        yield 2

    bp = BatchProducer(blocked_source(), name='leaky-producer')
    try:
        assert next(bp) == 1
        with pytest.warns(RuntimeWarning, match='wedged'):
            with pytest.raises(RuntimeError, match='leaky-producer'):
                bp.close(timeout=0.2)
    finally:
        release.set()
    bp._thread.join(timeout=5)
    assert not bp._thread.is_alive()


def test_producer_exit_never_masks_the_original_error():
    release = threading.Event()

    def blocked_source():
        yield 1
        release.wait()
        yield 2

    try:
        with pytest.warns(RuntimeWarning, match='wedged'):
            with pytest.raises(ValueError, match='original'):
                with BatchProducer(blocked_source(), capacity=1,
                                   name='masked-producer') as bp:
                    bp.close = lambda **kw: BatchProducer.close(
                        bp, timeout=0.2, **kw)
                    assert next(bp) == 1
                    raise ValueError('original')
    finally:
        release.set()


# ---------------------------------------------------------------------- #
# the engine's engine_run site
# ---------------------------------------------------------------------- #
def test_engine_fires_engine_run_once_per_run():
    """InferenceEngine(fault_injector=) fires engine_run with the bucket at
    every run() (predict goes through run); an exception plan raises out of
    that run and the next one serves."""
    module = DenoiseConfig(depth=1, dim=8).build_module(
        device='cpu', generator=torch.Generator().manual_seed(0))
    inj = FaultInjector(seed=0)
    inj.plan('engine_run', 'exception', at=(2,))
    engine = InferenceEngine(module, buckets=(12,), precompile=False,
                             fault_injector=inj, device='cpu')
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 24, size=(1, 12))
    coords = np.cumsum(rng.normal(size=(1, 12, 3)), 1).astype(np.float32)
    mask = np.ones((1, 12), bool)
    out = engine.run(12, tokens, coords, mask)
    with pytest.raises(InjectedFault, match='engine_run'):
        engine.run(12, tokens, coords, mask)
    torch.testing.assert_close(engine.run(12, tokens, coords, mask), out,
                               rtol=0, atol=0)
    engine.predict(tokens[0, :10], coords[0, :10])
    assert [e['bucket'] for e in inj.injected] == [12]
    assert inj._plans[0].calls == 4
