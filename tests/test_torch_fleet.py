"""The port's single-host fleet tier (se3_transformer_torch.serving: the
continuous batcher, the replica workers, the router with its health
breakers, retries and deadlines, the router telemetry) against the JAX
package's (se3_transformer_tpu.serving) on the CPU.

Each scenario of tests/test_serving.py is one function of a package
namespace that drives fake engines (the JAX tests' engine: it records the
replica, bucket and params version of every dispatch and answers each
row's position) under an injected clock, and returns everything it
observed: the dispatch log, every request's resolution (error codes,
details and retry_after_s included), every counter, the health snapshots
and transition lists, the swap events. The port's trace must equal JAX's
in every scenario. No scenario sleeps."""
import threading
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _namespace(name):
    """The classes a scenario needs, from one package."""
    if name == 'jax':
        from se3_transformer_tpu import faults, serving
        from se3_transformer_tpu.inference import admission, batching
        from se3_transformer_tpu.observability import PhaseTimer, schema
    else:
        from se3_transformer_torch import faults, serving
        from se3_transformer_torch.inference import admission, batching
        from se3_transformer_torch.observability import PhaseTimer, schema
    return types.SimpleNamespace(
        name=name, ContinuousBatcher=serving.ContinuousBatcher,
        ReplicaWorker=serving.ReplicaWorker, Router=serving.Router,
        RouterTelemetry=serving.RouterTelemetry,
        HealthConfig=serving.HealthConfig,
        HealthMonitor=serving.HealthMonitor,
        PendingResult=batching.PendingResult,
        AdmissionController=admission.AdmissionController,
        RequestRejected=admission.RequestRejected,
        RequestFailed=admission.RequestFailed, PhaseTimer=PhaseTimer,
        FaultInjector=faults.FaultInjector,
        validate_record=schema.validate_record)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _FakeEngine:
    """tests/test_serving.py's engine: records (replica, bucket, params)
    of every call into a shared log, answers each row's position index;
    its next `fail_next` calls raise (the flaky engine)."""

    def __init__(self, ns, rid=0, log=None, buckets=(4, 8), batch_size=2,
                 timer=None):
        self.rid = rid
        self.log = log if log is not None else []
        self.buckets = tuple(buckets)
        self.batch_size = batch_size
        self.rows_served = {b: 0 for b in self.buckets}
        self.calls = []
        self.params = 'v0'
        self.timer = timer if timer is not None else ns.PhaseTimer()
        self.executables = {}
        self.cost_payloads = {}
        self.fail_next = 0

    def run(self, bucket, tokens, coords, mask):
        if self.fail_next > 0:
            self.fail_next -= 1
            self.calls.append((bucket, 'FAIL'))
            self.log.append((self.rid, int(bucket), 'FAIL'))
            raise RuntimeError('replica runner exploded')
        self.calls.append((bucket, self.params))
        self.log.append((self.rid, int(bucket), self.params,
                         int(np.asarray(mask).any(-1).sum())))
        self.rows_served[bucket] += int(np.asarray(mask).any(-1).sum())
        with self.timer.phase(f'bucket_{bucket}'):
            pass
        return np.broadcast_to(
            np.arange(tokens.shape[1], dtype=np.float32)[None, :, None],
            tokens.shape + (3,))

    def stats(self):
        return dict(buckets=list(self.buckets),
                    batch_size=self.batch_size)


def _request(rng, length):
    return (rng.randint(0, 8, size=length),
            rng.normal(size=(length, 3)).astype(np.float32))


def _error(e):
    if e is None:
        return None
    return (type(e).__name__, getattr(e, 'code', None), str(e),
            dict(getattr(e, 'detail', {})))


def _pending(p):
    return dict(id=p.request_id, length=p.length, bucket=p.bucket,
                done=p.done, ok=p.ok, attempts=p.attempts,
                deadline=p.deadline, latency=p.latency_s,
                result=None if p.result is None else p.result.tolist(),
                error=_error(p.error))


def _router_state(router):
    return dict(
        queue_depth=router.queue_depth,
        continuous_admissions=router.continuous_admissions,
        deadline_flushes=router.deadline_flushes,
        batches=router.batches_dispatched, timeouts=router.timeouts,
        deadline_sheds=router.deadline_sheds, retries=router.retries,
        request_failures=router.request_failures,
        depth_by_bucket=router.depth_by_bucket,
        replicas={w.id: w.snapshot() for w in router.workers},
        health=router.health.snapshot(),
        transitions=router.health.transitions,
        recoveries=router.health.recoveries,
        swap_events=list(router.swap_events))


def _batcher_state(cb):
    return dict(depth=cb.depth, continuous_admissions=cb.continuous_admissions,
                deadline_flushes=cb.deadline_flushes,
                batches=cb.batches_dispatched, rows=cb.rows_dispatched,
                timeouts=cb.timeouts, deadline_sheds=cb.deadline_sheds)


def _attempt(trace, label, fn):
    """Call fn, recording its result or the exception it raised."""
    try:
        out = fn()
    except Exception as e:   # noqa: BLE001 - the trace compares it
        trace.append((label, 'raised', _error(e)))
        return None
    trace.append((label, out))
    return out


def _router(ns, n=2, buckets=(4, 8), batch_size=2, max_wait_ms=10.0,
            max_queue_depth=None, health=None, max_retries=1,
            timeout_s=None, async_dispatch=False, engine_cls=_FakeEngine,
            **engine_kw):
    clock = _Clock()
    timer = ns.PhaseTimer()
    log = []
    engines = [engine_cls(ns, i, log, buckets, batch_size, timer,
                          **engine_kw) for i in range(n)]
    workers = [ns.ReplicaWorker(i, e, max_wait_ms=max_wait_ms, clock=clock,
                                async_dispatch=async_dispatch)
               for i, e in enumerate(engines)]
    ctl = ns.AdmissionController(max_len=max(buckets),
                                 max_queue_depth=max_queue_depth)
    kw = {}
    if health is not None:
        kw['health'] = ns.HealthConfig(**health)
    router = ns.Router(workers, admission=ctl, clock=clock,
                       max_retries=max_retries,
                       default_timeout_s=timeout_s, **kw)
    return router, engines, clock, ctl, log


# the breaker of tests/test_serving.py::_health_router
HEALTH = dict(degrade_after=1, quarantine_after=2, recover_after=1,
              probe_backoff_s=5.0)


def _health_router(ns, n=2, batch_size=1, **kw):
    kw.setdefault('health', HEALTH)
    return _router(ns, n=n, batch_size=batch_size, **kw)


def _finish(trace, router, log, pending, ctl=None):
    trace.append(('state', _router_state(router)))
    trace.append(('log', list(log)))
    trace.append(('pending', [_pending(p) for p in pending]))
    if ctl is not None:
        trace.append(('admission', ctl.snapshot()))
    return trace


# ---------------------------------------------------------------------- #
# the scenarios (tests/test_serving.py's, by name)
# ---------------------------------------------------------------------- #
def sc_dispatch_on_fill(ns):
    clock = _Clock()
    engine = _FakeEngine(ns, buckets=(8,), batch_size=3)
    cb = ns.ContinuousBatcher(engine.run, engine.buckets, 3,
                              max_wait_ms=1e9, clock=clock)
    rng = np.random.RandomState(0)
    ps = [ns.PendingResult(i, n, 8, clock()) for i, n in enumerate((3, 5, 8))]
    trace = []
    for p in ps:
        cb.admit(8, *_request(rng, p.length), p)
        trace.append(('admit', _batcher_state(cb),
                      [_pending(q) for q in ps]))
    trace.append(('completed', [p.request_id for p in cb.pop_completed()]))
    trace.append(('log', engine.log))
    return trace


def sc_deadline_fallback(ns):
    clock = _Clock()
    engine = _FakeEngine(ns, buckets=(4, 8), batch_size=3)
    cb = ns.ContinuousBatcher(engine.run, engine.buckets, 3,
                              max_wait_ms=10.0, clock=clock)
    rng = np.random.RandomState(0)
    p = ns.PendingResult(0, 3, 4, clock())
    cb.admit(4, *_request(rng, 3), p)
    trace = [('flush', cb.flush_due(), _pending(p)),
             ('deadline', cb.next_deadline())]
    clock.t += 0.011
    trace += [('flush', cb.flush_due(), _pending(p)),
              ('deadline', cb.next_deadline()), ('state', _batcher_state(cb)),
              ('log', engine.log)]
    return trace


def sc_runner_failure(ns):
    def exploding(bucket, tokens, coords, mask):
        raise RuntimeError('device OOM')
    clock = _Clock()
    cb = ns.ContinuousBatcher(exploding, (8,), 2, max_wait_ms=1e9,
                              clock=clock)
    rng = np.random.RandomState(0)
    p1 = ns.PendingResult(0, 3, 8, clock())
    p2 = ns.PendingResult(1, 4, 8, clock())
    trace = []
    _attempt(trace, 'admit1', lambda: cb.admit(8, *_request(rng, 3), p1)
             and None)
    _attempt(trace, 'admit2', lambda: cb.admit(8, *_request(rng, 4), p2)
             and None)
    trace += [('pending', [_pending(p1), _pending(p2)]),
              ('state', _batcher_state(cb)),
              ('completed', [p.request_id for p in cb.pop_completed()])]
    return trace


def sc_least_outstanding(ns):
    router, engines, clock, ctl, log = _router(ns, n=2, batch_size=3)
    rng = np.random.RandomState(0)
    trace, pending = [], []
    pending.append(router.submit(*_request(rng, 3)))
    trace.append(('outstanding', [w.outstanding for w in router.workers]))
    pending.append(router.submit(*_request(rng, 3)))
    trace.append(('outstanding', [w.outstanding for w in router.workers]))
    router.workers[0].admit(8, *_request(rng, 6),
                            ns.PendingResult(99, 6, 8, clock()))
    pending.append(router.submit(*_request(rng, 5)))
    trace.append(('outstanding', [w.outstanding for w in router.workers]))
    trace.append(('drain', router.drain()))
    return _finish(trace, router, log, pending, ctl)


def sc_oversize_and_overload(ns):
    router, engines, clock, ctl, log = _router(ns, n=2, batch_size=4,
                                               max_queue_depth=2)
    rng = np.random.RandomState(0)
    trace, pending = [], []

    def submit(n):
        p = router.submit(*_request(rng, n))
        pending.append(p)
        return p.request_id
    for n in (9, 3, 3, 3):
        _attempt(trace, f'submit{n}', lambda: submit(n))
    trace.append(('drain', router.drain()))
    _attempt(trace, 'submit_after', lambda: submit(3))
    return _finish(trace, router, log, pending, ctl)


def sc_drain_then_swap(ns):
    router, engines, clock, ctl, log = _router(ns, n=2, batch_size=3)
    rng = np.random.RandomState(0)
    before = [router.submit(*_request(rng, n)) for n in (3, 3, 6)]
    trace = [('depth', router.queue_depth)]
    events = router.swap_weights('v1', tag='ckpt@7')
    trace.append(('events', events))
    trace.append(('params', [e.params for e in engines]))
    after = [router.submit(*_request(rng, 3)) for _ in range(6)]
    router.close()
    return _finish(trace, router, log, before + after, ctl)


def sc_drain_then_swap_async(ns):
    """The rolling swap on async replicas: the drain answers everything
    admitted before it on the old weights. Placement after the swap
    follows the executors' timing (the in-flight rows count as
    outstanding), so only what does not depend on it is traced."""
    router, engines, clock, ctl, log = _router(ns, n=2, batch_size=3,
                                               async_dispatch=True)
    rng = np.random.RandomState(0)
    before = [router.submit(*_request(rng, n)) for n in (3, 3, 6)]
    trace = [('depth', router.queue_depth)]
    trace.append(('events', router.swap_weights('v1', tag='ckpt@7')))
    trace.append(('pending before', [_pending(p) for p in before]))
    trace.append(('log before', list(log)))
    n_before = len(log)
    after = [router.submit(*_request(rng, 3)) for _ in range(6)]
    router.close()
    trace.append(('pending after', [_pending(p) for p in after]))
    trace.append(('versions after', sorted({c[2] for c in log[n_before:]})))
    trace.append(('rows after', sum(c[3] for c in log[n_before:])))
    trace.append(('params', [e.params for e in engines]))
    trace.append(('depth', router.queue_depth, ctl.snapshot()))
    return trace


def sc_single_replica(ns):
    router, engines, clock, ctl, log = _router(ns, n=1, batch_size=2)
    rng = np.random.RandomState(0)
    pending = [router.submit(*_request(rng, n)) for n in (3, 4, 2)]
    trace = [('mid', _router_state(router))]
    router.drain()
    return _finish(trace, router, log, pending, ctl)


def sc_health_transitions_and_backoff(ns):
    clock = _Clock()
    mon = ns.HealthMonitor([0], ns.HealthConfig(
        degrade_after=1, quarantine_after=3, recover_after=2,
        probe_backoff_s=1.0, probe_backoff_max_s=3.0), clock=clock)
    trace = []

    def note(label):
        trace.append((label, mon.state(0), mon.probe_due(0, clock()),
                      mon.snapshot()))
    mon.record_failure(0, RuntimeError('x'))
    note('fail')
    mon.record_success(0)
    mon.record_success(0)
    note('recovered')
    for _ in range(3):
        mon.record_failure(0)
    note('quarantined')
    clock.t += 1.5
    note('backoff elapsed')
    mon.begin_probe(0)
    note('half open')
    mon.record_failure(0)
    clock.t += 1.5
    note('failed probe, backoff doubled')
    clock.t += 1.0
    note('probe due again')
    mon.begin_probe(0)
    mon.record_success(0)
    note('probe success')
    mon.record_success(0)
    mon.record_success(0)
    note('healthy')
    trace.append(('transitions', mon.transitions, mon.recoveries))
    return trace


def sc_abandoned_probe_rearms(ns):
    clock = _Clock()
    mon = ns.HealthMonitor([0], ns.HealthConfig(
        degrade_after=1, quarantine_after=1, recover_after=1,
        probe_backoff_s=1.0, probe_timeout_s=10.0), clock=clock)
    trace = []
    mon.record_failure(0)
    for dt in (1.5, 0.0, 5.0, 6.0):
        clock.t += dt
        due = mon.probe_due(0, clock())
        trace.append((clock(), due, mon.snapshot()))
        if due:
            mon.begin_probe(0)
    mon.record_success(0)
    trace.append(('transitions', mon.transitions, mon.recoveries))
    return trace


def sc_try_begin_probe(ns):
    clock = _Clock()
    mon = ns.HealthMonitor([0], ns.HealthConfig(
        degrade_after=1, quarantine_after=1, recover_after=2,
        probe_backoff_s=1.0), clock=clock)
    mon.record_failure(0)
    clock.t += 1.5
    trace = [mon.try_begin_probe(0), mon.try_begin_probe(0)]
    mon.record_success(0)
    trace.append(('transitions', mon.transitions, mon.snapshot()))
    return trace


def sc_redispatch_to_sibling(ns):
    router, engines, clock, ctl, log = _health_router(ns, max_retries=1)
    engines[0].fail_next = 1
    rng = np.random.RandomState(0)
    p = router.submit(*_request(rng, 3))
    trace = [('after submit', _pending(p), router.queue_depth)]
    trace.append(('pump', router.pump()))
    return _finish(trace, router, log, [p], ctl)


def sc_retries_exhausted(ns):
    router, engines, clock, ctl, log = _health_router(ns, max_retries=1)
    engines[0].fail_next = 5
    engines[1].fail_next = 5
    rng = np.random.RandomState(0)
    p = router.submit(*_request(rng, 3))
    trace = [('pump', router.pump()), ('pump', router.pump()),
             ('completed', [q.request_id for q in router.pop_completed()])]
    return _finish(trace, router, log, [p], ctl)


def sc_quarantine_then_recovery(ns):
    router, engines, clock, ctl, log = _health_router(
        ns, max_retries=2, health=dict(degrade_after=1, quarantine_after=1,
                                       recover_after=1, probe_backoff_s=5.0))
    engines[0].fail_next = 1
    rng = np.random.RandomState(0)
    pending = [router.submit(*_request(rng, 3)) for _ in range(2)]
    router.pump()
    router.pump()
    trace = [('quarantined', _router_state(router))]
    pending += [router.submit(*_request(rng, 3)) for _ in range(3)]
    clock.t += 6.0
    pending.append(router.submit(*_request(rng, 3)))    # the probe
    trace.append(('probed', _router_state(router)))
    pending += [router.submit(*_request(rng, 3)) for _ in range(2)]
    return _finish(trace, router, log, pending, ctl)


def sc_all_quarantined(ns):
    router, engines, clock, ctl, log = _health_router(ns, n=1,
                                                      max_retries=0)
    engines[0].fail_next = 2
    rng = np.random.RandomState(0)
    pending = [router.submit(*_request(rng, 3)) for _ in range(2)]
    router.pump()
    pending.append(router.submit(*_request(rng, 3)))
    return _finish([], router, log, pending, ctl)


def sc_deadline_expiry(ns):
    router, engines, clock, ctl, log = _health_router(ns, n=1,
                                                      batch_size=2)
    rng = np.random.RandomState(0)
    p = router.submit(*_request(rng, 3), timeout_s=0.5)
    trace = [('waiting', _pending(p))]
    clock.t += 0.6
    trace.append(('pump', router.pump()))
    return _finish(trace, router, log, [p], ctl)


def sc_shed_before_dispatch(ns):
    router, engines, clock, ctl, log = _health_router(ns, n=1,
                                                      batch_size=2)
    rng = np.random.RandomState(0)
    p1 = router.submit(*_request(rng, 3), timeout_s=0.2)
    clock.t += 0.3
    p2 = router.submit(*_request(rng, 4))
    return _finish([], router, log, [p1, p2], ctl)


def sc_default_timeout(ns):
    router, engines, clock, ctl, log = _health_router(ns, n=1,
                                                      batch_size=2,
                                                      timeout_s=1.0)
    rng = np.random.RandomState(0)
    pending = [router.submit(*_request(rng, 3)),
               router.submit(*_request(rng, 4), timeout_s=9.0)]
    return _finish([], router, log, pending, ctl)


def sc_retry_after_hints(ns):
    router, engines, clock, ctl, log = _health_router(ns, n=2,
                                                      max_retries=1)
    engines[0].fail_next = 5
    engines[1].fail_next = 5
    rng = np.random.RandomState(0)
    p = router.submit(*_request(rng, 3))
    router.pump()
    router.pump()
    trace = _finish([], router, log, [p], ctl)
    router2, _, clock2, ctl2, log2 = _health_router(ns, n=1, timeout_s=5.0)
    ps = [router2.submit(*_request(rng, 5)),
          router2.submit(*_request(rng, 3), timeout_s=0.0)]
    clock2.t += 0.1
    router2.pump()
    _finish(trace, router2, log2, ps, ctl2)
    router3, _, _, ctl3, log3 = _health_router(ns, n=1, batch_size=4,
                                               max_queue_depth=2)
    ps = []
    for _ in range(3):
        _attempt(trace, 'submit', lambda: ps.append(
            router3.submit(*_request(rng, 3))))
    trace.append(('hint wired', ctl3.retry_hint == router3.retry_after_hint))
    return _finish(trace, router3, log3, ps, ctl3)


def sc_async_error_barrier(ns):
    from concurrent.futures import ThreadPoolExecutor

    def exploding(bucket, tokens, coords, mask):
        raise RuntimeError('device OOM')
    clock = _Clock()
    ex = ThreadPoolExecutor(max_workers=1)
    cb = ns.ContinuousBatcher(exploding, (8,), 2, max_wait_ms=1e9,
                              clock=clock, executor=ex)
    rng = np.random.RandomState(0)
    ps = [ns.PendingResult(0, 3, 8, clock()), ns.PendingResult(1, 4, 8,
                                                               clock())]
    trace = []
    for p in ps:
        _attempt(trace, 'admit', lambda: cb.admit(8, *_request(rng, p.length),
                                                  p) and None)
    _attempt(trace, 'wait', cb.wait)
    trace.append(('pending', [_pending(p) for p in ps]))
    _attempt(trace, 'wait again', cb.wait)
    ex.shutdown(wait=True)
    # the same payloads redispatched to a healthy batcher answer
    healthy = _FakeEngine(ns, buckets=(8,), batch_size=2)
    good = ns.ContinuousBatcher(healthy.run, (8,), 2, max_wait_ms=1e9,
                                clock=clock)
    rng = np.random.RandomState(0)
    retried = [ns.PendingResult(10 + i, n, 8, clock())
               for i, n in enumerate((3, 4))]
    for p in retried:
        good.admit(8, *_request(rng, p.length), p)
    trace.append(('retried', [_pending(p) for p in retried],
                  _batcher_state(cb), _batcher_state(good)))
    return trace


def sc_async_failure_redispatch(ns):
    """A failed async batch's requests are taken over by the router and
    answered by the sibling at the next pump."""
    router, engines, clock, ctl, log = _health_router(
        ns, max_retries=1, async_dispatch=True)
    engines[0].fail_next = 1
    rng = np.random.RandomState(0)
    p = router.submit(*_request(rng, 3))
    router.workers[0].drain()
    trace = [('pump', router.pump())]
    router.close()
    return _finish(trace, router, log, [p], ctl)


def sc_context_manager_closes(ns):
    router, engines, clock, ctl, log = _health_router(ns, n=2)
    events = []
    for w in router.workers:
        orig = w.close
        w.close = (lambda _orig=orig, _id=w.id:
                   (events.append(_id), _orig())[1])
    trace = []

    def crash():
        with router:
            router.submit(*_request(np.random.RandomState(0), 3))
            raise ValueError('serve loop crashed')
    _attempt(trace, 'crash', crash)
    trace.append(('closed', events))
    return _finish(trace, router, log, [], ctl)


def _record_fields(rec):
    """A record without its wall-clock parts: the bucket windows (real
    PhaseTimer times) keep their keys and counts; the watchdog snapshot
    (JAX counts XLA compiles, the port one-time host work) keeps its
    delta."""
    rec = dict(rec)
    rec['buckets'] = {k: v['count'] for k, v in rec['buckets'].items()}
    rec['runtime'] = rec['runtime']['compile_events_delta']
    return rec


def sc_telemetry_serve_record(ns):
    router, engines, clock, ctl, log = _router(ns, n=2, batch_size=2)
    tele = ns.RouterTelemetry(router, ctl)
    tele.arm()
    rng = np.random.RandomState(0)
    pending = [router.submit(*_request(rng, n)) for n in (3, 3, 6, 6, 2)]
    router.swap_weights('v1')
    router.drain()
    rec = tele.flush()
    ns.validate_record(dict(rec, kind='serve', run_id='t'))
    summary = tele.close()
    trace = [('serve', _record_fields(rec)),
             ('summary', {k: summary[k] for k in
                          ('steps', 'replicas', 'swaps',
                           'continuous_admissions', 'deadline_flushes',
                           'post_warmup_compiles', 'requests')}),
             ('latency', summary['metrics'])]
    return _finish(trace, router, log, pending, ctl)


def sc_fault_record(ns):
    router, engines, clock, ctl, log = _health_router(ns, n=2,
                                                      max_retries=1)
    tele = ns.RouterTelemetry(router, ctl)
    tele.arm()
    inj = ns.FaultInjector(seed=3)
    inj.plan('unit_site', 'exception', at=(1,))
    trace = []
    _attempt(trace, 'fire', lambda: inj.fire('unit_site'))
    engines[0].fail_next = 1
    rng = np.random.RandomState(0)
    pending = [router.submit(*_request(rng, 3), timeout_s=30.0)]
    router.pump()
    rec = tele.fault_flush(injector=inj, pending=pending, label='unit')
    ns.validate_record(dict(rec, kind='fault', run_id='t'))
    serve = tele.flush()
    ns.validate_record(dict(serve, kind='serve', run_id='t'))
    trace += [('fault', rec), ('serve', _record_fields(serve))]
    return _finish(trace, router, log, pending, ctl)


def sc_injected_replica_dispatch(ns):
    """The `replica_dispatch` site: replica 0's second and third
    dispatches raise, the breaker degrades, the retries land on replica
    1."""
    clock = _Clock()
    timer = ns.PhaseTimer()
    log = []
    inj = ns.FaultInjector(seed=0)
    inj.plan('replica_dispatch', 'exception', match=dict(replica=0),
             at=(2, 3))
    engines = [_FakeEngine(ns, i, log, (4, 8), 1, timer) for i in range(2)]
    workers = [ns.ReplicaWorker(i, e, max_wait_ms=10.0, clock=clock,
                                fault_injector=inj)
               for i, e in enumerate(engines)]
    router = ns.Router(workers, clock=clock, max_retries=2,
                       health=ns.HealthConfig(**HEALTH))
    rng = np.random.RandomState(0)
    pending = []
    for n in (3, 5, 2, 7, 4, 1):
        pending.append(router.submit(*_request(rng, n)))
        router.pump()
    router.drain()
    return _finish([('injected', inj.snapshot())], router, log, pending)


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith('sc_')}


@pytest.fixture(scope='module')
def namespaces():
    return _namespace('torch'), _namespace('jax')


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_fleet_scenario_matches_jax(name, namespaces):
    """The same scripted scenario through both packages: the dispatch log
    (replica, bucket, params version, rows), every request's resolution
    and structured error, every counter, the health snapshots and
    transitions, and the records are equal."""
    ours, ref = (SCENARIOS[name](ns) for ns in namespaces)
    assert ours == ref


class _BarrierEngine(_FakeEngine):
    """run() signals entry, then waits on a shared release event: two
    replicas inside run() at once shows the overlap by events, not by
    timing."""

    def __init__(self, ns, rid, log, buckets, batch_size, timer, release,
                 entered):
        super().__init__(ns, rid, log, buckets, batch_size, timer)
        self._release = release
        self._entered = entered

    def run(self, bucket, tokens, coords, mask):
        self._entered[self.rid].set()
        assert self._release.wait(10.0), 'overlap barrier never released'
        return super().run(bucket, tokens, coords, mask)


def test_async_dispatch_overlaps_replica_executions(namespaces):
    """With async_dispatch, submit returns while both replicas' engines are
    inside run() at once (the sync path would block in the first)."""
    ns = namespaces[0]
    release = threading.Event()
    entered = [threading.Event(), threading.Event()]
    router, engines, clock, ctl, log = _router(
        ns, n=2, buckets=(8,), batch_size=2, max_wait_ms=1e9,
        async_dispatch=True, engine_cls=_BarrierEngine, release=release,
        entered=entered)
    rng = np.random.RandomState(0)
    try:
        ps = [router.submit(*_request(rng, 3)) for _ in range(4)]
        assert entered[0].wait(10.0) and entered[1].wait(10.0)
        assert not any(p.done for p in ps)
        assert router.queue_depth == 4       # in flight still counts
    finally:
        release.set()
    router.close()
    assert all(p.done and p.ok for p in ps)
    assert router.queue_depth == 0
    assert all(w.stream is None for w in router.workers)   # no card
