"""The fleet observability run: request tracing and SLO aggregation. The
counterpart of the repository's scripts/slo_smoke.py.

    python -m se3_transformer_torch.serving.slo_smoke [--cpu]
        [--requests 40] [--buckets 4,8] [--batch-size 2] [--seed 0]
        [--timeout-s 20] [--metrics SLO.jsonl] [--out SUMMARY.json]
        [--inject-regression]

Two in-process hosts (the toy model's engines, each behind a `Router`,
`RouterTelemetry` and `HostServer`, reached over `LocalTransport`) with
seeded transport faults (latency, and drops of `infer` calls that force
cross-host redispatches) serve a mixed-length stream through a traced
`FleetRouter`, and the run writes two schema'd records: `trace` (the span
trees and the completeness invariant) and `slo` (availability, merged
histogram percentiles, the error budget's burn). The zero-lost claim is
gated in-process; no `fleet` record is written (this run has no rollout
and no recovery). The card is the default device; --cpu runs the plain
PyTorch path.

It exits non-zero when any of these fails:

  * a request resolves neither answered nor structured-failed;
  * an orphan span, or completeness_total below 1.0;
  * redispatch_hops differs from the fleet's cross_host_retries (the
    trace record must reconcile with the counters);
  * no multi-host trace (the seeded drops force redispatches, which show
    spans of two hosts);
  * availability under the floor, or no answered request;
  * the stream fails the schema.

`--inject-regression` shows that the gates fire: after the (healthy) run
the tracer's fleet-side `attempt` spans are discarded (broken
instrumentation): every host span loses its parent, the record reports
orphans and completeness below 1.0, and the run must exit 1.
"""
import argparse
import json
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description='two traced in-process hosts: the trace and slo '
                    'records')
    ap.add_argument('--requests', type=int, default=40)
    ap.add_argument('--buckets', default='4,8')
    ap.add_argument('--batch-size', type=int, default=2)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--timeout-s', type=float, default=20.0)
    ap.add_argument('--metrics', default=None,
                    help='the JSONL stream (default: a temporary file)')
    ap.add_argument('--out', default=None,
                    help='also write the summary JSON here')
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (the plain PyTorch path)')
    ap.add_argument('--inject-regression', action='store_true',
                    help='discard the fleet-side attempt spans after the '
                         'run (broken instrumentation): the trace gates '
                         'must fire and the run exits 1')
    args = ap.parse_args(argv)
    # build_module_and_params reads these: the run draws its weights
    args.checkpoint = None
    args.checkpoint_step = None
    return args


def build_hosts(args, buckets):
    """Two in-process hosts: an engine each (over its own copy of the
    module), one Router, RouterTelemetry and HostServer each, both
    telemetries writing into one MetricLogger."""
    import copy

    from ..faults import FaultInjector
    from ..inference import AdmissionController, InferenceEngine
    from ..inference.serve import build_module_and_params
    from ..observability import MetricLogger, PhaseTimer
    from . import (
        HostServer, LocalTransport, ReplicaWorker, Router, RouterTelemetry,
    )

    _, module, _ = build_module_and_params(args, buckets)
    logger = MetricLogger(args.metrics, run_meta=dict(
        mode='slo_smoke', hosts=2, buckets=list(buckets),
        batch_size=args.batch_size, seed=args.seed))
    injector = FaultInjector(seed=args.seed)
    # seeded transport chaos: periodic latency and infer drops; each drop
    # is a TransportError at the fleet tier, feeds the host breaker and
    # forces a cross-host redispatch (the multi-host trace gated below)
    injector.plan('transport', 'latency', every=9, latency_s=0.02)
    injector.plan('transport', 'drop', at=(4, 11),
                  match=dict(method='infer'))

    hosts, transports, telemetries = {}, {}, {}
    t0 = time.perf_counter()
    # both engines warm before either telemetry arms: one-time work is
    # counted process-wide, so arming host 0 first would book host 1's
    # warmup against host 0
    engines = {hid: InferenceEngine(
        copy.deepcopy(module), buckets=buckets, batch_size=args.batch_size,
        return_type=1, timer=PhaseTimer(),
        device='cpu' if args.cpu else 'cuda') for hid in (0, 1)}
    for hid, engine in engines.items():
        worker = ReplicaWorker(0, engine, max_wait_ms=5.0)
        admission = AdmissionController(max_len=buckets[-1])
        router = Router([worker], admission=admission, max_retries=1,
                        default_timeout_s=args.timeout_s)
        telemetry = RouterTelemetry(router, admission, logger)
        telemetry.arm(emit_cost_records=False)
        server = HostServer(router, host_id=hid, telemetry=telemetry,
                            flush_every_batches=4)
        hosts[hid] = server
        telemetries[hid] = telemetry
        transports[hid] = LocalTransport(server, fault_injector=injector)
    print(f'warmup: 2 hosts x {len(buckets)} buckets in '
          f'{time.perf_counter() - t0:.1f}s on {engines[0].device}',
          flush=True)
    return hosts, transports, telemetries, logger, injector


def main(argv=None):
    args = parse_args(argv)
    import os
    import tempfile

    import numpy as np

    from ..inference.serve import TOY_NUM_TOKENS
    from ..observability import SLOAggregator, Tracer, trace_record_body
    from ..observability.schema import SchemaError, validate_stream
    from ..observability.slo import AVAILABILITY_FLOOR
    from . import FleetRouter

    tmp = None
    if args.metrics is None:
        tmp = tempfile.TemporaryDirectory(prefix='slo_smoke')
        args.metrics = os.path.join(tmp.name, 'slo.jsonl')
    buckets = tuple(int(b) for b in args.buckets.split(','))
    hosts, transports, telemetries, logger, injector = \
        build_hosts(args, buckets)

    tracer = Tracer(origin='fleet')
    slo = SLOAggregator(availability_target=0.999)
    rng = np.random.RandomState(args.seed)
    pending = []
    with FleetRouter(transports, max_retries=2,
                     default_timeout_s=args.timeout_s,
                     heartbeat_every_s=0.05,
                     tracer=tracer, slo=slo) as fleet:
        for i in range(args.requests):
            n = int(rng.randint(1, buckets[-1] + 1))
            pending.append(fleet.submit(
                rng.randint(0, TOY_NUM_TOKENS, size=n),
                rng.normal(size=(n, 3)).astype(np.float32)))
            fleet.pump()
            time.sleep(0.004)
        # settle: every submit resolves (answered or structured) and
        # the heartbeat loop keeps scraping the hosts' histograms
        deadline = time.monotonic() + args.timeout_s + 30.0
        while (any(not p.done for p in pending)
               and time.monotonic() < deadline):
            fleet.drain()
            fleet.pump()
            time.sleep(0.01)
        fleet.drain()
        scraped = fleet.scrape()    # final cumulative counters
        fleet_body = fleet.record_body(pending, label='slo_smoke')
        answered = fleet.answered
        failures = fleet.request_failures
        xretries = fleet.cross_host_retries

    for s in hosts.values():
        s.stop(drain=True)
    for t in telemetries.values():
        t.flush()

    if args.inject_regression:
        # broken instrumentation: dropping the fleet-side `attempt` spans
        # orphans every host span (their parent ids leave the trace), so
        # the orphan and completeness gates below must fire
        with tracer._lock:
            tracer._spans = [s for s in tracer._spans
                             if s.get('name') != 'attempt']
        print('INJECTED REGRESSION: fleet-side attempt spans discarded: '
              'the host spans are orphans now', flush=True)

    resolved = answered + failures
    trace_body = trace_record_body(tracer, label='slo_smoke',
                                   expected=resolved)
    slo_body = slo.record_body(fleet, label='slo_smoke')
    # no `fleet` record: this run has no rollout and no recovery; its
    # fleet-level claim (zero lost) is gated in-process off fleet_body
    logger.log_record('trace', mirror=False, **trace_body)
    logger.log_record('slo', mirror=False, **slo_body)
    logger.close()

    ok = True

    def gate(cond, msg):
        nonlocal ok
        if not cond:
            print(f'FAIL: {msg}')
            ok = False

    gate(answered > 0, 'zero answered requests')
    gate(fleet_body['lost_requests'] == 0,
         f'{fleet_body["lost_requests"]} lost request(s): resolved '
         f'neither answered nor structured')
    gate(trace_body['orphan_spans'] == 0,
         f'{trace_body["orphan_spans"]} orphan span(s)')
    gate(trace_body['completeness_total'] >= 1.0,
         f'trace completeness {trace_body["completeness_total"]} < 1.0 '
         f'({trace_body["complete_trees"]}/{trace_body["traces"]} '
         f'complete over {resolved} resolved)')
    gate(trace_body['redispatch_hops'] == xretries,
         f'redispatch_hops {trace_body["redispatch_hops"]} != '
         f'cross_host_retries {xretries}: the trace record does not '
         f'reconcile with the fleet counters')
    gate(trace_body['multi_host_traces'] >= 1,
         'no multi-host trace: the seeded drops must force at least '
         'one cross-host redispatch with spans from both hosts')
    gate(isinstance(slo_body['availability'], (int, float))
         and slo_body['availability'] >= AVAILABILITY_FLOOR,
         f'fleet availability {slo_body["availability"]} under the '
         f'{AVAILABILITY_FLOOR} floor')
    gate(slo_body['hosts'] == 2 and scraped == 2,
         f'SLO aggregator saw {slo_body["hosts"]} host(s), final '
         f'scrape hit {scraped}: both hosts must report')
    gate(any(v.get('count') for v in slo_body['buckets'].values()),
         'merged histograms are empty: no host shipped latency '
         'counts')

    try:
        validate_stream(args.metrics)
        print(f'schema: {args.metrics} validated clean')
    except SchemaError as e:
        gate(False, f'schema violation: {e}')

    summary = dict(
        answered=answered, request_failures=failures,
        cross_host_retries=xretries,
        injections=injector.snapshot()['injections_total'],
        trace={k: trace_body[k] for k in (
            'traces', 'complete_trees', 'orphan_spans',
            'multi_host_traces', 'redispatch_hops',
            'completeness_total')},
        availability=slo_body['availability'],
        buckets=slo_body['buckets'],
        ok=ok,
    )
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(summary, f, indent=2)
    if tmp is not None:
        tmp.cleanup()
    if ok:
        print(f'SLO SMOKE PASS: {answered} answered, {xretries} '
              f'cross-host redispatches all traced, availability '
              f'{slo_body["availability"]}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
