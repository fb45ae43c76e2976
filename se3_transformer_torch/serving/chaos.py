"""The chaos harness: the single-host fault domain under seeded fire. The
port of the repository's scripts/chaos_smoke.py.

    python -m se3_transformer_torch.serving.chaos [--cpu] [--replicas 3]
        [--requests 80] [--buckets 8,16] [--batch-size 2]
        [--max-wait-ms 10] [--timeout-s 30] [--max-retries 2] [--seed 0]
        [--swap-at 40] [--ckpt-dir DIR] [--metrics CHAOS.jsonl]
        [--out SUMMARY.json] [--weaken none|drop]

N replicas of the serve entry point's toy model (each over its own copy
of the module) serve a mixed-length stream behind the `Router` while a
seeded `faults.FaultInjector` (same seed, same faults) injects:

  * replica crashes: replica 0's dispatches 2-4 raise, driving its breaker
    healthy -> degraded -> quarantined; the router takes it out of
    rotation, redispatches the failed batches onto siblings, and brings it
    back through half-open probe traffic;
  * latency spikes: every 9th engine run sleeps 30 ms (a slow replica:
    served, slower, no change of contract);
  * a torn checkpoint: the checkpoint directory's latest step is truncated
    after its write (`checkpoint_written` corrupt plan); the mid-run
    rolling swap reloads from that directory, so `restore_params` must
    fall back to the newest valid step;
  * instant deadlines: two requests arrive with timeout_s=0 and must be
    shed before dispatch with a structured RequestFailed('deadline').

The card is the default device; --cpu runs the plain PyTorch path. It
exits non-zero unless all of:

  * zero lost requests: every submit resolved answered or with a
    structured error (RequestRejected at the door, RequestFailed after);
  * at least one quarantine -> recovery transition was seen;
  * the rolling swap reached every replica from the fallback step (the
    torn latest was skipped: the swap tag names the step);
  * zero one-time host work after warmup;
  * every planned fault class fired, and the two instant deadlines timed
    out;
  * the telemetry stream (serve and fault records) is schema-valid.

`--weaken drop` is the check of those gates: it replaces the router's
structured-failure choke point (`Router._fail_request`) with a silent drop
and sets the retry budget to 0, so failed requests are lost; the run must
then exit 1.
"""
from __future__ import annotations

import argparse
import atexit
import json
import shutil
import sys
import tempfile
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description='seeded fault injection over the multi-replica '
                    'serving fault domain')
    ap.add_argument('--replicas', type=int, default=3)
    ap.add_argument('--requests', type=int, default=80)
    ap.add_argument('--oversize', type=int, default=1)
    ap.add_argument('--buckets', type=str, default='8,16')
    ap.add_argument('--batch-size', type=int, default=2)
    ap.add_argument('--max-wait-ms', type=float, default=10.0)
    ap.add_argument('--max-queue-depth', type=int, default=256)
    ap.add_argument('--timeout-s', type=float, default=30.0)
    ap.add_argument('--max-retries', type=int, default=2)
    ap.add_argument('--flush-every', type=int, default=8)
    ap.add_argument('--swap-at', type=int, default=None,
                    help='rolling swap_from_checkpoint after this many '
                         'requests (default: requests // 2)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--ckpt-dir', type=str, default=None,
                    help='checkpoint directory for the torn-latest swap '
                         '(default: a fresh temporary directory, removed '
                         'after)')
    ap.add_argument('--metrics', type=str, default=None)
    ap.add_argument('--out', type=str, default=None)
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (the plain PyTorch path)')
    ap.add_argument('--weaken', choices=('none', 'drop'), default='none',
                    help="'drop': silently drop the failures past the "
                         'retry budget instead of resolving them: the '
                         'zero-lost gate must fire (exit 1)')
    args = ap.parse_args(argv)
    # build_module_and_params reads these: the harness draws its weights
    args.checkpoint = None
    args.checkpoint_step = None
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import copy

    import numpy as np

    from ..faults import FaultInjector
    from ..inference import (
        AdmissionController, InferenceEngine, RequestRejected,
    )
    from ..inference.admission import RequestFailed
    from ..inference.serve import build_module_and_params, request_lengths
    from ..observability import MetricLogger, PhaseTimer
    from ..observability.schema import SchemaError, validate_stream
    from ..training.checkpoint import CheckpointManager
    from . import HealthConfig, ReplicaWorker, Router, RouterTelemetry

    buckets = tuple(int(b) for b in args.buckets.split(','))
    swap_at = (args.swap_at if args.swap_at is not None
               else args.requests // 2)
    cfg, module, _ = build_module_and_params(args, buckets)
    _, swap_module, _ = build_module_and_params(args, buckets,
                                                seed=args.seed + 1)

    # ---- the fault plan (seeded: same seed, same chaos) --------------- #
    inj = FaultInjector(seed=args.seed)
    inj.plan('replica_dispatch', 'exception', match=dict(replica=0),
             at=(2, 3, 4))               # 3 in a row -> quarantined
    inj.plan('engine_run', 'latency', every=9, latency_s=0.03)
    inj.plan('checkpoint_written', 'corrupt', at=(2,))  # tear the latest

    # ---- a checkpoint directory whose latest step is torn ------------- #
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix='chaos_ckpt_')
    if args.ckpt_dir is None:
        atexit.register(shutil.rmtree, ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(ckpt_dir, fault_injector=inj)
    mgr.save(1, dict(params=swap_module.state_dict()))   # valid fallback
    mgr.save(2, dict(params=module.state_dict()))        # torn by the plan
    print(f'checkpoints: step 1 valid, step 2 torn (latest) in {ckpt_dir}')

    # ---- N replicas, each its own module copy, one shared timer ------- #
    t0 = time.perf_counter()
    timer = PhaseTimer()
    engines = [InferenceEngine(copy.deepcopy(module), buckets=buckets,
                               batch_size=args.batch_size, return_type=1,
                               timer=timer, fault_injector=inj,
                               device='cpu' if args.cpu else 'cuda')
               for _ in range(args.replicas)]
    print(f'warmup: {args.replicas} replicas x '
          f'{len(engines[0].executables)} buckets in '
          f'{time.perf_counter() - t0:.1f}s on {engines[0].device}',
          flush=True)
    workers = [ReplicaWorker(i, e, max_wait_ms=args.max_wait_ms,
                             fault_injector=inj)
               for i, e in enumerate(engines)]
    admission = AdmissionController(max_len=buckets[-1],
                                    max_queue_depth=args.max_queue_depth)
    health = HealthConfig(quarantine_after=3, recover_after=2,
                          probe_backoff_s=0.05, probe_backoff_max_s=2.0)
    max_retries = 0 if args.weaken == 'drop' else args.max_retries

    ok = True
    with Router(workers, admission=admission, health=health,
                max_retries=max_retries,
                default_timeout_s=args.timeout_s) as router:
        if args.weaken == 'drop':
            # the weakened arm: the structured-failure choke point drops
            # the request, so failures past the budget vanish; the gates
            # below must catch it (exit 1)
            print('WEAKENED GATE ARM: failures past the retry budget are '
                  'silently dropped (this run must exit 1)')
            router._fail_request = lambda pending, error: None
        logger = MetricLogger(args.metrics, run_meta=dict(
            mode='chaos_smoke', backend=engines[0].device.type,
            replicas=args.replicas, buckets=list(buckets),
            batch_size=args.batch_size, seed=args.seed,
            weaken=args.weaken, dtype=engines[0].dtype_name))
        telemetry = RouterTelemetry(router, admission, logger)
        telemetry.arm()

        rng = np.random.RandomState(args.seed)
        lengths = request_lengths(args, buckets, router.max_len, rng)

        pending, flushed_at, swapped = [], 0, False
        swap_events = []

        def guarded_submit(length, **kw):
            """Every submit shares the rejection guard: a RequestRejected
            (oversize / overload) is a gated outcome, never a crash of the
            harness (a crash's exit code must not pass for the gate's)."""
            tokens = rng.randint(0, cfg.num_tokens, size=length)
            coords = rng.normal(size=(length, 3)).astype(np.float32)
            try:
                pending.append(router.submit(tokens, coords, **kw))
            except RequestRejected as e:
                print(f'rejected: {e.code} {e.detail}')
                logger.log_record('step', mirror=False,
                                  step=len(pending),
                                  rejected=e.to_record())
        for i, length in enumerate(lengths):
            if i == swap_at and not swapped:
                # the rolling reload from the torn-latest directory:
                # restore_params must fall back to step 1
                swap_events = router.swap_from_checkpoint(ckpt_dir)
                swapped = True
                print(f'rolling swap after request {i}: '
                      f'{len(swap_events)} replicas swapped, tag '
                      f'{swap_events[0]["tag"]!r}')
            guarded_submit(length)
            if i in (3, 4):
                # two requests already expired: shed before any dispatch
                # with a structured RequestFailed('deadline')
                guarded_submit(lengths[0], timeout_s=0.0)
            router.pump()
            time.sleep(0.002)   # pacing: the probe backoffs and the
            #                     latency spikes get real time to land
            if router.batches_dispatched - flushed_at >= args.flush_every:
                telemetry.flush()
                flushed_at = router.batches_dispatched
        # probe until the quarantined replica recovered (bounded: the
        # breaker must be seen closing)
        probe_rounds = 0
        while router.health.recoveries == 0 and probe_rounds < 200:
            probe_rounds += 1
            time.sleep(0.01)
            guarded_submit(lengths[0])
            router.pump()
        # deadline-drain the stragglers
        while router.queue_depth:
            wait = router.next_deadline()
            if wait:
                time.sleep(wait)
            router.pump()
    # leaving the block drained, settled the retries, closed the executors
    telemetry.flush()
    fault_rec = telemetry.fault_flush(injector=inj, pending=pending,
                                      label='chaos_smoke')
    summary = telemetry.close()
    logger.close()

    # ---- gates -------------------------------------------------------- #
    lost = [p.request_id for p in pending if not p.done]
    if lost:
        print(f'FAIL: {len(lost)} submitted requests lost (resolved '
              f'neither answered nor with a structured error): {lost[:10]}')
        ok = False
    unstructured = [p.request_id for p in pending
                    if p.done and p.error is not None
                    and not isinstance(p.error, RequestFailed)]
    if unstructured:
        print(f'FAIL: {len(unstructured)} requests resolved with a raw '
              f'error instead of a structured RequestFailed: '
              f'{unstructured[:10]}')
        ok = False
    if router.health.recoveries < 1:
        print('FAIL: no quarantine -> recovery transition seen: the '
              'circuit breaker never closed again')
        ok = False
    if len(swap_events) != args.replicas:
        print(f'FAIL: rolling swap incomplete: {len(swap_events)} swap '
              f'events for {args.replicas} replicas')
        ok = False
    elif not swap_events[0]['tag'].endswith('@1'):
        print(f'FAIL: the swap restored {swap_events[0]["tag"]!r}; '
              f'expected the fallback step 1 (the torn latest step 2 must '
              f'be skipped)')
        ok = False
    if telemetry.post_warmup_compiles:
        print(f'FAIL: {telemetry.post_warmup_compiles} one-time host work '
              f'events after warmup: injected faults must not break the '
              f'warmed-bucket contract')
        ok = False
    by_site = fault_rec['injections_by_site']
    for needed in ('replica_dispatch:exception', 'checkpoint_written:'
                   'corrupt', 'engine_run:latency'):
        if not by_site.get(needed):
            print(f'FAIL: planned fault class {needed!r} never fired')
            ok = False
    if router.timeouts < 2:
        print(f'FAIL: {router.timeouts} deadline timeouts: the two '
              f'timeout_s=0 submits must shed structurally')
        ok = False
    if args.metrics:
        try:
            info = validate_stream(args.metrics)
            print(f'schema ok: {info["records"]} records {info["kinds"]}')
        except SchemaError as e:
            print(f'FAIL: telemetry stream invalid: {e}')
            ok = False

    report = dict(
        ok=ok,
        weaken=args.weaken,
        device=str(engines[0].device),
        requests=dict(submitted=len(pending),
                      answered=sum(1 for p in pending if p.ok),
                      structured_failures=sum(
                          1 for p in pending
                          if p.done and p.error is not None),
                      lost=len(lost), **admission.snapshot()),
        injections=fault_rec['injections_by_site'],
        health=router.health.snapshot(),
        health_transitions=router.health.transitions,
        recoveries=router.health.recoveries,
        retries=router.retries,
        request_failures=router.request_failures,
        timeouts=router.timeouts,
        deadline_sheds=router.deadline_sheds,
        swap_tag=swap_events[0]['tag'] if swap_events else None,
        post_warmup_compiles=telemetry.post_warmup_compiles,
        batches=router.batches_dispatched,
        request_latency_ms=summary['metrics']['request_latency_ms'],
    )
    print(json.dumps(report, indent=2, default=str))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=2, default=str)
        print(f'report -> {args.out}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
