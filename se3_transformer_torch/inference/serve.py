"""Serve a mixed-length request stream through the port's serving stack:
the counterpart of the repository's scripts/serve.py.

    python -m se3_transformer_torch.inference.serve [--requests N]
        [--oversize K] [--buckets 12,24] [--batch-size 2]
        [--max-wait-ms 5] [--max-queue-depth 64] [--flush-every 2]
        [--bf16] [--precision MIX[,MIX...]]
        [--checkpoint DIR [--checkpoint-step S]]
        [--metrics SERVE.jsonl] [--out SUMMARY.json] [--seed S]
        [--pace-ms MS] [--cpu]
        [--replicas N [--swap-at K] [--async-dispatch] [--timeout-s T]
         [--max-retries R]]

Startup: the toy model (DenoiseConfig: 24 tokens, dim 8, 2 heads of 8,
depth 2, 2 degrees, 4 sparse neighbors) with seeded weights, or its
params restored from a checkpoint (params only), then one warmup forward
per bucket and the watchdog armed. Serve loop: admit -> enqueue ->
micro-batch (flush on full or deadline) -> answer. Close: a summary
report. The card is the default device; --cpu runs the plain PyTorch
path.

It exits non-zero when
  * the telemetry stream fails schema validation,
  * any one-time host work ran after warmup (post_warmup_compiles > 0: a
    mixed-length stream over warmed buckets must set off none), or
  * an admitted request was not answered.

`--replicas N` (N > 1) serves through the multi-replica router
(se3_transformer_torch.serving): N replica workers, each with its own
engine over its own copy of the module (a deep copy of the host module,
made before quantization and placement: replicas never share weights),
warmed one after another with one shared PhaseTimer; least-outstanding
placement into in-flight bucket slots (the deadline only a fallback);
`--async-dispatch` gives each replica its own dispatch thread and, on a
card, its own CUDA stream; `--timeout-s` stamps each request's deadline
and `--max-retries` bounds the redispatches of a failed batch's requests
onto siblings; `--swap-at K` makes one rolling weight swap to a second
seeded state after the K-th request. A comma `--precision` list cycles
over the replicas (e.g. fp32,int8_mix). On top of the single-replica
gates it exits non-zero when no request ever joined an in-flight slot
(continuous_admissions 0) or the rolling swap did not reach every
replica.

SIGTERM or SIGINT mid-stream stops admitting, drains what was accepted,
flushes the telemetry and exits 0 (training.guardian.PreemptionGuard).

The flags of the cross-host fleet (--fleet above 1, --host, --port,
--host-id, --transport, --poison-step) are refused with the ROADMAP item
that ports them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

FLEET = 'ROADMAP A8.2 (the cross-host fleet)'
# scripts/serve.py's flags whose machinery is not ported
UNPORTED_FLAGS = {flag: FLEET for flag in (
    '--host', '--port', '--host-id', '--transport', '--poison-step')}

# the toy serving model's vocab size: one constant for the module and the
# request stream
TOY_NUM_TOKENS = 24


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description='bucketed serving over a mixed-length stream')
    ap.add_argument('--requests', type=int, default=8,
                    help='in-range requests, lengths cycling across '
                         'buckets (mixed-length by construction)')
    ap.add_argument('--oversize', type=int, default=1,
                    help='extra requests longer than the largest bucket '
                         '(must be rejected)')
    ap.add_argument('--buckets', type=str, default='12,24')
    ap.add_argument('--batch-size', type=int, default=2)
    ap.add_argument('--max-wait-ms', type=float, default=5.0)
    ap.add_argument('--max-queue-depth', type=int, default=64)
    ap.add_argument('--flush-every', type=int, default=2,
                    help='emit a serve record every N dispatched batches')
    ap.add_argument('--bf16', action='store_true',
                    help='bf16 activation path (coords rounded in, f32 out)')
    ap.add_argument('--precision', type=str, default=None,
                    help='weight-precision mix (quant.rules: fp32 / bf16 / '
                         'int8_mix / fp8_mix), quantized on the host before '
                         'the weights reach the device; with --replicas N '
                         'a comma list cycles over the replicas (e.g. '
                         '"fp32,int8_mix")')
    ap.add_argument('--checkpoint', type=str, default=None,
                    help='CheckpointManager directory; params-only restore')
    ap.add_argument('--checkpoint-step', type=int, default=None,
                    help='with --checkpoint: restore this step instead of '
                         'the latest')
    ap.add_argument('--metrics', type=str, default=None,
                    help='JSONL telemetry stream (serve records)')
    ap.add_argument('--out', type=str, default=None,
                    help='write the summary report JSON here')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--pace-ms', type=float, default=0.0,
                    help='sleep this long between submitted requests')
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (the plain PyTorch path)')
    ap.add_argument('--replicas', type=int, default=1,
                    help='above 1: serve through the multi-replica router '
                         '(se3_transformer_torch.serving), one module copy '
                         'per replica')
    ap.add_argument('--swap-at', type=int, default=None,
                    help='multi-replica only: after this many submitted '
                         'requests, a rolling swap to a second seeded '
                         'state (nothing rebuilt, nothing dropped)')
    ap.add_argument('--async-dispatch', action='store_true',
                    help='multi-replica only: a dispatch thread (and on a '
                         'card a CUDA stream) per replica, so that the '
                         "replicas' forwards overlap")
    ap.add_argument('--timeout-s', type=float, default=None,
                    help='multi-replica only: per-request deadline; '
                         'expired requests shed before dispatch with a '
                         'structured RequestFailed("deadline")')
    ap.add_argument('--max-retries', type=int, default=1,
                    help="multi-replica only: redispatches of a failed "
                         "batch's requests onto sibling replicas before a "
                         'structured RequestFailed("retries_exhausted")')
    ap.add_argument('--fleet', type=int, default=1,
                    help=f'1 only; the cross-host fleet is not ported '
                         f'({FLEET})')
    for flag, item in UNPORTED_FLAGS.items():
        ap.add_argument(flag, nargs='?', const=True, default=None,
                        help=f'not ported ({item})')
    args = ap.parse_args(argv)
    if args.fleet > 1:
        ap.error(f'--fleet {args.fleet}: the cross-host fleet is not '
                 f'ported ({FLEET})')
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag[2:].replace('-', '_')) is not None:
            ap.error(f'{flag}: its machinery is not ported ({item})')
    if args.replicas < 1:
        ap.error(f'--replicas {args.replicas}: at least one replica')
    if args.precision and ',' in args.precision and args.replicas <= 1:
        ap.error('--precision got a comma list but --replicas is 1: '
                 'heterogeneous mixes need a fleet')
    return args


def precision_mixes(args):
    """The per-replica precision list: None -> fp32 everywhere; one mix
    applies to every replica; a comma list cycles over them."""
    if not args.precision:
        return [None] * max(args.replicas, 1)
    mixes = [m.strip() or None for m in args.precision.split(',')]
    return [mixes[i % len(mixes)] for i in range(max(args.replicas, 1))]


def build_module_and_params(args, buckets, seed=None):
    """The toy module on the host with seeded weights, and the restored
    params (CheckpointManager.restore_params, params only) with
    --checkpoint, else None."""
    import torch

    from ..training.denoise import DenoiseConfig

    seed = args.seed if seed is None else seed
    cfg = DenoiseConfig(num_tokens=TOY_NUM_TOKENS, dim=8, dim_head=8,
                        heads=2, depth=2, num_degrees=2,
                        max_sparse_neighbors=4)
    module = cfg.build_module(device='cpu',
                              generator=torch.Generator().manual_seed(seed))
    params = None
    if args.checkpoint:
        from ..training.checkpoint import CheckpointManager
        step = args.checkpoint_step
        params = CheckpointManager(
            args.checkpoint, model_family=module.model_family,
        ).restore_params(step)
        print(f'restored params-only from {args.checkpoint}'
              f'{f" @ step {step}" if step is not None else ""}')
    else:
        print(f'no --checkpoint: initialized fresh params (seed {seed})')
    return cfg, module, params


def request_lengths(args, buckets, max_len, rng):
    """Mixed-length stream: in-range lengths cycling across buckets, plus
    the oversize (must-reject) tail, shuffled."""
    lows = [1] + [b + 1 for b in buckets[:-1]]
    lengths = [int(rng.randint(lows[i % len(buckets)],
                               buckets[i % len(buckets)] + 1))
               for i in range(args.requests)]
    lengths += [max_len + int(rng.randint(1, 32))
                for _ in range(args.oversize)]
    rng.shuffle(lengths)
    return lengths


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.replicas > 1:
        return serve_multi(args)
    import numpy as np
    import torch

    from ..observability import MetricLogger
    from ..observability.schema import SchemaError, validate_stream
    from ..training.guardian import PreemptionGuard
    from . import (
        AdmissionController, InferenceEngine, MicroBatcher, RequestRejected,
        ServeTelemetry,
    )

    buckets = tuple(int(b) for b in args.buckets.split(','))
    cfg, module, params = build_module_and_params(args, buckets)

    # ---- startup: warm every bucket, then arm the watchdog ------------ #
    t0 = time.perf_counter()
    engine = InferenceEngine(
        module, buckets=buckets, batch_size=args.batch_size, return_type=1,
        precision=args.precision, device='cpu' if args.cpu else 'cuda',
        activation_dtype=torch.bfloat16 if args.bf16 else None,
        precompile=params is None)
    if params is not None:
        engine.params = params
        engine.warmup()
    print(f'warmup: warmed {len(engine.executables)} buckets in '
          f'{time.perf_counter() - t0:.1f}s ({engine.compile_seconds}, '
          f'precision {engine.precision_name}, device {engine.device})',
          flush=True)

    admission = AdmissionController(max_len=engine.max_len,
                                    max_queue_depth=args.max_queue_depth)
    batcher = MicroBatcher(engine.run, buckets=engine.buckets,
                           batch_size=args.batch_size,
                           max_wait_ms=args.max_wait_ms,
                           admission=admission)
    logger = MetricLogger(args.metrics, run_meta=dict(
        mode='serve', backend=engine.device.type, buckets=list(buckets),
        batch_size=args.batch_size, dtype=engine.dtype_name,
        precision=engine.precision_name))
    telemetry = ServeTelemetry(engine, batcher, admission, logger)
    telemetry.arm()

    # ---- the request stream: lengths cycle across buckets ------------ #
    rng = np.random.RandomState(args.seed)
    lengths = request_lengths(args, engine.buckets, engine.max_len, rng)

    pending, flushed_at, interrupted = [], 0, None
    with PreemptionGuard() as guard:
        print(f'serving {len(lengths)} requests (SIGTERM or SIGINT: drain, '
              f'flush, exit 0)', flush=True)
        for length in lengths:
            if guard.stop_requested:
                # graceful preemption: stop admitting, drain what was
                # accepted, flush the telemetry
                interrupted = guard.signame
                print(f'{interrupted}: graceful shutdown: draining '
                      f'{batcher.queue_depth} queued requests, flushing '
                      f'telemetry', flush=True)
                break
            tokens = rng.randint(0, cfg.num_tokens, size=length)
            coords = rng.normal(size=(length, 3)).astype(np.float32)
            try:
                pending.append(batcher.submit(tokens, coords))
            except RequestRejected as e:
                print(f'rejected: {e.code} {e.detail}')
                logger.log_record('step', mirror=False, step=len(pending),
                                  rejected=e.to_record())
            batcher.pump()
            if args.pace_ms:
                time.sleep(args.pace_ms / 1e3)
            if batcher.batches_dispatched - flushed_at >= args.flush_every:
                telemetry.flush()
                flushed_at = batcher.batches_dispatched
        # deadline-drain the stragglers (still under the guard: a second
        # signal sets the flag again instead of killing the drain)
        while batcher.queue_depth:
            wait = batcher.next_deadline()
            if wait:
                time.sleep(wait)
            batcher.pump()
    telemetry.flush()
    summary = telemetry.close()
    logger.close()

    # ---- gates + report ---------------------------------------------- #
    ok = True
    unanswered = [p.request_id for p in pending if not p.ok]
    if unanswered:
        print(f'FAIL: {len(unanswered)} admitted requests unanswered')
        ok = False
    if telemetry.post_warmup_compiles:
        print(f'FAIL: {telemetry.post_warmup_compiles} one-time host work '
              f'events after warmup: the warmed-bucket contract is broken')
        ok = False
    if args.metrics:
        try:
            info = validate_stream(args.metrics)
            print(f'schema ok: {info["records"]} records {info["kinds"]}')
        except SchemaError as e:
            print(f'FAIL: telemetry stream invalid: {e}')
            ok = False

    stats = engine.stats()
    report = dict(
        ok=ok,
        interrupted=interrupted,
        requests=dict(total=len(lengths), answered=len(pending) -
                      len(unanswered), **admission.snapshot()),
        batches=batcher.batches_dispatched,
        post_warmup_compiles=telemetry.post_warmup_compiles,
        compile_seconds=stats['compile_seconds'],
        # measured per bucket on a card (the cost records are in the
        # --metrics stream); empty on the CPU
        peak_hbm_by_bucket=stats['peak_hbm_by_bucket'],
        latency_by_bucket={
            k: {p: v[p] for p in
                ('count', 'p50_ms', 'p95_ms', 'p99_ms', 'max_ms')}
            for k, v in summary['timing'].items()
            if k.startswith('bucket_')},
        request_latency_ms=summary['metrics']['request_latency_ms'],
        batch_fill=summary['metrics'].get('batch_fill'),
    )
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=2)
        print(f'report -> {args.out}')
    return 0 if ok else 1



def build_replica_engines(args, module, params, buckets, timer):
    """One InferenceEngine per replica, each over its own deep copy of the
    host `module` (made before quantization and placement, so that no two
    replicas share a weight), at the replica's precision mix, all on the
    shared `timer`; warmed one after another (with `params` loaded first
    when given)."""
    import copy

    import torch

    from . import InferenceEngine

    engines = []
    for mix in precision_mixes(args):
        engine = InferenceEngine(
            copy.deepcopy(module), buckets=buckets,
            batch_size=args.batch_size, return_type=1, timer=timer,
            precision=mix, device='cpu' if args.cpu else 'cuda',
            activation_dtype=torch.bfloat16 if args.bf16 else None,
            precompile=params is None)
        if params is not None:
            engine.params = params
            engine.warmup()
        engines.append(engine)
    return engines


def serve_multi(args) -> int:
    """The multi-replica path (`--replicas N`): scripts/serve.py's
    serve_multi."""
    import numpy as np

    from ..observability import MetricLogger, PhaseTimer
    from ..observability.schema import SchemaError, validate_stream
    from ..serving import ReplicaWorker, Router, RouterTelemetry
    from ..training.guardian import PreemptionGuard
    from . import AdmissionController, RequestRejected

    buckets = tuple(int(b) for b in args.buckets.split(','))
    cfg, module, params = build_module_and_params(args, buckets)

    # ---- startup: N replicas, one shared PhaseTimer, warmed in turn ---- #
    t0 = time.perf_counter()
    timer = PhaseTimer()
    engines = build_replica_engines(args, module, params, buckets, timer)
    print(f'warmup: {args.replicas} replicas x {len(engines[0].executables)}'
          f' buckets in {time.perf_counter() - t0:.1f}s (precision mixes '
          f'{[e.precision_name for e in engines]}, device '
          f'{engines[0].device})', flush=True)

    workers = [ReplicaWorker(i, e, max_wait_ms=args.max_wait_ms,
                             async_dispatch=args.async_dispatch)
               for i, e in enumerate(engines)]
    admission = AdmissionController(max_len=buckets[-1],
                                    max_queue_depth=args.max_queue_depth)
    # the router is a context manager: its dispatch executors shut down
    # when the block exits, error paths included
    with Router(workers, admission=admission,
                max_retries=args.max_retries,
                default_timeout_s=args.timeout_s) as router:
        swap_params = None
        if args.swap_at is not None:
            _, swap_module, swap_params = build_module_and_params(
                args, buckets, seed=args.seed + 1)
            if swap_params is None:
                swap_params = swap_module.state_dict()
        logger = MetricLogger(args.metrics, run_meta=dict(
            mode='serve_multi', backend=engines[0].device.type,
            replicas=args.replicas, buckets=list(buckets),
            batch_size=args.batch_size, dtype=engines[0].dtype_name,
            async_dispatch=args.async_dispatch,
            precision_mixes=[e.precision_name for e in engines]))
        telemetry = RouterTelemetry(router, admission, logger)
        telemetry.arm()

        # ---- the request stream, with one mid-run rolling swap ------- #
        rng = np.random.RandomState(args.seed)
        lengths = request_lengths(args, buckets, router.max_len, rng)

        pending, flushed_at, swapped, interrupted = [], 0, False, None
        with PreemptionGuard() as guard:
            print(f'serving {len(lengths)} requests on {args.replicas} '
                  f'replicas (SIGTERM or SIGINT: drain, flush, exit 0)',
                  flush=True)
            for i, length in enumerate(lengths):
                if guard.stop_requested:
                    interrupted = guard.signame
                    print(f'{interrupted}: graceful shutdown: draining '
                          f'{router.queue_depth} queued requests, '
                          f'flushing telemetry', flush=True)
                    break
                if args.swap_at is not None and i == args.swap_at \
                        and not swapped:
                    # same shapes, new values: the swap must set off no
                    # one-time work and drop nothing (the gates check both)
                    events = router.swap_weights(
                        swap_params, tag=f'seed_{args.seed + 1}')
                    swapped = True
                    print(f'rolling weight swap after request {i}: '
                          f'{len(events)} replicas swapped, '
                          f'{sum(e["drained_batches"] for e in events)} '
                          f'partial batches drained')
                tokens = rng.randint(0, cfg.num_tokens, size=length)
                coords = rng.normal(size=(length, 3)).astype(np.float32)
                try:
                    pending.append(router.submit(tokens, coords))
                except RequestRejected as e:
                    print(f'rejected: {e.code} {e.detail}')
                    logger.log_record('step', mirror=False,
                                      step=len(pending),
                                      rejected=e.to_record())
                router.pump()
                if args.pace_ms:
                    time.sleep(args.pace_ms / 1e3)
                if router.batches_dispatched - flushed_at >= \
                        args.flush_every:
                    telemetry.flush()
                    flushed_at = router.batches_dispatched
            # deadline-drain the stragglers
            while router.queue_depth:
                wait = router.next_deadline()
                if wait:
                    time.sleep(wait)
                elif args.async_dispatch:
                    # the depth counts rows in flight on the executors,
                    # which no deadline governs: yield, do not spin
                    time.sleep(0.001)
                router.pump()
    # leaving the block drained the replicas and shut the executors down
    telemetry.flush()
    summary = telemetry.close()
    logger.close()

    # ---- gates + report ---------------------------------------------- #
    ok = True
    unanswered = [p.request_id for p in pending if not p.ok]
    if unanswered:
        print(f'FAIL: {len(unanswered)} admitted requests unanswered (the '
              f'rolling swap must drop nothing)')
        ok = False
    if telemetry.post_warmup_compiles:
        print(f'FAIL: {telemetry.post_warmup_compiles} one-time host work '
              f'events after warmup: a weight swap or the stream broke the '
              f'warmed-bucket contract')
        ok = False
    if not router.continuous_admissions and not interrupted:
        # an interrupted run may have stopped before any slot held two
        # requests: a graceful shutdown exits 0
        print('FAIL: zero continuous admissions: no request ever joined '
              'an in-flight bucket slot')
        ok = False
    if args.swap_at is not None and not interrupted and \
            len(router.swap_events) != args.replicas:
        print(f'FAIL: rolling swap incomplete: {len(router.swap_events)} '
              f'swap events for {args.replicas} replicas')
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
        interrupted=interrupted,
        replicas=args.replicas,
        async_dispatch=args.async_dispatch,
        precision_mixes=[e.precision_name for e in engines],
        requests=dict(total=len(lengths), answered=len(pending) -
                      len(unanswered), **admission.snapshot()),
        batches=router.batches_dispatched,
        continuous_admissions=router.continuous_admissions,
        deadline_flushes=router.deadline_flushes,
        swaps=dict(count=len(router.swap_events),
                   events=router.swap_events),
        post_warmup_compiles=telemetry.post_warmup_compiles,
        compile_seconds={str(w.id): w.engine.stats()['compile_seconds']
                         for w in router.workers},
        peak_hbm_by_bucket={str(w.id):
                            w.engine.stats()['peak_hbm_by_bucket']
                            for w in router.workers},
        per_replica={str(w.id): w.snapshot() for w in router.workers},
        latency_by_bucket={
            k: {p: v[p] for p in
                ('count', 'p50_ms', 'p95_ms', 'p99_ms', 'max_ms')}
            for k, v in summary['timing'].items()
            if k.startswith('bucket_')},
        request_latency_ms=summary['metrics']['request_latency_ms'],
    )
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=2)
        print(f'report -> {args.out}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
