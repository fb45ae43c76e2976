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
        [--fleet N | --host --port P --host-id K [--poison-step S]]
        [--transport binary|legacy] [--model toy|flagship_fast
         [--depth L]]

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

`--host` runs this process as one fleet host: the replicas-and-router
stack above behind `serving.fleet.HostServer` on a TCP port (`--transport
binary`, the default: pooled, multiplexed, raw numpy frames; `legacy`:
newline JSON, a connection a call). It prints `FLEET HOST READY host=K
port=P transport=T device=D` once every bucket is warm and the socket
listens (D is `cuda:N` unless --cpu was given: a host finds the card or
fails, it never serves on the CPU instead), then serves until SIGTERM:
it closes the socket, drains the router, writes its serve, fault and
summary records and exits 0. `--poison-step S` is the chaos hook: once a
swap RPC has restored step S, every dispatch on the host fails until a
swap restores another step (the poisoned canary of the fleet chaos run).

`--fleet N` (N above 1) is the cross-host front end: it starts N `--host`
processes (fresh interpreters, never forks: each host gets a CUDA context
of its own), routes the stream through a `serving.fleet.FleetRouter`
(host breakers, cross-host redispatch, deadline propagation), writes the
`fleet` record, and SIGTERMs the hosts on the way out (each must exit 0).
It exits non-zero when a request is lost, an in-range request is not
answered, the stream fails the schema, or a host exits non-zero.

`--model flagship_fast` serves the flagship_fast recipe at its own width
(features [n, 64]) and `--depth` blocks instead of the toy model on
tokens; with `--checkpoint` every host restores the same weights.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# the toy serving model's vocab size: one constant for the module and the
# request stream
TOY_NUM_TOKENS = 24
MODELS = ('toy', 'flagship_fast')
# the checkout holding the package: hosts run `python -m` from here
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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
    ap.add_argument('--model', choices=MODELS, default='toy',
                    help="'toy' (tokens) or the 'flagship_fast' recipe "
                         '(features [n, 64])')
    ap.add_argument('--depth', type=int, default=6,
                    help='flagship_fast only: the number of blocks')
    # ---- the cross-host fleet (serving.fleet) ------------------------ #
    ap.add_argument('--fleet', type=int, default=1,
                    help='above 1: start N --host processes and route '
                         'through the cross-host FleetRouter')
    ap.add_argument('--host', action='store_true', dest='host_mode',
                    help='run as one fleet host: the replicas and router '
                         'behind serving.fleet.HostServer on a TCP port, '
                         'until SIGTERM')
    ap.add_argument('--host-id', type=int, default=0,
                    help="--host only: this host's id in the fleet")
    ap.add_argument('--port', type=int, default=0,
                    help='--host only: the TCP port (0: the system picks; '
                         'the READY line names it)')
    ap.add_argument('--transport', choices=('binary', 'legacy'),
                    default='binary',
                    help='the fleet wire: "binary" (pooled connections, '
                         'correlation-id multiplexing, raw numpy frames) '
                         'or "legacy" (newline JSON, a connection a call)')
    ap.add_argument('--poison-step', type=int, default=None,
                    help='--host only (the chaos hook): once a swap RPC '
                         'restores this step, every dispatch fails until '
                         'another step is restored')
    args = ap.parse_args(argv)
    if args.fleet < 1:
        ap.error(f'--fleet {args.fleet}: at least one host')
    if args.host_mode and args.fleet > 1:
        ap.error('--host and --fleet exclude each other: a host is one '
                 'process of a fleet')
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
    """The module on the host with seeded weights (the toy model, or
    flagship_fast with --model flagship_fast), and the restored params
    (CheckpointManager.restore_params, params only) with --checkpoint,
    else None."""
    import torch

    from ..training.denoise import DenoiseConfig

    seed = args.seed if seed is None else seed
    cfg = DenoiseConfig(num_tokens=TOY_NUM_TOKENS, dim=8, dim_head=8,
                        heads=2, depth=2, num_degrees=2,
                        max_sparse_neighbors=4)
    generator = torch.Generator().manual_seed(seed)
    if getattr(args, 'model', 'toy') == 'flagship_fast':
        from ..training.recipes import flagship_fast
        module = flagship_fast(depth=args.depth, device='cpu',
                               generator=generator)
    else:
        module = cfg.build_module(device='cpu', generator=generator)
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


def make_request(args, rng, length):
    """One request's (tokens or features, coords): toy tokens, or
    flagship_fast's features [length, FLAGSHIP_FAST_DIM]."""
    import numpy as np
    if getattr(args, 'model', 'toy') == 'flagship_fast':
        from ..training.recipes import FLAGSHIP_FAST_DIM
        feats = rng.normal(size=(length, FLAGSHIP_FAST_DIM)).astype(
            np.float32)
    else:
        feats = rng.randint(0, TOY_NUM_TOKENS, size=length)
    return feats, rng.normal(size=(length, 3)).astype(np.float32)


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
    if args.host_mode:
        return serve_host(args)
    if args.fleet > 1:
        return serve_fleet(args)
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
            tokens, coords = make_request(args, rng, length)
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
                tokens, coords = make_request(args, rng, length)
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


def serve_host(args) -> int:
    """One fleet host (`--host`): the serve_multi stack behind a TCP RPC
    surface, serving until SIGTERM (drain, final records, exit 0)."""
    from ..faults import FaultInjector
    from ..observability import MetricLogger, PhaseTimer
    from ..observability.schema import SchemaError, validate_stream
    from ..serving import (
        HostServer, ReplicaWorker, Router, RouterTelemetry, serve_binary,
        serve_socket,
    )
    from ..training.guardian import PreemptionGuard
    from . import AdmissionController

    buckets = tuple(int(b) for b in args.buckets.split(','))
    _, module, params = build_module_and_params(args, buckets)

    t0 = time.perf_counter()
    timer = PhaseTimer()
    engines = build_replica_engines(args, module, params, buckets, timer)
    device = engines[0].device
    print(f'host {args.host_id}: warmed {len(engines)} replicas x '
          f'{len(engines[0].executables)} buckets in '
          f'{time.perf_counter() - t0:.1f}s on {device}', flush=True)
    injector = FaultInjector(seed=args.seed)
    workers = [ReplicaWorker(i, e, max_wait_ms=args.max_wait_ms,
                             async_dispatch=args.async_dispatch,
                             fault_injector=injector)
               for i, e in enumerate(engines)]
    admission = AdmissionController(max_len=buckets[-1],
                                    max_queue_depth=args.max_queue_depth)

    ok = True
    with Router(workers, admission=admission,
                max_retries=args.max_retries,
                default_timeout_s=args.timeout_s) as router:
        logger = MetricLogger(args.metrics, run_meta=dict(
            mode='serve_host', host_id=args.host_id, backend=device.type,
            replicas=len(engines), buckets=list(buckets),
            batch_size=args.batch_size, seed=args.seed, model=args.model,
            precision_mixes=[e.precision_name for e in engines]))
        telemetry = RouterTelemetry(router, admission, logger)
        telemetry.arm()

        # the chaos hook: once a swap restores --poison-step, every
        # dispatch fails (an every=1 plan) until another step is restored:
        # "the new weights are bad on this host", which the fleet's canary
        # gate must catch
        poison_plans = []

        def on_swap(payload, events):
            if args.poison_step is None:
                return
            tag = (events[0].get('tag') or '') if events else ''
            restored = tag.rsplit('@', 1)[-1]
            if restored == str(args.poison_step):
                poison_plans.append(injector.plan(
                    'replica_dispatch', 'exception', every=1))
                print(f'host {args.host_id}: poison armed: step '
                      f'{restored} restored, every dispatch fails until '
                      f'another step is swapped in', flush=True)
            elif poison_plans:
                for plan in poison_plans:
                    plan.max_fires = plan.fires    # spent: disarmed
                del poison_plans[:]
                print(f'host {args.host_id}: poison disarmed (step '
                      f'{restored} restored)', flush=True)

        host_server = HostServer(router, host_id=args.host_id,
                                 telemetry=telemetry,
                                 flush_every_batches=args.flush_every,
                                 on_swap=on_swap)
        if args.transport == 'binary':
            sock = serve_binary(host_server, port=args.port)
            # every serve record carries the wire's own counters
            telemetry.transport_source = sock.transport_stats
        else:
            sock = serve_socket(host_server, port=args.port)
        print(f'FLEET HOST READY host={args.host_id} port={sock.port} '
              f'transport={args.transport} device={device}', flush=True)
        with PreemptionGuard() as guard:
            while not guard.stop_requested:
                time.sleep(0.05)
        print(f'host {args.host_id}: {guard.signame}: graceful shutdown: '
              f'close the socket, drain the router, flush the records',
              flush=True)
        sock.close()
        host_server.stop(drain=True)
    # leaving the block drained the router and shut the executors down
    telemetry.flush()
    telemetry.fault_flush(injector=injector, label=f'host_{args.host_id}')
    telemetry.close()
    logger.close()

    if telemetry.post_warmup_compiles:
        print(f'FAIL: host {args.host_id}: '
              f'{telemetry.post_warmup_compiles} one-time host work events '
              f'after warmup: a swap or the stream broke the warmed-bucket '
              f'contract', flush=True)
        ok = False
    if args.metrics:
        try:
            info = validate_stream(args.metrics)
            print(f'host {args.host_id}: schema ok ({info["records"]} '
                  f'records {info["kinds"]})', flush=True)
        except SchemaError as e:
            print(f'FAIL: host {args.host_id}: telemetry stream invalid: '
                  f'{e}', flush=True)
            ok = False
    print(f'host {args.host_id}: served '
          f'{sum(w.served_rows for w in router.workers)} rows in '
          f'{router.batches_dispatched} batches, '
          f'{len(router.swap_events)} swaps, {router.request_failures} '
          f'structured failures', flush=True)
    return 0 if ok else 1


# --------------------------------------------------------------------- #
# fleet hosts as processes (shared with serving.fleet_chaos)
# --------------------------------------------------------------------- #
def host_command(host_id, *, port=0, buckets='8,16', batch_size=2,
                 replicas=1, seed=0, max_wait_ms=10.0, timeout_s=None,
                 max_retries=1, max_queue_depth=None, checkpoint=None,
                 checkpoint_step=None, metrics=None, poison_step=None,
                 bf16=False, async_dispatch=False, cpu=False,
                 transport='binary', model='toy', depth=6,
                 precision=None):
    """The argv of one `--host` process (run from the checkout)."""
    cmd = [sys.executable, '-m', 'se3_transformer_torch.inference.serve',
           '--host', '--host-id', str(host_id), '--port', str(port),
           '--buckets', str(buckets), '--batch-size', str(batch_size),
           '--replicas', str(replicas), '--seed', str(seed),
           '--max-wait-ms', str(max_wait_ms),
           '--max-retries', str(max_retries),
           '--transport', str(transport), '--model', str(model)]
    if model == 'flagship_fast':
        cmd += ['--depth', str(depth)]
    for flag, on in (('--cpu', cpu), ('--bf16', bf16),
                     ('--async-dispatch', async_dispatch)):
        if on:
            cmd.append(flag)
    for flag, value in (('--timeout-s', timeout_s),
                        ('--max-queue-depth', max_queue_depth),
                        ('--checkpoint', checkpoint),
                        ('--checkpoint-step', checkpoint_step),
                        ('--metrics', metrics),
                        ('--poison-step', poison_step),
                        ('--precision', precision)):
        if value is not None:
            cmd += [flag, str(value)]
    return cmd


def spawn_host(host_id, **kw):
    """Start one `--host` process: a fresh interpreter (never a fork of a
    process whose CUDA is up), stdout piped; call `wait_host_ready`, which
    also keeps the pipe drained (a full pipe would wedge the host)."""
    import subprocess
    return subprocess.Popen(host_command(host_id, **kw), cwd=_ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)


def wait_host_ready(proc, timeout_s=300.0):
    """Wait for the host's READY line; returns `(port, device, sink)`,
    `sink` being the list a daemon thread keeps appending the host's
    output to (started at once, so that the pipe never fills, and the
    deadline holds against a host that wedges without printing)."""
    import threading
    sink = []
    eof = threading.Event()

    def drain(p=proc, s=sink):
        try:
            for line in p.stdout:
                s.append(line)
        finally:
            eof.set()

    threading.Thread(target=drain, daemon=True).start()
    deadline = time.monotonic() + timeout_s
    scanned = 0
    while time.monotonic() < deadline:
        n = len(sink)
        while scanned < n:
            line = sink[scanned]
            scanned += 1
            if 'FLEET HOST READY' in line:
                fields = dict(kv.split('=', 1) for kv in line.split()
                              if '=' in kv)
                return int(fields['port']), fields.get('device'), sink
        if eof.is_set() and scanned >= len(sink):
            raise RuntimeError(
                f'fleet host died during warmup (rc={proc.poll()}):\n'
                + ''.join(sink[-30:]))
        time.sleep(0.05)
    raise RuntimeError(f'fleet host not READY within {timeout_s}s:\n'
                       + ''.join(sink[-30:]))


def stop_host(proc, timeout_s=90.0):
    """Graceful stop: SIGTERM, wait, SIGKILL only on a wedge. Returns the
    exit code (0: the graceful-shutdown contract held)."""
    import signal
    import subprocess
    if proc.poll() is None:
        try:
            proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
    try:
        return proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10.0)
        return proc.returncode


def serve_fleet(args) -> int:
    """The cross-host front end (`--fleet N`): start N `--host`
    processes, route the stream through a FleetRouter, write the `fleet`
    record, SIGTERM the hosts (each must exit 0)."""
    import numpy as np

    from ..observability import MetricLogger
    from ..observability.schema import SchemaError, validate_stream
    from ..serving import BinaryTransport, FleetRouter, SocketTransport
    from ..training.guardian import PreemptionGuard
    from .admission import RequestRejected

    buckets = tuple(int(b) for b in args.buckets.split(','))
    procs, ports, devices = [], [], []
    print(f'starting {args.fleet} fleet hosts...', flush=True)
    for i in range(args.fleet):
        procs.append(spawn_host(
            i, buckets=args.buckets, batch_size=args.batch_size,
            replicas=args.replicas, seed=args.seed,
            max_wait_ms=args.max_wait_ms, timeout_s=args.timeout_s,
            max_retries=args.max_retries,
            max_queue_depth=args.max_queue_depth,
            checkpoint=args.checkpoint,
            checkpoint_step=args.checkpoint_step, bf16=args.bf16,
            async_dispatch=args.async_dispatch, cpu=args.cpu,
            transport=args.transport, model=args.model,
            depth=args.depth, precision=args.precision))
    ok, lengths, pending, lost, unanswered = True, [], [], [], []
    interrupted, body = None, {}
    try:
        for p in procs:
            port, device, _ = wait_host_ready(p)
            ports.append(port)
            devices.append(device)
        print(f'fleet up: {args.fleet} hosts on ports {ports} '
              f'({devices})', flush=True)
        transport_cls = (BinaryTransport if args.transport == 'binary'
                         else SocketTransport)
        transports = {i: transport_cls('127.0.0.1', port)
                      for i, port in enumerate(ports)}
        rng = np.random.RandomState(args.seed)
        lengths = request_lengths(args, buckets, buckets[-1], rng)
        logger = MetricLogger(args.metrics, run_meta=dict(
            mode='serve_fleet', hosts=args.fleet, ports=ports,
            devices=devices, buckets=list(buckets), model=args.model,
            batch_size=args.batch_size, seed=args.seed))
        with FleetRouter(transports, max_retries=args.max_retries,
                         default_timeout_s=args.timeout_s) as fleet:
            with PreemptionGuard() as guard:
                for length in lengths:
                    if guard.stop_requested:
                        interrupted = guard.signame
                        print(f'{interrupted}: graceful shutdown: '
                              f'draining the fleet, flushing the records',
                              flush=True)
                        break
                    tokens, coords = make_request(args, rng, length)
                    try:
                        pending.append(fleet.submit(tokens, coords))
                    except RequestRejected as e:
                        print(f'rejected: {e.code} {e.detail}')
                        logger.log_record('step', mirror=False,
                                          step=len(pending),
                                          rejected=e.to_record())
                    fleet.pump()
                    if args.pace_ms:
                        time.sleep(args.pace_ms / 1e3)
                fleet.drain()
            body = fleet.record_body(pending, label='serve_fleet')
            logger.log_record('fleet', mirror=False, **body)
        logger.close()
        for t in transports.values():
            if hasattr(t, 'close'):
                t.close()

        lost = [p.request_id for p in pending if not p.done]
        # a host-side RequestRejected (an oversize request sent before the
        # first scrape named the buckets) is a structured outcome
        unanswered = [p.request_id for p in pending
                      if not p.ok
                      and not isinstance(p.error, RequestRejected)]
        if lost:
            print(f'FAIL: {len(lost)} requests lost fleet-wide')
            ok = False
        if unanswered:
            print(f'FAIL: {len(unanswered)} in-range requests resolved '
                  f'unanswered (a healthy fleet answers every one)')
            ok = False
        if not args.cpu and any(not str(d).startswith('cuda')
                                for d in devices):
            print(f'FAIL: hosts on {devices}: every host must serve on '
                  f'the card')
            ok = False
        if args.metrics:
            try:
                info = validate_stream(args.metrics)
                print(f'schema ok: {info["records"]} records '
                      f'{info["kinds"]}')
            except SchemaError as e:
                print(f'FAIL: telemetry stream invalid: {e}')
                ok = False
    finally:
        rcs = [stop_host(p) for p in procs]
    print(f'fleet hosts stopped: rcs {rcs}')
    if any(rc != 0 for rc in rcs):
        print('FAIL: a fleet host exited non-zero on a graceful SIGTERM')
        ok = False

    report = dict(ok=ok, interrupted=interrupted, hosts=args.fleet,
                  devices=devices, host_rcs=rcs,
                  requests=dict(total=len(lengths),
                                submitted=len(pending),
                                answered=len(pending) - len(unanswered),
                                lost=len(lost)),
                  fleet={k: body.get(k) for k in (
                      'answered', 'cross_host_retries',
                      'request_failures', 'heartbeats')})
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=2)
        print(f'report -> {args.out}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
