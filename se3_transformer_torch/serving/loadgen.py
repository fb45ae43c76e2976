"""The transport A/B: the counterpart of the repository's
scripts/transport_loadgen.py.

    python -m se3_transformer_torch.serving.loadgen [--requests 240]
        [--concurrency 8] [--length 768] [--pool-size 2] [--seed 0]
        [--metrics TRANSPORT.jsonl] [--out SUMMARY.json]

One seeded closed-loop workload (C client threads, N `infer` calls
against one host: a `HostServer` and `Router` over an engine that answers
at once, so that the wire is what varies) is driven through each wire:

  legacy: `serve_socket` + `SocketTransport`: a connection a call,
          newline JSON, arrays as lists at the wire;
  binary: `serve_binary` + `BinaryTransport`: persistent pooled
          connections, correlation-id multiplexing, length-prefixed
          frames with raw dtype- and shape-tagged array segments.

Per arm: requests/s (closed-loop wall clock), p50/p99 request latency,
and bytes on the wire per call off the transport's own counters. With
--metrics it writes one schema'd `transport` record
(`qps_binary_vs_legacy`, `p99_binary_vs_legacy`,
`wire_bytes_binary_vs_legacy`). It exits non-zero on an error or a short
arm, a frame error, a reconnect with no host restart, or a binary arm
that never had two calls in flight. Host-side Python only: it touches no
device.
"""
import argparse
import json
import sys
import threading
import time
import uuid

import numpy as np

from ..observability import PhaseTimer


class WireBoundEngine:
    """An engine-shaped stand-in that answers at once, so that the A/B
    isolates the transport: serialization, connection setup and framing
    are the only costs that differ between the arms."""

    def __init__(self, buckets, batch_size=2):
        self.buckets = tuple(buckets)
        self.batch_size = batch_size
        self.rows_served = {b: 0 for b in self.buckets}
        self.params = 'v0'
        self.executables = {}
        self.cost_payloads = {}
        self.timer = PhaseTimer()

    def run(self, bucket, tokens, coords, mask):
        self.rows_served[bucket] += int(np.asarray(mask).any(-1).sum())
        with self.timer.phase(f'bucket_{bucket}'):
            pass
        return np.broadcast_to(
            np.arange(tokens.shape[1], dtype=np.float32)[None, :, None],
            tokens.shape + (3,)).copy()


def build_host(length, batch_size=2):
    """One host (HostServer over a Router over the wire-bound engine)."""
    from ..inference import AdmissionController
    from . import HostServer, ReplicaWorker, Router
    engine = WireBoundEngine((length,), batch_size)
    worker = ReplicaWorker(0, engine, max_wait_ms=1.0)
    router = Router([worker],
                    admission=AdmissionController(max_len=length),
                    max_retries=1)
    return HostServer(router, host_id=0)


def workload(n, length, seed):
    """Seeded requests made up front: the same arrays hit both arms,
    sized so that the arrays' serialization outweighs the envelope."""
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        ln = int(rng.randint(max(length // 2, length - 128), length + 1))
        reqs.append((rng.randint(0, 32, size=ln).astype(np.int32),
                     rng.normal(size=(ln, 3)).astype(np.float32)))
    return reqs


def run_arm(name, transport, requests, concurrency, timeout_s=30.0):
    """Closed loop: C threads race through the shared request list; every
    response's shape is checked, so that a transport that corrupts the
    array path cannot win on speed."""
    lock = threading.Lock()
    latencies, failures = [], []
    cursor = [0]

    def client(tid):
        while True:
            with lock:
                i = cursor[0]
                if i >= len(requests):
                    return
                cursor[0] += 1
            tokens, coords = requests[i]
            t0 = time.perf_counter()
            try:
                resp = transport.call(
                    'infer',
                    dict(tokens=tokens, coords=coords,
                         timeout_s=timeout_s),
                    timeout_s=timeout_s)
                if not resp.get('ok'):
                    raise RuntimeError(f'structured failure: '
                                       f'{resp.get("error")}')
                result = np.asarray(resp['result'])
                if result.shape != (len(tokens), 3):
                    raise RuntimeError(
                        f'result shape {result.shape} != '
                        f'({len(tokens)}, 3)')
            except Exception as e:  # noqa: BLE001
                with lock:
                    failures.append(f'{name}[t{tid} req{i}]: {e}')
                continue
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                latencies.append(ms)

    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t_start

    stats = transport.transport_stats()
    lat = sorted(latencies)

    def pct(p):
        return round(lat[min(len(lat) - 1,
                             int(p / 100.0 * len(lat)))], 3) if lat else 0.0

    wire = stats['bytes_sent'] + stats['bytes_received']
    arm = dict(
        requests=len(latencies),
        errors=len(failures),
        qps=round(len(latencies) / max(wall_s, 1e-9), 2),
        p50_ms=pct(50), p99_ms=pct(99),
        bytes_per_call=int(wire / max(len(latencies), 1)),
        wall_s=round(wall_s, 3),
        transport=stats,
    )
    for f in failures[:5]:
        print(f'  ERROR {f}')
    print(f'{name:>6}: {arm["requests"]} ok / {arm["errors"]} err, '
          f'{arm["qps"]} qps, p50 {arm["p50_ms"]}ms p99 {arm["p99_ms"]}ms, '
          f'{arm["bytes_per_call"]} B/call '
          f'(conns {stats["connections_opened"]}, '
          f'peak in-flight {stats["peak_in_flight"]}, '
          f'frame errors {stats["frame_errors"]})')
    return arm


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='transport A/B: legacy connect-per-call JSON vs '
                    'pooled multiplexed binary frames, one seeded '
                    'workload')
    ap.add_argument('--metrics', default=None,
                    help='write the schema-valid transport stream here')
    ap.add_argument('--out', default=None,
                    help='write the summary JSON here')
    ap.add_argument('--requests', type=int, default=240)
    ap.add_argument('--concurrency', type=int, default=8)
    ap.add_argument('--length', type=int, default=768,
                    help='engine bucket / max token length: sized so '
                         'array bytes dominate the control envelope')
    ap.add_argument('--pool-size', type=int, default=2,
                    help='binary arm: pooled connections per client')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    run_id = f'transport_loadgen_{uuid.uuid4().hex[:8]}'
    from . import (
        BinaryTransport, SocketTransport, serve_binary, serve_socket,
    )

    requests = workload(args.requests, args.length, args.seed)
    ok = True
    arms = {}

    # ---- legacy arm: connect-per-call newline-JSON ----------------- #
    host = build_host(args.length)
    sock = serve_socket(host, port=0)
    legacy = SocketTransport('127.0.0.1', sock.port, label='ab-legacy')
    try:
        arms['legacy'] = run_arm('legacy', legacy, requests,
                                 args.concurrency)
    finally:
        sock.close()
        host.stop()

    # ---- binary arm: pooled + multiplexed + raw array frames ------- #
    host = build_host(args.length)
    srv = serve_binary(host, port=0)
    binary = BinaryTransport('127.0.0.1', srv.port, label='ab-binary',
                             pool_size=args.pool_size)
    try:
        arms['binary'] = run_arm('binary', binary, requests,
                                 args.concurrency)
        server_stats = srv.transport_stats()
    finally:
        binary.close()
        srv.close()
        host.stop()

    for name, arm in arms.items():
        if arm['errors'] or arm['requests'] != args.requests:
            print(f'FAIL: {name} arm answered {arm["requests"]}/'
                  f'{args.requests} with {arm["errors"]} errors')
            ok = False
    bstats = arms['binary']['transport']
    if bstats['frame_errors'] or server_stats['frame_errors']:
        print(f'FAIL: frame errors on a clean run (client '
              f'{bstats["frame_errors"]}, server '
              f'{server_stats["frame_errors"]})')
        ok = False
    if bstats['reconnects']:
        print(f'FAIL: {bstats["reconnects"]} reconnects with no host '
              f'restart: the connections do not persist')
        ok = False
    if bstats['peak_in_flight'] < 2:
        print('FAIL: binary peak in flight below 2: nothing was '
              'multiplexed')
        ok = False

    def ratio(field):
        b, l = arms['binary'][field], arms['legacy'][field]
        return round(b / max(l, 1e-9), 3)

    ratios = dict(
        qps_binary_vs_legacy=ratio('qps'),
        p99_binary_vs_legacy=ratio('p99_ms'),
        wire_bytes_binary_vs_legacy=ratio('bytes_per_call'),
    )
    print(f'binary vs legacy: {ratios["qps_binary_vs_legacy"]}x QPS, '
          f'{ratios["p99_binary_vs_legacy"]}x p99, '
          f'{ratios["wire_bytes_binary_vs_legacy"]}x wire bytes')

    if args.metrics:
        from ..observability.report import write_record_stream
        from ..observability.schema import validate_stream
        body = dict(
            kind='transport',
            label=f'loadgen,n={args.requests},c={args.concurrency},'
                  f'len={args.length}',
            workload=dict(requests=args.requests,
                          concurrency=args.concurrency,
                          length=args.length, seed=args.seed,
                          pool_size=args.pool_size),
            arms={name: {k: v for k, v in arm.items()
                         if k != 'transport'}
                  for name, arm in arms.items()},
            transport=bstats,
            server_transport=server_stats,
            **ratios)
        write_record_stream(args.metrics, run_id, [body])
        info = validate_stream(args.metrics)
        print(f'schema ok: {info["records"]} records {info["kinds"]}')

    report = dict(ok=ok, arms=arms, server_transport=server_stats, **ratios)
    print(json.dumps(dict(ok=ok, **ratios)))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=2)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
