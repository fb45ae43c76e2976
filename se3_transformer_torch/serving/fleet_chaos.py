"""The fleet chaos run: the cross-host fault domain under seeded fire, with
real processes dying. The counterpart of the repository's
scripts/fleet_chaos_smoke.py.

    python -m se3_transformer_torch.serving.fleet_chaos [--cpu]
        [--hosts 3] [--requests 36] [--buckets 8,16] [--batch-size 2]
        [--timeout-s 30] [--max-retries 2] [--seed 0] [--kill-at 10]
        [--canary-requests 6] [--model toy|flagship_fast [--depth L]]
        [--metrics FLEET_CHAOS.jsonl] [--out SUMMARY.json]
        [--transport binary|legacy] [--weaken none|noexclude]

Three `python -m se3_transformer_torch.inference.serve --host` processes
(each a whole single-host stack: engines, continuous batcher, router,
breakers; on one card they share it, each with a CUDA context of its own)
serve a mixed-length stream through a `serving.fleet.FleetRouter` while
the run injects, deterministically:

  * a host death: host 0 is SIGKILLed mid-run (no drain, no goodbye; its
    card memory is freed once its process is gone). Its RPCs in flight
    and after fail, the fleet redispatches them to other hosts (zero
    lost), failed heartbeats walk the host breaker to quarantined, and
    once the run restarts the process on the same port, half-open ping
    probes close the breaker again: recovery observed, not assumed;
  * transport faults: a seeded `FaultInjector` `transport` plan makes a
    latency spike and a partition-style drop on the fleet's RPCs (same
    seed, same faults), so a cross-host retry runs even before the kill;
  * a poisoned canary: a rolling rollout (checkpoint step 1 -> step 2
    over the hosts' drain and swap contract) canaries on a host started
    with `--poison-step 2`: once the canary restores the new step every
    dispatch on it fails. The canary gate (pinned probe traffic and the
    host's scraped evidence) must fail and the fleet must roll back to
    step 1, leaving every other host on the old weights.

The card is the default device (a host that finds none fails); --cpu
runs the plain PyTorch path. Exit is non-zero unless all of:

  * zero lost requests fleet-wide (every submit, the sacrificial canary
    probes included, resolves answered or with a structured error);
  * every in-range request that is not a probe is answered (the
    redispatch must pay the kill down, not only fail it structurally);
  * at least one host quarantine -> recovery transition of the killed
    host, and at least one cross-host retry;
  * the rollout event shows the canary swapped to step 2, the gate
    failing, a rollback to step 1, and zero sibling swaps;
  * the planned transport faults fired (latency and drop);
  * no one-time host work after warmup on any host (scraped at the end);
  * every host is on the card (unless --cpu) and exits 0 on SIGTERM;
  * tracing survives the chaos: zero orphan spans, completeness 1.0
    across the SIGKILL (the dead host's spans die with it; the fleet's
    tree stays single-rooted through the redispatch), and at least one
    multi-host trace;
  * the stream (run_meta and the schema'd `fleet` and `trace` records)
    validates.

`--weaken noexclude` is the check of those gates: host exclusion is
nulled (placement ignores the breakers, retries stop avoiding the host
that just failed) and the killed host is never restarted. The dead
lowest-id host keeps taking traffic, requests spend their budgets
unanswered and no recovery is seen: the run must exit 1.
"""
import argparse
import atexit
import json
import os
import shutil
import signal
import sys
import tempfile
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description='the cross-host fleet under seeded chaos, hosts as '
                    'processes')
    ap.add_argument('--hosts', type=int, default=3)
    ap.add_argument('--requests', type=int, default=36,
                    help='phase A stream length (the kill lands inside)')
    ap.add_argument('--post-requests', type=int, default=8,
                    help='phase D stream length (after the rollback the '
                         'fleet must still answer everything)')
    ap.add_argument('--buckets', type=str, default='8,16')
    ap.add_argument('--batch-size', type=int, default=2)
    ap.add_argument('--max-wait-ms', type=float, default=10.0)
    ap.add_argument('--timeout-s', type=float, default=30.0)
    ap.add_argument('--max-retries', type=int, default=2)
    ap.add_argument('--pace-ms', type=float, default=30.0)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--kill-at', type=int, default=10,
                    help='SIGKILL host 0 after this many phase A submits')
    ap.add_argument('--restart-after-s', type=float, default=1.0)
    ap.add_argument('--canary-requests', type=int, default=6)
    ap.add_argument('--latency-budget-ms', type=float, default=30000.0,
                    help='the canary gate\'s latency ceiling (generous: '
                         'the poisoned canary fails on answers, not '
                         'latency)')
    ap.add_argument('--recovery-deadline-s', type=float, default=240.0,
                    help='bound on waiting for the restarted host to warm '
                         'up and close its breaker through probes')
    ap.add_argument('--ckpt-dir', type=str, default=None)
    ap.add_argument('--model', choices=('toy', 'flagship_fast'),
                    default='toy')
    ap.add_argument('--depth', type=int, default=6)
    ap.add_argument('--metrics', type=str, default=None)
    ap.add_argument('--out', type=str, default=None)
    ap.add_argument('--transport', choices=('binary', 'legacy'),
                    default='binary',
                    help='the fleet wire under chaos: the pooled '
                         'multiplexed binary frames (default) or the '
                         'legacy JSON, a connection a call')
    ap.add_argument('--cpu', action='store_true',
                    help='hosts on the CPU (the plain PyTorch path)')
    ap.add_argument('--weaken', choices=('none', 'noexclude'),
                    default='none',
                    help="'noexclude': null host exclusion and skip the "
                         'restart: the gates must fire (exit 1)')
    args = ap.parse_args(argv)
    # build_module_and_params reads these: the run draws its weights
    args.checkpoint = None
    args.checkpoint_step = None
    return args


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from ..faults import FaultInjector
    from ..inference.serve import (
        build_module_and_params, make_request, spawn_host, stop_host,
        wait_host_ready,
    )
    from ..observability import MetricLogger, Tracer, trace_record_body
    from ..observability.report import summarize_fleet_records
    from ..observability.schema import SchemaError, validate_stream
    from ..training.checkpoint import CheckpointManager
    from . import BinaryTransport, FleetRouter, HealthConfig, SocketTransport

    buckets = tuple(int(b) for b in args.buckets.split(','))
    weakened = args.weaken == 'noexclude'
    kill_host = 0       # lowest id: the weaken arm's tie-breaks land on
    #                     it, so nulled exclusion keeps feeding it
    canary = args.hosts - 1

    # ---- the weight refs: step 1 = current, step 2 = rollout target -- #
    _, module_old, _ = build_module_and_params(args, buckets)
    _, module_new, _ = build_module_and_params(args, buckets,
                                               seed=args.seed + 1)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix='fleet_ckpt_')
    if args.ckpt_dir is None:
        atexit.register(shutil.rmtree, ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(ckpt_dir, model_family=module_old.model_family)
    mgr.save(1, dict(params=module_old.state_dict()))
    mgr.save(2, dict(params=module_new.state_dict()))
    mgr.close()
    del module_old, module_new
    print(f'checkpoints: step 1 (current) and step 2 (the rollout '
          f'target) in {ckpt_dir}')

    # ---- spawn the host processes (canary carries the poison) -------- #
    tmp = tempfile.mkdtemp(prefix='fleet_chaos_')
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)

    def host_kw(i, port=0):
        return dict(
            port=port, buckets=args.buckets, batch_size=args.batch_size,
            replicas=1, seed=args.seed, max_wait_ms=args.max_wait_ms,
            timeout_s=args.timeout_s, max_retries=1,
            checkpoint=ckpt_dir, checkpoint_step=1,
            metrics=os.path.join(tmp, f'host_{i}.jsonl'),
            poison_step=2 if i == canary else None,
            transport=args.transport, cpu=args.cpu, model=args.model,
            depth=args.depth)

    print(f'starting {args.hosts} host processes (canary={canary} '
          f'poisoned at step 2)...', flush=True)
    procs = [spawn_host(i, **host_kw(i)) for i in range(args.hosts)]

    def kill_everything():
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
    atexit.register(kill_everything)

    ports, sinks, devices = [], [], []
    t0 = time.monotonic()
    for p in procs:
        port, device, sink = wait_host_ready(p)
        ports.append(port)
        sinks.append(sink)
        devices.append(device)
    ready_s = round(time.monotonic() - t0, 3)
    print(f'fleet up in {ready_s}s: hosts on ports {ports} ({devices})',
          flush=True)

    # ---- the fleet front-end + the seeded transport fault plan ------- #
    inj = FaultInjector(seed=args.seed)
    inj.plan('transport', 'latency', every=11, latency_s=0.02)
    inj.plan('transport', 'drop', at=(5,), match=dict(method='infer'))
    # the chaos gates (SIGKILL reconnect, seeded drop/latency faults,
    # canary rollback) run on the binary wire by default; --transport
    # legacy runs them on the newline-JSON wire
    transport_cls = (BinaryTransport if args.transport == 'binary'
                     else SocketTransport)
    transports = {i: transport_cls('127.0.0.1', port,
                                   fault_injector=inj)
                  for i, port in enumerate(ports)}
    health = HealthConfig(quarantine_after=3, recover_after=2,
                          probe_backoff_s=0.25, probe_backoff_max_s=2.0)
    logger = MetricLogger(args.metrics, run_meta=dict(
        mode='fleet_chaos', hosts=args.hosts, ports=ports,
        devices=devices, buckets=list(buckets), seed=args.seed,
        weaken=args.weaken, kill_host=kill_host, canary=canary,
        model=args.model))
    rng = np.random.RandomState(args.seed)
    pending, probes = [], []
    rollout_event = None
    killed_at_t = None
    restarted = False
    restart = {}
    ok = True

    def mk_request():
        b = buckets[int(rng.randint(0, len(buckets)))]
        low = 1 if b == buckets[0] else buckets[0] + 1
        return make_request(args, rng, int(rng.randint(low, b + 1)))

    def respawn():
        """Restart the killed host on its port (a fresh interpreter)."""
        print(f'restarting host {kill_host} on port {ports[kill_host]}...',
              flush=True)
        restart['spawned_after_kill_s'] = round(
            time.monotonic() - killed_at_t, 3)
        procs[kill_host] = spawn_host(
            kill_host, **host_kw(kill_host, port=ports[kill_host]))

    # every submit is traced: under the SIGKILL the dead host's own
    # spans are simply lost with the process, but the fleet-side span
    # tree must STAY complete (the failed attempt ends transport_error,
    # the redispatch hop is recorded, the retry attempt carries the
    # sibling host): zero orphans even across a host death
    tracer = Tracer(origin='fleet')
    with FleetRouter(transports, health=health,
                     max_retries=args.max_retries,
                     default_timeout_s=args.timeout_s,
                     heartbeat_every_s=0.2,
                     stale_after_s=3.0, tracer=tracer) as fleet:
        if weakened:
            # the weakened arm: the exclusion mechanism (quarantine
            # filtering, failed-host avoidance, health-ranked placement)
            # is a no-op. The dead host keeps taking traffic; the gates
            # below must catch it (rc 1), or they decide nothing.
            print('WEAKENED GATE ARM: host exclusion nulled, no '
                  'restart (this run must exit 1)')
            fleet.host_exclusion = False

        # scrape until the routing signals (and buckets) arrive
        t0 = time.monotonic()
        while fleet.buckets is None and time.monotonic() - t0 < 30:
            fleet.pump()
            time.sleep(0.05)
        assert fleet.buckets == buckets, \
            f'scraped buckets {fleet.buckets} != served {buckets}'

        # ---- phase A: the stream, with a mid-run SIGKILL ------------- #
        for i in range(args.requests):
            if i == args.kill_at:
                print(f'SIGKILL host {kill_host} (pid '
                      f'{procs[kill_host].pid}) after {i} submits: a real '
                      f'preemption, no drain', flush=True)
                os.kill(procs[kill_host].pid, signal.SIGKILL)
                # its card memory is freed once the process is gone
                procs[kill_host].wait()
                killed_at_t = time.monotonic()
            if killed_at_t is not None and not restarted \
                    and not weakened \
                    and time.monotonic() - killed_at_t \
                    >= args.restart_after_s:
                respawn()
                restarted = True
            tokens, coords = mk_request()
            pending.append(fleet.submit(tokens, coords))
            fleet.pump()
            time.sleep(args.pace_ms / 1e3)
        fleet.drain()
        if killed_at_t is not None and not restarted and not weakened:
            # the stream outran the restart delay: restart now, the
            # recovery must still be OBSERVED via probes below
            remaining = args.restart_after_s - (time.monotonic()
                                                - killed_at_t)
            if remaining > 0:
                time.sleep(remaining)
            respawn()
            restarted = True
        answered_a = sum(1 for p in pending if p.ok)
        print(f'phase A: {answered_a}/{len(pending)} answered, '
              f'{fleet.cross_host_retries} cross-host retries, '
              f'host {kill_host} state '
              f'{fleet.health.state(kill_host)!r}')
        logger.log_record('fleet', mirror=False,
                          **fleet.record_body(pending, label='phase_a'))

        # ---- phase B: wait for the restarted host's recovery --------- #
        if restarted:
            # the new process warms its buckets and must close its breaker
            # through ping probes: the recovery is observed, not assumed
            _, device, sink = wait_host_ready(procs[kill_host])
            sinks[kill_host] = sink
            devices[kill_host] = device
            restart['ready_after_kill_s'] = round(
                time.monotonic() - killed_at_t, 3)
            print(f'host {kill_host} restarted and READY on {device}: '
                  f'waiting for the breaker to close through probes',
                  flush=True)
            t0 = time.monotonic()
            while fleet.health.recoveries == 0 and \
                    time.monotonic() - t0 < args.recovery_deadline_s:
                fleet.pump()
                time.sleep(0.1)
            fleet.drain()
            restart['recovered_after_kill_s'] = round(
                time.monotonic() - killed_at_t, 3)
            print(f'recoveries={fleet.health.recoveries}, host '
                  f'{kill_host} state '
                  f'{fleet.health.state(kill_host)!r}')

        # ---- phase C: the canaried rollout (must auto-roll-back) ----- #
        canary_traffic = [mk_request()
                          for _ in range(args.canary_requests)]
        rollout_event, probes = fleet.rollout(
            dict(directory=ckpt_dir, step=2),
            dict(directory=ckpt_dir, step=1),
            canary_traffic, canary=canary,
            latency_budget_ms=args.latency_budget_ms,
            timeout_s=args.timeout_s)
        pending += probes
        print(f'rollout: canary={rollout_event["canary"]} '
              f'tag={rollout_event.get("canary_tag")!r} '
              f'gate={rollout_event.get("gate")} '
              f'rolled_back={rollout_event.get("rolled_back")}')

        # ---- phase D: the fleet must still serve after the rollback -- #
        post = []
        for _ in range(args.post_requests):
            tokens, coords = mk_request()
            post.append(fleet.submit(tokens, coords))
            fleet.pump()
            time.sleep(args.pace_ms / 1e3)
        # the poisoned canary quarantined during the gate; give its
        # probe recovery a bounded chance too (more breaker evidence)
        t0 = time.monotonic()
        while fleet.health.state(canary) == 'quarantined' \
                and time.monotonic() - t0 < 30:
            fleet.pump()
            time.sleep(0.1)
        fleet.drain()
        pending += post
        print(f'phase D: {sum(1 for p in post if p.ok)}/{len(post)} '
              f'answered after the rollback')

        # ---- final evidence: scraped stats + the banked record ------- #
        final_stats = {}
        for hid, t in transports.items():
            try:
                res = t.call('stats', timeout_s=5.0)
                final_stats[hid] = res.get('stats') or {}
            except Exception as e:
                final_stats[hid] = dict(error=str(e))
        body = fleet.record_body(pending, label='fleet_chaos')
        logger.log_record('fleet', mirror=False, **body)
        resolved = sum(1 for p in pending if p.done)
        trace_body = trace_record_body(tracer, label='fleet_chaos',
                                       expected=resolved)
        logger.log_record('trace', mirror=False, **trace_body)
    logger.close()

    # ---- graceful shutdown: every host must exit 0 on SIGTERM -------- #
    rcs = [stop_host(p) for p in procs]
    print(f'host exit codes on graceful SIGTERM: {rcs}')

    # ---- gates ------------------------------------------------------- #
    probe_ids = {p.request_id for p in probes}
    lost = [p.request_id for p in pending if not p.done]
    if lost:
        print(f'FAIL: {len(lost)} submitted requests LOST fleet-wide '
              f'(resolved neither answered nor structured-error): '
              f'{lost[:10]}')
        ok = False
    unanswered = [p.request_id for p in pending
                  if not p.ok and p.request_id not in probe_ids]
    if unanswered:
        print(f'FAIL: {len(unanswered)} non-probe requests resolved '
              f'unanswered: cross-host redispatch must pay the kill '
              f'down: {unanswered[:10]}')
        ok = False
    killed_recovered = any(
        e.get('from_state') == 'quarantined'
        and e.get('host') == kill_host
        for e in body['host_transitions'])
    if body['recoveries'] < 1 or not killed_recovered:
        print(f'FAIL: the SIGKILLed host {kill_host} was never '
              f'observed recovering (quarantine -> live via probe '
              f'after restart); transitions: '
              f'{body["host_transitions"]}')
        ok = False
    if body['cross_host_retries'] < 1:
        print('FAIL: zero cross-host retries: nothing was ever '
              'redispatched onto a sibling host')
        ok = False
    if rollout_event is None or not rollout_event.get('rolled_back'):
        print('FAIL: the poisoned canary rollout did NOT auto-roll-'
              'back: the gate decorated instead of deciding')
        ok = False
    else:
        if not str(rollout_event.get('canary_tag', '')).endswith('@2'):
            print(f'FAIL: canary swap tag '
                  f'{rollout_event.get("canary_tag")!r}: expected the '
                  f'rollout target step 2')
            ok = False
        rb = rollout_event.get('rollback') or {}
        if not str(rb.get('tag', '')).endswith('@1'):
            print(f'FAIL: rollback tag {rb.get("tag")!r}: expected '
                  f'the previous step 1')
            ok = False
        # EVERY non-canary host must show zero swaps: the restarted
        # kill_host included (its fresh process counts from 0, so a
        # rollout that wrongly rolled it would show there too)
        sibling_swaps = {hid: (final_stats.get(hid) or {}).get('swaps')
                         for hid in range(args.hosts) if hid != canary}
        if any(s != 0 for s in sibling_swaps.values()):
            print(f'FAIL: sibling hosts swapped during a rolled-back '
                  f'canary: {sibling_swaps} (must all be 0)')
            ok = False
    by_site = inj.snapshot()['by_site']
    for needed in ('transport:latency', 'transport:drop'):
        if not by_site.get(needed):
            print(f'FAIL: planned transport fault {needed!r} never '
                  f'fired: the chaos proved less than it claims')
            ok = False
    compiles = {hid: (final_stats.get(hid) or {})
                .get('post_warmup_compiles') for hid in final_stats}
    if any(c is None or c != 0 for c in compiles.values()):
        print(f'FAIL: one-time host work after warmup per host '
              f'{compiles}: the rollout and rollback swaps and the chaos '
              f'must not break the warmed-bucket contract')
        ok = False
    if not args.cpu and any(not str(d).startswith('cuda')
                            for d in devices):
        print(f'FAIL: hosts on {devices}: every host must serve on the '
              f'card')
        ok = False
    if any(rc != 0 for rc in rcs):
        print(f'FAIL: host exit codes {rcs}: graceful SIGTERM must '
              f'drain, bank telemetry, and exit 0')
        ok = False
        for i, rc in enumerate(rcs):
            if rc != 0:
                print(f'--- host {i} tail ---')
                print(''.join(sinks[i][-15:]) if i < len(sinks) else '?')
    # tracing must survive the chaos: a SIGKILLed host takes its own
    # spans down with it, but every fleet-side tree must stay complete
    #: a single orphan means some latency can no longer be attributed
    if trace_body['orphan_spans'] != 0:
        print(f'FAIL: {trace_body["orphan_spans"]} orphan span(s) '
              f'under SIGKILL/redispatch: the span trees must stay '
              f'single-rooted across a host death')
        ok = False
    if trace_body['completeness_total'] < 1.0:
        print(f'FAIL: trace completeness '
              f'{trace_body["completeness_total"]} < 1.0 '
              f'({trace_body["complete_trees"]}/{trace_body["traces"]} '
              f'complete over {resolved} resolved)')
        ok = False
    if trace_body['multi_host_traces'] < 1:
        print('FAIL: no multi-host trace: a redispatched request '
              'must show attempts on >= 2 hosts')
        ok = False
    if args.metrics:
        try:
            info = validate_stream(args.metrics)
            print(f'schema ok: {info["records"]} records '
                  f'{info["kinds"]}')
        except SchemaError as e:
            print(f'FAIL: telemetry stream invalid: {e}')
            ok = False

    report = dict(
        ok=ok,
        weaken=args.weaken,
        requests=dict(submitted=len(pending),
                      answered=sum(1 for p in pending if p.ok),
                      structured_failures=sum(
                          1 for p in pending
                          if p.done and p.error is not None),
                      lost=len(lost), unanswered_non_probe=len(unanswered)),
        fleet=summarize_fleet_records(
            [dict(body, kind='fleet')]),
        rollout=rollout_event,
        trace={k: trace_body[k] for k in (
            'traces', 'complete_trees', 'orphan_spans',
            'multi_host_traces', 'redispatch_hops',
            'completeness_total')},
        injections=by_site,
        host_rcs=rcs,
        devices=devices,
        post_warmup_compiles=compiles,
        ready_s=ready_s,
        restart=restart,
        host_swaps=body.get('host_swaps'),
        host_stats={str(hid): {k: st.get(k) for k in (
            'device', 'launches', 'routed', 'peak_bytes', 'served',
            'batches', 'swaps')} for hid, st in final_stats.items()},
    )
    print(json.dumps(report, indent=2, default=str))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=2, default=str)
        print(f'report -> {args.out}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
