"""The port's cross-host fleet tier (se3_transformer_torch.serving.fleet and
.transport) on the CPU, held to the JAX package's (se3_transformer_tpu.
serving.fleet): the transport contract (local and socket arms, injected
faults), the HostServer RPC surface over a real Router (fake engines, no
forward), the FleetRouter's host breaker walk, cross-host redispatch,
deadlines, capability-aware placement and canaried rollout with its
rollback, the schema'd `fleet` record, and a `--host` process drained by a
real SIGTERM.

Scenarios whose JAX counterparts pass on this tree run through both
packages with the same assertions (`ns` is 'jax' or 'torch'). JAX's swap
and rollout tests fail on this tree (its checkpoint restore), so the
port's swap and rollouts are held to JAX's `rollout` contract (the
assertions of its tests) and its records to JAX's schema validator."""
import os
import signal
import subprocess
import threading
import time
import types

import numpy as np
import pytest
import torch

from se3_transformer_torch.inference import serve as tserve
from se3_transformer_torch.observability import schema as tschema
from se3_transformer_tpu.observability import schema as jschema

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _namespace(name):
    if name == 'jax':
        from se3_transformer_tpu import faults, serving
        from se3_transformer_tpu.inference import admission
        from se3_transformer_tpu.observability import PhaseTimer
    else:
        from se3_transformer_torch import faults, serving
        from se3_transformer_torch.inference import admission
        from se3_transformer_torch.observability import PhaseTimer
    return types.SimpleNamespace(
        name=name, serving=serving, PhaseTimer=PhaseTimer,
        FaultInjector=faults.FaultInjector,
        AdmissionController=admission.AdmissionController,
        RequestFailed=admission.RequestFailed,
        RequestRejected=admission.RequestRejected)


NAMESPACES = {name: _namespace(name) for name in ('jax', 'torch')}
TORCH = NAMESPACES['torch']


@pytest.fixture(params=['jax', 'torch'])
def ns(request):
    return NAMESPACES[request.param]


class FakeEngine:
    """Engine-shaped stand-in (no forward): answers each row's position,
    so that a result is checkable; `fail` makes every run raise; a params
    setter makes a swap observable."""

    def __init__(self, ns, buckets=(4, 8), batch_size=2):
        self.buckets = tuple(buckets)
        self.batch_size = batch_size
        self.rows_served = {b: 0 for b in self.buckets}
        self._params = 'v0'
        self.timer = ns.PhaseTimer()
        self.executables = {}
        self.cost_payloads = {}
        self.fail = False

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value):
        self._params = value

    def run(self, bucket, tokens, coords, mask):
        if self.fail:
            raise RuntimeError('engine down')
        self.rows_served[bucket] += int(np.asarray(mask).any(-1).sum())
        with self.timer.phase(f'bucket_{bucket}'):
            pass
        return np.broadcast_to(
            np.arange(tokens.shape[1], dtype=np.float32)[None, :, None],
            tokens.shape + (3,)).copy()


def killable(ns):
    class KillableTransport(ns.serving.LocalTransport):
        """A LocalTransport with a kill switch: a dead one raises
        TransportError on every call (the SIGKILLed host)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.dead = False
            self.refused = 0

        def call(self, method, payload=None, timeout_s=None):
            if self.dead:
                self.refused += 1
                raise ns.serving.TransportError(
                    f'{self.label}: connection refused (host dead)')
            return super().call(method, payload, timeout_s=timeout_s)
    return KillableTransport


def host(ns, host_id, buckets=(4, 8), batch_size=2, max_retries=1,
         on_swap=None, telemetry=False):
    engine = FakeEngine(ns, buckets, batch_size)
    worker = ns.serving.ReplicaWorker(0, engine, max_wait_ms=5.0)
    router = ns.serving.Router(
        [worker], admission=ns.AdmissionController(max_len=max(buckets)),
        max_retries=max_retries)
    tele = ns.serving.RouterTelemetry(router, router.admission) \
        if telemetry else None
    return ns.serving.HostServer(router, host_id=host_id, on_swap=on_swap,
                                 telemetry=tele), engine


def request(rng, length):
    return (rng.randint(0, 8, size=length),
            rng.normal(size=(length, 3)).astype(np.float32))


def fleet_of(ns, n=3, injector=None, max_retries=2, **kw):
    servers, engines, transports = [], [], {}
    cls = killable(ns)
    for i in range(n):
        s, e = host(ns, i)
        servers.append(s)
        engines.append(e)
        transports[i] = cls(s, fault_injector=injector)
    kw.setdefault('health', ns.serving.HealthConfig(
        quarantine_after=3, recover_after=2,
        probe_backoff_s=0.02, probe_backoff_max_s=0.2))
    kw.setdefault('heartbeat_every_s', 0.01)
    fleet = ns.serving.FleetRouter(transports, max_retries=max_retries,
                                   default_timeout_s=10.0, **kw)
    # scrape until the hosts reported their buckets (routing signals up)
    t0 = time.monotonic()
    while fleet.buckets is None and time.monotonic() - t0 < 5:
        fleet.pump()
        time.sleep(0.005)
    fleet.drain()
    assert fleet.buckets == (4, 8)
    return fleet, servers, engines, transports


def shutdown(fleet, servers):
    fleet.close()
    for s in servers:
        s.stop()


def ckpt(tmp_path):
    from se3_transformer_torch.training.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, dict(params=dict(w=torch.ones(3))))
    mgr.save(2, dict(params=dict(w=torch.full((3,), 2.0))))
    mgr.close()
    return (dict(directory=str(tmp_path), step=2),
            dict(directory=str(tmp_path), step=1))


# --------------------------------------------------------------------- #
# the transport contract over HostServer
# --------------------------------------------------------------------- #
def test_local_and_socket_transport_round_trip(ns):
    """ping, stats and infer behave the same over the in-process and the
    socket arm; a host's stats name its device and its own kernel
    counts."""
    server, _ = host(ns, 7)
    sock = ns.serving.serve_socket(server, port=0)
    rng = np.random.RandomState(0)
    try:
        for transport in (ns.serving.LocalTransport(server),
                          ns.serving.SocketTransport('127.0.0.1',
                                                     sock.port)):
            res = transport.call('ping', timeout_s=5.0)
            assert res['ok'] and res['host'] == 7
            tokens, coords = request(rng, 3)
            res = transport.call('infer', dict(tokens=tokens.tolist(),
                                               coords=coords.tolist(),
                                               timeout_s=5.0),
                                 timeout_s=10.0)
            assert res['ok'] and len(res['result']) == 3
            stats = transport.call('stats', timeout_s=5.0)['stats']
            assert stats['host'] == 7 and stats['buckets'] == [4, 8]
            assert 'p99_ms_by_bucket' in stats
            if ns.name == 'torch':
                assert stats['device'] == 'cpu'
                assert set(stats['launches']) >= {'bxf', 'fwd', 'A', 'B'}
                assert set(stats['routed']) >= {'bxf', 'fwd'}
            res = transport.call('nope', timeout_s=5.0)
            assert not res['ok']
            assert res['error']['code'] == 'unknown_method'
    finally:
        sock.close()
        server.stop()


def test_transport_fault_injection_latency_exception_drop(ns):
    """The seeded `transport` site: latency sleeps in place, exception and
    the partition-style drop both surface as TransportError, and a drop
    never reaches the host."""
    server, _ = host(ns, 0)
    inj = ns.FaultInjector(seed=0)
    # one action per fire: each plan's at= counts its own consultations
    inj.plan('transport', 'latency', at=(1,), latency_s=0.01)
    inj.plan('transport', 'exception', at=(1,))
    inj.plan('transport', 'drop', at=(1,))
    t = ns.serving.LocalTransport(server, fault_injector=inj)
    try:
        assert t.call('ping')['ok']                    # latency: served
        with pytest.raises(ns.serving.TransportError):
            t.call('ping')                             # injected reset
        pings_before = server.calls['ping']
        with pytest.raises(ns.serving.TransportError, match='partition'):
            t.call('ping')                             # dropped
        assert server.calls['ping'] == pings_before    # never sent
        assert [e['kind'] for e in inj.injected] == ['latency',
                                                     'exception', 'drop']
    finally:
        server.stop()


# --------------------------------------------------------------------- #
# HostServer: the RPC surface over a real Router
# --------------------------------------------------------------------- #
def test_host_server_structured_rejection_and_deadline(ns):
    server, _ = host(ns, 0)
    t = ns.serving.LocalTransport(server)
    rng = np.random.RandomState(0)
    try:
        tokens, coords = request(rng, 64)     # oversize for buckets 4/8
        res = t.call('infer', dict(tokens=tokens.tolist(),
                                   coords=coords.tolist()))
        assert not res['ok'] and res['error']['code'] == 'oversize'
        tokens, coords = request(rng, 3)
        res = t.call('infer', dict(tokens=tokens.tolist(),
                                   coords=coords.tolist(), timeout_s=0.0))
        assert not res['ok'] and res['error']['code'] == 'deadline'
        # structured terminal failures carry the retry hint
        assert res['error']['detail']['retry_after_s'] >= 0.0
    finally:
        server.stop()


def test_stats_answers_off_a_busy_serve_loop():
    """`stats`, like `ping`, answers while the serve loop is inside a long
    synchronous forward, from the snapshot the loop last published; a
    scrape after an answer sees that answer counted."""
    server, engine = host(TORCH, 0)
    entered, release = threading.Event(), threading.Event()
    run = engine.run

    def slow_run(*args):
        entered.set()
        release.wait(10.0)
        return run(*args)
    engine.run = slow_run
    t = TORCH.serving.LocalTransport(server)
    tokens, coords = request(np.random.RandomState(0), 3)
    answer = {}
    infer = threading.Thread(target=lambda: answer.update(t.call(
        'infer', dict(tokens=tokens, coords=coords, timeout_s=10.0),
        timeout_s=20.0)))
    try:
        before = t.call('stats')['stats']['served']
        infer.start()
        assert entered.wait(10.0)
        t0 = time.monotonic()
        res = t.call('stats', timeout_s=1.0)
        assert time.monotonic() - t0 < 0.5
        assert res['ok'] and res['stats']['served'] == before
        release.set()
        infer.join(20.0)
        assert answer['ok'] and len(answer['result']) == 3
        stats = t.call('stats')['stats']
        assert stats['served'] == before + 1
        assert 0 < stats['snapshots'] < server.snapshots
    finally:
        release.set()
        server.stop()


def test_host_server_swap_from_checkpoint_and_on_swap_hook(tmp_path):
    seen = []
    server, engine = host(TORCH, 0, on_swap=lambda payload, events:
                          seen.append((payload.get('step'), events)))
    new_ref, old_ref = ckpt(tmp_path)
    t = TORCH.serving.LocalTransport(server)
    try:
        res = t.call('swap', new_ref)
        assert res['ok'] and res['tag'].endswith('@2')
        assert torch.equal(engine.params['w'], torch.full((3,), 2.0))
        assert seen and seen[0][0] == 2
        res = t.call('swap', old_ref)
        assert res['tag'].endswith('@1')
        assert torch.equal(engine.params['w'], torch.ones(3))
    finally:
        server.stop()


def test_request_ids_disjoint_across_two_hosts(ns):
    """Each router starts its ids at 0; a HostServer prefixes them with
    its host, so that merged streams never collide."""
    servers, ids = [], {}
    try:
        for hid in (0, 1):
            server, _ = host(ns, hid)
            servers.append(server)
            rng = np.random.RandomState(hid)
            ids[hid] = {server.router.submit(*request(rng, 4)).request_id
                        for _ in range(5)}
        assert not ids[0] & ids[1]
        assert all(i.startswith('h0-') for i in ids[0])
        assert all(i.startswith('h1-') for i in ids[1])
    finally:
        for s in servers:
            s.stop()


# --------------------------------------------------------------------- #
# FleetRouter: placement, breaker walk, redispatch, zero lost
# --------------------------------------------------------------------- #
def test_fleet_routes_and_answers_across_hosts(ns):
    fleet, servers, engines, _ = fleet_of(ns)
    rng = np.random.RandomState(0)
    pending = [fleet.submit(*request(rng, int(rng.randint(1, 9))))
               for _ in range(12)]
    fleet.drain()
    assert all(p.ok for p in pending)
    assert all(len(p.result) == p.length for p in pending)
    assert sum(sum(e.rows_served.values()) for e in engines) >= 12
    shutdown(fleet, servers)


def test_capability_aware_placement_on_heterogeneous_fleet(ns):
    """A length-12 request in a (4, 8) + (4, 8, 16) fleet lands only on
    the host whose scraped buckets serve it; a request no host serves
    resolves as a structured reject naming the capable hosts per axis."""
    s0, e0 = host(ns, 0)
    s1, e1 = host(ns, 1, buckets=(4, 8, 16))
    transports = {0: ns.serving.LocalTransport(s0),
                  1: ns.serving.LocalTransport(s1)}
    fleet = ns.serving.FleetRouter(
        transports, max_retries=2, default_timeout_s=10.0,
        health=ns.serving.HealthConfig(quarantine_after=3, recover_after=2,
                                       probe_backoff_s=0.02,
                                       probe_backoff_max_s=0.2),
        heartbeat_every_s=0.01)
    try:
        t0 = time.monotonic()
        while (any(not h.stats for h in fleet.hosts.values())
               and time.monotonic() - t0 < 5):
            fleet.pump()
            time.sleep(0.005)
        assert fleet.buckets == (4, 8, 16)     # the union at the door
        rng = np.random.RandomState(0)
        pending = [fleet.submit(*request(rng, 12)) for _ in range(6)]
        fleet.drain()
        assert all(p.ok for p in pending)
        assert sum(e1.rows_served.values()) >= 6
        assert sum(e0.rows_served.values()) == 0
        p = fleet.submit(*request(rng, 3), model_family='se3_v9')
        fleet.drain()
        assert p.done and not p.ok
        assert isinstance(p.error, ns.RequestRejected)
        assert p.error.code == 'no_capable_host'
        assert sorted(p.error.detail['capable_by_length']) == [0, 1]
        assert p.error.detail['capable_by_family'] == []
        assert set(p.error.detail['host_capabilities']) == {'0', '1'}
    finally:
        shutdown(fleet, [s0, s1])


def test_local_transport_passes_numpy_through_bit_exact(ns):
    server, engine = host(ns, 0)
    t = ns.serving.LocalTransport(server)
    rng = np.random.RandomState(3)
    try:
        tokens, coords = request(rng, 7)
        res = t.call('infer', dict(tokens=tokens, coords=coords,
                                   timeout_s=5.0), timeout_s=10.0)
        assert res['ok']
        out = res['result']
        assert isinstance(out, np.ndarray) and out.dtype == np.float32
        expected = engine.run(8, tokens[None], coords[None],
                              np.ones((1, len(tokens)), bool))[0][:7]
        assert np.array_equal(out, expected)
    finally:
        server.stop()


def test_dead_host_quarantines_redispatch_answers_probe_recovers(ns):
    """The SIGKILL arc in miniature: every request still answers through
    cross-host redispatch, the dead host's breaker walks to quarantined
    (one dispatch failure degrades it; failed heartbeats finish the walk),
    and once it is back a half-open ping probe closes it."""
    fleet, servers, _, transports = fleet_of(ns, heartbeat_every_s=60.0)
    rng = np.random.RandomState(0)
    transports[0].dead = True
    pending = []
    for _ in range(6):
        pending.append(fleet.submit(*request(rng, 4)))
        time.sleep(0.02)                    # paced: each retry settles
    fleet.drain()
    assert all(p.ok for p in pending)
    assert fleet.cross_host_retries >= 1
    assert fleet.health.state(0) == 'degraded'
    fleet.heartbeat_every_s = 0.0
    for _ in range(4):
        fleet.pump()
        fleet.drain()
    assert fleet.health.state(0) == 'quarantined'
    transports[0].dead = False              # "restart"
    t0 = time.monotonic()
    while fleet.health.recoveries == 0 and time.monotonic() - t0 < 5:
        fleet.pump()
        time.sleep(0.01)
    fleet.drain()
    assert fleet.health.recoveries >= 1
    assert fleet.health.state(0) in ('degraded', 'healthy')
    transitions = fleet.record_body(pending)['host_transitions']
    assert any(e['host'] == 0 and e['from_state'] == 'quarantined'
               for e in transitions)
    shutdown(fleet, servers)


def test_all_hosts_dead_resolves_structured_with_retry_hint(ns):
    fleet, servers, _, transports = fleet_of(ns, max_retries=1)
    for t in transports.values():
        t.dead = True
    p = fleet.submit(*request(np.random.RandomState(0), 4))
    fleet.drain()
    assert p.done and not p.ok
    assert isinstance(p.error, ns.RequestFailed)
    assert p.error.code == 'retries_exhausted'
    assert p.error.detail['retry_after_s'] >= 0.0
    assert p.attempts == 2          # the first try and one retry
    for t in transports.values():
        t.dead = False
    shutdown(fleet, servers)


def test_weaken_hook_nulls_exclusion_and_gate_would_fire(ns):
    """`host_exclusion = False`: the dead lowest-id host keeps winning
    load ties, paced requests spend their budgets on it, and nothing is
    lost (only placement is broken)."""
    fleet, servers, _, transports = fleet_of(ns, heartbeat_every_s=60.0)
    fleet.host_exclusion = False
    transports[0].dead = True
    rng = np.random.RandomState(0)
    pending = []
    for _ in range(5):
        pending.append(fleet.submit(*request(rng, 4)))
        time.sleep(0.02)
    fleet.drain()
    assert all(p.done for p in pending)
    assert sum(1 for p in pending if not p.ok) == 5
    transports[0].dead = False
    shutdown(fleet, servers)


def test_deadline_propagates_and_expires_structured(ns):
    fleet, servers, _, _ = fleet_of(ns)
    p = fleet.submit(*request(np.random.RandomState(0), 4), timeout_s=0.0)
    fleet.drain()
    assert p.done and not p.ok
    assert isinstance(p.error, (ns.RequestFailed, ns.RequestRejected))
    assert p.error.code == 'deadline'
    shutdown(fleet, servers)


def test_deadline_travels_as_remaining_budget_in_the_payload():
    """The infer payload carries the request's remaining budget, and the
    RPC's own timeout is that budget plus slack (JAX's _call_infer)."""
    fleet, servers, _, transports = fleet_of(TORCH)
    seen = []
    orig = transports[1].call

    def spy(method, payload=None, timeout_s=None):
        if method == 'infer':
            seen.append((payload.get('timeout_s'), timeout_s))
        return orig(method, payload, timeout_s=timeout_s)
    for t in transports.values():
        t.call = spy
    p = fleet.submit(*request(np.random.RandomState(0), 4), timeout_s=7.0)
    fleet.drain()
    assert p.ok and len(seen) == 1
    budget, rpc = seen[0]
    assert 6.0 < budget <= 7.0 and rpc == pytest.approx(budget + 5.0,
                                                        abs=1e-3)
    shutdown(fleet, servers)


# --------------------------------------------------------------------- #
# canaried rollout: roll on a clean gate, roll back on a dirty one
# --------------------------------------------------------------------- #
def test_rollout_clean_canary_rolls_every_host(tmp_path):
    fleet, servers, engines, _ = fleet_of(TORCH)
    new_ref, old_ref = ckpt(tmp_path)
    rng = np.random.RandomState(0)
    traffic = [request(rng, 4) for _ in range(4)]
    event, probes = fleet.rollout(new_ref, old_ref, traffic, canary=0)
    assert event['passed'] and not event['rolled_back']
    assert event['canary_tag'].endswith('@2')
    assert {r['host'] for r in event['rolled']} == {1, 2}
    assert all(r['tag'].endswith('@2') for r in event['rolled'])
    assert all(p.ok for p in probes)
    assert all(torch.equal(e.params['w'], torch.full((3,), 2.0))
               for e in engines)
    assert fleet.rollouts == 1 and fleet.rollbacks == 0
    body = fleet.record_body(probes)
    assert [s['host'] for s in body['host_swaps']] == [0, 1, 2]
    for validate in (tschema.validate_record, jschema.validate_record):
        validate(dict(body, kind='fleet', run_id='t'))
    shutdown(fleet, servers)


def test_rollout_poisoned_canary_auto_rolls_back(tmp_path):
    """The canary's new weights are bad (every dispatch after the swap
    fails): the gate fails on its probe traffic and the scraped failure
    delta, the canary swaps back, and the siblings never swap."""
    fleet, servers, engines, _ = fleet_of(TORCH)
    new_ref, old_ref = ckpt(tmp_path)

    class Poisoned(FakeEngine):
        @FakeEngine.params.setter
        def params(self, value):
            self._params = value
            self.fail = bool(torch.equal(value['w'],
                                         torch.full((3,), 2.0)))
    engines[0].__class__ = Poisoned
    rng = np.random.RandomState(0)
    traffic = [request(rng, 4) for _ in range(4)]
    event, probes = fleet.rollout(new_ref, old_ref, traffic, canary=0)
    assert not event['passed'] and event['rolled_back']
    assert event['canary_tag'].endswith('@2')
    assert event['rollback']['tag'].endswith('@1')
    assert event['rolled'] == []
    assert event['gate']['answered'] == 0
    assert event['gate']['host_request_failures_delta'] >= 1
    assert all(p.done and not p.ok for p in probes)
    assert all(isinstance(p.error, TORCH.RequestFailed) for p in probes)
    assert engines[1].params == 'v0' and engines[2].params == 'v0'
    assert torch.equal(engines[0].params['w'], torch.ones(3))
    assert fleet.rollbacks == 1 and fleet.rollouts == 0
    rec = dict(fleet.record_body(probes), kind='fleet', run_id='t')
    for validate in (tschema.validate_record, jschema.validate_record):
        validate(rec)
    assert rec['rollbacks'] == 1 and rec['lost_requests'] == 0
    assert rec['rollouts']['events'][0]['rolled_back']
    shutdown(fleet, servers)


# --------------------------------------------------------------------- #
# the `fleet` record: its load-bearing fields cannot be dropped
# --------------------------------------------------------------------- #
@pytest.mark.parametrize('schema', [tschema, jschema],
                         ids=['torch_schema', 'jax_schema'])
def test_fleet_record_schema_load_bearing_fields(schema):
    fleet, servers, _, _ = fleet_of(TORCH)
    base = dict(fleet.record_body([]), kind='fleet', run_id='t')
    shutdown(fleet, servers)
    schema.validate_record(base)
    for field in ('lost_requests', 'hosts', 'host_transitions',
                  'rollouts', 'rollbacks', 'recoveries',
                  'cross_host_retries'):
        broken = dict(base)
        del broken[field]
        with pytest.raises(schema.SchemaError):
            schema.validate_record(broken)
    with pytest.raises(schema.SchemaError, match='state'):
        schema.validate_record(dict(base, hosts={'0': dict(depth=0)}))
    with pytest.raises(schema.SchemaError, match='non-negative'):
        schema.validate_record(dict(base, lost_requests=-1))
    with pytest.raises(schema.SchemaError, match='from_state'):
        schema.validate_record(dict(base, host_transitions=[dict(host=0)]))
    with pytest.raises(schema.SchemaError, match='canary'):
        schema.validate_record(dict(
            base, rollouts=dict(count=1, events=[dict(t=0)])))
    with pytest.raises(schema.SchemaError, match='transport'):
        schema.validate_record(dict(base, transport=dict(reconnects=-1)))


# --------------------------------------------------------------------- #
# the entry point: a --host process drained by a real SIGTERM
# --------------------------------------------------------------------- #
def test_parse_args_takes_the_fleet_flags():
    args = tserve.parse_args(['--host', '--port', '0', '--host-id', '2',
                              '--transport', 'legacy', '--poison-step',
                              '3', '--cpu'])
    assert args.host_mode and args.host_id == 2 and args.port == 0
    assert args.transport == 'legacy' and args.poison_step == 3
    assert tserve.parse_args(['--fleet', '3']).fleet == 3
    with pytest.raises(SystemExit):
        tserve.parse_args(['--host', '--fleet', '2'])
    cmd = tserve.host_command(1, port=7, poison_step=2, cpu=True,
                              model='flagship_fast', depth=4)
    parsed = tserve.parse_args(cmd[cmd.index('--host'):])
    assert parsed.host_mode and parsed.port == 7 and parsed.cpu
    assert parsed.poison_step == 2 and parsed.model == 'flagship_fast'
    assert parsed.depth == 4


def test_host_sigterm_drains_and_banks_telemetry(tmp_path):
    """A `--host` process serving the toy model on the CPU: READY names
    its port and device, it answers over the binary wire with its own
    kernel counts in `stats`, and a real SIGTERM drains, writes a
    schema-valid stream (serve, fault, summary) and exits 0."""
    from se3_transformer_torch.serving import BinaryTransport
    metrics = str(tmp_path / 'host.jsonl')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.Popen(
        tserve.host_command(3, buckets='8,16', cpu=True, metrics=metrics),
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, bufsize=1)
    t = None
    try:
        port, device, sink = tserve.wait_host_ready(proc, timeout_s=120)
        assert device == 'cpu'
        t = BinaryTransport('127.0.0.1', port)
        rng = np.random.RandomState(0)
        tokens, coords = rng.randint(0, 24, size=10), \
            rng.normal(size=(10, 3)).astype(np.float32)
        res = t.call('infer', dict(tokens=tokens, coords=coords,
                                   timeout_s=30.0), timeout_s=60.0)
        assert res['ok'] and res['result'].shape == (10, 3)
        stats = t.call('stats', timeout_s=10.0)['stats']
        assert stats['host'] == 3 and stats['device'] == 'cpu'
        assert stats['served'] >= 1 and stats['routed']['bxf'] == 0
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if t is not None:
            t.close()
        if proc.poll() is None:
            proc.kill()
    tail = ''.join(sink)
    assert rc == 0, tail[-3000:]
    assert 'graceful shutdown' in tail
    for validate in (tschema.validate_stream, jschema.validate_stream):
        kinds = validate(metrics)['kinds']
        assert kinds['serve'] >= 1 and kinds['fault'] == 1
        assert kinds['summary'] == 1
