"""The port's transports (se3_transformer_torch.serving.transport) against
the JAX package's (se3_transformer_tpu.serving.transport) on the CPU: the
frame codec (raw numpy segments; a frame the port packs is the frame JAX
packs, and each unpacks the other's bit for bit), the pooled multiplexed
client against the frame-pump server, correlation ids under concurrent
callers, a server death mid-call and the reconnect, the seeded fault site
on every arm, numpy through all three transports bit for bit, and the
schema'd `transport` record under both packages' validators."""
import copy
import struct
import threading
import time

import numpy as np
import pytest
import torch

from se3_transformer_torch.faults import FaultInjector
from se3_transformer_torch.observability import schema as tschema
from se3_transformer_torch.serving.transport import (
    BinaryServer, BinaryTransport, FrameError, LocalTransport,
    SocketServer, SocketTransport, TransportError, pack_frame, unpack_frame,
)
from se3_transformer_tpu.observability import schema as jschema
from se3_transformer_tpu.serving import transport as jtransport

torch.set_num_threads(1)


def _join_frame(bufs):
    """Frame buffers -> (envelope bytes, body) as the wire delivers them
    (header stripped)."""
    raw = b''.join(bytes(memoryview(b)) for b in bufs)
    magic, env_len, body_len = struct.unpack_from('>4sII', raw)
    assert magic == b'SE3B'
    env = raw[12:12 + env_len]
    body = memoryview(raw)[12 + env_len:12 + env_len + body_len]
    return env, body


def _handler(method, payload=None, timeout_s=None, log=None):
    if log is not None:
        log.append(method)
    payload = payload or {}
    if method == 'ping':
        return dict(ok=True, t=time.monotonic())
    if method == 'echo':
        return dict(ok=True, echoed=payload)
    if method == 'double':
        if payload.get('delay'):
            time.sleep(payload['delay'])
        return dict(ok=True, tag=payload['tag'],
                    result=np.asarray(payload['x']) * 2)
    if method == 'sleepy':
        time.sleep(payload['s'])
        return dict(ok=True)
    raise RuntimeError(f'unhandled {method!r}')


def _message():
    return dict(
        id=7, method='infer',
        payload=dict(tokens=np.arange(12, dtype=np.int32),
                     coords=np.random.RandomState(0).normal(
                         size=(12, 3)).astype(np.float32),
                     mask=np.array([[True, False], [True, True]]),
                     wide=np.arange(4, dtype=np.int64),
                     timeout_s=2.5, trace=dict(origin='t', hops=[1, 2])))


# --------------------------------------------------------------------- #
# the codec
# --------------------------------------------------------------------- #
def test_frame_codec_round_trip_preserves_dtypes_and_nesting():
    msg = _message()
    env, body = _join_frame(pack_frame(msg))
    out = unpack_frame(env, body)
    assert out['id'] == 7 and out['method'] == 'infer'
    p, q = msg['payload'], out['payload']
    for key in ('tokens', 'coords', 'mask', 'wide'):
        assert q[key].dtype == p[key].dtype, key
        assert np.array_equal(q[key], p[key]), key
    assert q['timeout_s'] == 2.5
    assert q['trace'] == dict(origin='t', hops=[1, 2])
    # arrays ride as raw segments, not JSON text
    assert b'tokens' in env and b'[0, 1' not in env


@pytest.mark.parametrize('packer,unpacker', [('torch', 'jax'),
                                             ('jax', 'torch')])
def test_frame_codec_is_jax_wire_compatible(packer, unpacker):
    """The port's frame is JAX's byte for byte, and each side unpacks the
    other's arrays bit for bit: a port host speaks to a JAX front end."""
    pack = dict(torch=pack_frame, jax=jtransport.pack_frame)
    unpack = dict(torch=unpack_frame, jax=jtransport.unpack_frame)
    mine = b''.join(bytes(memoryview(b)) for b in pack_frame(_message()))
    theirs = b''.join(bytes(memoryview(b))
                      for b in jtransport.pack_frame(_message()))
    assert mine == theirs
    env, body = _join_frame(pack[packer](_message()))
    out = unpack[unpacker](env, body)['payload']
    for key, want in _message()['payload'].items():
        if isinstance(want, np.ndarray):
            assert out[key].dtype == want.dtype
            assert out[key].tobytes() == want.tobytes(), key


def test_frame_codec_rejects_corruption():
    with pytest.raises(FrameError):
        unpack_frame(b'not json at all', memoryview(b''))
    # manifest/body length mismatch: a truncated array segment can never
    # be zero-filled quietly
    env, body = _join_frame(pack_frame(dict(
        id=1, method='m', payload=dict(x=np.arange(8, dtype=np.int64)))))
    with pytest.raises(FrameError):
        unpack_frame(env, body[:-8])


# --------------------------------------------------------------------- #
# client <-> server
# --------------------------------------------------------------------- #
def test_binary_round_trip_arrays_bit_exact():
    srv = BinaryServer(_handler, port=0)
    t = BinaryTransport('127.0.0.1', srv.port, label='t0')
    try:
        x = np.random.RandomState(1).normal(size=(9, 3)).astype(np.float32)
        res = t.call('echo', dict(x=x, n=3), timeout_s=5.0)
        assert res['ok']
        assert res['echoed']['x'].dtype == np.float32
        assert np.array_equal(res['echoed']['x'], x)
        assert res['echoed']['n'] == 3
        assert t.call('ping', timeout_s=5.0)['ok']
        cstats, sstats = t.transport_stats(), srv.transport_stats()
        assert cstats['bytes_sent'] > 0 and cstats['bytes_received'] > 0
        assert sstats['bytes_received'] == cstats['bytes_sent']
        assert cstats['frame_errors'] == 0 and sstats['frame_errors'] == 0
    finally:
        t.close()
        srv.close()


@pytest.mark.parametrize('arm', ['local', 'legacy', 'binary'])
def test_numpy_round_trips_bit_exact_over_every_transport(arm):
    """float32 coordinates and int64 ids come back with the same bits over
    each arm (the legacy wire lists them: float32 -> JSON -> float32 is
    exact for float32 values)."""
    rng = np.random.RandomState(5)
    x = rng.normal(size=(11, 3)).astype(np.float32)
    ids = rng.randint(0, 1 << 40, size=6).astype(np.int64)
    srv = None
    if arm == 'local':
        t = LocalTransport(type('S', (), dict(
            host_id=0, handle=staticmethod(_handler)))())
    elif arm == 'legacy':
        srv = SocketServer(_handler, port=0)
        t = SocketTransport('127.0.0.1', srv.port, timeout_s=5.0)
    else:
        srv = BinaryServer(_handler, port=0)
        t = BinaryTransport('127.0.0.1', srv.port)
    try:
        res = t.call('echo', dict(x=x, ids=ids), timeout_s=5.0)
        got_x = np.asarray(res['echoed']['x'], np.float32)
        got_ids = np.asarray(res['echoed']['ids'], np.int64)
        assert got_x.tobytes() == x.tobytes()
        assert got_ids.tobytes() == ids.tobytes()
    finally:
        if hasattr(t, 'close'):
            t.close()
        if srv is not None:
            srv.close()


def test_handler_crash_is_structured_not_a_torn_wire():
    srv = BinaryServer(_handler, port=0)
    t = BinaryTransport('127.0.0.1', srv.port, label='t0')
    try:
        res = t.call('nope', timeout_s=5.0)
        assert not res['ok'] and res['error']['code'] == 'internal'
        # the connection survived the crash: the next call reuses it
        assert t.call('ping', timeout_s=5.0)['ok']
        assert t.transport_stats()['reconnects'] == 0
    finally:
        t.close()
        srv.close()


def test_multiplex_hammer_responses_match_requests():
    """8 client threads x 4 calls over a 2-connection pool, with staggered
    server-side delays so that responses complete out of request order on
    every connection: each response still carries its own request's tag
    and payload."""
    srv = BinaryServer(_handler, port=0, pumps=4)
    t = BinaryTransport('127.0.0.1', srv.port, label='mux', pool_size=2)
    failures = []

    def client(tid):
        for k in range(4):
            i = tid * 4 + k
            x = np.full(16 + i, i, dtype=np.int32)
            try:
                res = t.call('double',
                             dict(tag=i, x=x, delay=(i % 5) * 0.004),
                             timeout_s=10.0)
                if not res['ok'] or res['tag'] != i \
                        or not np.array_equal(res['result'], x * 2):
                    failures.append(f'req {i} got {res.get("tag")}')
            except Exception as e:  # noqa: BLE001
                failures.append(f'req {i}: {e}')

    try:
        threads = [threading.Thread(target=client, args=(n,))
                   for n in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30.0)
        assert not any(th.is_alive() for th in threads)
        assert not failures, failures[:5]
        stats = t.transport_stats()
        assert stats['connections_opened'] == 2     # the pool persisted
        assert stats['reconnects'] == 0
        assert stats['peak_in_flight'] >= 2         # really multiplexed
        assert stats['frame_errors'] == 0
    finally:
        t.close()
        srv.close()


def test_midstream_server_death_fails_inflight_then_reconnects():
    srv = BinaryServer(_handler, port=0)
    port = srv.port
    t = BinaryTransport('127.0.0.1', port, label='t0', pool_size=1)
    try:
        assert t.call('ping', timeout_s=5.0)['ok']
        errs = []

        def inflight():
            try:
                t.call('sleepy', dict(s=30.0), timeout_s=30.0)
            except TransportError as e:
                errs.append(e)

        th = threading.Thread(target=inflight)
        th.start()
        time.sleep(0.2)              # the call is on the wire
        srv.close()                  # the SIGKILL stand-in: sockets torn
        th.join(timeout=10.0)
        assert not th.is_alive()
        assert len(errs) == 1        # the call in flight failed, fast
        # the host restarts on the same port; the same transport object
        # recovers with no reset from outside
        srv = BinaryServer(_handler, port=port)
        assert t.call('ping', timeout_s=5.0)['ok']
        stats = t.transport_stats()
        assert stats['reconnects'] >= 1
        assert stats['connections_opened'] >= 2
    finally:
        t.close()
        srv.close()


def test_socket_transport_refused_connection_is_transport_error():
    srv = SocketServer(_handler, port=0)
    port = srv.port
    srv.close()
    with pytest.raises(TransportError):
        SocketTransport('127.0.0.1', port, timeout_s=1.0).call('ping')


# --------------------------------------------------------------------- #
# the seeded fault site on the framing
# --------------------------------------------------------------------- #
def test_fault_injector_fires_on_binary_framing():
    log = []
    srv = BinaryServer(
        lambda m, p=None, timeout_s=None: _handler(m, p, log=log), port=0)
    inj = FaultInjector(seed=0)
    inj.plan('transport', 'latency', every=1, latency_s=0.05,
             match=dict(method='ping'))
    inj.plan('transport', 'exception', every=1, match=dict(method='echo'))
    inj.plan('transport', 'drop', every=1, match=dict(method='double'))
    t = BinaryTransport('127.0.0.1', srv.port, label='t0',
                        fault_injector=inj)
    try:
        t0 = time.perf_counter()
        assert t.call('ping', timeout_s=5.0)['ok']
        assert time.perf_counter() - t0 >= 0.05    # the latency slept
        with pytest.raises(TransportError):
            t.call('echo', dict(x=1), timeout_s=5.0)
        before = list(log)
        with pytest.raises(TransportError, match='dropped'):
            t.call('double', dict(tag=0, x=np.ones(3)), timeout_s=5.0)
        time.sleep(0.05)
        assert log == before      # the drop was never sent
        assert len(inj.injected) == 3
    finally:
        t.close()
        srv.close()


def test_transport_site_at_plan_fires_once_under_concurrent_callers():
    """The fleet's transport threads fire the site at once: an at=(5,)
    plan fires on exactly one call of 16, whatever the interleaving."""
    inj = FaultInjector(seed=0)
    inj.plan('transport', 'drop', at=(5,))
    t = LocalTransport(type('S', (), dict(
        host_id=0, handle=staticmethod(_handler)))(), fault_injector=inj)
    drops = []

    def caller():
        for _ in range(4):
            try:
                t.call('ping')
            except TransportError:
                drops.append(1)

    threads = [threading.Thread(target=caller) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30.0)
    assert not any(th.is_alive() for th in threads)
    assert len(drops) == 1
    assert [e['call'] for e in inj.injected] == [5]


# --------------------------------------------------------------------- #
# the `transport` record kind
# --------------------------------------------------------------------- #
def _transport_record():
    from se3_transformer_torch.serving.loadgen import (
        build_host, run_arm, workload,
    )
    from se3_transformer_torch.serving.transport import serve_binary
    requests = workload(12, 32, 0)
    host = build_host(32)
    srv = serve_binary(host, port=0)
    t = BinaryTransport('127.0.0.1', srv.port, pool_size=2)
    try:
        arm = run_arm('binary', t, requests, 4)
    finally:
        t.close()
        srv.close()
        host.stop()
    assert arm['errors'] == 0 and arm['requests'] == 12
    stats = arm.pop('transport')
    return dict(
        kind='transport', run_id='t', label='loadgen,test',
        workload=dict(requests=12, concurrency=4, length=32, seed=0),
        arms=dict(legacy=dict(arm, qps=arm['qps'] / 2), binary=arm),
        transport=stats, qps_binary_vs_legacy=2.0,
        p99_binary_vs_legacy=0.5, wire_bytes_binary_vs_legacy=0.3)


def test_transport_record_schema_valid_and_guarded_under_both_schemas():
    rec = _transport_record()
    for validate in (tschema.validate_record, jschema.validate_record):
        validate(rec)
    for mutate in (
            lambda r: r.pop('qps_binary_vs_legacy'),
            lambda r: r['arms'].pop('binary'),
            lambda r: r['arms']['legacy'].pop('p99_ms'),
            lambda r: r['transport'].pop('frame_errors'),
            lambda r: r['transport'].update(reconnects=-1),
            lambda r: r['workload'].update(requests=0),
    ):
        for validate, error in ((tschema.validate_record,
                                 tschema.SchemaError),
                                (jschema.validate_record,
                                 jschema.SchemaError)):
            broken = copy.deepcopy(rec)
            mutate(broken)
            with pytest.raises(error):
                validate(broken)
