"""The pluggable RPC transport of the cross-host serving tier: the port
of se3_transformer_tpu/serving/transport.py (pure Python and numpy, so
the port keeps its own copy).

The fleet front end (`serving.fleet.FleetRouter`) speaks to each host's
`Router` through one verb:

    response = transport.call(method, payload, timeout_s=...)

`payload` and `response` are dicts of JSON values and numpy arrays, and
every failure of the link itself (connection refused, reset mid-read,
timeout, injected partition) surfaces as `TransportError`: the fleet's
host-failure signal (the host breaker records it, the request is
redispatched onto a sibling host). Failures of the application (an
oversize reject, a deadline, a retry budget spent inside the host) ride
the response (`{'ok': False, 'error': {...}}`) and are not transport
errors: a host that answers "no" is alive.

Three implementations, one contract:

  * `LocalTransport`: in-process, it calls the wrapped `HostServer.handle`
    directly (the tests' and the single-process arm: the fleet logic is
    the same, only the wire is gone). Numpy arrays pass through unchanged.
  * `BinaryTransport` / `BinaryServer` / `serve_binary`: the production
    arm. Persistent pooled connections, correlation-id multiplexing (many
    calls in flight share one connection; a reader thread per connection
    hands each response to its waiting caller), and length-prefixed
    frames in which numpy arrays ride as raw, dtype- and shape-tagged
    segments:

        MAGIC(4B) | u32 env_len | u32 body_len |
        env JSON (id/method/payload minus arrays, plus the array
                  manifest [{path, dtype, shape}, ...]) |
        raw array bytes, in manifest order

    JSON carries only the small control envelope; the receiver rebuilds
    arrays as `np.frombuffer` views of the frame. A dead connection fails
    its calls in flight with `TransportError` and the next call
    reconnects, so a host restarted on the same port is transparent. The
    server has no thread per connection: one demux thread reads frames
    off every connection, `HostServer.handle_async` queues each call on
    the host's single serve-loop thread, and a small pool writes the
    responses back.
  * `SocketTransport` / `SocketServer` / `serve_socket`: the legacy arm
    (`--transport legacy`): newline-delimited JSON over TCP, one request
    per connection. Arrays become lists at this wire.

Results cross every wire as numpy arrays on the host (the engine's answer
after its copy off the card); no tensor on a card is pickled or sent.

Every arm fires the seeded `faults.FaultInjector` at the `transport` site
before sending (ctx: method, host): `latency` plans sleep (a slow link),
`exception` plans raise (a reset connection, re-raised as
`TransportError`), and the cooperative `drop` kind models a partition (the
call raises `TransportError` without sending anything).
"""
from __future__ import annotations

import json
import queue
import select
import selectors
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..faults import InjectedFault

__all__ = ['TransportError', 'LocalTransport', 'SocketTransport',
           'SocketServer', 'serve_socket',
           'BinaryTransport', 'BinaryServer', 'serve_binary',
           'pack_frame', 'unpack_frame']


class TransportError(RuntimeError):
    """The link to a host failed (refused / reset / timeout / injected
    partition). The fleet treats this as a HOST outcome — breaker
    failure + cross-host redispatch — never as a request verdict."""


def _fire_transport_faults(injector, method: str, host: str) -> None:
    """Shared injection hook: one site, three deterministic failure
    modes (latency sleeps in place; exception and drop both surface as
    TransportError so they walk the exact path a real link failure
    walks)."""
    if injector is None:
        return
    try:
        kind = injector.fire('transport', method=method, host=host)
    except InjectedFault as e:
        raise TransportError(str(e)) from e
    if kind == 'drop':
        raise TransportError(
            f'injected partition: {method!r} to host {host} dropped '
            f'(request never sent, no response will come)')


# --------------------------------------------------------------------- #
# binary framing: JSON control envelope + raw array segments
# --------------------------------------------------------------------- #
_MAGIC = b'SE3B'
_HEADER = struct.Struct('>4sII')      # magic, env_len, body_len
_MAX_FRAME = 1 << 30                  # sanity bound: 1 GiB per frame


class FrameError(ValueError):
    """The byte stream is not a valid frame (bad magic / oversize /
    undecodable envelope). A framing error is unrecoverable for its
    connection — there is no way to resync a corrupted length-prefixed
    stream — so both ends count it and drop the connection; callers
    see the usual `TransportError` and the next call reconnects."""


def _np_jsonable(obj):
    """`json.dumps(default=...)` hook for the LEGACY arm only: numpy
    arrays degrade to lists at the text wire (the binary framing ships
    them raw), so callers may hand numpy payloads to either arm."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f'{type(obj).__name__} is not JSON serializable')


def pack_frame(msg: dict) -> List[object]:
    """Encode one message as a list of send buffers (header + envelope
    + one raw segment per numpy array — the segments are memoryviews
    of the arrays themselves, no copy). Every `np.ndarray` at any dict
    path inside `msg` is lifted out of the JSON envelope and tagged in
    the `_arrays` manifest as (dotted path, dtype, shape)."""
    arrays: List[tuple] = []

    def strip(node, prefix):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                p = f'{prefix}.{k}' if prefix else str(k)
                if isinstance(v, np.ndarray):
                    arrays.append((p, np.ascontiguousarray(v)))
                elif isinstance(v, np.generic):
                    out[k] = v.item()
                else:
                    out[k] = strip(v, p)
            return out
        return node

    env = strip(msg, '')
    env['_arrays'] = [dict(path=p, dtype=a.dtype.str, shape=list(a.shape))
                      for p, a in arrays]
    env_bytes = json.dumps(env).encode()
    body_len = sum(a.nbytes for _, a in arrays)
    if len(env_bytes) + body_len > _MAX_FRAME:
        raise FrameError(
            f'frame too large: {len(env_bytes) + body_len}B '
            f'> {_MAX_FRAME}B')
    bufs: List[object] = [_HEADER.pack(_MAGIC, len(env_bytes), body_len),
                          env_bytes]
    bufs.extend(a.data for _, a in arrays)
    return bufs


def unpack_frame(env_bytes, body) -> dict:
    """Decode one frame back into its message dict. Array segments
    become `np.frombuffer` views of `body` (zero-copy — read-only when
    `body` is bytes) reinserted at their manifest paths."""
    try:
        env = json.loads(bytes(env_bytes).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise FrameError(f'undecodable envelope: {e}') from e
    if not isinstance(env, dict):
        raise FrameError(f'envelope is {type(env).__name__}, not a dict')
    manifest = env.pop('_arrays', [])
    mv = memoryview(body)
    off = 0
    for d in manifest:
        try:
            dt = np.dtype(d['dtype'])
            shape = tuple(int(s) for s in d['shape'])
            n = 1
            for s in shape:
                n *= s
            nbytes = n * dt.itemsize
            arr = np.frombuffer(mv[off:off + nbytes],
                                dtype=dt).reshape(shape)
        except (KeyError, TypeError, ValueError) as e:
            raise FrameError(f'bad array segment {d!r}: {e}') from e
        off += nbytes
        node = env
        keys = str(d['path']).split('.')
        for k in keys[:-1]:
            nxt = node.get(k)
            if not isinstance(nxt, dict):
                raise FrameError(f'manifest path {d["path"]!r} does '
                                 f'not exist in the envelope')
            node = nxt
        node[keys[-1]] = arr
    if off != mv.nbytes:
        raise FrameError(f'frame body is {mv.nbytes}B but the manifest '
                         f'accounts for {off}B')
    return env


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    """Blocking read of exactly `n` bytes (EOF mid-frame raises — the
    peer died, which the caller maps to a dead connection)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError(
                f'peer closed mid-frame ({got}/{n}B read)')
        got += k
    return buf


def _recv_frame(sock: socket.socket):
    """Blocking read of one whole frame -> (message dict, wire bytes)."""
    head = _read_exact(sock, _HEADER.size)
    magic, env_len, body_len = _HEADER.unpack(bytes(head))
    if magic != _MAGIC:
        raise FrameError(
            f'bad frame magic {magic!r} (protocol mismatch? a legacy '
            f'JSON peer cannot speak to a binary endpoint)')
    if env_len + body_len > _MAX_FRAME:
        raise FrameError(f'frame too large: {env_len + body_len}B')
    env_bytes = _read_exact(sock, env_len)
    body = _read_exact(sock, body_len) if body_len else b''
    return (unpack_frame(env_bytes, body),
            _HEADER.size + env_len + body_len)


class LocalTransport:
    """In-process transport: the arm of the contract without a wire.

        server = HostServer(router, host_id=0)
        t = LocalTransport(server, fault_injector=inj)
        t.call('ping')                     # -> {'ok': True, ...}
    """

    def __init__(self, server, fault_injector=None,
                 label: Optional[str] = None):
        self.server = server
        self.fault_injector = fault_injector
        self.label = label if label is not None else \
            f'local:{getattr(server, "host_id", "?")}'

    def call(self, method: str, payload: Optional[dict] = None,
             timeout_s: Optional[float] = None) -> dict:
        _fire_transport_faults(self.fault_injector, method, self.label)
        try:
            return self.server.handle(method, payload,
                                      timeout_s=timeout_s)
        except Exception as e:  # a crashed handler IS a dead host
            raise TransportError(
                f'{self.label}: {method!r} handler raised '
                f'{type(e).__name__}: {e}') from e

    def __repr__(self):
        return f'LocalTransport({self.label})'


class SocketTransport:
    """Newline-delimited JSON over TCP, one request per connection.

        t = SocketTransport('127.0.0.1', 9000)
        t.call('infer', dict(tokens=[...], coords=[...]), timeout_s=5)

    `timeout_s` bounds connect + send + the full response read — the
    deadline-propagation arm of the fleet contract (a hung host must
    cost one timeout, not a wedged front-end). Connecting per call
    makes a host RESTART transparent: the next call reaches whatever
    process now owns the port.
    """

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 30.0, fault_injector=None,
                 label: Optional[str] = None):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.fault_injector = fault_injector
        self.label = label if label is not None else f'{host}:{port}'
        # wire accounting so the loadgen A/B can price this arm's
        # bytes-on-wire against the binary framing's
        self._stats_lock = threading.Lock()
        self._stats = dict(connections_opened=0, reconnects=0,
                           in_flight=0, peak_in_flight=0,
                           bytes_sent=0, bytes_received=0,
                           frame_errors=0)

    def transport_stats(self) -> dict:
        """Snapshot of the wire counters (same shape as the binary
        arm's, so records and the loadgen treat both uniformly —
        `connections_opened` counts one per call here, that being the
        whole point of the A/B)."""
        with self._stats_lock:
            return dict(self._stats)

    def call(self, method: str, payload: Optional[dict] = None,
             timeout_s: Optional[float] = None) -> dict:
        _fire_transport_faults(self.fault_injector, method, self.label)
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        # one ABSOLUTE deadline for connect + send + the full response
        # read: a per-recv timeout would let a host that trickles one
        # chunk per interval hold a fleet pool thread indefinitely —
        # exactly the wedged front-end this bound exists to prevent
        deadline = time.monotonic() + max(0.001, timeout)

        def remaining() -> float:
            left = deadline - time.monotonic()
            if left <= 0:
                raise socket.timeout(
                    f'transport deadline ({timeout:.3f}s) exhausted')
            return left

        # arrays degrade to lists at this wire (the binary arm ships
        # them raw) — callers hand numpy payloads to either arm
        line = json.dumps(dict(method=method, payload=payload or {}),
                          default=_np_jsonable) + '\n'
        data = line.encode()
        with self._stats_lock:
            self._stats['connections_opened'] += 1
            self._stats['in_flight'] += 1
            self._stats['peak_in_flight'] = max(
                self._stats['peak_in_flight'], self._stats['in_flight'])
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=remaining()) as s:
                s.settimeout(remaining())
                s.sendall(data)
                s.shutdown(socket.SHUT_WR)
                chunks = []
                while True:
                    s.settimeout(remaining())
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    chunks.append(chunk)
        except OSError as e:
            raise TransportError(
                f'{self.label}: {method!r} failed on the wire: '
                f'{type(e).__name__}: {e}') from e
        finally:
            with self._stats_lock:
                self._stats['in_flight'] -= 1
        raw = b''.join(chunks)
        with self._stats_lock:
            self._stats['bytes_sent'] += len(data)
            self._stats['bytes_received'] += len(raw)
        if not raw.strip():
            raise TransportError(
                f'{self.label}: {method!r} got an empty response '
                f'(host died mid-call?)')
        try:
            return json.loads(raw.decode())
        except ValueError as e:
            raise TransportError(
                f'{self.label}: {method!r} returned undecodable bytes '
                f'({len(raw)}B): {e}') from e

    def __repr__(self):
        return f'SocketTransport({self.label})'


class SocketServer:
    """Accept loop exposing a `HostServer` on a TCP port (daemon
    threads: one acceptor, one per in-flight connection — connections
    are one-shot, so the per-connection thread count tracks the fleet's
    in-flight RPC count, which the front-end already bounds)."""

    def __init__(self, handler: Callable, port: int = 0,
                 host: str = '127.0.0.1'):
        self.handler = handler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name=f'rpc-accept:{self.port}',
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self):
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return    # close() won the startup race — nothing to serve
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn: socket.socket):
        with conn:
            try:
                conn.settimeout(60.0)
                buf = b''
                while not buf.endswith(b'\n'):
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
                req = json.loads(buf.decode())
                try:
                    resp = self.handler(req.get('method'),
                                        req.get('payload'),
                                        timeout_s=(req.get('payload') or
                                                   {}).get('timeout_s'))
                except Exception as e:  # handler crash -> app error, not
                    #                     a torn wire: the caller can at
                    #                     least read what happened
                    resp = dict(ok=False, error=dict(
                        code='internal',
                        message=f'{type(e).__name__}: {e}'))
                # numpy results (the no-tolist hot path) degrade to
                # lists at this legacy text wire
                conn.sendall((json.dumps(resp, default=_np_jsonable)
                              + '\n').encode())
            except (OSError, ValueError):
                pass    # torn connection / garbage line: the client's
                #         read fails and ITS TransportError carries the
                #         verdict — nothing useful to do server-side

    def close(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


def serve_socket(server, port: int = 0,
                 host: str = '127.0.0.1') -> SocketServer:
    """Expose a `HostServer` on a TCP port; returns the running
    `SocketServer` (its `.port` is the bound port — pass 0 to let the
    OS pick, the worker prints it in its READY line)."""
    return SocketServer(server.handle, port=port, host=host)


# --------------------------------------------------------------------- #
# the production arm: pooled + multiplexed + binary-framed
# --------------------------------------------------------------------- #
class _Waiter:
    """One in-flight call's parking spot in a connection's demux
    table: the reader thread resolves it (response or link death), the
    calling thread waits on it under its own deadline."""

    __slots__ = ('event', 'response', 'error')

    def __init__(self):
        self.event = threading.Event()
        self.response: Optional[dict] = None
        self.error: Optional[str] = None


class _MuxConn:
    """One persistent connection: the socket, a send lock (frames from
    concurrent callers must not interleave), the correlation-id ->
    waiter table, and liveness."""

    __slots__ = ('sock', 'send_lock', 'lock', 'pending', 'alive')

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.send_lock = threading.Lock()
        self.lock = threading.Lock()
        self.pending: Dict[int, _Waiter] = {}
        self.alive = True


class BinaryTransport:
    """Persistent pooled binary-framed transport with correlation-id
    multiplexing — same one-verb `call()` surface and `TransportError`
    failure signal as the other arms, so the fleet runs unmodified.

        t = BinaryTransport('127.0.0.1', 9000, pool_size=2)
        t.call('infer', dict(tokens=np.arange(8), coords=...), timeout_s=5)

    Calls round-robin over `pool_size` persistent connections; many
    calls share each connection in flight at once (one reader thread
    per connection demuxes responses by correlation id). A dead
    connection — reset, EOF, frame corruption, send timeout — fails
    ONLY its own in-flight calls with `TransportError` and the next
    call reconnects, so a host restart on the same port stays exactly
    as transparent as the legacy connect-per-call arm. `timeout_s`
    still bounds connect + send + the response wait per call."""

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 30.0, fault_injector=None,
                 label: Optional[str] = None, pool_size: int = 2):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.fault_injector = fault_injector
        self.label = label if label is not None else f'{host}:{port}'
        self.pool_size = max(1, int(pool_size))
        self._slots: List[Optional[_MuxConn]] = [None] * self.pool_size
        self._ever_connected: set = set()
        self._lock = threading.Lock()      # slots + counters + corr ids
        self._rr = 0
        self._next_id = 0
        self._closed = False
        self._stats = dict(connections_opened=0, reconnects=0,
                           in_flight=0, peak_in_flight=0,
                           bytes_sent=0, bytes_received=0,
                           frame_errors=0)

    def transport_stats(self) -> dict:
        """Snapshot of the transport counters (the `transport` section
        of fleet/serve records and the loadgen A/B read these)."""
        with self._lock:
            return dict(self._stats)

    # ------------------------------------------------------------------ #
    def _checkout(self, deadline: float) -> _MuxConn:
        """Round-robin a live pooled connection, (re)connecting the
        slot if its connection died. Connect runs under the pool lock —
        reconnects are rare and serializing them keeps a thundering
        herd from opening `callers` sockets to a freshly restarted
        host."""
        with self._lock:
            if self._closed:
                raise TransportError(f'{self.label}: transport closed')
            slot = self._rr % self.pool_size
            self._rr += 1
            conn = self._slots[slot]
            if conn is not None and conn.alive:
                return conn
            left = deadline - time.monotonic()
            if left <= 0:
                raise TransportError(
                    f'{self.label}: deadline exhausted before connect')
            sock = socket.create_connection(
                (self.host, self.port), timeout=min(left, 10.0))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # bound each send syscall (SO_SNDTIMEO) so a wedged peer
            # with a full buffer surfaces as an OSError instead of
            # parking the caller forever; recv stays fully blocking —
            # the reader thread owns it and per-call deadlines are
            # enforced by the waiter, not the socket
            sec = max(1, int(self.timeout_s))
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack('ll', sec, 0))
            sock.settimeout(None)
            conn = _MuxConn(sock)
            self._slots[slot] = conn
            self._stats['connections_opened'] += 1
            if slot in self._ever_connected:
                self._stats['reconnects'] += 1
            self._ever_connected.add(slot)
            threading.Thread(
                target=self._read_loop, args=(conn,),
                name=f'mux-read:{self.label}#{slot}', daemon=True).start()
            return conn

    def _read_loop(self, conn: _MuxConn):
        """The demux thread: one per connection, reads frames forever,
        routes each response to its correlation id's waiter. Any read
        failure kills the connection and fails everything in flight on
        it."""
        why = 'connection closed'
        try:
            while True:
                msg, nbytes = _recv_frame(conn.sock)
                with self._lock:
                    self._stats['bytes_received'] += nbytes
                with conn.lock:
                    waiter = conn.pending.pop(msg.get('id'), None)
                if waiter is not None:
                    waiter.response = msg.get('response')
                    waiter.event.set()
                # unknown id: the caller already gave up on its
                # deadline — the late response is discarded
        except FrameError as e:
            with self._lock:
                self._stats['frame_errors'] += 1
            why = f'frame error: {e}'
        except OSError as e:
            why = f'{type(e).__name__}: {e}'
        except Exception as e:      # pragma: no cover - defense in depth
            why = f'{type(e).__name__}: {e}'
        self._kill_conn(conn, why)

    def _kill_conn(self, conn: _MuxConn, why: str):
        with conn.lock:
            already_dead = not conn.alive
            conn.alive = False
            pending, conn.pending = dict(conn.pending), {}
        try:
            conn.sock.close()
        except OSError:
            pass
        if already_dead and not pending:
            return
        for waiter in pending.values():
            waiter.error = (f'connection lost in flight ({why}) — '
                            f'the next call reconnects')
            waiter.event.set()

    # ------------------------------------------------------------------ #
    def call(self, method: str, payload: Optional[dict] = None,
             timeout_s: Optional[float] = None) -> dict:
        _fire_transport_faults(self.fault_injector, method, self.label)
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        deadline = time.monotonic() + max(0.001, timeout)
        try:
            conn = self._checkout(deadline)
        except OSError as e:
            raise TransportError(
                f'{self.label}: {method!r} connect failed: '
                f'{type(e).__name__}: {e}') from e
        with self._lock:
            cid = self._next_id
            self._next_id += 1
        waiter = _Waiter()
        with conn.lock:
            if not conn.alive:
                raise TransportError(
                    f'{self.label}: {method!r} raced a dying '
                    f'connection — the next call reconnects')
            conn.pending[cid] = waiter
        bufs = pack_frame(dict(id=cid, method=method,
                               payload=payload or {}))
        nbytes = sum(memoryview(b).nbytes for b in bufs)
        with self._lock:
            self._stats['in_flight'] += 1
            self._stats['peak_in_flight'] = max(
                self._stats['peak_in_flight'], self._stats['in_flight'])
        try:
            try:
                with conn.send_lock:
                    for b in bufs:
                        conn.sock.sendall(b)
            except OSError as e:
                self._kill_conn(conn, f'send failed: {e}')
                raise TransportError(
                    f'{self.label}: {method!r} failed on the wire: '
                    f'{type(e).__name__}: {e}') from e
            with self._lock:
                self._stats['bytes_sent'] += nbytes
            left = deadline - time.monotonic()
            if not waiter.event.wait(timeout=max(0.001, left)):
                with conn.lock:
                    conn.pending.pop(cid, None)
                raise TransportError(
                    f'{self.label}: {method!r} deadline '
                    f'({timeout:.3f}s) exhausted waiting for the '
                    f'response (correlation id {cid})')
            if waiter.error is not None:
                raise TransportError(
                    f'{self.label}: {method!r} {waiter.error}')
            return waiter.response
        finally:
            with self._lock:
                self._stats['in_flight'] -= 1

    def close(self):
        """Close the pool (in-flight calls fail with TransportError).
        The fleet never calls this mid-run — it exists for clean
        shutdown in smokes/tests."""
        with self._lock:
            self._closed = True
            conns = [c for c in self._slots if c is not None]
        for conn in conns:
            self._kill_conn(conn, 'transport closed')

    def __repr__(self):
        return f'BinaryTransport({self.label}, pool={self.pool_size})'


class _ServerConn:
    """Server-side connection state: the nonblocking socket, its
    partial-frame read buffer, and a send lock (pump threads must not
    interleave response frames)."""

    __slots__ = ('sock', 'buf', 'send_lock', 'open')

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = bytearray()
        self.send_lock = threading.Lock()
        self.open = True


class BinaryServer:
    """Frame-pump server for the binary multiplexed arm.

    No thread-per-connection: one acceptor, ONE demux thread that
    `select()`s over every connection and parses complete frames, and
    a small frame-pump pool that executes/ships responses. With an
    `async_handler` (`HostServer.handle_async`) the demux thread only
    ENQUEUES each call onto the host's serve loop — the serve loop
    still owns all router state, and its completion callback hands the
    response to a pump thread for the wire write, so a slow infer
    never parks a pump thread and in-flight depth is bounded by the
    host's admission control, not by this pool. With a plain sync
    `handler` (tests, loadgen echo servers) the pump threads run the
    handler directly, so at most `pumps` calls execute at once."""

    def __init__(self, handler: Callable, port: int = 0,
                 host: str = '127.0.0.1', *, pumps: int = 4,
                 async_handler: Optional[Callable] = None):
        self.handler = handler
        self.async_handler = async_handler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(128)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._newq: 'queue.Queue' = queue.Queue()
        self._workq: 'queue.Queue' = queue.Queue()
        self._selector = selectors.DefaultSelector()
        self._slock = threading.Lock()
        self._stats = dict(connections_opened=0, reconnects=0,
                           in_flight=0, peak_in_flight=0,
                           bytes_sent=0, bytes_received=0,
                           frame_errors=0)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f'bin-accept:{self.port}',
            daemon=True)
        self._demux_thread = threading.Thread(
            target=self._demux_loop, name=f'bin-demux:{self.port}',
            daemon=True)
        self._pumps = [threading.Thread(
            target=self._pump_loop, name=f'bin-pump{i}:{self.port}',
            daemon=True) for i in range(max(1, int(pumps)))]
        self._accept_thread.start()
        self._demux_thread.start()
        for t in self._pumps:
            t.start()

    def transport_stats(self) -> dict:
        """Server-side wire counters (the host's serve records carry
        these; `reconnects` is always 0 server-side — only the client
        knows a fresh accept is a reconnect)."""
        with self._slock:
            return dict(self._stats)

    # ------------------------------------------------------------------ #
    def _accept_loop(self):
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return    # close() won the startup race — nothing to serve
        while not self._stop.is_set():
            try:
                sock, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
                sock.setblocking(False)
            except OSError:
                continue
            with self._slock:
                self._stats['connections_opened'] += 1
            # hand the socket to the demux thread, the selector's only
            # owner (registering from two threads is a select race)
            self._newq.put(_ServerConn(sock))

    def _demux_loop(self):
        while not self._stop.is_set():
            while True:
                try:
                    conn = self._newq.get_nowait()
                except queue.Empty:
                    break
                try:
                    self._selector.register(conn.sock,
                                            selectors.EVENT_READ, conn)
                except (OSError, ValueError):
                    conn.open = False
            try:
                events = self._selector.select(timeout=0.05)
            except OSError:
                continue
            for key, _ in events:
                self._pump_read(key.data)
        for key in list(self._selector.get_map().values()):
            self._drop_conn(key.data)
        self._selector.close()

    def _pump_read(self, conn: _ServerConn):
        """Drain the socket, carve complete frames off the buffer,
        dispatch each one."""
        while True:
            try:
                chunk = conn.sock.recv(1 << 18)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._drop_conn(conn)
                return
            if not chunk:
                self._drop_conn(conn)
                return
            conn.buf += chunk
            with self._slock:
                self._stats['bytes_received'] += len(chunk)
            if len(chunk) < (1 << 18):
                break
        while True:
            if len(conn.buf) < _HEADER.size:
                return
            magic, env_len, body_len = _HEADER.unpack_from(conn.buf)
            if magic != _MAGIC or env_len + body_len > _MAX_FRAME:
                # a corrupted length-prefixed stream cannot be
                # resynced: count it, drop the connection, let the
                # client's TransportError + reconnect tell the story
                with self._slock:
                    self._stats['frame_errors'] += 1
                self._drop_conn(conn)
                return
            total = _HEADER.size + env_len + body_len
            if len(conn.buf) < total:
                return
            frame = bytes(conn.buf[:total])
            del conn.buf[:total]
            mv = memoryview(frame)
            try:
                msg = unpack_frame(
                    mv[_HEADER.size:_HEADER.size + env_len],
                    mv[_HEADER.size + env_len:])
            except FrameError:
                with self._slock:
                    self._stats['frame_errors'] += 1
                self._drop_conn(conn)
                return
            self._dispatch(conn, msg)

    def _dispatch(self, conn: _ServerConn, msg: dict):
        cid = msg.get('id')
        method = msg.get('method')
        payload = msg.get('payload') or {}
        timeout_s = payload.get('timeout_s')
        with self._slock:
            self._stats['in_flight'] += 1
            self._stats['peak_in_flight'] = max(
                self._stats['peak_in_flight'], self._stats['in_flight'])
        replied = []

        def reply(response):
            # exactly-once: a buggy double-completion must not skew
            # the in-flight gauge or send a duplicate frame
            if replied:
                return
            replied.append(True)
            self._workq.put(('send', conn, cid, response))

        if self.async_handler is not None:
            try:
                self.async_handler(method, payload, reply,
                                   timeout_s=timeout_s)
            except Exception as e:   # a crashing enqueue still answers
                reply(dict(ok=False, error=dict(
                    code='internal',
                    message=f'{type(e).__name__}: {e}')))
        else:
            self._workq.put(('call', conn, cid, method, payload,
                             timeout_s, reply))

    def _pump_loop(self):
        while True:
            item = self._workq.get()
            if item is None:
                return
            if item[0] == 'call':
                _, conn, cid, method, payload, timeout_s, reply = item
                try:
                    resp = self.handler(method, payload,
                                        timeout_s=timeout_s)
                except Exception as e:  # handler crash -> app error,
                    #                     not a torn wire (same contract
                    #                     as the legacy server)
                    resp = dict(ok=False, error=dict(
                        code='internal',
                        message=f'{type(e).__name__}: {e}'))
                self._send_response(conn, cid, resp)
            else:
                _, conn, cid, resp = item
                self._send_response(conn, cid, resp)

    def _send_response(self, conn: _ServerConn, cid, response):
        try:
            try:
                bufs = pack_frame(dict(id=cid, response=response))
            except (FrameError, TypeError, ValueError) as e:
                # an unencodable response must still answer — the
                # caller gets a structured internal error, not silence
                with self._slock:
                    self._stats['frame_errors'] += 1
                bufs = pack_frame(dict(id=cid, response=dict(
                    ok=False, error=dict(
                        code='internal',
                        message=f'response not frameable: {e}'))))
            nbytes = sum(memoryview(b).nbytes for b in bufs)
            try:
                with conn.send_lock:
                    for b in bufs:
                        _sendall_nonblocking(conn.sock, b)
                with self._slock:
                    self._stats['bytes_sent'] += nbytes
            except OSError:
                self._drop_conn(conn)
        finally:
            with self._slock:
                self._stats['in_flight'] -= 1

    def _drop_conn(self, conn: _ServerConn):
        if not conn.open:
            return
        conn.open = False
        try:
            self._selector.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def close(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        self._demux_thread.join(timeout=2.0)
        for _ in self._pumps:
            self._workq.put(None)
        for t in self._pumps:
            t.join(timeout=2.0)


def serve_binary(server, port: int = 0, host: str = '127.0.0.1',
                 pumps: int = 4) -> BinaryServer:
    """Expose a `HostServer` on a TCP port over the binary multiplexed
    framing; returns the running `BinaryServer` (its `.port` is the
    bound port). Uses the host's `handle_async` when present so the
    serve loop keeps single ownership of the router and in-flight
    depth is never bounded by the pump pool."""
    return BinaryServer(server.handle, port=port, host=host,
                        pumps=pumps,
                        async_handler=getattr(server, 'handle_async',
                                              None))


def _sendall_nonblocking(sock: socket.socket, buf,
                         timeout_s: float = 30.0):
    """sendall for a nonblocking socket: spin send/wait-writable until
    the buffer is gone (raises socket.timeout if the peer stalls a
    full `timeout_s` — the connection is then dropped)."""
    mv = memoryview(buf)
    if mv.format != 'B':
        mv = mv.cast('B')
    deadline = time.monotonic() + timeout_s
    while mv.nbytes:
        try:
            n = sock.send(mv)
        except (BlockingIOError, InterruptedError):
            left = deadline - time.monotonic()
            if left <= 0:
                raise socket.timeout(
                    f'response send stalled for {timeout_s:.0f}s')
            select.select([], [sock], [], min(left, 0.5))
            continue
        mv = mv[n:]
