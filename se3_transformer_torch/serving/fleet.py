"""The cross-host serving tier: a fleet of per-host routers. The port of
se3_transformer_tpu/serving/fleet.py.

A host is one process running a `Router` over its replicas (on one card,
hosts are processes that share it); each is a fault domain behind a small
RPC surface, and a `FleetRouter` routes across them:

  * `HostServer` puts one host's `Router` behind five RPC methods (`ping`,
    `stats`, `infer`, `swap`, `drain`). One serve-loop thread owns every
    router interaction (submit, pump, deadline flushes, swaps); RPC
    threads only queue and wait, so the router stays single-threaded as
    its tests hold it. `stats` is the routing signal: per-bucket depth,
    cumulative p99, precision mixes and model families, the retry and
    failure counters, one-time work after warmup, the host's mergeable
    latency histograms, and this process's kernel launches and routed
    calls (`kernels.launch_counts`: another process cannot read them).
    The serve loop publishes it as a snapshot whenever its state moves,
    right after it sends the answers of that turn; `stats`, like `ping`,
    is answered from the RPC thread: a host busy with queued forwards
    reports at once, and a scrape that follows an answer waits for the
    snapshot that counts it (the answer never waits for the snapshot).

  * `FleetRouter` is the front end: the per-replica breaker
    (`serving.health.HealthMonitor`) one level up, one breaker per host,
    driven by RPC outcomes and heartbeat staleness (healthy -> degraded ->
    quarantined; recovery through half-open `ping` probes with exponential
    backoff from `pump()`, so a SIGKILLed host restarted on its port
    closes its breaker through probe traffic). Placement is capability
    first (the scraped bucket sets and model families), then least
    loaded (fleet-side RPCs in flight plus the host's scraped queue
    depth), healthy before degraded, the scraped p99 breaking ties.
    Failed RPCs are redispatched to another host (at most `max_retries`
    times, never to the host that just failed), and deadlines travel as
    the remaining budget in the payload; past the budget a request
    resolves through `_fail_request`, the same zero-lost contract as the
    single-host router's, now fleet-wide. `host_exclusion` is the weaken
    hook: the fleet chaos run's weakened arm nulls it to show the gate
    fires.

  * Canaried rollout: `rollout(new_ref, rollback_ref, traffic)` swaps one
    canary host, drives pinned probe traffic through it, gates on its
    evidence (every probe answered, none lost, latency within budget, no
    new host-side structured failure), then rolls the other hosts, or
    rolls the canary back to `rollback_ref` and leaves the fleet on the
    old weights. Every decision lands in `rollout_events`.

`record_body()` assembles the schema'd `fleet` record: per-host breaker
snapshots and scraped stats, the host transitions, cross-host retries,
rollout and rollback events, heartbeat counts, the transport counters,
and the fleet-wide `lost_requests`. `python -m
se3_transformer_torch.serving.fleet_chaos` gates it.

Hazards of hosts on one card that JAX's hosts never met: each host is a
process with its own CUDA context, started as a fresh interpreter
(`inference.serve.spawn_host`, never a fork after CUDA is up), and a
SIGKILLed host frees its card memory only when its process is gone.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference.admission import (
    RequestFailed, RequestRejected, deadline_error, fit_bucket,
    oversize_error, retries_exhausted_error,
)
from ..inference.batching import PendingResult
from ..kernels import launch_counts
from ..observability.tracing import CONTROL_KIND, Tracer
from .health import QUARANTINED, HealthConfig, HealthMonitor
from .router import Router
from .transport import TransportError

__all__ = ['HostServer', 'FleetRouter']

# host error codes the fleet treats as a HOST failure (redispatch +
# breaker) rather than a request verdict: the host's own retry budget
# spending means its replicas are failing; 'internal'/'host_timeout'
# mean the host process itself is sick
_HOST_FAILURE_CODES = ('retries_exhausted', 'internal', 'host_timeout')


class _Call:
    __slots__ = ('method', 'payload', 'event', 'response', 'on_done')

    def __init__(self, method: str, payload: dict,
                 on_done: Optional[Callable] = None):
        self.method = method
        self.payload = payload
        self.event = threading.Event()
        self.response: Optional[dict] = None
        self.on_done = on_done

    def respond(self, response: dict):
        self.response = response
        self.event.set()
        if self.on_done is not None:
            try:
                self.on_done(response)
            except Exception as e:  # a buggy completion callback must
                #                     not take the serve loop with it
                warnings.warn(f'{self.method!r} completion callback '
                              f'raised {type(e).__name__}: {e}',
                              RuntimeWarning)


class HostServer:
    """One host's RPC surface over its `Router`.

        server = HostServer(router, host_id=0, telemetry=tele)
        server.handle('infer', dict(tokens=[...], coords=[...]))
        server.handle('swap', dict(directory=ckpt_dir, step=None))
        server.stop()        # drains the router, joins the loop

    A dedicated serve-loop thread owns the router: it dequeues calls,
    submits infers, pumps (deadline flushes, retries, probes), resolves
    watched requests, and periodically flushes the telemetry — RPC
    threads never touch router state. `handle` is therefore safe from
    any number of transport threads.

    `on_swap(payload, events)` is an optional hook invoked (on the loop
    thread) after a completed swap — the chaos harness uses it to arm a
    deterministic poison against the step the canary just restored.
    """

    METHODS = ('ping', 'stats', 'infer', 'swap', 'drain')

    def __init__(self, router: Router, host_id: int = 0, *,
                 telemetry=None, clock: Callable[[], float] = time.monotonic,
                 default_timeout_s: float = 30.0,
                 flush_every_batches: int = 8,
                 on_swap: Optional[Callable] = None):
        self.router = router
        self.host_id = int(host_id)
        self.telemetry = telemetry
        self.clock = clock
        self.default_timeout_s = float(default_timeout_s)
        self.flush_every_batches = int(flush_every_batches)
        self.on_swap = on_swap
        # host-side request tracing: spans are only recorded for
        # requests whose RPC payload carries a trace context, so an
        # untraced fleet pays nothing. The router's id namespace gets
        # the host prefix here too — per-router monotonic ints collide
        # across hosts once record streams merge.
        self.tracer = Tracer(origin=f'host{self.host_id}',
                             host=self.host_id, clock=clock)
        router.attach_tracer(self.tracer)
        if router.id_prefix is None:
            router.id_prefix = f'h{self.host_id}'
        self.started_at = clock()
        self.calls: Dict[str, int] = {m: 0 for m in self.METHODS}
        # handle() runs on arbitrary transport threads (one per socket
        # connection) — the per-method counters need their own lock
        self._calls_lock = threading.Lock()
        self._pump_errors_seen: set = set()
        self._inbox: 'queue.Queue[_Call]' = queue.Queue()
        self._stop = threading.Event()
        self._flushed_at_batches = 0
        # the `stats` response, replaced whole by the serve loop (never
        # mutated once published): RPC threads only read the reference.
        # `snapshots` and `snapshot_s` count the builds and their time
        # (the stats body reports them: what answering off the loop costs)
        self.snapshots = 0
        self.snapshot_s = 0.0
        self._stats_response: dict = {}
        self._publish_stats()
        # cleared while answers are out and their snapshot is not yet
        self._fresh = threading.Event()
        self._fresh.set()
        self._thread = threading.Thread(
            target=self._loop, name=f'host{self.host_id}-serve',
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    def handle(self, method: str, payload: Optional[dict] = None,
               timeout_s: Optional[float] = None) -> dict:
        """Transport entry (any thread): enqueue onto the serve loop,
        wait for the response. The wait is bounded by the request's own
        timeout budget plus slack — a wedged loop answers
        `host_timeout`, which the fleet counts as a host failure."""
        if method not in self.METHODS:
            return dict(ok=False, error=dict(
                code='unknown_method',
                message=f'{method!r} not in {self.METHODS}'))
        with self._calls_lock:
            self.calls[method] = self.calls.get(method, 0) + 1
        if method in ('ping', 'stats'):
            return self._answer_off_loop(method)
        call = _Call(method, dict(payload or {}))
        self._inbox.put(call)
        budget = timeout_s
        if budget is None:
            budget = call.payload.get('timeout_s')
        wait = (float(budget) if budget is not None
                else self.default_timeout_s) + 5.0
        if not call.event.wait(timeout=max(0.05, wait)):
            return dict(ok=False, error=dict(
                code='host_timeout',
                message=f'{method!r} timed out after {wait:.1f}s inside '
                        f'host {self.host_id}\'s serve loop'))
        return call.response

    def handle_async(self, method: str, payload: Optional[dict] = None,
                     reply: Optional[Callable] = None,
                     timeout_s: Optional[float] = None) -> None:
        """Transport entry, callback form (any thread): enqueue onto
        the serve loop and return immediately — `reply(response)`
        fires exactly once when the response is ready (from the serve
        loop thread for watched infers; the binary frame-pump server
        hands it straight to its writer pool, so the loop never blocks
        on a slow client socket). The binary server rides this so a
        slow infer never parks one of its pump threads and in-flight
        depth stays bounded by admission control, not the pool size.

        Unlike the blocking `handle`, a WEDGED serve loop here answers
        nothing — the caller's own transport deadline raises
        `TransportError`, which the fleet counts as the same host
        failure `host_timeout` maps to."""
        if method not in self.METHODS:
            reply(dict(ok=False, error=dict(
                code='unknown_method',
                message=f'{method!r} not in {self.METHODS}')))
            return
        with self._calls_lock:
            self.calls[method] = self.calls.get(method, 0) + 1
        if method in ('ping', 'stats'):
            reply(self._answer_off_loop(method))
            return
        self._inbox.put(_Call(method, dict(payload or {}),
                              on_done=reply))

    def _answer_off_loop(self, method: str) -> dict:
        """`ping` and `stats`, answered on the calling RPC thread, never
        queued behind the serve loop's synchronous forwards: `ping` says
        the PROCESS is alive (a half-open probe can close the breaker
        mid-dispatch, and traffic then re-judges the host on real
        outcomes); `stats` hands back the loop's last published
        snapshot, once the one that follows the latest answers is out (a
        few ms at most: it is built right after they are sent)."""
        if method == 'stats':
            self._fresh.wait(timeout=5.0)
            return self._stats_response
        now = self.clock()
        return dict(ok=True, host=self.host_id, t=round(now, 4),
                    uptime_s=round(now - self.started_at, 3))

    def _publish_stats(self):
        """Replace the `stats` response with one built now (serve-loop
        thread, or the constructor before the loop starts). A failing
        build publishes a structured error: an alive host saying no."""
        t0 = time.perf_counter()
        try:
            self._stats_response = dict(
                ok=True, stats=self._stats_body(self.clock()))
        except Exception as e:
            self._stats_response = dict(ok=False, error=dict(
                code='internal',
                message=f'stats snapshot raised {type(e).__name__}: {e}'))
        self.snapshots += 1
        self.snapshot_s += time.perf_counter() - t0

    def _answer_then_publish(self, answers):
        """Send `answers` ([(call, response)]), then publish the stats
        snapshot that counts them; a `stats` RPC in between waits for it."""
        self._fresh.clear()
        try:
            for call, response in answers:
                call.respond(response)
        finally:
            self._publish_stats()
            self._fresh.set()

    def _state_signature(self) -> tuple:
        """The router counters that a `stats` snapshot reports: when
        none moved over a loop turn, the published snapshot still holds."""
        r = self.router
        return (r.batches_dispatched, r.queue_depth, r.retries,
                r.request_failures, r.timeouts, r.deadline_sheds,
                len(r.swap_events))

    def stop(self, drain: bool = True):
        """End the serve loop (then drain the router by default, so
        everything already admitted answers: the graceful shutdown that
        `python -m se3_transformer_torch.inference.serve --host` walks on
        SIGTERM)."""
        self._stop.set()
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            # the loop is wedged (a watched request behind a stuck
            # runner) and STILL OWNS the router — draining from this
            # thread would break the single-owner invariant and mutate
            # batcher/retry state concurrently. Loud skip instead.
            warnings.warn(
                f'host {self.host_id}: serve loop did not exit within '
                f'30s of stop() — skipping the router drain (the loop '
                f'thread still owns the router)', RuntimeWarning)
            return
        if drain:
            self.router.drain()

    # ------------------------------------------------------------------ #
    # the serve loop: the ONLY thread that touches the router
    # ------------------------------------------------------------------ #
    def _loop(self):
        watched: List[Tuple[PendingResult, _Call]] = []
        signature = self._state_signature()
        while not (self._stop.is_set() and self._inbox.empty()
                   and not watched):
            try:
                call = self._inbox.get(timeout=0.002)
            except queue.Empty:
                call = None
            if call is not None:
                try:
                    self._handle_call(call, watched)
                except Exception as e:
                    # NO handler exception may kill this thread: a dead
                    # loop wedges every future RPC into host_timeout
                    # and the host can never rejoin the fleet. Answer
                    # structurally — an alive host saying "no" is the
                    # whole transport contract.
                    call.respond(dict(ok=False, error=dict(
                        code='internal',
                        message=f'{call.method!r} handler raised '
                                f'{type(e).__name__}: {e}')))
            try:
                self.router.pump()
            except Exception as e:
                # a raising sync runner without failure hooks lands
                # here (its requests already resolved done-with-error
                # inside dispatch_batch) — but a PERSISTENT pump bug
                # would too, re-raising every iteration. Warn once per
                # distinct error so a wedged host leaves evidence
                # instead of silence.
                key = f'{type(e).__name__}: {e}'
                if key not in self._pump_errors_seen:
                    self._pump_errors_seen.add(key)
                    warnings.warn(
                        f'host {self.host_id}: router.pump raised '
                        f'{key} (warned once; the serve loop '
                        f'continues)', RuntimeWarning)
            done = [(p, c) for p, c in watched if p.done]
            if done:
                watched[:] = [(p, c) for p, c in watched if not p.done]
            moved = self._state_signature()
            if done or moved != signature:
                signature = moved
                self._answer_then_publish(
                    [(c, self._infer_response(p)) for p, c in done])
            try:
                self._maybe_flush()
            except Exception as e:   # a failing telemetry bank (disk
                #                      full, rotated file) must not
                #                      take the serve loop with it
                warnings.warn(f'host {self.host_id}: telemetry flush '
                              f'failed: {type(e).__name__}: {e}',
                              RuntimeWarning)

    def _handle_call(self, call: _Call, watched: list):
        method, payload = call.method, call.payload
        if method == 'drain':
            batches = self.router.drain()
            self._answer_then_publish([(call, dict(ok=True,
                                                   batches=batches))])
        elif method == 'swap':
            try:
                events = self.router.swap_from_checkpoint(
                    payload['directory'], payload.get('step'))
                if self.on_swap is not None:
                    self.on_swap(payload, events)
                response = dict(ok=True, events=events,
                                tag=events[0]['tag'] if events else None)
            except Exception as e:
                response = dict(ok=False, error=dict(
                    code='internal',
                    message=f'swap failed: {type(e).__name__}: {e}'))
            self._answer_then_publish([(call, response)])
        elif method == 'infer':
            try:
                tokens = np.asarray(payload['tokens'])
                coords = np.asarray(payload['coords'],
                                    np.float32).reshape(-1, 3)
                pending = self.router.submit(
                    tokens, coords, timeout_s=payload.get('timeout_s'),
                    trace=payload.get('trace'))
            except RequestRejected as e:
                call.respond(dict(ok=False, error=dict(
                    code=e.code, message=str(e), detail=e.detail)))
                return
            except Exception as e:
                call.respond(dict(ok=False, error=dict(
                    code='internal',
                    message=f'{type(e).__name__}: {e}')))
                return
            watched.append((pending, call))

    def _infer_response(self, p: PendingResult) -> dict:
        if p.ok:
            # the result stays a numpy array — LocalTransport hands the
            # buffer through untouched and the binary framing ships it
            # raw; only the legacy JSON wire degrades it to lists (its
            # server's json.dumps default= hook), so the old tolist()
            # copy tax is paid exactly where a text wire demands it
            resp = dict(ok=True,
                        result=np.asarray(p.result),
                        latency_ms=round((p.latency_s or 0.0) * 1e3, 3))
        else:
            err = p.error
            if isinstance(err, (RequestFailed, RequestRejected)):
                resp = dict(ok=False, error=dict(
                    code=err.code, message=str(err), detail=err.detail))
            else:
                resp = dict(ok=False, error=dict(
                    code='internal',
                    message=f'{type(err).__name__}: {err}'))
        tr = getattr(p, 'trace', None)
        if tr:
            # ship the request's host-side spans back to the fleet
            # front-end (error verdicts carry their story too); popping
            # keeps the host tracer bounded by what is still in flight
            spans = self.tracer.pop_trace(tr['ctx'])
            if spans:
                resp['spans'] = spans
        return resp

    def _stats_body(self, now: float) -> dict:
        """The per-host routing signal, scraped off the surfaces that
        already exist (router counters, the shared PhaseTimer's
        cumulative per-bucket p99, RouterTelemetry's one-time-work
        verdict): the fleet routes on these, so they are the numbers the
        serve records carry. `device` names the engines' device, and
        `launches` / `routed` this process's kernel launches and routed
        calls (kernels.launch_counts), which no other process can read."""
        r = self.router
        cum = r.workers[0].engine.timer.cumulative_summary()
        p99 = {phase[len('bucket_'):]: st.get('p99_ms')
               for phase, st in cum.items() if phase.startswith('bucket_')}
        post_warmup = None
        slo = None
        if self.telemetry is not None:
            self.telemetry._check_runtime()     # fold in one-time work
            post_warmup = self.telemetry.post_warmup_compiles
            # mergeable per-bucket latency histograms + cumulative
            # answered/failed: the fleet's SLOAggregator folds these,
            # so fleet percentiles are EXACT merges, never averaged
            slo = self.telemetry.slo_snapshot()
        body = dict(
            host=self.host_id, t=round(now, 4),
            buckets=list(r.buckets),
            queue_depth=r.queue_depth,
            depth_by_bucket={str(b): d
                             for b, d in r.depth_by_bucket.items()},
            p99_ms_by_bucket=p99,
            precision_mixes=sorted({
                getattr(w.engine, 'precision_name', 'fp32')
                for w in r.workers}),
            model_families=sorted({
                getattr(w.engine, 'model_family', 'se3_v1')
                for w in r.workers}),
            served=sum(w.served_rows for w in r.workers),
            batches=r.batches_dispatched,
            retries=r.retries,
            request_failures=r.request_failures,
            timeouts=r.timeouts,
            deadline_sheds=r.deadline_sheds,
            swaps=len(r.swap_events),
            health=r.health.snapshot(),
            post_warmup_compiles=post_warmup,
            snapshots=self.snapshots,
            snapshot_ms=round(self.snapshot_s * 1e3, 3),
        )
        device = torch.device(getattr(r.workers[0].engine, 'device',
                                      'cpu'))
        body.update(device=str(device), **launch_counts())
        if device.type == 'cuda':
            # this process's peak on the card (hosts share one card: the
            # fleet's peak is their sum)
            body['peak_bytes'] = int(torch.cuda.max_memory_allocated(device))
        if slo is not None:
            body.update(slo)
        return body

    def _maybe_flush(self):
        if self.telemetry is None:
            return
        batches = self.router.batches_dispatched
        if batches - self._flushed_at_batches >= self.flush_every_batches:
            self._flushed_at_batches = batches
            self.telemetry.flush()


class _HostHandle:
    """Fleet-side view of one host: its transport plus the scraped
    signal cache and in-flight accounting (mutated under the fleet's
    lock)."""

    def __init__(self, host_id: int, transport):
        self.id = int(host_id)
        self.transport = transport
        self.outstanding = 0            # fleet-side in-flight RPCs
        self.stats: dict = {}           # last successful scrape
        self.last_ok_at: Optional[float] = None
        self.last_attempt_at: Optional[float] = None
        self.last_stale_mark: Optional[float] = None
        self.last_error: Optional[str] = None


class FleetRouter:
    """Health-aware cross-host placement + retry + canaried rollout.

        transports = {0: SocketTransport(...), 1: ..., 2: ...}
        with FleetRouter(transports, max_retries=2,
                         default_timeout_s=30.0) as fleet:
            pending = fleet.submit(tokens, coords)   # async: a pool
            fleet.pump()          # heartbeats, staleness, probes
            event, probes = fleet.rollout(new_ref, old_ref, traffic)
            fleet.drain()         # barrier: every submit resolved

    `submit` returns immediately (a worker-pool thread walks the
    dispatch: pick host -> RPC -> redispatch-on-failure -> resolve);
    `drain()` barriers the pool. Every submit ends answered or with a
    structured error through `_fail_request` — the fleet-wide zero-lost
    contract (`host_exclusion = False` is the chaos smoke's weaken
    hook: quarantine and failed-host exclusion stop steering placement,
    so a dead host keeps eating traffic and the gate must fire).
    """

    def __init__(self, transports, *,
                 health: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_retries: int = 2,
                 default_timeout_s: Optional[float] = None,
                 heartbeat_every_s: float = 0.5,
                 heartbeat_timeout_s: float = 2.0,
                 stale_after_s: float = 5.0,
                 concurrency: int = 8,
                 tracer: Optional[Tracer] = None,
                 slo=None):
        if isinstance(transports, dict):
            items = sorted(transports.items())
        else:
            items = list(enumerate(transports))
        assert items, 'a fleet needs at least one host'
        self.hosts: Dict[int, _HostHandle] = {
            int(k): _HostHandle(k, t) for k, t in items}
        self.health = HealthMonitor(list(self.hosts),
                                    config=health, clock=clock)
        self.clock = clock
        self.max_retries = int(max_retries)
        assert self.max_retries >= 0
        self.default_timeout_s = default_timeout_s
        self.heartbeat_every_s = float(heartbeat_every_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.stale_after_s = float(stale_after_s)
        self.host_exclusion = True      # the chaos weaken hook
        # observability plane (both optional, both zero-cost when
        # absent): `tracer` mints one trace per submit and folds the
        # hosts' returned spans; `slo` (observability.slo.SLOAggregator)
        # is fed every successful stats scrape
        self.tracer = tracer
        self.slo = slo
        self.buckets: Optional[tuple] = None   # learned from scrapes
        self._lock = threading.Lock()
        self._executor = ThreadPoolExecutor(
            max_workers=max(2, int(concurrency)),
            thread_name_prefix='fleet')
        self._futures: List[Future] = []
        self._next_id = 0
        # fleet-wide counters (under _lock; the fleet record reads them)
        self.submitted = 0
        self.answered = 0
        self.cross_host_retries = 0
        self.request_failures = 0
        self.timeouts = 0
        self.heartbeats_ok = 0
        self.heartbeats_failed = 0
        self.stale_marks = 0
        self.rollout_events: List[dict] = []
        self.host_swaps: List[dict] = []
        self.rollbacks = 0
        self.rollouts = 0

    # ------------------------------------------------------------------ #
    @property
    def queue_depth(self) -> int:
        """Fleet-side in-flight RPCs + the hosts' scraped queue depths
        (stale by at most a heartbeat interval)."""
        with self._lock:
            inflight = sum(h.outstanding for h in self.hosts.values())
            scraped = sum(h.stats.get('queue_depth', 0)
                          for h in self.hosts.values())
        return inflight + scraped

    def retry_after_hint(self, queue_depth: int) -> float:
        """Backoff hint for structured failures (the satellite
        contract: RequestFailed carries the same machine-readable
        `retry_after_s` an overload RequestRejected does). Per-request
        drain estimate from the scraped per-bucket p99s; 50 ms/request
        before any host reported latency."""
        per_row_s = 0.05
        with self._lock:
            p99s = [v for h in self.hosts.values()
                    for v in (h.stats.get('p99_ms_by_bucket') or {}).values()
                    if isinstance(v, (int, float))]
        if p99s:
            per_row_s = (sum(p99s) / len(p99s)) / 1e3
        return max(1, int(queue_depth)) * per_row_s

    def _fail_request(self, pending: PendingResult,
                      error: Exception) -> None:
        """THE terminal structured choke point, fleet tier — the same
        zero-lost contract `Router._fail_request` carries. Stamps the
        `retry_after_s` backoff hint when the error lacks one."""
        if isinstance(error, RequestFailed) and \
                'retry_after_s' not in error.detail:
            error.detail['retry_after_s'] = round(
                max(0.0, self.retry_after_hint(self.queue_depth)), 4)
        pending.error = error
        pending.done = True
        pending.completed_at = self.clock()
        with self._lock:
            self.request_failures += 1
        tr = getattr(pending, 'trace', None)
        if self.tracer is not None and tr:
            # a structured failure still closes the root span — the
            # completeness invariant covers failed requests too
            self.tracer.end(tr['root'],
                            status=getattr(error, 'code', None)
                            or type(error).__name__)

    # ------------------------------------------------------------------ #
    # placement
    # ------------------------------------------------------------------ #
    def _score(self, h: _HostHandle):
        # with `host_exclusion` nulled (the weaken arm) placement is
        # load-only: health must not steer traffic away from a sick
        # host, or the weakened gate would be protected by the very
        # mechanism it claims to have disabled
        rank = 0
        if self.host_exclusion and self.health.state(h.id) != 'healthy':
            rank = 1
        depth = h.outstanding + h.stats.get('queue_depth', 0)
        p99s = [v for v in (h.stats.get('p99_ms_by_bucket') or {}).values()
                if isinstance(v, (int, float))]
        return (depth, rank, max(p99s) if p99s else 0.0, h.id)

    def _host_capable(self, h: _HostHandle, length: Optional[int],
                      family: Optional[str]) -> bool:
        """Can this host serve a request of `length` tokens for model
        `family`, judged on its last scraped stats (bucket set + model
        families)? A host that has never been scraped counts as
        capable — ignorance must not black-hole traffic before the
        first heartbeat lands."""
        st = h.stats
        if not st:
            return True
        if length is not None and st.get('buckets'):
            if fit_bucket(tuple(int(b) for b in st['buckets']),
                          int(length)) is None:
                return False
        if family is not None and st.get('model_families'):
            if family not in st['model_families']:
                return False
        return True

    def _pick_host(self, exclude: Optional[int] = None,
                   length: Optional[int] = None,
                   family: Optional[str] = None) -> _HostHandle:
        """CAPABILITY filter first, then least-loaded over (fleet
        in-flight + scraped depth), healthy before degraded, scraped
        p99 tie-break. The capability filter (scraped bucket sets +
        model families) means a request sized for a big bucket never
        lands on a host that lacks it — in a heterogeneous fleet the
        incapable hosts simply leave the pool; if NO host is capable
        the request rejects structurally, naming per-host capabilities
        and which hosts are capable on each axis. Quarantined hosts
        and `exclude` (the host a retry just failed on) leave the pool
        — unless `host_exclusion` was nulled (the weaken arm), in
        which case placement is load-only and the chaos gate must
        catch the consequences. All-quarantined degrades to
        best-effort over the CAPABLE hosts (serving through a sick
        host beats black-holing; serving through an incapable one is
        just a slower reject)."""
        hosts = list(self.hosts.values())
        pool = [h for h in hosts
                if self._host_capable(h, length, family)]
        if not pool:
            by_len = [h.id for h in hosts
                      if self._host_capable(h, length, None)]
            by_fam = [h.id for h in hosts
                      if self._host_capable(h, None, family)]
            caps = {str(h.id): dict(
                        buckets=list(h.stats.get('buckets') or []),
                        model_families=list(
                            h.stats.get('model_families') or []))
                    for h in hosts}
            raise RequestRejected(
                'no_capable_host',
                f'no host serves length={length} '
                f'model_family={family!r}: capable by length '
                f'{by_len}, by family {by_fam}, per-host '
                f'capabilities {caps}',
                length=length, model_family=family,
                capable_by_length=by_len, capable_by_family=by_fam,
                host_capabilities=caps)
        capable = pool
        if self.host_exclusion:
            pool = [h for h in capable
                    if h.id != exclude
                    and self.health.state(h.id) != QUARANTINED]
            if not pool:
                pool = [h for h in capable
                        if h.id != exclude] or capable
        return min(pool, key=self._score)

    # ------------------------------------------------------------------ #
    # submission + dispatch
    # ------------------------------------------------------------------ #
    def submit(self, tokens, coords,
               timeout_s: Optional[float] = None,
               pin_host: Optional[int] = None,
               model_family: Optional[str] = None) -> PendingResult:
        """Admit one request; a pool thread dispatches it (cross-host
        retries included) and resolves the returned PendingResult.
        Oversize requests reject at the door once any host has reported
        its buckets (before that, the host's own rejection resolves the
        pending structurally — either way, never silence). The door
        gate uses the UNION of scraped bucket sets — in a
        heterogeneous fleet a request only rejects here when NO host
        could ever serve it; per-host placement then routes it to the
        hosts that actually have the bucket (and, when `model_family`
        is given, serve that family).

        `pin_host` pins the dispatch to ONE host, single-attempt (the
        rollout's canary probes ride this: a redispatch to a healthy
        sibling would mask exactly the failure the canary gate exists
        to observe)."""
        tokens = np.asarray(tokens)
        coords = np.asarray(coords, np.float32).reshape(-1, 3)
        length = len(tokens)
        bucket = -1
        if self.buckets:
            bucket = fit_bucket(self.buckets, length)
            if bucket is None:
                raise oversize_error(length, self.buckets[-1])
        submitted_at = self.clock()
        timeout_s = (timeout_s if timeout_s is not None
                     else self.default_timeout_s)
        deadline = (submitted_at + float(timeout_s)
                    if timeout_s is not None else None)
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self.submitted += 1
        pending = PendingResult(rid, length, bucket, submitted_at,
                                deadline=deadline)
        if self.tracer is not None:
            # the single trace root: every span of this request — fleet
            # attempts, redispatches, and the hosts' returned admit/
            # dispatch trees — hangs under it, and exactly one terminal
            # site closes it (end() is idempotent)
            tid = self.tracer.mint()
            root = self.tracer.begin(tid, 'request', rid=rid,
                                     pinned=pin_host)
            pending.trace = dict(ctx=tid, root=root)
        self._track(self._executor.submit(
            self._dispatch, pending, tokens, coords, pin_host,
            model_family))
        return pending

    def _track(self, future: Future):
        with self._lock:
            # prune cleanly-finished futures so the list stays bounded
            self._futures = [f for f in self._futures if not f.done()]
            self._futures.append(future)

    def _dispatch(self, pending: PendingResult, tokens, coords,
                  pin_host: Optional[int] = None,
                  model_family: Optional[str] = None):
        """Worker-pool body: pick -> RPC -> redispatch or resolve.
        NEVER raises — every exit resolves the pending (the zero-lost
        contract is this function terminating structurally)."""
        exclude = None
        last_err: Optional[Exception] = None
        try:
            while True:
                now = self.clock()
                if pending.expired(now):
                    timeout_s = ((pending.deadline - pending.submitted_at)
                                 if pending.deadline is not None else 0.0)
                    with self._lock:
                        self.timeouts += 1
                    self._fail_request(pending, deadline_error(
                        now - pending.submitted_at, timeout_s,
                        attempts=pending.attempts))
                    return
                try:
                    host = (self.hosts[pin_host]
                            if pin_host is not None
                            else self._pick_host(
                                exclude=exclude,
                                length=pending.length,
                                family=model_family))
                except RequestRejected as e:
                    # capability reject: no host in the fleet serves
                    # this size/family — structured, names the capable
                    # hosts per axis, retrying cannot improve it
                    self._fail_request(pending, e)
                    return
                outcome, err = self._call_infer(host, pending,
                                                tokens, coords)
                if outcome in ('answered', 'resolved'):
                    return
                last_err = err
                pending.attempts += 1
                if pin_host is not None:
                    # pinned probe traffic (canary gating): one host,
                    # one attempt — a redispatch to a healthy sibling
                    # would MASK exactly the failure the gate exists
                    # to observe
                    self._fail_request(pending, retries_exhausted_error(
                        pending.attempts, last_err))
                    return
                if self.host_exclusion:
                    exclude = host.id
                if pending.attempts > self.max_retries:
                    self._fail_request(pending, retries_exhausted_error(
                        pending.attempts, last_err))
                    return
                with self._lock:
                    self.cross_host_retries += 1
                tr = getattr(pending, 'trace', None)
                if self.tracer is not None and tr:
                    # one redispatch span per cross_host_retries
                    # increment — the trace record's redispatch_hops
                    # reconciles against the counter exactly
                    self.tracer.add(tr['ctx'], 'redispatch',
                                    parent_id=tr['root']['span'],
                                    failed_host=host.id,
                                    attempt=pending.attempts)
        except Exception as e:   # defense in depth: a bug here must
            #                      still resolve the request, not lose it
            if not pending.done:
                self._fail_request(pending, retries_exhausted_error(
                    pending.attempts + 1, e))

    def _call_infer(self, host: _HostHandle, pending: PendingResult,
                    tokens, coords):
        """One RPC attempt -> ('answered' | 'resolved' | 'failed', err).
        'failed' means a HOST failure (transport error or a host-level
        error code): breaker fed, caller redispatches. 'resolved' means
        the request got a structured verdict (deadline / reject) that
        redispatching cannot improve."""
        now = self.clock()
        # arrays ride the payload as-is: zero-copy through
        # LocalTransport, raw framed segments through BinaryTransport;
        # the legacy JSON arm degrades them to lists at ITS wire
        payload = dict(tokens=np.asarray(tokens),
                       coords=np.asarray(coords))
        rpc_timeout = None
        if pending.deadline is not None:
            remaining = max(0.0, pending.deadline - now)
            payload['timeout_s'] = round(remaining, 4)
            rpc_timeout = remaining + 5.0
        att = None
        tr = getattr(pending, 'trace', None)
        if self.tracer is not None and tr:
            att = self.tracer.begin(tr['ctx'], 'attempt',
                                    parent_id=tr['root']['span'],
                                    host=host.id)
            # the trace context rides the payload (the transport is
            # payload-opaque); the host hangs its spans under `parent`
            # and ships them back in the response's `spans` key
            payload['trace'] = dict(trace=tr['ctx'],
                                    parent=att['span'])
        with self._lock:
            host.outstanding += 1
        try:
            res = host.transport.call('infer', payload,
                                      timeout_s=rpc_timeout)
        except TransportError as e:
            host.last_error = str(e)
            self.health.record_failure(host.id, e)
            if self.tracer is not None:
                # the host (or its link) died mid-RPC: its local spans
                # are simply lost — the fleet-side tree stays complete
                # through this attempt span and the retry path
                self.tracer.end(att, status='transport_error')
            return 'failed', e
        finally:
            with self._lock:
                host.outstanding -= 1
        if self.tracer is not None and att is not None:
            self.tracer.end(att, status=('ok' if res.get('ok') else
                                         (res.get('error') or {})
                                         .get('code')))
            self.tracer.extend(res.get('spans'))
        if res.get('ok'):
            self.health.record_success(host.id)
            pending.result = np.asarray(res['result'], np.float32)
            pending.done = True
            pending.completed_at = self.clock()
            with self._lock:
                self.answered += 1
            if self.tracer is not None and tr:
                self.tracer.end(tr['root'], status='ok')
            return 'answered', None
        err = (res.get('error') or {})
        code = err.get('code')
        message = err.get('message', 'host returned no message')
        detail = dict(err.get('detail') or {}, host=host.id)
        if code in _HOST_FAILURE_CODES or code is None:
            e = RuntimeError(f'host {host.id}: {code}: {message}')
            host.last_error = str(e)
            self.health.record_failure(host.id, e)
            return 'failed', e
        if code == 'deadline':
            with self._lock:
                self.timeouts += 1
            self._fail_request(pending,
                               RequestFailed(code, message, **detail))
        elif code in ('oversize', 'overloaded'):
            self._fail_request(pending,
                               RequestRejected(code, message, **detail))
        else:
            self._fail_request(pending,
                               RequestFailed(code, message, **detail))
        return 'resolved', None

    # ------------------------------------------------------------------ #
    # heartbeats, staleness, probes
    # ------------------------------------------------------------------ #
    def pump(self, now: Optional[float] = None) -> None:
        """The fleet heartbeat: scrape due hosts (routing signals),
        mark stale ones as failures, and issue half-open `ping` probes
        to quarantined hosts whose backoff elapsed (claimed atomically
        via `try_begin_probe`, so concurrent pumps never double-book).
        All RPCs run on the pool — pump never blocks the serve loop."""
        now = self.clock() if now is None else now
        for h in self.hosts.values():
            if self.health.state(h.id) == QUARANTINED:
                if self.health.try_begin_probe(h.id, now):
                    self._track(self._executor.submit(self._probe, h))
                continue
            if h.last_attempt_at is None or \
                    now - h.last_attempt_at >= self.heartbeat_every_s:
                h.last_attempt_at = now
                self._track(self._executor.submit(self._heartbeat, h))
            anchor = h.last_ok_at
            if anchor is not None and now - anchor >= self.stale_after_s \
                    and (h.last_stale_mark is None
                         or now - h.last_stale_mark >= self.stale_after_s):
                # the link isn't refusing, it's SILENT: staleness is a
                # failure signal of its own (a partitioned host must
                # leave rotation even if no RPC happens to fail)
                h.last_stale_mark = now
                with self._lock:
                    self.stale_marks += 1
                self.health.record_failure(h.id, RuntimeError(
                    f'heartbeat stale: host {h.id} last answered '
                    f'{now - anchor:.1f}s ago '
                    f'(stale_after_s={self.stale_after_s})'))

    def _heartbeat(self, h: _HostHandle):
        """Scrape one host's stats. Successes refresh the routing
        signal but do NOT feed the breaker (asymmetric by design: a
        host that answers pings while failing dispatches must not have
        its breaker reset by the pings); failures feed it.

        A host answers `stats` off its serve loop, from the snapshot the
        loop last published, so a host busy with queued forwards still
        answers within `heartbeat_timeout_s`: what fails a heartbeat is
        a dead process, a partitioned link or a host that errs, never
        the length of its queue. A host whose loop wedges keeps
        answering with a snapshot that stops moving; its dispatches'
        failures are what take it out of rotation."""
        try:
            res = h.transport.call('stats',
                                   timeout_s=self.heartbeat_timeout_s)
        except TransportError as e:
            h.last_error = str(e)
            with self._lock:
                self.heartbeats_failed += 1
            self.health.record_failure(h.id, e)
            return
        if res.get('ok'):
            h.stats = res.get('stats') or {}
            h.last_ok_at = self.clock()
            h.last_stale_mark = None
            if self.slo is not None:
                # the heartbeat loop IS the SLO scrape: stats carry the
                # host's cumulative mergeable histograms and counters
                self.slo.fold(h.id, h.stats)
            with self._lock:
                self.heartbeats_ok += 1
                if h.stats.get('buckets'):
                    # fleet-level buckets = UNION over scraped hosts:
                    # the door-level oversize gate only rejects what NO
                    # host could serve; per-host capability filtering
                    # in _pick_host handles heterogeneity
                    self.buckets = tuple(sorted(
                        {int(b) for b in h.stats['buckets']}
                        | set(self.buckets or ())))
        else:
            with self._lock:
                self.heartbeats_failed += 1
            self.health.record_failure(h.id, RuntimeError(
                f'stats RPC returned error: {res.get("error")}'))

    def _probe(self, h: _HostHandle):
        """The half-open probe (claimed before submission): one `ping`.
        Success closes the breaker back to degraded — the host rejoins
        rotation and dispatch successes walk it to healthy; failure
        doubles the backoff. A restarted process on the same port
        recovers through exactly this path."""
        span = None
        if self.tracer is not None:
            # control-plane trace: excluded from request completeness
            span = self.tracer.begin(
                self.tracer.mint(CONTROL_KIND), 'probe', host=h.id)
        try:
            res = h.transport.call('ping',
                                   timeout_s=self.heartbeat_timeout_s)
        except TransportError as e:
            h.last_error = str(e)
            self.health.record_failure(h.id, e)
            if self.tracer is not None:
                self.tracer.end(span, status='transport_error')
            return
        ok = bool(res.get('ok'))
        if self.tracer is not None:
            self.tracer.end(span, status='ok' if ok else 'error')
        if ok:
            self.health.record_success(h.id)
            h.last_ok_at = self.clock()
            h.last_stale_mark = None
        else:
            self.health.record_failure(h.id, RuntimeError(
                f'probe ping returned error: {res.get("error")}'))

    # ------------------------------------------------------------------ #
    # canaried rollout
    # ------------------------------------------------------------------ #
    def _swap(self, h: _HostHandle, ref: dict) -> str:
        t0 = time.perf_counter()
        res = h.transport.call('swap', dict(ref),
                               timeout_s=self.heartbeat_timeout_s + 30.0)
        if not res.get('ok'):
            raise TransportError(
                f'host {h.id} swap to {ref} failed: {res.get("error")}')
        tag = res.get('tag') or '?'
        # the swap RPC's wall (the host drains, copies, answers): the
        # `fleet` record's host_swaps
        with self._lock:
            self.host_swaps.append(dict(
                host=h.id, tag=tag,
                seconds=round(time.perf_counter() - t0, 4)))
        return tag

    def rollout(self, new_ref: dict, rollback_ref: dict,
                canary_traffic: Sequence[tuple], *,
                canary: Optional[int] = None,
                latency_budget_ms: Optional[float] = None,
                timeout_s: Optional[float] = None):
        """Fleet-wide rolling weight rollout over the hosts' drain/swap
        contract, gated by a CANARY:

          1. swap ONE host (`canary`, default: the best-ranked live
             host) to `new_ref` ({'directory': ..., 'step': ...} — the
             host's `swap_from_checkpoint` handles torn-latest
             fallback and tags the step actually restored);
          2. drive `canary_traffic` ([(tokens, coords), ...]) PINNED to
             the canary — single-attempt, failures resolve structurally
             on the canary instead of being masked by redispatch;
          3. gate on the canary's serve evidence: every probe answered,
             zero lost, max latency within `latency_budget_ms` (when
             given), and zero NEW host-side structured failures across
             the swap (scraped stats delta);
          4. gate passed -> roll every other host; gate failed -> AUTO
             ROLL-BACK the canary to `rollback_ref` and leave the rest
             of the fleet untouched.

        Returns `(event, probes)`: the JSON-safe rollout event (also
        appended to `rollout_events` — the fleet record's evidence) and
        the probe PendingResults (callers fold them into their
        zero-lost accounting)."""
        pool = [h for h in self.hosts.values()
                if self.health.state(h.id) != QUARANTINED]
        assert pool, 'every host is quarantined — nothing to canary'
        canary_host = (self.hosts[int(canary)] if canary is not None
                       else min(pool, key=self._score))
        pre = self._scrape_sync(canary_host)
        span = None
        if self.tracer is not None:
            # control-plane trace over the whole canary decision
            span = self.tracer.begin(
                self.tracer.mint(CONTROL_KIND), 'rollout',
                canary=canary_host.id)
        event = dict(t=round(self.clock(), 3), canary=canary_host.id,
                     new=dict(new_ref))
        try:
            event['canary_tag'] = self._swap(canary_host, new_ref)
        except TransportError as e:
            self.health.record_failure(canary_host.id, e)
            event.update(passed=False, rolled_back=False,
                         aborted=f'canary swap failed: {e}')
            with self._lock:
                self.rollout_events.append(event)
            if self.tracer is not None:
                self.tracer.end(span, status='aborted')
            return event, []
        # the probes ride the SAME admission path as every request
        # (oversize gate included), just pinned single-attempt
        probes = [self.submit(tokens, coords, timeout_s=timeout_s,
                              pin_host=canary_host.id)
                  for tokens, coords in canary_traffic]
        self._wait_for(probes)
        post = self._scrape_sync(canary_host)
        answered = sum(1 for p in probes if p.ok)
        lost = sum(1 for p in probes if not p.done)
        lat = [p.latency_s * 1e3 for p in probes
               if p.ok and p.latency_s is not None]
        failures_delta = None
        if pre is not None and post is not None:
            failures_delta = (post.get('request_failures', 0)
                              - pre.get('request_failures', 0))
        gate = dict(requests=len(probes), answered=answered,
                    failures=len(probes) - answered, lost=lost,
                    max_latency_ms=round(max(lat), 3) if lat else None,
                    latency_budget_ms=latency_budget_ms,
                    host_request_failures_delta=failures_delta)
        passed = (len(probes) > 0 and answered == len(probes)
                  and lost == 0
                  and (failures_delta in (None, 0))
                  and (latency_budget_ms is None
                       or (lat and max(lat) <= latency_budget_ms)))
        event.update(gate=gate, passed=bool(passed))
        if passed:
            rolled = []
            for h in sorted(self.hosts.values(), key=lambda h: h.id):
                if h.id == canary_host.id:
                    continue
                try:
                    rolled.append(dict(host=h.id,
                                       tag=self._swap(h, new_ref)))
                except TransportError as e:
                    self.health.record_failure(h.id, e)
                    rolled.append(dict(host=h.id, error=str(e)))
            event.update(rolled=rolled, rolled_back=False)
            with self._lock:
                self.rollouts += 1
        else:
            rb_ok = True
            try:
                rb_tag = self._swap(canary_host, rollback_ref)
            except TransportError as e:
                # the canary is STRANDED on the bad weights — that must
                # never read as an observed rollback (the gated
                # `rollbacks` counter only counts swaps that landed)
                self.health.record_failure(canary_host.id, e)
                rb_ok = False
                rb_tag = f'ROLLBACK FAILED: {e}'
            event.update(rolled=[], rolled_back=rb_ok,
                         rollback=dict(ref=dict(rollback_ref),
                                       tag=rb_tag, ok=rb_ok))
            with self._lock:
                if rb_ok:
                    self.rollbacks += 1
        with self._lock:
            self.rollout_events.append(event)
        if self.tracer is not None:
            self.tracer.end(
                span, status='passed' if passed else 'rolled_back')
        return event, probes

    def _scrape_sync(self, h: _HostHandle) -> Optional[dict]:
        try:
            res = h.transport.call('stats',
                                   timeout_s=self.heartbeat_timeout_s)
        except TransportError:
            return None
        if res.get('ok'):
            h.stats = res.get('stats') or {}
            h.last_ok_at = self.clock()
            if self.slo is not None:
                self.slo.fold(h.id, h.stats)
            return h.stats
        return None

    def scrape(self) -> int:
        """Synchronously scrape every host's stats ONCE (fold into the
        SLO aggregator when attached) — the end-of-run flush a smoke
        uses so the final `slo` record reflects the hosts' cumulative
        counters, not the last heartbeat's. Returns hosts scraped."""
        return sum(1 for h in self.hosts.values()
                   if self._scrape_sync(h) is not None)

    def _wait_for(self, probes: Sequence[PendingResult],
                  timeout_s: float = 120.0):
        t0 = time.monotonic()
        while any(not p.done for p in probes):
            if time.monotonic() - t0 > timeout_s:
                break
            time.sleep(0.005)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def drain(self) -> None:
        """Barrier: every dispatch/probe/heartbeat the fleet started
        has finished (each resolves its own request structurally, so
        after drain() the caller's pendings are all done-or-failed)."""
        while True:
            with self._lock:
                futures, self._futures = self._futures, []
            if not futures:
                return
            for f in futures:
                f.exception()   # _dispatch resolves internally; a bug
                #                 surfacing here must not wedge drain

    def close(self) -> None:
        self.drain()
        self._executor.shutdown(wait=True)

    def __enter__(self) -> 'FleetRouter':
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # ------------------------------------------------------------------ #
    # the `fleet` record
    # ------------------------------------------------------------------ #
    def record_body(self, pending: Optional[Sequence[PendingResult]] = None,
                    label: str = 'fleet') -> dict:
        """Assemble the schema'd `fleet` record body (the caller logs
        it: `logger.log_record('fleet', **body)`): per-host breaker
        snapshots + last scraped signals, the merged host-transition
        log, cross-host retry / failure / heartbeat counters, rollout
        and rollback evidence, and the load-bearing fleet-wide
        `lost_requests` over the caller's submitted `pending` list
        (None limits lost accounting to what the fleet can see, i.e.
        0 — pass the real list)."""
        pending = list(pending or [])
        # per-host transport counters (only transports that expose
        # them — BinaryTransport and SocketTransport do, the wire-free
        # LocalTransport has nothing to count), aggregated fleet-wide:
        # sums for the monotonic counters, max for the peak gauge
        tstats = {}
        for hid, h in sorted(self.hosts.items()):
            snap = getattr(h.transport, 'transport_stats', None)
            if callable(snap):
                tstats[str(hid)] = snap()
        transport_section = None
        if tstats:
            transport_section = {
                k: sum(s.get(k, 0) for s in tstats.values())
                for k in ('connections_opened', 'reconnects',
                          'bytes_sent', 'bytes_received',
                          'frame_errors')}
            transport_section['peak_in_flight'] = max(
                s.get('peak_in_flight', 0) for s in tstats.values())
            transport_section['by_host'] = tstats
        hsnap = self.health.snapshot()
        hosts = {}
        for hid, h in sorted(self.hosts.items()):
            entry = dict(hsnap[str(hid)])
            entry['outstanding'] = h.outstanding
            if h.stats:
                entry['stats'] = {
                    k: h.stats.get(k)
                    for k in ('queue_depth', 'served', 'batches',
                              'request_failures', 'retries', 'timeouts',
                              'precision_mixes', 'model_families',
                              'swaps', 'post_warmup_compiles', 'device',
                              'launches', 'routed', 'peak_bytes')
                    if k in h.stats}
            if h.last_error:
                entry['last_error'] = h.last_error
            hosts[str(hid)] = entry
        transitions = [dict(e, host=e['replica'])
                       for e in self.health.transitions]
        with self._lock:
            body = dict(
                label=label,
                hosts=hosts,
                host_transitions=transitions,
                recoveries=self.health.recoveries,
                cross_host_retries=self.cross_host_retries,
                request_failures=self.request_failures,
                timeouts=self.timeouts,
                heartbeats=dict(ok=self.heartbeats_ok,
                                failed=self.heartbeats_failed,
                                stale_marks=self.stale_marks),
                rollouts=dict(count=len(self.rollout_events),
                              completed=self.rollouts,
                              events=list(self.rollout_events)),
                rollbacks=self.rollbacks,
                host_swaps=list(self.host_swaps),
                submitted=self.submitted,
                answered=self.answered,
                resolved=sum(1 for p in pending if p.done),
                structured_failures=sum(
                    1 for p in pending
                    if p.done and p.error is not None),
                lost_requests=sum(1 for p in pending if not p.done),
            )
        if transport_section is not None:
            body['transport'] = transport_section
        return body
