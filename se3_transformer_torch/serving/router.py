"""Continuous-batching router over N replica workers: the port of
se3_transformer_tpu/serving/router.py.

Placement, with an injectable clock:

  * continuous admission: `submit` places a request straight into the
    chosen replica's in-flight bucket slot (`ContinuousBatcher`); a full
    slot dispatches inside `submit`, and `pump` flushes by deadline only
    the slots that never fill;
  * least-outstanding dispatch: among the replicas not draining, the one
    with the fewest unanswered requests wins (ties to the lowest id, so a
    one-replica router is exactly its batcher);
  * rolling weight swaps: `swap_weights` walks the replicas one at a time
    (out of rotation, drain, copy the new state, back in) while the
    others serve, so a checkpoint reload (`swap_from_checkpoint`) drops
    no request.

The single-host fault domain:

  * replica health (`serving.health`): every dispatch outcome feeds a
    per-replica breaker (healthy -> degraded -> quarantined); quarantined
    replicas leave the rotation and come back through exponential-backoff
    half-open probe traffic;
  * bounded retry with redispatch: a failed batch's requests are taken
    over (never resolved with the raw error, never dropped) and
    redispatched onto siblings at the next `pump()`; once `max_retries`
    redispatches have failed, a request resolves with a structured
    `RequestFailed('retries_exhausted')`. `_fail_request` is the one place
    a request is failed for good;
  * deadlines: `submit(..., timeout_s=)` (or the router's
    `default_timeout_s`) stamps `submitted_at + timeout_s` on the
    request; an expired request is shed before dispatch and resolves with
    `RequestFailed('deadline')`.

Shedding goes through the port's `AdmissionController`: oversize and
overload rejections raise `RequestRejected` before any engine runs, and
the router wires its queue-depth x per-bucket-p50 estimate in as the
controller's `retry_hint`, so overload sheds carry `retry_after_s`.

Replicas on one card must not share weights: the constructor refuses two
engines whose parameters share storage (a rolling swap of one would
change the other mid-stream). With `async_dispatch=True` workers a filled
slot runs on its replica's own executor thread and CUDA stream; `drain`
and `swap_weights` wait per replica, and `close()` (or leaving the `with`
block, error paths included) shuts the executors down.

`id_prefix` names the request ids of a router whose records merge with
other hosts' (serving.fleet.HostServer sets it); `attach_tracer` wires one
span recorder (observability.tracing) through the router and every
replica's batcher: `admit` and `retry` spans here, `batch_fill` and the
dispatch spans below, for the requests whose `submit(..., trace=)`
carries a context (an untraced request records nothing).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..inference.admission import (
    AdmissionController, RequestFailed, deadline_error, fit_bucket,
    oversize_error, retries_exhausted_error,
)
from ..inference.batching import PendingResult
from .health import QUARANTINED, HealthConfig, HealthMonitor
from .replica import ReplicaWorker


def _shared_storages(workers) -> List[tuple]:
    """(replica a, replica b) for every pair of workers whose engines hold
    a parameter in the same storage (engines without a torch module are
    skipped)."""
    owner = {}
    pairs = []
    for w in workers:
        module = getattr(w.engine, 'module', None)
        if not isinstance(module, torch.nn.Module):
            continue
        seen = set()
        for p in module.parameters():
            if p.numel() == 0:
                continue
            key = (p.device, p.untyped_storage().data_ptr())
            if key in seen:
                continue
            seen.add(key)
            other = owner.setdefault(key, w.id)
            if other != w.id and (other, w.id) not in pairs:
                pairs.append((other, w.id))
    return pairs


class Router:
    """Admission, placement, fault domain and lifecycle over replicas.

        workers = [ReplicaWorker(i, engine_i) for i ...]
        with Router(workers, admission=ctl, max_retries=2,
                    default_timeout_s=30.0) as router:
            pending = router.submit(tokens, coords)   # may raise
            router.pump()             # deadlines, retries, probes
            router.swap_weights(new_state)            # rolling swap
            router.drain()                            # end of stream
        # __exit__ -> close(): executors shut down, error paths included
    """

    def __init__(self, workers: Sequence[ReplicaWorker],
                 admission: Optional[AdmissionController] = None,
                 clock: Callable[[], float] = time.monotonic,
                 health: Optional[HealthConfig] = None,
                 max_retries: int = 1,
                 default_timeout_s: Optional[float] = None):
        self.workers: List[ReplicaWorker] = list(workers)
        assert self.workers, 'a router needs at least one replica'
        buckets = {w.engine.buckets for w in self.workers}
        assert len(buckets) == 1, \
            f'replicas disagree on buckets: {sorted(buckets)}: the ' \
            f'router routes by bucket, so every replica must warm the ' \
            f'same set'
        shared = _shared_storages(self.workers)
        if shared:
            raise ValueError(
                f'replicas {shared} hold parameters in the same storage: '
                f'a weight swap or a quantization of one would change the '
                f'other; give each replica its own module (a deep copy '
                f'made before quantization and placement)')
        self.buckets = self.workers[0].engine.buckets
        self.admission = admission
        self.clock = clock
        self._next_id = 0
        # request-id namespace: ids are monotonic ints per router and
        # collide once several routers' streams merge; a host sets a prefix
        # and ids become strings like 'h1-17'
        self.id_prefix: Optional[str] = None
        # request tracing: attach_tracer hands it to every replica's
        # batcher, so that one host records into one Tracer
        self.tracer = None
        self.swap_events: List[dict] = []
        # ---- fault domain -------------------------------------------- #
        self.health = HealthMonitor([w.id for w in self.workers],
                                    config=health, clock=clock)
        self.max_retries = int(max_retries)
        assert self.max_retries >= 0
        self.default_timeout_s = default_timeout_s
        self.retries = 0            # redispatches performed
        self.request_failures = 0   # structured terminal failures
        self._retry_timeouts = 0    # deadline failures from the queue
        # a failed batch's requests land here (from the dispatch hooks,
        # possibly on an executor thread) and are redispatched or failed
        # by the next pump()/drain() on the serve loop's thread, so a retry
        # never touches a sibling's batcher from another thread
        self._retry_lock = threading.Lock()
        self._retry_queue: List[tuple] = []
        self._failed: List[PendingResult] = []   # for pop_completed
        self._failed_capacity = 65536
        for w in self.workers:
            w.batcher.on_success = self._success_hook(w.id)
            w.batcher.on_failure = self._failure_hook(w.id)
            # deadline failures inside the batcher carry the same
            # retry_after_s hint that _fail_request stamps
            w.batcher.retry_hint = self.retry_after_hint
        if admission is not None and admission.retry_hint is None:
            admission.retry_hint = self.retry_after_hint

    # ------------------------------------------------------------------ #
    @property
    def queue_depth(self) -> int:
        with self._retry_lock:
            retrying = len(self._retry_queue)
        return sum(w.outstanding for w in self.workers) + retrying

    @property
    def depth_by_bucket(self) -> dict:
        """Open-slot depth per bucket across the replicas."""
        depths = {b: 0 for b in self.buckets}
        for w in self.workers:
            for b, n in w.batcher.depth_by_bucket.items():
                depths[b] = depths.get(b, 0) + n
        return depths

    @property
    def continuous_admissions(self) -> int:
        return sum(w.batcher.continuous_admissions for w in self.workers)

    @property
    def deadline_flushes(self) -> int:
        return sum(w.batcher.deadline_flushes for w in self.workers)

    @property
    def batches_dispatched(self) -> int:
        return sum(w.batcher.batches_dispatched for w in self.workers)

    @property
    def timeouts(self) -> int:
        """Requests resolved RequestFailed('deadline') anywhere: shed or
        expired in a slot, or expired on the retry queue."""
        return sum(w.batcher.timeouts
                   for w in self.workers) + self._retry_timeouts

    @property
    def deadline_sheds(self) -> int:
        return sum(w.batcher.deadline_sheds for w in self.workers)

    @property
    def max_len(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, length: int) -> Optional[int]:
        return fit_bucket(self.buckets, length)

    def attach_tracer(self, tracer) -> None:
        """Wire one span recorder through the router and every replica's
        batcher, so that `pop_trace` can ship a request's whole host-side
        story back in its RPC response."""
        self.tracer = tracer
        for w in self.workers:
            w.batcher.tracer = tracer

    def retry_after_hint(self, queue_depth: int) -> float:
        """Backoff hint: queue depth x the per-request drain estimate (the
        mean per-bucket p50 of the shared timer over the batch size);
        50 ms a request before any latency sample exists."""
        per_row_s = 0.05
        timer = getattr(self.workers[0].engine, 'timer', None)
        if timer is not None:
            summary = timer.cumulative_summary()
            p50s = [v.get('p50_ms') for k, v in summary.items()
                    if k.startswith('bucket_') and v.get('p50_ms')]
            if p50s:
                batch = max(1, self.workers[0].engine.batch_size)
                per_row_s = (sum(p50s) / len(p50s)) / 1e3 / batch
        return max(1, int(queue_depth)) * per_row_s

    # ------------------------------------------------------------------ #
    # the fault-domain hooks and the retry queue
    # ------------------------------------------------------------------ #
    def _success_hook(self, replica_id: int):
        def hook(rows: int):
            self.health.record_success(replica_id)
        return hook

    def _failure_hook(self, replica_id: int):
        def hook(bucket, tokens, coords, pending, exc) -> bool:
            self.health.record_failure(replica_id, exc)
            with self._retry_lock:
                for p, t, c in zip(pending, tokens, coords):
                    self._retry_queue.append((p, t, c, replica_id, exc))
            return True   # taken over: redispatch or fail structurally
        return hook

    def _fail_request(self, pending: PendingResult,
                      error: RequestFailed) -> None:
        """Terminal structured resolution: the one place the
        zero-lost-requests contract rides (the chaos harness's weakened arm
        replaces exactly this to show that its gate fires). Every terminal
        failure carries the `retry_after_s` hint that overload sheds
        carry."""
        if isinstance(error, RequestFailed) and \
                'retry_after_s' not in error.detail:
            error.detail['retry_after_s'] = round(
                max(0.0, self.retry_after_hint(self.queue_depth)), 4)
        pending.error = error
        pending.done = True
        pending.completed_at = self.clock()
        self.request_failures += 1
        self._failed.append(pending)
        if len(self._failed) > self._failed_capacity:
            del self._failed[:-self._failed_capacity]

    def process_failures(self, now: Optional[float] = None) -> int:
        """Drain the retry queue: redispatch each failed request onto a
        sibling (its attempts and deadline permitting) or resolve it with a
        structured RequestFailed. Returns the requests redispatched. Runs
        on the serve loop's thread (from pump / drain)."""
        with self._retry_lock:
            drained, self._retry_queue = self._retry_queue, []
        if not drained:
            return 0
        now = self.clock() if now is None else now
        redispatched = 0
        for p, tokens, coords, failed_on, exc in drained:
            p.attempts += 1
            if p.expired(now):
                timeout_s = ((p.deadline - p.submitted_at)
                             if p.deadline is not None else 0.0)
                self._retry_timeouts += 1
                self._fail_request(p, deadline_error(
                    now - p.submitted_at, timeout_s, attempts=p.attempts))
            elif p.attempts > self.max_retries:
                self._fail_request(
                    p, retries_exhausted_error(p.attempts, exc))
            else:
                self.retries += 1
                worker = self._pick_worker(exclude=failed_on)
                tr = getattr(p, 'trace', None)
                if self.tracer is not None and tr:
                    self.tracer.add(tr['ctx'], 'retry',
                                    parent_id=tr['parent'],
                                    failed_on=failed_on,
                                    replica=worker.id,
                                    attempt=p.attempts)
                worker.admit(p.bucket, tokens, coords, p)
                redispatched += 1
        return redispatched

    # ------------------------------------------------------------------ #
    def _pick_worker(self, exclude: Optional[int] = None) -> ReplicaWorker:
        """Health-aware least-outstanding placement.

        1. A quarantined replica whose probe backoff has elapsed gets this
           request (half-open: one until its outcome lands).
        2. Else the least outstanding of the replicas neither draining nor
           quarantined (degraded after healthy at equal depth, ties to the
           lowest id).
        3. Last resort (every live replica quarantined): the least
           outstanding of all live replicas: a sick replica beats
           dropping the request.

        `exclude` (a replica id) steers a retry away from the replica that
        just failed whenever a sibling exists.
        """
        live = [w for w in self.workers if not w.draining]
        assert live, 'every replica is draining: rolling swaps take one ' \
                     'replica out at a time, so this is a bug'
        now = self.clock()
        for w in live:
            # the check and the claim under the monitor's lock, so that a
            # concurrent picker cannot book the half-open slot twice
            if w.id != exclude and self.health.try_begin_probe(w.id, now):
                return w

        def rank(w):
            state = self.health.state(w.id)
            return (w.outstanding, 0 if state == 'healthy' else 1, w.id)

        routable = [w for w in live
                    if self.health.state(w.id) != QUARANTINED
                    and w.id != exclude]
        if not routable:
            routable = [w for w in live if w.id != exclude] or live
        return min(routable, key=rank)

    def submit(self, tokens, coords,
               timeout_s: Optional[float] = None,
               trace: Optional[dict] = None) -> PendingResult:
        """Admit and place one request; its slot dispatches when it fills.

        Raises RequestRejected (oversize / overloaded) before any engine
        runs; the bucket fit is checked before admission accounting (the
        MicroBatcher's contract). `timeout_s` (default: the router's
        `default_timeout_s`) stamps the request's deadline: it then either
        answers in time or resolves with RequestFailed('deadline').

        `trace` is an incoming trace context (`{'trace': <id>, 'parent':
        <span id>}`, the fleet RPC payload's `trace`): with a tracer
        attached, an `admit` span lands under the caller's parent and every
        later span of the request hangs under it."""
        tokens = np.asarray(tokens)
        length = len(tokens)
        bucket = self.bucket_for(length)
        if bucket is None:
            if self.admission is not None:
                self.admission.reject_oversize(length, self.buckets[-1])
            raise oversize_error(length, self.buckets[-1])
        if self.admission is not None:
            self.admission.admit(length, queue_depth=self.queue_depth)
        worker = self._pick_worker()
        submitted_at = self.clock()
        timeout_s = (timeout_s if timeout_s is not None
                     else self.default_timeout_s)
        deadline = (submitted_at + float(timeout_s)
                    if timeout_s is not None else None)
        rid = (self._next_id if self.id_prefix is None
               else f'{self.id_prefix}-{self._next_id}')
        pending = PendingResult(rid, length, bucket,
                                submitted_at, deadline=deadline)
        self._next_id += 1
        if self.tracer is not None and trace and trace.get('trace'):
            admit = self.tracer.add(trace['trace'], 'admit',
                                    parent_id=trace.get('parent'),
                                    ts=submitted_at, rid=rid,
                                    bucket=int(bucket),
                                    replica=worker.id)
            pending.trace = dict(ctx=trace['trace'],
                                 parent=admit['span'])
        worker.admit(bucket, tokens, coords, pending)
        return pending

    def pump(self, now: Optional[float] = None) -> int:
        """The fault domain's heartbeat: redispatch or fail the queued
        retries, expire deadlines, then flush every slot whose oldest
        request hit `max_wait_ms`. Returns the batches the flush
        dispatched."""
        now = self.clock() if now is None else now
        self.process_failures(now)
        return sum(w.flush_due(now) for w in self.workers)

    def next_deadline(self, now: Optional[float] = None) -> Optional[float]:
        """Sleep hint: seconds until the earliest fallback deadline."""
        now = self.clock() if now is None else now
        deadlines = [d for d in (w.batcher.next_deadline(now)
                                 for w in self.workers) if d is not None]
        return min(deadlines) if deadlines else None

    def drain(self) -> int:
        """Dispatch every partial slot on every replica (end of stream),
        wait for the async dispatches and settle the retry queue: once it
        returns, everything admitted has answered or failed structurally.
        Returns the batches dispatched. It ends: every redispatch adds one
        to the request's `attempts`, so a request bounces at most
        `max_retries` times, within the `max_retries + 2` rounds."""
        total = 0
        for _ in range(self.max_retries + 2):
            total += sum(w.drain() for w in self.workers)
            if not self.process_failures():
                with self._retry_lock:
                    settled = not self._retry_queue
                if settled and not any(w.batcher.depth
                                       for w in self.workers):
                    break
        return total

    def close(self) -> None:
        """Drain, then shut the replicas' executors down (idempotent)."""
        self.drain()
        for w in self.workers:
            w.close()

    def __enter__(self) -> 'Router':
        return self

    def __exit__(self, exc_type, exc, tb):
        # the executors shut down on error paths too
        self.close()
        return False

    def pop_completed(self) -> List[PendingResult]:
        done: List[PendingResult] = []
        for w in self.workers:
            done += w.batcher.pop_completed()
        done += self._failed
        self._failed = []
        return done

    # ------------------------------------------------------------------ #
    def swap_weights(self, params, tag: Optional[str] = None) -> List[dict]:
        """Rolling weight swap: one replica at a time drains and takes
        `params` (a state dict) while the others serve. Returns the swap
        events (also kept in `swap_events` for telemetry)."""
        events = []
        for w in self.workers:
            event = w.swap_weights(params)
            event['t'] = round(self.clock(), 3)
            if tag is not None:
                event['tag'] = tag
            self.swap_events.append(event)
            events.append(event)
            # a drain can leave failed requests on the retry queue while
            # this replica is out of rotation: settle them now
            self.process_failures()
        return events

    def swap_from_checkpoint(self, directory: str,
                             step: Optional[int] = None) -> List[dict]:
        """Reload the latest (or a named) training checkpoint into every
        replica: the params-only restore (`CheckpointManager.
        restore_params`, which falls back past a torn latest step to the
        newest valid one), then the rolling swap. The tag names the step
        restored, so a fallback shows in the swap events."""
        from ..training.checkpoint import CheckpointManager
        mgr = CheckpointManager(directory)
        params = mgr.restore_params(step)
        restored = (step if step is not None
                    else mgr.last_restored_step)
        tag = f'{directory}@{restored if restored is not None else "latest"}'
        return self.swap_weights(params, tag=tag)
