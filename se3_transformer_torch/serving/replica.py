"""Replica worker: one engine and its in-flight bucket slots. The port of
se3_transformer_tpu/serving/replica.py.

The `MicroBatcher` queues requests per bucket and flushes on batch-full or
on a deadline, so a drain is a barrier over every queue. Continuous
batching turns that around: each bucket owns an open slot (a partially
filled, in-flight batch) that requests are admitted into at any time; a
slot dispatches the moment it fills, inside `admit` itself, and the
deadline is only the fallback for slots that never fill (counted apart:
`deadline_flushes` stays near zero on a loaded replica while
`continuous_admissions` grows).

`ReplicaWorker` pairs a `ContinuousBatcher` with the `InferenceEngine` that
runs its slots, and owns the replica's lifecycle verbs that the router
composes: `drain()` (dispatch every partial slot and wait for it) and
`swap_weights()` (drain, then copy the new state into the engine's placed
tensors: nothing is rebuilt and nothing is warmed again).

Several replicas on one card. JAX runs one replica per chip; here the
replicas may share the one card, and each must then own its weights and
its stream:

  * every replica holds its own module (the router refuses two engines
    whose parameters share storage: a swap of one would change the
    other);
  * with `async_dispatch=True` each worker owns a single-thread executor
    and, on a card, one `torch.cuda.Stream`: every dispatch runs in that
    thread under that stream (the placement, the forward, the copy of the
    answer to the host), and the engine's bucket phase ends in that
    stream's synchronize alone, so a replica's latency leaves out its
    sibling's work;
  * `swap_weights` copies the new state on the replica's stream after the
    drain and waits for that stream, so its next forward reads the new
    weights;
  * warm the replicas one after another, before any serves: an engine's
    warmup resets the card's peak-memory counter and drops the
    process-wide kernel-pick memo (kernels.tuning), which a sibling
    serving at the same time would see.

JAX's request tracing (the batcher's `tracer`, its `batch_fill` span)
comes with ROADMAP A8.2.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..inference.admission import deadline_error
from ..inference.batching import PendingResult, _host, dispatch_batch


class _Slot:
    """One in-flight bucket batch, open for admission until full.
    (Deadlines key off each request's own `submitted_at`: a slot carries no
    clock state.)"""

    __slots__ = ('bucket', 'tokens', 'coords', 'pending')

    def __init__(self, bucket: int):
        self.bucket = bucket
        self.tokens: List[np.ndarray] = []
        self.coords: List[np.ndarray] = []
        self.pending: List[PendingResult] = []

    def __len__(self):
        return len(self.pending)


class ContinuousBatcher:
    """Admit requests into partially filled in-flight bucket slots.

        cb = ContinuousBatcher(engine.run, engine.buckets,
                               engine.batch_size, max_wait_ms=50.0)
        cb.admit(bucket, tokens, coords, pending)  # dispatches on fill
        cb.flush_due()                             # the deadline fallback
        cb.drain()                                 # shutdown / swap

    A slot that fills dispatches inside `admit` (`continuous_admissions`
    counts every request that joined an already open slot), and
    `flush_due` exists only so that a trickle of requests that never fills
    a slot still answers within `max_wait_ms`. The runner contract and the
    error semantics are the `MicroBatcher`'s: both go through
    `inference.batching.dispatch_batch`.

    With `executor` set (the `async_dispatch=True` worker), a filled slot
    submits its dispatch to that executor instead of running it in the
    admit caller. A raising runner still resolves its batch done-with-error
    (inside dispatch_batch, on the executor's thread), but the exception
    re-raises at the next `wait()` (drain / swap / close) rather than in
    admit; `inflight` counts the requests submitted but not yet answered,
    so the router's least-outstanding signal keeps seeing them.
    """

    def __init__(self, runner: Callable, buckets: Sequence[int],
                 batch_size: int, max_wait_ms: float = 50.0,
                 clock: Callable[[], float] = time.monotonic,
                 executor: Optional[ThreadPoolExecutor] = None):
        self.runner = runner
        self.buckets = tuple(sorted(int(b) for b in buckets))
        assert self.buckets, 'no buckets'
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.clock = clock
        self.executor = executor
        self._slots: Dict[int, _Slot] = {}
        self.continuous_admissions = 0   # joined an in-flight slot
        self.deadline_flushes = 0        # fallback dispatches
        self.batches_dispatched = 0
        self.rows_dispatched = 0         # real (non-dummy) rows
        # the router's hooks (None: the batcher alone): on_success(rows)
        # feeds the health breaker; on_failure(bucket, tokens, coords,
        # pending, exc) -> True takes a failed batch's requests over for
        # retry with redispatch
        self.on_success: Optional[Callable[[int], None]] = None
        self.on_failure: Optional[Callable] = None
        # retry_hint(queue_depth) -> seconds: when set (the router points
        # it at its retry_after_hint), deadline failures carry the same
        # retry_after_s hint that overload sheds do
        self.retry_hint: Optional[Callable[[int], float]] = None
        # requests resolved with RequestFailed('deadline'): shed at
        # dispatch time (deadline_sheds) or expired in an open slot
        self.timeouts = 0
        self.deadline_sheds = 0
        # resolved results, drained by telemetry through pop_completed()
        # (bounded: each submitter holds its own PendingResult)
        self.completed: List[PendingResult] = []
        self._completed_capacity = 65536
        # async dispatch bookkeeping (unused on the sync path)
        self._futures: List[Future] = []
        self._inflight_rows = 0
        self._inflight_lock = threading.Lock()
        # the executor's thread publishes into `completed` while the serve
        # loop's pop_completed swaps it: every access takes this lock (a
        # dispatch resolves into a private list first)
        self._completed_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    @property
    def depth(self) -> int:
        """Requests in open slots (not yet dispatched)."""
        return sum(len(s) for s in self._slots.values())

    @property
    def depth_by_bucket(self) -> Dict[int, int]:
        """Open-slot depth per bucket."""
        return {s.bucket: len(s) for s in self._slots.values() if len(s)}

    @property
    def inflight(self) -> int:
        """Requests submitted to the executor but not yet answered (0 on
        the sync path: a dispatch completes inline)."""
        with self._inflight_lock:
            return self._inflight_rows

    def admit(self, bucket: int, tokens, coords,
              pending: PendingResult) -> PendingResult:
        """Admit one request into its bucket's in-flight slot; the slot
        dispatches at once when it fills."""
        assert bucket in self.buckets, f'{bucket} is not a configured bucket'
        slot = self._slots.get(bucket)
        if slot is None:
            slot = self._slots[bucket] = _Slot(bucket)
        elif slot.pending:
            self.continuous_admissions += 1
        slot.tokens.append(np.asarray(tokens))
        slot.coords.append(np.asarray(coords, np.float32).reshape(-1, 3))
        slot.pending.append(pending)
        if len(slot) >= self.batch_size:
            self._dispatch(slot)
        return pending

    def flush_due(self, now: Optional[float] = None) -> int:
        """The deadline fallback: dispatch every slot whose oldest request
        has waited `max_wait_ms`. Returns the batches dispatched. Requests
        past their own deadline are resolved with a structured timeout
        first: they never take a batch row."""
        now = self.clock() if now is None else now
        self.expire_due(now)
        n = 0
        for slot in list(self._slots.values()):
            if slot.pending and \
                    now - slot.pending[0].submitted_at >= self.max_wait_s:
                self._dispatch(slot)
                self.deadline_flushes += 1
                n += 1
        return n

    def expire_due(self, now: Optional[float] = None) -> int:
        """Resolve every open-slot request whose own deadline
        (`PendingResult.deadline`) has passed with a structured
        `RequestFailed('deadline')`. Returns the requests expired."""
        now = self.clock() if now is None else now
        n = 0
        for slot in list(self._slots.values()):
            n += self._shed_expired(slot, now)
            if not slot.pending:
                self._slots.pop(slot.bucket, None)
        return n

    def _shed_expired(self, slot: _Slot, now: float) -> int:
        """The expired-request filter that expire_due and the
        shed-before-dispatch share: drop the expired requests from the
        slot and resolve them with a structured timeout. Returns how many
        were shed."""
        keep = [i for i, p in enumerate(slot.pending)
                if not p.expired(now)]
        if len(keep) == len(slot.pending):
            return 0
        expired = [p for p in slot.pending if p.expired(now)]
        slot.tokens = [slot.tokens[i] for i in keep]
        slot.coords = [slot.coords[i] for i in keep]
        slot.pending = [slot.pending[i] for i in keep]
        self._resolve_failed(expired, now=now)
        return len(expired)

    def _resolve_failed(self, expired: Sequence[PendingResult],
                        now: Optional[float] = None) -> None:
        """Resolve timed-out requests done-with-structured-error and
        publish them to `completed` (telemetry sees the sheds too)."""
        now = self.clock() if now is None else now
        hint = None
        if self.retry_hint is not None:
            try:
                hint = max(0.0, float(self.retry_hint(self.depth)))
            except Exception:   # noqa: BLE001 - the timeout stays structured
                hint = None
        for p in expired:
            timeout_s = ((p.deadline - p.submitted_at)
                         if p.deadline is not None else 0.0)
            p.error = deadline_error(now - p.submitted_at, timeout_s,
                                     attempts=p.attempts,
                                     retry_after_s=hint)
            p.done = True
            p.completed_at = now
            self.timeouts += 1
        with self._completed_lock:
            self.completed.extend(expired)
            if len(self.completed) > self._completed_capacity:
                del self.completed[:-self._completed_capacity]

    def drain(self) -> int:
        """Dispatch every non-empty slot (shutdown / weight swap)."""
        n = 0
        for slot in list(self._slots.values()):
            if slot.pending:
                self._dispatch(slot)
                n += 1
        return n

    def next_deadline(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the earliest fallback deadline; None when idle."""
        oldest = [s.pending[0].submitted_at
                  for s in self._slots.values() if s.pending]
        if not oldest:
            return None
        now = self.clock() if now is None else now
        return max(0.0, min(oldest) + self.max_wait_s - now)

    def pop_completed(self) -> List[PendingResult]:
        with self._completed_lock:
            done, self.completed = self.completed, []
        return done

    def wait(self) -> None:
        """Wait for every async dispatch in flight; re-raises the first
        runner exception (its requests were already resolved
        done-with-error, or taken over by the router). No-op on the sync
        path."""
        futures, self._futures = self._futures, []
        first_err = None
        for f in futures:
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    # ------------------------------------------------------------------ #
    def _dispatch(self, slot: _Slot):
        # the slot closes as it dispatches; the next admit for this bucket
        # opens a fresh one
        self._slots.pop(slot.bucket, None)
        # shed before dispatch: an expired request must not ride (or pad
        # out) a batch whose answer it can no longer use
        self.deadline_sheds += self._shed_expired(slot, self.clock())
        if not slot.pending:
            return
        pending = slot.pending

        def run():
            # dispatch_batch resolves into a private list; the shared
            # `completed` is touched under the lock only
            done_local: List[PendingResult] = []
            try:
                dispatch_batch(self.runner, slot.bucket, self.batch_size,
                               slot.tokens, slot.coords, pending,
                               done_local, self._completed_capacity,
                               self.clock, on_success=self.on_success,
                               on_failure=self.on_failure)
            finally:
                with self._completed_lock:
                    self.completed.extend(done_local)
                    if len(self.completed) > self._completed_capacity:
                        del self.completed[:-self._completed_capacity]
        self.batches_dispatched += 1
        self.rows_dispatched += len(pending)
        if self.executor is None:
            run()
            return
        with self._inflight_lock:
            self._inflight_rows += len(pending)
        # drop the futures that finished cleanly so the list stays bounded;
        # failed ones stay until wait() re-raises them
        self._futures = [f for f in self._futures
                         if not f.done() or f.exception() is not None]

        def tracked():
            try:
                run()
            finally:
                with self._inflight_lock:
                    self._inflight_rows -= len(pending)

        self._futures.append(self.executor.submit(tracked))


def _card(engine) -> Optional[torch.device]:
    """The engine's device when it is a CUDA card, else None."""
    device = getattr(engine, 'device', None)
    if device is None:
        return None
    device = torch.device(device)
    return device if device.type == 'cuda' else None


class ReplicaWorker:
    """One serving replica: an engine and its continuous batcher.

        worker = ReplicaWorker(0, engine, max_wait_ms=50.0)
        worker.admit(bucket, tokens, coords, pending)
        worker.swap_weights(new_state)     # drain, copy, nothing dropped

    `outstanding` (admitted but unanswered) is the router's
    least-outstanding load signal; `draining=True` takes the replica out
    of rotation while a swap is in flight.

    `async_dispatch=True` gives the replica a single-thread executor (and
    on a card its own CUDA stream, `stream`) through which every slot
    dispatch runs: the router's submit loop never waits for a forward, and
    the replicas' forwards overlap. One thread per replica keeps each
    engine's forwards in order among themselves. `drain()` and
    `swap_weights()` wait for the executor, so the rolling-swap contract
    (the old weights answer everything already admitted) holds; runner
    errors surface there instead of in admit (ContinuousBatcher.wait).

    `fault_injector` (faults.FaultInjector) fires the `replica_dispatch`
    site (ctx: replica, bucket) before each engine run, so that an
    injected exception walks the path a real engine failure walks.
    """

    def __init__(self, replica_id: int, engine, *,
                 max_wait_ms: float = 50.0,
                 clock: Callable[[], float] = time.monotonic,
                 async_dispatch: bool = False,
                 fault_injector=None):
        self.id = int(replica_id)
        self.engine = engine
        self.executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f'replica{self.id}') \
            if async_dispatch else None
        card = _card(engine)
        self.stream = torch.cuda.Stream(card) \
            if async_dispatch and card is not None else None
        self.fault_injector = fault_injector
        self.batcher = ContinuousBatcher(
            self._run, engine.buckets, engine.batch_size,
            max_wait_ms=max_wait_ms, clock=clock,
            executor=self.executor)
        self.draining = False
        self.swaps = 0

    def _run(self, bucket, tokens, coords, mask):
        """The batcher's runner: the fault site, then the engine's run (on
        the replica's stream, with the answer copied to the host there,
        when it has one)."""
        if self.fault_injector is not None:
            self.fault_injector.fire('replica_dispatch', replica=self.id,
                                     bucket=bucket)
        if self.stream is None:
            return self.engine.run(bucket, tokens, coords, mask)
        with torch.cuda.stream(self.stream):
            return _host(self.engine.run(bucket, tokens, coords, mask,
                                         stream=self.stream))

    # ------------------------------------------------------------------ #
    @property
    def outstanding(self) -> int:
        # open-slot depth and the async dispatches not yet answered
        return self.batcher.depth + self.batcher.inflight

    @property
    def served_rows(self) -> int:
        return int(sum(self.engine.rows_served.values()))

    def admit(self, bucket: int, tokens, coords,
              pending: PendingResult) -> PendingResult:
        assert not self.draining, \
            f'replica {self.id} is draining: the router must not ' \
            f'admit into it'
        return self.batcher.admit(bucket, tokens, coords, pending)

    def flush_due(self, now=None) -> int:
        return self.batcher.flush_due(now)

    def drain(self) -> int:
        """Dispatch every partial slot and wait for the async dispatches:
        once it returns, everything admitted has answered."""
        n = self.batcher.drain()
        self.batcher.wait()
        return n

    def swap_weights(self, params) -> dict:
        """Drain (the old weights answer everything already admitted),
        then copy `params` into the engine's placed tensors: on the
        replica's stream when it has one, waited for before the replica
        serves again. Returns the swap event for the telemetry stream."""
        self.draining = True
        try:
            drained = self.drain()
            if self.stream is None:
                self.engine.params = params
            else:
                with torch.cuda.stream(self.stream):
                    self.engine.params = params
                self.stream.synchronize()
        finally:
            self.draining = False
        self.swaps += 1
        return dict(replica=self.id, drained_batches=drained,
                    swap_index=self.swaps)

    def close(self) -> None:
        """Shut the executor down (idempotent; no-op for a sync replica)."""
        if self.executor is not None:
            self.executor.shutdown(wait=True)

    def snapshot(self) -> dict:
        """Per-replica counters for the serve record; `precision` and
        `model_family` say which replica served which mix and family."""
        return dict(depth=self.batcher.depth,
                    precision=getattr(self.engine, 'precision_name',
                                      'fp32'),
                    model_family=getattr(self.engine, 'model_family',
                                         'se3_v1'),
                    served=self.served_rows,
                    batches=self.batcher.batches_dispatched,
                    continuous_admissions=self.batcher.continuous_admissions,
                    deadline_flushes=self.batcher.deadline_flushes,
                    timeouts=self.batcher.timeouts,
                    deadline_sheds=self.batcher.deadline_sheds,
                    swaps=self.swaps,
                    draining=self.draining)
