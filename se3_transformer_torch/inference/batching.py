"""Micro-batching: variable-length requests -> fixed-shape bucket batches.
The port of se3_transformer_tpu/inference/batching.py.

A batch of B rows is one forward, so a lone request wastes the other
B - 1 rows, but waiting forever for a full batch destroys tail latency.
The `MicroBatcher` trades between them with two knobs:

  * flush-on-full: the moment a bucket's queue holds `batch_size`
    requests, the batch dispatches (throughput bound);
  * flush-on-deadline: `pump()` dispatches any bucket whose oldest
    request has waited `max_wait_ms`, padding the short batch with
    all-masked rows (latency bound).

Padding goes through `engine.pad_to_bucket`, the one function the engine
pads with, so a batch has exactly the shapes the engine warmed. The
batcher is synchronous and single-threaded: `submit()` enqueues and
returns a `PendingResult`, the serve loop calls `pump()` between accepts
and `drain()` at the end; the clock is injectable. A request is
integer tokens [n] (a num_tokens model) or features [n, d], with
coordinates [n, 3].

`dispatch_batch` is the dispatch body that the `MicroBatcher` and the
multi-replica `serving.ContinuousBatcher` share; its `on_success` /
`on_failure` hooks and `PendingResult`'s `deadline` / `attempts` are what
the router's health breakers, retries and deadlines ride on; its
`tracer` argument and `PendingResult.trace` carry request tracing
(observability.tracing): the queue_wait, dispatch and device_run spans of
every traced request.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .admission import AdmissionController, fit_bucket, oversize_error
from .engine import pad_to_bucket
from .stats import agg_update, agg_zero


class PendingResult:
    """Future-lite: filled in by the flush that dispatches the request.
    `done=True` with `error` set means the request terminally failed: its
    batch's runner raised (and any retry budget is spent), or its deadline
    expired while queued (`ok` tells them apart; the error is the runner's
    exception or a structured `RequestFailed`).

    `deadline` (absolute, on the clock of `submitted_at`; None: no
    timeout) carries the caller's `timeout_s` through every queue and
    redispatch; `attempts` counts the dispatches that failed under this
    request (the router's retry budget). `trace` is the request-tracing
    context (observability.tracing): the trace id and the parent span id
    the next tier hangs its spans under; None (the default) keeps every
    tracing site free."""

    __slots__ = ('request_id', 'length', 'bucket', 'result', 'done',
                 'error', 'submitted_at', 'completed_at', 'deadline',
                 'attempts', 'trace')

    def __init__(self, request_id, length: int, bucket: int,
                 submitted_at: float, deadline: Optional[float] = None,
                 trace: Optional[dict] = None):
        self.request_id = request_id
        self.length = length
        self.bucket = bucket
        self.result = None
        self.done = False
        self.error: Optional[BaseException] = None
        self.submitted_at = submitted_at
        self.completed_at: Optional[float] = None
        self.deadline = deadline
        self.attempts = 0
        self.trace = trace

    @property
    def ok(self) -> bool:
        return self.done and self.error is None

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


def _host(out) -> np.ndarray:
    """A runner's output as a host array (the engine returns a tensor on
    its device)."""
    if isinstance(out, torch.Tensor):
        return out.detach().float().cpu().numpy()
    return np.asarray(out)


def dispatch_batch(runner, bucket: int, batch_size: int, tokens, coords,
                   pending: List[PendingResult],
                   completed: List[PendingResult],
                   completed_capacity: int,
                   clock: Callable[[], float],
                   on_success: Optional[Callable[[int], None]] = None,
                   on_failure: Optional[Callable] = None,
                   tracer=None) -> None:
    """Pad, run, resolve: pads with `pad_to_bucket`, slices each result
    back to its request's true rows, and on a raising runner resolves
    every request of the batch done-with-error (no submitter waits
    forever) before re-raising.

    `on_success(rows)` and `on_failure(bucket, tokens, coords, pending,
    exc) -> bool` are the router's hooks: a success feeds the replica's
    health breaker; a failure handler that returns True takes ownership of
    the batch's requests (the router's retry queue redispatches or fails
    each one), and the function then neither resolves them nor re-raises.
    The hooks get the original per-request arrays, not the padded batch,
    so a redispatch pads again for its new slot.

    `tracer` (observability.tracing.Tracer, optional) records queue_wait,
    dispatch and device_run spans for every request that carries a trace
    context (`p.trace`); None keeps dispatch free of spans."""
    raw_tokens, raw_coords = list(tokens), list(coords)
    t_start = clock()
    tokens, coords, mask = pad_to_bucket(tokens, coords, bucket,
                                         batch_size=batch_size)
    t_run = clock()
    try:
        # a CUDA launch returns before its work is done: device_run ends
        # here, once _host has copied the answer to the host (its .cpu()
        # waits for the card), so the span times the forward, not its
        # launch
        out = _host(runner(bucket, tokens, coords, mask))
    except Exception as e:
        _trace_batch(tracer, bucket, pending, t_start, t_run, clock(),
                     error=type(e).__name__)
        if on_failure is not None and \
                on_failure(bucket, raw_tokens, raw_coords, pending, e):
            return      # taken over by the retry path
        now = clock()
        for p in pending:
            p.error = e
            p.done = True
            p.completed_at = now
            completed.append(p)
        if len(completed) > completed_capacity:
            del completed[:-completed_capacity]
        raise
    now = clock()
    _trace_batch(tracer, bucket, pending, t_start, t_run, now)
    for row, p in enumerate(pending):
        # a copy: a view would keep the whole [B, L, ...] output alive for
        # as long as any one request's result is held
        p.result = np.array(out[row, :p.length])
        p.done = True
        p.completed_at = now
        completed.append(p)
    if len(completed) > completed_capacity:
        del completed[:-completed_capacity]
    if on_success is not None:
        on_success(len(pending))


def _trace_batch(tracer, bucket, pending, t_start, t_run, t_done,
                 error=None):
    """queue_wait, dispatch and device_run spans for each traced request
    of one dispatched batch. device_run nests under dispatch (dispatch's
    exclusive time is the padding and the resolve); a failing runner
    stamps its error class on the dispatch span, so that retried attempts
    tell apart in the tree."""
    if tracer is None:
        return
    for p in pending:
        tr = getattr(p, 'trace', None)
        if not tr:
            continue
        tracer.add(tr['ctx'], 'queue_wait', parent_id=tr['parent'],
                   ts=p.submitted_at,
                   dur_ms=(t_start - p.submitted_at) * 1e3)
        meta = dict(bucket=int(bucket), fill=len(pending))
        if error is not None:
            meta['error'] = error
        d = tracer.add(tr['ctx'], 'dispatch', parent_id=tr['parent'],
                       ts=t_start, dur_ms=(t_done - t_start) * 1e3,
                       **meta)
        tracer.add(tr['ctx'], 'device_run', parent_id=d['span'],
                   ts=t_run, dur_ms=(t_done - t_run) * 1e3)


class _BucketQueue:
    __slots__ = ('bucket', 'tokens', 'coords', 'pending')

    def __init__(self, bucket: int):
        self.bucket = bucket
        self.tokens: List[np.ndarray] = []
        self.coords: List[np.ndarray] = []
        self.pending: List[PendingResult] = []

    def __len__(self):
        return len(self.pending)


class MicroBatcher:
    """Queue requests per length bucket; flush on batch-full or deadline.

        batcher = MicroBatcher(engine.run, buckets=engine.buckets,
                               batch_size=engine.batch_size,
                               max_wait_ms=5.0, admission=ctl)
        pending = batcher.submit(tokens, coords)   # may raise
        batcher.pump()                             # deadline flushes
        ...
        batcher.drain()                            # end of stream

    `runner(bucket, tokens, coords, mask) -> out [B, L, ...]` is the
    engine's `run`; results are sliced back to each request's true rows
    before its `PendingResult` resolves.
    """

    def __init__(self, runner: Callable, buckets: Sequence[int],
                 batch_size: int, max_wait_ms: float = 10.0,
                 admission: Optional[AdmissionController] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.runner = runner
        self.buckets = tuple(sorted(int(b) for b in buckets))
        assert self.buckets, 'no buckets'
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.admission = admission
        self.clock = clock
        self._queues = {b: _BucketQueue(b) for b in self.buckets}
        self._next_id = 0
        self.tracer = None             # observability.tracing.Tracer
        self.batches_dispatched = 0
        self.rows_dispatched = 0       # real (non-dummy) rows
        # real rows per dispatched batch: exact running stats forever, raw
        # samples capped (a serve loop runs for days)
        self.fill_stats = agg_zero()
        self.fill_history: List[int] = []
        self._fill_capacity = 4096
        # completed results, drained by telemetry through pop_completed();
        # bounded (the oldest go first: each submitter holds its own
        # PendingResult)
        self.completed: List[PendingResult] = []
        self._completed_capacity = 65536

    # ------------------------------------------------------------------ #
    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def bucket_for(self, length: int) -> Optional[int]:
        return fit_bucket(self.buckets, length)

    def submit(self, tokens, coords) -> PendingResult:
        """Admit + enqueue one request; flushes its bucket if now full.

        Raises RequestRejected (oversize / overloaded) without touching
        the engine. The bucket fit is checked before admission
        accounting, so a request no bucket can serve is counted rejected
        (never admitted) even when the controller's max_len is looser
        than the buckets.
        """
        tokens = np.asarray(tokens)
        length = len(tokens)
        bucket = self.bucket_for(length)
        if bucket is None:
            if self.admission is not None:
                self.admission.reject_oversize(length, self.buckets[-1])
            raise oversize_error(length, self.buckets[-1])
        if self.admission is not None:
            self.admission.admit(length, queue_depth=self.queue_depth)
        q = self._queues[bucket]
        pending = PendingResult(self._next_id, length, bucket, self.clock())
        self._next_id += 1
        q.tokens.append(tokens)
        q.coords.append(np.asarray(coords, np.float32).reshape(-1, 3))
        q.pending.append(pending)
        if len(q) >= self.batch_size:
            self._flush(q)
        return pending

    def pump(self, now: Optional[float] = None) -> int:
        """Flush every bucket whose oldest request has hit the deadline.
        Returns the number of batches dispatched."""
        now = self.clock() if now is None else now
        n = 0
        for q in self._queues.values():
            if q.pending and \
                    now - q.pending[0].submitted_at >= self.max_wait_s:
                self._flush(q)
                n += 1
        return n

    def drain(self) -> int:
        """Flush every non-empty bucket regardless of deadline (end of a
        request stream / shutdown). Returns batches dispatched."""
        n = 0
        for q in self._queues.values():
            if q.pending:
                self._flush(q)
                n += 1
        return n

    def next_deadline(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the earliest pending deadline (sleep hint for a
        serve loop); None when idle."""
        oldest = [q.pending[0].submitted_at for q in self._queues.values()
                  if q.pending]
        if not oldest:
            return None
        now = self.clock() if now is None else now
        return max(0.0, min(oldest) + self.max_wait_s - now)

    def pop_completed(self) -> List[PendingResult]:
        """Drain the completed-results queue (telemetry's latency feed)."""
        done, self.completed = self.completed, []
        return done

    # ------------------------------------------------------------------ #
    def _flush(self, q: _BucketQueue):
        # the queue is cleared before dispatch: on a raising runner the
        # requests resolve done-with-error (never silently requeued)
        tokens, coords, pending = q.tokens, q.coords, q.pending
        q.tokens, q.coords, q.pending = [], [], []
        dispatch_batch(self.runner, q.bucket, self.batch_size, tokens,
                       coords, pending, self.completed,
                       self._completed_capacity, self.clock,
                       tracer=self.tracer)
        self.batches_dispatched += 1
        self.rows_dispatched += len(pending)
        agg_update(self.fill_stats, [len(pending)])
        if len(self.fill_history) < self._fill_capacity:
            self.fill_history.append(len(pending))
