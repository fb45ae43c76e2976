"""Admission control: reject early, degrade gracefully. The port of
se3_transformer_tpu/inference/admission.py, with its codes, records and
retry hints.

Two failure modes a bucketed engine must never hit:

  * an **oversize request**: a sequence longer than the largest warmed
    bucket. The right answer is a structured rejection at the front door,
    never a forward at a shape nothing was warmed for.
  * **queue collapse**: once the backlog exceeds what the engine can
    drain within the deadline budget, every queued request's latency
    grows without bound. Shedding load at a depth threshold keeps the p99
    of *admitted* requests flat instead of letting everyone time out.

`RequestRejected` is an exception AND a record: `to_record()` returns the
JSON-safe payload that rides the `serve` telemetry stream. An overload
shed carries a machine-readable `retry_after_s` hint when the controller
was built with a `retry_hint`. It is a ValueError: the request, not the
engine, is at fault.

`RequestFailed` is the terminal sibling for requests that were admitted
but could not be answered (retry budget spent, or a deadline expired
while queued); the multi-replica router (serving.Router) raises it.
"""
from __future__ import annotations

from typing import Callable, Optional

OVERSIZE = 'oversize'
OVERLOADED = 'overloaded'
# RequestFailed codes
RETRIES_EXHAUSTED = 'retries_exhausted'
DEADLINE = 'deadline'


def fit_bucket(buckets, length: int):
    """Smallest bucket that fits `length`, or None. THE bucket-fit rule —
    engine and batcher both route through it."""
    for b in buckets:
        if length <= b:
            return b
    return None


def oversize_error(length: int, max_len: int) -> 'RequestRejected':
    """THE oversize rejection payload (one constructor, three raisers).

    `max_bucket` duplicates `max_len` under the name clients reason in:
    a 30k-atom submitter reads the largest configured bucket straight
    off the structured detail (actionable — split the assembly or ask
    for a bigger deployment) instead of parsing the prose."""
    return RequestRejected(
        OVERSIZE,
        f'request length {length} exceeds the largest compiled bucket '
        f'({max_len}); recompile the engine with a larger bucket to '
        f'serve it',
        length=int(length), max_len=int(max_len),
        max_bucket=int(max_len))


class RequestRejected(ValueError):
    """Structured rejection: `code` ('oversize' | 'overloaded') plus a
    machine-readable `detail` dict (max_len / queue depth / limits)."""

    def __init__(self, code: str, message: str, **detail):
        super().__init__(message)
        self.code = code
        self.detail = dict(detail)

    def to_record(self) -> dict:
        return dict(code=self.code, message=str(self), **self.detail)


class RequestFailed(Exception):
    """Structured TERMINAL failure of an admitted request: `code`
    ('retries_exhausted' | 'deadline') plus a machine-readable `detail`
    dict (attempts / deadline / the last underlying error). Set as a
    `PendingResult.error` — the submitter always gets an answer-shaped
    object, never a silently dropped request."""

    def __init__(self, code: str, message: str, **detail):
        super().__init__(message)
        self.code = code
        self.detail = dict(detail)

    def to_record(self) -> dict:
        return dict(code=self.code, message=str(self), **self.detail)


def retries_exhausted_error(attempts: int,
                            cause: Optional[BaseException] = None,
                            retry_after_s: Optional[float] = None
                            ) -> RequestFailed:
    """`retry_after_s` is the same machine-readable backoff hint an
    overload `RequestRejected` carries (the Router's `_fail_request`
    stamps its queue-depth estimate when the caller has none) — a
    terminal failure without it invites the client to hot-loop the
    struggling fleet it just fell out of."""
    detail = dict(
        attempts=int(attempts),
        cause=f'{type(cause).__name__}: {cause}' if cause is not None
        else None)
    if retry_after_s is not None:
        detail['retry_after_s'] = round(max(0.0, float(retry_after_s)), 4)
    return RequestFailed(
        RETRIES_EXHAUSTED,
        f'request failed on every replica it was dispatched to '
        f'({attempts} attempt{"s" if attempts != 1 else ""}); the retry '
        f'budget is spent',
        **detail)


def deadline_error(waited_s: float, timeout_s: float,
                   attempts: int = 0,
                   retry_after_s: Optional[float] = None) -> RequestFailed:
    detail = dict(
        waited_s=round(float(waited_s), 4),
        timeout_s=round(float(timeout_s), 4),
        attempts=int(attempts))
    if retry_after_s is not None:
        detail['retry_after_s'] = round(max(0.0, float(retry_after_s)), 4)
    return RequestFailed(
        DEADLINE,
        f'request deadline expired after {waited_s:.3f}s '
        f'(timeout {timeout_s:.3f}s) before a dispatch could answer it',
        **detail)


class AdmissionController:
    """Gate requests on length and backlog before they touch the engine.

        ctl = AdmissionController(max_len=512, max_queue_depth=256)
        ctl.admit(length=700, queue_depth=0)   # raises RequestRejected

    Counters (`admitted`, `rejected`) feed the `serve` telemetry record
    via `snapshot()`. `retry_hint(queue_depth) -> seconds` (optional —
    the Router wires its queue-depth x per-bucket-p50 estimate in)
    turns an overload shed's "retry with backoff" into a structured
    `retry_after_s` the client can actually schedule against.
    """

    def __init__(self, max_len: int,
                 max_queue_depth: Optional[int] = None,
                 retry_hint: Optional[Callable[[int], float]] = None):
        assert max_len > 0, 'max_len must be positive'
        self.max_len = int(max_len)
        self.max_queue_depth = (int(max_queue_depth)
                                if max_queue_depth is not None else None)
        self.retry_hint = retry_hint
        self.admitted = 0
        self.rejected = {OVERSIZE: 0, OVERLOADED: 0}

    def reject_oversize(self, length: int,
                        max_len: Optional[int] = None) -> None:
        """Count and raise an oversize rejection (callers that discover
        the overflow themselves — e.g. the batcher's bucket fit — route
        it through here so the counters stay truthful)."""
        self.rejected[OVERSIZE] += 1
        raise oversize_error(length, self.max_len if max_len is None
                             else max_len)

    def admit(self, length: int, queue_depth: int = 0) -> None:
        """Raise RequestRejected if the request must not enter the queue;
        otherwise count it admitted and return."""
        if length > self.max_len:
            self.reject_oversize(length)
        if (self.max_queue_depth is not None
                and queue_depth >= self.max_queue_depth):
            self.rejected[OVERLOADED] += 1
            detail = dict(queue_depth=int(queue_depth),
                          max_queue_depth=self.max_queue_depth)
            hint = ''
            if self.retry_hint is not None:
                retry_after = max(0.0, float(self.retry_hint(queue_depth)))
                detail['retry_after_s'] = round(retry_after, 4)
                hint = f' (retry_after_s={detail["retry_after_s"]})'
            raise RequestRejected(
                OVERLOADED,
                f'queue depth {queue_depth} at the shed threshold '
                f'({self.max_queue_depth}); retry with backoff{hint}',
                **detail)
        self.admitted += 1

    def snapshot(self) -> dict:
        """Cumulative counters for the serve record."""
        return dict(admitted=self.admitted, rejected=dict(self.rejected))
