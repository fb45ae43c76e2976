"""Fleet-wide request tracing: spans, span trees and the completeness
invariant behind the schema'd `trace` record. The port of
se3_transformer_tpu/observability/tracing.py (pure Python, so the port
keeps its own copy).

One request goes FleetRouter -> host RPC -> Router -> ContinuousBatcher ->
ReplicaWorker dispatch -> InferenceEngine.run, and may be redispatched
across hosts. Each tier records spans into a `Tracer` (one per process):
the fleet front end mints the trace id and the single root `request`
span at submit; every RPC attempt carries the trace context in its
payload (`{'trace': <id>, 'parent': <span id>}`); the host hangs its
`admit` / `queue_wait` / `batch_fill` / `dispatch` / `device_run` /
`retry` spans under that parent, and the finished host spans ride back
in the infer response (`spans`), where they fold into the fleet's tracer.
A host that dies mid-request loses its own spans; the fleet's tree (root,
`attempt`, `redispatch`) stays complete through the retry path, which is
the zero-orphans-under-SIGKILL property the chaos gates check.

Ids are unique by construction: every Tracer draws a token of its own
(origin, pid, random); trace ids are `req-<token>-<n>` (control-plane
actions, probes and rollouts, mint `ctl-<token>-<n>` and stay out of the
request completeness count), span ids `s-<token>-<n>`.

The completeness invariant (`trace_record_body`): every answered or
structured-failed request yields exactly one single-root span tree with
no orphan (a span whose parent id never appears in its trace);
`completeness_total` is the share of request traces that hold it (1.0 is
the contract). Exclusive durations per span name nest spans per (trace,
recording process) with an interval stack of their own
(`exclusive_durations`), so spans of different clock domains (the fleet's
and a host's monotonic clocks) never subtract from each other.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

# trace-id kinds: request traces enter the completeness invariant;
# control-plane traces (probe / rollout) have no submitting request
REQUEST_KIND = 'req'
CONTROL_KIND = 'ctl'

_UNSET = object()


class Tracer:
    """Thread-safe span recorder for one process.

    Spans are JSON-safe dicts::

        {trace, span, parent, name, org, host, ts, dur_ms, ...meta}

    `begin()` / `end()` bracket an interval (`end` is idempotent: terminal
    sites may race); `add()` records an already-timed or instantaneous
    span; `extend()` folds spans recorded by another Tracer (returned in
    an RPC response). `host` stamps every span, so that a cross-host trace
    reads from the record alone.
    """

    def __init__(self, origin: str = 'fleet', host=None,
                 capacity: int = 65536, clock=time.monotonic):
        self.origin = str(origin)
        self.host = host
        self.clock = clock
        self.dropped = 0
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans: List[dict] = []
        self._seq = 0
        self._uniq = (f'{self.origin}-{os.getpid():x}-'
                      f'{uuid.uuid4().hex[:6]}')

    # ---- ids ---------------------------------------------------------- #
    def _next(self, prefix: str) -> str:
        with self._lock:
            n = self._seq
            self._seq += 1
        return f'{prefix}{self._uniq}-{n}'

    def mint(self, kind: str = REQUEST_KIND) -> str:
        """A new unique trace id (`req-...` or `ctl-...`)."""
        return self._next(f'{kind}-')

    # ---- recording ---------------------------------------------------- #
    def begin(self, trace_id: str, name: str, parent_id=None,
              host=_UNSET, **meta) -> dict:
        """Open a span; it is recorded only when `end()` closes it."""
        span = dict(trace=trace_id, span=self._next('s-'),
                    parent=parent_id, name=str(name), org=self._uniq,
                    host=self.host if host is _UNSET else host,
                    ts=self.clock(), dur_ms=None)
        if meta:
            span.update(meta)
        return span

    def end(self, span: Optional[dict], **meta) -> Optional[dict]:
        """Close and record a `begin()` span. Idempotent: the first
        terminal site wins, later calls do nothing."""
        if span is None or span.get('dur_ms') is not None:
            return span
        span['dur_ms'] = round(
            max(self.clock() - span['ts'], 0.0) * 1e3, 3)
        span['ts'] = round(float(span['ts']), 6)
        if meta:
            span.update(meta)
        self._record(span)
        return span

    def add(self, trace_id: str, name: str, *, parent_id=None,
            ts=None, dur_ms: float = 0.0, host=_UNSET, **meta) -> dict:
        """Record an already-timed (or instantaneous) span."""
        span = dict(trace=trace_id, span=self._next('s-'),
                    parent=parent_id, name=str(name), org=self._uniq,
                    host=self.host if host is _UNSET else host,
                    ts=round(float(self.clock() if ts is None else ts),
                             6),
                    dur_ms=round(max(float(dur_ms), 0.0), 3))
        if meta:
            span.update(meta)
        self._record(span)
        return span

    def extend(self, spans) -> None:
        """Fold closed spans recorded elsewhere into this recorder."""
        for s in spans or []:
            if isinstance(s, dict) and s.get('dur_ms') is not None:
                self._record(dict(s))

    def _record(self, span: dict) -> None:
        with self._lock:
            if len(self._spans) < self._capacity:
                self._spans.append(span)
            else:
                self.dropped += 1

    # ---- reading ------------------------------------------------------ #
    @property
    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def pop_trace(self, trace_id: str) -> List[dict]:
        """Remove and return every recorded span of one trace (a host
        ships them back in the infer response with this)."""
        with self._lock:
            keep, out = [], []
            for s in self._spans:
                (out if s.get('trace') == trace_id else keep).append(s)
            self._spans = keep
        return out


# --------------------------------------------------------------------- #
# span-tree analysis
# --------------------------------------------------------------------- #
def span_trees(spans) -> Dict[str, List[dict]]:
    """Spans grouped by trace id."""
    trees: Dict[str, List[dict]] = {}
    for s in spans:
        trees.setdefault(s.get('trace'), []).append(s)
    return trees


def _is_request(tid) -> bool:
    return isinstance(tid, str) and tid.startswith(REQUEST_KIND + '-')


def orphan_spans(spans) -> List[dict]:
    """Spans whose parent id never appears inside their own trace."""
    out = []
    for group in span_trees(spans).values():
        ids = {s.get('span') for s in group}
        out += [s for s in group
                if s.get('parent') and s['parent'] not in ids]
    return out


def complete_request_trees(spans) -> List[str]:
    """Request-trace ids whose tree is exactly one root (parent None) and
    no orphan: the per-request completeness invariant."""
    done = []
    for tid, group in span_trees(spans).items():
        if not _is_request(tid):
            continue
        ids = {s.get('span') for s in group}
        roots = [s for s in group if not s.get('parent')]
        orphans = [s for s in group
                   if s.get('parent') and s['parent'] not in ids]
        if len(roots) == 1 and not orphans:
            done.append(tid)
    return done


def exclusive_durations(events, slack: float = 1e-9
                        ) -> List[Tuple[dict, float]]:
    """(event, exclusive us) pairs over trace-event dicts (`pid`, `tid`,
    `ts` and `dur` in microseconds): each event's duration less the time
    of the events nested in it on the same (pid, tid) track; an event that
    starts within `slack` us of the open event's end is its sibling. The
    interval-stack idiom of JAX's profiling.exclusive_durations; the
    port's profiler keeps its own over torch.profiler events."""
    out = []
    by_track: Dict[tuple, list] = {}
    for ev in events:
        by_track.setdefault((ev.get('pid'), ev.get('tid')), []).append(ev)
    for evs in by_track.values():
        # parents first on ties: the longer event takes the outer slot
        evs.sort(key=lambda e: (float(e.get('ts', 0.0)),
                                -float(e.get('dur', 0.0))))
        stack: list = []   # [end_ts, child_time, event]
        for ev in evs:
            ts = float(ev.get('ts', 0.0))
            dur = float(ev.get('dur', 0.0))
            while stack and ts >= stack[-1][0] - slack:
                _, child, parent = stack.pop()
                out.append((parent, float(parent.get('dur', 0.0)) - child))
            if stack:
                stack[-1][1] += dur
            stack.append([ts + dur, 0.0, ev])
        while stack:
            _, child, parent = stack.pop()
            out.append((parent, float(parent.get('dur', 0.0)) - child))
    return out


def exclusive_by_name(spans) -> Dict[str, dict]:
    """Per span name {count, total_ms, exclusive_ms}. Spans map to trace
    events keyed (pid = trace, tid = recording process), so nesting is
    computed within one clock domain only: a host's `device_run` subtracts
    from its `dispatch`, never from the fleet's `attempt`. A span's ts and
    duration are each rounded to the microsecond, so one that starts
    within 2 us of another's end is its sibling (`queue_wait`, then
    `dispatch`); JAX's nests it, and books the dispatch's whole duration
    against the queue wait."""
    events = [dict(name=s.get('name'), pid=s.get('trace'),
                   tid=s.get('org'),
                   ts=float(s.get('ts') or 0.0) * 1e6,
                   dur=float(s.get('dur_ms') or 0.0) * 1e3)
              for s in spans if s.get('dur_ms') is not None]
    acc: Dict[str, dict] = {}
    for ev, excl in exclusive_durations(events, slack=2.0):
        e = acc.setdefault(ev['name'],
                           dict(count=0, total_ms=0.0, exclusive_ms=0.0))
        e['count'] += 1
        e['total_ms'] += ev['dur'] / 1e3
        e['exclusive_ms'] += excl / 1e3
    return {name: dict(count=e['count'],
                       total_ms=round(e['total_ms'], 3),
                       exclusive_ms=round(e['exclusive_ms'], 3))
            for name, e in sorted(acc.items())}


def multi_host_traces(spans) -> int:
    """Request traces whose spans touched two hosts or more (a cross-host
    redispatch, made visible)."""
    n = 0
    for tid, group in span_trees(spans).items():
        if not _is_request(tid):
            continue
        hosts = {s.get('host') for s in group
                 if s.get('host') is not None}
        if len(hosts) >= 2:
            n += 1
    return n


def trace_record_body(tracer, label: str = 'trace',
                      expected: Optional[int] = None) -> dict:
    """The schema'd `trace` record's fields from a Tracer (or a span
    list).

    `expected` is the number of requests that resolved answered or
    structured-failed: given, `completeness_total` is judged against
    max(expected, request traces seen), so a request that never produced
    a root span still lowers the score."""
    spans = tracer.spans if isinstance(tracer, Tracer) else list(tracer)
    trees = span_trees(spans)
    req_traces = [t for t in trees if _is_request(t)]
    complete = complete_request_trees(spans)
    orphans = orphan_spans(spans)
    denom = max(len(req_traces),
                int(expected) if expected is not None else 0)
    completeness = 1.0 if denom == 0 else len(complete) / denom
    body = dict(
        label=label,
        traces=len(req_traces),
        complete_trees=len(complete),
        orphan_spans=len(orphans),
        spans_total=len(spans),
        spans_by_name=exclusive_by_name(spans),
        retry_hops=sum(1 for s in spans if s.get('name') == 'retry'),
        redispatch_hops=sum(1 for s in spans
                            if s.get('name') == 'redispatch'),
        multi_host_traces=multi_host_traces(spans),
        completeness_total=round(completeness, 6),
    )
    if expected is not None:
        body['expected_traces'] = int(expected)
    if isinstance(tracer, Tracer) and tracer.dropped:
        body['dropped_spans'] = tracer.dropped
    return body
