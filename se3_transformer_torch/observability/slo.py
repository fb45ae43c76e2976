"""Mergeable latency histograms and the fleet's SLO aggregation: the
port of se3_transformer_tpu/observability/slo.py.

Percentiles do not merge (averaging two hosts' p99s is wrong), counts do:
every histogram counts latencies into the same geometric boundaries, a
snapshot is a plain JSON dict, merging is count addition, and a
percentile read off a merged histogram is exactly the percentile of the
pooled samples at bucket resolution. `ServeTelemetry` keeps one per
bucket and writes their snapshots into each `serve` record;
`HostServer`'s `stats` ships them, `FleetRouter`'s heartbeat folds them
into an `SLOAggregator`, and its `record_body` renders the schema'd `slo`
record: fleet availability, merged per-bucket p50/p95/p99, the error
budget's burn rate, breaker-state dwell times, and the rollout and
rollback history.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, List, Optional

# fixed geometric boundaries (ms, ratio 2^(1/4)): ~0.1 ms .. ~88 s, JAX's.
# Merging is exact only between histograms with identical boundaries
# (merge_histograms enforces it).
DEFAULT_BOUNDS = tuple(round(0.1 * 2 ** (i / 4), 6) for i in range(80))

# the availability floor the SLO run's gate judges against
AVAILABILITY_FLOOR = 0.97


class LatencyHistogram:
    """Thread-safe fixed-boundary latency histogram (milliseconds).

    `counts[i]` counts samples with `bounds[i-1] < ms <= bounds[i]`;
    the final slot is the overflow bucket (> bounds[-1]). A bucket's
    representative value is its UPPER edge (overflow reports the
    observed max), so percentiles are conservative and merge-exact.
    """

    __slots__ = ('bounds', 'counts', 'count', 'sum_ms', 'max_ms',
                 '_lock')

    def __init__(self, bounds=None):
        self.bounds = tuple(float(b) for b in (bounds or DEFAULT_BOUNDS))
        assert all(a < b for a, b in zip(self.bounds, self.bounds[1:])), \
            'histogram boundaries must be strictly ascending'
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0
        self._lock = threading.Lock()

    def observe(self, ms: float) -> None:
        ms = float(ms)
        i = bisect.bisect_left(self.bounds, ms)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum_ms += ms
            if ms > self.max_ms:
                self.max_ms = ms

    def snapshot(self) -> dict:
        """JSON-safe, mergeable snapshot."""
        with self._lock:
            return dict(bounds=list(self.bounds),
                        counts=list(self.counts),
                        count=self.count,
                        sum_ms=round(self.sum_ms, 3),
                        max_ms=round(self.max_ms, 3))


def merge_histograms(snapshots: List[dict]) -> dict:
    """Merge snapshots by count addition — exact by construction.

    Empty/None entries are skipped (an empty host merges as zero);
    mismatched boundaries raise (a silent resample would be wrong).
    """
    snaps = [s for s in (snapshots or []) if s and s.get('counts')]
    if not snaps:
        return dict(bounds=list(DEFAULT_BOUNDS),
                    counts=[0] * (len(DEFAULT_BOUNDS) + 1),
                    count=0, sum_ms=0.0, max_ms=0.0)
    bounds = list(snaps[0]['bounds'])
    counts = [0] * len(snaps[0]['counts'])
    count, sum_ms, max_ms = 0, 0.0, 0.0
    for s in snaps:
        if list(s['bounds']) != bounds:
            raise ValueError('cannot merge histograms with different '
                             'boundaries')
        for i, c in enumerate(s['counts']):
            counts[i] += int(c)
        count += int(s.get('count') or 0)
        sum_ms += float(s.get('sum_ms') or 0.0)
        max_ms = max(max_ms, float(s.get('max_ms') or 0.0))
    return dict(bounds=bounds, counts=counts, count=count,
                sum_ms=round(sum_ms, 3), max_ms=round(max_ms, 3))


def histogram_percentiles(snap: dict, qs=(50, 95, 99)) -> dict:
    """{count, p50_ms, p95_ms, p99_ms} off one snapshot, at bucket
    resolution: the q-th percentile is the upper edge of the bucket
    holding the ceil(q/100 * count)-th smallest sample (overflow
    reports the observed max). Empty histogram -> None percentiles."""
    counts = snap.get('counts') or []
    bounds = snap.get('bounds') or []
    total = int(snap.get('count') or 0)
    out = dict(count=total)
    for q in qs:
        key = f'p{q}_ms'
        if total <= 0:
            out[key] = None
            continue
        rank = max(1, math.ceil(q / 100.0 * total))
        cum, val = 0, None
        for i, c in enumerate(counts):
            cum += int(c)
            if cum >= rank:
                val = (bounds[i] if i < len(bounds)
                       else float(snap.get('max_ms') or bounds[-1]))
                break
        out[key] = round(float(val), 6)
    return out


class SLOAggregator:
    """Fold per-host scraped stats into the fleet `slo` record.

    `FleetRouter` calls `fold(host_id, stats)` on every successful
    heartbeat / stats scrape (stats is the host's cumulative
    `_stats_body`, so the LATEST snapshot per host is all that needs
    keeping — no delta bookkeeping). `record_body(fleet)` then merges
    the per-bucket histograms, computes availability off the fleet's
    own answered/failure counters, and renders dwell times from the
    host breaker's transition log.
    """

    def __init__(self, availability_target: float = 0.999,
                 clock=time.monotonic):
        self.target = float(availability_target)
        self.clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._hosts: Dict[object, dict] = {}

    def fold(self, host_id, stats) -> None:
        if not isinstance(stats, dict) or not stats:
            return
        with self._lock:
            self._hosts[host_id] = dict(stats)

    @property
    def hosts(self) -> dict:
        with self._lock:
            return dict(self._hosts)

    def merged_buckets(self) -> dict:
        """Per-bucket fleet percentiles off the merged histograms."""
        per_bucket: Dict[str, List[dict]] = {}
        for stats in self.hosts.values():
            for b, snap in (stats.get('latency_hist') or {}).items():
                per_bucket.setdefault(str(b), []).append(snap)
        return {b: histogram_percentiles(merge_histograms(snaps))
                for b, snaps in sorted(per_bucket.items())}

    def _dwell(self, fleet, now: float) -> dict:
        """Per-host seconds spent in each breaker state, integrated
        over the host transition log (hosts with no transitions have
        been healthy the whole observation window)."""
        if fleet is None:
            return {}
        per: Dict[str, list] = {str(h): [] for h in fleet.hosts}
        for tr in fleet.health.transitions:
            per.setdefault(str(tr['replica']), []).append(tr)
        out = {}
        for host, trs in sorted(per.items()):
            dwell: Dict[str, float] = {}
            prev_t = self._t0
            state = trs[0]['from_state'] if trs else 'healthy'
            for tr in trs:
                t = float(tr['t'])
                dwell[state] = dwell.get(state, 0.0) + max(t - prev_t,
                                                           0.0)
                prev_t, state = t, tr['to_state']
            dwell[state] = dwell.get(state, 0.0) + max(now - prev_t,
                                                       0.0)
            out[host] = {k: round(v, 4) for k, v in dwell.items()}
        return out

    def record_body(self, fleet=None, label: str = 'slo',
                    now: Optional[float] = None) -> dict:
        hosts = self.hosts
        now = self.clock() if now is None else now
        if fleet is not None:
            answered = int(fleet.answered)
            failures = int(fleet.request_failures)
            timeouts = int(fleet.timeouts)
        else:
            answered = sum(int(s.get('answered') or 0)
                           for s in hosts.values())
            failures = sum(int(s.get('request_failures') or 0)
                           for s in hosts.values())
            timeouts = sum(int(s.get('timeouts') or 0)
                           for s in hosts.values())
        denom = answered + failures
        availability = 1.0 if denom == 0 else answered / denom
        budget = max(1.0 - self.target, 1e-12)
        if fleet is not None:
            rollouts = dict(count=len(fleet.rollout_events),
                            completed=int(fleet.rollouts),
                            rollbacks=int(fleet.rollbacks))
        else:
            rollouts = dict(count=0, completed=0, rollbacks=0)
        return dict(
            label=label,
            hosts=len(hosts),
            window_s=round(now - self._t0, 3),
            availability=round(availability, 6),
            answered=answered,
            request_failures=failures,
            timeouts=timeouts,
            buckets=self.merged_buckets(),
            error_budget=dict(target=self.target,
                              budget=round(budget, 6),
                              burn_rate=round(
                                  (1.0 - availability) / budget, 4)),
            breaker_dwell=self._dwell(fleet, now),
            rollouts=rollouts,
        )
