"""Mergeable fixed-boundary latency histograms: the port of
se3_transformer_tpu/observability/slo.py's histogram half.

Percentiles do not merge (averaging two hosts' p99s is wrong), counts do:
every histogram counts latencies into the same geometric boundaries, a
snapshot is a plain JSON dict, merging is count addition, and a
percentile read off a merged histogram is exactly the percentile of the
pooled samples at bucket resolution. `ServeTelemetry` keeps one per
bucket and writes their snapshots into each `serve` record. The fleet's
SLO aggregation (`SLOAggregator`) comes with ROADMAP A8.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import List

# fixed geometric boundaries (ms, ratio 2^(1/4)): ~0.1 ms .. ~88 s, JAX's.
# Merging is exact only between histograms with identical boundaries
# (merge_histograms enforces it).
DEFAULT_BOUNDS = tuple(round(0.1 * 2 ** (i / 4), 6) for i in range(80))


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
