"""Bounded running aggregates shared by batching and telemetry: the port
of se3_transformer_tpu/inference/stats.py.

A serve loop runs for days, so every retained statistic must be O(1):
these fold samples into exact running {count, sum, min, max} (one dict,
never a growing list). One implementation — `MicroBatcher` (batch fill)
and `ServeTelemetry` (request latency) both use it.
"""
from __future__ import annotations

import numpy as np


def agg_zero() -> dict:
    return dict(count=0, sum=0.0, min=None, max=None)


def agg_update(agg: dict, values) -> dict:
    """Fold a window of samples into the exact running aggregate."""
    for v in values:
        v = float(v)
        agg['count'] += 1
        agg['sum'] += v
        agg['min'] = v if agg['min'] is None else min(agg['min'], v)
        agg['max'] = v if agg['max'] is None else max(agg['max'], v)
    return agg


def agg_stats(agg: dict) -> dict:
    """The window-shaped {count, mean, min, max} view of an aggregate."""
    if not agg['count']:
        return dict(count=0, mean=None, min=None, max=None)
    return dict(count=agg['count'],
                mean=round(agg['sum'] / agg['count'], 4),
                min=round(agg['min'], 4), max=round(agg['max'], 4))


def window_stats(values) -> dict:
    """One-shot {count, mean, min, max} over a (bounded) sample window."""
    a = np.asarray(list(values), dtype=float)
    if a.size == 0:
        return dict(count=0, mean=None, min=None, max=None)
    return dict(count=int(a.size), mean=round(float(a.mean()), 4),
                min=round(float(a.min()), 4), max=round(float(a.max()), 4))
