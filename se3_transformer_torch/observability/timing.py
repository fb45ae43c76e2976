"""Phase wall-clock reservoirs and profiler labels: the port of
se3_transformer_tpu/observability/timing.py.

  * `PhaseTimer`: host wall clock per phase ('bucket_1024', 'step', ...)
    with windowed and cumulative p50/p95/p99/max. A phase that times work
    on a card passes `device=`: the phase then ends in a synchronize of
    that device, so the time recorded is the device's, as JAX's phases
    end in `block_until_ready`.
  * `named_scope`: a `torch.profiler.record_function` label, the
    counterpart of `jax.named_scope` (a region named in a profiler
    trace).

The model's own scope labels (JAX's MODEL_SCOPES) and `profile_trace`
come with ROADMAP A8.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import numpy as np
import torch


def named_scope(name: str):
    """Label a region for torch.profiler (a record_function range)."""
    return torch.profiler.record_function(name)


def _percentiles(samples) -> dict:
    a = np.asarray(samples, dtype=float) * 1e3  # -> ms
    return dict(count=int(a.size),
                p50_ms=round(float(np.percentile(a, 50)), 3),
                p95_ms=round(float(np.percentile(a, 95)), 3),
                # serving SLOs quote p99 (the serve record requires it)
                p99_ms=round(float(np.percentile(a, 99)), 3),
                max_ms=round(float(a.max()), 3),
                mean_ms=round(float(a.mean()), 3))


class PhaseTimer:
    """Host wall-clock reservoirs per phase with windowed percentiles.

        timer = PhaseTimer()
        with timer.phase('bucket_1024', device=engine.device):
            ...launch the forward...
        stats = timer.window_summary()   # {phase: {p50_ms, p95_ms, ...}}

    `window_summary` reports and resets the current window (call it at the
    flush interval); `cumulative_summary` covers the whole run (its
    reservoir is capped at `capacity` samples; count, total and max stay
    exact beyond that, the percentiles come from the first `capacity`).
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._window: Dict[str, list] = {}
        self._all: Dict[str, list] = {}
        self._totals: Dict[str, dict] = {}
        # recorders and the flush reader may live on different threads
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        """Time the block; with a CUDA `device`, the block's device work
        is waited for before the clock stops."""
        sync = device is not None and torch.device(device).type == 'cuda'
        t0 = time.perf_counter()
        try:
            yield
            if sync:
                torch.cuda.synchronize(device)
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        with self._lock:
            self._window.setdefault(name, []).append(seconds)
            full = self._all.setdefault(name, [])
            if len(full) < self.capacity:
                full.append(seconds)
            tot = self._totals.setdefault(
                name, dict(count=0, total_s=0.0, max_s=0.0))
            tot['count'] += 1
            tot['total_s'] += seconds
            tot['max_s'] = max(tot['max_s'], seconds)

    def window_summary(self, reset: bool = True) -> dict:
        with self._lock:
            window = self._window
            if reset:
                self._window = {}
            else:
                window = {k: list(v) for k, v in window.items()}
        return {name: _percentiles(samples)
                for name, samples in window.items() if samples}

    def cumulative_summary(self) -> dict:
        with self._lock:
            snap = {name: (list(samples), dict(self._totals[name]))
                    for name, samples in self._all.items() if samples}
        out = {}
        for name, (samples, tot) in snap.items():
            stats = _percentiles(samples)
            stats.update(count=tot['count'],
                         total_s=round(tot['total_s'], 4),
                         max_ms=round(tot['max_s'] * 1e3, 3))
            out[name] = stats
        return out

    def total_seconds(self, name: str) -> float:
        tot = self._totals.get(name)
        return tot['total_s'] if tot else 0.0

    def total_count(self, name: str) -> int:
        tot = self._totals.get(name)
        return tot['count'] if tot else 0
