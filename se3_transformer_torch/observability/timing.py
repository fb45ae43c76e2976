"""Phase wall-clock reservoirs and profiler labels: the port of
se3_transformer_tpu/observability/timing.py.

  * `PhaseTimer`: host wall clock per phase ('bucket_1024', 'step', ...)
    with windowed and cumulative p50/p95/p99/max. A phase that times work
    on a card passes `device=`: the phase then ends in a synchronize of
    that device (of one stream with `stream=`), so the time recorded is
    the device's, as JAX's phases end in `block_until_ready`.
  * `named_scope` / `profile_trace`: device attribution. A scope is a
    `torch.profiler.record_function` label, the counterpart of
    `jax.named_scope`; `MODEL_SCOPES` lists the labels the model emits
    (models/se3_transformer.py, ops/attention.py, kernels/attention.py,
    v2/model.py), and observability.profiling folds a profile's device
    time onto them.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict

import numpy as np
import torch

# every named_scope label the model emits, for trace readers (JAX's
# MODEL_SCOPES; 'ring_knn', 'ici_wait' and 'exchange' are the parallel
# package's, ROADMAP A7, and 'frames' the V2 family's edge frames)
MODEL_SCOPES = (
    'neighbors',          # models/se3_transformer.py: kNN selection
    'adjacency',          # models/se3_transformer.py: adjacency expansion
    #                       and the jittered bonded top-k
    'basis',              # models/se3_transformer.py: the per-edge payloads
    'conv_in',            # models/se3_transformer.py
    'trunk',              # models/se3_transformer.py
    'conv_out',           # models/se3_transformer.py
    'attention',          # ops/attention.py: the whole attention call
    'attn_qkv',           # ops/attention.py: q/k/v projections and convs
    'attn_core',          # ops/attention.py: sim/softmax/weighted sum
    'pallas_attention',   # kernels/attention.py: the fused kernel's op
    'ring_knn',           # the parallel package (ROADMAP A7)
    'ici_wait',
    'exchange',
    'frames',             # v2/model.py: the edge frames
)


def named_scope(name: str):
    """Label a region for torch.profiler (a record_function range)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A torch.profiler session (CPU activity, and CUDA activity when a
    card is present) whose trace lands in `log_dir` as a Chrome trace
    (perfetto-compatible); yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f'trace_{os.getpid()}_{time.time_ns()}.json'))


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
    def phase(self, name: str, device=None, stream=None):
        """Time the block; with a CUDA `device`, the block's device work
        is waited for before the clock stops: the whole device's, or with
        `stream` (a torch.cuda.Stream) that stream's alone, so that the
        time of a replica on its own stream leaves out its siblings'
        work."""
        sync = device is not None and torch.device(device).type == 'cuda'
        t0 = time.perf_counter()
        try:
            yield
            if stream is not None:
                stream.synchronize()
            elif sync:
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
