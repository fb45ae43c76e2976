"""Serving telemetry: per-bucket SLO percentiles, schema'd `serve`
records, and the proof that a served stream set off no one-time work.
The port of se3_transformer_tpu/inference/telemetry.py.

It composes the observability primitives:

  * the engine's `PhaseTimer` holds one `bucket_<L>` phase per bucket;
    `flush()` turns its window percentiles (p50/p95/p99) into the
    `buckets` section of a `serve` record;
  * a `RetraceWatchdog` counts one-time host work (device constants
    built, the kernel library loaded): after `arm()` any is a request
    paying for it, and `post_warmup_compiles` accumulates the deltas
    (the serve entry point gates on it being exactly zero);
  * request latencies (queue wait + execute, off the `MicroBatcher`'s
    completed results) fold into mergeable per-bucket histograms and
    window-shaped metrics, batch fill into the end-of-run `summary`.

`ServeTelemetryBase` holds the record assembly that this emitter shares
with the multi-replica router's (serving.RouterTelemetry).
"""
from __future__ import annotations

from typing import Optional

from ..observability import MetricLogger, PhaseTimer, RetraceWatchdog
from ..observability.slo import LatencyHistogram
from .admission import AdmissionController
from .batching import MicroBatcher
from .engine import InferenceEngine, bucket_phase
from .stats import agg_stats, agg_update, agg_zero, window_stats


class ServeTelemetryBase:
    """Serve-record plumbing over (timer, watchdog, admission, logger):
    one-time-work deltas against the armed baseline, per-bucket window
    assembly, the requests section, and the request-latency drain.
    Subclasses provide `_pop_completed()` (their resolved PendingResults)
    and `_emit_cost_records()`."""

    def __init__(self, timer: PhaseTimer,
                 admission: Optional[AdmissionController] = None,
                 logger: Optional[MetricLogger] = None,
                 watchdog: Optional[RetraceWatchdog] = None):
        self.timer = timer
        self.admission = admission
        self.logger = logger
        self.watchdog = watchdog if watchdog is not None else \
            RetraceWatchdog()
        self.post_warmup_compiles = 0
        self._armed = False
        self._latency_agg = agg_zero()
        self.flush_count = 0
        # mergeable per-bucket latency histograms (observability.slo) and
        # the cumulative answered/failed counters
        self.latency_hist: dict = {}
        self.answered_total = 0
        self.failed_total = 0
        self._window_ms: list = []

    # hooks ------------------------------------------------------------- #
    def _pop_completed(self):
        return []

    def _emit_cost_records(self):
        pass

    # shared assembly ---------------------------------------------------- #
    def arm(self, emit_cost_records: bool = True):
        """Baseline the one-time-work count after warmup: every event from
        here on counts against the zero-after-warmup contract. Also writes
        each warmed bucket's `cost` record."""
        self.watchdog.check()        # the first check arms the watchdog
        self._armed = True
        if emit_cost_records and self.logger is not None:
            self._emit_cost_records()

    def _check_runtime(self) -> dict:
        """Watchdog snapshot + armed delta accumulation (shared by flush
        and close, so that a straggler drain cannot escape the
        verdict)."""
        runtime = self.watchdog.check()
        if self._armed:
            self.post_warmup_compiles += runtime['compile_events_delta']
        return runtime

    def _bucket_windows(self, buckets) -> dict:
        """The serve record's `buckets` section off the timer's window
        percentiles (resets the window)."""
        timing = self.timer.window_summary()
        return {str(b): timing[bucket_phase(b)]
                for b in buckets if bucket_phase(b) in timing}

    def _requests_section(self, served: int) -> dict:
        requests = dict(
            served=served,
            rejected=(self.admission.snapshot()['rejected']
                      if self.admission else {}),
        )
        if self.admission is not None:
            requests['admitted'] = self.admission.admitted
        return requests

    def _drain_latencies(self):
        ms = []
        for p in self._pop_completed():
            if p.latency_s is not None:
                lat = p.latency_s * 1e3
                ms.append(lat)
                if p.ok:
                    # only answered latencies feed the SLO histograms
                    self.latency_hist.setdefault(
                        str(p.bucket), LatencyHistogram()).observe(lat)
            if p.ok:
                self.answered_total += 1
            elif p.done and p.error is not None:
                self.failed_total += 1
        agg_update(self._latency_agg, ms)
        self._window_ms.extend(ms)
        return ms

    def _latency_sections(self) -> dict:
        """The serve record's latency fields (the window accumulates
        across drains)."""
        self._drain_latencies()
        window, self._window_ms = self._window_ms, []
        fields = {}
        if window:
            fields['request_latency_ms'] = window_stats(window)
        if self.latency_hist:
            fields['latency_hist'] = {
                b: h.snapshot()
                for b, h in sorted(self.latency_hist.items())}
        return fields

    def _emit(self, kind: str, fields: dict) -> dict:
        if kind == 'serve':
            self.flush_count += 1
        if self.logger is not None:
            return self.logger.log_record(kind, **fields)
        return fields


class ServeTelemetry(ServeTelemetryBase):
    """Wire an engine + batcher + admission controller into the JSONL
    telemetry stream.

        tele = ServeTelemetry(engine, batcher, admission, logger)
        tele.arm()              # baseline after the engine's warmup
        ... serve ...
        tele.flush()            # one `serve` record per interval
        tele.close()            # cumulative `summary` record
        assert tele.post_warmup_compiles == 0
    """

    def __init__(self, engine: InferenceEngine,
                 batcher: Optional[MicroBatcher] = None,
                 admission: Optional[AdmissionController] = None,
                 logger: Optional[MetricLogger] = None,
                 watchdog: Optional[RetraceWatchdog] = None):
        super().__init__(engine.timer, admission, logger,
                         watchdog if watchdog is not None
                         else RetraceWatchdog(device=engine.device))
        self.engine = engine
        self.batcher = batcher

    def _pop_completed(self):
        return self.batcher.pop_completed() if self.batcher is not None \
            else []

    def _emit_cost_records(self):
        for key in sorted(self.engine.cost_payloads):
            self.logger.log_record('cost', mirror=False,
                                   **self.engine.cost_payloads[key])

    def flush(self) -> dict:
        """One schema'd `serve` record: per-bucket window percentiles,
        request counters, queue depth, watchdog snapshot."""
        runtime = self._check_runtime()
        fields = dict(
            requests=self._requests_section(
                sum(self.engine.rows_served.values())),
            buckets=self._bucket_windows(self.engine.buckets),
            queue_depth=(self.batcher.queue_depth
                         if self.batcher is not None else 0),
            runtime=runtime,
            post_warmup_compiles=self.post_warmup_compiles,
        )
        fields.update(self._latency_sections())
        return self._emit('serve', fields)

    def close(self) -> dict:
        """Cumulative `summary` record: total batches, request-latency /
        batch-fill metric windows, per-bucket cumulative timing, the
        engine's counters, and the one-time-work verdict."""
        # a final watchdog check: work between the last flush and close
        # (a straggler drain) must not escape the verdict
        self._check_runtime()
        self._drain_latencies()
        metrics = dict(request_latency_ms=agg_stats(self._latency_agg))
        if self.batcher is not None:
            metrics['batch_fill'] = agg_stats(self.batcher.fill_stats)
        fields = dict(
            steps=(self.batcher.batches_dispatched
                   if self.batcher is not None
                   else sum(self.engine.batches_served.values())),
            metrics=metrics,
            timing=self.timer.cumulative_summary(),
            engine=self.engine.stats(),
            post_warmup_compiles=self.post_warmup_compiles,
            retrace_warnings_total=self.watchdog.warnings_total,
        )
        if self.admission is not None:
            fields['requests'] = self.admission.snapshot()
        return self._emit('summary', fields)
