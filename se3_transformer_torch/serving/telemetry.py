"""Cross-replica aggregation into the `serve` record, and the `fault`
record: the port of se3_transformer_tpu/serving/telemetry.py.

One record shape for one replica and for N: both emitters extend
`inference.telemetry.ServeTelemetryBase` (the one-time-work deltas, the
bucket windows, the requests section, the latency drain), so the `serve`
record keeps its required fields and a router's records add only what the
router knows: per-replica counters (`replicas`), the rolling swap events
(`swaps`), `continuous_admissions`, and the fault domain's signals
(per-replica `health`, `retries`, `request_failures`, `timeouts`,
`deadline_sheds`).

The per-bucket percentiles come from one PhaseTimer that every replica's
engine shares (the constructor checks it): each `run()` records its
latency in the same `bucket_<L>` phase whichever replica ran it, so the
record's `buckets` section is the cross-replica latency surface with no
merging of percentiles. Per-replica skew shows in `replicas[i].depth` and
`.served`.

A fleet host's serve records also carry its wire's counters: set
`transport_source` to the socket server's `transport_stats` (the
`--host` entry does) and every serve record gets a schema'd `transport`
section.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..inference.admission import AdmissionController
from ..inference.stats import agg_stats
from ..inference.telemetry import ServeTelemetryBase
from ..observability import MetricLogger, RetraceWatchdog
from .router import Router

# the _router_sections keys that every `fault` record carries too
_FAULT_SECTION_KEYS = ('health', 'retries', 'request_failures',
                       'timeouts', 'deadline_sheds')


class RouterTelemetry(ServeTelemetryBase):
    """Wire a router (and its admission controller) into the JSONL stream.

        tele = RouterTelemetry(router, admission, logger)
        tele.arm()              # after every replica's warmup
        ... serve ...
        tele.flush()            # one extended `serve` record
        tele.fault_flush(injector, pending)   # one `fault` record
        tele.close()            # the cumulative `summary` record
        assert tele.post_warmup_compiles == 0
    """

    def __init__(self, router: Router,
                 admission: Optional[AdmissionController] = None,
                 logger: Optional[MetricLogger] = None,
                 watchdog: Optional[RetraceWatchdog] = None):
        timers = {id(w.engine.timer) for w in router.workers}
        assert len(timers) == 1, \
            'every replica engine must share ONE PhaseTimer (pass ' \
            'timer=... to each InferenceEngine): aggregate percentiles ' \
            'cannot be merged from per-replica reservoirs'
        engine = router.workers[0].engine
        super().__init__(engine.timer, admission, logger,
                         watchdog if watchdog is not None else
                         RetraceWatchdog(device=getattr(engine, 'device',
                                                        None)))
        self.router = router
        # the host's wire counters (the `--host` entry points it at its
        # socket server's transport_stats): every serve record then
        # carries a `transport` section
        self.transport_source: Optional[Callable[[], dict]] = None

    def _pop_completed(self):
        return self.router.pop_completed()

    def _emit_cost_records(self):
        """Each replica's per-bucket cost records, tagged with the
        replica."""
        for w in self.router.workers:
            for key in sorted(w.engine.cost_payloads):
                body = dict(w.engine.cost_payloads[key])
                body['label'] = f'replica_{w.id},' + body['label']
                self.logger.log_record('cost', mirror=False, **body)

    def _router_sections(self) -> dict:
        """The fields the router adds to the serve record (and, through
        _FAULT_SECTION_KEYS, to the fault record)."""
        router = self.router
        return dict(
            replicas={str(w.id): w.snapshot() for w in router.workers},
            # the mixes and families behind the router (each replica's own
            # is in its snapshot)
            precision_mixes=sorted({
                getattr(w.engine, 'precision_name', 'fp32')
                for w in router.workers}),
            model_families=sorted({
                getattr(w.engine, 'model_family', 'se3_v1')
                for w in router.workers}),
            swaps=dict(count=len(router.swap_events),
                       events=list(router.swap_events)),
            continuous_admissions=router.continuous_admissions,
            deadline_flushes=router.deadline_flushes,
            health=router.health.snapshot(),
            retries=router.retries,
            request_failures=router.request_failures,
            timeouts=router.timeouts,
            deadline_sheds=router.deadline_sheds,
        )

    def fault_flush(self, injector=None, pending=None,
                    label: str = 'fault') -> dict:
        """One schema'd `fault` record: what was injected, how the health
        breakers moved, how the retries and deadlines paid it down, and
        the verdict `lost_requests` (submits in `pending` that resolved
        neither answered nor with a structured error; the chaos harness
        gates on 0).

        `injector` (a faults.FaultInjector) gives the injection log;
        `pending` is the caller's full list of submitted PendingResults
        (None: nothing to count, so 0)."""
        router = self.router
        pending = list(pending or [])
        lost = sum(1 for p in pending if not p.done)
        inj = injector.snapshot() if injector is not None else dict(
            seed=None, injections=[], injections_total=0, by_site={})
        # the fault-domain signals come from the serve record's assembly:
        # the two kinds cannot drift
        sections = self._router_sections()
        fields = dict(
            label=label,
            injections=inj['injections'],
            injections_total=inj['injections_total'],
            injections_by_site=inj['by_site'],
            injector_seed=inj['seed'],
            health_transitions=router.health.transitions,
            recoveries=router.health.recoveries,
            **{k: sections[k] for k in _FAULT_SECTION_KEYS},
            submitted=len(pending),
            resolved=sum(1 for p in pending if p.done),
            answered=sum(1 for p in pending if p.ok),
            structured_failures=sum(
                1 for p in pending if p.done and p.error is not None),
            lost_requests=lost,
        )
        return self._emit('fault', fields)

    def flush(self) -> dict:
        """One extended `serve` record: the per-bucket window percentiles,
        the request counters, and the router's sections."""
        router = self.router
        runtime = self._check_runtime()
        fields = dict(
            requests=self._requests_section(
                sum(w.served_rows for w in router.workers)),
            buckets=self._bucket_windows(router.buckets),
            queue_depth=router.queue_depth,
            runtime=runtime,
            post_warmup_compiles=self.post_warmup_compiles,
            **self._router_sections(),
        )
        fields.update(self._latency_sections())
        if self.transport_source is not None:
            fields['transport'] = dict(self.transport_source())
        return self._emit('serve', fields)

    def close(self) -> dict:
        """The cumulative `summary` record across the replicas."""
        self._check_runtime()
        self._drain_latencies()
        router = self.router
        fields = dict(
            steps=router.batches_dispatched,
            metrics=dict(request_latency_ms=agg_stats(self._latency_agg)),
            timing=self.timer.cumulative_summary(),
            replicas={str(w.id): dict(w.snapshot(),
                                      engine=w.engine.stats())
                      for w in router.workers},
            swaps=dict(count=len(router.swap_events),
                       events=list(router.swap_events)),
            continuous_admissions=router.continuous_admissions,
            deadline_flushes=router.deadline_flushes,
            post_warmup_compiles=self.post_warmup_compiles,
            retrace_warnings_total=self.watchdog.warnings_total,
        )
        if self.admission is not None:
            fields['requests'] = self.admission.snapshot()
        return self._emit('summary', fields)
