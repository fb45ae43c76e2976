"""Telemetry of the serve and training paths: the port of
se3_transformer_tpu/observability.

  * `metrics`: `MetricAccumulator` (a training step's loss and gradient
    norm summed on the device, one device-to-host copy a flush),
    `MetricLogger`, the schema'd JSONL stream behind a `run_meta` header
    (host, code, card name and power limit), and `merge_windows`.
  * `runtime`: `RetraceWatchdog`, the count of one-time host work (device
    constants built, the kernel library loaded) that must stay 0 after an
    engine's warmup, and `device_memory_stats`.
  * `timing`: `PhaseTimer`, wall-clock reservoirs with windowed and
    cumulative p50/p95/p99 per phase (a device phase ends in a
    synchronize), and `named_scope`.
  * `schema`: the record contract of the kinds the port writes.
  * `costs`: the `cost` record body of one warmed bucket.
  * `slo`: mergeable fixed-boundary latency histograms.

What JAX's package has beyond this (report, profiling, tracing, the SLO
aggregator) comes with ROADMAP A8.
"""
from .costs import cost_payload  # noqa: F401
from .metrics import (  # noqa: F401
    MetricAccumulator, MetricLogger, collect_run_meta, merge_windows,
)
from .runtime import (  # noqa: F401
    RetraceWarning, RetraceWatchdog, device_memory_stats,
)
from .schema import (  # noqa: F401
    SCHEMA_VERSION, SchemaError, validate_record, validate_stream,
)
from .slo import (  # noqa: F401
    LatencyHistogram, histogram_percentiles, merge_histograms,
)
from .timing import PhaseTimer, named_scope  # noqa: F401
