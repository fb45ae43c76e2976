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
    synchronize), `named_scope`, `MODEL_SCOPES` (the labels the model
    emits) and `profile_trace`.
  * `profiling`: per-scope device time of a profiled call
    (`capture_step_profile`) and its `profile` record
    (`profile_payload`, with a roofline against the card's peaks).
  * `schema`: the record contract of the kinds the port writes.
  * `costs`: the `cost` record body of one warmed bucket (`cost_payload`)
    or one training step (`step_cost_payload`).
  * `report`: run summaries of bench records and telemetry streams (the
    `tune`, `cost` and `profile` records beside), `write_record_stream`.
  * `slo`: mergeable fixed-boundary latency histograms.

What JAX's package has beyond this (tracing, the SLO aggregator, the comm
and fleet summaries) comes with the parallel package and the cross-host
fleet (ROADMAP A7, A8.2).
"""
from .costs import cost_payload, step_cost_payload  # noqa: F401
from .metrics import (  # noqa: F401
    MetricAccumulator, MetricLogger, collect_run_meta, merge_windows,
)
from .profiling import (  # noqa: F401
    StepProfile, attribute_scopes, capture_step_profile, device_time_by_op,
    profile_payload,
)
from .report import (  # noqa: F401
    load_jsonl, summarize, summarize_bench_records, summarize_cost_records,
    summarize_profile_records, summarize_telemetry, summarize_tune_records,
    write_record_stream,
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
from .timing import (  # noqa: F401
    MODEL_SCOPES, PhaseTimer, named_scope, profile_trace,
)
