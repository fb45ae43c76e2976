"""Serving: the port of se3_transformer_tpu/inference.

  * `engine`: `InferenceEngine`, the bucketed engine (a warmup forward per
    bucket, the weight swap, params-only checkpoint restore, the bf16 and
    quantized paths) and `pad_to_bucket`.
  * `batching`: `MicroBatcher`, requests queued per bucket, padded by the
    engine's `pad_to_bucket`, flushed on batch-full or `max_wait_ms`.
  * `admission`: `AdmissionController` + `RequestRejected`: oversize and
    overloaded requests are rejected with a structured error before they
    reach the engine.
  * `telemetry`: `ServeTelemetry`, per-bucket p50/p95/p99 off the
    engine's `PhaseTimer`, schema'd `serve` records, and the watchdog's
    proof that a mixed-length stream sets off no one-time work.

Entry point: `python -m se3_transformer_torch.inference.serve`.
"""
from .admission import (  # noqa: F401
    OVERLOADED, OVERSIZE, AdmissionController, RequestFailed,
    RequestRejected,
)
from .batching import MicroBatcher, PendingResult  # noqa: F401
from .engine import InferenceEngine, bucket_phase, pad_to_bucket  # noqa: F401
from .telemetry import ServeTelemetry  # noqa: F401
