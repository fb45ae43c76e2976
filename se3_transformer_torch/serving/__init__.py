"""Multi-replica serving on one host: the port of se3_transformer_tpu/serving
(its single-host tier).

  * `replica`: `ContinuousBatcher` (requests admitted into in-flight bucket
    slots; a slot dispatches the moment it fills, the deadline only a
    fallback) and `ReplicaWorker` (a batcher and its `InferenceEngine`,
    with `drain()` and `swap_weights()`; with `async_dispatch=True` its
    own executor thread and, on a card, its own CUDA stream).
  * `router`: `Router`: least-outstanding placement over the replicas,
    shedding through the `AdmissionController`, rolling weight swaps
    (`swap_weights`, `swap_from_checkpoint`), and the fault domain:
    health-aware placement, retries with redispatch, deadlines. It refuses
    replicas whose engines share parameter storage.
  * `health`: `HealthConfig`, `ReplicaHealth`, `HealthMonitor`: the
    per-replica breaker (healthy -> degraded -> quarantined, half-open
    probes with exponential backoff).
  * `telemetry`: `RouterTelemetry`: the extended `serve` record over one
    shared PhaseTimer, and the `fault` record.
  * `chaos`: the seeded fault-injection harness over three replicas,
    `python -m se3_transformer_torch.serving.chaos [--cpu] [--weaken
    none|drop]`.

Entry point: `python -m se3_transformer_torch.inference.serve --replicas N`.
The cross-host tier (JAX's `transport` and `fleet`: RPC, host breakers,
canaried rollouts) is ROADMAP A8.2.
"""
from .health import HealthConfig, HealthMonitor, ReplicaHealth  # noqa: F401
from .replica import ContinuousBatcher, ReplicaWorker  # noqa: F401
from .router import Router  # noqa: F401
from .telemetry import RouterTelemetry  # noqa: F401
