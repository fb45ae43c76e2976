"""Serving across replicas and hosts: the port of se3_transformer_tpu/serving.

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

The cross-host tier:

  * `transport`: `LocalTransport`, `SocketTransport` / `serve_socket`
    (newline JSON, a connection a call) and `BinaryTransport` /
    `serve_binary` (pooled, multiplexed, raw numpy frames); every link
    failure is a `TransportError`.
  * `fleet`: `HostServer` (one host's router behind ping, stats, infer,
    swap and drain) and `FleetRouter` (capability-aware placement over
    host breakers, cross-host redispatch, deadline propagation, heartbeats
    and half-open probes, canaried rollouts with auto-rollback, the
    `fleet` record).
  * `fleet_chaos`: hosts as processes, one SIGKILLed and restarted,
    seeded transport faults and a poisoned canary, `python -m
    se3_transformer_torch.serving.fleet_chaos [--cpu] [--weaken
    none|noexclude]`; `slo_smoke`: two in-process hosts with tracing and
    SLO aggregation; `loadgen`: the legacy wire against the binary one.

Entry point: `python -m se3_transformer_torch.inference.serve --replicas
N`, `--host --port P --host-id K` (one fleet host) or `--fleet N`.
"""
from .health import HealthConfig, HealthMonitor, ReplicaHealth  # noqa: F401
from .replica import ContinuousBatcher, ReplicaWorker  # noqa: F401
from .router import Router  # noqa: F401
from .telemetry import RouterTelemetry  # noqa: F401
from .transport import (  # noqa: F401
    BinaryServer, BinaryTransport, FrameError, LocalTransport,
    SocketServer, SocketTransport, TransportError, serve_binary,
    serve_socket,
)
from .fleet import FleetRouter, HostServer  # noqa: F401
