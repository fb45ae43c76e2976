"""The telemetry-stream record contract of the serve and training paths: the
port's copy of se3_transformer_tpu/observability/schema.py for the record
kinds the port writes (pure Python: validating a stream touches no
device).

A stream is JSONL; every record carries `kind` and `run_id`. Kinds:

  run_meta         stream header: schema_version, backend, code_rev, host
                   {hostname, pid, python, torch}, device metadata. MUST
                   be the first record of a stream.
  step             per-step fields: step, t, free-form fields (the serve
                   loop writes one per rejected request).
  flush            one per training flush interval: step, window
                   (per-metric {count, mean, min, max} from the on-device
                   MetricAccumulator), timing (per-phase {count, p50_ms,
                   p95_ms, max_ms, mean_ms}), runtime (the watchdog
                   snapshot: compile_events, retraced, memory), optional
                   nodes_steps_per_sec.
  retrace_warning  one-time host work after the first step (the loud copy
                   of the flush's `retraced` payload).
  pipeline         one per flush interval (and one at close) of a
                   pipelined training run: steps delivered, queue
                   {capacity, depth_mean}, prefetch {depth, hits, stalls,
                   hit_rate, host_wait_ms, place_ms}, a producer_bound /
                   device_bound / balanced verdict, and the optional
                   source {retries, skipped} of the BatchProducer.
  serve            one per serving flush interval: requests {admitted,
                   served, rejected}, buckets (per-bucket latency {count,
                   p50_ms, p95_ms, p99_ms, max_ms}: p99 is REQUIRED
                   here), queue_depth, runtime (watchdog snapshot),
                   post_warmup_compiles (REQUIRED: the zero
                   one-time-work-after-warmup contract rides this field),
                   optional latency_hist (mergeable per-bucket histograms,
                   validated when present). A router's records
                   (serving.RouterTelemetry) add, validated when present:
                   replicas (per replica id {depth, ...}), swaps {count,
                   events}, continuous_admissions, model_families, the
                   retries / request_failures / timeouts / deadline_sheds
                   counters and health (per replica id {state, ...});
                   a fleet host's add transport (its wire's counters
                   {connections_opened, reconnects, peak_in_flight,
                   bytes_sent, bytes_received, frame_errors}).
  cost             one per warmed bucket (observability.costs.cost_payload):
                   label, flops / bytes_accessed with the load-bearing
                   `source` (cost_analysis / hlo_estimate / unavailable),
                   memory split {argument_bytes, output_bytes,
                   temp_bytes}, peak_bytes, and the per-class collective
                   {count, bytes} ledger.
  tune             one per step of the kernel tuner (kernels/tune.py):
                   kernel (the tuning kind), shape, candidate, blocks,
                   the load-bearing verdict (admitted / promoted /
                   rejected / consulted / error) and promoted (bool).
  profile          one per profiled program (observability.profiling):
                   label, scopes (per-scope {time_ms, share}),
                   device_time_ms and the load-bearing coverage (the
                   attributed share, in [0, 1]); optional roofline,
                   unattributed_top, steps, tracks.
  fault            one per chaos or serving run of the router
                   (serving.RouterTelemetry.fault_flush, exercised by
                   serving/chaos.py): injections (the seeded
                   FaultInjector's firing log) and injections_total,
                   health_transitions (per-replica breaker moves) and
                   recoveries (quarantine -> live), the retries /
                   request_failures / timeouts / deadline_sheds counters,
                   and the load-bearing verdict lost_requests (submits
                   that resolved neither answered nor with a structured
                   error: must be 0).
  guard            one per guarded training run (training.guardian): the
                   counters {trips, rollbacks, restarts, skipped_batches,
                   preemptions, injections_total}, cumulative across
                   process restarts (the guardian's sidecar carries them
                   over a kill), and the load-bearing `diverged` bit
                   (final parameters non-finite, or a trip the rollback
                   policy never paid down).
  fleet            one per fleet run or phase (serving.fleet.FleetRouter.
                   record_body): hosts (per host id {state, ...} and the
                   scraped stats), host_transitions, recoveries,
                   cross_host_retries, request_failures, timeouts,
                   rollouts {count, events: [{canary, passed, ...}]},
                   rollbacks, and the load-bearing lost_requests (must be
                   0); optional transport (the hosts' wire counters).
  trace            one per traced run (observability.tracing.
                   trace_record_body): traces, complete_trees,
                   spans_total, spans_by_name (per name {count, total_ms,
                   exclusive_ms}), retry_hops and redispatch_hops (they
                   reconcile with the routers' retry counters),
                   multi_host_traces, and the load-bearing pair
                   orphan_spans (must be 0) and completeness_total (the
                   share of answered or structured-failed requests with
                   exactly one single-root span tree: must be 1.0).
  slo              one per fleet run (observability.slo.SLOAggregator.
                   record_body): hosts folded, the load-bearing
                   availability (answered / (answered + failures)),
                   answered / request_failures / timeouts, buckets
                   (per-bucket p50/p95/p99 off merged histograms),
                   error_budget {target, budget, burn_rate},
                   breaker_dwell (per host, seconds in each state) and
                   rollouts {count, completed, rollbacks}.
  transport        one per wire A/B (serving.loadgen): workload {requests,
                   ...}, arms {legacy, binary} (each {requests, errors,
                   qps, p50_ms, p99_ms, bytes_per_call}), the ratios
                   qps_binary_vs_legacy, p99_binary_vs_legacy and
                   wire_bytes_binary_vs_legacy, and the binary arm's
                   transport counters.
  summary          end-of-run cumulative record (steps, metrics, timing);
                   a training run's (DenoiseTrainer.telemetry_close) also
                   carries label, retrace_warnings_total,
                   nodes_steps_per_sec, loss_first, loss_last and
                   loss_decreased.

Every record the port writes validates under the JAX package's schema as
well (SCHEMA_VERSION is the same). The other kinds of the JAX contract
come with the slices that write them: comm and mesh_sweep with ROADMAP
A7; flash, so2_sweep, v2_sweep, quant_ab and assembly with the
benchmark's A/B records.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Iterable, Union

SCHEMA_VERSION = 1

KNOWN_KINDS = ('run_meta', 'step', 'flush', 'retrace_warning', 'pipeline',
               'serve', 'tune', 'cost', 'profile', 'fault', 'guard',
               'fleet', 'trace', 'slo', 'transport', 'summary')

_REQUIRED = {
    'run_meta': ('run_id', 'schema_version', 'backend', 'code_rev', 'host'),
    'step': ('run_id', 'step', 't'),
    'flush': ('run_id', 'step', 'window', 'timing', 'runtime'),
    'retrace_warning': ('run_id', 'retraced'),
    # the verdict is the load-bearing field: a pipeline record that cannot
    # say who waited on whom proves nothing
    'pipeline': ('run_id', 'steps', 'queue', 'prefetch', 'verdict'),
    # post_warmup_compiles is the load-bearing field of the serving
    # contract (must be 0): a serve record without it is invalid
    'serve': ('run_id', 'requests', 'buckets', 'runtime', 'queue_depth',
              'post_warmup_compiles'),
    # verdict and promoted are the load-bearing pair of the tuner: a tune
    # record that cannot say what happened to the candidate (and whether
    # the table changed) proves nothing
    'tune': ('run_id', 'kernel', 'shape', 'candidate', 'blocks', 'verdict',
             'promoted'),
    # coverage is the load-bearing field of the attribution: a profile
    # record that cannot say how much device time its scopes account for
    # proves nothing about where the time went
    'profile': ('run_id', 'label', 'scopes', 'device_time_ms', 'coverage'),
    # source is the load-bearing field of the cost ledger: a record that
    # cannot say where its numbers came from proves nothing
    'cost': ('run_id', 'label', 'source', 'flops', 'bytes_accessed',
             'memory', 'peak_bytes', 'collectives'),
    # lost_requests is the load-bearing field of the serving fault domain:
    # a fault record that cannot say whether every submit resolved
    # answered or with a structured error proves nothing (and
    # injections_total 0 proves nothing was exercised)
    'fault': ('run_id', 'label', 'injections', 'injections_total',
              'health_transitions', 'recoveries', 'retries',
              'request_failures', 'timeouts', 'lost_requests'),
    # diverged is the load-bearing field of the training fault domain: a
    # guard record that cannot say whether the run ended on finite,
    # policy-clean parameters proves nothing (and injections_total 0
    # proves nothing was exercised)
    'guard': ('run_id', 'step', 'trips', 'rollbacks', 'restarts',
              'skipped_batches', 'preemptions', 'injections_total',
              'diverged'),
    # lost_requests is the load-bearing field of the cross-host fault
    # domain: a fleet record that cannot say whether every submit
    # resolved answered or structured across host deaths, redispatches
    # and a canaried rollout proves nothing
    'fleet': ('run_id', 'label', 'hosts', 'host_transitions',
              'recoveries', 'cross_host_retries', 'request_failures',
              'timeouts', 'rollouts', 'rollbacks', 'lost_requests'),
    # orphan_spans and completeness_total are the load-bearing pair of
    # tracing: a trace record that cannot say whether every resolved
    # request produced exactly one single-root span tree proves nothing
    'trace': ('run_id', 'label', 'traces', 'complete_trees',
              'orphan_spans', 'spans_total', 'spans_by_name',
              'retry_hops', 'redispatch_hops', 'multi_host_traces',
              'completeness_total'),
    # availability is the load-bearing field of the SLO record, and its
    # bucket percentiles come from merged histograms, never averaged
    'slo': ('run_id', 'label', 'hosts', 'availability', 'answered',
            'request_failures', 'timeouts', 'buckets', 'error_budget',
            'breaker_dwell', 'rollouts'),
    # the binary-vs-legacy ratios are the load-bearing trio of the wire
    # A/B: faster, no worse at the tail, lighter on the wire, on one
    # seeded workload
    'transport': ('run_id', 'label', 'workload', 'arms',
                  'qps_binary_vs_legacy', 'p99_binary_vs_legacy',
                  'wire_bytes_binary_vs_legacy', 'transport'),
    'summary': ('run_id', 'steps', 'metrics', 'timing'),
}

_TUNE_VERDICTS = ('admitted', 'promoted', 'rejected', 'consulted',
                  'error')
_COST_SOURCES = ('cost_analysis', 'hlo_estimate', 'unavailable')
_PROFILE_SCOPE_REQUIRED = ('time_ms', 'share')
_COST_MEMORY_REQUIRED = ('argument_bytes', 'output_bytes', 'temp_bytes')

_TIMING_REQUIRED = ('count', 'p50_ms', 'p95_ms', 'max_ms')
# serving SLOs are quoted at p99: a serve record without it is invalid
_SERVE_TIMING_REQUIRED = _TIMING_REQUIRED + ('p99_ms',)
_WINDOW_REQUIRED = ('count', 'mean', 'min', 'max')
_PIPELINE_PREFETCH_REQUIRED = ('depth', 'hits', 'stalls')
_PIPELINE_VERDICTS = ('producer_bound', 'device_bound', 'balanced')
_FAULT_COUNTERS = ('injections_total', 'recoveries', 'retries',
                   'request_failures', 'timeouts', 'lost_requests')
_HEALTH_STATES = ('healthy', 'degraded', 'quarantined')
_GUARD_COUNTERS = ('trips', 'rollbacks', 'restarts', 'skipped_batches',
                   'preemptions', 'injections_total')
_FLEET_COUNTERS = ('recoveries', 'cross_host_retries', 'request_failures',
                   'timeouts', 'rollbacks', 'lost_requests')
# the wire's counters: the optional `transport` section of serve and fleet
# records, and the required one of the transport record
_TRANSPORT_COUNTERS = ('connections_opened', 'reconnects',
                       'peak_in_flight', 'bytes_sent', 'bytes_received',
                       'frame_errors')
_TRANSPORT_ARM_REQUIRED = ('requests', 'errors', 'qps', 'p50_ms',
                           'p99_ms', 'bytes_per_call')


class SchemaError(ValueError):
    pass


def _fail(index, msg):
    where = f'record {index}: ' if index is not None else ''
    raise SchemaError(where + msg)


def _validate_latency_hist(hist, index, where):
    """One mergeable-histogram section: bucket -> {bounds, counts, count}.
    Counts must have one more slot than bounds (the overflow bucket) and
    sum to count: a snapshot that cannot merge exactly is worse than
    none."""
    if not isinstance(hist, dict):
        _fail(index, f'{where}.latency_hist must be an object '
                     f'(bucket -> histogram snapshot)')
    for bucket, snap in hist.items():
        if not isinstance(snap, dict):
            _fail(index, f'{where}.latency_hist[{bucket!r}] must be an '
                         f'object')
        bounds, counts = snap.get('bounds'), snap.get('counts')
        if not isinstance(bounds, list) or not isinstance(counts, list) \
                or len(counts) != len(bounds) + 1:
            _fail(index, f'{where}.latency_hist[{bucket!r}] must carry '
                         f'bounds plus len(bounds)+1 counts (the last '
                         f'slot is the overflow bucket)')
        total = snap.get('count')
        if not isinstance(total, int) or isinstance(total, bool) \
                or total < 0:
            _fail(index, f'{where}.latency_hist[{bucket!r}].count must '
                         f'be a non-negative int, got {total!r}')
        if sum(counts) != total:
            _fail(index, f'{where}.latency_hist[{bucket!r}].count='
                         f'{total} contradicts counts summing to '
                         f'{sum(counts)}: the snapshot cannot merge '
                         f'exactly')


def _validate_serve(rec, index):
    requests = rec['requests']
    if not isinstance(requests, dict) or 'served' not in requests \
            or 'rejected' not in requests:
        _fail(index, 'serve.requests must carry served and rejected')
    buckets = rec['buckets']
    if not isinstance(buckets, dict):
        _fail(index, 'serve.buckets must be an object')
    for bucket, st in buckets.items():
        missing = [k for k in _SERVE_TIMING_REQUIRED
                   if not isinstance(st, dict) or k not in st]
        if missing:
            _fail(index, f'buckets[{bucket!r}] missing {missing} '
                         f'(per-bucket p50/p95/p99 are the SLO surface)')
    _validate_router_fields(rec, index)
    if 'transport' in rec:
        _validate_transport_section(rec['transport'], index,
                                    'serve.transport')
    if 'latency_hist' in rec:
        _validate_latency_hist(rec['latency_hist'], index, 'serve')


def _non_negative_int(val) -> bool:
    return isinstance(val, int) and not isinstance(val, bool) and val >= 0


def _number(val) -> bool:
    return isinstance(val, (int, float)) and not isinstance(val, bool)


def _validate_transport_section(val, index, where):
    """The wire's counter section: every counter present and a
    non-negative int."""
    if not isinstance(val, dict):
        _fail(index, f'{where} must be an object, got '
                     f'{type(val).__name__}')
    for field in _TRANSPORT_COUNTERS:
        if not _non_negative_int(val.get(field)):
            _fail(index, f'{where}.{field} must be a non-negative int '
                         f'(the transport counter contract), got '
                         f'{val.get(field)!r}')


def _validate_transitions(entries, index, where):
    for e in entries:
        if not isinstance(e, dict) or 'from_state' not in e \
                or 'to_state' not in e:
            _fail(index, f'{where} entries must carry from_state/to_state, '
                         f'got {e!r}')


def _validate_model_families(val, index, where):
    """A list of the model families served: non-empty, of non-empty
    strings."""
    if not isinstance(val, list) or not val or any(
            not isinstance(f, str) or not f for f in val):
        _fail(index, f'{where} must be a non-empty list of non-empty '
                     f'strings (model families served), got {val!r}')


def _validate_router_fields(rec, index):
    """The serve record's multi-replica fields (serving.RouterTelemetry):
    optional, validated when present."""
    if 'continuous_admissions' in rec and \
            not _non_negative_int(rec['continuous_admissions']):
        _fail(index, f'serve.continuous_admissions must be a non-negative '
                     f'int, got {rec["continuous_admissions"]!r}')
    if 'replicas' in rec:
        replicas = rec['replicas']
        if not isinstance(replicas, dict):
            _fail(index, 'serve.replicas must be an object (replica id -> '
                         'snapshot)')
        for rid, snap in replicas.items():
            if not isinstance(snap, dict) or 'depth' not in snap:
                _fail(index, f'replicas[{rid!r}] must carry depth '
                             f'(per-replica depth is the load surface)')
            if 'model_family' in snap and (
                    not isinstance(snap['model_family'], str)
                    or not snap['model_family']):
                _fail(index, f'replicas[{rid!r}].model_family must be a '
                             f'non-empty string, got '
                             f'{snap["model_family"]!r}')
    if 'model_families' in rec:
        _validate_model_families(rec['model_families'], index,
                                 'serve.model_families')
    if 'swaps' in rec:
        swaps = rec['swaps']
        if not isinstance(swaps, dict) \
                or not isinstance(swaps.get('count'), int) \
                or not isinstance(swaps.get('events'), list):
            _fail(index, f'serve.swaps must carry an int count and an '
                         f'events list, got {swaps!r}')
    for field in ('retries', 'request_failures', 'timeouts',
                  'deadline_sheds'):
        if field in rec and not _non_negative_int(rec[field]):
            _fail(index, f'serve.{field} must be a non-negative int, got '
                         f'{rec[field]!r}')
    if 'health' in rec:
        health = rec['health']
        if not isinstance(health, dict):
            _fail(index, 'serve.health must be an object (replica id -> '
                         'breaker snapshot)')
        for rid, snap in health.items():
            if not isinstance(snap, dict) \
                    or snap.get('state') not in _HEALTH_STATES:
                _fail(index, f'serve.health[{rid!r}] must carry a state '
                             f'in {_HEALTH_STATES}')


def _validate_fault(rec, index):
    for field in ('injections', 'health_transitions'):
        if not isinstance(rec[field], list):
            _fail(index, f'fault.{field} must be a list (the evidence '
                         f'log, empty when clean)')
    for field in _FAULT_COUNTERS:
        if not _non_negative_int(rec[field]):
            _fail(index, f'fault.{field} must be a non-negative int, got '
                         f'{rec[field]!r}')
    if rec['injections_total'] != len(rec['injections']):
        _fail(index, f'fault.injections_total={rec["injections_total"]} '
                     f'contradicts {len(rec["injections"])} logged '
                     f'injections')
    _validate_transitions(rec['health_transitions'], index,
                          'fault.health_transitions')


def _validate_fleet(rec, index):
    hosts = rec['hosts']
    if not isinstance(hosts, dict) or not hosts:
        _fail(index, 'fleet.hosts must be a non-empty object (host id -> '
                     'breaker snapshot and scraped signals)')
    for hid, snap in hosts.items():
        if not isinstance(snap, dict) \
                or snap.get('state') not in _HEALTH_STATES:
            _fail(index, f'fleet.hosts[{hid!r}] must carry a state in '
                         f'{_HEALTH_STATES}')
        stats = snap.get('stats')
        if isinstance(stats, dict) and 'model_families' in stats:
            _validate_model_families(
                stats['model_families'], index,
                f'fleet.hosts[{hid!r}].stats.model_families')
    if not isinstance(rec['host_transitions'], list):
        _fail(index, 'fleet.host_transitions must be a list (the host '
                     'breakers\' evidence log, empty when clean)')
    _validate_transitions(rec['host_transitions'], index,
                          'fleet.host_transitions')
    for field in _FLEET_COUNTERS:
        if not _non_negative_int(rec[field]):
            _fail(index, f'fleet.{field} must be a non-negative int, got '
                         f'{rec[field]!r}')
    rollouts = rec['rollouts']
    if not isinstance(rollouts, dict) \
            or not isinstance(rollouts.get('count'), int) \
            or not isinstance(rollouts.get('events'), list):
        _fail(index, f'fleet.rollouts must carry an int count and an '
                     f'events list, got {rollouts!r}')
    for e in rollouts['events']:
        if not isinstance(e, dict) or 'canary' not in e \
                or 'passed' not in e:
            _fail(index, f'fleet.rollouts.events entries must carry '
                         f'canary/passed (the gate verdict is the '
                         f'evidence), got {e!r}')
    if 'transport' in rec:
        _validate_transport_section(rec['transport'], index,
                                    'fleet.transport')


def _validate_trace(rec, index):
    for field in ('traces', 'complete_trees', 'orphan_spans',
                  'spans_total', 'retry_hops', 'redispatch_hops',
                  'multi_host_traces'):
        if not _non_negative_int(rec[field]):
            _fail(index, f'trace.{field} must be a non-negative int, got '
                         f'{rec[field]!r}')
    comp = rec['completeness_total']
    if not _number(comp) or not 0 <= comp <= 1:
        _fail(index, f'trace.completeness_total must be a number in '
                     f'[0, 1], got {comp!r}')
    if rec['complete_trees'] > rec['traces']:
        _fail(index, f'trace.complete_trees={rec["complete_trees"]} '
                     f'exceeds traces={rec["traces"]}')
    if rec['orphan_spans'] > 0 and rec['traces'] > 0 and comp >= 1.0:
        _fail(index, f'trace.completeness_total={comp} contradicts '
                     f'{rec["orphan_spans"]} orphan spans: an orphan '
                     f'means some tree is incomplete')
    by_name = rec['spans_by_name']
    if not isinstance(by_name, dict):
        _fail(index, 'trace.spans_by_name must be an object (span name -> '
                     'exclusive-duration entry)')
    for name, entry in by_name.items():
        missing = [k for k in ('count', 'total_ms', 'exclusive_ms')
                   if not isinstance(entry, dict) or k not in entry]
        if missing:
            _fail(index, f'trace.spans_by_name[{name!r}] missing '
                         f'{missing}')


def _validate_slo(rec, index):
    for field in ('hosts', 'answered', 'request_failures', 'timeouts'):
        if not _non_negative_int(rec[field]):
            _fail(index, f'slo.{field} must be a non-negative int, got '
                         f'{rec[field]!r}')
    avail = rec['availability']
    if not _number(avail) or not 0 <= avail <= 1:
        _fail(index, f'slo.availability must be a number in [0, 1], got '
                     f'{avail!r}')
    buckets = rec['buckets']
    if not isinstance(buckets, dict):
        _fail(index, 'slo.buckets must be an object (bucket -> merged '
                     'fleet percentiles)')
    for bucket, st in buckets.items():
        missing = [k for k in ('count', 'p50_ms', 'p95_ms', 'p99_ms')
                   if not isinstance(st, dict) or k not in st]
        if missing:
            _fail(index, f'slo.buckets[{bucket!r}] missing {missing}')
    budget = rec['error_budget']
    if not isinstance(budget, dict) or 'target' not in budget \
            or 'burn_rate' not in budget:
        _fail(index, f'slo.error_budget must carry target and burn_rate, '
                     f'got {budget!r}')
    if not isinstance(rec['breaker_dwell'], dict):
        _fail(index, 'slo.breaker_dwell must be an object (host -> '
                     'per-state seconds)')
    rollouts = rec['rollouts']
    if not isinstance(rollouts, dict) \
            or not isinstance(rollouts.get('count'), int) \
            or not isinstance(rollouts.get('rollbacks'), int):
        _fail(index, f'slo.rollouts must carry int count and rollbacks, '
                     f'got {rollouts!r}')


def _validate_transport(rec, index):
    workload = rec['workload']
    if not isinstance(workload, dict) \
            or not _non_negative_int(workload.get('requests')) \
            or workload['requests'] <= 0:
        _fail(index, f'transport.workload must carry a positive int '
                     f'requests count, got {workload!r}')
    arms = rec['arms']
    if not isinstance(arms, dict) or 'legacy' not in arms \
            or 'binary' not in arms:
        _fail(index, 'transport.arms must carry both the legacy and the '
                     'binary arm (the A/B is the record)')
    for name, arm in arms.items():
        missing = [k for k in _TRANSPORT_ARM_REQUIRED
                   if not isinstance(arm, dict) or k not in arm]
        if missing:
            _fail(index, f'transport.arms[{name!r}] missing {missing}')
        for k in _TRANSPORT_ARM_REQUIRED:
            if not _number(arm[k]) or arm[k] < 0:
                _fail(index, f'transport.arms[{name!r}].{k} must be a '
                             f'non-negative number, got {arm[k]!r}')
    for field in ('qps_binary_vs_legacy', 'p99_binary_vs_legacy',
                  'wire_bytes_binary_vs_legacy'):
        if not _number(rec[field]) or rec[field] <= 0:
            _fail(index, f'transport.{field} must be a positive number, '
                         f'got {rec[field]!r}')
    _validate_transport_section(rec['transport'], index,
                                'transport.transport')


def _validate_cost(rec, index):
    if rec['source'] not in _COST_SOURCES:
        _fail(index, f'cost.source {rec["source"]!r} not in '
                     f'{_COST_SOURCES}')
    mem = rec['memory']
    missing = [k for k in _COST_MEMORY_REQUIRED
               if not isinstance(mem, dict) or k not in mem]
    if missing:
        _fail(index, f'cost.memory missing {missing} (the '
                     f'argument/output/temp split IS the ledger)')
    for k in _COST_MEMORY_REQUIRED:
        if not isinstance(mem[k], (int, float)) or mem[k] < 0:
            _fail(index, f'cost.memory[{k!r}] must be a non-negative '
                         f'number, got {mem[k]!r}')
    if not isinstance(rec['peak_bytes'], (int, float)) \
            or rec['peak_bytes'] < 0:
        _fail(index, f'cost.peak_bytes must be a non-negative number, '
                     f'got {rec["peak_bytes"]!r}')
    if rec['source'] == 'cost_analysis' and (
            not isinstance(rec['flops'], (int, float))
            or rec['flops'] < 0):
        _fail(index, f'cost.flops must be a non-negative number when '
                     f'source=cost_analysis, got {rec["flops"]!r}')
    colls = rec['collectives']
    if not isinstance(colls, dict):
        _fail(index, 'cost.collectives must be an object')
    for cls, st in colls.items():
        missing = [k for k in ('count', 'bytes')
                   if not isinstance(st, dict) or k not in st]
        if missing:
            _fail(index, f'cost.collectives[{cls!r}] missing {missing}')


def _validate_tune(rec, index):
    if rec['verdict'] not in _TUNE_VERDICTS:
        _fail(index, f'tune.verdict {rec["verdict"]!r} not in '
                     f'{_TUNE_VERDICTS}')
    if not isinstance(rec['promoted'], bool):
        _fail(index, f'tune.promoted must be a bool, got '
                     f'{rec["promoted"]!r}')
    if rec['verdict'] == 'promoted' and not rec['promoted']:
        _fail(index, 'tune verdict "promoted" requires promoted=true')
    for field in ('candidate', 'blocks', 'shape'):
        val = rec[field]
        if not isinstance(val, (list, tuple)) or \
                not all(isinstance(v, int) for v in val):
            _fail(index, f'tune.{field} must be a list of ints, got '
                         f'{val!r}')


def _validate_profile(rec, index):
    scopes = rec['scopes']
    if not isinstance(scopes, dict):
        _fail(index, 'profile.scopes must be an object')
    for scope, st in scopes.items():
        missing = [k for k in _PROFILE_SCOPE_REQUIRED
                   if not isinstance(st, dict) or k not in st]
        if missing:
            _fail(index, f'profile.scopes[{scope!r}] missing {missing} '
                         f'(per-scope time and share are the whole '
                         f'attribution)')
    cov = rec['coverage']
    if not isinstance(cov, (int, float)) or not 0 <= cov <= 1:
        _fail(index, f'profile.coverage must be a number in [0, 1], got '
                     f'{cov!r}')
    if not isinstance(rec['device_time_ms'], (int, float)) \
            or rec['device_time_ms'] < 0:
        _fail(index, f'profile.device_time_ms must be a non-negative '
                     f'number, got {rec["device_time_ms"]!r}')


def _validate_pipeline(rec, index):
    prefetch = rec['prefetch']
    missing = [k for k in _PIPELINE_PREFETCH_REQUIRED
               if not isinstance(prefetch, dict) or k not in prefetch]
    if missing:
        _fail(index, f'pipeline.prefetch missing {missing} '
                     f'(hit/stall counts are the whole point)')
    if not isinstance(rec['queue'], dict) or 'capacity' not in rec['queue']:
        _fail(index, 'pipeline.queue must carry capacity')
    if rec['verdict'] not in _PIPELINE_VERDICTS:
        _fail(index, f'pipeline.verdict {rec["verdict"]!r} not in '
                     f'{_PIPELINE_VERDICTS}')
    # the BatchProducer's retry/skip counters are optional, validated
    # when present
    if 'source' in rec:
        src = rec['source']
        if not isinstance(src, dict):
            _fail(index, 'pipeline.source must be an object')
        for field in ('retries', 'skipped'):
            val = src.get(field)
            if not isinstance(val, int) or isinstance(val, bool) or val < 0:
                _fail(index, f'pipeline.source.{field} must be a '
                             f'non-negative int, got {val!r}')


def _validate_guard(rec, index):
    for field in _GUARD_COUNTERS + ('step',):
        val = rec[field]
        if not isinstance(val, int) or isinstance(val, bool) or val < 0:
            _fail(index, f'guard.{field} must be a non-negative int, got '
                         f'{val!r}')
    if not isinstance(rec['diverged'], bool):
        _fail(index, f'guard.diverged must be a bool, got '
                     f'{rec["diverged"]!r}')


def _validate_timing_and_window(rec, index):
    """flush and summary: per-phase timing and the metric window."""
    timing = rec['timing']
    if not isinstance(timing, dict):
        _fail(index, 'timing must be an object')
    for phase, st in timing.items():
        missing = [k for k in _TIMING_REQUIRED
                   if not isinstance(st, dict) or k not in st]
        if missing:
            _fail(index, f'timing[{phase!r}] missing {missing} '
                         f'(per-phase p50/p95 are load-bearing)')
    window = rec.get('window') if rec['kind'] == 'flush' else rec['metrics']
    if not isinstance(window, dict):
        _fail(index, 'metric window must be an object')
    for name, st in window.items():
        missing = [k for k in _WINDOW_REQUIRED
                   if not isinstance(st, dict) or k not in st]
        if missing:
            _fail(index, f'window[{name!r}] missing {missing}')


def validate_record(rec: dict, index=None) -> dict:
    """Validate one record; raises SchemaError, returns the record."""
    if not isinstance(rec, dict):
        _fail(index, f'not an object: {type(rec).__name__}')
    kind = rec.get('kind')
    if kind not in KNOWN_KINDS:
        _fail(index, f'unknown kind {kind!r} (known: {KNOWN_KINDS})')
    missing = [k for k in _REQUIRED[kind] if k not in rec]
    if missing:
        _fail(index, f'{kind} record missing required fields {missing}')
    if kind == 'run_meta':
        host = rec['host']
        if not isinstance(host, dict) or 'hostname' not in host \
                or 'pid' not in host:
            _fail(index, 'run_meta.host must carry hostname and pid')
    elif kind == 'step' and not isinstance(rec['step'], int):
        _fail(index, f'step must be an int, got {rec["step"]!r}')
    elif kind == 'serve':
        _validate_serve(rec, index)
    elif kind == 'tune':
        _validate_tune(rec, index)
    elif kind == 'profile':
        _validate_profile(rec, index)
    elif kind == 'cost':
        _validate_cost(rec, index)
    elif kind == 'pipeline':
        _validate_pipeline(rec, index)
    elif kind == 'fault':
        _validate_fault(rec, index)
    elif kind == 'guard':
        _validate_guard(rec, index)
    elif kind == 'fleet':
        _validate_fleet(rec, index)
    elif kind == 'trace':
        _validate_trace(rec, index)
    elif kind == 'slo':
        _validate_slo(rec, index)
    elif kind == 'transport':
        _validate_transport(rec, index)
    elif kind in ('flush', 'summary'):
        _validate_timing_and_window(rec, index)
    return rec


def validate_stream(source: Union[str, Iterable[str]]) -> dict:
    """Validate a JSONL stream (path or iterable of lines).

    Returns {'records': N, 'kinds': {kind: count}, 'run_ids': [...]}.
    Raises SchemaError on the first invalid record; the first record of a
    stream must be run_meta (consumers key everything off it).
    """
    if isinstance(source, str):
        with open(source) as f:
            lines = f.readlines()
    else:
        lines = list(source)
    kinds = Counter()
    run_ids = []
    n = 0
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            _fail(i, f'invalid JSON: {e}')
        validate_record(rec, index=i)
        if n == 0 and rec['kind'] != 'run_meta':
            _fail(i, f'stream must open with run_meta, got {rec["kind"]!r}')
        if rec['kind'] == 'run_meta' and rec['run_id'] not in run_ids:
            run_ids.append(rec['run_id'])
        kinds[rec['kind']] += 1
        n += 1
    if n == 0:
        raise SchemaError('empty stream')
    return dict(records=n, kinds=dict(kinds), run_ids=run_ids)
