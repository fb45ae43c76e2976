"""The telemetry-stream record contract of the serve path: the port's copy
of se3_transformer_tpu/observability/schema.py for the record kinds the
port writes (pure Python: validating a stream touches no device).

A stream is JSONL; every record carries `kind` and `run_id`. Kinds:

  run_meta  stream header: schema_version, backend, code_rev, host
            {hostname, pid, python, torch}, device metadata. MUST be the
            first record of a stream.
  step      per-step fields: step, t, free-form fields (the serve loop
            writes one per rejected request).
  serve     one per serving flush interval: requests {admitted, served,
            rejected}, buckets (per-bucket latency {count, p50_ms,
            p95_ms, p99_ms, max_ms}: p99 is REQUIRED here), queue_depth,
            runtime (watchdog snapshot), post_warmup_compiles (REQUIRED:
            the zero one-time-work-after-warmup contract rides this
            field), optional latency_hist (mergeable per-bucket
            histograms, validated when present).
  cost      one per warmed bucket (observability.costs.cost_payload):
            label, flops / bytes_accessed with the load-bearing `source`
            (cost_analysis / hlo_estimate / unavailable), memory split
            {argument_bytes, output_bytes, temp_bytes}, peak_bytes, and
            the per-class collective {count, bytes} ledger.
  summary   end-of-run cumulative record (steps, metrics, timing).

Every record the port writes validates under the JAX package's schema as
well (SCHEMA_VERSION is the same). The other kinds of the JAX contract
come with the slices that write them: flush, retrace_warning, pipeline
and guard with ROADMAP A2.5; tune with A6; comm and mesh_sweep with A7;
profile, fault, fleet, trace, slo, transport and the serve record's
multi-replica fields with A8; flash, so2_sweep, v2_sweep, quant_ab and
assembly with the benchmark's A/B records.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Iterable, Union

SCHEMA_VERSION = 1

KNOWN_KINDS = ('run_meta', 'step', 'serve', 'cost', 'summary')

_REQUIRED = {
    'run_meta': ('run_id', 'schema_version', 'backend', 'code_rev', 'host'),
    'step': ('run_id', 'step', 't'),
    # post_warmup_compiles is the load-bearing field of the serving
    # contract (must be 0): a serve record without it is invalid
    'serve': ('run_id', 'requests', 'buckets', 'runtime', 'queue_depth',
              'post_warmup_compiles'),
    # source is the load-bearing field of the cost ledger: a record that
    # cannot say where its numbers came from proves nothing
    'cost': ('run_id', 'label', 'source', 'flops', 'bytes_accessed',
             'memory', 'peak_bytes', 'collectives'),
    'summary': ('run_id', 'steps', 'metrics', 'timing'),
}

_COST_SOURCES = ('cost_analysis', 'hlo_estimate', 'unavailable')
_COST_MEMORY_REQUIRED = ('argument_bytes', 'output_bytes', 'temp_bytes')

_TIMING_REQUIRED = ('count', 'p50_ms', 'p95_ms', 'max_ms')
# serving SLOs are quoted at p99: a serve record without it is invalid
_SERVE_TIMING_REQUIRED = _TIMING_REQUIRED + ('p99_ms',)
_WINDOW_REQUIRED = ('count', 'mean', 'min', 'max')


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
    if 'latency_hist' in rec:
        _validate_latency_hist(rec['latency_hist'], index, 'serve')


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


def _validate_summary(rec, index):
    timing = rec['timing']
    if not isinstance(timing, dict):
        _fail(index, 'timing must be an object')
    for phase, st in timing.items():
        missing = [k for k in _TIMING_REQUIRED
                   if not isinstance(st, dict) or k not in st]
        if missing:
            _fail(index, f'timing[{phase!r}] missing {missing} '
                         f'(per-phase p50/p95 are load-bearing)')
    window = rec['metrics']
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
    elif kind == 'cost':
        _validate_cost(rec, index)
    elif kind == 'summary':
        _validate_summary(rec, index)
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
