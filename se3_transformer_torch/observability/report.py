"""Aggregate JSONL streams into run summaries: the port of
se3_transformer_tpu/observability/report.py.

Two input species, one output shape:

  * bench records (`{"metric", "value", "unit", ...}` lines): grouped by
    metric label, the best of each group, one-sided outlier flagging (a
    slow window is noise, a fast one is not), vs_baseline carried from
    the best record;
  * telemetry streams (schema.py records of a `--telemetry` run), reduced
    to a bench-shaped record with the per-phase p50/p95 and the retrace
    count, and the run's `tune`, `cost` and `profile` records summarized
    beside it.

The comm and fleet summaries come with the parallel package and the
cross-host fleet (ROADMAP A7, A8.2). Pure Python: reading and summarizing touch no
device; only write_record_stream reads the live process's metadata.
"""
from __future__ import annotations

import json
from typing import List, Optional

# one-sided noise gate: host noise only ever makes a window slower, so a
# record more than this far below its group's best is flagged as a
# suspected-noise outlier
OUTLIER_RATIO = 0.85


def load_jsonl(path: str, strict: bool = False) -> List[dict]:
    """Parse a JSONL file. Non-JSON lines are skipped (bench session
    logs can carry stderr interleaving) unless strict=True."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if strict:
                    raise ValueError(f'{path}:{i + 1}: invalid JSON')
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


def _is_bench_record(rec: dict) -> bool:
    return 'metric' in rec and 'value' in rec and 'unit' in rec


def summarize_bench_records(records: List[dict],
                            code_rev: Optional[str] = None,
                            outlier_ratio: float = OUTLIER_RATIO) -> dict:
    """Group bench records by metric label; per group report the best
    record (bench shape preserved), every observed value, the best
    single timing window, and flagged outliers."""
    recs = [r for r in records if _is_bench_record(r)]
    if code_rev:
        recs = [r for r in recs if r.get('code_rev') == code_rev]
    groups = {}
    for r in recs:
        groups.setdefault(r['metric'], []).append(r)

    out_groups = []
    for metric in sorted(groups):
        rs = groups[metric]
        # an implausible-throughput record (rate above bf16 peak — the
        # 19:29Z artifact class) never wins the group; it is flagged
        plausible = [r for r in rs if not r.get('implausible_throughput')]
        best = max(plausible or rs, key=lambda r: r['value'])
        window_rates = [w for r in plausible
                        for w in (r.get('window_rates') or [r['value']])]
        values = sorted((r['value'] for r in rs), reverse=True)
        outliers = sorted(
            {r['value'] for r in rs
             if r['value'] < outlier_ratio * best['value']
             or r.get('implausible_throughput')})
        g = dict(best)  # the bench record shape, verbatim
        g.update(
            runs=len(rs),
            values=values,
            window_best=max(window_rates) if window_rates
            else best['value'],
            outliers=outliers,
        )
        out_groups.append(g)

    return dict(kind='bench_summary',
                n_records=len(recs),
                code_rev=code_rev,
                outlier_ratio=outlier_ratio,
                groups=out_groups)


def summarize_telemetry(records: List[dict],
                        anchor: Optional[float] = None) -> List[dict]:
    """Reduce telemetry stream(s) to bench-shaped run summaries.

    Returns one dict per run_id, in stream order, each matching the
    bench.py record shape (metric/value/unit/vs_baseline/step_ms/
    window_rates/steps_trained/loss trajectory) plus per-phase
    percentiles and the retrace-warning count."""
    runs = {}
    order = []
    for rec in records:
        rid = rec.get('run_id')
        if rid is None:
            continue
        if rid not in runs:
            runs[rid] = dict(meta=None, flushes=[], summary=None,
                             retrace_warnings=0, steps=[], pipeline=None,
                             tune=[], cost=[], profile=[])
            order.append(rid)
        kind = rec.get('kind')
        if kind == 'run_meta':
            runs[rid]['meta'] = rec
        elif kind == 'flush':
            runs[rid]['flushes'].append(rec)
        elif kind == 'summary':
            runs[rid]['summary'] = rec
        elif kind == 'retrace_warning':
            runs[rid]['retrace_warnings'] += 1
        elif kind == 'step':
            runs[rid]['steps'].append(rec)
        elif kind == 'pipeline':
            # cumulative counters: the last record of the run wins
            runs[rid]['pipeline'] = rec
        elif kind == 'tune':
            runs[rid]['tune'].append(rec)
        elif kind == 'cost':
            # one per compiled program (a bucketed engine carries one
            # per shape bucket), all surfaced
            runs[rid]['cost'].append(rec)
        elif kind == 'profile':
            runs[rid]['profile'].append(rec)

    out = []
    for rid in order:
        run = runs[rid]
        meta = run['meta'] or {}
        summary = run['summary'] or {}
        backend = meta.get('backend') or 'cpu'
        on_chip = backend != 'cpu'
        label = summary.get('label') or meta.get('label') or 'telemetry'

        window_rates = [f['nodes_steps_per_sec'] for f in run['flushes']
                        if f.get('nodes_steps_per_sec')]
        value = summary.get('nodes_steps_per_sec')
        if value is None and window_rates:
            # best-of-windows, the bench.py chip estimator (one-sided
            # noise only slows a window down)
            value = max(window_rates)

        timing = summary.get('timing') or {}
        step_t = timing.get('step') or {}
        retraces = summary.get('retrace_warnings_total',
                               run['retrace_warnings'])

        rec = {
            'metric': f'denoise_train_nodes_steps_per_sec'
                      f'({label},backend={backend})',
            'value': round(value, 2) if value else None,
            'unit': f'nodes*steps/sec/{"chip" if on_chip else "cpu-host"}',
            'vs_baseline': round(value / anchor, 3)
            if (value and anchor) else 1.0,
            'step_ms': step_t.get('mean_ms'),
            'step_ms_p50': step_t.get('p50_ms'),
            'step_ms_p95': step_t.get('p95_ms'),
            'step_ms_max': step_t.get('max_ms'),
            'timing': timing,
            'window_rates': [round(w, 2) for w in window_rates],
            'steps_trained': summary.get('steps'),
            'retrace_warnings': retraces,
            'run_id': rid,
            'code_rev': meta.get('code_rev'),
        }
        for k in ('loss_first', 'loss_last', 'loss_decreased'):
            if k in summary:
                rec[k] = summary[k]
        if meta.get('device_kind'):
            rec['device_kind'] = meta['device_kind']
        if run['pipeline'] is not None:
            pipe = run['pipeline']
            rec['pipeline'] = {k: pipe[k] for k in
                               ('steps', 'queue', 'prefetch', 'verdict')
                               if k in pipe}
        if run['tune']:
            rec['kernel_tuning'] = summarize_tune_records(run['tune'])
        if run['cost']:
            rec['cost'] = summarize_cost_records(run['cost'])
        if run['profile']:
            rec['profile'] = summarize_profile_records(run['profile'])
        out.append(rec)
    return out


def summarize_tune_records(records: List[dict]) -> dict:
    """Reduce a tune-record stream (kernels/tune.py) to the
    adopted-vs-heuristic view the run report surfaces: per-verdict
    counts plus the promoted entries with their end-to-end evidence."""
    tunes = [r for r in records if r.get('kind', 'tune') == 'tune']
    verdicts = {}
    for r in tunes:
        v = r.get('verdict', 'unknown')
        verdicts[v] = verdicts.get(v, 0) + 1
    promoted = [
        {k: r[k] for k in ('kernel', 'shape', 'candidate', 'blocks',
                           'step_ms', 'nodes_steps_per_sec', 'pairs',
                           'incumbent') if k in r}
        for r in tunes if r.get('promoted') and r.get('verdict') ==
        'promoted']
    consulted = [
        {k: r[k] for k in ('kernel', 'shape', 'blocks') if k in r}
        for r in tunes if r.get('verdict') == 'consulted']
    return dict(candidates=len(tunes), verdicts=verdicts,
                promoted=promoted, consulted=consulted)


def write_record_stream(path: str, run_id: str,
                        records: List[dict],
                        append: bool = False) -> List[dict]:
    """Schema-valid JSONL telemetry stream: one run_meta header + the
    given records (each a dict WITH its `kind`; run_id is stamped in).
    Every record is validated before anything is written, so a schema
    change breaks loudly in one place. The header's backend and device
    metadata come from the live process (metrics.collect_run_meta), so a
    card's cost and profile records are never labeled as the CPU's."""
    import os

    from .metrics import collect_run_meta
    from .schema import validate_record

    meta = collect_run_meta()
    meta.update(run_id=run_id,
                code_rev=meta.get('code_rev')
                or os.environ.get('SE3_TORCH_CODE_REV', 'dev'),
                backend=meta.get('backend') or 'cpu')
    out = [meta]
    out += [dict(rec, run_id=run_id) for rec in records]
    for r in out:
        validate_record(r)
    # append=True keeps a long-lived bank: each run adds its own run_meta
    # and records
    with open(path, 'a' if append else 'w') as f:
        for r in out:
            f.write(json.dumps(r) + '\n')
    return out


def summarize_cost_records(records: List[dict]) -> dict:
    """Reduce cost records (observability.costs.cost_payload rows) to
    the view the run report surfaces: one row per program label with
    flops/peak memory and the source that produced them (a fallback
    estimate stays distinguishable from XLA's analysis)."""
    costs = [r for r in records if r.get('kind', 'cost') == 'cost']
    programs = []
    for r in costs:
        row = {k: r[k] for k in ('label', 'source', 'flops',
                                 'bytes_accessed') if k in r}
        mem = r.get('memory') or {}
        row['peak_bytes'] = r.get('peak_bytes')
        row['peak_gb'] = round((r.get('peak_bytes') or 0) / 2**30, 3)
        row['temp_bytes'] = mem.get('temp_bytes')
        if r.get('collectives'):
            row['collectives'] = r['collectives']
        programs.append(row)
    return dict(programs=len(programs), by_program=programs)


def summarize_profile_records(records: List[dict]) -> dict:
    """Reduce profile records (observability.profiling.profile_payload
    rows) to the surfaced view: per-program coverage, device time, and
    the hottest scopes."""
    profs = [r for r in records if r.get('kind', 'profile') == 'profile']
    programs = []
    for r in profs:
        row = {k: r[k] for k in ('label', 'device_time_ms', 'coverage',
                                 'steps') if k in r}
        scopes = r.get('scopes') or {}
        row['scopes'] = {
            s: st.get('share') for s, st in
            sorted(scopes.items(),
                   key=lambda kv: -(kv[1].get('time_ms') or 0))}
        if r.get('roofline'):
            row['roofline'] = r['roofline']
        programs.append(row)
    return dict(programs=len(programs), by_program=programs)


def summarize(records: List[dict], anchor: Optional[float] = None,
              code_rev: Optional[str] = None):
    """Auto-detect the stream species and summarize. A mixed stream is
    summarized as bench records if any are present (telemetry runs in
    the same file still summarize via their run_ids)."""
    if any(_is_bench_record(r) for r in records):
        return summarize_bench_records(records, code_rev=code_rev)
    tele = summarize_telemetry(records, anchor=anchor)
    if len(tele) == 1:
        return tele[0]
    return dict(kind='telemetry_summary', runs=tele)
