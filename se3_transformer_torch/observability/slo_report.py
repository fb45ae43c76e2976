"""Render a fleet's JSONL stream into its SLO and tracing dashboard: the
counterpart of the repository's scripts/slo_report.py.

    python -m se3_transformer_torch.observability.slo_report STREAM.jsonl
        [--out DASHBOARD.json]

Reads the stream a traced fleet run writes (`python -m
se3_transformer_torch.serving.slo_smoke`, or the fleet chaos run) and
renders: fleet availability against the SLO target, the error budget's
burn rate, per-bucket merged-fleet latency percentiles (exact at bucket
resolution: the hosts' histograms share fixed boundaries and merge by
count addition), breaker-state dwell times, the rollout and rollback
history, and the tracing verdict (complete span trees, orphans,
cross-host redispatch hops).

Exits non-zero when the stream is not dashboard-grade:

  * a record fails the schema;
  * no `slo` record (nothing to aggregate);
  * a `trace` record with orphan spans or completeness below 1.0 (the
    span-tree invariant is broken, so the dashboard's attributions cannot
    be trusted).

A stream with an `slo` record and no `trace` record renders with a
warning. Pure Python: it touches no device.
"""
import argparse
import json
import sys

from .report import load_jsonl
from .schema import SchemaError, validate_record


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description='fleet SLO + tracing dashboard from a JSONL stream')
    ap.add_argument('stream', help='JSONL stream with slo/trace records')
    ap.add_argument('--out', default=None,
                    help='also write the dashboard JSON here')
    return ap.parse_args(argv)


def _pct(x, digits=4):
    return f'{100.0 * x:.{digits}g}%'


def _render_slo(slo):
    eb = slo.get('error_budget', {})
    lines = [
        'fleet SLO',
        f'  hosts reporting     {slo.get("hosts")}',
        f'  availability        {_pct(slo["availability"])} '
        f'(target {_pct(eb.get("target", 0))})',
        f'  answered / failed   {slo.get("answered")} / '
        f'{slo.get("request_failures")} '
        f'(+{slo.get("timeouts", 0)} timeouts)',
        f'  error-budget burn   {eb.get("burn_rate")}x '
        f'(budget {_pct(eb.get("budget", 0))})',
    ]
    lines.append('  latency (merged-fleet percentiles, ms)')
    lines.append('    bucket   count      p50      p95      p99')
    for b, pct in sorted(slo.get('buckets', {}).items(),
                         key=lambda kv: int(kv[0])):
        lines.append(
            f'    {b:>6}  {pct.get("count", 0):>6}'
            + ''.join(f'  {pct.get(k) if pct.get(k) is not None else "-":>7}'
                      for k in ('p50_ms', 'p95_ms', 'p99_ms')))
    dwell = slo.get('breaker_dwell', {})
    if dwell:
        lines.append('  breaker dwell (s, share of window per state)')
        for host, states in sorted(dwell.items()):
            parts = ' '.join(f'{st}={round(sec, 3)}'
                             for st, sec in sorted(states.items()))
            lines.append(f'    host {host}: {parts}')
    ro = slo.get('rollouts', {})
    lines.append(f'  rollouts            {ro.get("count", 0)} '
                 f'({ro.get("completed", 0)} completed, '
                 f'{ro.get("rollbacks", 0)} rolled back)')
    return lines


def _render_trace(trace):
    lines = [
        'request tracing',
        f'  span trees          {trace["complete_trees"]}/'
        f'{trace["traces"]} complete '
        f'(completeness {trace["completeness_total"]})',
        f'  orphan spans        {trace["orphan_spans"]}',
        f'  retry hops          {trace["retry_hops"]} in-host, '
        f'{trace["redispatch_hops"]} cross-host',
        f'  multi-host traces   {trace["multi_host_traces"]}',
        '  exclusive time by span (ms)',
    ]
    by_name = trace.get('spans_by_name', {})
    for name, agg in sorted(by_name.items(),
                            key=lambda kv: -kv[1].get('exclusive_ms', 0)):
        lines.append(f'    {name:<12} n={agg.get("count", 0):>4}  '
                     f'excl={agg.get("exclusive_ms")}')
    return lines


def main(argv=None):
    args = parse_args(argv)
    records = load_jsonl(args.stream)
    ok = True
    for i, rec in enumerate(records):
        try:
            validate_record(rec)
        except SchemaError as e:
            print(f'FAIL: record {i}: {e}', file=sys.stderr)
            ok = False
    slos = [r for r in records if r.get('kind') == 'slo']
    traces = [r for r in records if r.get('kind') == 'trace']

    if not slos:
        print('FAIL: no slo record in the stream: nothing to aggregate '
              '(run python -m se3_transformer_torch.serving.slo_smoke, or '
              'give the FleetRouter an SLOAggregator)', file=sys.stderr)
        ok = False

    lines = [f'== fleet dashboard: {args.stream} ==']
    slo = slos[-1] if slos else None
    trace = traces[-1] if traces else None
    if slo is not None:
        lines += _render_slo(slo)
    if trace is not None:
        lines += _render_trace(trace)
        if trace['orphan_spans'] > 0:
            print(f'FAIL: {trace["orphan_spans"]} orphan span(s) — '
                  f'span parents are missing, the trace trees cannot '
                  f'be trusted', file=sys.stderr)
            ok = False
        if trace['completeness_total'] < 1.0:
            print(f'FAIL: trace completeness '
                  f'{trace["completeness_total"]} < 1.0 '
                  f'({trace["complete_trees"]}/{trace["traces"]} '
                  f'single-root trees)', file=sys.stderr)
            ok = False
    else:
        lines.append('WARNING: no trace record — tracing not armed '
                     '(SLO view only)')

    print('\n'.join(lines))
    dashboard = dict(stream=args.stream, ok=ok,
                     slo=slo, trace=trace)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(dashboard, f, indent=2)
        print(f'dashboard JSON -> {args.out}')
    if ok:
        print('DASHBOARD OK')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
