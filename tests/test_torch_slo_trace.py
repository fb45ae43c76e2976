"""The port's request tracing (se3_transformer_torch.observability.tracing)
and SLO aggregation (observability.slo.SLOAggregator) against the JAX
package's on the CPU: mergeable fixed-boundary histograms (merged fleet
percentiles equal pooled-sample percentiles exactly), the tracer's ids and
idempotent end, span trees and the completeness invariant, exclusive
durations within one clock domain, the schema'd `trace` and `slo` records
under both packages' validators, scripted spans and folds that give the
record bodies JAX's give, and a traced two-host fleet with a host death,
end to end."""
import time

import numpy as np
import pytest
import torch

from se3_transformer_torch.observability import schema as tschema
from se3_transformer_torch.observability.slo import (
    DEFAULT_BOUNDS, LatencyHistogram, SLOAggregator, histogram_percentiles,
    merge_histograms,
)
from se3_transformer_torch.observability.tracing import (
    Tracer, complete_request_trees, multi_host_traces, orphan_spans,
    trace_record_body,
)
from se3_transformer_tpu.observability import schema as jschema
from se3_transformer_tpu.observability import slo as jslo
from se3_transformer_tpu.observability import tracing as jtracing

from test_torch_cross_host import NAMESPACES, host, killable

torch.set_num_threads(1)

SCHEMAS = (tschema, jschema)


# --------------------------------------------------------------------- #
# histograms: merged == pooled, exactly
# --------------------------------------------------------------------- #
def test_merged_percentiles_exactly_equal_pooled():
    rng = np.random.RandomState(0)
    host_a = rng.lognormal(mean=2.0, sigma=1.0, size=400)
    host_b = rng.lognormal(mean=3.5, sigma=0.7, size=150)
    ha, hb, pooled = (LatencyHistogram(), LatencyHistogram(),
                      LatencyHistogram())
    for ms in host_a:
        ha.observe(ms)
        pooled.observe(ms)
    for ms in host_b:
        hb.observe(ms)
        pooled.observe(ms)
    merged = merge_histograms([ha.snapshot(), hb.snapshot()])
    got = histogram_percentiles(merged, qs=(50, 90, 95, 99))
    want = histogram_percentiles(pooled.snapshot(), qs=(50, 90, 95, 99))
    assert got == want and got['count'] == 550
    true_p50 = float(np.percentile(np.concatenate([host_a, host_b]), 50))
    i = next(i for i, b in enumerate(DEFAULT_BOUNDS) if b >= got['p50_ms'])
    lo = DEFAULT_BOUNDS[i - 1] if i else 0.0
    assert lo < true_p50 <= got['p50_ms'] * (2 ** 0.25)
    # and JAX merges the port's snapshots to the same percentiles
    assert jslo.histogram_percentiles(jslo.merge_histograms(
        [ha.snapshot(), hb.snapshot()]), qs=(50, 90, 95, 99)) == got


def test_empty_host_merges_as_zero():
    h = LatencyHistogram()
    for ms in (1.0, 5.0, 20.0):
        h.observe(ms)
    alone = histogram_percentiles(h.snapshot())
    merged = merge_histograms([h.snapshot(), LatencyHistogram().snapshot(),
                               None])
    assert histogram_percentiles(merged) == alone
    empty = merge_histograms([])
    assert empty['count'] == 0
    assert len(empty['counts']) == len(empty['bounds']) + 1
    assert histogram_percentiles(empty)['p99_ms'] is None


def test_mismatched_boundaries_refuse_to_merge():
    custom = LatencyHistogram(bounds=(1.0, 2.0, 4.0)).snapshot()
    custom['counts'][0] = 1
    custom['count'] = 1
    with pytest.raises(ValueError):
        merge_histograms([LatencyHistogram().snapshot(), custom])


# --------------------------------------------------------------------- #
# the tracer
# --------------------------------------------------------------------- #
def test_tracer_ids_unique_and_end_idempotent():
    t = [0.0]
    tr = Tracer(origin='t', clock=lambda: t[0])
    tids = {tr.mint() for _ in range(100)}
    assert len(tids) == 100 and all(i.startswith('req-') for i in tids)
    assert tr.mint('ctl').startswith('ctl-')
    span = tr.begin(next(iter(tids)), 'request')
    t[0] = 0.010
    tr.end(span, status='ok')
    t[0] = 99.0
    tr.end(span, status='late-loser')      # the first terminal site wins
    assert span['dur_ms'] == 10.0 and span['status'] == 'ok'
    assert len(tr.spans) == 1


def test_completeness_and_orphans():
    tr = Tracer(origin='t')
    tid = tr.mint()
    root = tr.begin(tid, 'request')
    tr.add(tid, 'attempt', parent_id=root['span'])
    tr.end(root)
    bad = tr.mint()
    bad_root = tr.begin(bad, 'request')
    tr.add(bad, 'attempt', parent_id='s-vanished-0')
    tr.end(bad_root)
    ctl = tr.mint('ctl')                   # control traces never count
    tr.end(tr.begin(ctl, 'probe'))
    spans = tr.spans
    assert complete_request_trees(spans) == [tid]
    assert [s['trace'] for s in orphan_spans(spans)] == [bad]
    body = trace_record_body(tr, expected=2)
    assert body['traces'] == 2 and body['complete_trees'] == 1
    assert body['orphan_spans'] == 1 and body['completeness_total'] == 0.5
    assert trace_record_body(tr, expected=4)['completeness_total'] == 0.25


def test_exclusive_durations_nest_within_one_clock_domain():
    t = [0.0]
    tr = Tracer(origin='t', clock=lambda: t[0])
    tid = tr.mint()
    parent = tr.begin(tid, 'dispatch')
    tr.add(tid, 'device_run', parent_id=parent['span'], ts=0.002,
           dur_ms=4.0)
    t[0] = 0.010
    tr.end(parent)
    by_name = trace_record_body(tr)['spans_by_name']
    assert by_name['dispatch']['total_ms'] == 10.0
    assert by_name['dispatch']['exclusive_ms'] == 6.0
    assert by_name['device_run']['exclusive_ms'] == 4.0
    # a span of another tracer (another clock domain) never subtracts
    other = Tracer(origin='elsewhere', clock=lambda: 0.001)
    foreign = other.begin(tid, 'attempt', parent_id=parent['span'])
    foreign['dur_ms'] = 8.0
    tr.extend([foreign])
    assert trace_record_body(tr)['spans_by_name']['dispatch'][
        'exclusive_ms'] == 6.0


def test_adjacent_spans_rounded_to_the_microsecond_stay_siblings():
    """queue_wait then dispatch, back to back: the rounding of ts (to the
    microsecond) and of the duration (likewise) may put the dispatch's
    start a microsecond before the wait's recorded end. They stay
    siblings: no exclusive time goes negative (JAX's nests them)."""
    tr = Tracer(origin='t')
    tid = tr.mint()
    # the wait truly ends at 10.0000032 s, where the dispatch starts; its
    # rounded start and duration end it at 10.000004
    root = tr.add(tid, 'admit', ts=10.0000006)
    tr.add(tid, 'queue_wait', parent_id=root['span'], ts=10.0000006,
           dur_ms=0.0026)
    tr.add(tid, 'dispatch', parent_id=root['span'], ts=10.0000032,
           dur_ms=5.0)
    by_name = trace_record_body(tr)['spans_by_name']
    assert by_name['queue_wait']['exclusive_ms'] == 0.003
    assert by_name['dispatch']['exclusive_ms'] == 5.0
    assert jtracing.exclusive_by_name(tr.spans)['queue_wait'][
        'exclusive_ms'] < 0


def test_multi_host_counting():
    tr = Tracer(origin='t', host=None)
    tid = tr.mint()
    root = tr.begin(tid, 'request')
    tr.add(tid, 'attempt', parent_id=root['span'], host=0)
    tr.add(tid, 'attempt', parent_id=root['span'], host=1)
    tr.end(root)
    single = tr.mint()
    r2 = tr.begin(single, 'request')
    tr.add(single, 'attempt', parent_id=r2['span'], host=0)
    tr.end(r2)
    assert multi_host_traces(tr.spans) == 1


def _scripted(tracer_cls):
    """One scripted run of spans on an injected clock: two request trees
    (one redispatched across two hosts, with a host tracer's spans folded
    in), an orphan, a control probe."""
    t = [0.0]
    fleet = tracer_cls(origin='fleet', clock=lambda: t[0])
    hosts = {h: tracer_cls(origin=f'host{h}', host=h, clock=lambda: t[0])
             for h in (0, 1)}
    for k in range(3):
        tid = fleet.mint()
        root = fleet.begin(tid, 'request', rid=k)
        for attempt, h in enumerate((0, 1) if k == 1 else (0,)):
            t[0] += 0.001
            att = fleet.begin(tid, 'attempt', parent_id=root['span'],
                              host=h)
            ht = hosts[h]
            admit = ht.add(tid, 'admit', parent_id=att['span'],
                           ts=t[0], bucket=8)
            ht.add(tid, 'queue_wait', parent_id=admit['span'], ts=t[0],
                   dur_ms=2.0)
            d = ht.add(tid, 'dispatch', parent_id=admit['span'],
                       ts=t[0] + 0.002, dur_ms=5.0)
            ht.add(tid, 'device_run', parent_id=d['span'],
                   ts=t[0] + 0.003, dur_ms=3.0)
            t[0] += 0.008
            fleet.end(att, status='ok' if attempt or k != 1 else 'x')
            fleet.extend(ht.pop_trace(tid))
            if k == 1 and attempt == 0:
                fleet.add(tid, 'redispatch', parent_id=root['span'],
                          failed_host=h, attempt=1)
        if k == 2:
            fleet.add(tid, 'retry', parent_id='s-gone-0')
        fleet.end(root, status='ok')
    fleet.end(fleet.begin(fleet.mint('ctl'), 'probe', host=0))
    return fleet


def test_trace_record_body_equals_jax_on_scripted_spans():
    mine = trace_record_body(_scripted(Tracer), label='s', expected=3)
    theirs = jtracing.trace_record_body(_scripted(jtracing.Tracer),
                                        label='s', expected=3)
    assert mine == theirs
    assert mine['multi_host_traces'] == 1 and mine['orphan_spans'] == 1
    assert mine['redispatch_hops'] == 1 and mine['retry_hops'] == 1


# --------------------------------------------------------------------- #
# schema: both kinds, positive and negative, under both validators
# --------------------------------------------------------------------- #
def _trace_body():
    tr = Tracer(origin='t')
    tr.end(tr.begin(tr.mint(), 'request'))
    return trace_record_body(tr, label='t', expected=1)


@pytest.mark.parametrize('schema', SCHEMAS, ids=['torch', 'jax'])
def test_trace_record_schema(schema):
    rec = dict(_trace_body(), kind='trace', run_id='t')
    schema.validate_record(rec)
    for broken in ({k: v for k, v in rec.items() if k != 'orphan_spans'},
                   dict(rec, orphan_spans=3),
                   dict(rec, completeness_total=1.5),
                   dict(rec, complete_trees=99)):
        with pytest.raises(schema.SchemaError):
            schema.validate_record(broken)


def _slo_body():
    slo = SLOAggregator()
    h = LatencyHistogram()
    h.observe(5.0)
    slo.fold('0', dict(answered=3, request_failures=0, timeouts=0,
                       latency_hist={'8': h.snapshot()}))
    return slo.record_body(label='t')


@pytest.mark.parametrize('schema', SCHEMAS, ids=['torch', 'jax'])
def test_slo_record_schema(schema):
    body = _slo_body()
    assert body['buckets']['8']['count'] == 1
    rec = dict(body, kind='slo', run_id='t')
    schema.validate_record(rec)
    for broken in (dict(rec, availability=1.5),
                   {k: v for k, v in rec.items() if k != 'error_budget'},
                   dict(rec, buckets={'8': dict(count=1, p50_ms=1.0,
                                                p95_ms=1.0)})):
        with pytest.raises(schema.SchemaError):
            schema.validate_record(broken)


def test_slo_record_body_equals_jax_on_the_same_folds():
    """The same scraped host stats folded into the port's and JAX's
    aggregators, at the same clock, give the same `slo` body."""
    rng = np.random.RandomState(1)
    stats = {}
    for hid in (0, 1):
        hists = {}
        for b in ('8', '16'):
            h = LatencyHistogram()
            for ms in rng.lognormal(2.0 + hid, 0.5, size=40):
                h.observe(ms)
            hists[b] = h.snapshot()
        stats[hid] = dict(answered=40 + hid, request_failures=hid,
                          timeouts=0, latency_hist=hists)
    bodies = []
    for cls in (SLOAggregator, jslo.SLOAggregator):
        agg = cls(availability_target=0.99, clock=lambda: 10.0)
        for hid, st in stats.items():
            agg.fold(hid, st)
        bodies.append(agg.record_body(label='x', now=12.5))
    assert bodies[0] == bodies[1]
    assert bodies[0]['availability'] == round(81 / 82, 6)


# --------------------------------------------------------------------- #
# the traced two-host fleet, end to end, through both packages
# --------------------------------------------------------------------- #
@pytest.mark.parametrize('name', ['jax', 'torch'])
def test_traced_fleet_end_to_end(name):
    """A LocalTransport two-host fleet with a host death mid-stream: every
    resolved request yields one complete single-root tree (zero orphans,
    though the dead host's spans are lost), redispatch hops reconcile with
    the fleet's counter, redispatched requests show multi-host traces, and
    the router's serve record keeps its required fields and carries
    `latency_hist`; the records pass both packages' schemas."""
    ns = NAMESPACES[name]
    tracing = jtracing if name == 'jax' else None
    hosts, transports, teles = {}, {}, {}
    cls = killable(ns)
    for hid in (0, 1):
        server, _ = host(ns, hid, telemetry=True)
        hosts[hid] = server
        teles[hid] = server.telemetry
        transports[hid] = cls(server)
    tracer = (tracing.Tracer if tracing else Tracer)(origin='fleet')
    slo = (jslo.SLOAggregator if tracing else SLOAggregator)()
    # one scrape at the first pump, none after: a heartbeat to the dead
    # host would degrade it before a request tries it, and the redispatch
    # this test follows would not happen
    fleet = ns.serving.FleetRouter(transports, max_retries=2,
                                   default_timeout_s=10.0,
                                   heartbeat_every_s=60.0, tracer=tracer,
                                   slo=slo)
    pending = []
    rng = np.random.RandomState(0)
    try:
        i = 0
        # 16 requests; host 0 dies after the 7th and comes back from the
        # 12th on, once a request has tried it dead (the redispatch this
        # test follows), however the pool's threads were scheduled
        while i < 16 or (transports[0].dead and i < 64):
            n = int(rng.randint(2, 8))
            pending.append(fleet.submit(
                rng.randint(0, 8, size=n),
                rng.normal(size=(n, 3)).astype(np.float32)))
            fleet.pump()
            time.sleep(0.003)
            if i == 6:
                transports[0].dead = True       # the SIGKILL stand-in
            if i >= 11 and transports[0].refused:
                transports[0].dead = False
            i += 1
        deadline = time.monotonic() + 20
        while (any(not p.done for p in pending)
               and time.monotonic() < deadline):
            fleet.drain()
            fleet.pump()
            time.sleep(0.005)
        assert all(p.done for p in pending)
        assert fleet.scrape() == 2
        xretries = fleet.cross_host_retries
        answered, failures = fleet.answered, fleet.request_failures
    finally:
        fleet.close()
        for s in hosts.values():
            s.stop()
    assert answered > 0 and xretries >= 1
    record = (tracing.trace_record_body if tracing else trace_record_body)
    body = record(tracer, label='e2e', expected=answered + failures)
    assert body['orphan_spans'] == 0 and body['completeness_total'] == 1.0
    assert body['redispatch_hops'] == xretries
    assert body['multi_host_traces'] >= 1
    for span in ('request', 'attempt', 'admit', 'queue_wait', 'dispatch',
                 'device_run'):
        assert span in body['spans_by_name'], span
    slo_body = slo.record_body(fleet, label='e2e')
    assert slo_body['hosts'] == 2 and slo_body['answered'] == answered
    assert any(v['count'] for v in slo_body['buckets'].values())
    rec = teles[0].flush()
    for field in ('requests', 'buckets', 'queue_depth', 'runtime',
                  'post_warmup_compiles', 'replicas', 'health',
                  'latency_hist'):
        assert field in rec, field
    for schema in SCHEMAS:
        schema.validate_record(dict(body, kind='trace', run_id='t'))
        schema.validate_record(dict(slo_body, kind='slo', run_id='t'))
        schema.validate_record(dict(rec, kind='serve', run_id='t'))


def test_untraced_request_records_no_span():
    """A request whose payload carries no trace context costs nothing:
    the host records no span for it."""
    ns = NAMESPACES['torch']
    server, _ = host(ns, 0)
    try:
        res = ns.serving.LocalTransport(server).call(
            'infer', dict(tokens=np.arange(4), coords=np.zeros((4, 3),
                                                               np.float32)))
        assert res['ok'] and 'spans' not in res
        assert server.tracer.spans == []
    finally:
        server.stop()


# --------------------------------------------------------------------- #
# the python -m entry points: the dashboard and the profiler's top ops
# --------------------------------------------------------------------- #
def test_slo_report_renders_and_fails_on_a_broken_trace(tmp_path, capsys):
    from se3_transformer_torch.observability import slo_report
    from se3_transformer_torch.observability.report import (
        write_record_stream,
    )
    good, bad = str(tmp_path / 'good.jsonl'), str(tmp_path / 'bad.jsonl')
    slo = dict(_slo_body(), kind='slo')
    write_record_stream(good, 'r', [slo, dict(_trace_body(), kind='trace')])
    tr = Tracer(origin='t')
    tid = tr.mint()
    tr.end(tr.begin(tid, 'request'))
    tr.add(tid, 'attempt', parent_id='s-gone-0')
    write_record_stream(bad, 'r', [slo, dict(trace_record_body(tr),
                                             kind='trace')])
    assert slo_report.main([good, '--out', str(tmp_path / 'd.json')]) == 0
    assert 'DASHBOARD OK' in capsys.readouterr().out
    assert slo_report.main([bad]) == 1
    assert 'orphan' in capsys.readouterr().err


def test_trace_summary_ranks_exclusive_device_time(tmp_path, capsys):
    """A Chrome trace with two kernels on one stream, a copy on another
    and a CPU op: the device events are read, their times made exclusive
    per track, their names folded."""
    import json
    from se3_transformer_torch.observability import trace_summary
    events = [
        dict(ph='X', cat='cpu_op', name='aten::mm', pid=1, tid=1, ts=0.0,
             dur=500.0),
        dict(ph='X', cat='kernel', name='pairwise_bxf_kernel.1', pid=0,
             tid=7, ts=10.0, dur=300.0),
        dict(ph='X', cat='kernel', name='pairwise_bxf_kernel.2', pid=0,
             tid=7, ts=320.0, dur=100.0),
        dict(ph='X', cat='gpu_memcpy', name='Memcpy HtoD', pid=0, tid=8,
             ts=0.0, dur=50.0)]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps(dict(traceEvents=events)))
    dev, selector = trace_summary.device_events(
        dict(traceEvents=events))
    assert selector == 'device' and len(dev) == 3
    assert trace_summary.time_by_op(dev) == [('pairwise_bxf_kernel', 0.4),
                                            ('Memcpy HtoD', 0.05)]
    assert trace_summary.main(['--trace', str(tmp_path)]) == 0
    assert 'pairwise_bxf_kernel' in capsys.readouterr().out
