"""The port's observability primitives (se3_transformer_torch.observability,
and training.guardian's PreemptionGuard) against the JAX package's on the
CPU: the record schema accepts and refuses the same records (the records
of tests/test_inference.py::test_serve_record_schema_requires_p99, the
training kinds flush, retrace_warning, pipeline and guard, and broken
ones), the latency histograms, PhaseTimer summaries and merge_windows give
the same numbers on the same samples, MetricAccumulator gives JAX's
windows over the same values and fetches once a flush (never in a step),
the logger's stream and the cost record body validate under JAX's schema,
the one-time-work watchdog, and the preemption guard."""
import json
import signal
import threading

import numpy as np
import pytest
import torch

from se3_transformer_tpu.observability import metrics as jmetrics
from se3_transformer_tpu.observability import schema as jschema
from se3_transformer_tpu.observability import slo as jslo
from se3_transformer_tpu.observability import timing as jtiming
from se3_transformer_tpu.training.guardian import PreemptionGuard as JGuard
from se3_transformer_torch import observability as obs
from se3_transformer_torch.observability import metrics as tmetrics
from se3_transformer_torch.observability import schema as tschema
from se3_transformer_torch.training.guardian import PreemptionGuard
from se3_transformer_torch.utils.helpers import ONE_TIME_WORK, device_constant

torch.set_num_threads(1)


def _serve(**over):
    # test_inference.py::test_serve_record_schema_requires_p99's record
    rec = dict(kind='serve', run_id='r',
               requests=dict(served=3, rejected=dict(oversize=1)),
               buckets={'64': dict(count=2, p50_ms=1.0, p95_ms=2.0,
                                   p99_ms=2.5, max_ms=3.0)},
               runtime=dict(compile_events_delta=0),
               queue_depth=0, post_warmup_compiles=0)
    rec.update(over)
    return rec


def _hist(counts_off=0):
    h = obs.LatencyHistogram()
    for ms in (0.5, 3.0, 3.1, 40.0):
        h.observe(ms)
    snap = h.snapshot()
    snap['count'] += counts_off
    return snap


def _cost(**over):
    rec = dict(kind='cost', run_id='r', **obs.cost_payload(
        label='bucket_1024,b=1,dtype=float32,precision=fp32',
        argument_bytes=1000, output_bytes=12, peak_bytes=5000))
    rec.update(over)
    return rec


def _summary(**over):
    rec = dict(kind='summary', run_id='r', steps=4,
               metrics=dict(request_latency_ms=dict(count=2, mean=1.0,
                                                    min=0.5, max=1.5)),
               timing={'bucket_64': dict(count=2, p50_ms=1.0, p95_ms=2.0,
                                         p99_ms=2.5, max_ms=3.0)})
    rec.update(over)
    return rec


def _flush(**over):
    rec = dict(kind='flush', run_id='r', step=4,
               window=dict(loss=dict(count=4, mean=1.0, min=0.5, max=1.5),
                           grad_norm=dict(count=0, mean=None, min=None,
                                          max=None)),
               timing={'step': dict(count=2, p50_ms=1.0, p95_ms=2.0,
                                    max_ms=3.0, mean_ms=1.5)},
               runtime=dict(compile_events=3, compile_events_delta=0,
                            retraced=[], memory=None))
    rec.update(over)
    return rec


def _pipeline(**over):
    rec = dict(kind='pipeline', run_id='r', steps=4, step=4,
               queue=dict(capacity=4, depth_mean=1.5),
               prefetch=dict(depth=2, hits=3, stalls=1, hit_rate=0.75,
                             host_wait_ms=1.0, place_ms=0.5),
               verdict='balanced', source=dict(retries=1, skipped=0))
    rec.update(over)
    return rec


def _guard(**over):
    rec = dict(kind='guard', run_id='r', step=8, trips=2, rollbacks=2,
               restarts=1, skipped_batches=0, preemptions=1,
               injections_total=2, diverged=False,
               injections_by_site={'step_batch:nan': 1})
    rec.update(over)
    return rec


RECORDS = {
    'flush': _flush(),
    'flush_window_missing': {k: v for k, v in _flush().items()
                             if k != 'window'},
    'flush_window_without_mean': _flush(window=dict(loss=dict(
        count=1, min=1.0, max=1.0))),
    'flush_timing_without_p95': _flush(timing={'step': dict(
        count=1, p50_ms=1.0, max_ms=1.0)}),
    'flush_runtime_missing': {k: v for k, v in _flush().items()
                              if k != 'runtime'},
    'retrace_warning': dict(kind='retrace_warning', run_id='r', step=3,
                            retraced=[dict(events=1)]),
    'retrace_warning_empty': dict(kind='retrace_warning', run_id='r'),
    'pipeline': _pipeline(),
    'pipeline_no_source': {k: v for k, v in _pipeline().items()
                           if k != 'source'},
    'pipeline_bad_verdict': _pipeline(verdict='host_bound'),
    'pipeline_prefetch_without_stalls': _pipeline(prefetch=dict(depth=2,
                                                                hits=3)),
    'pipeline_queue_without_capacity': _pipeline(queue=dict(depth_mean=1)),
    'pipeline_source_negative': _pipeline(source=dict(retries=-1,
                                                      skipped=0)),
    'pipeline_source_bool': _pipeline(source=dict(retries=True,
                                                  skipped=0)),
    'guard': _guard(),
    'guard_diverged_int': _guard(diverged=0),
    'guard_float_counter': _guard(rollbacks=2.0),
    'guard_negative_step': _guard(step=-1),
    'guard_without_injections': {k: v for k, v in _guard().items()
                                 if k != 'injections_total'},
    'summary_training': _summary(
        label='denoise,dim=8', retrace_warnings_total=0,
        nodes_steps_per_sec=12.5, loss_first=3.1, loss_last=2.2,
        loss_decreased=True),
    'serve': _serve(),
    'serve_p99_missing': _serve(buckets={'64': dict(
        count=2, p50_ms=1.0, p95_ms=2.0, max_ms=3.0)}),
    'serve_requests_empty': _serve(requests=dict()),
    'serve_no_post_warmup_compiles': {
        k: v for k, v in _serve().items() if k != 'post_warmup_compiles'},
    'serve_buckets_not_object': _serve(buckets=[]),
    'serve_latency_hist': _serve(latency_hist={'64': _hist()}),
    'serve_latency_hist_count_off': _serve(latency_hist={'64': _hist(1)}),
    'serve_latency_hist_not_object': _serve(latency_hist=[1]),
    'cost': _cost(),
    'cost_bad_source': _cost(source='torch_profiler'),
    'cost_temp_missing': _cost(memory=dict(argument_bytes=1,
                                           output_bytes=1)),
    'cost_negative_peak': _cost(peak_bytes=-1),
    'cost_analysis_without_flops': _cost(source='cost_analysis'),
    'cost_collectives_malformed': _cost(collectives={'all-gather': {}}),
    'summary': _summary(),
    'summary_timing_without_p95': _summary(timing={'b': dict(
        count=1, p50_ms=1.0, max_ms=1.0)}),
    'summary_metric_without_mean': _summary(metrics={'m': dict(
        count=1, min=1.0, max=1.0)}),
    'summary_steps_missing': {k: v for k, v in _summary().items()
                              if k != 'steps'},
    'step': dict(kind='step', run_id='r', step=3, t=0.5),
    'step_float_step': dict(kind='step', run_id='r', step=3.0, t=0.5),
    'run_meta_without_pid': dict(kind='run_meta', run_id='r',
                                 schema_version=1, backend='cpu',
                                 code_rev=None, host=dict(hostname='h')),
    'unknown_kind': dict(kind='nonsense', run_id='r'),
    'not_an_object': ['serve'],
}


def _refused(validate, rec):
    try:
        validate(rec)
    except (jschema.SchemaError, tschema.SchemaError):
        return True
    return False


@pytest.mark.parametrize('name', sorted(RECORDS))
def test_schema_accepts_and_refuses_as_jax_does(name):
    rec = RECORDS[name]
    refused = _refused(jschema.validate_record, rec)
    assert _refused(tschema.validate_record, rec) == refused
    assert refused == (name not in ('serve', 'serve_latency_hist', 'cost',
                                    'summary', 'step', 'flush',
                                    'retrace_warning', 'pipeline',
                                    'pipeline_no_source', 'guard',
                                    'summary_training'))


def test_stream_rules_and_logger_stream_match_jax(tmp_path):
    """The logger's stream opens with a run_meta that names the host and
    the backend; every record validates under both schemas; a stream that
    opens with anything else, or is empty, is refused by both."""
    path = str(tmp_path / 's.jsonl')
    lines = []
    with obs.MetricLogger(path, mirror=lines.append,
                          run_meta=dict(mode='serve')) as logger:
        logger.log(1, loss=torch.tensor(0.5))
        logger.log_record('serve', **{k: v for k, v in _serve().items()
                                      if k not in ('kind', 'run_id')})
        logger.log_record('cost', mirror=False, **obs.cost_payload(
            label='b', argument_bytes=10, output_bytes=2, peak_bytes=30))
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    meta = recs[0]
    assert meta['kind'] == 'run_meta' and meta['mode'] == 'serve'
    assert meta['schema_version'] == jschema.SCHEMA_VERSION
    assert meta['backend'] == ('cuda' if torch.cuda.is_available()
                               else 'cpu')
    assert meta['host']['torch'] == torch.__version__
    assert all(r['run_id'] == logger.run_id for r in recs)
    assert recs[1]['loss'] == 0.5 and len(lines) == 3
    for validate in (tschema.validate_stream, jschema.validate_stream):
        assert validate(path)['kinds'] == {'run_meta': 1, 'step': 1,
                                           'serve': 1, 'cost': 1}
        for bad in ([json.dumps(_serve())], [], ['not json']):
            with pytest.raises(ValueError):
                validate(bad)


def test_cost_payload_splits_the_measured_peak():
    body = obs.cost_payload(label='x', argument_bytes=100, output_bytes=20,
                            peak_bytes=500)
    assert body['memory'] == dict(argument_bytes=100, output_bytes=20,
                                  temp_bytes=380)
    assert body['peak_bytes'] == 500 and body['source'] == 'unavailable'
    assert body['flops'] is None and body['collectives'] == {}
    jschema.validate_record(dict(kind='cost', run_id='r', **body))


def test_latency_histograms_match_jax():
    rng = np.random.RandomState(6)
    samples = [rng.lognormal(1.0, 1.5, size=n) for n in (50, 31, 0)]
    ours, ref = [], []
    for s in samples:
        a, b = obs.LatencyHistogram(), jslo.LatencyHistogram()
        for ms in s:
            a.observe(ms)
            b.observe(ms)
        ours.append(a.snapshot())
        ref.append(b.snapshot())
    assert ours == ref
    assert obs.merge_histograms(ours) == jslo.merge_histograms(ref)
    assert obs.merge_histograms([]) == jslo.merge_histograms([])
    for snap in ours + [obs.merge_histograms(ours)]:
        assert obs.histogram_percentiles(snap) == \
            jslo.histogram_percentiles(snap)
        assert obs.histogram_percentiles(snap, qs=(90, 99.9)) == \
            jslo.histogram_percentiles(snap, qs=(90, 99.9))
    odd = obs.LatencyHistogram(bounds=(1.0, 2.0)).snapshot()
    for mod in (obs, jslo):
        with pytest.raises(ValueError):
            mod.merge_histograms([ours[0], odd])


def test_phase_timer_and_merge_windows_match_jax():
    rng = np.random.RandomState(7)
    ours, ref = obs.PhaseTimer(capacity=16), jtiming.PhaseTimer(capacity=16)
    for name in ('bucket_12', 'bucket_24', 'bucket_12'):
        for s in rng.exponential(0.01, size=11):
            ours.record(name, float(s))
            ref.record(name, float(s))
        assert ours.window_summary(reset=False) == \
            ref.window_summary(reset=False)
    assert ours.cumulative_summary() == ref.cumulative_summary()
    assert ours.window_summary() == ref.window_summary()
    assert ours.window_summary() == {} == ref.window_summary()
    assert ours.total_count('bucket_12') == ref.total_count('bucket_12') \
        == 22
    assert ours.total_seconds('x') == ref.total_seconds('x') == 0.0
    # a phase with a device: on the CPU nothing to wait for
    with ours.phase('p', device='cpu'):
        pass
    with obs.named_scope('serve_batch'):
        pass
    assert ours.total_count('p') == 1
    w1 = dict(loss=dict(count=2, mean=1.0, min=0.5, max=1.5),
              gnorm=dict(count=0, mean=None, min=None, max=None))
    w2 = dict(loss=dict(count=3, mean=2.0, min=0.1, max=4.0),
              gnorm=dict(count=1, mean=3.0, min=3.0, max=3.0))
    for cum in (None, obs.merge_windows(None, w1)):
        assert obs.merge_windows(cum, w2) == jmetrics.merge_windows(cum, w2)


def test_watchdog_counts_one_time_work_after_arming():
    """The first check arms; a device-constant build after it is counted
    and warned of once; a check with nothing new reads 0; the CPU has no
    allocator stats."""
    built = []

    @device_constant
    def constant(n):
        built.append(n)
        return torch.zeros(n)

    wd = obs.RetraceWatchdog()
    first = wd.check()
    assert first['armed'] and first['memory'] is None
    assert first['compile_events'] == ONE_TIME_WORK[0]
    constant(3)
    constant(3)
    with pytest.warns(obs.RetraceWarning):
        snap = wd.check()
    assert snap['compile_events_delta'] == 1 and wd.warnings_total == 1
    assert built == [3] and snap['retraced'][0]['events'] == 1
    assert wd.check()['compile_events_delta'] == 0
    constant.cache_clear()
    constant(3)
    with pytest.warns(obs.RetraceWarning):
        assert wd.check()['compile_events_delta'] == 1
    assert obs.device_memory_stats('cpu') is None


def test_preemption_guard_matches_jax():
    for cls in (PreemptionGuard, JGuard):
        before = signal.getsignal(signal.SIGTERM)
        with cls() as guard:
            assert not guard.stop_requested and guard.signame is None
            if threading.current_thread() is threading.main_thread():
                assert signal.getsignal(signal.SIGTERM) == guard._handler
                signal.raise_signal(signal.SIGTERM)
                assert guard.signame == 'SIGTERM'
            else:
                guard.request_stop()
            assert guard.stop_requested
        assert signal.getsignal(signal.SIGTERM) == before
        guard = cls()
        guard.request_stop('drill')
        assert guard.stop_requested and guard.signame == 'drill'


# ---------------------------------------------------------------------- #
# MetricAccumulator
# ---------------------------------------------------------------------- #
def _updates(seed):
    rng = np.random.RandomState(seed)
    return [dict(loss=rng.normal(size=4).astype(np.float32),
                 grad_norm=np.float32(rng.exponential())),
            dict(loss=np.float32(rng.normal())),
            dict(grad_norm=rng.exponential(size=(2, 3)).astype(np.float32)),
            dict(loss=np.array([np.inf, -2.5, 0.5], np.float32))]


@pytest.mark.parametrize('case', ['scalars_and_vectors', 'merge', 'empty',
                                  'exact'])
def test_metric_accumulator_windows_match_jax(case):
    """The same updates through the port's accumulator and JAX's: the same
    {count, mean, min, max} windows (count, min and max exactly; the mean
    within float32's rounding of the sum, whose order may differ; exactly
    where the sums are exact), and a zeroed accumulator after each
    flush."""
    names = ('loss', 'grad_norm')
    ours = obs.MetricAccumulator.zero(names)
    ref = jmetrics.MetricAccumulator.zero(names)
    if case == 'exact':
        ups = [dict(loss=np.array([0.5, 1.25, -2.0], np.float32),
                    grad_norm=np.float32(3.0)),
               dict(loss=np.float32(0.25))]
    else:
        ups = [] if case == 'empty' else _updates(3)
    for up in ups:
        ours = ours.update(**{k: torch.from_numpy(np.array(v))
                              for k, v in up.items()})
        ref = ref.update(**up)
    if case == 'merge':
        other, jother = obs.MetricAccumulator.zero(names), \
            jmetrics.MetricAccumulator.zero(names)
        for up in _updates(4):
            other = other.update(**up)
            jother = jother.update(**up)
        ours, ref = ours.merge(other), ref.merge(jother)
    got, ours = ours.flush()
    want, ref = ref.flush()
    assert sorted(got) == sorted(want)
    for name in want:
        for key in ('count', 'min', 'max'):
            assert got[name][key] == want[name][key], (name, key)
        if case in ('empty', 'exact') or want[name]['mean'] is None \
                or not np.isfinite(want[name]['mean']):
            assert got[name]['mean'] == want[name]['mean'] or (
                np.isnan(got[name]['mean']) and np.isnan(want[name]['mean']))
        else:
            assert abs(got[name]['mean'] - want[name]['mean']) <= \
                1e-6 * abs(want[name]['mean']) * got[name]['count']
    assert ours.flush()[0] == ref.flush()[0] == {
        n: dict(count=0, mean=None, min=None, max=None) for n in names}
    with pytest.raises(KeyError, match='not declared'):
        ours.update(lr=1.0)


def test_telemetry_step_fetches_nothing_and_a_flush_fetches_once(
        monkeypatch):
    """The CPU half of the no-sync contract: a telemetry train_step never
    reaches the accumulator's host fetch, and telemetry_flush reaches it
    exactly once (on a card, chip_smoke's denoise_guarded phase counts the
    synchronizing calls themselves)."""
    from se3_transformer_torch.training import denoise as tden
    calls = []
    inner = tmetrics._host_fetch

    def counted(stats):
        calls.append(len(stats))
        return inner(stats)
    monkeypatch.setattr(tmetrics, '_host_fetch', counted)
    trainer = tden.DenoiseTrainer(tden.DenoiseConfig(
        num_nodes=12, accum_steps=2, telemetry=True, flush_every=2),
        device='cpu')
    for _ in range(2):
        trainer.train_step(trainer.micro_batches_host())
    assert calls == []
    rec = trainer.telemetry_flush()
    assert calls == [2]
    assert rec['window']['loss']['count'] == 4
    assert rec['window']['grad_norm']['count'] == 2
    assert set(rec['timing']) == {'warmup', 'step'}
    assert rec['runtime']['compile_events_delta'] == 0
    summary = trainer.telemetry_close()
    assert calls == [2]       # nothing left to flush
    assert summary['steps'] == 2 and summary['retrace_warnings_total'] == 0
    assert np.isfinite(summary['loss_first'])
    for kind, fields in (('flush', rec), ('summary', summary)):
        for schema in (tschema, jschema):
            schema.validate_record(dict(fields, kind=kind, run_id='r'))
