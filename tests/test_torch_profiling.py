"""The attribution half of observability on the CPU: the analytic FLOP
model (utils.flops) against the JAX package's, the kernel cost model
moved out of chip_smoke.py (pinned at PERF.md's unit shapes), per-scope
profiling (observability.profiling) of a small model, the run report
(observability.report) against JAX's, and a training step's `cost`
record (observability.costs.step_cost_payload, DenoiseTrainer.cost_record).
"""
import json
import os

import numpy as np
import pytest
import torch

import se3_transformer_torch as st
from se3_transformer_torch.models import se3_transformer as tmodel
from se3_transformer_torch.observability import costs as tcosts
from se3_transformer_torch.observability import profiling as tprof
from se3_transformer_torch.observability import report as treport
from se3_transformer_torch.observability import schema as tschema
from se3_transformer_torch.training import denoise as tden
from se3_transformer_torch.utils import flops as tflops
from se3_transformer_tpu.observability import report as jreport
from se3_transformer_tpu.observability import schema as jschema
from se3_transformer_tpu.training import recipes as jrecipes
from se3_transformer_tpu.utils import flops as jflops

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


# --------------------------------------------------------------------- #
# the analytic model and the kernel costs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize('recipe,n,k', [
    ('flagship_fast', 1024, 32), ('flagship', 1024, 32),
    ('af2_refinement', 1024, 12), ('molecular_edges', 128, 6)])
def test_train_step_flops_match_jax(recipe, n, k, monkeypatch):
    # the count reads the fields alone: no weights drawn
    monkeypatch.setattr(tmodel, 'init_parameters', lambda m, g: None)
    ours = getattr(st, recipe)(device='meta')
    ref = jrecipes.RECIPES[recipe]()
    for head in ({}, dict(output_degrees=2, reduce_dim_out=True)):
        if head:
            ours = getattr(st, recipe)(device='meta', **head)
            ref = jrecipes.RECIPES[recipe]().clone(**head)
        assert tflops.train_step_flops_estimate(ours, n, k) == \
            jflops.train_step_flops_estimate(ref, n, k)
        assert tflops.train_step_flops_estimate(ours, n, k, batch=2) == \
            jflops.train_step_flops_estimate(ref, n, k, batch=2)
    mult = 4.0 if ours.reversible else 3.0
    assert tflops.train_step_flops_estimate(ours, n, k) == \
        mult * tflops.forward_flops_estimate(ours, n, k)


def test_kernel_costs_are_chip_smokes():
    """Every kernel's bound in chip_smoke.py comes from utils.flops now:
    the same numbers, to the bit, as the functions it had (pinned at the
    units of PERF.md's kernel table: the flagship pairs and output degrees
    at E 4096 and 32768, the mid-32 and narrow shapes, the attention
    block's degrees, the assembly request's)."""
    with open(os.path.join(HERE, 'fixtures', 'torch_cost_pins.json')) as f:
        pins = json.load(f)
    assert len(pins) == 125
    for pin in pins:
        got = getattr(tflops, pin['fn'])(*pin['args'], **pin['kwargs'])
        assert list(got) == pin['out'], pin['fn']
    import chip_smoke
    for name in ('pairwise_cost', 'fwd_cost', 'fwd_q_cost',
                 'pairwise_bwd_cost', 'attention_cost', 'flash_cost',
                 'global_cost', 'peaks_for'):
        assert getattr(chip_smoke, name) is getattr(tflops, name)
    assert tflops.peaks_for('NVIDIA H100 80GB HBM3') == \
        ('H100', (989e12, 67e12, 3.35e12))
    assert tflops.peaks_for('NVIDIA H100 PCIe')[0] == 'H100 PCIe'


# --------------------------------------------------------------------- #
# per-scope profiling
# --------------------------------------------------------------------- #
@pytest.fixture(scope='module')
def small():
    model = st.flagship_fast(dim=8, depth=1, device='cpu', output_degrees=2,
                             reduce_dim_out=True,
                             generator=torch.Generator().manual_seed(0))
    trainer = st.DenoiseTrainer(model, device='cpu')
    batch = trainer.to_device(st.flagship_batch(np.random.RandomState(0), 1,
                                                24, 8))
    trainer.train_step(batch)
    return model, trainer, batch


def test_forward_profile_attributes_the_model_scopes(small):
    model, _, batch = small

    def forward():
        with torch.no_grad():
            model(batch['feats'], batch['coords'], batch['masks'],
                  return_type=1)
    prof = tprof.capture_step_profile(forward, steps=2, device='cpu')
    body = tprof.profile_payload(
        prof, label='depth-1 forward',
        flops_per_step=tflops.forward_flops_estimate(model, 24, 23))
    rec = dict(kind='profile', run_id='t', **body)
    tschema.validate_record(rec)
    jschema.validate_record(rec)
    assert 0 <= body['coverage'] <= 1 and body['coverage'] > 0.8
    assert {'neighbors', 'basis', 'conv_in', 'trunk', 'attention',
            'attn_qkv', 'attn_core', 'conv_out'} <= set(body['scopes'])
    assert set(body['scopes']) <= set(tprof.MODEL_SCOPES)
    assert body['steps'] == 2 and body['tracks']['selector'] == 'cpu_ops'
    shares = sum(v['share'] for v in body['scopes'].values())
    assert abs(shares - body['coverage']) < 1e-3
    # CPU time is no card's: no roofline on the CPU or an unknown card
    assert 'roofline' not in body
    assert 'roofline' not in tprof.profile_payload(
        prof, label='x', flops_per_step=1e9, device_name='Unknown GPU')
    roof = tprof.profile_payload(
        prof, label='x', flops_per_step=1e9,
        device_name='NVIDIA H100 80GB HBM3')['roofline']
    assert roof['peaks_of'] == 'H100' and \
        roof['bf16_peak_flops_per_sec'] == 989e12
    assert set(roof) == {'flops_per_step', 'device_flops_per_sec',
                         'utilization_vs_bf16_peak',
                         'bf16_peak_flops_per_sec', 'device_kind',
                         'peaks_of'}


def test_cuda_capture_without_device_events_raises(small):
    """A capture that asked for CUDA activity and got no device event
    (CUPTI gave nothing) is an error, not CPU time read as the card's."""
    model, _, batch = small
    prof = tprof.capture_step_profile(
        lambda: model(batch['feats'], batch['coords'], batch['masks'],
                      return_type=1), device='cpu')
    prof = tprof.StepProfile(prof.prof, prof.steps, prof.wall_ms, True)
    with pytest.raises(RuntimeError, match='no device event'):
        prof.pairs()
    with pytest.raises(RuntimeError, match='no device event'):
        tprof.profile_payload(prof, label='x')


def test_step_profile_attributes_the_backward(small):
    """Backward ops carry no forward scope of their own: they take the
    scope of the forward op that made their autograd node."""
    _, trainer, batch = small
    prof = tprof.capture_step_profile(lambda: trainer.train_step(batch),
                                      device='cpu')
    att = tprof.attribute_scopes(prof)
    assert att['attributed_us'] / att['total_us'] > 0.8
    backward = [e for e in prof.events
                if e.name.startswith('autograd::engine::evaluate_function')
                and e.sequence_nr >= 0]
    scopes = tprof._Scopes(prof.events, tprof.MODEL_SCOPES)
    assert backward and sum(scopes(e) is not None for e in backward) \
        >= 0.8 * len(backward)
    assert {scopes(e) for e in backward} >= {'conv_in', 'attn_qkv',
                                             'conv_out'}
    rows = tprof.device_time_by_op(prof)
    assert rows[0][2] >= rows[-1][2] and all(n >= 1 for _, n, _ in rows)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from se3_transformer_torch.observability import profile_trace
    with profile_trace(str(tmp_path)) as prof:
        torch.ones(4).sum()
    assert prof is not None
    path, = tmp_path.iterdir()
    assert json.loads(path.read_text())['traceEvents']
    with profile_trace(str(tmp_path / 'off'), enabled=False) as prof:
        assert prof is None


# --------------------------------------------------------------------- #
# the run report against JAX's
# --------------------------------------------------------------------- #
def _stream():
    meta = dict(kind='run_meta', run_id='r1', schema_version=1,
                backend='cuda', code_rev='abc', host=dict(hostname='h',
                                                          pid=1),
                device_kind='NVIDIA H100 80GB HBM3', label='denoise')
    flush = dict(kind='flush', run_id='r1', step=2, nodes_steps_per_sec=90.5,
                 window=dict(loss=dict(count=2, mean=1.0, min=0.5, max=1.5)),
                 timing=dict(step=dict(count=2, p50_ms=10.0, p95_ms=12.0,
                                       max_ms=12.5, mean_ms=11.0)),
                 runtime=dict(compile_events=0))
    summary = dict(kind='summary', run_id='r1', steps=4, label='denoise',
                   metrics=flush['window'], timing=flush['timing'],
                   nodes_steps_per_sec=95.25, loss_first=1.5, loss_last=0.5,
                   loss_decreased=True)
    tune = [dict(kind='tune', run_id='r1', kernel='plain',
                 shape=[12288, 32, 32, 1, 128], dtype='float32',
                 candidate=list(c), incumbent=[32], blocks=list(b),
                 verdict=v, promoted=p, step_ms=s, pairs=[],
                 nodes_steps_per_sec=r)
            for c, b, v, p, s, r in (((16,), (16,), 'promoted', True, 88.1,
                                      11623.2),
                                     ((8,), (16,), 'rejected', False, 90.2,
                                      11352.5),
                                     ((16,), (16,), 'consulted', True, None,
                                      None))]
    cost = dict(kind='cost', run_id='r1', label='step', source='unavailable',
                flops=None, bytes_accessed=None,
                memory=dict(argument_bytes=10, output_bytes=4,
                            temp_bytes=100), peak_bytes=114, collectives={})
    profile = dict(kind='profile', run_id='r1', label='step',
                   scopes=dict(trunk=dict(time_ms=9.0, share=0.9),
                               conv_in=dict(time_ms=0.5, share=0.05)),
                   device_time_ms=10.0, coverage=0.95, steps=1,
                   roofline=dict(flops_per_step=1e12))
    other = dict(meta, run_id='r2', backend='cpu')
    return [meta, flush, *tune, cost, profile, summary, other,
            dict(flush, run_id='r2', nodes_steps_per_sec=10.0)]


def test_report_summaries_match_jax():
    records = _stream()
    for rec in records:
        tschema.validate_record(rec)
        jschema.validate_record(rec)
    tunes = [r for r in records if r['kind'] == 'tune']
    assert treport.summarize_tune_records(tunes) == \
        jreport.summarize_tune_records(tunes)
    for kind, fn in (('cost', 'summarize_cost_records'),
                     ('profile', 'summarize_profile_records')):
        sel = [r for r in records if r['kind'] == kind]
        assert getattr(treport, fn)(sel) == getattr(jreport, fn)(sel)
    assert treport.summarize_telemetry(records, anchor=50.0) == \
        jreport.summarize_telemetry(records, anchor=50.0)
    assert treport.summarize(records) == jreport.summarize(records)
    bench = [dict(metric='m', value=v, unit='u', code_rev='abc')
             for v in (100.0, 80.0, 99.0)]
    assert treport.summarize(bench) == jreport.summarize(bench)
    assert treport.summarize_bench_records(bench, code_rev='abc') == \
        jreport.summarize_bench_records(bench, code_rev='abc')


def test_write_record_stream_and_load(tmp_path):
    path = str(tmp_path / 's.jsonl')
    recs = [r for r in _stream() if r['kind'] in ('tune', 'cost', 'profile')]
    out = treport.write_record_stream(path, 'run-x', recs)
    assert out[0]['kind'] == 'run_meta' and len(out) == len(recs) + 1
    assert tschema.validate_stream(path)['records'] == len(recs) + 1
    assert jschema.validate_stream(path)['records'] == len(recs) + 1
    assert treport.load_jsonl(path) == jreport.load_jsonl(path)


# --------------------------------------------------------------------- #
# a training step's cost record
# --------------------------------------------------------------------- #
@pytest.fixture
def fake_card(monkeypatch):
    """The allocator's counters of a card, on the CPU: step_cost_payload
    reads them around the step."""
    peak = dict(base=1000, top=5000)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda d=None: None)
    monkeypatch.setattr(torch.cuda, 'reset_peak_memory_stats',
                        lambda d=None: None)
    monkeypatch.setattr(torch.cuda, 'memory_allocated',
                        lambda d=None: peak['base'])
    monkeypatch.setattr(torch.cuda, 'max_memory_allocated',
                        lambda d=None: peak['top'])
    real = tcosts.step_cost_payload
    monkeypatch.setattr(tcosts, 'step_cost_payload',
                        lambda step, **kw: real(step, **dict(
                            kw, device='cuda')))
    return peak


def test_step_cost_payload_validates_under_jax(fake_card):
    params = [torch.zeros(10, 10), torch.zeros(3)]
    body = tcosts.step_cost_payload(lambda: torch.zeros(()), label='step',
                                    state=params, batch=[torch.zeros(4, 2)],
                                    device='cuda')
    assert body['memory'] == dict(argument_bytes=4 * 111,
                                  output_bytes=4, temp_bytes=4000 - 4)
    assert body['peak_bytes'] == 4000 + 4 * 111
    assert body['source'] == 'unavailable' and body['flops'] is None
    rec = dict(kind='cost', run_id='r', **body)
    tschema.validate_record(rec)
    jschema.validate_record(rec)


def _train(cost_record, steps=3, logger=None):
    cfg = tden.DenoiseConfig(num_nodes=12, accum_steps=2,
                             cost_record=cost_record)
    trainer = tden.DenoiseTrainer(cfg, device='cpu')
    history = trainer.train(steps, log=lambda msg: None,
                            metric_logger=logger)
    return trainer, history


def test_cost_record_leaves_training_as_it_was(fake_card, tmp_path):
    from se3_transformer_torch.observability import MetricLogger
    path = str(tmp_path / 'm.jsonl')
    with MetricLogger(path) as logger:
        trainer, history = _train(True, logger=logger)
    control, plain = _train(False)
    costs = [r for r in history if isinstance(r, dict)
             and r.get('kind') == 'cost']
    assert len(costs) == 1 and len(history) == len(plain) + 1
    for name, t in trainer.model.state_dict().items():
        assert torch.equal(t, control.model.state_dict()[name]), name
    assert trainer.step_count == control.step_count == 3
    for key, state in control.optimizer.state_dict()['state'].items():
        for k, v in state.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                trainer.optimizer.state_dict()['state'][key][k]))
    assert jschema.validate_stream(path)['kinds']['cost'] == 1


def test_cost_record_failure_warns_and_training_goes_on():
    with pytest.raises(ValueError, match='allocator peak'):
        tcosts.step_cost_payload(lambda: torch.zeros(()), label='step',
                                 state=[], batch=[], device='cpu')
    with pytest.warns(UserWarning, match='cost record failed'):
        trainer, history = _train(True, steps=2)
    assert trainer.step_count == 2
    assert not any(isinstance(r, dict) and r.get('kind') == 'cost'
                   for r in history)
