"""The port's self-healing training loop (se3_transformer_torch.training.
guardian) against the JAX package's training/guardian.py on the CPU, at
the size of tests/test_guardian.py (DenoiseConfig(num_nodes=16,
num_degrees=2, max_sparse_neighbors=4, telemetry=True, flush_every=2)):
SpikeDetector and StepGuard give JAX's verdicts; the guard record and the
sidecar; the per-step batches are JAX's; a NaN window rolls back and
replays to an uninterrupted control's parameters bit for bit; a SIGTERM
under pipeline=True ends in one emergency save and a resume that lands
on the control bit for bit; a spent restart budget raises TrainingFailed;
the weakened arm (no rollback) ends diverged with exit code 1; the CLI's
--guarded exit codes; and a guarded NaN run from JAX's parameters with
JAX's per-step noise ends with JAX's guard counters and parameters. The
fsdp case of tests/test_guardian.py is ROADMAP A7."""
import math
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu.faults import FaultInjector as JInjector
from se3_transformer_tpu.observability import schema as jschema
from se3_transformer_tpu.training import denoise as jden
from se3_transformer_tpu.training import guardian as jguard
from se3_transformer_tpu.training.checkpoint import (
    CheckpointManager as JCheckpointManager,
)
from se3_transformer_torch import convert_flax_params
from se3_transformer_torch.faults import FaultInjector
from se3_transformer_torch.observability import schema as tschema
from se3_transformer_torch.training import cli
from se3_transformer_torch.training import denoise as tden
from se3_transformer_torch.training import guardian
from se3_transformer_torch.training.checkpoint import CheckpointManager
from se3_transformer_torch.training.guardian import (
    RESUMABLE_RC, GuardConfig, SpikeDetector, StepGuard, TrainingFailed,
    resume_trainer, run_guarded,
)

torch.set_num_threads(1)

_SILENT = lambda *a, **k: None  # noqa: E731 - test logs stay quiet

SMALL = dict(num_nodes=16, batch_size=1, num_degrees=2,
             max_sparse_neighbors=4, telemetry=True, flush_every=2)


def _trainer(**kw):
    return tden.DenoiseTrainer(tden.DenoiseConfig(**dict(SMALL, **kw)),
                               device='cpu')


def _params(trainer):
    return {k: v.clone() for k, v in trainer.params.items()}


def _assert_bit_equal(want, trainer):
    got = trainer.params
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def _control(tmp_path, steps, **kw):
    """The uninterrupted guarded run's final parameters."""
    trainer = _trainer(**kw)
    with CheckpointManager(str(tmp_path / 'control')) as mgr:
        res = run_guarded(trainer, steps, mgr, log=_SILENT)
    assert res.exit_code == 0 and not res.diverged
    assert res.counters == dict.fromkeys(res.counters, 0)
    return _params(trainer)


def _both_schemas(rec):
    """The record validates under the port's schema and JAX's."""
    rec = dict(rec, run_id=rec.get('run_id', 't'))
    tschema.validate_record(rec)
    jschema.validate_record(rec)


# ---------------------------------------------------------------------- #
# detection, records, derivations (no model)
# ---------------------------------------------------------------------- #
NAN, INF = float('nan'), float('inf')
SEQUENCES = {
    'descent_then_spike': [1.0, 0.7, 0.5, 0.45, 0.44, 50.0, 0.43, 0.42],
    'nan_and_inf': [1.0, 0.9, NAN, 0.8, INF, -INF, 0.7, 0.6, 0.5, 9.0],
    'flat_then_small_bump': [0.5] * 6 + [0.5000001, 0.6, 5.0, 0.5],
    'noisy': list(np.random.RandomState(3).lognormal(size=24)),
}


@pytest.mark.parametrize('name', sorted(SEQUENCES))
@pytest.mark.parametrize('zscore,decay,warmup', [(8.0, 0.9, 3),
                                                 (3.0, 0.5, 0)])
def test_spike_detector_verdicts_are_jax_s(name, zscore, decay, warmup):
    ours = SpikeDetector(zscore, decay, warmup)
    ref = jguard.SpikeDetector(zscore, decay, warmup)
    for x in SEQUENCES[name]:
        assert ours.observe(x) == ref.observe(x), x
        assert (ours.mean, ours.var, ours.seen) == \
            (ref.mean, ref.var, ref.seen)


def _window(loss, grad=1.0, count=2):
    return dict(loss=dict(count=count, mean=loss, min=loss, max=loss),
                grad_norm=dict(count=count, mean=grad, min=grad, max=grad))


WINDOWS = {
    'clean_then_spike': [_window(x) for x in (1.0, 0.8, 0.7, 0.65, 40.0,
                                              0.6)],
    'nonfinite': [_window(0.5), _window(NAN), _window(0.5, grad=INF),
                  dict(loss=dict(count=2, mean=0.5, min=0.1, max=INF)),
                  _window(0.5)],
    'empty_and_none': [{}, dict(loss=dict(count=0, mean=None, min=None,
                                          max=None)), _window(0.3)],
}


@pytest.mark.parametrize('name', sorted(WINDOWS))
def test_step_guard_verdicts_are_jax_s(name):
    for cfg in (dict(), dict(warmup_windows=0, spike_zscore=3.0)):
        ours = StepGuard(GuardConfig(**cfg))
        ref = jguard.StepGuard(jguard.GuardConfig(**cfg))
        verdicts = [ours.check_window(w) for w in WINDOWS[name]]
        assert verdicts == [ref.check_window(w) for w in WINDOWS[name]]
        assert ours.last_verdict == ref.last_verdict
    if name == 'nonfinite':
        assert verdicts == ['ok', 'nonfinite', 'nonfinite', 'nonfinite',
                            'ok']


def test_guard_config_and_record_are_jax_s(tmp_path):
    import dataclasses
    assert {f.name: f.default for f in dataclasses.fields(GuardConfig)} == \
        {f.name: f.default for f in dataclasses.fields(jguard.GuardConfig)}
    assert RESUMABLE_RC == jguard.RESUMABLE_RC == 75
    ours, ref = StepGuard(), jguard.StepGuard()
    for g in (ours, ref):
        g.bump('trips')
        g.bump('rollbacks')
        g.bump('injections_total', 3)
    inj, jinj = FaultInjector(seed=0), JInjector(seed=0)
    for i in (inj, jinj):
        i.plan('step_batch', 'nan', at=(1,))
        i.fire('step_batch', step=0)
    rec = ours.record(7, injector=inj)
    assert rec == ref.record(7, injector=jinj)
    _both_schemas(dict(kind='guard', **rec))
    for bad in (dict(rec, diverged=0), dict(rec, trips=-1),
                dict(rec, rollbacks=1.0)):
        for schema in (tschema, jschema):
            with pytest.raises(schema.SchemaError):
                schema.validate_record(dict(kind='guard', run_id='t', **bad))
    ours.save_counters(str(tmp_path))
    back = StepGuard()
    back.load_counters(str(tmp_path))
    assert back.counters == ours.counters
    # JAX reads the port's sidecar: the same file format
    jback = jguard.StepGuard()
    jback.load_counters(str(tmp_path))
    assert jback.counters == ours.counters
    with open(tmp_path / 'guard_state.json', 'w') as f:
        f.write('{"trips": 4')
    torn = StepGuard()
    with pytest.warns(RuntimeWarning, match='unreadable'):
        torn.load_counters(str(tmp_path))
    assert torn.counters['trips'] == 0


def test_training_failed_record():
    e = TrainingFailed('budget spent', trips=2, rollbacks=1)
    assert e.to_record() == jguard.TrainingFailed(
        'budget spent', trips=2, rollbacks=1).to_record()
    assert isinstance(e, RuntimeError)


def test_step_batches_are_jax_s_and_noise_depends_on_the_step_alone():
    for seed, step in ((0, 0), (0, 5), (3, 17)):
        a = guardian.step_batch_rng(seed, step).normal(size=4)
        np.testing.assert_array_equal(
            a, jguard.step_batch_rng(seed, step).normal(size=4))
    cfg = dict(num_nodes=12, accum_steps=3)
    tr = tden.DenoiseTrainer(tden.DenoiseConfig(**cfg), device='cpu')
    jt = type('T', (), dict(cfg=jden.DenoiseConfig(**cfg)))()
    for step in (0, 4):
        ours = guardian._host_micro_batches(tr, step)
        ref = jguard._host_micro_batches(jt, step)
        assert sorted(ours) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(ours[key], ref[key])
    poisoned = guardian.poison_batch(ours)
    assert np.isnan(poisoned['coords']).all()
    assert not np.isnan(ours['coords']).any()
    draws = [torch.randn(5, generator=guardian.step_train_rng(0, s))
             for s in (2, 2, 3)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert not torch.equal(
        draws[0], torch.randn(5, generator=guardian.step_train_rng(1, 2)))


def test_run_guarded_needs_telemetry(tmp_path):
    tr = tden.DenoiseTrainer(tden.DenoiseConfig(num_nodes=12), device='cpu')
    with pytest.raises(ValueError, match='telemetry=True'):
        run_guarded(tr, 1, CheckpointManager(str(tmp_path)))


# ---------------------------------------------------------------------- #
# rollback, preemption and the budget on the model
# ---------------------------------------------------------------------- #
def test_nan_rollback_replays_to_the_control_bit_for_bit(tmp_path):
    """A NaN batch (build 3) and a failing dispatch (call 6) each trip a
    window; each rolls back and replays to the exact final parameters of
    a run that never faulted, with no one-time host work after the first
    step. The records of the run validate under both schemas."""
    control = _control(tmp_path, 6)
    trainer = _trainer()
    inj = FaultInjector(seed=0)
    inj.plan('step_batch', 'nan', at=(3,))
    inj.plan('step_dispatch', 'exception', at=(6,))
    inj.plan('step_dispatch', 'latency', at=(2,), latency_s=0.001)
    with CheckpointManager(str(tmp_path / 'chaos')) as mgr:
        res = run_guarded(trainer, 6, mgr, injector=inj, log=_SILENT)
    assert res.counters == dict(trips=2, rollbacks=2, restarts=0,
                                skipped_batches=0, preemptions=0,
                                injections_total=3)
    assert not res.diverged and res.exit_code == 0 and res.steps == 6
    assert trainer.watchdog.warnings_total == 0
    _assert_bit_equal(control, trainer)
    windows = [h['window']['loss']['mean'] for h in res.history
               if 'window' in h]
    assert math.isnan(windows[1]) and np.isfinite(windows[2:]).all()
    summary = [h for h in res.history if 'label' in h][-1]
    # the NaN window left the cumulative statistics; the step before the
    # failing dispatch stays in the accumulator and joins the replayed
    # window, as in JAX's loop: 6 steps and that one
    assert summary['metrics']['loss']['count'] == 7
    assert np.isfinite(summary['metrics']['loss']['mean'])
    assert summary['retrace_warnings_total'] == 0
    for kind, rec in [('flush', h) for h in res.history if 'window' in h] \
            + [('summary', summary), ('guard', res.guard_record)]:
        _both_schemas(dict(rec, kind=kind))


def test_kill_and_resume_under_pipeline_is_bit_for_bit(tmp_path):
    """A SIGTERM at step 3 under pipeline=True (producer thread, device
    prefetch, async checkpoints): one emergency save, exit code 75; a
    fresh trainer resumes through resume_trainer and ends on the control's
    parameters bit for bit, with cumulative counters."""
    kw = dict(pipeline=True, accum_steps=2)
    control = _control(tmp_path, 6, **kw)
    ckpt = str(tmp_path / 'elastic')

    def stop_at_3(step):
        if step >= 3:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer = _trainer(**kw)
    with CheckpointManager(ckpt) as mgr:
        res = run_guarded(trainer, 6, mgr, step_hook=stop_at_3, log=_SILENT)
    assert res.preempted and res.exit_code == RESUMABLE_RC
    assert res.counters['preemptions'] == 1 and res.guard_record is None
    assert 0 < res.steps < 6
    resumed = _trainer(**kw)
    with CheckpointManager(ckpt) as mgr:
        assert mgr.latest_step() == res.steps      # the emergency save
        assert resume_trainer(resumed, mgr) == res.steps
        res2 = run_guarded(resumed, 6, mgr, restart=True, log=_SILENT)
    assert res2.exit_code == 0 and res2.steps == 6
    assert res2.counters['restarts'] == 1
    assert res2.counters['preemptions'] == 1
    assert resumed.watchdog.warnings_total == 0
    _assert_bit_equal(control, resumed)
    pipeline = [h for h in res2.history if h.get('kind') == 'pipeline']
    assert pipeline == []     # no logger: the records stay in the flushes


def test_a_dying_emergency_writer_still_exits_resumable(tmp_path):
    """The emergency save raises (the emergency_save site): the run still
    exits 75 and the restart falls back to the last window's checkpoint."""
    trainer = _trainer()
    inj = FaultInjector(seed=0)
    inj.plan('emergency_save', 'exception', at=(1,))

    def stop_at_3(step):
        if step >= 3:
            os.kill(os.getpid(), signal.SIGTERM)

    with CheckpointManager(str(tmp_path)) as mgr:
        with pytest.warns(RuntimeWarning, match='emergency checkpoint '
                                                'failed'):
            res = run_guarded(trainer, 6, mgr, injector=inj,
                              step_hook=stop_at_3, log=_SILENT)
        assert res.exit_code == RESUMABLE_RC and res.steps == 3
        assert mgr.latest_step() == 2
    fresh = StepGuard()
    fresh.load_counters(str(tmp_path))
    assert fresh.counters['preemptions'] == 1
    assert fresh.counters['injections_total'] == 1


def test_restart_budget_fails_loud_and_the_weakened_arm_diverges(tmp_path):
    trainer = _trainer()
    inj = FaultInjector(seed=0)
    inj.plan('step_batch', 'nan', every=1)
    with CheckpointManager(str(tmp_path / 'budget')) as mgr:
        with pytest.raises(TrainingFailed) as ei:
            run_guarded(trainer, 6, mgr, injector=inj, log=_SILENT,
                        guard=StepGuard(GuardConfig(restart_budget=1)))
    assert ei.value.counters['rollbacks'] == 1
    assert ei.value.counters['trips'] == 2
    assert ei.value.to_record()['error'] == 'training_failed'

    weak = _trainer()
    inj2 = FaultInjector(seed=0)
    inj2.plan('step_batch', 'nan', at=(3,))
    with CheckpointManager(str(tmp_path / 'weak')) as mgr:
        with pytest.warns(RuntimeWarning, match='rollback is disabled'):
            res = run_guarded(weak, 6, mgr, injector=inj2, log=_SILENT,
                              guard=StepGuard(GuardConfig(rollback=False)))
    assert res.diverged and res.exit_code == 1
    assert res.counters['trips'] >= 1 and res.counters['rollbacks'] == 0
    assert res.guard_record['diverged'] is True


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #
CLI = ['--cpu', '--nodes', '16', '--accum', '1', '--flush-every', '2']


def _with_chaos(monkeypatch, **extra):
    """Hand train_guarded extra arguments (an injector, a guard, a step
    hook), as the chip smoke's worker does."""
    inner = tden.DenoiseTrainer.train_guarded

    def train_guarded(self, *args, **kwargs):
        kwargs.update(extra)
        return inner(self, *args, **kwargs)
    monkeypatch.setattr(tden.DenoiseTrainer, 'train_guarded', train_guarded)


def test_cli_guarded_exit_codes_and_stream(tmp_path, monkeypatch):
    """--guarded: SIGTERM -> exit 75; the resume -> exit 0 on the
    uninterrupted run's parameters, a stream of flush, pipeline, guard and
    summary records valid under both schemas; rollback disabled and a NaN
    window -> exit 1."""
    ckpt, metrics = str(tmp_path / 'ck'), str(tmp_path / 'm.jsonl')
    args = CLI + ['--steps', '4', '--guarded', '--ckpt-dir', ckpt,
                  '--pipelined', '--metrics', metrics]

    def stop_at_2(step):
        if step >= 2:
            os.kill(os.getpid(), signal.SIGTERM)

    with monkeypatch.context() as m:
        _with_chaos(m, step_hook=stop_at_2)
        with pytest.raises(SystemExit) as e:
            cli.main(args)
    assert e.value.code == RESUMABLE_RC
    history = cli.main(args)
    guard_rec = history[-1]
    assert guard_rec['kind'] == 'guard' and not guard_rec['diverged']
    assert guard_rec['restarts'] == 1 and guard_rec['preemptions'] == 1
    info = tschema.validate_stream(metrics)
    assert info == jschema.validate_stream(metrics)
    assert {'flush', 'pipeline', 'guard', 'summary'} <= set(info['kinds'])
    state = CheckpointManager(ckpt).restore()
    control = tden.DenoiseTrainer(tden.DenoiseConfig(
        num_nodes=16, accum_steps=1, telemetry=True, flush_every=2,
        pipeline=True), device='cpu')      # the CLI's config
    with CheckpointManager(str(tmp_path / 'control')) as mgr:
        run_guarded(control, 4, mgr, log=_SILENT)
    for key, value in control.params.items():
        assert torch.equal(state[0][key], value), key

    weak_args = CLI + ['--steps', '4', '--guarded', '--ckpt-dir',
                       str(tmp_path / 'weak')]
    inj = FaultInjector(seed=0)
    inj.plan('step_batch', 'nan', at=(2,))
    with monkeypatch.context() as m:
        _with_chaos(m, injector=inj,
                    guard=StepGuard(GuardConfig(rollback=False)))
        with pytest.warns(RuntimeWarning, match='rollback is disabled'):
            with pytest.raises(SystemExit) as e:
                cli.main(weak_args)
    assert e.value.code == 1


@pytest.mark.parametrize('argv,message', [
    (['--cost-record', '--cpu'], 'needs a card'), (['--mesh'], 'ROADMAP A7'),
    (['--guarded'], 'needs --ckpt-dir'),
    (['--guarded', '--ckpt-dir', 'd', '--dataset', 'x.npz'],
     'per-step-index')])
def test_cli_refusals(argv, message, capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(argv)
    assert message in capsys.readouterr().err


def test_cli_flags_reach_the_config():
    args = cli.parse_args(['--guarded', '--ckpt-dir', 'd',
                           '--restart-budget', '5', '--spike-zscore', '4.5',
                           '--flush-every', '3', '--metrics', 'm.jsonl'])
    assert args.telemetry and args.restart_budget == 5
    assert args.spike_zscore == 4.5 and args.flush_every == 3
    assert not cli.parse_args(['--metrics', 'm.jsonl']).telemetry


# ---------------------------------------------------------------------- #
# JAX parity of a guarded NaN run
# ---------------------------------------------------------------------- #
# six applied Adam steps, as tests/test_torch_denoise.py's bound: a
# parameter whose gradient is at rounding level may move by up to 2 * lr a
# step the other way; the median within 1e-6
PARITY_STEPS = 6


def test_guarded_nan_run_matches_jax(tmp_path):
    """The same parameters (drawn on JAX's eval_shape tree with numpy and
    converted), JAX's per-step batches, and each step's noise drawn from
    JAX's per-step key (fold_in(PRNGKey(seed), step), split as its step
    splits it) and handed to the port's train_step by a patch: with a NaN
    at build 3 and a latency at dispatch 2 both loops trip, roll back and
    replay alike: the same guard counters, each window's loss mean within
    TRAJ_RTOL (NaN in the same window), and the final parameters within
    2 * lr * PARITY_STEPS, the median within 1e-6."""
    from test_torch_denoise import TRAJ_RTOL, _jax_params
    jcfg = jden.DenoiseConfig(**SMALL)
    jt = jden.DenoiseTrainer(jcfg)
    params = _jax_params(jt.module, jden.synthetic_protein_batch_host(
        jcfg, np.random.RandomState(0)), seed=6)
    jt.params = jax.tree_util.tree_map(jnp.asarray, params)
    jt.opt_state = jt.optimizer.init(jt.params)

    tr = _trainer()
    tr.init()
    tr.model.load_state_dict(convert_flax_params(params, tr.model))
    shape = (jcfg.batch_size, jcfg.num_nodes, 3)
    inner = tr.train_step

    def train_step(batch, noise=None):
        _, sub = jax.random.split(jguard.step_train_rng(jcfg.seed,
                                                        tr.step_count))
        noise = np.array(jax.random.normal(sub, shape, jnp.float32))
        return inner(batch, noise=noise)
    tr.train_step = train_step

    def plans(inj):
        inj.plan('step_batch', 'nan', at=(3,))
        inj.plan('step_dispatch', 'latency', at=(2,), latency_s=0.001)
        return inj

    with JCheckpointManager(str(tmp_path / 'jax')) as jm:
        jm._ckptr = None      # the pickle format: no orbax on this path
        ref = jguard.run_guarded(jt, PARITY_STEPS, jm,
                                 injector=plans(JInjector(seed=0)),
                                 log=_SILENT)
    with CheckpointManager(str(tmp_path / 'port')) as mgr:
        res = run_guarded(tr, PARITY_STEPS, mgr,
                          injector=plans(FaultInjector(seed=0)),
                          log=_SILENT)
    assert res.counters == ref.counters
    assert res.counters['rollbacks'] == 1 and res.exit_code == 0
    assert (res.steps, res.diverged) == (ref.steps, ref.diverged)
    means = [[h['window']['loss']['mean'] for h in r.history
              if 'window' in h] for r in (res, ref)]
    assert len(means[0]) == len(means[1]) == 4
    for got, want in zip(*means):
        if math.isnan(want):
            assert math.isnan(got)
        else:
            assert abs(got - want) <= TRAJ_RTOL * abs(want)
    want = convert_flax_params(jax.device_get(jt.params), tr.model)
    diffs = np.concatenate([(tr.params[k] - v).abs().flatten().numpy()
                            for k, v in want.items()])
    assert diffs.max() <= 2 * jcfg.learning_rate * PARITY_STEPS
    assert np.median(diffs) <= 1e-6
