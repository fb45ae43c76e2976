"""Self-healing training: the port of se3_transformer_tpu/training/guardian.py.

NaN and spike rollback, preemption safety and the guarded loop around
`DenoiseTrainer`. The plain loop cannot survive three things:

  * a non-finite loss or gradient (one bad batch, an overflowing
    activation) poisons the parameters within one Adam update, and every
    later step trains a corpse;
  * a SIGTERM lands mid-run, and the work since the last periodic
    checkpoint is gone, or a checkpoint is torn mid-write;
  * a flaky batch source kills the run (`BatchProducerError`).

The pieces, composed by `run_guarded`:

  * `StepGuard`: detection with no new host sync. The guarded loop needs
    `cfg.telemetry`, so the loss and the global gradient norm already fold
    into the on-device `MetricAccumulator`; the guard reads the window that
    `telemetry_flush` fetches (one device-to-host copy a window, as
    without the guard). Non-finite window statistics trip at once; an EMA
    z-score detector (`SpikeDetector`) trips on a loss-mean spike after a
    warmup.
  * rollback: on a trip, restore the newest restorable checkpoint through
    `CheckpointManager.restore` (a torn newest step is skipped with a
    warning), adopt it with `DenoiseTrainer.restore` (which copies every
    tensor: Adam updates in place, so the trainer must share no storage
    with the restored state), and replay. The replay is deterministic:
    every batch (`step_batch_rng`) and every step's noise
    (`step_train_rng`) derive from the absolute step index, so a
    rolled-back run ends on the trajectory of a run that never faulted.
    Rollbacks count against `restart_budget`; past it a structured
    `TrainingFailed` (counters attached) is raised.
  * `PreemptionGuard`: SIGTERM/SIGINT set a flag the loop reads between
    steps; the loop then closes the batch producer, waits for the async
    checkpoint writer, makes ONE synchronous emergency save (the
    `emergency_save` fault site can kill even that: the run still exits
    resumable and falls back to the last periodic checkpoint), and the
    CLI exits with `RESUMABLE_RC` (75, EX_TEMPFAIL).
  * the `guard` record, one per guarded run (observability.schema): the
    trips, rollbacks, restarts, skipped_batches, preemptions and
    injections_total counters and the `diverged` bit (final parameters
    non-finite, or a trip the policy never paid down). The counters
    persist across process restarts in a JSON sidecar beside the
    checkpoints (`guard_state.json`), so the record a resumed run writes
    tells the whole run's story.

Meshes (JAX's sharded placement of a restored state) are ROADMAP A7.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import signal
import warnings
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    'GuardConfig', 'GuardResult', 'PreemptionGuard', 'RESUMABLE_RC',
    'SpikeDetector', 'StepGuard', 'TrainingFailed', 'poison_batch',
    'resume_trainer', 'run_guarded', 'step_batch_rng', 'step_train_rng',
]

# EX_TEMPFAIL: "preempted, resume me"; a supervisor tells it from rc 1
RESUMABLE_RC = 75

_GUARD_STATE_FILE = 'guard_state.json'
_COUNTERS = ('trips', 'rollbacks', 'restarts', 'skipped_batches',
             'preemptions', 'injections_total')


class TrainingFailed(RuntimeError):
    """The restart budget is spent: training fails loud with its counters
    attached (terminal, not a preemption)."""

    def __init__(self, message: str, **counters):
        super().__init__(message)
        self.counters = dict(counters)

    def to_record(self) -> dict:
        return dict(error='training_failed', message=str(self),
                    **self.counters)


@dataclasses.dataclass
class GuardConfig:
    """The self-healing policy's knobs."""
    # EMA z-score spike detection: trip when a window's loss mean sits
    # more than spike_zscore EMA standard deviations above the EMA mean,
    # after warmup_windows clean windows armed the statistics
    spike_zscore: float = 8.0
    ema_decay: float = 0.9
    warmup_windows: int = 3
    # restore and replay at most restart_budget times, then fail loud;
    # rollback=False detects without responding (the run must then end
    # diverged and exit 1)
    restart_budget: int = 3
    rollback: bool = True
    # skip the offending window instead of replaying it (for data that
    # re-trips deterministically); off: replay keeps bit-exact parity
    # with an unfaulted run, since injected faults do not fire again
    skip_window: bool = False
    # the guarded pipeline's BatchProducer: transient source errors retry
    # with bounded backoff, then up to source_max_skips batches are dropped
    source_max_retries: int = 2
    source_retry_backoff_s: float = 0.05
    source_max_skips: int = 0


class SpikeDetector:
    """EMA mean/variance z-score over flushed window loss means.

    `observe(x)` is True when x spikes beyond `zscore` EMA standard
    deviations; clean observations update the statistics, spiking ones do
    not (a spike must not drag the baseline up and mask its successors)."""

    def __init__(self, zscore: float = 8.0, decay: float = 0.9,
                 warmup: int = 3):
        self.zscore = float(zscore)
        self.decay = float(decay)
        self.warmup = int(warmup)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.seen = 0

    def observe(self, x: float) -> bool:
        if not math.isfinite(x):
            return True
        if self.mean is not None and self.seen >= self.warmup:
            sd = math.sqrt(max(self.var, 1e-12))
            if (x - self.mean) / sd > self.zscore:
                return True
        if self.mean is None:
            self.mean = x
        else:
            d = x - self.mean
            self.mean += (1.0 - self.decay) * d
            self.var = self.decay * (self.var + (1.0 - self.decay) * d * d)
        self.seen += 1
        return False


class StepGuard:
    """Window-level fault detection and the guard record's counters.

    Reads only the statistics `telemetry_flush` already fetched. Counters
    may be seeded from a previous process's sidecar (`load_counters`), so
    a resumed run's record is cumulative."""

    def __init__(self, cfg: Optional[GuardConfig] = None):
        self.cfg = cfg or GuardConfig()
        self.spikes = SpikeDetector(self.cfg.spike_zscore,
                                    self.cfg.ema_decay,
                                    self.cfg.warmup_windows)
        self.counters = {k: 0 for k in _COUNTERS}
        self.diverged = False
        self.last_verdict = 'ok'

    def check_window(self, window: dict) -> str:
        """'ok' | 'nonfinite' | 'spike' for one flushed metric window
        ({'loss': {count, mean, min, max}, 'grad_norm': {...}})."""
        vals = []
        for name in ('loss', 'grad_norm'):
            st = window.get(name) or {}
            vals += [st.get(k) for k in ('mean', 'min', 'max')
                     if st.get(k) is not None]
        if any(not math.isfinite(v) for v in vals):
            self.last_verdict = 'nonfinite'
            return 'nonfinite'
        loss = (window.get('loss') or {}).get('mean')
        if loss is not None and self.spikes.observe(loss):
            self.last_verdict = 'spike'
            return 'spike'
        self.last_verdict = 'ok'
        return 'ok'

    def bump(self, name: str, by: int = 1):
        self.counters[name] += by

    def load_counters(self, directory: str):
        """Seed the counters from a previous process's sidecar (resume)."""
        path = os.path.join(directory, _GUARD_STATE_FILE)
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                saved = json.load(f)
        except (OSError, ValueError) as e:
            # a torn sidecar must never block a resume
            warnings.warn(f'guard sidecar {path} unreadable '
                          f'({type(e).__name__}: {e}): counters reset',
                          RuntimeWarning)
            return
        for k in _COUNTERS:
            if isinstance(saved.get(k), int):
                self.counters[k] = saved[k]

    def save_counters(self, directory: str):
        """Atomic sidecar write (a temporary file, then os.replace)."""
        path = os.path.join(directory, _GUARD_STATE_FILE)
        tmp = path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(self.counters, f)
        os.replace(tmp, path)

    def record(self, step: int, injector=None) -> dict:
        """The `guard` record's fields; with an injector, its firings by
        site beside the counters."""
        fields = dict(step=int(step), diverged=bool(self.diverged),
                      **{k: int(v) for k, v in self.counters.items()})
        if injector is not None:
            fields['injections_by_site'] = injector.snapshot()['by_site']
        return fields


class PreemptionGuard:
    """SIGTERM/SIGINT -> a flag the loop polls (in the signal handler: set
    a bool, nothing else). Context-managed so the previous handlers are
    restored on exit; `request_stop()` is the programmatic equivalent."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.stop_requested = False
        self.signame: Optional[str] = None
        self._previous = {}

    def request_stop(self, signame: str = 'request_stop'):
        self.stop_requested = True
        self.signame = signame

    def _handler(self, signum, frame):
        self.request_stop(signal.Signals(signum).name)

    def __enter__(self) -> 'PreemptionGuard':
        for sig in self.SIGNALS:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except ValueError:
                # not the main thread: request_stop still works
                pass
        return self

    def __exit__(self, exc_type, exc, tb):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        return False


# ---------------------------------------------------------------------- #
# everything a step consumes derives from the absolute step index, so a
# resume or a rollback replays bit for bit
# ---------------------------------------------------------------------- #
def step_batch_rng(seed: int, step_index: int) -> np.random.RandomState:
    """The host rng of step `step_index` (JAX's formula): step k's batch is
    the same whether reached straight through, after a rollback or in a
    resumed process, and it is JAX's."""
    return np.random.RandomState((int(seed) * 1000003 + step_index)
                                 % (2 ** 31 - 1))


def step_train_rng(seed: int, step_index: int,
                   device='cpu') -> torch.Generator:
    """The noise generator of step `step_index`: a torch.Generator on
    `device` seeded from (seed, step_index) alone, as JAX's
    fold_in(PRNGKey(seed), step_index) is a key of those two alone."""
    state = np.random.SeedSequence((int(seed), int(step_index)))
    return torch.Generator(device).manual_seed(
        int(state.generate_state(1, np.uint64)[0]) >> 1)


def poison_batch(batch: dict) -> dict:
    """The cooperative half of the injector's `nan` kind: the coordinates
    times NaN, so that a real non-finite loss flows through the step."""
    out = dict(batch)
    out['coords'] = np.asarray(batch['coords']) * np.float32(np.nan)
    return out


def _host_micro_batches(trainer, step_index: int) -> dict:
    """The host batch of step `step_index`: accum_steps synthetic batches
    from step_batch_rng, stacked on a leading axis as micro_batches_host
    stacks them."""
    from .denoise import synthetic_protein_batch_host
    cfg = trainer.cfg
    rng = step_batch_rng(cfg.seed, step_index)
    batches = [synthetic_protein_batch_host(cfg, rng)
               for _ in range(trainer.accum_steps)]
    if trainer.accum_steps == 1:
        return batches[0]
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _params_finite(trainer) -> bool:
    """Every floating parameter and buffer finite (one host sync)."""
    flags = [torch.isfinite(v).all() for v in trainer.params.values()
             if v.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


def _restore_state(trainer, checkpoint_manager):
    """The newest restorable checkpoint (the fallback-aware path), its
    tensors placed as the trainer's."""
    return checkpoint_manager.restore(
        like=(trainer.params, trainer.opt_state, trainer.step_count))


def resume_trainer(trainer, checkpoint_manager) -> int:
    """Adopt the newest restorable checkpoint into `trainer` (the process
    restart half of the loop): initialize it if needed, restore with the
    fallback-aware path. Returns the restored step (0 when the directory
    holds no checkpoint: a fresh run)."""
    if checkpoint_manager.latest_step() is None:
        return 0
    if not trainer._initialized:
        trainer.init()
    trainer.restore(_restore_state(trainer, checkpoint_manager))
    return trainer.step_count


@dataclasses.dataclass
class GuardResult:
    """What run_guarded hands back (the CLI maps it to an exit code)."""
    steps: int
    preempted: bool
    diverged: bool
    counters: dict
    history: list
    guard_record: Optional[dict] = None

    @property
    def exit_code(self) -> int:
        if self.preempted:
            return RESUMABLE_RC
        return 1 if self.diverged else 0


def run_guarded(trainer, num_steps: int, checkpoint_manager,
                guard: Optional[StepGuard] = None,
                injector=None, metric_logger=None,
                restart: bool = False,
                step_hook: Optional[Callable[[int], None]] = None,
                log=print) -> GuardResult:
    """The self-healing loop over a `DenoiseTrainer` of the config form.

    Needs `trainer.cfg.telemetry` (detection rides the accumulator: no
    extra host sync on clean steps) and a `CheckpointManager`. The window
    is `cfg.flush_every` steps: each window runs its steps, flushes
    telemetry once, checks the window and, when clean, checkpoints
    asynchronously (the window boundary is the rollback grain; every
    consumer of a checkpoint waits for the writer first). `cfg.pipeline`
    selects the overlapped data path: a `BatchProducer` (wired to the
    injector's `batch_source` site, retry and skip per GuardConfig) feeds
    `device_prefetch` per segment; a rollback or a preemption closes the
    producer, and the next segment starts it again at the rolled-back
    step.

    `restart=True` marks a resumed process: the counters load from the
    sidecar and `restarts` goes up by one. `step_hook(step_count)` runs
    after every optimizer step (progress reports; tests request a stop
    there)."""
    cfg = trainer.cfg
    if cfg is None or not cfg.telemetry:
        raise ValueError('run_guarded needs DenoiseConfig(telemetry=True): '
                         'detection rides the on-device MetricAccumulator, '
                         'so clean steps cost no extra host sync')
    guard = guard or StepGuard()
    gcfg = guard.cfg
    window = max(1, cfg.flush_every)
    guard.load_counters(checkpoint_manager.directory)
    if restart:
        guard.bump('restarts')
    history = []
    last_good_step = trainer.step_count
    # a first-window trip must have something to roll back to: anchor
    # whenever the directory is empty
    needs_anchor = checkpoint_manager.latest_step() is None
    # injections carried from a previous process (the sidecar) plus this
    # process's injector total, read from the injector itself (it fires on
    # the step loop and the producer thread)
    base_injections = guard.counters['injections_total']

    def sync_injections():
        if injector is not None:
            guard.counters['injections_total'] = (
                base_injections + injector.injections_total)

    def fire(site, **ctx):
        if injector is None:
            return None
        return injector.fire(site, **ctx)

    def save_good(step, sync=False):
        """Checkpoint a guard-clean state: save_async at window ends (the
        write overlaps the next window), a synchronous save on the
        emergency path (durable before the process exits)."""
        nonlocal last_good_step
        with trainer.phase_timer.phase('checkpoint'):
            state = (trainer.params, trainer.opt_state, step)
            if sync:
                checkpoint_manager.save(step, state)
            else:
                checkpoint_manager.save_async(step, state)
        sync_injections()
        guard.save_counters(checkpoint_manager.directory)
        last_good_step = step

    def emergency_save(step):
        """One synchronous save on the preemption path, after the partial
        window is flushed and checked: a preemption in the window of a NaN
        step must not checkpoint poisoned parameters as the newest resume
        point. The save itself may die (the `emergency_save` site): the
        restart then falls back to the last periodic checkpoint."""
        guard.bump('preemptions')
        try:
            flush = trainer.telemetry_flush(metric_logger)
            history.append(flush)
            if guard.check_window(flush.get('window') or {}) != 'ok':
                warnings.warn(
                    f'preemption landed on a tripped window at step {step}: '
                    f'no emergency save; the restart resumes from the last '
                    f'good step {last_good_step}', RuntimeWarning)
            else:
                fire('emergency_save', step=int(step))
                checkpoint_manager.wait_until_finished()
                save_good(step, sync=True)
                log(f'preemption: emergency checkpoint at step {step}, '
                    f'exiting resumable (rc {RESUMABLE_RC})')
        except Exception as e:  # noqa: BLE001 - a dying emergency writer
            # must not turn a preemption into a hard failure
            warnings.warn(
                f'emergency checkpoint failed ({type(e).__name__}: {e}): '
                f'exiting resumable anyway; the restart falls back to '
                f'step {last_good_step}', RuntimeWarning)
        sync_injections()
        guard.save_counters(checkpoint_manager.directory)

    def close_record():
        sync_injections()
        rec = guard.record(trainer.step_count, injector=injector)
        if metric_logger is not None:
            rec = metric_logger.log_record('guard', **rec)
        else:
            rec = dict(kind='guard', **rec)
        history.append(rec)
        return rec

    def rollback(reason: str) -> bool:
        """Restore the newest restorable checkpoint and rewind the loop.
        False when the policy does not act (rollback disabled)."""
        guard.bump('trips')
        if not gcfg.rollback:
            warnings.warn(
                f'guard tripped ({reason}) at step {trainer.step_count} '
                f'but rollback is disabled: training continues on suspect '
                f'parameters', RuntimeWarning)
            return False
        if guard.counters['rollbacks'] + 1 > gcfg.restart_budget:
            guard.diverged = True
            close_record()
            raise TrainingFailed(
                f'restart budget spent: {guard.counters["rollbacks"]} '
                f'rollbacks already, guard tripped again ({reason}) at '
                f'step {trainer.step_count}', **guard.counters)
        checkpoint_manager.wait_until_finished()
        tripped_at = trainer.step_count
        state = _restore_state(trainer, checkpoint_manager)
        trainer.restore(state)
        guard.bump('rollbacks')
        if gcfg.skip_window:
            skipped = tripped_at - trainer.step_count
            trainer.step_count = tripped_at
            guard.bump('skipped_batches', skipped)
            log(f'guard trip ({reason}): rolled back the parameters to step '
                f'{state[2]}, skipped the {skipped}-step window')
        else:
            log(f'guard trip ({reason}): rolled back to step '
                f'{trainer.step_count}, replaying')
        sync_injections()
        guard.save_counters(checkpoint_manager.directory)
        return True

    def run_one_step(preemption, batch=None) -> bool:
        """One guarded optimizer step at the trainer's current index;
        False when the loop must stop (preemption)."""
        step_index = trainer.step_count
        fire('step_dispatch', step=step_index)
        if batch is None:
            with trainer.phase_timer.phase('data'):
                batch = _host_micro_batches(trainer, step_index)
                if fire('step_batch', step=step_index) == 'nan':
                    batch = poison_batch(batch)
        trainer.generator = step_train_rng(cfg.seed, step_index,
                                           trainer.device)
        trainer.train_step(batch)
        if step_hook is not None:
            step_hook(trainer.step_count)
        return not preemption.stop_requested

    def check_and_checkpoint() -> str:
        # telemetry_flush merges the window into the run's cumulative
        # statistics; a tripped window must not stay merged (the rollback
        # erases its steps), so snapshot and restore on a trip. The flush
        # record keeps the poisoned window: it is the evidence.
        prev_cum = (None if trainer._cum_metrics is None
                    else {k: dict(v)
                          for k, v in trainer._cum_metrics.items()})
        flush = trainer.telemetry_flush(metric_logger)
        history.append(flush)
        verdict = guard.check_window(flush.get('window') or {})
        if verdict == 'ok':
            save_good(trainer.step_count)
        else:
            trainer._cum_metrics = prev_cum
        return verdict

    def is_window_end() -> bool:
        return (trainer.step_count % window == 0
                or trainer.step_count >= num_steps)

    def plain_segment(preemption):
        """Steps on batches built in the loop, up to a trip or a stop."""
        while trainer.step_count < num_steps:
            try:
                stop = not run_one_step(preemption)
            except Exception as e:  # noqa: BLE001 - an injected or real
                # step fault is a trip, not a crash (the policy decides)
                return f'step_error:{e}', False
            if is_window_end():
                verdict = check_and_checkpoint()
                if verdict != 'ok':
                    return verdict, stop
            if stop:
                return None, True
        return None, False

    preempted = False
    with PreemptionGuard() as preemption:
        try:
            if not trainer._initialized:
                # the weights depend on the seed alone: the same in every
                # arm of a run
                trainer.init()
            if needs_anchor:
                save_good(trainer.step_count)
            while trainer.step_count < num_steps:
                if cfg.pipeline:
                    trip, stop = _pipelined_segment(
                        trainer, num_steps, fire, run_one_step,
                        check_and_checkpoint, is_window_end, preemption,
                        injector, metric_logger, history, gcfg)
                else:
                    trip, stop = plain_segment(preemption)
                if trip is not None:
                    if not rollback(trip) and trip.startswith('step_error'):
                        # rollback disabled and the step itself raised: skip
                        # the failing step rather than spin on it (the
                        # diverged verdict still lands)
                        guard.bump('skipped_batches')
                        trainer.step_count += 1
                    continue
                if stop or preemption.stop_requested:
                    break
            if preemption.stop_requested:
                preempted = True
                emergency_save(trainer.step_count)
        finally:
            if not preempted:
                # the residual flush and the summary (one more sync)
                try:
                    history.append(trainer.telemetry_close(metric_logger))
                except Exception as e:  # noqa: BLE001 - the close must not
                    # mask the error that is unwinding
                    warnings.warn(f'telemetry close failed '
                                  f'({type(e).__name__}: {e})',
                                  RuntimeWarning)
    if preempted:
        rec = None
    else:
        guard.diverged = guard.diverged or (
            guard.last_verdict != 'ok' and not gcfg.rollback) or (
            not _params_finite(trainer))
        rec = close_record()
        guard.save_counters(checkpoint_manager.directory)
    return GuardResult(steps=trainer.step_count, preempted=preempted,
                       diverged=guard.diverged,
                       counters=dict(guard.counters), history=history,
                       guard_record=rec)


def _pipelined_segment(trainer, num_steps, fire, run_one_step,
                       check_and_checkpoint, is_window_end, preemption,
                       injector, metric_logger, history, gcfg):
    """One producer/prefetch segment of the pipelined guarded loop: the
    per-index host batches (the `step_batch` nan site fires at build, on
    the producer thread), a `BatchProducer` with the `batch_source` site
    and GuardConfig's retry and skip budgets, and `device_prefetch` onto
    the trainer's device. The producer is closed when the segment returns.
    Returns (trip reason or None, stop)."""
    from .pipeline import BatchProducer, PipelineStats, device_prefetch
    cfg = trainer.cfg
    start = trainer.step_count

    def source():
        for i in itertools.count(start):
            if i >= num_steps:
                return
            host = _host_micro_batches(trainer, i)
            if fire('step_batch', step=i) == 'nan':
                host = poison_batch(host)
            yield host

    stats = PipelineStats(depth=cfg.prefetch_depth,
                          capacity=cfg.producer_capacity)
    trip, stop = None, False
    with BatchProducer(source(), capacity=cfg.producer_capacity,
                       fault_injector=injector,
                       max_retries=gcfg.source_max_retries,
                       retry_backoff_s=gcfg.source_retry_backoff_s,
                       max_skips=gcfg.source_max_skips) as producer:
        stats.bind_source(producer)
        batches = device_prefetch(producer, depth=cfg.prefetch_depth,
                                  device=trainer.device, stats=stats,
                                  phase_timer=trainer.phase_timer)
        for batch in batches:
            try:
                if not run_one_step(preemption, batch=batch):
                    stop = True
            except Exception as e:  # noqa: BLE001 - a trip, not a crash
                trip = f'step_error:{e}'
            if trip is None and is_window_end():
                verdict = check_and_checkpoint()
                if metric_logger is not None:
                    history.append(trainer._pipeline_record(
                        stats, metric_logger))
                if verdict != 'ok':
                    trip = verdict
            if trip is not None or stop:
                break
    return trip, stop
