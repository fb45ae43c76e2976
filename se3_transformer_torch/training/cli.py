"""Protein-backbone coordinate denoising from the command line: the port's
counterpart of the repository's root denoise.py.

    python -m se3_transformer_torch.training.cli [--steps N] [--nodes N]
        [--batch B] [--degrees D] [--accum K] [--ckpt-dir DIR]
        [--ckpt-every N] [--metrics FILE.jsonl] [--telemetry]
        [--flush-every N] [--pipelined] [--prefetch-depth N]
        [--dataset FILE.npz] [--guarded] [--restart-budget N]
        [--spike-zscore Z] [--cpu]

Trains DenoiseTrainer(DenoiseConfig(...)) on synthetic chain batches, or
on a PointCloudDataset .npz (--dataset; --nodes is then the bucket size;
sidechainnet.py converts a sidechainnet export). With --ckpt-dir the run
resumes from the newest restorable step there and saves at exit, as
denoise.py does. --metrics writes the schema'd JSONL stream; --telemetry
accumulates the loss and gradient norm on the device and writes a `flush`
record every --flush-every steps and a `summary` at the end.

--guarded is the self-healing loop (training.guardian): it needs
--ckpt-dir and turns telemetry on; a non-finite or spiking window rolls
back to the newest restorable checkpoint and replays, SIGTERM/SIGINT make
one emergency save, and the process exits with the GuardResult's code: 75
preempted (run it again to resume), 1 diverged, 0 clean. A guarded resume
goes through guardian.resume_trainer.

--cost-record writes one `cost` record of a warm training step after the
first step (DenoiseTrainer.cost_record: the allocator's peak, the
argument bytes) into --metrics; it needs a card.

The card is the default device; --cpu runs the plain PyTorch path. The
flag of machinery the port has not (--mesh) is refused with the ROADMAP
item that ports it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

# denoise.py's flags whose machinery is not ported, with the ROADMAP item
# that ports it
UNPORTED_FLAGS = {
    '--mesh': 'ROADMAP A7 (parallelism)',
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description='Coordinate denoising (DenoiseTrainer) on the port')
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--nodes', type=int, default=96)
    ap.add_argument('--batch', type=int, default=1)
    ap.add_argument('--degrees', type=int, default=2)
    ap.add_argument('--accum', type=int, default=16,
                    help='gradient-accumulation micro-steps')
    ap.add_argument('--ckpt-dir', type=str, default=None)
    ap.add_argument('--ckpt-every', type=int, default=0,
                    help='also checkpoint every N steps (0 = only at exit)')
    ap.add_argument('--metrics', type=str, default=None,
                    help='the schema\'d JSONL metric stream')
    ap.add_argument('--telemetry', action='store_true',
                    help='on-device loss and gradient-norm accumulation (no '
                         'per-step host sync), phase timing, the one-time '
                         'work watchdog, flush and summary records')
    ap.add_argument('--flush-every', type=int, default=5,
                    help='telemetry flush interval in optimizer steps (one '
                         'device-to-host copy per flush)')
    ap.add_argument('--pipelined', action='store_true',
                    help='batches built on a producer thread and placed '
                         '--prefetch-depth steps ahead; checkpoints written '
                         'asynchronously')
    ap.add_argument('--prefetch-depth', type=int, default=2)
    ap.add_argument('--dataset', type=str, default=None,
                    help='train from a PointCloudDataset .npz; --nodes is '
                         'the bucket size')
    ap.add_argument('--guarded', action='store_true',
                    help='the self-healing loop (training.guardian): needs '
                         '--ckpt-dir, implies --telemetry; exits 75 when '
                         'preempted, 1 when diverged')
    ap.add_argument('--restart-budget', type=int, default=3,
                    help='guarded: rollbacks allowed before TrainingFailed')
    ap.add_argument('--spike-zscore', type=float, default=8.0,
                    help='guarded: the EMA z-score above which a window\'s '
                         'loss mean is a spike')
    ap.add_argument('--cost-record', action='store_true',
                    help="one schema'd `cost` record of a warm training "
                         'step after the first step (the allocator peak '
                         'and argument bytes; pair with --metrics)')
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (the plain PyTorch path)')
    for flag, item in UNPORTED_FLAGS.items():
        ap.add_argument(flag, nargs='?', const=True, default=None,
                        help=f'not ported ({item})')
    args = ap.parse_args(argv)
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag[2:].replace('-', '_')) is not None:
            ap.error(f'{flag}: its machinery is not ported ({item})')
    if args.cost_record and args.cpu:
        ap.error('--cost-record needs a card: the record is the allocator '
                 'peak of a training step, and the CPU has none')
    if args.guarded:
        if not args.ckpt_dir:
            ap.error('--guarded needs --ckpt-dir (the rollback target and '
                     'the preemption resume point live there)')
        if args.dataset:
            ap.error('--guarded trains on per-step-index synthetic batches '
                     '(deterministic replay); a dataset-backed guarded loop '
                     'is not wired, as in denoise.py')
        args.telemetry = True      # detection rides the accumulator
    return args


def _train_dataset(trainer, args, ckpt, logger):
    """The --dataset loop (denoise.py's): the pipelined trainer on the
    dataset's batches, or train_step on them one by one."""
    from .dataset import PointCloudDataset
    from .pipeline import dataset_batch_source
    cfg = trainer.cfg
    stream = dataset_batch_source(
        PointCloudDataset.load(args.dataset), batch_size=cfg.batch_size,
        bucket=cfg.num_nodes, accum_steps=cfg.accum_steps,
        num_steps=args.steps if args.pipelined else None)
    if args.pipelined:
        return trainer.train_pipelined(
            args.steps, batch_source=stream, checkpoint_manager=ckpt,
            checkpoint_every=args.ckpt_every,
            log=lambda msg: logger.log(trainer.step_count, msg=msg),
            metric_logger=logger if (cfg.telemetry or cfg.cost_record)
            else None)
    history = []
    for i in range(args.steps):
        with trainer._phase('data'):
            batch = next(stream)
        loss = trainer.train_step(batch)
        if i == 0:
            # this loop drives train_step itself: the trainer's first-step
            # hook never runs
            trainer._maybe_cost_record(batch, logger, history)
        if cfg.telemetry:
            # no per-step host sync: the metrics flush per interval
            if (i + 1) % cfg.flush_every == 0:
                history.append(trainer.telemetry_flush(logger))
        else:
            history.append(logger.log(trainer.step_count, loss=float(loss)))
        if (ckpt is not None and args.ckpt_every > 0
                and trainer.step_count % args.ckpt_every == 0):
            with trainer._phase('checkpoint'):
                ckpt.save(trainer.step_count, (
                    trainer.params, trainer.opt_state, trainer.step_count))
    if cfg.telemetry:
        history.append(trainer.telemetry_close(logger))
    return history


def main(argv=None):
    from ..observability import MetricLogger
    from .checkpoint import CheckpointManager
    from .denoise import DenoiseConfig, DenoiseTrainer
    args = parse_args(argv)
    cfg = DenoiseConfig(num_nodes=args.nodes, batch_size=args.batch,
                        num_degrees=args.degrees, accum_steps=args.accum,
                        telemetry=args.telemetry,
                        flush_every=args.flush_every,
                        pipeline=args.pipelined,
                        prefetch_depth=args.prefetch_depth,
                        cost_record=args.cost_record)
    trainer = DenoiseTrainer(cfg, device='cpu' if args.cpu else 'cuda')
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    run_meta = dict(tool='denoise', config=dataclasses.asdict(cfg))
    with ckpt if ckpt is not None else contextlib.nullcontext(), \
            MetricLogger(args.metrics, run_meta=run_meta) as logger:
        if args.guarded:
            from .guardian import GuardConfig, StepGuard, resume_trainer
            restart = ckpt.latest_step() is not None
            if restart:
                print(f'guarded resume from step '
                      f'{resume_trainer(trainer, ckpt)}')
            guard = StepGuard(GuardConfig(
                restart_budget=args.restart_budget,
                spike_zscore=args.spike_zscore))
            result = trainer.train_guarded(
                args.steps, ckpt, guard=guard, metric_logger=logger,
                restart=restart)
            # 75: preempted, resumable (a supervisor restarts the run);
            # 1: diverged
            if result.exit_code:
                sys.exit(result.exit_code)
            return result.history
        if ckpt is not None and ckpt.latest_step() is not None:
            trainer.init()
            trainer.restore(ckpt.restore(like=(trainer.params,
                                               trainer.opt_state,
                                               trainer.step_count)))
            print(f'resumed from step {trainer.step_count}')
        # the cost record rides the stream too, telemetry or not
        metric_logger = logger if (cfg.telemetry or cfg.cost_record) \
            else None
        if args.dataset:
            history = _train_dataset(trainer, args, ckpt, logger)
        else:
            history = trainer.train(
                args.steps, log=lambda msg: logger.log(trainer.step_count,
                                                       msg=msg),
                checkpoint_manager=ckpt, checkpoint_every=args.ckpt_every,
                metric_logger=metric_logger)
        if ckpt is not None:
            ckpt.save(trainer.step_count, (trainer.params, trainer.opt_state,
                                           trainer.step_count))
            print(f'checkpointed at step {trainer.step_count}')
    return history


if __name__ == '__main__':
    main(sys.argv[1:])
