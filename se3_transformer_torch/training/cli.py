"""Protein-backbone coordinate denoising from the command line: the port's
counterpart of the repository's root denoise.py.

    python -m se3_transformer_torch.training.cli [--steps N] [--nodes N]
        [--batch B] [--degrees D] [--accum K] [--ckpt-dir DIR]
        [--ckpt-every N] [--pipelined] [--prefetch-depth N]
        [--dataset FILE.npz] [--cpu]

Trains DenoiseTrainer(DenoiseConfig(...)) on synthetic chain batches, or
on a PointCloudDataset .npz (--dataset; --nodes is then the bucket size;
sidechainnet.py converts a sidechainnet export). With --ckpt-dir the run
resumes from the newest restorable step there and saves at exit, as
denoise.py does. The card is the default device; --cpu runs the plain
PyTorch path. The flags of machinery the port has not (--mesh, --metrics,
--telemetry, --flush-every, --cost-record, --guarded, --restart-budget,
--spike-zscore) are refused with the ROADMAP item that ports it.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

# denoise.py's flags whose machinery is not ported, with the ROADMAP item
# that ports it
UNPORTED_FLAGS = {
    '--mesh': 'ROADMAP A7 (parallelism)',
    '--metrics': 'ROADMAP A8 (fleet and observability)',
    '--telemetry': 'ROADMAP A8 (fleet and observability)',
    '--flush-every': 'ROADMAP A8 (fleet and observability)',
    '--cost-record': 'ROADMAP A8 (fleet and observability)',
    '--guarded': 'ROADMAP A2.5 (the guarded training loop)',
    '--restart-budget': 'ROADMAP A2.5 (the guarded training loop)',
    '--spike-zscore': 'ROADMAP A2.5 (the guarded training loop)',
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
    ap.add_argument('--pipelined', action='store_true',
                    help='batches built on a producer thread and placed '
                         '--prefetch-depth steps ahead; checkpoints written '
                         'asynchronously')
    ap.add_argument('--prefetch-depth', type=int, default=2)
    ap.add_argument('--dataset', type=str, default=None,
                    help='train from a PointCloudDataset .npz; --nodes is '
                         'the bucket size')
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (the plain PyTorch path)')
    for flag, item in UNPORTED_FLAGS.items():
        ap.add_argument(flag, nargs='?', const=True, default=None,
                        help=f'not ported ({item})')
    args = ap.parse_args(argv)
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag[2:].replace('-', '_')) is not None:
            ap.error(f'{flag}: its machinery is not ported ({item})')
    return args


def main(argv=None):
    from .checkpoint import CheckpointManager
    from .denoise import DenoiseConfig, DenoiseTrainer
    args = parse_args(argv)
    cfg = DenoiseConfig(num_nodes=args.nodes, batch_size=args.batch,
                        num_degrees=args.degrees, accum_steps=args.accum,
                        pipeline=args.pipelined,
                        prefetch_depth=args.prefetch_depth)
    trainer = DenoiseTrainer(cfg, device='cpu' if args.cpu else 'cuda')
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    with ckpt if ckpt is not None else contextlib.nullcontext():
        if ckpt is not None and ckpt.latest_step() is not None:
            trainer.init()
            trainer.restore(ckpt.restore(like=(trainer.params,
                                               trainer.opt_state,
                                               trainer.step_count)))
            print(f'resumed from step {trainer.step_count}')
        if args.dataset:
            from .dataset import PointCloudDataset
            from .pipeline import dataset_batch_source
            stream = dataset_batch_source(
                PointCloudDataset.load(args.dataset),
                batch_size=cfg.batch_size, bucket=cfg.num_nodes,
                accum_steps=cfg.accum_steps,
                num_steps=args.steps if args.pipelined else None)
            if args.pipelined:
                history = trainer.train_pipelined(
                    args.steps, batch_source=stream, checkpoint_manager=ckpt,
                    checkpoint_every=args.ckpt_every)
            else:
                history = []
                for _ in range(args.steps):
                    loss = trainer.train_step(next(stream))
                    history.append(dict(step=trainer.step_count,
                                        loss=float(loss)))
                    print(f'step {trainer.step_count} loss '
                          f'{history[-1]["loss"]:.4f}')
                    if (ckpt is not None and args.ckpt_every > 0
                            and trainer.step_count % args.ckpt_every == 0):
                        ckpt.save(trainer.step_count, (
                            trainer.params, trainer.opt_state,
                            trainer.step_count))
        else:
            history = trainer.train(args.steps, checkpoint_manager=ckpt,
                                    checkpoint_every=args.ckpt_every)
        if ckpt is not None:
            ckpt.save(trainer.step_count, (trainer.params, trainer.opt_state,
                                           trainer.step_count))
            print(f'checkpointed at step {trainer.step_count}')
    return history


if __name__ == '__main__':
    main(sys.argv[1:])
