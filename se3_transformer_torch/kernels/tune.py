"""The end-to-end kernel block tuner: the port of scripts/tune_kernels.py.

    python -m se3_transformer_torch.kernels.tune [--dry-run] [--smoke]
        [--out TUNE.jsonl] [--steps 10] [--pairs 3] [--margin 0.03]
        [--recipe flagship_fast] [--dim D] [--nodes N] [--kinds plain ...]
        [--max-candidates 0] [--max-targets 0] [--conv-backend dense]
        [--fuse-pairwise] [--pallas-attention] [--attention-mode knn]
        [--device cuda]

It never times a kernel alone (a standalone ranking can be the opposite of
the end-to-end one):

  1. build the real train step of a recipe, as chip_smoke.py's train
     phases do (training.recipes, a synthetic batch, DenoiseTrainer), or
     with --smoke a tiny model (the JAX smoke's widths);
  2. run one step with the resolved picks dropped and the consult log
     reset: the picks it resolves (kernels.tuning) of --kinds that have an
     admissible candidate besides their own are the targets, interleaved
     over the kernel arms they steer (tuning.target_arm), so that a
     --max-targets cut keeps one of each arm;
  3. per target, the admissible candidates (tuning.admissible_candidates);
  4. each candidate through the whole step under tuning.force(kind,
     blocks, shape=, dtype=) in --pairs alternating windows of --steps
     steps against the incumbent;
  5. promote (tuning.promote) only a candidate that beats the incumbent by
     --margin in every pair; the entry is the incumbent after;
  6. run one step again and require every promoted entry to resolve from
     the table (verdict 'consulted'); exit 1 otherwise.

Every step appends a schema'd `tune` record to --out (validated first, one
line flushed and synced at a time) and prints it. A non-positive margin
still measures end to end; --margin -1 promotes every measured candidate,
which runs the promote and consult path deterministically (JAX's
tune-smoke convention). On the CPU (--device cpu) only the plain versions
run, so only the 'so2', 'flash_stream' and 'flash_global' picks resolve.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import uuid

import numpy as np
import torch

KINDS_DEFAULT = ('plain', 'bx', 'bxf', 'attention', 'attention_bwd', 'so2',
                 'flash', 'flash_stream', 'flash_global')


def _emit(args, rec):
    """Validate, then append the record to --out (flushed and synced) and
    print it."""
    from ..observability.schema import validate_record
    validate_record(rec)
    line = json.dumps(rec)
    print(line, flush=True)
    with open(args.out, 'a') as f:
        f.write(line + '\n')
        f.flush()
        os.fsync(f.fileno())


def _build_step(args) -> dict:
    """The train step the tuner measures: {trainer, batch, num_nodes,
    label}. With --smoke the JAX smoke's tiny model (tokens 24, dim 8, two
    degrees, depth 1); else the recipe at its widths with the vector head."""
    from ..models.se3_transformer import SE3TransformerModule
    from ..training.denoise import DenoiseTrainer, flagship_batch
    from ..training.recipes import RECIPES
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    device = args.device
    if args.smoke:
        n, dim = args.nodes or 32, 8
        fields = dict(num_tokens=24, dim=dim, dim_head=8, heads=2, depth=1,
                      attend_self=True, input_degrees=1, num_degrees=2,
                      output_degrees=2, reduce_dim_out=True,
                      conv_backend=args.conv_backend)
        if args.attention_mode == 'global':
            if args.fuse_pairwise or args.pallas_attention:
                raise SystemExit('--attention-mode global subsumes the '
                                 'fused-attention flags')
            fields.update(attention_mode='global')
        else:
            fields.update(num_neighbors=8, fuse_pairwise=args.fuse_pairwise,
                          shared_radial_hidden=args.fuse_pairwise,
                          pallas_attention=args.pallas_attention or None)
        model = SE3TransformerModule(device=device, generator=gen, **fields)
        label = f'smoke,dim={dim},{args.attention_mode},{args.conv_backend}'
        coords = np.cumsum(rng.normal(size=(1, n, 3)), axis=1)
        batch = dict(seqs=rng.randint(0, 24, (1, n)),
                     coords=(coords - coords.mean(1, keepdims=True))
                     .astype(np.float32), masks=np.ones((1, n), bool))
    else:
        n = args.nodes or 1024
        overrides = dict(output_degrees=2, reduce_dim_out=True,
                         conv_backend=args.conv_backend)
        if args.dim:
            overrides['dim'] = args.dim
        if args.fuse_pairwise:
            overrides.update(fuse_pairwise=True, shared_radial_hidden=True)
        if args.pallas_attention:
            overrides['pallas_attention'] = True
        if args.attention_mode == 'global':
            overrides['attention_mode'] = 'global'
        model = RECIPES[args.recipe](device=device, generator=gen,
                                     **overrides)
        dim = model.dim
        label = f'{args.recipe},dim={dim},n={n}'
        batch = flagship_batch(rng, 1, n, dim)
    trainer = DenoiseTrainer(model, lr=1e-4, device=device)
    return dict(trainer=trainer, batch=trainer.to_device(batch),
                num_nodes=n, label=label)


def _measure_window(state: dict, steps: int) -> float:
    """One timed window of `steps` train steps, the last loss read back
    before the clock stops: nodes * steps / s."""
    trainer = state['trainer']
    t0 = time.perf_counter()
    loss = None
    for _ in range(steps):
        loss = trainer.train_step(state['batch'])
    float(loss)
    return state['num_nodes'] * steps / (time.perf_counter() - t0)


def _resolved(state: dict) -> list:
    """The consults of one step run with the resolved picks dropped."""
    from . import tuning
    tuning.clear_kernel_caches()
    tuning.reset_consults()
    _measure_window(state, 1)
    return tuning.consults()


def _targets(state: dict, kinds) -> list:
    """The step's resolved picks of `kinds` with a candidate to measure,
    interleaved over the arms they steer."""
    from . import tuning
    by_arm, seen = {}, set()
    for c in _resolved(state):
        key = (c['kernel'], tuple(c['shape']), c['dtype'])
        if c['kernel'] not in kinds or key in seen:
            continue
        seen.add(key)
        if len(tuning.admissible_candidates(c['kernel'], c['shape'])) > 1:
            by_arm.setdefault(tuning.target_arm(c['kernel'], c['shape']),
                              []).append(c)
    out = []
    for i in range(max((len(v) for v in by_arm.values()), default=0)):
        out += [v[i] for v in by_arm.values() if i < len(v)]
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description='end-to-end shape-keyed kernel block tuner')
    ap.add_argument('--out', default='TUNE.jsonl')
    ap.add_argument('--dry-run', action='store_true',
                    help='enumerate the admissible candidates and emit tune '
                         'records without measuring or promoting')
    ap.add_argument('--smoke', action='store_true',
                    help="a tiny model (the JAX smoke's widths)")
    ap.add_argument('--steps', type=int, default=10,
                    help='train steps per timed window')
    ap.add_argument('--pairs', type=int, default=3,
                    help='alternating incumbent/candidate window pairs')
    ap.add_argument('--margin', type=float, default=0.03,
                    help='fractional end-to-end win required to promote')
    ap.add_argument('--recipe', default='flagship_fast')
    ap.add_argument('--dim', type=int, default=0,
                    help="model width (0: the recipe's own)")
    ap.add_argument('--nodes', type=int, default=0,
                    help='nodes of the batch (0: 1024, 32 with --smoke)')
    ap.add_argument('--kinds', nargs='+', default=list(KINDS_DEFAULT))
    ap.add_argument('--max-candidates', type=int, default=0,
                    help='per target; 0 = all admissible')
    ap.add_argument('--max-targets', type=int, default=0,
                    help='tune only the first N targets; 0 = all')
    ap.add_argument('--conv-backend', default='dense',
                    help="the convs' backend ('dense' | 'so2'); 'so2' makes "
                         "the banded contraction's chunk count a target")
    ap.add_argument('--fuse-pairwise', action='store_true',
                    help='the streaming attention (with shared radial '
                         "trunks): its backward's 'flash_stream' pick")
    ap.add_argument('--pallas-attention', action='store_true',
                    help='the fused attention kernels #5 and #6')
    ap.add_argument('--attention-mode', default='knn',
                    choices=('knn', 'global'),
                    help="'global': the kNN-free step, its "
                         "'flash_global' pick")
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..observability.metrics import collect_run_meta
    from . import tuning

    run_id = f'tune-{uuid.uuid4().hex[:12]}'
    meta = collect_run_meta(extra=dict(
        tool='tune', mode='smoke' if args.smoke else 'full',
        dry_run=args.dry_run, margin=args.margin, pairs=args.pairs,
        steps=args.steps, cache_file=tuning.cache_file(),
        backend=torch.device(args.device).type))
    meta['run_id'] = run_id
    _emit(args, meta)

    state = _build_step(args)
    targets = _targets(state, set(args.kinds))
    if not targets:
        print('no tunable kernel pick resolved in this step',
              file=sys.stderr)
        return 1
    if args.max_targets > 0:
        targets = targets[:args.max_targets]
    device_kind = tuning.current_device_kind(args.device)

    def record(kind, shape, dtype, cand, incumbent, blocks, verdict,
               promoted=None, **extra):
        return dict(kind='tune', run_id=run_id, kernel=kind,
                    shape=list(shape), dtype=dtype, candidate=list(cand),
                    incumbent=list(incumbent), blocks=list(blocks),
                    verdict=verdict, promoted=verdict == 'promoted'
                    if promoted is None else promoted, **extra)

    promoted = {}     # (kernel, shape, dtype) -> blocks: the last winner
    failures = 0
    for tgt in targets:
        kind, shape, dtype = tgt['kernel'], tuple(tgt['shape']), tgt['dtype']
        incumbent = tuple(tgt['blocks'])
        cands = [c for c in tuning.admissible_candidates(kind, shape)
                 if c != incumbent]
        if args.max_candidates > 0:
            cands = cands[:args.max_candidates]
        print(f'target {kind}{shape} dtype={dtype}: incumbent {incumbent} '
              f'({tgt["source"]}), {len(cands)} candidates', file=sys.stderr)
        if args.dry_run:
            for cand in cands:
                _emit(args, record(kind, shape, dtype, cand, incumbent,
                                   incumbent, 'admitted', step_ms=None))
            continue
        tuning.clear_kernel_caches()
        _measure_window(state, 1)
        for cand in cands:
            try:
                with tuning.force(kind, cand, shape=shape, dtype=dtype):
                    _measure_window(state, 1)
            except Exception as e:  # noqa: BLE001 - a candidate that fails
                # is a record, not the end of the sweep
                _emit(args, record(kind, shape, dtype, cand, incumbent,
                                   incumbent, 'error', step_ms=None,
                                   error=f'{type(e).__name__}: {e}'[:300]))
                failures += 1
                continue
            pairs = []
            for _ in range(max(1, args.pairs)):
                r_inc = _measure_window(state, args.steps)
                with tuning.force(kind, cand, shape=shape, dtype=dtype):
                    r_cand = _measure_window(state, args.steps)
                pairs.append(dict(incumbent=r_inc, candidate=r_cand))
            inc_best = max(p['incumbent'] for p in pairs)
            cand_best = max(p['candidate'] for p in pairs)
            # the candidate must beat the incumbent by the margin in every
            # alternating pair
            wins = all(p['candidate'] > p['incumbent'] * (1.0 + args.margin)
                       for p in pairs)
            verdict = 'promoted' if wins else 'rejected'
            rec = record(kind, shape, dtype, cand, incumbent,
                         cand if wins else incumbent, verdict,
                         step_ms=state['num_nodes'] / cand_best * 1e3,
                         nodes_steps_per_sec=cand_best,
                         incumbent_nodes_steps_per_sec=inc_best,
                         pairs=pairs, margin=args.margin)
            if wins:
                tuning.promote(kind, shape, cand, dtype=dtype,
                               device_kind=device_kind, provenance=dict(
                                   benched_nodes_steps_per_sec=cand_best,
                                   incumbent_nodes_steps_per_sec=inc_best,
                                   incumbent_blocks=list(incumbent),
                                   pairs=pairs, steps_per_window=args.steps,
                                   margin=args.margin, label=state['label'],
                                   run_id=run_id))
                promoted[(kind, shape, dtype)] = tuple(cand)
                incumbent = tuple(cand)
                _measure_window(state, 1)
            _emit(args, rec)

    # prove adoption: a fresh step resolves every promoted entry from the
    # table
    if promoted:
        resolved = {(c['kernel'], tuple(c['shape']), c['dtype']):
                    (c['source'], tuple(c['blocks']))
                    for c in _resolved(state)}
        for (kind, shape, dtype), blocks in promoted.items():
            got = resolved.get((kind, shape, dtype))
            ok = got == ('cache', blocks)
            _emit(args, record(
                kind, shape, dtype, blocks, blocks, blocks,
                'consulted' if ok else 'error', promoted=ok, step_ms=None,
                error=None if ok else f'promoted entry not consulted '
                                      f'(resolved {got})'))
            failures += not ok
    print(f'tune: {len(targets)} targets, {len(promoted)} promoted, '
          f'{failures} failures; table at {tuning.cache_file()}',
          file=sys.stderr)
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
