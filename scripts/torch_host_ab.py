"""Host-bound paths of the PyTorch port: two trees, one card, one call.

Times, through the public API, the request and step medians of the paths
whose time is mostly host work: flagship_fast served at bucket 1024 and
trained (n 1024), af2_refinement served and trained, and the
DenoiseConfig trainer's step (16 micro-batches of 96 nodes). Run from the
root of a checkout, on a machine with a card:

    python scripts/torch_host_ab.py --parent DIR [--out FILE]

DIR is another checkout (say the parent commit, unpacked with
`git archive`). The kernels are built once here and the library is copied
into DIR (a tree whose kernel sources differ builds its own). The trees
then run in the order parent, change, change, parent, each in a process
of its own, so that a drift of the host shows as a spread within each
tree. One JSON line per path and run, on stdout and in FILE.
"""
import argparse
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import time


def _worker(root: str, label: str) -> None:
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import se3_transformer_torch as st
    from se3_transformer_torch.kernels import build
    build.load_library()
    import chip_smoke as cs

    def out(**kw):
        print(json.dumps(dict(tree=label, **kw)), flush=True)

    def timed(fn, reps):
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return dict(median_ms=statistics.median(ms), ms=ms)

    def serve(recipe, dim, depth, bonds, n=1024):
        rng = np.random.RandomState(0)
        model = cs.condition_weights(getattr(st, recipe)(
            dim=dim, depth=depth, generator=torch.Generator().manual_seed(0)))
        engine = st.InferenceEngine(model, buckets=(1024,))
        req = (rng.normal(size=(n, dim)).astype(np.float32),
               cs.chain_coords(rng, n, bonds))
        engine.predict(*req)
        engine.predict(*req)
        out(path=f'{recipe} serve', **timed(lambda: engine.predict(*req), 9))

    def train(recipe, dim, depth, reps, n=1024):
        model = cs.condition_weights(getattr(st, recipe)(
            dim=dim, depth=depth, output_degrees=2, reduce_dim_out=True,
            generator=torch.Generator().manual_seed(0)))
        trainer = st.DenoiseTrainer(model, lr=1e-4)
        batch = trainer.to_device(st.flagship_batch(
            np.random.RandomState(0), 1, n, dim))
        noise = torch.randn(batch['coords'].shape, device='cuda',
                            generator=torch.Generator('cuda').manual_seed(0))

        def step():
            float(trainer.train_step(batch, noise=noise))
        step()
        step()
        out(path=f'{recipe} train', **timed(step, reps))

    def denoise():
        trainer = st.DenoiseTrainer(st.DenoiseConfig(accum_steps=16))
        batch = trainer.micro_batches()

        def step():
            float(trainer.train_step(batch))
        step()
        out(path='DenoiseConfig train', **timed(step, 5))

    serve('flagship_fast', 64, cs.DEPTH, (3.8,))
    serve('af2_refinement', cs.AF2_DIM, 2, cs.BACKBONE_BONDS)
    train('af2_refinement', cs.AF2_DIM, 2, 7)
    denoise()
    train('flagship_fast', 64, cs.DEPTH, 5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', required=True)
    ap.add_argument('--out', default=None)
    ap.add_argument('--worker', nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        _worker(*args.worker)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parent = os.path.abspath(args.parent)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [json.dumps(dict(card=smi))]
    print(lines[0], flush=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, '-c', 'from se3_transformer_torch.'
                    'kernels import build; build.load_library()'],
                   cwd=here, check=True, stdout=subprocess.DEVNULL)
    lines.append(json.dumps(dict(build_s=time.perf_counter() - t0)))
    dest = os.path.join(parent, 'se3_transformer_torch', 'kernels', 'build')
    os.makedirs(dest, exist_ok=True)
    for lib in glob.glob(os.path.join(here, 'se3_transformer_torch',
                                      'kernels', 'build', '*.so')):
        shutil.copy(lib, dest)
    for label, root in (('parent', parent), ('change', here),
                        ('change', here), ('parent', parent)):
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--parent', parent,
             '--worker', root, label], capture_output=True, text=True)
        got = [line for line in run.stdout.splitlines()
               if line.startswith('{"tree"')]
        for line in got:
            print(line, flush=True)
        lines += got
        if run.returncode != 0:
            sys.stderr.write(run.stderr[-4000:])
            return run.returncode
    if args.out:
        with open(args.out, 'w') as f:
            f.write('\n'.join(lines) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
