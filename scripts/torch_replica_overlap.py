"""Where the time of two flagship_fast replicas on one card goes: the host
share of a request, one at a time and two at a time.

Serves flagship_fast (dim 64, depth `chip_smoke.DEPTH`, seeded and
conditioned weights, as the smoke's serve_multi phase) at bucket 1024,
batch 1, and reads for every request the wall time of its dispatch, the
CPU time of the thread that issued its forward and that thread's
context switches, in four arrangements:

  one      one async ReplicaWorker behind a Router, one request at a time;
  threads  two async ReplicaWorkers behind one Router (each its own
           thread and CUDA stream), two requests at a time;
  proc     one process with its own engine, one request at a time, while
           a second process waits;
  procs    two such processes at once, each one request at a time.

Run from the root of a checkout, on a machine with a card:

    python scripts/torch_replica_overlap.py [--reps 10] [--out FILE]

`--cpu` runs it on the CPU at a toy size (dim 16, depth 1, bucket 64), to
check the script itself. One JSON line per arrangement on stdout, and in
FILE.
"""
import argparse
import json
import multiprocessing as mp
import os
import resource
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(cpu: bool):
    """(engine factory, one request) at the script's size."""
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import se3_transformer_torch as st
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    dim, depth, n = (16, 1, 64) if cpu else (64, cs.DEPTH, 1024)
    if not cpu:
        from se3_transformer_torch.kernels import build
        build.load_library()
    host = cs.condition_weights(st.flagship_fast(
        dim=dim, depth=depth, device='cpu',
        generator=torch.Generator().manual_seed(0)))
    rng = np.random.RandomState(0)
    request = (rng.normal(size=(n, dim)).astype(np.float32),
               cs.chain_coords(rng, n))

    def engine():
        import copy
        return st.InferenceEngine(copy.deepcopy(host), buckets=(n,),
                                  batch_size=1,
                                  device='cpu' if cpu else 'cuda')
    return engine, request


class _Meter:
    """Wall, thread CPU time and context switches of the calling thread
    around one call."""

    def __init__(self):
        self.samples = []

    def wrap(self, fn):
        def run(*args, **kw):
            r0 = resource.getrusage(resource.RUSAGE_THREAD)
            c0, t0 = time.thread_time(), time.perf_counter()
            out = fn(*args, **kw)
            t1, c1 = time.perf_counter(), time.thread_time()
            r1 = resource.getrusage(resource.RUSAGE_THREAD)
            self.samples.append(dict(
                wall_ms=(t1 - t0) * 1e3, cpu_ms=(c1 - c0) * 1e3,
                voluntary_switches=r1.ru_nvcsw - r0.ru_nvcsw,
                involuntary_switches=r1.ru_nivcsw - r0.ru_nivcsw))
            return out
        return run


def _median(samples, key):
    return statistics.median(s[key] for s in samples)


def _summary(name, samples, rounds_ms, per_round, **extra):
    return dict(
        arrangement=name, requests=len(samples),
        round_ms=statistics.median(rounds_ms),
        requests_per_s=per_round * len(rounds_ms) / (sum(rounds_ms) / 1e3),
        dispatch_wall_ms=_median(samples, 'wall_ms'),
        thread_cpu_ms=_median(samples, 'cpu_ms'),
        cpu_share_of_wall=_median(samples, 'cpu_ms')
        / _median(samples, 'wall_ms'),
        voluntary_switches=_median(samples, 'voluntary_switches'),
        involuntary_switches=_median(samples, 'involuntary_switches'),
        **extra)


def _threads(make_engine, request, reps):
    """The `one` and `threads` arrangements, in this process."""
    from se3_transformer_torch.serving import ReplicaWorker, Router
    engines = [make_engine() for _ in range(2)]
    out = []
    for name, n in (('one', 1), ('threads', 2)):
        meter = _Meter()
        workers = [ReplicaWorker(i, engines[i], async_dispatch=True)
                   for i in range(n)]
        for w in workers:
            w.batcher.runner = meter.wrap(w.batcher.runner)
        rounds = []
        with Router(workers) as router:
            for k in range(reps + 2):
                t0 = time.perf_counter()
                for _ in range(n):
                    router.submit(*request)
                router.drain()
                if k >= 2:          # the first two rounds warm the streams
                    rounds.append((time.perf_counter() - t0) * 1e3)
        out.append(_summary(name, meter.samples[2 * n:], rounds, n))
    return out


def _proc_worker(rank, cpu, reps, barrier, queue):
    """One process, one engine: `reps` requests alone (rank 0 only, the
    other waiting), then `reps` at once with the other process."""
    make_engine, request = _setup(cpu)
    engine = make_engine()
    meter = _Meter()
    predict = meter.wrap(engine.predict)
    for _ in range(2):
        predict(*request)
    meter.samples.clear()
    result = {}
    for phase, busy in (('proc', rank == 0), ('procs', True)):
        barrier.wait()
        t0 = time.perf_counter()
        if busy:
            for _ in range(reps):
                predict(*request)
        result[phase] = dict(start=t0, end=time.perf_counter(),
                             samples=list(meter.samples))
        meter.samples.clear()
    queue.put((rank, result))


def _procs(cpu, reps):
    """The `proc` and `procs` arrangements: two spawned processes."""
    ctx = mp.get_context('spawn')
    barrier, queue = ctx.Barrier(2), ctx.Queue()
    procs = [ctx.Process(target=_proc_worker,
                         args=(r, cpu, reps, barrier, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=900) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    alone = results[0]['proc']
    wall = (alone['end'] - alone['start']) * 1e3
    out = [_summary('proc', alone['samples'], [wall / reps] * reps, 1)]
    both = [results[r]['procs'] for r in (0, 1)]
    wall = (max(b['end'] for b in both) - min(b['start'] for b in both)) * 1e3
    out.append(_summary('procs', both[0]['samples'] + both[1]['samples'],
                        [wall / reps] * reps, 2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--out', default=None)
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args(argv)
    card = 'cpu'
    if not args.cpu:
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True,
            text=True).stdout.strip()
    make_engine, request = _setup(args.cpu)
    lines = _threads(make_engine, request, args.reps)
    lines += _procs(args.cpu, args.reps)
    one = lines[0]['requests_per_s']
    with open(args.out, 'w') if args.out else open(os.devnull, 'w') as f:
        for line in lines:
            line.update(card=card, bucket=len(request[0]),
                        throughput_vs_one=line['requests_per_s'] / one)
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
