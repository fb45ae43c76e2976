"""Summarize a torch.profiler Chrome trace: the top ops by device time. The
counterpart of the repository's scripts/trace_summary.py (which reads a
jax.profiler trace).

    python -m se3_transformer_torch.observability.trace_summary
        --trace DIR_OR_FILE [--top 30] [--raw] [--match FILTER]

`--trace` is a Chrome trace JSON written by `timing.profile_trace` (or
`prof.export_chrome_trace`), or the directory holding them (the newest is
read). The device events are the trace's kernel, memcpy and memset events
when it holds any (a capture on a card), else its CPU ops (a capture on
the CPU). Durations are exclusive: an event's time less that of the
events nested in it on its own track (tracing.exclusive_durations), so a
wrapping op and its children are not counted twice. Names are folded to
their family (a trailing '.123' dropped) unless --raw. Pure Python: it
touches no device.
"""
import argparse
import glob
import json
import os
import sys
from typing import List, Tuple

from .profiling import fold_name
from .tracing import exclusive_durations

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def find_trace_file(path: str) -> str:
    """The trace itself, or the newest `*.json` under a directory."""
    if os.path.isfile(path):
        return path
    files = glob.glob(os.path.join(path, '**', '*.json'), recursive=True)
    if not files:
        raise FileNotFoundError(f'no Chrome trace (*.json) under {path}')
    return max(files, key=os.path.getmtime)


def device_events(trace: dict) -> Tuple[List[dict], str]:
    """The complete ('X') events that stand for the device, and which
    selector chose them ('device' or 'cpu_ops')."""
    xs = [ev for ev in trace.get('traceEvents', [])
          if isinstance(ev, dict) and ev.get('ph') == 'X']
    dev = [ev for ev in xs if ev.get('cat') in DEVICE_CATS]
    if dev:
        return dev, 'device'
    return [ev for ev in xs if ev.get('cat') == 'cpu_op'], 'cpu_ops'


def time_by_op(events, raw: bool = False, match=None) -> List[tuple]:
    """(name, exclusive ms) per op family, largest first."""
    acc: dict = {}
    for ev, excl in exclusive_durations(events):
        name = str(ev.get('name'))
        if not raw:
            name = fold_name(name)
        if match and match not in name:
            continue
        acc[name] = acc.get(name, 0.0) + excl / 1e3
    return sorted(acc.items(), key=lambda kv: -kv[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description='top ops by exclusive device time of a Chrome trace')
    ap.add_argument('--trace', required=True)
    ap.add_argument('--top', type=int, default=30)
    ap.add_argument('--raw', action='store_true',
                    help='no folding of numeric name suffixes')
    ap.add_argument('--match', default=None)
    args = ap.parse_args(argv)

    path = find_trace_file(args.trace)
    with open(path) as f:
        trace = json.load(f)
    events, selector = device_events(trace)
    rows = time_by_op(events, raw=args.raw, match=args.match)
    total = sum(ms for _, ms in rows)
    print(f'# {path}')
    print(f'# {len(events)} events ({selector}); total exclusive time '
          f'{total:.3f} ms')
    for name, ms in rows[:args.top]:
        print(f'{ms:10.3f} ms  {100 * ms / (total or 1.0):5.1f}%  {name}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
