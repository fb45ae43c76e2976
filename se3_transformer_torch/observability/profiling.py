"""Per-scope device-time profiling: a torch.profiler session -> the
schema'd `profile` record. The port of
se3_transformer_tpu/observability/profiling.py.

  1. `capture_step_profile` runs a warm callable `steps` times under
     torch.profiler (CPU activity, and CUDA activity on a card), ended by a
     device synchronize.
  2. The device events are the profile's device-side events (kernels,
     copies, sets) and nothing else: a CPU op that launches a kernel from a
     ctypes call (the pairwise custom ops) is charged that kernel's time
     as its own device time, so counting CPU ops would count it twice. A
     capture that asked for CUDA activity and holds no device event is an
     error, never read as CPU time. Only a capture made on the CPU takes
     its CPU ops as the device, each at its self time (its children's
     time taken out), as JAX's CPU traces take the XLA:CPU thunks. Device
     durations are made exclusive per track (device, stream) before any
     sum.
  3. Each device event is attributed to the innermost MODEL_SCOPES label
     on the record_function ancestry of the CPU op that launched it (by
     its linked correlation id where the profiler keeps one, else by the
     launching op's list of kernels). Backward ops run on autograd's own
     thread, outside any forward scope: the ancestry walk stops at their
     `autograd::engine::evaluate_function` op, whose sequence number and
     forward thread name the forward op that made the autograd node, and
     takes that op's scope. A checkpoint's recompute re-enters the
     forward code and so its scopes.
  4. `profile_payload` writes the record body: per-scope {time_ms,
     share}, total device time, the attributed share (`coverage`), the
     top unattributed ops (a coverage miss is diagnosable from the record
     alone), and, given the program's FLOPs, a roofline against the
     card's bf16 peak (utils.flops.peaks_for, found by device name; none
     for the CPU or a card that table does not know).
"""
from __future__ import annotations

import os
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .timing import MODEL_SCOPES

__all__ = [
    'StepProfile', 'capture_step_profile', 'device_events',
    'exclusive_durations', 'fold_name', 'attribute_scopes',
    'device_time_by_op', 'kernels_ms', 'profile_payload',
]

_BACKWARD = 'autograd::engine::evaluate_function'


class StepProfile:
    """One captured profile: the profiler's FunctionEvents, how many calls
    it covers, their wall time (ms, the synchronize included) and whether
    the capture asked for CUDA activity."""

    def __init__(self, prof, steps: int, wall_ms: float, cuda: bool):
        self.prof = prof
        self.events = list(prof.events())
        self.steps = steps
        self.wall_ms = wall_ms
        self.cuda = cuda
        self._pairs = None

    def pairs(self) -> List[Tuple[object, float]]:
        """(device event, exclusive microseconds), computed once."""
        if self._pairs is None:
            self._pairs = exclusive_durations(*device_events(self)[:2])
        return self._pairs


def capture_step_profile(fn, args=(), *, steps: int = 1,
                         log_dir: Optional[str] = None, device=None
                         ) -> StepProfile:
    """Run `fn(*args)` `steps` times under torch.profiler (the callable
    must be warm: a first call's one-time work would swamp the
    attribution) and synchronize the card. With `log_dir` the Chrome
    trace is written there too."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available() if device is None else \
        torch.device(device).type == 'cuda'
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(*args)
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f'trace_{os.getpid()}_{time.time_ns()}.json'))
    return StepProfile(prof, steps, wall_ms, cuda)


def _is_cpu(ev) -> bool:
    from torch.autograd import DeviceType
    return ev.device_type == DeviceType.CPU


def device_events(profile: StepProfile) -> Tuple[list, str, dict]:
    """(events, selector, info): for a capture with CUDA activity, the
    device-side events (kernels, copies, sets; not the record_function
    ranges mirrored onto the device's timeline), selector 'device'; it
    raises when there are none (CUPTI gave nothing). For a capture on the
    CPU, the CPU ops (selector 'cpu_ops': neither record_function labels
    nor the async runtime events). info names the tracks."""
    if profile.cuda:
        dev = [e for e in profile.events if not _is_cpu(e)
               and not getattr(e, 'is_user_annotation', False)]
        if not dev:
            raise RuntimeError('the profile asked for CUDA activity and '
                               'holds no device event')
        tracks = sorted({f'device {e.device_index} stream '
                         f'{getattr(e, "device_resource_id", 0)}'
                         for e in dev})
        return dev, 'device', dict(selector='device', tracks=tracks)
    ops = [e for e in profile.events
           if not e.is_async and not getattr(e, 'is_user_annotation', False)]
    tracks = sorted({f'thread {e.thread}' for e in ops})
    return ops, 'cpu_ops', dict(selector='cpu_ops', tracks=tracks)


def exclusive_durations(events, selector: str) -> List[Tuple[object, float]]:
    """(event, exclusive us) pairs. CPU ops: their self time. Device
    events: each duration less the time of the events nested in it on the
    same track (device, stream), so that nothing is counted twice."""
    if selector == 'cpu_ops':
        return [(e, float(e.self_cpu_time_total)) for e in events]
    out = []
    by_track: Dict[tuple, list] = {}
    for e in events:
        by_track.setdefault((e.device_index,
                             getattr(e, 'device_resource_id', 0)),
                            []).append(e)
    for evs in by_track.values():
        # parents first on ties: the longer event takes the outer slot
        evs.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
        stack: list = []     # [end_us, child_us, event]
        for e in evs:
            start, end = e.time_range.start, e.time_range.end
            while stack and start >= stack[-1][0] - 1e-9:
                top = stack.pop()
                out.append((top[2], top[2].time_range.elapsed_us() - top[1]))
            if stack:
                stack[-1][1] += end - start
            stack.append([end, 0.0, e])
        while stack:
            top = stack.pop()
            out.append((top[2], top[2].time_range.elapsed_us() - top[1]))
    return out


def fold_name(name: str) -> str:
    """An op or kernel name folded to its family: a trailing '.123'
    dropped, at most 90 characters."""
    return re.sub(r'(\.\d+)+$', '', name)[:90]


class _Scopes:
    """The scope of a CPU op: the innermost label of `scopes` on its
    ancestry; past an autograd evaluate_function op, the scope of the
    forward op that made its node (same sequence number on the forward
    thread)."""

    def __init__(self, events, scopes: Sequence[str]):
        self.scopes = set(scopes)
        self.memo: Dict[int, Optional[str]] = {}
        self.forward: Dict[Tuple[int, int], str] = {}
        for e in events:
            if _is_cpu(e) and e.sequence_nr >= 0 and \
                    not e.name.startswith(_BACKWARD):
                key = (e.thread, e.sequence_nr)
                if key not in self.forward:
                    scope = self._walk(e, backward=False)
                    if scope is not None:
                        self.forward[key] = scope

    def _walk(self, e, backward: bool = True) -> Optional[str]:
        while e is not None:
            if e.name in self.scopes:
                return e.name
            if backward and e.name.startswith(_BACKWARD) and \
                    e.sequence_nr >= 0:
                scope = self.forward.get((e.fwd_thread, e.sequence_nr))
                if scope is not None:
                    return scope
            e = e.cpu_parent
        return None

    def __call__(self, e) -> Optional[str]:
        key = id(e)
        if key not in self.memo:
            self.memo[key] = self._walk(e)
        return self.memo[key]


def _launchers(profile: StepProfile, events) -> Dict[int, object]:
    """id(device event) -> the CPU op that launched it: by the device
    event's linked correlation id (the launching op's id) where the
    profiler keeps it, else by matching the event against the launching
    ops' kernel lists (name, device, duration)."""
    ops = [e for e in profile.events if _is_cpu(e) and not e.is_async]
    by_id = {e.id: e for e in ops
             if not getattr(e, 'linked_correlation_id', 0)}
    out = {}
    for e in events:
        op = by_id.get(getattr(e, 'linked_correlation_id', 0) or None)
        if op is not None:
            out[id(e)] = op
    if out:
        return out
    listed: Dict[tuple, list] = {}
    for op in ops:
        for k in getattr(op, 'kernels', ()):
            listed.setdefault((k.name, k.device, k.duration), []).append(op)
    for e in sorted(events, key=lambda e: e.time_range.start):
        queue = listed.get((e.name, e.device_index,
                            e.time_range.end - e.time_range.start))
        if queue:
            out[id(e)] = queue.pop(0)
    return out


def attribute_scopes(profile: StepProfile,
                     scopes: Sequence[str] = MODEL_SCOPES) -> dict:
    """Fold a profile's device time onto scope labels: {scope_us: {scope:
    us}, total_us, attributed_us, unattributed: [(folded name, us)
    hottest first]}."""
    events, selector, _ = device_events(profile)
    scope_of = _Scopes(profile.events, scopes)
    launcher = _launchers(profile, events) if selector == 'device' else {}
    scope_us: Dict[str, float] = {}
    unattr: Dict[str, float] = {}
    total = attributed = 0.0
    for e, us in profile.pairs():
        if us <= 0:
            continue
        total += us
        anchor = e if selector == 'cpu_ops' else launcher.get(id(e))
        scope = None if anchor is None else scope_of(anchor)
        if scope is not None:
            scope_us[scope] = scope_us.get(scope, 0.0) + us
            attributed += us
        else:
            key = fold_name(e.name)
            unattr[key] = unattr.get(key, 0.0) + us
    return dict(scope_us=scope_us, total_us=total, attributed_us=attributed,
                unattributed=sorted(unattr.items(), key=lambda kv: -kv[1]))


def device_time_by_op(profile: StepProfile) -> List[Tuple[str, int, float]]:
    """(name, calls, exclusive device ms) per device op name, hottest
    first."""
    agg: Dict[str, list] = {}
    for e, us in profile.pairs():
        if us <= 0:
            continue
        row = agg.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += us / 1e3
    return sorted(((k, n, ms) for k, (n, ms) in agg.items()),
                  key=lambda r: -r[2])


def kernels_ms(profile: StepProfile, names: Sequence[str]) -> float:
    """Device ms of the ops whose names hold one of `names`."""
    return sum(us for e, us in profile.pairs()
               if us > 0 and any(n in e.name for n in names)) / 1e3


def profile_payload(profile: StepProfile, *, label: str,
                    scopes: Sequence[str] = MODEL_SCOPES,
                    flops_per_step: Optional[float] = None,
                    device_name: Optional[str] = None,
                    top_unattributed: int = 8) -> dict:
    """The schema'd `profile` record body (kind='profile', minus run_id):
    per-scope device time and share, the device time, the attributed
    share, the top unattributed ops, the calls covered (`steps`) and their
    wall time; with `flops_per_step`, the roofline against the bf16 peak
    of the card named `device_name` (the current card's name when None),
    left out for the CPU and for a card utils.flops.PEAKS does not
    know."""
    att = attribute_scopes(profile, scopes)
    total_us = att['total_us']
    body = dict(
        label=label,
        scopes={scope: dict(time_ms=round(us / 1e3, 3),
                            share=round(us / total_us, 4))
                for scope, us in sorted(att['scope_us'].items(),
                                        key=lambda kv: -kv[1])},
        device_time_ms=round(total_us / 1e3, 3),
        coverage=round(att['attributed_us'] / total_us, 4)
        if total_us else 0.0,
        steps=profile.steps,
        wall_ms=round(profile.wall_ms, 3),
        tracks=device_events(profile)[2],
        unattributed_top=[dict(op=op, time_ms=round(us / 1e3, 3))
                          for op, us in att['unattributed']
                          [:top_unattributed]])
    if device_name is None:
        device_name = torch.cuda.get_device_name() \
            if profile.cuda else 'cpu'
    from ..utils.flops import peaks_for
    peaks_of, (bf16_peak, _, _) = peaks_for(device_name)
    if flops_per_step and total_us and device_name != 'cpu' and \
            not peaks_of.endswith('(assumed)'):
        rate = flops_per_step * profile.steps / (total_us / 1e6)
        body['roofline'] = dict(
            flops_per_step=flops_per_step,
            device_flops_per_sec=round(rate, 1),
            utilization_vs_bf16_peak=round(rate / bf16_peak, 6),
            bf16_peak_flops_per_sec=bf16_peak, device_kind=device_name,
            peaks_of=peaks_of)
    return body
