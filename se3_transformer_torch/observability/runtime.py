"""The one-time-work watchdog and device memory snapshots: the port of
se3_transformer_tpu/observability/runtime.py.

JAX's watchdog counts XLA compile events: after an AOT engine's warmup,
any compile is a request paying seconds of latency. The port runs
eagerly and compiles nothing per request, but a request can still set off
one-time host work, and that work is its latency cliff:

  * the build or load of the kernels' library (kernels/build.py, at its
    first use);
  * a miss in a cache of device constants (utils.helpers.device_constant:
    basis._qj_tensor, the constants of kernels/flash.py, so2's canonical
    blocks and J tables), each a blocking pageable host-to-device copy.

`RetraceWatchdog` reads their process-wide count (`ONE_TIME_WORK`) at
every check as `compile_events`: the first check arms it, and each later
check whose delta is above 0 warns once with a `RetraceWarning`. An
engine warmed on real shapes sets all of it off before it serves, so a
stream over its buckets adds 0.

`device_memory_stats` reads the caching allocator of a card (bytes in use
and the peak); the CPU gives None, as JAX's schema allows.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from ..utils.helpers import ONE_TIME_WORK


class RetraceWarning(UserWarning):
    """One-time host work ran after warmup."""


def device_memory_stats(device=None) -> Optional[dict]:
    """{bytes_in_use, peak_bytes_in_use} of a CUDA `device` (the current
    card when None and one is present), or None on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    device = torch.device(device)
    if device.type != 'cuda':
        return None
    return dict(bytes_in_use=int(torch.cuda.memory_allocated(device)),
                peak_bytes_in_use=int(torch.cuda.max_memory_allocated(
                    device)))


class RetraceWatchdog:
    """Counts one-time host work across checks.

        wd = RetraceWatchdog(device=engine.device)
        ... warmup ...
        wd.check()   # the first check arms (baselines the count)
        ... serve ...
        snap = wd.check()   # work after warmup -> RetraceWarning and
                            # snap['compile_events_delta'] > 0

    Each check re-baselines, so a burst of work warns once.
    """

    def __init__(self, device=None):
        self.device = device
        self._armed = False
        self._seen = ONE_TIME_WORK[0]
        self.warnings_total = 0

    def arm(self):
        """Baseline the count; work after this warns."""
        self._armed = True
        self._seen = ONE_TIME_WORK[0]

    def check(self) -> dict:
        """Snapshot for the flush record. The first call arms; later calls
        warn when one-time work ran since the previous check."""
        events = ONE_TIME_WORK[0]
        snap = dict(compile_events=events,
                    compile_events_delta=events - self._seen,
                    retraced=[],
                    warnings_total=self.warnings_total,
                    memory=device_memory_stats(self.device))
        self._seen = events
        if not self._armed:
            self.arm()
            snap['armed'] = True
            return snap
        if snap['compile_events_delta'] > 0:
            snap['retraced'].append(dict(
                work='device constants / kernel library',
                events=snap['compile_events_delta']))
            self.warnings_total += 1
            snap['warnings_total'] = self.warnings_total
            warnings.warn(
                f'{snap["compile_events_delta"]} one-time host work '
                f'event(s) after warmup (a device-constant build or the '
                f'kernel library load): a request paid for them',
                RetraceWarning, stacklevel=2)
        return snap
