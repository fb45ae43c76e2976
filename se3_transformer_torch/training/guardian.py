"""Preemption handling: the port of se3_transformer_tpu/training/guardian.py's
`PreemptionGuard`.

SIGTERM and SIGINT become a flag that a step or serve loop polls, and the
previous handlers come back on exit. The rest of JAX's guardian (NaN and
spike rollback, emergency saves, per-step replay) is ROADMAP A2.5.
"""
from __future__ import annotations

import signal
from typing import Optional


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
