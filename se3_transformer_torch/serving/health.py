"""Per-replica health for the router: the port of
se3_transformer_tpu/serving/health.py (a state machine and circuit breaker
per replica).

A replica whose runner raises must not keep receiving least-outstanding
traffic: "fewest unanswered requests" describes a replica that fails
every batch as well as an idle healthy one. This module gives the router
that signal:

  * `ReplicaHealth`: one replica's state machine, driven by per-dispatch
    outcomes (`record_success` / `record_failure`, from the batcher's
    dispatch hooks):

        healthy --failure x degrade_after--> degraded
        degraded --failure x quarantine_after--> quarantined
        degraded --success x recover_after--> healthy
        quarantined --half-open probe success--> degraded

    Quarantine is a circuit breaker: after an exponential backoff
    (`probe_backoff_s`, doubling up to `probe_backoff_max_s` on each
    failed probe) the replica becomes probe-eligible and the router sends
    exactly one request into it (half-open: `begin_probe` holds
    `probe_due` false until the outcome lands). A probe success closes the
    breaker back to degraded and resets the backoff; normal traffic then
    walks it to healthy. Recovery comes from probe traffic, not a restart.

  * `HealthMonitor`: the fleet view the `Router` consults. It is
    thread-safe (outcomes arrive from the replicas' dispatch threads),
    keeps a merged transition log (the `fault` record's
    `health_transitions`) and the `recoveries` count (the chaos harness
    gates on at least one quarantine -> recovery).

The member ids are opaque ints (replica ids here; the cross-host tier of
ROADMAP A8.2 drives a second monitor with host ids). Concurrent callers
claim probes through `try_begin_probe` (the check and the begin under one
lock): a separate probe_due() / begin_probe() pair could book the
half-open slot twice. Clocks are injectable.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

HEALTHY = 'healthy'
DEGRADED = 'degraded'
QUARANTINED = 'quarantined'
HEALTH_STATES = (HEALTHY, DEGRADED, QUARANTINED)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the per-replica breaker.

    degrade_after      consecutive failures before healthy -> degraded
    quarantine_after   consecutive failures before -> quarantined
    recover_after      consecutive successes before degraded -> healthy
    probe_backoff_s    first half-open probe delay after quarantine
    probe_backoff_max_s  backoff ceiling (doubles per failed probe)
    backoff_factor     multiplier applied per failed probe
    probe_timeout_s    a probe whose outcome never lands (the request
                       was deadline-shed before its batch ran — neither
                       a success nor a failure of the replica) is
                       ABANDONED after this long and the breaker
                       re-arms; without it, one shed probe would pin
                       probe_inflight forever and quarantine the
                       replica permanently
    """
    degrade_after: int = 1
    quarantine_after: int = 3
    recover_after: int = 2
    probe_backoff_s: float = 0.25
    probe_backoff_max_s: float = 30.0
    backoff_factor: float = 2.0
    probe_timeout_s: float = 60.0

    def __post_init__(self):
        assert self.degrade_after >= 1
        assert self.quarantine_after >= self.degrade_after
        assert self.recover_after >= 1
        assert self.probe_backoff_s > 0 and self.backoff_factor >= 1.0
        assert self.probe_timeout_s > 0


class ReplicaHealth:
    """One replica's breaker state; mutate only via the monitor (which
    holds the lock — outcomes arrive from executor threads)."""

    def __init__(self, replica_id: int, config: HealthConfig,
                 clock: Callable[[], float]):
        self.id = int(replica_id)
        self.config = config
        self.clock = clock
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.consecutive_successes = 0
        self.failures_total = 0
        self.successes_total = 0
        self.probes = 0
        self.probe_inflight = False
        self.probe_started_at: Optional[float] = None
        self._backoff = config.probe_backoff_s
        self.next_probe_at: Optional[float] = None
        self.transitions: List[dict] = []
        self.last_error: Optional[str] = None

    # ------------------------------------------------------------------ #
    def _transition(self, to: str, reason: str):
        if to == self.state:
            return
        self.transitions.append(dict(
            replica=self.id, t=round(self.clock(), 4),
            from_state=self.state, to_state=to, reason=reason))
        self.state = to

    def record_success(self):
        self.successes_total += 1
        self.consecutive_failures = 0
        self.consecutive_successes += 1
        if self.probe_inflight:
            # half-open probe answered: close the breaker back to
            # degraded (NOT straight to healthy — one good batch after a
            # quarantine is evidence of life, not of health) and reset
            # the backoff for any future quarantine
            self.probe_inflight = False
            self._backoff = self.config.probe_backoff_s
            self.next_probe_at = None
            self._transition(DEGRADED, 'probe_success')
            self.consecutive_successes = 1
        if self.state == DEGRADED and \
                self.consecutive_successes >= self.config.recover_after:
            self._transition(HEALTHY, 'recovered')

    def record_failure(self, error: Optional[BaseException] = None):
        self.failures_total += 1
        self.consecutive_successes = 0
        self.consecutive_failures += 1
        if error is not None:
            self.last_error = f'{type(error).__name__}: {error}'
        now = self.clock()
        if self.probe_inflight:
            # failed probe: stay quarantined, back off exponentially
            self.probe_inflight = False
            self._backoff = min(self._backoff * self.config.backoff_factor,
                                self.config.probe_backoff_max_s)
            self.next_probe_at = now + self._backoff
            return
        if self.state != QUARANTINED and \
                self.consecutive_failures >= self.config.quarantine_after:
            self._transition(QUARANTINED, 'failures')
            self.next_probe_at = now + self._backoff
        elif self.state == HEALTHY and \
                self.consecutive_failures >= self.config.degrade_after:
            self._transition(DEGRADED, 'failures')

    def probe_due(self, now: float) -> bool:
        if self.probe_inflight and self.probe_started_at is not None \
                and now - self.probe_started_at \
                >= self.config.probe_timeout_s:
            # the probe's outcome never landed — its request was
            # deadline-shed before the batch ran, which judges the
            # REQUEST, not the replica. Abandon it and re-arm, or this
            # breaker would stay half-open (and the replica
            # quarantined) forever.
            self.probe_inflight = False
            self.next_probe_at = now
        return (self.state == QUARANTINED and not self.probe_inflight
                and self.next_probe_at is not None
                and now >= self.next_probe_at)

    def begin_probe(self, now: Optional[float] = None):
        """Half-open: exactly one request in flight until its outcome
        (or the probe_timeout_s abandonment above)."""
        self.probes += 1
        self.probe_inflight = True
        self.probe_started_at = self.clock() if now is None else now

    def snapshot(self) -> dict:
        return dict(state=self.state,
                    consecutive_failures=self.consecutive_failures,
                    failures=self.failures_total,
                    successes=self.successes_total,
                    probes=self.probes,
                    probe_inflight=self.probe_inflight,
                    transitions=len(self.transitions),
                    last_error=self.last_error)


class HealthMonitor:
    """The fleet's health surface: per-replica breakers behind one lock.

        monitor = HealthMonitor([0, 1, 2], config, clock=clock)
        monitor.record_failure(0, err)      # from a dispatch hook
        monitor.state(0)                    # 'degraded'
        monitor.probe_due(0, now)           # breaker half-open?
        monitor.snapshot()                  # serve-record health section
    """

    def __init__(self, replica_ids, config: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config if config is not None else HealthConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._replicas: Dict[int, ReplicaHealth] = {
            int(r): ReplicaHealth(r, self.config, clock)
            for r in replica_ids}

    def __getitem__(self, replica_id: int) -> ReplicaHealth:
        return self._replicas[int(replica_id)]

    def record_success(self, replica_id: int):
        with self._lock:
            self._replicas[int(replica_id)].record_success()

    def record_failure(self, replica_id: int,
                       error: Optional[BaseException] = None):
        with self._lock:
            self._replicas[int(replica_id)].record_failure(error)

    def state(self, replica_id: int) -> str:
        with self._lock:
            return self._replicas[int(replica_id)].state

    def probe_due(self, replica_id: int, now: float) -> bool:
        with self._lock:
            return self._replicas[int(replica_id)].probe_due(now)

    def begin_probe(self, replica_id: int):
        with self._lock:
            self._replicas[int(replica_id)].begin_probe()

    def try_begin_probe(self, replica_id: int,
                        now: Optional[float] = None) -> bool:
        """Atomically claim the half-open probe slot: probe_due check
        AND begin_probe under one lock acquisition, so N concurrent
        callers (the replicas' async dispatch hooks)
        can never double-book a probe — at most one returns True per
        breaker opening. Prefer this over the probe_due()/begin_probe()
        pair whenever more than one thread routes."""
        with self._lock:
            r = self._replicas[int(replica_id)]
            now = self.clock() if now is None else now
            if not r.probe_due(now):
                return False
            r.begin_probe(now)
            return True

    @property
    def transitions(self) -> List[dict]:
        """Merged, time-ordered transition log across the fleet."""
        with self._lock:
            events = [e for r in self._replicas.values()
                      for e in r.transitions]
        return sorted(events, key=lambda e: (e['t'], e['replica']))

    @property
    def recoveries(self) -> int:
        """Quarantine -> live transitions (the chaos harness gates on it)."""
        return sum(1 for e in self.transitions
                   if e['from_state'] == QUARANTINED)

    def snapshot(self) -> dict:
        """Per-replica health section of the serve/fault records."""
        with self._lock:
            return {str(rid): r.snapshot()
                    for rid, r in sorted(self._replicas.items())}
