"""Deterministic fault injection: the port of se3_transformer_tpu/faults.py
(pure Python, so the port keeps its own copy; the same plans fire on the
same calls as JAX's injector).

`FaultInjector` is a seeded, plan-driven injector. The port wires it into
these sites:

  * `engine_run`: `InferenceEngine(fault_injector=...)` fires it at the
    top of `run()` (ctx: bucket);
  * `checkpoint_write` / `checkpoint_written`: `CheckpointManager(
    fault_injector=...)` fires before and after the durable write (ctx:
    step, and path on the post-write site, where a `corrupt` plan tears
    the entry just written: the preemption-mid-write case that
    `restore`'s fallback exists for);
  * the training sites (training.guardian, training.pipeline):
    `step_dispatch` fires before every guarded optimizer step (ctx: step;
    an exception plan walks the rollback path a real device fault walks),
    `step_batch` fires at batch build (a `nan` plan poisons that step's
    coordinates, so a real non-finite loss flows through the step),
    `batch_source` fires before every producer-thread pull
    (`BatchProducer(fault_injector=...)`: exception plans exercise the
    retry and skip path), and `emergency_save` fires on the preemption
    handler's save path (a dying emergency writer must still exit
    resumable);
  * `replica_dispatch`: `serving.ReplicaWorker(fault_injector=...)` fires
    it before every engine run of a replica's batch (ctx: replica,
    bucket): an exception plan walks the path a real replica failure
    walks (the router's health breaker, retry and redispatch).

JAX's cross-host fleet fires `transport` too; that comes with ROADMAP A8.2,
and a plan on any site name is accepted.

Fault kinds:

  * `exception`: raise `InjectedFault` (it walks the path a real failure
    walks);
  * `latency`: sleep `latency_s`;
  * `corrupt`: truncate the file (or every file under the directory)
    named by ctx['path'] to `frac` of its bytes: a torn checkpoint;
  * `nan`: cooperative: record the firing and return 'nan' from `fire()`;
    the call site poisons its own data;
  * `drop`: cooperative: record the firing and return 'drop'; the call
    site discards its own message.

`fire()` returns the kind that acted ('exception' never returns: it
raises) or None when no plan triggered; only the cooperative kinds need
the caller to look at it.

Plans are deterministic: each plan counts the fires that match its site
and ctx filters and triggers on explicit call indices (`at=(3, 4)`), a
period (`every=5`), or a seeded coin (`p=0.1`, from the injector's
private `random.Random(seed)`: same seed, same faults). Every firing is
appended to `injector.injected` (JSON-safe).

    inj = FaultInjector(seed=0)
    inj.plan('step_batch', 'nan', at=(3,))          # poison build 3
    inj.plan('engine_run', 'latency', every=7, latency_s=0.05)
    inj.plan('checkpoint_written', 'corrupt', at=(2,))   # tear ckpt 2
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, List, Optional, Sequence

__all__ = ['FAULT_KINDS', 'FaultInjector', 'InjectedFault', 'corrupt_path']

FAULT_KINDS = ('exception', 'latency', 'corrupt', 'nan', 'drop')


class InjectedFault(RuntimeError):
    """A deliberately injected failure (site and plan in the message). A
    RuntimeError: consumers treat it as they treat a real one."""

    def __init__(self, site: str, message: str, **ctx):
        super().__init__(f'injected fault at {site}: {message}')
        self.site = site
        self.ctx = dict(ctx)


class _Plan:
    __slots__ = ('site', 'kind', 'at', 'every', 'p', 'match',
                 'latency_s', 'frac', 'max_fires', 'calls', 'fires')

    def __init__(self, site: str, kind: str, *,
                 at: Optional[Sequence[int]] = None,
                 every: Optional[int] = None,
                 p: Optional[float] = None,
                 match: Optional[dict] = None,
                 latency_s: float = 0.05,
                 frac: float = 0.5,
                 max_fires: Optional[int] = None):
        if kind not in FAULT_KINDS:
            raise ValueError(f'unknown fault kind {kind!r}')
        if sum(x is not None for x in (at, every, p)) != 1:
            raise ValueError('exactly one of at= / every= / p= selects '
                             'when a plan fires')
        self.site = site
        self.kind = kind
        self.at = tuple(int(i) for i in at) if at is not None else None
        self.every = int(every) if every is not None else None
        self.p = float(p) if p is not None else None
        self.match = dict(match or {})
        self.latency_s = float(latency_s)
        self.frac = float(frac)
        self.max_fires = max_fires
        self.calls = 0    # matching fire() calls seen (1-based index)
        self.fires = 0

    def wants(self, rng: random.Random) -> bool:
        """Called once per matching fire(); decides and counts."""
        self.calls += 1
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.at is not None:
            return self.calls in self.at
        if self.every is not None:
            return self.calls % self.every == 0
        return rng.random() < self.p


def _truncate(path: str, frac: float):
    size = os.path.getsize(path)
    with open(path, 'r+b') as f:
        f.truncate(max(0, int(size * frac)))


def corrupt_path(path: str, frac: float = 0.5) -> List[str]:
    """Tear a checkpoint on disk: truncate the file, or every regular file
    under a directory, to `frac` of its bytes. Returns the torn paths."""
    torn = []
    if os.path.isdir(path):
        for root, _, files in os.walk(path):
            for name in files:
                p = os.path.join(root, name)
                _truncate(p, frac)
                torn.append(p)
    else:
        _truncate(path, frac)
        torn.append(path)
    return torn


class FaultInjector:
    """Seeded, plan-driven fault injector (the module docstring has the
    contract). `fire(site, **ctx)` is the hook: a site with no plan costs
    a scan of the plan list, so the hooks stay wired in."""

    def __init__(self, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        self.rng = random.Random(seed)
        self.seed = int(seed)
        self.sleep = sleep
        self._plans: List[_Plan] = []
        self.injected: List[dict] = []   # JSON-safe firing log
        # fire() runs on the step loop and the producer thread at once:
        # plan counters, the rng and the log stay serialized, or at= and
        # every= firings drift from run to run
        self._lock = threading.Lock()

    def plan(self, site: str, kind: str = 'exception', **kw) -> _Plan:
        p = _Plan(site, kind, **kw)
        self._plans.append(p)
        return p

    def fire(self, site: str, **ctx):
        """Evaluate every plan for `site` whose ctx filters match; act on
        the first that triggers (raise / sleep / corrupt / return the
        cooperative kind). The firing is recorded before the action, so an
        injected exception is in the log though it unwinds."""
        # decide and record under the lock; act outside it (a latency
        # sleep under the lock would serialize every concurrent caller)
        fired = None
        with self._lock:
            for plan in self._plans:
                if plan.site != site:
                    continue
                if any(ctx.get(k) != v for k, v in plan.match.items()):
                    continue
                if not plan.wants(self.rng):
                    continue
                plan.fires += 1
                event = dict(site=site, kind=plan.kind, call=plan.calls,
                             **{k: v for k, v in ctx.items()
                                if isinstance(v, (str, int, float, bool))})
                self.injected.append(event)
                # one action per fire: later plans for this site were not
                # consulted and keep their counters
                fired = (plan, event)
                break
        if fired is None:
            return None
        plan, event = fired
        if plan.kind == 'latency':
            event['latency_s'] = plan.latency_s
            self.sleep(plan.latency_s)
        elif plan.kind == 'corrupt':
            path = ctx.get('path')
            if not path:
                raise ValueError(f'corrupt plan at {site} needs ctx path=')
            event['torn'] = corrupt_path(path, plan.frac)
        elif plan.kind == 'exception':
            raise InjectedFault(
                site, f'{plan.kind} (call {event["call"]})', **ctx)
        return plan.kind

    @property
    def injections_total(self) -> int:
        return len(self.injected)

    def snapshot(self) -> dict:
        """The firing log: seed, every firing, the total and the count by
        site:kind."""
        by_site: dict = {}
        for e in self.injected:
            key = f"{e['site']}:{e['kind']}"
            by_site[key] = by_site.get(key, 0) + 1
        return dict(seed=self.seed, injections=list(self.injected),
                    injections_total=self.injections_total,
                    by_site=by_site)
