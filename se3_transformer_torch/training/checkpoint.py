"""Checkpoint / resume: the port of se3_transformer_tpu/training/checkpoint.py.

Params, optimizer state and the step counter, atomic writes, latest-step
discovery, an async save path (`save_async`) that keeps the step loop
running while a background thread serializes, the model-family guard, and
a restore that falls back past torn entries.

The format is the port's own: one `torch.save` file per step,
`<dir>/step_<n>.pt`, holding a CPU snapshot of the state (tensors,
dicts, lists, tuples and numbers), written to `step_<n>.pt.tmp` and then
`os.replace`d, so `latest_step` only ever sees completed entries; with a
`model_family` each save also stamps `step_<n>.meta.json` as the JAX
manager does. Files are read back with `torch.load(weights_only=True)`:
nothing but tensors and plain containers is unpickled.

In-place updates. torch's optimizers update the parameters and their
moments in place, where JAX's step returns new arrays. So `save_async`
takes its snapshot before it returns: every CUDA tensor is copied into
pinned host memory by a non-blocking copy queued on the current stream
(behind the step that made it and before any later step's in-place
update), an event is recorded after the copies, and the writer thread
waits on that event before it serializes; CPU tensors are cloned at once.
A checkpoint written while the next steps run holds the state of the step
it names.

Preemption safety: a completed-looking entry can still be torn (a
preemption between write and fsync, a truncated file). `restore` /
`restore_params` therefore verify by loading: when the newest step fails
to load they warn and fall back to the next-newest step that does (an
explicitly named `step=` fails hard). `last_restored_step` says which step
answered. Retention is torn-step-aware: keep-last-k GC never deletes the
newest step that restores (`verify_step`).
"""
from __future__ import annotations

import json
import os
import re
import sys
import threading
import warnings
from typing import Any, Optional

import torch

# a COMPLETED checkpoint entry; an in-flight write lives in
# `step_<n>.pt.tmp`, which never matches
_STEP_ENTRY = re.compile(r'^step_(\d+)\.pt$')


class ModelFamilyMismatch(ValueError):
    """A checkpoint stamped for one model family was asked to restore into
    another. Never caught by `restore()`'s torn-checkpoint fallback: a
    family mismatch is a configuration error (the wrong checkpoint
    directory for this model), not a corrupt entry."""

    def __init__(self, expected: str, found: str, step: int,
                 directory: str):
        self.expected = expected
        self.found = found
        self.step = step
        self.directory = directory
        super().__init__(
            f'checkpoint model-family mismatch: step {step} in '
            f'{directory} was saved by model family {found!r} but this '
            f'manager restores for {expected!r}; the families are not '
            f'checkpoint-compatible; point the manager at a {expected!r} '
            f'checkpoint directory')


def _tree_map(fn, tree):
    """fn over every tensor leaf of nested tuples, lists and dicts; other
    leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def snapshot_device_arrays(state: Any) -> Any:
    """A host copy of every tensor leaf of `state` (other leaves pass
    through): CUDA tensors by non-blocking copies into pinned memory,
    queued on the current stream, so the copy holds the values the queued
    work has made by now, whatever in-place update is queued after it; CPU
    tensors cloned at once. Before reading a CUDA leaf's copy, wait on an
    event recorded after this call (CheckpointManager.save_async does)."""
    def copy(t):
        t = t.detach()
        if t.device.type == 'cuda':
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t, non_blocking=True)
        return t.clone()
    return _tree_map(copy, state)


def _snapshot(state: Any):
    """(snapshot_device_arrays(state), the events recorded after its copies
    on the current stream of each CUDA device it reads)."""
    devices = set()
    _tree_map(lambda t: devices.add(t.device) if t.device.type == 'cuda'
              else None, state)
    snap = snapshot_device_arrays(state)
    events = []
    for dev in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        events.append(event)
    return snap, events


class CheckpointManager:
    """Save/restore (params, opt_state, step) under `directory`.

    `save` blocks until the state is on disk; `save_async` snapshots the
    state to host memory (see the module docstring) and writes on a
    background thread; the next save/save_async/close waits for the
    in-flight write and re-raises its failure."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 writer_timeout_s: float = 300.0,
                 model_family: Optional[str] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        # the family guard: when set, every save stamps a step_<n>.meta.json
        # sidecar and every restore checks it; None = unguarded
        self.model_family = model_family
        os.makedirs(self.directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        # a writer thread that outlives this join warns; close paths raise
        self.writer_timeout_s = float(writer_timeout_s)
        self.last_restored_step: Optional[int] = None
        # steps proven restorable (verify_step / a successful restore)
        self._verified: set = set()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f'step_{step:08d}.pt')

    def _meta_path(self, step: int) -> str:
        # not matched by _STEP_ENTRY: never listed as a checkpoint entry
        return os.path.join(self.directory, f'step_{step:08d}.meta.json')

    def _write_meta(self, step: int):
        if self.model_family is None:
            return
        tmp = self._meta_path(step) + '.tmp'
        with open(tmp, 'w') as f:
            json.dump({'model_family': self.model_family}, f)
        os.replace(tmp, self._meta_path(step))

    def _stamped_family(self, step: int) -> Optional[str]:
        try:
            with open(self._meta_path(step)) as f:
                return json.load(f).get('model_family')
        except (OSError, ValueError):
            return None   # unstamped or unreadable sidecar

    def _check_family(self, step: int):
        """Raise ModelFamilyMismatch before any tensor is read when the
        stamp disagrees with this manager's family. Unstamped steps (or an
        unguarded manager) pass."""
        if self.model_family is None:
            return
        found = self._stamped_family(int(step))
        if found is not None and found != self.model_family:
            raise ModelFamilyMismatch(self.model_family, found, int(step),
                                      self.directory)

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_ENTRY.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name)):
                steps.append(int(m.group(1)))
        return sorted(set(steps))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write_state(self, step: int, state: Any):
        """One atomic write shared by the sync and async paths: the whole
        file under a temporary name, then os.replace."""
        # rewriting a step voids its earlier integrity proof
        self._verified.discard(int(step))
        path = self._path(step)
        tmp = path + '.tmp'
        torch.save(state, tmp)
        os.replace(tmp, path)
        # the stamp after the entry: a crash between the two leaves an
        # unstamped but valid step, never a stamped but missing one
        self._write_meta(int(step))

    def save(self, step: int, state: Any):
        self.wait_until_finished()
        snap, events = _snapshot(state)
        for event in events:
            event.synchronize()
        self._write_state(step, snap)
        self._gc()

    def save_async(self, step: int, state: Any):
        """Checkpoint without stalling the step loop: the snapshot is taken
        (queued, for CUDA tensors) before this returns, so the caller may
        run further in-place steps at once; a writer thread waits for the
        snapshot's copies, then performs the same atomic write as `save`.
        One write is in flight at a time: the next save, save_async,
        wait_until_finished or close joins it first and re-raises its
        failure."""
        self.wait_until_finished()
        snap, events = _snapshot(state)

        def write():
            try:
                for event in events:
                    event.synchronize()
                self._write_state(step, snap)
                self._gc()
            except BaseException as e:  # surfaced at the next barrier
                self._async_error = e

        t = threading.Thread(target=write, name=f'ckpt-write-{step}',
                             daemon=True)
        self._async_thread = t
        t.start()

    @property
    def save_in_flight(self) -> bool:
        t = self._async_thread
        return bool(t is not None and t.is_alive())

    def wait_until_finished(self, timeout: Optional[float] = None,
                            raise_on_timeout: bool = False):
        """Wait for the in-flight async write (a no-op when idle); re-raise
        its failure. A join past `writer_timeout_s` warns, then keeps
        waiting (a slow write is not a failure); close paths pass
        `raise_on_timeout=True` and raise instead, keeping the thread so
        that a later barrier can still collect the write."""
        timeout = self.writer_timeout_s if timeout is None else timeout
        t = self._async_thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                msg = (f'checkpoint writer thread {t.name!r} still alive '
                       f'after a {timeout:.1f}s join: the async write is '
                       f'wedged or very slow')
                warnings.warn(msg, RuntimeWarning)
                if raise_on_timeout:
                    raise RuntimeError(msg)
                t.join()
        self._async_thread = None
        err, self._async_error = self._async_error, None
        if err is not None:
            raise RuntimeError('async checkpoint write failed') from err

    def close(self, raise_on_timeout: bool = True):
        self.wait_until_finished(raise_on_timeout=raise_on_timeout)

    def __enter__(self) -> 'CheckpointManager':
        return self

    def __exit__(self, exc_type, exc, tb):
        # raise on a wedged writer only when nothing else is unwinding
        self.close(raise_on_timeout=exc_type is None)
        return False

    def _fallback_restore(self, restore_one, what: str) -> Any:
        """Try each completed step newest-first; a step that fails to load
        (a torn write, a truncated file) is skipped with a warning. Raises
        only when no step restores."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f'no checkpoints in {self.directory}')
        errors = []
        for step in reversed(steps):
            try:
                state = restore_one(step)
            except ModelFamilyMismatch:
                raise
            except Exception as e:  # noqa: BLE001 - torn entries fail any way
                errors.append((step, f'{type(e).__name__}: {e}'))
                warnings.warn(
                    f'checkpoint step {step} in {self.directory} failed to '
                    f'{what} ({type(e).__name__}: {e}): corrupt or partial; '
                    f'falling back to the next-newest step', RuntimeWarning)
                continue
            self.last_restored_step = step
            self._verified.add(step)
            if errors:
                print(f'checkpoint: restored step {step} after '
                      f'{len(errors)} corrupt newer step(s): '
                      f'{[s for s, _ in errors]}', file=sys.stderr)
            return state
        raise RuntimeError(f'no restorable checkpoint in {self.directory}: '
                           f'every step failed: {errors}')

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """The saved state on the CPU; with `like` (a state of the same
        structure) each tensor moves to the device of like's tensor at the
        same place. With `step=None` the newest valid step answers (see
        `_fallback_restore`); a named `step` fails hard."""
        if step is not None:
            state = self._restore_step(step, like)
            self.last_restored_step = int(step)
            self._verified.add(int(step))
            return state
        return self._fallback_restore(
            lambda s: self._restore_step(s, like), 'restore')

    def _load(self, step: int) -> Any:
        return torch.load(self._path(step), map_location='cpu',
                          weights_only=True)

    def _restore_step(self, step: int, like: Any = None) -> Any:
        self._check_family(step)
        state = self._load(step)
        return state if like is None else _placed_like(state, like)

    @staticmethod
    def _params_subtree(tree):
        """(params, opt_state, step) -> element 0; a dict with 'params' ->
        that entry; anything else is a params-only checkpoint."""
        if isinstance(tree, (tuple, list)):
            return tree[0]
        if isinstance(tree, dict) and 'params' in tree:
            return tree['params']
        return tree

    def restore_params(self, step: Optional[int] = None) -> Any:
        """Params-only restore for serving: the params of the state, on the
        CPU (the file is one blob, so the optimizer state is read and
        dropped). Same integrity fallback as `restore`."""
        if step is not None:
            params = self._params_subtree(self._restore_step(step))
            self.last_restored_step = int(step)
            return params
        return self._fallback_restore(
            lambda s: self._params_subtree(self._restore_step(s)),
            'restore params from')

    def verify_step(self, step: int) -> bool:
        """Does this step load? A success is cached."""
        if step in self._verified:
            return True
        try:
            self._load(step)
        except Exception:  # noqa: BLE001 - torn entries fail any way
            return False
        self._verified.add(step)
        return True

    def _newest_restorable(self, steps) -> Optional[int]:
        for step in reversed(steps):
            if self.verify_step(step):
                return step
        return None

    def _gc(self):
        """keep-last-k, the rollback target protected: the newest step that
        verifies survives GC even outside the keep window, so a run whose
        newest writes are all torn keeps a step to restore."""
        steps = self.all_steps()
        doomed = steps[:-self.max_to_keep]
        if not doomed:
            return
        target = self._newest_restorable(steps)
        for step in doomed:
            if target is not None and step == target:
                warnings.warn(
                    f'checkpoint GC kept step {step} beyond max_to_keep='
                    f'{self.max_to_keep}: every newer step is torn and this '
                    f'is the newest restorable one', RuntimeWarning)
                continue
            for path in (self._path(step), self._meta_path(step)):
                if os.path.exists(path):
                    os.remove(path)
            self._verified.discard(step)


def _placed_like(state: Any, like: Any) -> Any:
    """state's tensors moved to the devices of like's tensors at the same
    places (structures that differ keep state's leaves where they are)."""
    if isinstance(state, torch.Tensor):
        return state.to(like.device) if isinstance(like, torch.Tensor) \
            else state
    if isinstance(state, dict) and isinstance(like, dict):
        return type(state)((k, _placed_like(v, like[k]) if k in like else v)
                           for k, v in state.items())
    if isinstance(state, (tuple, list)) and isinstance(like, (tuple, list)) \
            and len(state) == len(like):
        return type(state)(_placed_like(a, b) for a, b in zip(state, like))
    return state
