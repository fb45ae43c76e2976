"""Overlapped training data path: producer thread -> device prefetch; the
port of se3_transformer_tpu/training/pipeline.py.

The step loop is host-bound whenever the host builds batches synchronously
between steps: the card drains its queue and idles while numpy assembles
the next batch and it is copied over. This module pipelines the host
stages:

  * `BatchProducer`  — runs any host batch source (an iterator, a
    generator such as `PointCloudDataset.batches`, or a
    ``build_fn(index) -> batch`` callable) on a background thread behind
    a BOUNDED queue. Exhaustion terminates the consumer cleanly; an
    exception in the source is re-raised in the consumer (wrapped as
    `BatchProducerError` with the original as ``__cause__``).
  * `device_prefetch` — keeps `depth` batches on the device ahead of the
    consumer: each numpy leaf is copied into pinned host memory and sent
    by a non-blocking copy on a side CUDA stream while step N computes;
    the consumer's stream waits on the copy's event, and every tensor is
    `record_stream`ed on it so that its memory is not reused while the
    step may still read it.
  * `PipelineStats`  — hit/stall accounting: a *hit* means the consumer's
    batch was already placed when requested, a *stall* means the consumer
    blocked on the producer. `snapshot()` is the record a run prints;
    `verdict` says whether a run is producer-bound or device-bound.

Every batch that leaves `device_prefetch` is a fresh device tensor: the
step may consume it, nothing else holds it.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
import warnings
from typing import Any, Callable, Iterable, Iterator, Optional, Union

import numpy as np
import torch

__all__ = [
    'BatchProducer', 'BatchProducerError', 'PipelineStats',
    'dataset_batch_source', 'device_prefetch',
]


class BatchProducerError(RuntimeError):
    """The batch source raised on the producer thread; the original
    exception is chained as ``__cause__``."""


_DONE = object()     # end-of-source sentinel (also carries errors)


class BatchProducer:
    """Run a host batch source on a background thread behind a bounded
    queue.

        with BatchProducer(dataset.batches(...), capacity=4) as producer:
            for batch in device_prefetch(producer, depth=2):
                ...

    `source` may be an iterable/iterator (consumed once — see
    `PointCloudDataset.batches` for its single-consumer contract) or a
    callable ``build_fn(index) -> batch`` (called with 0, 1, 2, ...
    forever). The queue is bounded by `capacity`, so a fast producer
    blocks on the slow consumer instead of buffering the whole epoch in
    host RAM. Single consumer; `close()` (or the context manager) stops
    the thread and drains the queue.

    Transient-fault tolerance: by default a source exception ends the
    run through `BatchProducerError`. With ``max_retries > 0`` the pull
    is retried
    with bounded exponential backoff (``retry_backoff_s`` doubling up
    to ``retry_backoff_max_s``, interruptible by close()); once retries
    are spent, ``max_skips > 0`` lets the producer SKIP the poison
    batch (counted in ``skipped`` — surfaced in the `pipeline` record's
    ``source`` section) and move on. Only a spent skip budget raises
    `BatchProducerError`. Retry can re-pull a ``build_fn`` source at
    the same index; a plain generator is DEAD after it raises (a
    re-next would silently end the stream), so for an iterator source
    retry applies only to faults raised BEFORE the pull: the
    ``fault_injector``'s ``fault_site`` (default ``batch_source``, ctx:
    index), fired once per pull on the producer thread.
    """

    def __init__(self, source: Union[Iterable, Callable[[int], Any]],
                 capacity: int = 4, name: str = 'batch-producer',
                 max_retries: int = 0, retry_backoff_s: float = 0.05,
                 retry_backoff_max_s: float = 2.0, max_skips: int = 0,
                 fault_injector=None, fault_site: str = 'batch_source'):
        if capacity < 1:
            raise ValueError(f'capacity must be >= 1, got {capacity}')
        self._build_fn = None
        self._it = None
        if callable(source) and not hasattr(source, '__next__') \
                and not hasattr(source, '__iter__'):
            self._build_fn = source    # retries re-pull the same index
        else:
            self._it = iter(source)
        self.capacity = capacity
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_max_s = float(retry_backoff_max_s)
        self.max_skips = int(max_skips)
        self.fault_injector = fault_injector
        self.fault_site = fault_site
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._exhausted = False
        self.puts = 0            # batches the producer finished building
        self.gets = 0            # batches the consumer received
        self.retries = 0         # transient source errors retried away
        self.skipped = 0         # poison batches dropped after retries
        self._restartable = True  # the last pull's failure may retry/skip
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=name)
        self._thread.start()

    # -- producer thread ------------------------------------------------- #
    def _put(self, item) -> bool:
        """Blocking put that honors close(); False if asked to stop."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _backoff_or_raise(self, attempts: int) -> int:
        """One retry tick: raises (re-raise in the caller) once the
        budget is spent, else sleeps the bounded backoff — via
        Event.wait, so a close() interrupts it instead of leaking a
        sleeping thread — and returns the new attempt count."""
        if attempts >= self.max_retries or self._stop.is_set():
            raise
        self.retries += 1
        backoff = min(self.retry_backoff_s * (2 ** attempts),
                      self.retry_backoff_max_s)
        self._stop.wait(backoff)
        return attempts + 1

    def _pull(self, index: int):
        """One source pull with the transient-retry policy. Raises
        StopIteration on exhaustion; re-raises the source error once the
        retry budget is spent (the skip policy is the caller's). Only a
        restartable failure retries: an injected fault (raised before the
        pull) or a `build_fn` error (the same index can be pulled again).
        A plain generator is dead once it raises (a re-next would return
        StopIteration and truncate the stream as clean exhaustion), so an
        iterator source's error fails loud at once."""
        attempts = 0
        self._restartable = True
        while True:
            if self.fault_injector is not None:
                try:
                    self.fault_injector.fire(self.fault_site,
                                             index=int(index))
                except Exception:
                    attempts = self._backoff_or_raise(attempts)
                    continue
            if self._build_fn is None:
                try:
                    return next(self._it)
                except StopIteration:
                    raise
                except Exception:
                    # the generator is dead: no retry, and no skip either
                    self._restartable = False
                    raise
            try:
                return self._build_fn(index)
            except StopIteration:
                raise
            except Exception:
                attempts = self._backoff_or_raise(attempts)

    def _worker(self):
        index = 0
        try:
            while not self._stop.is_set():
                try:
                    batch = self._pull(index)
                except StopIteration:
                    return
                except Exception as e:
                    # skip = "drop the item at this index": only a
                    # build_fn source maps indices to items (a dead
                    # generator has no next item to move on to)
                    if self._build_fn is not None \
                            and self._restartable \
                            and self.skipped < self.max_skips:
                        self.skipped += 1
                        index += 1
                        continue     # poison batch dropped, move on
                    raise e
                if not self._put(batch):
                    return
                self.puts += 1
                index += 1
        except BaseException as e:  # re-raised on the consumer side
            self._error = e
        finally:
            self._put(_DONE)

    # -- consumer side --------------------------------------------------- #
    def ready(self) -> bool:
        """A batch is available without blocking (used by
        device_prefetch for hit/stall accounting)."""
        return not self._q.empty()

    def qsize(self) -> int:
        return self._q.qsize()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
                if not self._thread.is_alive() and self._q.empty():
                    # thread died without managing to enqueue the
                    # sentinel (should not happen; don't hang if it does)
                    self._exhausted = True
                    self._raise_or_stop()
                continue
            if item is _DONE:
                self._exhausted = True
                self._thread.join(timeout=5)
                if self._thread.is_alive():
                    # the sentinel arrived, so the source loop is done —
                    # a thread still alive here is wedged in teardown;
                    # say so instead of silently leaking it (close()
                    # will raise if it is STILL alive then)
                    warnings.warn(
                        f'batch-producer thread {self._thread.name!r} '
                        f'still alive 5s after its end-of-source '
                        f'sentinel — leaking a wedged thread',
                        RuntimeWarning)
                self._raise_or_stop()
            self.gets += 1
            return item

    def _raise_or_stop(self):
        if self._error is not None:
            raise BatchProducerError(
                'batch source raised on the producer thread'
            ) from self._error
        raise StopIteration

    def close(self, timeout: float = 5.0, raise_on_leak: bool = True):
        """Idempotent: stop the thread, drain the queue, join.

        A thread that survives the bounded join is a LEAK — most likely
        the batch source is blocked inside `next()` (an uninterruptible
        build, a hung filesystem) and will hold its batch memory and a
        Python thread for the rest of the process. That is never
        silent: a loud RuntimeWarning always, and a RuntimeError when
        `raise_on_leak` (the context manager suppresses the raise only
        while another exception is already propagating, so the original
        error is never masked)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            msg = (f'batch-producer thread {self._thread.name!r} still '
                   f'alive after a {timeout:.1f}s close join — the '
                   f'batch source is wedged (blocked inside next()?); '
                   f'the thread and its queued batches are leaking')
            warnings.warn(msg, RuntimeWarning)
            if raise_on_leak:
                raise RuntimeError(msg)

    def __enter__(self) -> 'BatchProducer':
        return self

    def __exit__(self, exc_type, exc, tb):
        # raise on a leaked thread only when nothing else is already
        # unwinding — a leak report must never mask the real error
        self.close(raise_on_leak=exc_type is None)
        return False


@dataclasses.dataclass
class PipelineStats:
    """Hit/stall + occupancy accounting for one prefetch pipeline.

    hit   = the consumer's batch was already device-placed when requested
    stall = the consumer blocked on the producer (buffer empty)

    `snapshot()` is the payload of the schema'd ``pipeline`` record.
    """
    depth: int                   # configured prefetch depth
    capacity: int = 0            # producer queue capacity (0 = unknown)
    gets: int = 0                # batches delivered to the consumer
    hits: int = 0
    stalls: int = 0
    host_wait_s: float = 0.0     # total time blocked in next(source)
    place_s: float = 0.0         # total time issuing device_put
    occupancy_sum: int = 0       # producer qsize observed at each pull
    pulls: int = 0
    source: Optional[object] = None   # bound BatchProducer (live
    #                                   retry/skip counters, see below)

    def bind_source(self, producer):
        """Attach the producer whose transient-fault counters
        (`retries` retried pulls, `skipped` poison batches dropped)
        the `pipeline` record should surface — read LIVE at snapshot
        time, so every flush carries the current totals."""
        self.source = producer

    def record_pull(self, waited_s: float, occupancy: Optional[int]):
        self.pulls += 1
        self.host_wait_s += waited_s
        if occupancy is not None:
            self.occupancy_sum += occupancy

    def record_get(self, hit: bool):
        self.gets += 1
        if hit:
            self.hits += 1
        else:
            self.stalls += 1

    @property
    def hit_rate(self) -> float:
        return self.hits / self.gets if self.gets else 0.0

    def verdict(self) -> str:
        """Where does a step's time go? `device_bound` — the producer was
        (nearly) always ahead, so the device is the limiter and the
        pipeline is healthy; `producer_bound` — the consumer mostly
        blocked on the host, so host batch build is the limiter;
        `balanced` — in between."""
        if self.hit_rate >= 0.9:
            return 'device_bound'
        if self.hit_rate < 0.5:
            return 'producer_bound'
        return 'balanced'

    def snapshot(self) -> dict:
        out = dict(
            steps=self.gets,
            queue=dict(
                capacity=self.capacity,
                depth_mean=round(self.occupancy_sum / self.pulls, 2)
                if self.pulls else None),
            prefetch=dict(
                depth=self.depth,
                hits=self.hits,
                stalls=self.stalls,
                hit_rate=round(self.hit_rate, 4),
                host_wait_ms=round(self.host_wait_s * 1e3, 3),
                place_ms=round(self.place_s * 1e3, 3)),
            verdict=self.verdict())
        if self.source is not None:
            out['source'] = dict(
                retries=int(getattr(self.source, 'retries', 0)),
                skipped=int(getattr(self.source, 'skipped', 0)))
        return out


def _host_tensor(v) -> torch.Tensor:
    """A numpy leaf as a tensor on its memory (a contiguous, writable copy
    first where it is a read-only or broadcast view); other leaves as
    tensors."""
    if isinstance(v, np.ndarray):
        if not (v.flags.writeable and v.flags.c_contiguous):
            v = np.array(v, order='C')
        return torch.from_numpy(v)
    return torch.as_tensor(v)


def _place_on(device: torch.device, stream) -> Callable[[Any], Any]:
    """The placement of one host batch (a dict of numpy arrays or tensors)
    on `device`: on a card, each leaf copied into pinned host memory and
    sent by a non-blocking copy on `stream`, -> (batch, the copies'
    event); on the CPU, the leaves as tensors."""
    def leaf(v):
        t = _host_tensor(v)
        if device.type != 'cuda':
            return t.to(device)
        if t.device.type == 'cpu':
            pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t = pinned.copy_(t)
        return t.to(device, non_blocking=True)

    def place(batch):
        if stream is None:
            return {k: leaf(v) for k, v in batch.items()}
        with torch.cuda.stream(stream):
            out = {k: leaf(v) for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event
    return place


def device_prefetch(iterator: Iterable, depth: int = 2, device='cuda',
                    stats: Optional[PipelineStats] = None,
                    stall_threshold_s: float = 1e-3,
                    phase_timer=None) -> Iterator:
    """Keep `depth` batches on `device` ahead of the consumer.

    The host-to-device copies of batch N+k are issued from pinned memory
    on a side CUDA stream while the card computes step N. Before a batch
    is yielded the consumer's current stream waits on its copies' event,
    and each tensor is `record_stream`ed on that stream. With a
    `BatchProducer` source the top-up is non-blocking while the buffer is
    non-empty (the producer's `ready()` probe), so a momentarily slow
    producer delays future batches instead of the one already placed; a
    plain iterator falls back to one blocking pull per yield, with
    wait-time thresholding for hit/stall accounting. On the CPU the same
    loop yields tensors (copies of the numpy leaves).

    `stats` (PipelineStats) accumulates the hits, stalls, host wait and
    placement time; `phase_timer` (observability.PhaseTimer) gets a
    `host_wait` sample for every pull and a `prefetch` sample for every
    placement (host time: the copies are queued, not waited for). Yields every batch of `iterator` in order; terminates
    when the source is exhausted; source exceptions propagate to the
    consumer."""
    if depth < 1:
        raise ValueError(f'prefetch depth must be >= 1, got {depth}')
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == 'cuda' else None
    place = _place_on(device, side)
    it = iter(iterator)
    ready_probe = getattr(iterator, 'ready', None)
    size_probe = getattr(iterator, 'qsize', None)

    def pull():
        t0 = time.perf_counter()
        item = next(it)                      # may raise StopIteration
        waited = time.perf_counter() - t0
        if phase_timer is not None:
            phase_timer.record('host_wait', waited)
        if stats is not None:
            stats.record_pull(
                waited, size_probe() if size_probe is not None else None)
        t1 = time.perf_counter()
        placed = place(item)
        dt = time.perf_counter() - t1
        if phase_timer is not None:
            phase_timer.record('prefetch', dt)
        if stats is not None:
            stats.place_s += dt
        return placed

    def hand_over(placed):
        if side is None:
            return placed
        batch, event = placed
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in batch.values():
            t.record_stream(current)
        return batch

    def gen():
        buf = collections.deque()
        exhausted = False
        while True:
            stalled = False
            while not exhausted and len(buf) < depth:
                if buf and ready_probe is not None and not ready_probe():
                    break        # don't block a ready batch on a future one
                empty = not buf
                if empty:
                    # the consumer is waiting on the host; it still counts
                    # as a hit when the producer had the batch ready
                    # (probe), or, for probe-less sources, when the pull
                    # returned near-instantly
                    was_ready = ready_probe() if ready_probe is not None \
                        else None
                    t0 = time.perf_counter()
                try:
                    buf.append(pull())
                except StopIteration:
                    exhausted = True
                    continue
                if empty:
                    stalled = (not was_ready) if was_ready is not None \
                        else (time.perf_counter() - t0 >= stall_threshold_s)
            if not buf:
                return
            if stats is not None:
                stats.record_get(hit=not stalled)
            yield hand_over(buf.popleft())

    return gen()


def dataset_batch_source(dataset, batch_size: int, bucket: int,
                         accum_steps: int = 1,
                         num_steps: Optional[int] = None,
                         num_tokens_dtype=np.int32) -> Iterator[dict]:
    """Host batch dicts for `DenoiseTrainer` from a `PointCloudDataset`.

    Cycles epochs forever (per-epoch shuffle seed = epoch number, so the
    dropped remainder rotates), renames dataset keys to the trainer's
    (tokens->seqs, mask->masks), broadcasts the bucket's chain adjacency
    to [batch, n, n], and — with accum_steps > 1 — stacks that many
    consecutive batches on a leading axis. Pure numpy: meant to run
    entirely on a `BatchProducer` thread. Stops after `num_steps` outer
    steps (None = infinite).
    """
    if not len(dataset):
        raise ValueError('empty dataset')

    def host_batch(b):
        n = b['tokens'].shape[1]
        adj = np.broadcast_to(b['adj_mat'][None], (batch_size, n, n))
        return dict(seqs=b['tokens'].astype(num_tokens_dtype),
                    coords=b['coords'], masks=b['mask'], adj_mat=adj)

    def gen():
        produced = 0
        micro = []
        for epoch in itertools.count():
            got = False
            for b in dataset.batches(batch_size=batch_size,
                                     buckets=(bucket,),
                                     shuffle_seed=epoch):
                got = True
                micro.append(host_batch(b))
                if len(micro) < max(1, accum_steps):
                    continue
                if accum_steps <= 1:
                    out = micro[0]
                else:
                    out = {k: np.stack([m[k] for m in micro])
                           for k in micro[0]}
                micro.clear()
                yield out
                produced += 1
                if num_steps is not None and produced >= num_steps:
                    return
            if not got:
                raise ValueError(
                    f'dataset produced no full batches for bucket '
                    f'{bucket} at batch_size {batch_size} — nothing '
                    f'to train on')

    return gen()
