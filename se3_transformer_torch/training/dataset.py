"""File-backed point-cloud datasets with length bucketing: the port of
se3_transformer_tpu/training/dataset.py (numpy only; the same .npz layout,
so a dataset written by either package loads in the other).

Variable-length data is bucketed by length (a fixed shape per bucket) and
padded on the host (utils/graph.py). This module provides:

  * `save_point_cloud_dataset` / `PointCloudDataset` — a simple .npz
    container (ragged sequences stored flat + offsets): tokens and
    coords; `batches()` attaches the bucket's chain adjacency.
  * `PointCloudDataset.batches(...)` — an iterator of padded, fixed-shape
    batch dicts grouped by length bucket, ready for
    `pipeline.BatchProducer`/`pipeline.device_prefetch`.

Swap in real data (e.g. a sidechainnet export) by writing the same .npz
layout — no framework changes needed.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..utils.graph import chain_adjacency, pad_batch


def save_point_cloud_dataset(path: str, token_seqs: Sequence[np.ndarray],
                             coord_seqs: Sequence[np.ndarray],
                             mask_seqs: Optional[Sequence[np.ndarray]] = None
                             ) -> str:
    """Store ragged (tokens [L], coords [L, 3], optional mask [L])
    sequences as one .npz. Masks mark unresolved nodes (e.g. residues a
    sidechainnet entry could not place); omitted = all valid."""
    if len(token_seqs) != len(coord_seqs):
        raise ValueError(f'{len(token_seqs)} token sequences vs '
                         f'{len(coord_seqs)} coordinate sequences')
    if mask_seqs is not None and len(mask_seqs) != len(token_seqs):
        raise ValueError(f'{len(mask_seqs)} masks vs {len(token_seqs)} '
                         f'sequences')
    for i, (t, c) in enumerate(zip(token_seqs, coord_seqs)):
        c = np.asarray(c)
        if len(t) != c.reshape(-1, 3).shape[0]:
            # offsets are token-derived: a mismatch would mis-slice every
            # later sequence
            raise ValueError(f'sequence {i}: {len(t)} tokens vs '
                             f'{c.reshape(-1, 3).shape[0]} coordinates')
        if mask_seqs is not None and len(mask_seqs[i]) != len(t):
            raise ValueError(f'sequence {i}: mask length '
                             f'{len(mask_seqs[i])} vs {len(t)} tokens')
    lengths = np.asarray([len(t) for t in token_seqs], np.int64)
    flat_tokens = np.concatenate(
        [np.asarray(t, np.int32) for t in token_seqs]) if len(lengths) else \
        np.zeros((0,), np.int32)
    flat_coords = np.concatenate(
        [np.asarray(c, np.float32).reshape(-1, 3) for c in coord_seqs]) \
        if len(lengths) else np.zeros((0, 3), np.float32)
    arrays = dict(lengths=lengths, tokens=flat_tokens, coords=flat_coords)
    if mask_seqs is not None:
        arrays['masks'] = np.concatenate(
            [np.asarray(m, bool) for m in mask_seqs]) if len(lengths) else \
            np.zeros((0,), bool)
    np.savez(path if path.endswith('.npz') else path + '.npz', **arrays)
    return path if path.endswith('.npz') else path + '.npz'


@dataclasses.dataclass
class PointCloudDataset:
    lengths: np.ndarray          # [S]
    tokens: np.ndarray           # [sum L] int32
    coords: np.ndarray          # [sum L, 3] float32
    masks: Optional[np.ndarray] = None  # [sum L] bool, None = all valid
    # sequences the last batches(drop_longer=True) call discarded for
    # exceeding the largest bucket (set eagerly, before the first yield)
    last_dropped: int = 0

    @classmethod
    def load(cls, path: str) -> 'PointCloudDataset':
        with np.load(path) as data:
            return cls(lengths=data['lengths'].astype(np.int64),
                       tokens=data['tokens'].astype(np.int32),
                       coords=data['coords'].astype(np.float32),
                       masks=(data['masks'].astype(bool)
                              if 'masks' in data else None))

    def __len__(self) -> int:
        return len(self.lengths)

    def _offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.lengths)])

    def sequence(self, i: int):
        off = self._offsets()
        s, e = off[i], off[i + 1]
        return self.tokens[s:e], self.coords[s:e]

    def batches(self, batch_size: int,
                buckets: Sequence[int] = (64, 128, 256, 512),
                max_len: Optional[int] = None,
                shuffle_seed: Optional[int] = 0,
                drop_longer: bool = True,
                with_chain_adjacency: bool = True) -> Iterator[dict]:
        """Padded fixed-shape batches grouped by length bucket.

        Each yielded dict: tokens [B, L], coords [B, L, 3], mask [B, L],
        and (optionally) adj_mat [L, L] for the bucket's chain graph. L is
        the bucket size, so each bucket compiles exactly once downstream.
        Sequences longer than the largest bucket are dropped (the
        sidechainnet trainer skips >500-residue proteins the same way)
        unless drop_longer=False, in which case they are truncated. Drops
        are counted eagerly (before the first yield): the count lands in
        `self.last_dropped` and a single UserWarning carries it — a
        dataset silently shrinking to a fraction of itself was previously
        invisible.

        Fixed shapes require full batches, so each bucket's trailing
        partial batch is dropped for that pass; vary `shuffle_seed` per
        epoch (e.g. pass the epoch number) so different sequences land in
        the remainder each time.

        Thread-handoff contract (pipeline.BatchProducer): the
        batching PLAN — bucket assignment, drop count, and the per-epoch
        shuffle order — is frozen eagerly, before this call returns. The
        returned generator closes only over that frozen plan plus the
        dataset's (treated-as-immutable) flat arrays, so it is safe to
        hand to a background producer thread while the caller invokes
        `batches()` again for the next epoch: a live iterator and a
        re-call share NO mutable epoch state. Each generator is
        single-consumer (generators are not thread-safe to share); the
        one instance attribute this method writes, `last_dropped`, is
        written here — never by the generator.
        """
        buckets = sorted(b for b in buckets
                         if max_len is None or b <= max_len)
        if not buckets:
            raise ValueError('no usable buckets')
        off = self._offsets()

        by_bucket: List[List[int]] = [[] for _ in buckets]
        dropped = 0
        for i, L in enumerate(self.lengths):
            placed = False
            for bi, b in enumerate(buckets):
                if L <= b:
                    by_bucket[bi].append(i)
                    placed = True
                    break
            if not placed:
                if drop_longer:
                    dropped += 1
                else:
                    by_bucket[-1].append(i)  # truncated to the bucket
        self.last_dropped = dropped
        if dropped:
            warnings.warn(
                f'PointCloudDataset.batches: dropped {dropped} of '
                f'{len(self.lengths)} sequences longer than the largest '
                f'bucket ({buckets[-1]}); add a larger bucket or pass '
                f'drop_longer=False to truncate instead', stacklevel=2)

        rng = np.random.RandomState(shuffle_seed) \
            if shuffle_seed is not None else None
        # freeze the shuffle order NOW (not lazily at iteration time):
        # the rng must not be shared between a live iterator and a
        # re-call, and an eagerly-built plan is what makes the generator
        # below self-contained enough to run on a producer thread
        plan = [(buckets[bi],
                 list(rng.permutation(idxs)) if rng is not None
                 else list(idxs))
                for bi, idxs in enumerate(by_bucket)]

        def generate() -> Iterator[dict]:
            for L, order in plan:
                adj = chain_adjacency(L) if with_chain_adjacency else None
                for start in range(0, len(order) - batch_size + 1,
                                   batch_size):
                    chosen = order[start:start + batch_size]
                    toks, crds = [], []
                    for i in chosen:
                        s, e = off[i], off[i + 1]
                        toks.append(self.tokens[s:e])
                        crds.append(self.coords[s:e])
                    tokens, coords, mask = pad_batch(toks, crds, max_len=L)
                    if self.masks is not None:
                        # padding mask AND per-node resolution mask
                        for row, i in enumerate(chosen):
                            s, e = off[i], off[i + 1]
                            m = self.masks[s:e][:L]
                            mask[row, :len(m)] &= m
                    batch = dict(tokens=tokens, coords=coords, mask=mask,
                                 bucket=L)
                    if adj is not None:
                        batch['adj_mat'] = adj
                    yield batch

        return generate()
