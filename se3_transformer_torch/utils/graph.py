"""Host-side graph helpers in NumPy: the port's own copy of what it needs
of the fallbacks in se3_transformer_tpu/native/loader.py. The engine, the
batch builders and the dataset call these; native/loader.py takes them as
its fallbacks, so each exists once."""
from __future__ import annotations

from typing import Optional

import numpy as np


def chain_adjacency(n: int) -> np.ndarray:
    """[n, n] bool adjacency of a chain: i and j are bonded iff
    |i - j| == 1."""
    i = np.arange(n)
    return np.abs(i[:, None] - i[None, :]) == 1


def pad_batch(token_seqs, coord_seqs, max_len: Optional[int] = None,
              pad_value: int = 0):
    """Ragged (tokens, coords) sequences -> tokens [b, L] int32, coords [b,
    L, 3] float32 and mask [b, L] bool, L = max_len or the longest; a
    sequence longer than L is truncated to it."""
    b = len(token_seqs)
    lengths = [len(t) for t in token_seqs]
    L = int(max_len if max_len is not None else max(lengths))
    tokens = np.full((b, L), pad_value, np.int32)
    coords = np.zeros((b, L, 3), np.float32)
    mask = np.zeros((b, L), bool)
    for i, (t, c) in enumerate(zip(token_seqs, coord_seqs)):
        Li = min(lengths[i], L)
        tokens[i, :Li] = np.asarray(t[:Li], np.int32)
        coords[i, :Li] = np.asarray(c, np.float32).reshape(-1, 3)[:Li]
        mask[i, :Li] = True
    return tokens, coords, mask
