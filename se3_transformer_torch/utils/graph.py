"""Host-side graph helpers: the port's own numpy copy of what it needs from
se3_transformer_tpu/native/loader.py."""
from __future__ import annotations

import numpy as np


def chain_adjacency(n: int) -> np.ndarray:
    """[n, n] bool adjacency of a chain: i and j are bonded iff
    |i - j| == 1."""
    i = np.arange(n)
    return np.abs(i[:, None] - i[None, :]) == 1
