"""ctypes loader of the host-side graph builder, with a NumPy fallback: the
port's own counterpart of se3_transformer_tpu/native/loader.py.

graph_builder.cpp (this package's copy) is compiled with g++ at first use
into native/build/ beside this file (listed in .gitignore), under a name
that carries a hash of the source, so an edited source is rebuilt and a
stale library is never loaded. Every function has a NumPy fallback with
the same results, taken when no toolchain is there; chain_adjacency's and
pad_batch's are utils/graph.py's. The port's engine, batch builders and
dataset call utils/graph.py directly and never build this library: at
their sizes (a chain of at most a few thousand nodes, a batch of a few
sequences) nothing measures the native path as moving a step.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..utils import graph as _numpy

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, 'graph_builder.cpp')
BUILD_DIR = os.path.join(_HERE, 'build')
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the library built from this source lives."""
    with open(SOURCE, 'rb') as fh:
        tag = hashlib.sha1(fh.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f'libse3graph-{tag}.so')


def _build(lib: str) -> bool:
    """g++ into a per-process temporary name, then an atomic rename (two
    processes may build at once)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{lib}.{os.getpid()}.tmp'
    try:
        subprocess.run(['g++', '-O3', '-shared', '-fPIC', SOURCE, '-o', tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library, building it if needed; None if unavailable
    (every caller then takes its NumPy fallback)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
        i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
        i32 = ctypes.c_int32
        lib.chain_adjacency.argtypes = [i32, u8p]
        lib.expand_adjacency.argtypes = [i32, i32, u8p, i32p]
        lib.knn_graph.argtypes = [f32p, i32, i32, i32, ctypes.c_float,
                                  i32p, f32p, u8p]
        lib.pad_token_batch.argtypes = [i32p, i32p, i32, i32, i32, i32p, u8p]
        lib.pad_coord_batch.argtypes = [f32p, i32p, i32, i32, f32p]
        for fn in (lib.chain_adjacency, lib.expand_adjacency, lib.knn_graph,
                   lib.pad_token_batch, lib.pad_coord_batch):
            fn.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def chain_adjacency(n: int) -> np.ndarray:
    """[n, n] bool adjacency of a chain: i and j are bonded iff
    |i - j| == 1."""
    lib = get_lib()
    if lib is None:
        return _numpy.chain_adjacency(n)
    out = np.zeros((n, n), np.uint8)
    lib.chain_adjacency(n, out)
    return out.astype(bool)


def expand_adjacency(adj: np.ndarray, num_degrees: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The adjacency expanded to `num_degrees` hops and the hop-count ring
    labels (0 where unreachable): the host-side counterpart of
    ops.neighbors' expansion. A batched `adj` takes the NumPy path."""
    n = adj.shape[-1]
    lib = get_lib()
    if lib is not None and adj.ndim == 2:
        # a copy: the C function expands its argument in place
        a = np.array(adj, dtype=np.uint8, copy=True, order='C')
        labels = np.zeros((n, n), np.int32)
        lib.expand_adjacency(n, num_degrees, a, labels)
        return a.astype(bool), labels
    a = adj.astype(bool)
    labels = a.astype(np.int32)
    cur = a
    for d in range(2, num_degrees + 1):
        nxt = (cur.astype(np.float32) @ cur.astype(np.float32)) > 0
        labels = np.where(nxt & ~cur & (labels == 0), d, labels)
        cur = nxt
    return cur, labels


def knn_graph(coords: np.ndarray, k: int, radius: float = np.inf
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact batched kNN excluding self: coords [b, n, 3] -> (idx [b, n, k]
    int32, dist [b, n, k] float32, mask [b, n, k] bool: dist <= radius);
    k is clipped to n - 1."""
    coords = np.ascontiguousarray(coords, np.float32)
    b, n, _ = coords.shape
    k = int(min(k, n - 1)) if n > 1 else 0
    idx = np.zeros((b, n, k), np.int32)
    dist = np.zeros((b, n, k), np.float32)
    mask = np.zeros((b, n, k), np.uint8)
    if k == 0:
        return idx, dist, mask.astype(bool)
    lib = get_lib()
    if lib is not None:
        r = np.float32(radius if np.isfinite(radius)
                       else np.finfo(np.float32).max)
        lib.knn_graph(coords, b, n, k, r, idx, dist, mask)
        return idx, dist, mask.astype(bool)
    d2 = ((coords[:, :, None, :] - coords[:, None, :, :]) ** 2).sum(-1)
    ii = np.arange(n)
    d2[:, ii, ii] = np.inf
    idx = np.argsort(d2, axis=-1, kind='stable')[..., :k].astype(np.int32)
    dist = np.sqrt(np.take_along_axis(d2, idx, axis=-1)).astype(np.float32)
    return idx, dist, dist <= radius


def pad_to_bucket(token_seqs, coord_seqs, bucket_len: int,
                  batch_size: Optional[int] = None, pad_value: int = 0):
    """The one pad-to-bucket implementation: truncates each ragged sequence
    to `bucket_len` and pads to tokens [B, bucket_len] int32, coords [B,
    bucket_len, 3] float32 and mask [B, bucket_len]; with `batch_size`
    past the number of sequences, appends all-padding rows (mask False)."""
    if batch_size is not None and len(token_seqs) > batch_size:
        raise ValueError(f'{len(token_seqs)} sequences do not fit a batch '
                         f'of {batch_size}')
    toks = [np.asarray(t)[:bucket_len] for t in token_seqs]
    crds = [np.asarray(c, np.float32).reshape(-1, 3)[:bucket_len]
            for c in coord_seqs]
    tokens, coords, mask = pad_batch(toks, crds, max_len=bucket_len,
                                     pad_value=pad_value)
    if batch_size is not None and tokens.shape[0] < batch_size:
        extra = batch_size - tokens.shape[0]
        tokens = np.concatenate(
            [tokens, np.full((extra, bucket_len), pad_value, np.int32)])
        coords = np.concatenate(
            [coords, np.zeros((extra, bucket_len, 3), np.float32)])
        mask = np.concatenate([mask, np.zeros((extra, bucket_len), bool)])
    return tokens, coords, mask


def pad_batch(token_seqs, coord_seqs, max_len: Optional[int] = None,
              pad_value: int = 0):
    """Ragged (tokens, coords) sequences -> tokens [b, L] int32, coords [b,
    L, 3] float32 and mask [b, L] bool, L = max_len or the longest."""
    lib = get_lib()
    if lib is None:
        return _numpy.pad_batch(token_seqs, coord_seqs, max_len, pad_value)
    b = len(token_seqs)
    lengths = np.asarray([len(t) for t in token_seqs], np.int32)
    L = int(max_len if max_len is not None else lengths.max())
    tokens_out = np.full((b, L), pad_value, np.int32)
    mask = np.zeros((b, L), np.uint8)
    coords_out = np.zeros((b, L, 3), np.float32)
    flat_t = np.ascontiguousarray(np.concatenate(
        [np.asarray(t, np.int32) for t in token_seqs]))
    flat_c = np.ascontiguousarray(np.concatenate(
        [np.asarray(c, np.float32).reshape(-1, 3) for c in coord_seqs]))
    lib.pad_token_batch(flat_t, lengths, b, L, pad_value, tokens_out, mask)
    lib.pad_coord_batch(flat_c, lengths, b, L, coords_out)
    return tokens_out, coords_out, mask.astype(bool)
