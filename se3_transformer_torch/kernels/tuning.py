"""The shape-keyed kernel block-config table: the port of
se3_transformer_tpu/kernels/tuning.py.

Every runtime choice of a kernel's blocks is resolved by `pick`, in this
order:

    env override > force(kind, blocks, shape=, dtype=) > table > heuristic

  * the env overrides (SE3_TORCH_I_PER_SPLIT, SE3_TORCH_FLASH_CHUNKS,
    SE3_TORCH_SO2_CHUNKS) are the escape hatch, honoured as given;
  * `force` is the tuner's in-process candidate (kernels/tune.py): a
    pending entry under measurement, pinned to one shape and dtype so that
    it cannot leak into the other picks of the step;
  * the table is a versioned JSON file, $SE3_TORCH_CACHE_PATH/
    kernel_blocks_v1.json (the directory basis.py keeps its Q_J constants
    in; read per call, so tests and the tuner retarget it without a
    re-import; an empty value disables the table), keyed
    `kind|shape|dtype|device_kind` with per-entry provenance (code_rev,
    time). A missing, corrupt or truncated file, or one of another
    version, is a miss. A hit is adopted only if `validate_entry` admits
    it; an inadmissible entry warns and the heuristic is used;
  * with an empty table and no override every pick is the heuristic's,
    bit for bit (tests/test_torch_tuning.py pins the values).

Entries enter the table only through `promote` (a read-modify-write under
an fcntl lock with an atomic rename), and the supported promoter measures
candidates through the whole train step (kernels/tune.py).

Picks resolve once. JAX resolves a pick once per trace; the port launches
eagerly, so each resolved pick is memoized per (kind, shape, dtype,
device_kind) and its consult is recorded when it resolves, not on every
launch: a warmed launch does one dictionary lookup and no file-system
call. `clear_kernel_caches` drops the memo (and bwd_splits' lru_cache);
`force` and `promote` call it, so that the next launch resolves again. An
env override set after a pick resolved takes effect at the next clear.

KINDS keeps JAX's nine names, so that a JAX `tune` record's kind means the
same here. What each steers in the port:

  'plain'          kernel #3's i split (kernels/pairwise.py::fwd_i_per_split;
                   the heuristic is pairwise.i_per_split): blocks
                   (i_per_split,), shape (E, IF, O, P, mid). Admissible:
                   the splits the wide and mid-32 forwards take on whole
                   FWD_I_CHUNK (16-value) V2 chunks, IF itself, or the
                   narrow arm's whole NARROW_I_CHUNK chunks
                   (csrc/pairwise_fwd.cu's `vec` condition,
                   csrc/pairwise_narrow.cuh). Backward kernels A and B
                   keep their own heuristics (i_per_split, bwd_splits):
                   no entry reaches them, as in JAX.
  'flash_stream'   the plain kNN stream's node-chunk count
                   (kernels/flash.py::pick_stream_chunks), blocks (chunks,),
                   shape flash._shape_key. On a card #7's backward replays
                   this stream, so the pick is on the fuse_pairwise
                   training path; on the CPU the forward streams too.
  'flash_global'   the same for the global stream (7g's backward replay).
  'so2'            the node-axis chunk count of so2/contract.py and of
                   v2/conv.py when edge_chunks is None (so2.contract.
                   pick_so2_chunks); the heuristic's 1 runs unchunked.
  'bx', 'bxf'      kernels #2 and #1: blocks (EDGE_TILE, 64), the edges and
                   channels of a CTA's tile, fixed by the build.
  'attention',     kernels #5 and #6: blocks (1,), one kv row a warp,
  'attention_bwd'  fixed by the build.
  'flash'          kernel #7 (blocks (NODES, SLOTS) = (2, 32)) and 7g
                   ((8, 16): 8 query x 16 kv nodes, shape K = 0), fixed by
                   the build.

The last five take no runtime choice: each launch still records a
'heuristic' consult of its built tile (once per shape), and
`admissible_candidates` returns that one tile, so `kernel_tuning` lists
every pick as JAX's does and the tuner has nothing to measure there.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

CACHE_VERSION = 1

KINDS = ('plain', 'bx', 'bxf', 'attention', 'attention_bwd', 'so2',
         'flash', 'flash_stream', 'flash_global')

# the env override of each kind with a runtime choice (blocks[0])
ENV_OVERRIDES = {'plain': 'SE3_TORCH_I_PER_SPLIT',
                 'flash_stream': 'SE3_TORCH_FLASH_CHUNKS',
                 'flash_global': 'SE3_TORCH_FLASH_CHUNKS',
                 'so2': 'SE3_TORCH_SO2_CHUNKS'}

# the built tiles of the kinds that take no runtime choice
BUILT_TILES = {'bx': (64, 64), 'bxf': (64, 64), 'attention': (1,),
               'attention_bwd': (1,), 'flash': (2, 32)}
GLOBAL_TILE = (8, 16)   # 7g's, under kind 'flash' with K = 0

_lock = threading.Lock()
# kind -> (shape or None, dtype or None, blocks); None matches every pick
# of the kind (a test convenience: the tuner pins shape and dtype)
_forced: Dict[str, Tuple[Optional[Tuple[int, ...]], Optional[str],
                         Tuple[int, ...]]] = {}
# (kind, shape, dtype, source, blocks) -> count
_consults: Dict[Tuple, int] = {}
# (kind, shape, dtype, device_kind) -> blocks: the resolved picks; and
# (kind, shape, dtype, device, 'launch') -> blocks, as the launches ask
_memo: Dict[Tuple, Tuple[int, ...]] = {}
# path -> ((mtime_ns, size), entries)
_loaded: Dict[str, Tuple[Tuple[int, int], dict]] = {}


# --------------------------------------------------------------------- #
# the table file
# --------------------------------------------------------------------- #
def cache_dir() -> str:
    """$SE3_TORCH_CACHE_PATH (basis.cache_dir's variable), read per call;
    empty disables the table."""
    return os.environ.get('SE3_TORCH_CACHE_PATH', os.path.expanduser(
        '~/.cache/se3_transformer_torch'))


def cache_file() -> str:
    # the version is in the name: a bump orphans the old file
    return os.path.join(cache_dir(), f'kernel_blocks_v{CACHE_VERSION}.json')


def _key(kind: str, shape: Sequence[int], dtype: str,
         device_kind: str) -> str:
    return f'{kind}|{",".join(str(int(s)) for s in shape)}' \
           f'|{dtype}|{device_kind}'


_device_names: Dict[int, str] = {}


def current_device_kind(device=None) -> str:
    """The device identity of the table key: the card's name
    (torch.cuda.get_device_name) for a CUDA `device`, or with none given
    when a card is present; 'cpu' otherwise."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return 'cpu'
        device = torch.device('cuda', torch.cuda.current_device())
    device = torch.device(device)
    if device.type != 'cuda':
        return 'cpu'
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    name = _device_names.get(index)
    if name is None:
        name = _device_names[index] = torch.cuda.get_device_name(index)
    return name


def _parse(path: str) -> dict:
    """The entries of a table file; {} for a missing, corrupt or
    truncated file or one of another version."""
    try:
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and data.get('version') == CACHE_VERSION \
                and isinstance(data.get('entries'), dict):
            return dict(data['entries'])
    except Exception:  # noqa: BLE001 - a broken file is a miss
        pass
    return {}


def _load_entries(path: str) -> dict:
    try:
        st = os.stat(path)
    except OSError:
        return {}
    sig = (st.st_mtime_ns, st.st_size)
    with _lock:
        cached = _loaded.get(path)
        if cached is not None and cached[0] == sig:
            return cached[1]
    entries = _parse(path)
    with _lock:
        _loaded[path] = (sig, entries)
    return entries


def entries() -> dict:
    """The raw table ({key: {blocks, provenance}})."""
    return dict(_load_entries(cache_file())) if cache_dir() else {}


def lookup(kind: str, shape: Sequence[int], *, dtype: str = 'float32',
           device_kind: Optional[str] = None
           ) -> Optional[Tuple[Tuple[int, ...], str]]:
    """(blocks, 'forced' | 'cache') for (kind, shape, dtype, device), or
    None. The caller validates a 'cache' hit before adopting it."""
    shape = tuple(int(s) for s in shape)
    with _lock:
        forced = _forced.get(kind)
    if forced is not None:
        fshape, fdtype, fblocks = forced
        if (fshape is None or fshape == shape) and \
                (fdtype is None or fdtype == dtype):
            return tuple(fblocks), 'forced'
    if not cache_dir():
        return None
    ents = _load_entries(cache_file())
    if not ents:
        return None
    if device_kind is None:
        device_kind = current_device_kind()
    ent = ents.get(_key(kind, shape, dtype, device_kind))
    if not isinstance(ent, dict):
        return None
    blocks = ent.get('blocks')
    if (not isinstance(blocks, (list, tuple)) or not blocks
            or not all(isinstance(b, int) for b in blocks)):
        return None   # a malformed entry: a miss
    return tuple(blocks), 'cache'


def promote(kind: str, shape: Sequence[int], blocks: Sequence[int], *,
            dtype: str = 'float32', device_kind: Optional[str] = None,
            provenance: Optional[dict] = None) -> dict:
    """Write a measured winner into the table (read-modify-write under an
    fcntl lock, atomic rename); returns the stored entry. Drops the
    resolved picks, so that the next launch reads the entry."""
    if kind not in KINDS:
        raise ValueError(f'unknown kernel kind {kind!r} (known: {KINDS})')
    if not cache_dir():
        raise ValueError('SE3_TORCH_CACHE_PATH is empty: the table is off')
    if device_kind is None:
        device_kind = current_device_kind()
    prov = dict(provenance or {})
    prov.setdefault('time_utc',
                    time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime()))
    if 'code_rev' not in prov:
        from ..observability.metrics import _code_rev
        prov['code_rev'] = _code_rev()
    entry = dict(blocks=[int(b) for b in blocks], provenance=prov)
    path = cache_file()
    os.makedirs(cache_dir(), exist_ok=True)
    with open(os.path.join(cache_dir(), 'kernel_blocks.lock'), 'w') as lock:
        import fcntl
        fcntl.flock(lock, fcntl.LOCK_EX)
        # re-read inside the lock: the memo may be stale against another
        # writer
        existing = _parse(path)
        existing[_key(kind, shape, dtype, device_kind)] = entry
        tmp = f'{path}.{os.getpid()}.tmp'
        with open(tmp, 'w') as f:
            json.dump(dict(version=CACHE_VERSION, entries=existing), f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)
    with _lock:
        _loaded.pop(path, None)
    clear_kernel_caches()
    return entry


@contextlib.contextmanager
def force(kind: str, blocks: Sequence[int], *,
          shape: Optional[Sequence[int]] = None,
          dtype: Optional[str] = None):
    """Pin a candidate for one kind (below the env overrides, above the
    table). Pass the target `shape` and `dtype` so that only that pick
    takes it; shape None applies to every pick of the kind. Clears the
    resolved picks on entry and exit."""
    if kind not in KINDS:
        raise ValueError(f'unknown kernel kind {kind!r} (known: {KINDS})')
    with _lock:
        prior = _forced.get(kind)
        _forced[kind] = (None if shape is None
                         else tuple(int(s) for s in shape),
                         dtype, tuple(int(b) for b in blocks))
    clear_kernel_caches()
    try:
        yield
    finally:
        with _lock:
            if prior is None:
                _forced.pop(kind, None)
            else:
                _forced[kind] = prior
        clear_kernel_caches()


def _caches() -> List:
    """What clear_kernel_caches clears: the pick memo and the kernels'
    own memoized picks."""
    from . import pairwise
    return [_memo, pairwise.bwd_splits]


def clear_kernel_caches() -> int:
    """Drop every memo of a resolved pick (the pick memo, bwd_splits'
    lru_cache); returns the count of caches cleared. Raises if it cleared
    nothing: a silent no-op would let an A/B measure one program twice."""
    cleared = 0
    for cache in _caches():
        if isinstance(cache, dict):
            with _lock:
                cache.clear()
            cleared += 1
        elif hasattr(cache, 'cache_clear'):
            cache.cache_clear()
            cleared += 1
    if cleared == 0:
        raise RuntimeError('clear_kernel_caches cleared nothing: a block A/B '
                           'would measure the same program twice')
    return cleared


# --------------------------------------------------------------------- #
# resolving a pick
# --------------------------------------------------------------------- #
def pick(kind: str, shape: Sequence[int], dtype: str,
         heuristic: Callable[[], Sequence[int]], device=None
         ) -> Tuple[int, ...]:
    """The blocks of one pick: memoized per (kind, shape, dtype, device
    kind); on a miss, env override > forced > table (validated) >
    heuristic(), its consult recorded."""
    # a warmed launch: one lookup keyed by the call's own arguments
    launch_key = (kind, shape, dtype, device, 'launch') \
        if device is not None and type(shape) is tuple else None
    blocks = _memo.get(launch_key)
    if blocks is not None:
        return blocks
    shape = tuple(int(s) for s in shape)
    device_kind = current_device_kind(device)
    memo_key = (kind, shape, dtype, device_kind)
    blocks = _memo.get(memo_key)
    if blocks is not None:
        if launch_key is not None:
            with _lock:
                _memo[launch_key] = blocks
        return blocks
    source = None
    env = ENV_OVERRIDES.get(kind)
    if env and os.environ.get(env, ''):
        blocks, source = (max(1, int(os.environ[env])),), 'env'
    if source is None:
        hit = lookup(kind, shape, dtype=dtype, device_kind=device_kind)
        if hit is not None and (hit[1] == 'forced' or
                                validate_entry(kind, shape, hit[0])):
            blocks, source = hit
    if source is None:
        blocks, source = tuple(int(b) for b in heuristic()), 'heuristic'
    record_consult(kind, shape, dtype, source, blocks)
    with _lock:
        _memo[memo_key] = blocks
        if launch_key is not None:
            _memo[launch_key] = blocks
    return blocks


def built_tile(kind: str, shape: Sequence[int], dtype: str,
               blocks: Sequence[int], device=None) -> None:
    """Record (once per shape) the 'heuristic' consult of a kernel whose
    tile the build fixes."""
    pick(kind, shape, dtype, lambda: blocks, device)


# --------------------------------------------------------------------- #
# consult telemetry
# --------------------------------------------------------------------- #
def record_consult(kind: str, shape: Sequence[int], dtype: str,
                   source: str, blocks: Sequence[int]) -> None:
    """One resolution; source 'env' / 'forced' / 'cache' / 'heuristic'."""
    key = (kind, tuple(int(s) for s in shape), dtype, source,
           tuple(int(b) for b in blocks))
    with _lock:
        _consults[key] = _consults.get(key, 0) + 1


def reset_consults() -> None:
    with _lock:
        _consults.clear()


def consults() -> List[dict]:
    """Every distinct resolution since the last reset ({kernel, shape,
    dtype, source, blocks, count})."""
    return consults_since({})


def snapshot() -> Dict[Tuple, int]:
    """A marker for consults_since: consumers (the engine's warmup, the
    tuner) read their own deltas without resetting the shared log."""
    with _lock:
        return dict(_consults)


def consults_since(snap: Dict[Tuple, int]) -> List[dict]:
    """The consults recorded after `snap = snapshot()`."""
    with _lock:
        items = sorted(_consults.items())
    out = []
    for key, n in items:
        d = n - snap.get(key, 0)
        if d > 0:
            k, s, dt, src, b = key
            out.append(dict(kernel=k, shape=list(s), dtype=dt, source=src,
                            blocks=list(b), count=d))
    return out


def consult_summary(consult_list: Optional[List[dict]] = None) -> dict:
    """Counts per source and the non-heuristic resolutions spelled out."""
    cs = consults() if consult_list is None else consult_list
    by_source: Dict[str, int] = {}
    for c in cs:
        by_source[c['source']] = by_source.get(c['source'], 0) + c['count']
    adopted = [c for c in cs if c['source'] != 'heuristic']
    return dict(by_source=by_source, adopted=adopted,
                cache_entries=len(entries()))


# --------------------------------------------------------------------- #
# admission: what csrc/*.cu takes at launch
# --------------------------------------------------------------------- #
def _split_ladder(IF: int, chunk: int, whole: bool) -> List[int]:
    """The distinct i splits of IF on whole `chunk`s, fewest splits
    first: ceil(IF / s) rounded up to the chunk for s = 1, 2, ...; with
    `whole` the one-split value is IF itself (the wide tile's last
    chunk may be partial)."""
    out: List[int] = []
    for s in range(1, -(-IF // chunk) + 1):
        per = IF if whole and s == 1 else -(-(-(-IF // s)) // chunk) * chunk
        if per not in out:
            out.append(per)
    return out


def admissible_candidates(kind: str, shape: Sequence[int]
                          ) -> List[Tuple[int, ...]]:
    """The blocks a kernel takes at launch for this shape (what the tuner
    may measure), from the CUDA kernels' own legality:

      * 'plain' (E, IF, O, P, mid): O in NARROW_O takes the narrow arm's
        splits on whole NARROW_I_CHUNK chunks; every other O (the wide and
        mid-32 tiles) IF itself or a split on whole FWD_I_CHUNK chunks, so
        that every split starts on a 16-byte V2 chunk;
      * 'flash_stream' / 'flash_global' (n, ...): JAX's chunk-count
        ladders up to n;
      * 'so2' (n, ...): chunk counts 1, 2, 4, 8 up to n;
      * 'bx', 'bxf', 'attention', 'attention_bwd', 'flash': the built
        tile alone."""
    if kind == 'plain':
        from .pairwise import FWD_I_CHUNK, NARROW_I_CHUNK, NARROW_O
        E, IF, O, P, mid = (int(s) for s in shape)
        if O in NARROW_O:
            return [(p,) for p in _split_ladder(IF, NARROW_I_CHUNK, False)]
        return [(p,) for p in _split_ladder(IF, FWD_I_CHUNK, True)]
    if kind in ('flash_stream', 'flash_global', 'so2'):
        n = int(shape[0])
        ladder = {'so2': (1, 2, 4, 8),
                  'flash_stream': (1, 2, 4, 8, 16, 32, 64, 128),
                  'flash_global': (1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                   1024, 2048)}[kind]
        return [(c,) for c in ladder if c <= n]
    if kind == 'flash' and len(shape) > 1 and int(shape[1]) == 0:
        return [GLOBAL_TILE]
    if kind in BUILT_TILES:
        return [BUILT_TILES[kind]]
    raise ValueError(f'unknown kernel kind {kind!r} (known: {KINDS})')


def validate_entry(kind: str, shape: Sequence[int],
                   blocks: Sequence[int]) -> bool:
    """The gate a table hit passes before it is adopted: the blocks must
    be admissible for the shape. An inadmissible entry warns (the
    heuristic is used)."""
    ok = tuple(int(b) for b in blocks) in \
        set(admissible_candidates(kind, shape))
    if not ok:
        warnings.warn(
            f'kernel tuning table entry {kind}{tuple(shape)} -> '
            f'{tuple(blocks)} is not admissible; ignoring it (heuristic '
            f'pick used). Re-run python -m se3_transformer_torch.kernels.'
            f'tune or delete {cache_file()}', stacklevel=3)
    return ok


def target_arm(kind: str, shape: Sequence[int]) -> str:
    """The kernel arm a pick steers: #3's narrow, mid-32 or wide tile for
    'plain', else the kind (the tuner interleaves its targets over the
    arms)."""
    if kind != 'plain':
        return kind
    from .pairwise import MID, NARROW_O
    _, _, O, _, mid = (int(s) for s in shape)
    if O in NARROW_O:
        return 'plain:narrow'
    return 'plain:wide' if mid == MID else 'plain:mid32'
