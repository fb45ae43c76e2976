"""Streaming (flash-style) equivariant kNN attention with the pairwise
contraction rebuilt per edge: plain version, wrapper, and the
differentiable op.

Port of se3_transformer_tpu/kernels/pallas_flash.py::flash_attention in kNN
mode with both contraction arms. For one output degree d_out, per node i
and neighbor slot s (j = idx[i, s]), the dense arm is

    basis[p, q, f] = sum_m Y_J[i, s, m] Q_J[(p, q), m]      (J = |d_in - d_out| + f)
    z[p, (c, f)]   = sum_q basis[p, q, f] x_{d_in}[j, c, q]  (every input degree,
                                                           concatenated along i)
    kv[o, p]       = sum_i z[p, i] (h[i, s] . W3[:, i, o] + b3[i, o])

and the so2 arm (conv_backend='so2', from the edge frames of so2.frames)

    xr = D_{d_in}(R_e)^T x_{d_in}[j]        z = banded_z(xr) padded to P
    kv = D_{d_out}(R_e) (sum_i z[p, i] (h . W3[:, i, o] + b3[i, o]))

for the keys (h_k, wk, bk) and the values (h_v, wv, bv), then attention of
q over [prefix slots, neighbor slots] with the unfused path's semantics
(tied keys and values, tie_key_values: no wk, and the one kv block by
(h_v, wv, bv) serves as both):
masked slots take the finite float32 minimum (a fully masked row is the
uniform average), the prefix slots (here the self slot) are always valid.
The per-edge basis, the gathered features, k, v and the scores never exist
in device memory on the kernel path.

Layouts as in JAX: q [B, n, h, Dh] (Dh = dim_head * (2 d_out + 1),
(dim_head, m)-major); xs one [B, n, C, 2 d_in + 1] per input degree (the
`pairs` order); idx [B, n, K]; nmask [B, n, K] bool or None; h_v, h_k
[B, n, K, mid] (bf16 with the bf16 radial trunk); wv, wk [mid, IF, O] and
bv, bk [IF, O] float32, O = kv_heads * dim_head; sh the flash_sh_payload
stack [B, n, K, S] (dense arm); fr the packed frames [B, n, K, 4 L1]
(pack_frames, so2 arm); prefix_k, prefix_v [B, n, S0, kv_heads * Dh] or None
-> out [B, n, h, Dh] float32. The radial product is float32: bf16-valued h
times float32 W3, as the JAX einsum promotes it.

A CPU tensor takes the plain PyTorch version (`flash_attention_plain`, the
port of the JAX XLA stream `_flash_stream`: node chunks, n // 16 of them
unless the 'flash_stream' pick of kernels.tuning says otherwise,
`stream_rows`; the kernels record their built tiles' 'flash' consults). A
CUDA tensor launches the hand-written Hopper kernel of csrc/flash_fwd.cu
(`flash_attention_fwd`, whose `.launches` counts launches) or raises.
`flash_limit` (and `global_limit` for the global kernel), the fits
predicates, say from the configuration alone whether the kernel takes a
call, the counterpart of JAX's flash_admissible_blocks; past them the
attention layer runs the plain stream under autograd on the operands that
`flash_operands` (`flash_global_operands`) prepare, and counts the call in
the wrapper's `.routed` (routing.route).
`flash_attention` is the differentiable form, the torch.library custom op
`se3_torch::flash_attention`: it saves only its inputs, and its backward
replays the plain chunked stream under autograd, one node chunk at a time
(the port of `_flash_core_bwd`, which JAX runs in XLA too).

Global mode (`flash_global_attention`, the port of pallas_flash.py::
flash_global_attention, one arm for keys and values): no neighbor list;
every node attends to the prefix slots and to every other node, the pair
payload (distance, the inlined radial trunk of `_radial_apply`, the SH stack
or the frames) rebuilt from the coordinates [B, n, 3]. The plain version
(`flash_global_plain`, the JAX XLA stream in global mode) streams query-row
chunks, n // 16 of them; a CUDA tensor launches csrc/flash_global.cu
(`flash_global_attention_fwd`, with its own `.launches`). Its custom op
`se3_torch::flash_global_attention` saves only its inputs and replays the
plain stream in its backward.

Both kernels take tied keys and values (`FlashConfig.tie`, wk None) and
the so2 arm in compile-time variants of their own. Kernel #7 builds one arm
and one W3 storage for the keys and the values: mixed arms (to_k dense,
to_v so2) and mixed storage (one W3 quantized and one not, or int8 beside
fp8) are past flash_limit and route to the plain stream.

Quantized serving (se3_transformer_torch.quant): with `wv_scale` (and,
untied, `wk_scale`) float32 [1, IF, O], wv (wk) is int8 or float8_e4m3fn
storage and R = (h . w) * scale + b3, JAX's `_kv_block` epilogue, in both
arms, tied or not. The plain stream computes it in float32; on a card it
is kernel #7's scaled arm (csrc/flash_fwd.cu, se3_flash_fwd_q and
se3_flash_fwd_so2_q), which reads the 1-byte storage into its tile and
writes no dequantized W3; each of its launches counts in
`flash_attention_fwd.launches` and `.scaled_launches`. The arm serves only:
flash_attention with a scale calls the forward directly, and refuses
inputs that need a gradient.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..basis import basis_transformation_Q_J, safe_normalize
from ..so2.canonical import canonical_blocks
from ..so2.contract import banded_z
from ..so2.frames import FRAME_KEYS, edge_frames, j_matrix, rotate_in, \
    rotate_out
from ..so3.spherical_harmonics import real_spherical_harmonics_all
from ..utils.helpers import batched_index_select, device_constant
from .pairwise import QUANT_DTYPES, _aligned, _stream, serving_only

# the finite float32 minimum (pallas_flash.py::NEG_INF)
NEG_INF = float(torch.finfo(torch.float32).min)

# what csrc/flash_fwd.cu is built for
MID = 128            # radial hidden width
O_WIDTH = 64         # kv_heads * dim_head: one 64-wide output tile
MAX_SLOTS = 32       # neighbors per node (one 32-row slot block)
MAX_PREFIX = 4       # always-valid prefix slots
MAX_PAIRS = 4        # input degrees
MAX_DEGREE = 3       # d_in and d_out
MAX_HEADS = 8
MAX_SH = (2 * 2 * MAX_DEGREE + 1) ** 2
# node rows per chunk of the plain stream with no table entry
# (pallas_flash.py::_pick_stream_chunks' heuristic: n // 16 chunks)
STREAM_ROWS = 16


# the contraction arms (pallas_flash.py::ARMS)
ARMS = ('dense', 'so2')


class FlashConfig(NamedTuple):
    """Static configuration of one call: kNN or global mode, the keys' and
    the values' contraction arms, tied or untied keys and values
    (pallas_flash.py::FlashConfig's other fields are not ported)."""
    pairs: Tuple[Tuple[int, int], ...]  # (d_in, channels) per input degree
    d_out: int
    heads: int
    kv_heads: int
    scale: float
    prefix: int = 0                     # always-valid leading kv slots
    mode: str = 'knn'                   # 'knn' | 'global'
    exclude_self: bool = False          # global mode: mask the j == i slot
    tie: bool = False                   # keys ARE values (tie_key_values)
    arm_v: str = 'dense'                # 'dense' | 'so2'
    arm_k: str = 'dense'                # the keys' (tied: arm_v)


@lru_cache(maxsize=None)
def _pair_cg(d_in: int, d_out: int) -> np.ndarray:
    """Contraction constants turning the per-edge SH stack into the
    pairwise basis: T[s, p, q, f], s indexing the stack's rows of degrees
    lo..hi (degree J at rows J^2 - lo^2 .. (J+1)^2 - lo^2), so
    basis[.., p, q, f] = sum_s Y[.., lo^2 + s] T[s, p, q, f] is get_basis's
    Q_J contraction (pallas_flash.py::_pair_cg)."""
    lo, hi = abs(d_in - d_out), d_in + d_out
    P, Q = 2 * d_out + 1, 2 * d_in + 1
    F = 2 * min(d_in, d_out) + 1
    T = np.zeros(((hi + 1) ** 2 - lo ** 2, P, Q, F))
    for fi, J in enumerate(range(lo, hi + 1)):
        QJ = basis_transformation_Q_J(J, d_in, d_out)  # [(P*Q), 2J+1]
        T[J * J - lo * lo:(J + 1) * (J + 1) - lo * lo, :, :, fi] = \
            QJ.reshape(P, Q, 2 * J + 1).transpose(2, 0, 1)
    return T


@device_constant
def _pair_cg_tensor(d_in: int, d_out: int,
                    device: torch.device) -> torch.Tensor:
    """_pair_cg as a float32 tensor on `device`, made once (outside
    inference mode, so that it serves autograd later too)."""
    with torch.inference_mode(False):
        return torch.as_tensor(_pair_cg(d_in, d_out), dtype=torch.float32,
                               device=device)


def flash_sh_payload(rel_pos: torch.Tensor, max_degree: int,
                     differentiable: bool = False) -> torch.Tensor:
    """The dense arm's per-edge payload: real spherical harmonics
    J = 0..2*max_degree of the unit offsets stacked to
    [..., (2*max_degree + 1)^2], detached unless `differentiable`
    (pallas_flash.py::flash_sh_payload)."""
    Ys = real_spherical_harmonics_all(2 * max_degree, safe_normalize(rel_pos))
    out = torch.cat(Ys, dim=-1)
    return out if differentiable else out.detach()


def pack_frames(frames: dict) -> torch.Tensor:
    """so2 frames dict -> one [..., 4 * L1] tensor in FRAME_KEYS order (the
    kernel's layout, pallas_flash.py::pack_frames)."""
    return torch.cat([frames[k] for k in FRAME_KEYS], dim=-1)


def unpack_frames(packed: torch.Tensor) -> dict:
    L1 = packed.shape[-1] // 4
    return {k: packed[..., i * L1:(i + 1) * L1]
            for i, k in enumerate(FRAME_KEYS)}


def _arms(cfg: FlashConfig) -> set:
    """The arms a call runs: the values', and the keys' unless tied."""
    return {cfg.arm_v} | (set() if cfg.tie else {cfg.arm_k})


# --------------------------------------------------------------------- #
# the plain version (the JAX XLA stream)
# --------------------------------------------------------------------- #
def _contract_z(z, h, w3, b3, w3_scale=None) -> torch.Tensor:
    """The radial product of one slot block: z [..., P, IF], h [..., mid]
    -> [..., O, P], R = h . W3 + b3 in float32; with w3_scale [1, IF, O],
    W3 is quantized storage and R = (h . W3) * w3_scale + b3."""
    if w3_scale is None:
        R = torch.einsum('...m,mio->...io', h.float(), w3) + b3
    else:
        R = torch.einsum('...m,mio->...io', h.float(), w3.float()) \
            * w3_scale[0] + b3
    return torch.einsum('...pi,...io->...po', z, R).transpose(-1, -2)


def _kv_block(pairs, d_out: int, xg, h, sh, w3, b3,
              w3_scale=None) -> torch.Tensor:
    """One slot block's keyed features by the dense arm
    (pallas_flash.py::_kv_block): xg one gathered [..., C, Q] per input
    degree, h [..., mid], sh [..., S], w3 [mid, IF, O], b3 [IF, O] ->
    [..., O, P]. The same parameters and concatenation order as ConvSE3's
    grouped shared-radial contraction."""
    segs = []
    for (d_in, _), x in zip(pairs, xg):
        lo, hi = abs(d_in - d_out), d_in + d_out
        T = _pair_cg_tensor(d_in, d_out, x.device)
        y = sh[..., lo * lo:(hi + 1) * (hi + 1)]
        basis = torch.einsum('...s,spqf->...pqf', y, T)
        v2 = torch.einsum('...pqf,...cq->...pcf', basis, x)
        segs.append(v2.reshape(*v2.shape[:-2], -1))
    return _contract_z(torch.cat(segs, dim=-1), h, w3, b3, w3_scale)


def _kv_block_so2(pairs, d_out: int, xg, h, fr, w3, b3,
                  w3_scale=None) -> torch.Tensor:
    """The so2 arm of _kv_block: each input degree rotated into the edge
    frames `fr`, the band z padded to P, the radial product, the result
    rotated out -> [..., O, P]."""
    z = torch.cat([banded_z(rotate_in(x, fr, d_in), d_in, d_out)
                   for (d_in, _), x in zip(pairs, xg)], dim=-1)
    return rotate_out(_contract_z(z, h, w3, b3, w3_scale), fr, d_out)


def _attend_block(qr, kblk, vblk, maskblk, m, l, acc, scale, inbounds=None):
    """Fold one kv slot block into the online-softmax state
    (pallas_flash.py::_attend_block): qr [..., kv, g, D]; k/v
    [..., j, kv, D]; maskblk [..., j] or None (finite NEG_INF fill);
    inbounds [j] marks the slots that exist, the others get exactly zero
    weight; m/l [..., kv, g]; acc [..., kv, g, D]."""
    sim = torch.einsum('...kgd,...jkd->...kgj', qr, kblk) * scale
    if maskblk is not None:
        sim = sim.masked_fill(~maskblk[..., None, None, :], NEG_INF)
    if inbounds is not None:
        sim = sim.masked_fill(~inbounds, NEG_INF)
    m_new = torch.maximum(m, sim.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(sim - m_new[..., None])
    if inbounds is not None:
        p = p * inbounds.to(p.dtype)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + \
        torch.einsum('...kgj,...jkd->...kgd', p, vblk)
    return m_new, l_new, acc_new


def _init_state(qr, prefix_k, prefix_v, scale, Dh):
    """The online-softmax state after the always-valid prefix slots
    (pallas_flash.py::_init_state); NEG_INF / 0 / 0 without a prefix."""
    lead = qr.shape[:-1]
    m0 = torch.full(lead, NEG_INF, dtype=torch.float32, device=qr.device)
    l0 = torch.zeros(lead, dtype=torch.float32, device=qr.device)
    acc0 = torch.zeros((*lead, Dh), dtype=torch.float32, device=qr.device)
    if prefix_k is None:
        return m0, l0, acc0
    return _attend_block(qr, prefix_k, prefix_v, None, m0, l0, acc0, scale)


def _row_attention(cfg: FlashConfig, q, kf, vf, mask_full):
    """Full-row attention of one node chunk (q [..., h, D]; kf/vf
    [..., J, kv, D]; mask [..., J] or None): the online softmax's limit
    with one block, and the unfused einsum-softmax path's function
    (pallas_flash.py::_row_attention)."""
    group = cfg.heads // cfg.kv_heads
    qr = q.reshape(*q.shape[:-2], cfg.kv_heads, group, q.shape[-1])
    sim = torch.einsum('...kgd,...jkd->...kgj', qr, kf) * cfg.scale
    if mask_full is not None:
        sim = sim.masked_fill(~mask_full[..., None, None, :], NEG_INF)
    attn = sim.softmax(dim=-1)
    out = torch.einsum('...kgj,...jkd->...kgd', attn, vf)
    return out.reshape(q.shape)


def _kv_pair(cfg: FlashConfig, xg, h_k, h_v, sh, fr, full: dict, Dh: int):
    """(k, v) [..., kv_heads, Dh] of one block: the values' block by
    cfg.arm_v, and the keys' by (h_k, wk, bk) and cfg.arm_k, or the same
    block when cfg.tie (pallas_flash.py::_chunk_body)."""
    def block(arm, h, c):
        # the scale rides only when the weights are quantized
        w = (full[f'w{c}'], full[f'b{c}']) + tuple(
            s for s in (full.get(f'w{c}_scale'),) if s is not None)
        if arm == 'so2':
            t = _kv_block_so2(cfg.pairs, cfg.d_out, xg, h, fr, *w)
        else:
            t = _kv_block(cfg.pairs, cfg.d_out, xg, h, sh, *w)
        return t.reshape(*t.shape[:-2], cfg.kv_heads, Dh)
    kv_v = block(cfg.arm_v, h_v, 'v')
    if cfg.tie:
        return kv_v, kv_v
    return block(cfg.arm_k, h_k, 'k'), kv_v


# operands along the node axis (sliced into chunks) and node-level ones
_CHUNKED = ('q', 'idx', 'nmask', 'h_v', 'h_k', 'sh', 'fr', 'prefix_k',
            'prefix_v')
_FULL = ('xs', 'wv', 'bv', 'wk', 'bk', 'wv_scale', 'wk_scale')


def _chunk_body(cfg: FlashConfig, chunk: dict, full: dict) -> torch.Tensor:
    """One node chunk of the stream (pallas_flash.py::_chunk_body, kNN
    mode): gather, k and v by their arms, the prefix slots first, the row
    attention."""
    q = chunk['q']                                    # [B, nc, h, Dh]
    Dh, kv_h = q.shape[-1], cfg.kv_heads
    xg = tuple(batched_index_select(x, chunk['idx'], dim=1)
               for x in full['xs'])
    fr = unpack_frames(chunk['fr']) if chunk.get('fr') is not None else None
    kv_k, kv_v = _kv_pair(cfg, xg, chunk.get('h_k'), chunk['h_v'],
                          chunk.get('sh'), fr, full, Dh)
    nmask = chunk.get('nmask')
    if cfg.prefix:
        shape = (*q.shape[:-2], cfg.prefix, kv_h, Dh)
        kv_k = torch.cat((chunk['prefix_k'].reshape(shape), kv_k), dim=-3)
        kv_v = torch.cat((chunk['prefix_v'].reshape(shape), kv_v), dim=-3)
        if nmask is not None:
            ones = torch.ones((*nmask.shape[:-1], cfg.prefix),
                              dtype=torch.bool, device=nmask.device)
            nmask = torch.cat((ones, nmask), dim=-1)
    return _row_attention(cfg, q, kv_k, kv_v, nmask)


def _shape_key(cfg: FlashConfig, ops: dict) -> Tuple[int, ...]:
    """The block-config table's shape key of a call
    (pallas_flash.py::_shape_key): (n, K (0 in global mode), prefix,
    heads, kv_heads, Dh, mid, IF, 2 d_out + 1, the node features' row
    footprint in 128-value tiles)."""
    q = ops['q']
    knn = cfg.mode == 'knn'
    mid = ops['h_v'].shape[-1] if knn else ops['rp_v'][4].shape[0]
    xres = sum(-(-c * (2 * d + 1) // 128) * 128 for d, c in cfg.pairs)
    return (q.shape[1], ops['idx'].shape[-1] if knn else 0, cfg.prefix,
            cfg.heads, cfg.kv_heads, q.shape[-1], mid, ops['wv'].shape[1],
            2 * cfg.d_out + 1, xres)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace('torch.', '')


def pick_stream_chunks(kind: str, shape, dtype: str, device=None) -> int:
    """The plain stream's node-chunk count (pallas_flash.py::
    _pick_stream_chunks): the 'flash_stream' (kNN) or 'flash_global' pick
    of kernels.tuning, env SE3_TORCH_FLASH_CHUNKS > forced > table > the
    heuristic's n // STREAM_ROWS chunks (at least one)."""
    from . import tuning
    n = int(shape[0])
    return tuning.pick(kind, shape, dtype,
                       lambda: (max(1, n // STREAM_ROWS),), device)[0]


def stream_rows(cfg: FlashConfig, ops: dict) -> int:
    """Node rows per chunk of the plain stream (pick_stream_chunks' count
    of chunks), the last chunk ragged."""
    q = ops['q']
    n = q.shape[1]
    chunks = pick_stream_chunks(
        'flash_global' if cfg.mode == 'global' else 'flash_stream',
        _shape_key(cfg, ops), _dtype_name(q), q.device)
    return -(-n // max(1, min(chunks, n)))


def _slice(ops: dict, s: int, e: int) -> dict:
    return {k: ops[k][:, s:e] for k in _CHUNKED if ops.get(k) is not None}


def flash_attention_plain(cfg: FlashConfig, ops: dict) -> torch.Tensor:
    """The plain PyTorch version: the stream over node chunks
    (pallas_flash.py::_flash_stream), each chunk's per-edge tensors made
    and dropped in turn. `ops` holds the operands under the names of the
    module docstring."""
    n = ops['q'].shape[1]
    rows = stream_rows(cfg, ops)
    full = {k: ops.get(k) for k in _FULL}
    return torch.cat([_chunk_body(cfg, _slice(ops, s, min(s + rows, n)), full)
                      for s in range(0, n, rows)], dim=1)


# --------------------------------------------------------------------- #
# the kernel wrapper
# --------------------------------------------------------------------- #
@device_constant
def _cg_buffer(d_ins: Tuple[int, ...], d_out: int, device: torch.device):
    """The kernel's basis constants for the pairs into d_out: for each pair
    and each J = lo..hi, Q_J [(P*Q), 2J+1] row-major, concatenated; and
    each pair's offset into the buffer."""
    blocks, offsets, total = [], [], 0
    for d_in in d_ins:
        offsets.append(total)
        for J in range(abs(d_in - d_out), d_in + d_out + 1):
            QJ = basis_transformation_Q_J(J, d_in, d_out).ravel()
            blocks.append(QJ)
            total += QJ.size
    with torch.inference_mode(False):
        buf = torch.as_tensor(np.concatenate(blocks), dtype=torch.float32,
                              device=device)
    return buf, tuple(offsets)


# J_l (l = 1..MAX_DEGREE) at the head of the so2 arm's constants buffer
_J_OFFSETS = tuple(sum((2 * k + 1) ** 2 for k in range(1, l))
                   for l in range(1, MAX_DEGREE + 2))


@device_constant
def _so2_buffer(d_ins: Tuple[int, ...], d_out: int, device: torch.device):
    """The so2 arm's constants for the pairs into d_out: J_1 .. J_3
    row-major (J_l at _J_OFFSETS[l - 1]), then per pair its canonical
    blocks a and b [F, min(d_in, d_out) + 1] row-major; and each pair's
    offset of its a."""
    blocks = [j_matrix(l).ravel() for l in range(1, MAX_DEGREE + 1)]
    offsets, total = [], _J_OFFSETS[-1]
    for d_in in d_ins:
        offsets.append(total)
        for t in canonical_blocks(d_in, d_out):
            blocks.append(t.ravel())
            total += t.size
    with torch.inference_mode(False):
        buf = torch.as_tensor(np.concatenate(blocks), dtype=torch.float32,
                              device=device)
    return buf, tuple(offsets)


def _pairs_limit(pairs, d_out: int, prefix: int) -> Optional[str]:
    """The limits both kernels share: 1 to MAX_PAIRS input degrees, every
    degree <= MAX_DEGREE, at most MAX_PREFIX prefix slots."""
    if not 1 <= len(pairs) <= MAX_PAIRS:
        return (f'{len(pairs)} input degrees exceeds the kernel limit of 1 '
                f'to {MAX_PAIRS}')
    degree = max([d for d, _ in pairs] + [d_out])
    if degree > MAX_DEGREE:
        return f'degree {degree} exceeds the kernel limit of {MAX_DEGREE}'
    if prefix > MAX_PREFIX:
        return (f'{prefix} prefix slots exceeds the kernel limit of '
                f'{MAX_PREFIX}')
    return None


def flash_limit(pairs, d_out: int, heads: int, kv_heads: int, dim_head: int,
                K: int, prefix: int, mid: int = MID,
                h_dtype: torch.dtype = torch.float32,
                arms: Tuple[str, str] = ('dense', 'dense'),
                storages: Tuple[torch.dtype, torch.dtype] = (
                    torch.float32, torch.float32)) -> Optional[str]:
    """None when kernel #7 (csrc/flash_fwd.cu) takes a kNN call of this
    configuration, else the limit it exceeds: `pairs` (d_in, channels),
    K neighbor slots, the radial width mid and dtype of h, the keys' and
    the values' arms and W3 storage dtypes (the kernel builds one arm and
    one storage for both)."""
    limit = _pairs_limit(pairs, d_out, prefix)
    if limit is not None:
        return limit
    if arms[0] != arms[1]:
        return (f'mixed contraction arms (keys {arms[0]}, values {arms[1]}) '
                f'exceed the kernel, built with one arm for both')
    if storages[0] != storages[1]:
        return (f'mixed W3 storage (keys {storages[0]}, values '
                f'{storages[1]}) exceeds the kernel, built with one storage '
                f'for both')
    if heads != kv_heads or heads > MAX_HEADS \
            or heads * dim_head != O_WIDTH:
        return (f'heads {heads}, kv_heads {kv_heads}, dim_head {dim_head} '
                f'exceeds the built heads == kv_heads <= {MAX_HEADS} with '
                f'heads * dim_head = {O_WIDTH}')
    if not 1 <= K <= MAX_SLOTS:
        return f'K = {K} neighbors exceeds the kernel limit of {MAX_SLOTS}'
    if mid != MID or h_dtype not in (torch.bfloat16, torch.float32):
        return (f'h of width {mid} and dtype {h_dtype} exceeds the built '
                f'width {MID} in bfloat16 or float32')
    return None


def _check_xs(cfg: FlashConfig, xs, B: int, n: int) -> int:
    """The node features both kernels take: one float32 [B, n, C, 2 d + 1]
    per input degree; returns IF, the pairs' C * F summed."""
    if len(xs) != len(cfg.pairs):
        raise ValueError(f'got pairs {cfg.pairs} and {len(xs)} xs')
    IF = 0
    for (d_in, c), x in zip(cfg.pairs, xs):
        if x.dtype != torch.float32 \
                or tuple(x.shape) != (B, n, c, 2 * d_in + 1):
            raise ValueError(f'x of degree {d_in} must be float32 [{B}, {n}, '
                             f'{c}, {2 * d_in + 1}], got {x.dtype} '
                             f'{tuple(x.shape)}')
        IF += c * (2 * min(d_in, cfg.d_out) + 1)
    return IF


def _check_prefix(cfg: FlashConfig, ops: dict, B: int, n: int, width: int):
    """cfg.prefix slots of float32 [B, n, S0, width]."""
    S0 = cfg.prefix
    for name in ('prefix_k', 'prefix_v') if S0 else ():
        t = ops[name]
        if t.dtype != torch.float32 or tuple(t.shape) != (B, n, S0, width):
            raise ValueError(f'{name} must be float32 [{B}, {n}, {S0}, '
                             f'{width}], got {t.dtype} {tuple(t.shape)}')


def _check_placement(tensors, dev: torch.device):
    """Every operand on `dev` and contiguous."""
    for t in tensors:
        if t.device != dev:
            raise ValueError(f'an operand is on {t.device}, q on {dev}')
        if not t.is_contiguous():
            raise ValueError(f'operand of shape {tuple(t.shape)} must be '
                             f'contiguous')


def _pointers(ops: dict):
    """name -> the operand's device pointer, None for an absent one."""
    def ptr(name):
        t = ops.get(name)
        return None if t is None else t.data_ptr()
    return ptr


def _pair_args(cfg: FlashConfig, xs, device: torch.device):
    """The pairs as the kernels' C interfaces take them: the arm's
    constants buffer (the Q_J constants, or the so2 arm's J_l and canonical
    blocks), then the x pointers, degrees, channels and constant offsets,
    each padded to MAX_PAIRS."""
    make = _so2_buffer if cfg.arm_v == 'so2' else _cg_buffer
    cg, offsets = make(tuple(d for d, _ in cfg.pairs), cfg.d_out, device)
    pad = MAX_PAIRS - len(cfg.pairs)
    return (cg, [x.data_ptr() for x in xs] + [None] * pad,
            [d for d, _ in cfg.pairs] + [0] * pad,
            [c for _, c in cfg.pairs] + [0] * pad, list(offsets) + [0] * pad)


def _check(cfg: FlashConfig, ops: dict):
    """Shapes, dtypes, devices and contiguity the kernel takes; returns
    (B, n, K, S, S0, IF, h_is_bf16)."""
    q = ops['q']
    dev = q.device
    if q.dtype != torch.float32 or q.ndim != 4:
        raise TypeError(f'q must be float32 [B, n, h, Dh], got {q.dtype} '
                        f'{tuple(q.shape)}')
    B, n, H, Dh = q.shape
    P = 2 * cfg.d_out + 1
    if H != cfg.heads or Dh % P:
        raise ValueError(f'q must be [B, n, {cfg.heads}, dim_head * {P}], '
                         f'got {tuple(q.shape)}')
    idx = ops['idx']
    if idx.dtype != torch.int64 or idx.ndim != 3 or idx.shape[:2] != (B, n):
        raise ValueError(f'idx must be int64 [{B}, {n}, K], got {idx.dtype} '
                         f'{tuple(idx.shape)}')
    K = idx.shape[2]
    h_v, h_k = ops['h_v'], ops.get('h_k')
    kv_names = ('v',) if cfg.tie else ('k', 'v')
    if cfg.tie != (ops.get('wk') is None) or (cfg.tie and any(
            ops.get(k) is not None for k in ('h_k', 'bk'))):
        raise ValueError('tied keys and values take no h_k, wk or bk; '
                         'untied ones need wk and bk')
    if h_k is not None and h_k.dtype != h_v.dtype:
        raise TypeError(f'h_v/h_k must have one dtype, got '
                        f'{h_v.dtype}/{h_k.dtype}')
    w_k = ops['wv'] if cfg.tie else ops['wk']
    limit = flash_limit(cfg.pairs, cfg.d_out, cfg.heads, cfg.kv_heads,
                        Dh // P, K, cfg.prefix, h_v.shape[-1], h_v.dtype,
                        (cfg.arm_v if cfg.tie else cfg.arm_k, cfg.arm_v),
                        (w_k.dtype, ops['wv'].dtype))
    if limit is not None:
        raise ValueError(limit)
    IF = _check_xs(cfg, ops['xs'], B, n)
    nmask = ops.get('nmask')
    if nmask is not None and (nmask.dtype != torch.bool
                              or tuple(nmask.shape) != (B, n, K)):
        raise ValueError(f'nmask must be bool [{B}, {n}, {K}], got '
                         f'{nmask.dtype} {tuple(nmask.shape)}')
    for name in [f'h_{c}' for c in kv_names]:
        if tuple(ops[name].shape) != (B, n, K, MID):
            raise ValueError(f'{name} must be [{B}, {n}, {K}, {MID}], got '
                             f'{tuple(ops[name].shape)}')
    scaled = [ops.get(f'w{c}_scale') is not None for c in kv_names]
    if any(scaled) and not all(scaled):
        raise ValueError('the kernel takes the keys\' and the values\' W3 '
                         'both quantized or both float32')
    storage = ops['wv'].dtype
    for w, b in [(f'w{c}', f'b{c}') for c in kv_names]:
        want = QUANT_DTYPES if scaled[0] else (torch.float32,)
        if ops[w].dtype not in want or ops[w].dtype != storage \
                or ops[b].dtype != torch.float32 \
                or tuple(ops[w].shape) != (MID, IF, O_WIDTH) \
                or tuple(ops[b].shape) != (IF, O_WIDTH):
            raise ValueError(f'{w}/{b} must be one of {want} [{MID}, {IF}, '
                             f'{O_WIDTH}] / float32 [{IF}, {O_WIDTH}], got '
                             f'{ops[w].dtype} {tuple(ops[w].shape)} / '
                             f'{tuple(ops[b].shape)}')
        sc = ops.get(f'{w}_scale')
        if sc is not None and (sc.dtype != torch.float32
                               or sc.numel() != IF * O_WIDTH
                               or tuple(sc.shape[-2:]) != (IF, O_WIDTH)):
            raise ValueError(f'{w}_scale must be float32 [1, {IF}, '
                             f'{O_WIDTH}], got {sc.dtype} {tuple(sc.shape)}')
    # the arm's per-edge payload: the SH stack, or the packed frames
    degree = max([d for d, _ in cfg.pairs] + [cfg.d_out])
    if cfg.arm_v == 'so2':
        name, sh = 'fr', ops.get('fr')
        need, cap = 4 * (degree + 1), 4 * (MAX_DEGREE + 1)
        ok = sh is not None and sh.shape[-1] % 4 == 0
    else:
        name, sh = 'sh', ops.get('sh')
        need = (max(d for d, _ in cfg.pairs) + cfg.d_out + 1) ** 2
        cap, ok = MAX_SH, sh is not None
    if not ok or sh.dtype != torch.float32 or sh.ndim != 4 \
            or tuple(sh.shape[:3]) != (B, n, K) \
            or not need <= sh.shape[-1] <= max(cap, need):
        raise ValueError(f'{name} must be float32 [{B}, {n}, {K}, S] with '
                         f'{need} <= S, got '
                         f'{None if sh is None else (sh.dtype, sh.shape)}')
    S = sh.shape[-1]
    _check_prefix(cfg, ops, B, n, H * Dh)
    _check_placement([q, idx, sh, *ops['xs']]
                     + [ops[f'{k}{c}'] for c in kv_names
                        for k in ('h_', 'w', 'b')]
                     + [t for t in (nmask, ops.get('prefix_k'),
                                    ops.get('prefix_v'), ops.get('wv_scale'),
                                    ops.get('wk_scale')) if t is not None],
                     dev)
    return B, n, K, S, cfg.prefix, IF, h_v.dtype == torch.bfloat16


def flash_attention_fwd(cfg: FlashConfig, ops: dict) -> torch.Tensor:
    """The forward on `ops` (the module docstring's operands): the kernel on
    a card, the plain version on the CPU -> out [B, n, h, Dh] float32."""
    q = ops['q']
    if q.device.type == 'cpu':
        return flash_attention_plain(cfg, ops)
    if q.device.type != 'cuda':
        raise ValueError(f'no kernel for device {q.device}')
    B, n, K, S, S0, IF, bf16 = _check(cfg, ops)
    from . import tuning
    tuning.built_tile('flash', _shape_key(cfg, ops), _dtype_name(q),
                      tuning.BUILT_TILES['flash'], q.device)
    so2 = cfg.arm_v == 'so2'
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    cg, xs, ds, cs, offs = _pair_args(cfg, ops['xs'], q.device)
    # the kernel's 16-byte copies of h, W3 and b3 (and the scales)
    ops = dict(ops, **{k: _aligned(ops[k])
                       for k in ('h_v', 'h_k', 'wv', 'wk', 'bv', 'bk',
                                 'wv_scale', 'wk_scale')
                       if ops.get(k) is not None})
    scaled = ops.get('wv_scale') is not None
    ptr = _pointers(ops)
    head = (q.data_ptr(), *xs, ptr('idx'), ptr('nmask'), ptr('h_v'),
            ptr('h_k'), ptr('wv'), ptr('wk'), ptr('bv'), ptr('bk'),
            ptr('fr' if so2 else 'sh'), ptr('prefix_k'), ptr('prefix_v'),
            cg.data_ptr(), out.data_ptr())
    ints = (*ds, *cs, *offs, len(cfg.pairs), B, n, K, S, S0, cfg.heads, IF,
            2 * cfg.d_out + 1, int(bf16), int(cfg.tie), int(so2))
    from .build import load_library
    with torch.cuda.device(q.device):
        lib = load_library()
        if scaled:
            # the 1-byte storage and its scales as they are: no split
            rc = (lib.se3_flash_fwd_so2_q if so2 else lib.se3_flash_fwd_q)(
                *head, ptr('wv_scale'), ptr('wk_scale'), *ints,
                int(ops['wv'].dtype == torch.float8_e4m3fn),
                float(cfg.scale), _stream(q))
        else:
            # W_k's (untied) and W_v's bf16 hi and lo halves, split in the
            # launch
            convs = 1 if cfg.tie else 2
            w_split = torch.empty(2 * convs * MID * IF * O_WIDTH,
                                  dtype=torch.bfloat16, device=q.device)
            rc = (lib.se3_flash_fwd_so2 if so2 else lib.se3_flash_fwd)(
                *head, w_split.data_ptr(), *ints, float(cfg.scale),
                _stream(q))
    if rc != 0:
        raise RuntimeError(f'se3_flash_fwd launch failed: CUDA error {rc}')
    flash_attention_fwd.launches += 1
    flash_attention_fwd.so2_launches += so2
    flash_attention_fwd.scaled_launches += scaled
    return out


# every launch counts in .launches, the so2 arm's in .so2_launches too, the
# scaled arm's in .scaled_launches
flash_attention_fwd.launches = 0
flash_attention_fwd.so2_launches = 0
flash_attention_fwd.scaled_launches = 0
flash_attention_fwd.routed = 0


# --------------------------------------------------------------------- #
# the differentiable op
# --------------------------------------------------------------------- #
def _ops(q, xs, idx, nmask, h_v, h_k, wv, bv, wk, bk, sh, fr, prefix_k,
         prefix_v, wv_scale=None, wk_scale=None):
    return dict(q=q, xs=tuple(xs), idx=idx, nmask=nmask, h_v=h_v, h_k=h_k,
                wv=wv, bv=bv, wk=wk, bk=bk, sh=sh, fr=fr, prefix_k=prefix_k,
                prefix_v=prefix_v, wv_scale=wv_scale, wk_scale=wk_scale)


def _config(pairs, d_out, heads, kv_heads, scale, prefix_k, tie=False,
            arm_v='dense', arm_k='dense'):
    return FlashConfig(
        pairs=tuple((pairs[i], pairs[i + 1]) for i in range(0, len(pairs), 2)),
        d_out=d_out, heads=heads, kv_heads=kv_heads, scale=scale,
        prefix=0 if prefix_k is None else prefix_k.shape[2], tie=bool(tie),
        arm_v=arm_v, arm_k=arm_v if tie else arm_k)


@torch.library.custom_op('se3_torch::flash_attention', mutates_args=(),
                         device_types='cpu')
def _flash_op(q: torch.Tensor, xs: List[torch.Tensor], idx: torch.Tensor,
              nmask: Optional[torch.Tensor], h_v: torch.Tensor,
              h_k: Optional[torch.Tensor], wv: torch.Tensor, bv: torch.Tensor,
              wk: Optional[torch.Tensor], bk: Optional[torch.Tensor],
              sh: Optional[torch.Tensor], fr: Optional[torch.Tensor],
              prefix_k: Optional[torch.Tensor],
              prefix_v: Optional[torch.Tensor], pairs: List[int], d_out: int,
              heads: int, kv_heads: int, scale: float, arm_v: str,
              arm_k: str) -> torch.Tensor:
    cfg = _config(pairs, d_out, heads, kv_heads, scale, prefix_k, wk is None,
                  arm_v, arm_k)
    return flash_attention_plain(cfg, _ops(q, xs, idx, nmask, h_v, h_k, wv,
                                           bv, wk, bk, sh, fr, prefix_k,
                                           prefix_v))


@_flash_op.register_kernel('cuda')
def _(q, xs, idx, nmask, h_v, h_k, wv, bv, wk, bk, sh, fr, prefix_k,
      prefix_v, pairs, d_out, heads, kv_heads, scale, arm_v, arm_k):
    cfg = _config(pairs, d_out, heads, kv_heads, scale, prefix_k, wk is None,
                  arm_v, arm_k)
    return flash_attention_fwd(cfg, _ops(q, xs, idx, nmask, h_v, h_k, wv, bv,
                                         wk, bk, sh, fr, prefix_k, prefix_v))


_TENSOR_ARGS = ('q', 'xs', 'idx', 'nmask', 'h_v', 'h_k', 'wv', 'bv', 'wk',
                'bk', 'sh', 'fr', 'prefix_k', 'prefix_v')


def _flash_setup(ctx, inputs, output):
    (q, xs, idx, nmask, h_v, h_k, wv, bv, wk, bk, sh, fr, prefix_k, prefix_v,
     pairs, d_out, heads, kv_heads, scale, arm_v, arm_k) = inputs
    ctx.save_for_backward(q, idx, nmask, h_v, h_k, wv, bv, wk, bk, sh, fr,
                          prefix_k, prefix_v, *xs)
    ctx.cfg = _config(pairs, d_out, heads, kv_heads, scale, prefix_k,
                      wk is None, arm_v, arm_k)


def _flash_backward(ctx, g):
    """The port of pallas_flash.py::_flash_core_bwd: replay the plain
    chunked stream under autograd, one node chunk at a time, so that only
    one chunk's per-edge tensors exist at once; the chunk cotangents land
    in their slices, the node-level operands' are summed over the chunks
    in order."""
    (q, idx, nmask, h_v, h_k, wv, bv, wk, bk, sh, fr, prefix_k, prefix_v,
     *xs) = ctx.saved_tensors
    ops = _ops(q, xs, idx, nmask, h_v, h_k, wv, bv, wk, bk, sh, fr, prefix_k,
               prefix_v)
    needs = dict(zip(_TENSOR_ARGS, ctx.needs_input_grad))
    g = g.contiguous()
    grads = {}
    with torch.enable_grad():
        full = {}
        for k in _FULL:
            want = needs.get(k) if k != 'xs' else list(needs['xs'])
            if k == 'xs':
                full[k] = tuple(x.detach().requires_grad_(w)
                                for x, w in zip(ops[k], want))
            elif ops[k] is not None:
                full[k] = ops[k].detach().requires_grad_(want)
        n = q.shape[1]
        rows = stream_rows(ctx.cfg, ops)
        for s in range(0, n, rows):
            e = min(s + rows, n)
            chunk = {k: t.detach().requires_grad_(
                needs[k] and t.is_floating_point())
                for k, t in _slice(ops, s, e).items()}
            leaves = [(k, t) for k, t in chunk.items() if t.requires_grad]
            leaves += [(k, t) for k, t in full.items()
                       if k != 'xs' and t.requires_grad]
            leaves += [(('xs', i), x) for i, x in enumerate(full['xs'])
                       if x.requires_grad]
            if not leaves:
                break
            out = _chunk_body(ctx.cfg, chunk, full)
            got = torch.autograd.grad(out, [t for _, t in leaves], g[:, s:e],
                                      allow_unused=True)
            for (key, t), d in zip(leaves, got):
                if d is None:
                    continue
                if key in _CHUNKED:
                    grads.setdefault(key, torch.zeros_like(ops[key]))
                    grads[key][:, s:e] = d
                elif key in grads:
                    grads[key] = grads[key] + d
                else:
                    grads[key] = d
    dxs = [grads.get(('xs', i)) for i in range(len(xs))]
    return (grads.get('q'), dxs, None, None, grads.get('h_v'),
            grads.get('h_k'), grads.get('wv'), grads.get('bv'),
            grads.get('wk'), grads.get('bk'), grads.get('sh'),
            grads.get('fr'), grads.get('prefix_k'), grads.get('prefix_v'),
            None, None, None, None, None, None, None)


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_operands(q, xs, idx, nmask, h_v, wv, bv, *, pairs, d_out, heads,
                   kv_heads, scale, arm_v='dense', arm_k=None, h_k=None,
                   wk=None, bk=None, sh=None, frames=None, prefix_k=None,
                   prefix_v=None, wv_scale=None, wk_scale=None):
    """flash_attention's arguments as the plain stream and the kernel take
    them: (FlashConfig, ops), every operand contiguous, the so2 frames
    packed (pack_frames); wv_scale / wk_scale make wv / wk quantized
    storage (the module docstring). flash_attention_plain(
    *flash_operands(...)) is the plain stream under autograd, the route of
    a configuration past flash_limit."""
    arm_k = arm_v if arm_k is None else arm_k
    tie = wk is None
    if tie and bk is not None:
        raise ValueError('tied keys and values (no wk) take no bk')
    arms = {arm_v} | (set() if tie else {arm_k})
    if not arms <= set(ARMS):
        raise ValueError(f'unknown contraction arm in {sorted(arms)} (known: '
                         f'{ARMS})')
    for name, sc in (('wv_scale', wv_scale), ('wk_scale', wk_scale)):
        if sc is not None and not isinstance(sc, torch.Tensor):
            raise TypeError(f'{name} must be a float32 tensor [1, IF, O], '
                            f'got {type(sc).__name__}')
    if tie and wk_scale is not None:
        raise ValueError('tied keys and values (no wk) take no wk_scale')
    if 'dense' in arms and sh is None:
        raise ValueError('the dense arm needs the sh payload')
    if 'so2' in arms and frames is None:
        raise ValueError('the so2 arm needs the edge frames')
    if (prefix_k is None) != (prefix_v is None):
        raise ValueError('prefix_k and prefix_v come together')

    def c(t):
        return None if t is None else t.contiguous()
    flat = [int(v) for pair in pairs for v in pair]
    cfg = _config(flat, int(d_out), int(heads), int(kv_heads), float(scale),
                  prefix_k, tie, arm_v, arm_k)
    # untied keys without their own hidden take h_v's; tied keys none
    h_k = None if tie else (h_v if h_k is None else h_k)
    fr = pack_frames(frames).contiguous() if 'so2' in arms else None
    return cfg, _ops(c(q), [c(x) for x in xs], c(idx), c(nmask), c(h_v),
                     c(h_k), c(wv), c(bv), c(wk), c(bk),
                     c(sh) if 'dense' in arms else None, fr, c(prefix_k),
                     c(prefix_v), c(wv_scale), c(wk_scale))


def flash_attention(q, xs, idx, nmask, h_v, wv, bv, **config) -> torch.Tensor:
    """Streaming kNN equivariant attention for ONE output degree, with the
    signature of pallas_flash.py::flash_attention (operands in the module
    docstring, any strides; the keywords of flash_operands: arm_v and arm_k
    'dense' with the SH stack sh, 'so2' with the edge frames dict frames);
    differentiable in q, xs, h_v, h_k, wv, bv, wk, bk, sh, frames and the
    prefix slots. h_k defaults to h_v; without wk (and bk, h_k) the keys
    are tied to the values. With wv_scale (wk_scale) the scaled arm on
    quantized storage: serving only, no gradient."""
    cfg, ops = flash_operands(q, xs, idx, nmask, h_v, wv, bv, **config)
    if ops['wv_scale'] is not None or ops['wk_scale'] is not None:
        serving_only('the quantized wv_scale / wk_scale arm',
                     *(ops[k] for k in _TENSOR_ARGS if k != 'xs'),
                     *ops['xs'])
        return flash_attention_fwd(cfg, ops)
    return _flash_op(*(list(ops[k]) if k == 'xs' else ops[k]
                       for k in _TENSOR_ARGS),
                     [v for pair in cfg.pairs for v in pair], cfg.d_out,
                     cfg.heads, cfg.kv_heads, cfg.scale, cfg.arm_v, cfg.arm_k)


# --------------------------------------------------------------------- #
# global mode: every node attends to every node, the pair payload rebuilt
# from coordinates (pallas_flash.py::flash_global_attention)
# --------------------------------------------------------------------- #
# what csrc/flash_global.cu is built for
GLOBAL_O_WIDTH = 16   # kv_heads * dim_head
GLOBAL_MAX_PIF = 256  # P * IF: V2 of a 64-pair tile beside the weight ring
GLOBAL_MAX_HEADS = 16


def _safe_dist(rel: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """|rel| with the square clamped at eps^2 (pallas_flash.py::_safe_dist):
    finite, with a zero gradient, at rel = 0."""
    return torch.sqrt(torch.clamp((rel ** 2).sum(-1), min=eps ** 2))


def _gelu_tanh(t: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    return 0.5 * t * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (t + 0.044715 * t ** 3)))


def _radial_ln(t: torch.Tensor, s: torch.Tensor, o: torch.Tensor):
    """_radial_apply's LayerNorm: the two-pass variance, eps 1e-6 (not
    flax's one-pass nn.LayerNorm)."""
    mu = t.mean(-1, keepdim=True)
    var = ((t - mu) ** 2).mean(-1, keepdim=True)
    return (t - mu) * torch.rsqrt(var + 1e-6) * s + o


def _radial_apply(x: torch.Tensor, rp) -> torch.Tensor:
    """The inlined radial trunk of the global tile, Dense -> LN -> GELU
    twice (pallas_flash.py::_radial_apply): x [..., 1], rp the 8-tuple
    (w1 [1, mid], b1, s1, o1, w2 [mid, mid] (in, out), b2, s2, o2), every
    1-D parameter [1, mid]."""
    w1, b1, s1, o1, w2, b2, s2, o2 = rp
    t = _gelu_tanh(_radial_ln(torch.matmul(x, w1) + b1, s1, o1))
    t = torch.matmul(t, w2) + b2
    return _gelu_tanh(_radial_ln(t, s2, o2))


def _sh_degree(cfg: FlashConfig) -> int:
    """The SH stack's degree: flash_sh_payload stacks J = 0..2*degree, and
    every pair needs J up to d_in + d_out (pallas_flash.py::_sh_degree)."""
    max_j = max(d_in + cfg.d_out for d_in, _ in cfg.pairs)
    return (max_j + 1) // 2


def _frame_degree(cfg: FlashConfig) -> int:
    """The frames' degree: every input degree and d_out
    (pallas_flash.py::_frame_degree)."""
    return max([cfg.d_out] + [d for d, _ in cfg.pairs])


def _global_edge_payload(cfg: FlashConfig, rel, rp_v, rp_k):
    """The radial hiddens through the inlined trunk and the payload of the
    active arms of a [..., 3] rel block (pallas_flash.py::
    _global_edge_payload): the SH stack for the dense arm, the frames for
    the so2 arm (a pair at distance zero takes the identity frame); h_k is
    None with tied keys and values."""
    ef = _safe_dist(rel)[..., None]
    h_v = _radial_apply(ef, rp_v)
    h_k = None if cfg.tie else _radial_apply(ef, rp_k)
    arms = _arms(cfg)
    sh = flash_sh_payload(rel, _sh_degree(cfg), differentiable=True) \
        if 'dense' in arms else None
    fr = edge_frames(rel, _frame_degree(cfg), differentiable=True) \
        if 'so2' in arms else None
    return h_v, h_k, sh, fr


# operands of the global stream along the query axis (sliced into chunks)
_GLOBAL_CHUNKED = ('q', 'prefix_k', 'prefix_v')


def _global_chunk_body(cfg: FlashConfig, rows: slice, ops: dict):
    """The query rows `rows` of the global stream (pallas_flash.py::
    _chunk_body, global branch): rel from the coordinates, the payload, k
    and v by their arm against every node, the column mask (node mask,
    and i != j by absolute ids), the prefix slots first, the row
    attention."""
    q = ops['q'][:, rows]                             # [B, nc, h, Dh]
    Dh, kv_h = q.shape[-1], cfg.kv_heads
    coords = ops['coords']                            # [B, n, 3]
    n = coords.shape[1]
    rel = coords[:, rows, None, :] - coords[:, None, :, :]
    h_v, h_k, sh, fr = _global_edge_payload(cfg, rel, ops['rp_v'],
                                            ops['rp_k'])
    xg = tuple(x[:, None].expand(x.shape[0], q.shape[1], *x.shape[1:])
               for x in ops['xs'])
    kv_k, kv_v = _kv_pair(cfg, xg, h_k, h_v, sh, fr, ops, Dh)
    nmask = None
    if ops.get('node_mask') is not None:
        nmask = ops['node_mask'][:, None, :]
    if cfg.exclude_self:
        ids = torch.arange(n, device=q.device)
        notself = (ids[rows][:, None] != ids[None, :])[None]
        nmask = notself if nmask is None else nmask & notself
    if nmask is not None:
        nmask = nmask.expand(*q.shape[:2], n)
    if cfg.prefix:
        shape = (*q.shape[:-2], cfg.prefix, kv_h, Dh)
        kv_k = torch.cat((ops['prefix_k'][:, rows].reshape(shape), kv_k),
                         dim=-3)
        kv_v = torch.cat((ops['prefix_v'][:, rows].reshape(shape), kv_v),
                         dim=-3)
        if nmask is not None:
            nmask = torch.cat((nmask.new_ones(*q.shape[:2], cfg.prefix),
                               nmask), dim=-1)
    return _row_attention(cfg, q, kv_k, kv_v, nmask)


def flash_global_plain(cfg: FlashConfig, ops: dict,
                       rows: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of the global kernel: the stream over
    query-row chunks (pallas_flash.py::_flash_stream in global mode, n //
    16 chunks), each chunk's [rows, n] pair tensors made and dropped in
    turn; rows = n is the materialized control arm. `ops` holds q, xs,
    coords, rp_v, rp_k (8-tuples; rp_k empty when tied), wv, bv, wk, bk
    (None when tied), node_mask, prefix_k and prefix_v under the names of
    flash_global_attention."""
    n = ops['q'].shape[1]
    rows = rows or stream_rows(cfg, ops)
    return torch.cat([_global_chunk_body(cfg, slice(s, min(s + rows, n)),
                                         ops)
                      for s in range(0, n, rows)], dim=1)


@device_constant
def _sh_norm_table(device: torch.device) -> torch.Tensor:
    """The real SH normalization constants K_lm (l, m <= 6, sqrt(2) in for
    m > 0) as float32 [7 * 7], l-major, for the kernel's in-tile SH."""
    from ..so3.spherical_harmonics import _norm_const
    table = np.zeros((7, 7))
    for l in range(7):
        for m in range(l + 1):
            table[l, m] = _norm_const(l, m)
    with torch.inference_mode(False):
        return torch.as_tensor(table.ravel(), dtype=torch.float32,
                               device=device)


def global_limit(pairs, d_out: int, heads: int, kv_heads: int,
                 dim_head: int, prefix: int) -> Optional[str]:
    """None when kernel 7g (csrc/flash_global.cu) takes a global call of
    this configuration, else the limit it exceeds."""
    limit = _pairs_limit(pairs, d_out, prefix)
    if limit is not None:
        return limit
    if heads != kv_heads or heads > GLOBAL_MAX_HEADS \
            or heads * dim_head != GLOBAL_O_WIDTH:
        return (f'heads {heads}, kv_heads {kv_heads}, dim_head {dim_head} '
                f'exceeds the built heads == kv_heads <= {GLOBAL_MAX_HEADS} '
                f'with heads * dim_head = {GLOBAL_O_WIDTH}')
    P = 2 * d_out + 1
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in pairs)
    if P * IF > GLOBAL_MAX_PIF:
        return f'P * IF = {P * IF} exceeds the kernel limit of {GLOBAL_MAX_PIF}'
    return None


def _check_global(cfg: FlashConfig, ops: dict):
    """Shapes, dtypes, devices and contiguity csrc/flash_global.cu takes;
    returns (B, n, S0, IF)."""
    q = ops['q']
    if q.dtype != torch.float32 or q.ndim != 4:
        raise TypeError(f'q must be float32 [B, n, h, Dh], got {q.dtype} '
                        f'{tuple(q.shape)}')
    B, n, H, Dh = q.shape
    P = 2 * cfg.d_out + 1
    if H != cfg.heads or Dh % P:
        raise ValueError(f'q must be [B, n, {cfg.heads}, dim_head * {P}], '
                         f'got {tuple(q.shape)}')
    if cfg.mode != 'global':
        raise ValueError(f'the global kernel runs global mode, not '
                         f'{cfg.mode!r}')
    kv_names = ('v',) if cfg.tie else ('k', 'v')
    if cfg.tie != (ops.get('wk') is None) or (cfg.tie and (
            ops.get('bk') is not None or ops.get('rp_k'))):
        raise ValueError('tied keys and values take no rp_k, wk or bk; '
                         'untied ones need all three')
    limit = global_limit(cfg.pairs, cfg.d_out, cfg.heads, cfg.kv_heads,
                         Dh // P, cfg.prefix)
    if limit is not None:
        raise ValueError(limit)
    IF = _check_xs(cfg, ops['xs'], B, n)
    coords = ops['coords']
    if coords.dtype != torch.float32 or tuple(coords.shape) != (B, n, 3):
        raise ValueError(f'coords must be float32 [{B}, {n}, 3], got '
                         f'{coords.dtype} {tuple(coords.shape)}')
    shapes = ((1, MID),) * 4 + ((MID, MID),) + ((1, MID),) * 3
    for name in [f'rp_{c}' for c in kv_names]:
        rp = ops[name]
        if len(rp) != 8 or any(t.dtype != torch.float32
                               or tuple(t.shape) != s
                               for t, s in zip(rp, shapes)):
            raise ValueError(f'{name} must be the 8-tuple of float32 trunk '
                             f'parameters of shapes {shapes}')
    for w, b in [(f'w{c}', f'b{c}') for c in kv_names]:
        if ops[w].dtype != torch.float32 or ops[b].dtype != torch.float32 \
                or tuple(ops[w].shape) != (MID, IF, GLOBAL_O_WIDTH) \
                or tuple(ops[b].shape) != (IF, GLOBAL_O_WIDTH):
            raise ValueError(f'{w}/{b} must be float32 [{MID}, {IF}, '
                             f'{GLOBAL_O_WIDTH}] / [{IF}, {GLOBAL_O_WIDTH}], '
                             f'got {tuple(ops[w].shape)} / '
                             f'{tuple(ops[b].shape)}')
    node_mask = ops.get('node_mask')
    if node_mask is not None and (node_mask.dtype != torch.bool
                                  or tuple(node_mask.shape) != (B, n)):
        raise ValueError(f'node_mask must be bool [{B}, {n}], got '
                         f'{node_mask.dtype} {tuple(node_mask.shape)}')
    _check_prefix(cfg, ops, B, n, H * Dh)
    _check_placement([q, coords, *ops['xs'], *ops['rp_v'], *ops['rp_k']]
                     + [ops[f'{k}{c}'] for c in kv_names for k in ('w', 'b')]
                     + [t for t in (node_mask, ops.get('prefix_k'),
                                    ops.get('prefix_v')) if t is not None],
                     q.device)
    return B, n, cfg.prefix, IF


def _pack_trunks(rp_k, rp_v) -> torch.Tensor:
    """The trunks' parameters as the kernel reads them: per trunk (keys,
    then values; the values' alone when rp_k is empty, tied) the seven
    [mid] vectors w1, b1, s1, o1, b2, s2, o2, then w2 [mid, mid] (in,
    out), float32."""
    parts = []
    for w1, b1, s1, o1, w2, b2, s2, o2 in ((rp_k, rp_v) if rp_k
                                            else (rp_v,)):
        parts += [w1, b1, s1, o1, b2, s2, o2, w2]
    return torch.cat([t.reshape(-1) for t in parts])


def flash_global_attention_fwd(cfg: FlashConfig, ops: dict) -> torch.Tensor:
    """The global forward on `ops` (flash_global_plain's operands): the
    kernel of csrc/flash_global.cu on a card, the plain stream on the CPU
    -> out [B, n, h, Dh] float32."""
    q = ops['q']
    if q.device.type == 'cpu':
        return flash_global_plain(cfg, ops)
    if q.device.type != 'cuda':
        raise ValueError(f'no kernel for device {q.device}')
    B, n, S0, IF = _check_global(cfg, ops)
    from . import tuning
    tuning.built_tile('flash', _shape_key(cfg, ops), _dtype_name(q),
                      tuning.GLOBAL_TILE, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    cg, xs, ds, cs, offs = _pair_args(cfg, ops['xs'], q.device)
    so2 = cfg.arm_v == 'so2'
    rp = _pack_trunks(ops['rp_k'], ops['rp_v'])
    # the weight stream, packed in the launch: per stage one trunk's W2
    # half or 4 values of i of W_k or W_v, as bf16 hi + lo [128][64] tiles
    # (32768 bytes); then b3 of each W3 stage (256 bytes); tied, the
    # values' trunk alone
    nc, trunks = -(-IF // 4), 1 if cfg.tie else 2
    w_split = torch.empty(trunks * ((2 + nc) * 32768 + nc * 256),
                          dtype=torch.uint8, device=q.device)

    ptr = _pointers(ops)
    from .build import load_library
    with torch.cuda.device(q.device):
        lib = load_library()
        rc = (lib.se3_flash_global_so2 if so2 else lib.se3_flash_global)(
            q.data_ptr(), *xs, ptr('coords'), ptr('node_mask'), rp.data_ptr(),
            ptr('wk'), ptr('wv'), ptr('bk'), ptr('bv'), ptr('prefix_k'),
            ptr('prefix_v'), cg.data_ptr(), _sh_norm_table(q.device).data_ptr(),
            out.data_ptr(), w_split.data_ptr(), *ds, *cs, *offs,
            len(cfg.pairs), B, n, S0,
            cfg.heads, IF, 2 * cfg.d_out + 1,
            _frame_degree(cfg) if so2 else 2 * _sh_degree(cfg),
            int(cfg.exclude_self), int(cfg.tie), int(so2), float(cfg.scale),
            _stream(q))
    if rc != 0:
        raise RuntimeError(f'se3_flash_global launch failed: CUDA error {rc}')
    flash_global_attention_fwd.launches += 1
    flash_global_attention_fwd.so2_launches += so2
    return out


# every launch counts in .launches, the so2 arm's in .so2_launches too
flash_global_attention_fwd.launches = 0
flash_global_attention_fwd.so2_launches = 0
flash_global_attention_fwd.routed = 0


def _global_ops(q, xs, coords, rp_v, wv, bv, rp_k, wk, bk, node_mask,
                prefix_k, prefix_v):
    return dict(q=q, xs=tuple(xs), coords=coords, rp_v=tuple(rp_v), wv=wv,
                bv=bv, rp_k=tuple(rp_k), wk=wk, bk=bk, node_mask=node_mask,
                prefix_k=prefix_k, prefix_v=prefix_v)


def _global_config(pairs, d_out, heads, kv_heads, scale, prefix_k,
                   exclude_self, tie=False, arm='dense'):
    """Global mode runs one arm for the keys and the values (the JAX
    flash_global_attention's `arm`)."""
    return _config(pairs, d_out, heads, kv_heads, scale, prefix_k,
                   tie, arm, arm)._replace(mode='global',
                                           exclude_self=bool(exclude_self))


@torch.library.custom_op('se3_torch::flash_global_attention', mutates_args=(),
                         device_types='cpu')
def _global_op(q: torch.Tensor, xs: List[torch.Tensor], coords: torch.Tensor,
               rp_v: List[torch.Tensor], wv: torch.Tensor, bv: torch.Tensor,
               rp_k: List[torch.Tensor], wk: Optional[torch.Tensor],
               bk: Optional[torch.Tensor], node_mask: Optional[torch.Tensor],
               prefix_k: Optional[torch.Tensor],
               prefix_v: Optional[torch.Tensor], pairs: List[int],
               d_out: int, heads: int, kv_heads: int, scale: float,
               exclude_self: bool, arm: str) -> torch.Tensor:
    cfg = _global_config(pairs, d_out, heads, kv_heads, scale, prefix_k,
                         exclude_self, wk is None, arm)
    return flash_global_plain(cfg, _global_ops(
        q, xs, coords, rp_v, wv, bv, rp_k, wk, bk, node_mask, prefix_k,
        prefix_v))


@_global_op.register_kernel('cuda')
def _(q, xs, coords, rp_v, wv, bv, rp_k, wk, bk, node_mask, prefix_k,
      prefix_v, pairs, d_out, heads, kv_heads, scale, exclude_self, arm):
    cfg = _global_config(pairs, d_out, heads, kv_heads, scale, prefix_k,
                         exclude_self, wk is None, arm)
    return flash_global_attention_fwd(cfg, _global_ops(
        q, xs, coords, rp_v, wv, bv, rp_k, wk, bk, node_mask, prefix_k,
        prefix_v))


def _global_setup(ctx, inputs, output):
    (q, xs, coords, rp_v, wv, bv, rp_k, wk, bk, node_mask, prefix_k,
     prefix_v, pairs, d_out, heads, kv_heads, scale, exclude_self,
     arm) = inputs
    ctx.save_for_backward(q, coords, wv, bv, wk, bk, node_mask, prefix_k,
                          prefix_v, *xs, *rp_v, *rp_k)
    ctx.n_xs = len(xs)
    ctx.cfg = _global_config(pairs, d_out, heads, kv_heads, scale, prefix_k,
                             exclude_self, wk is None, arm)


def _global_backward(ctx, g):
    """The port of pallas_flash.py::_flash_core_bwd in global mode: replay
    the plain stream under autograd, one query-row chunk at a time, so
    that only one chunk's [rows, n] pair tensors exist at once; each
    chunk's gradients are added to the leaves' in chunk order."""
    (q, coords, wv, bv, wk, bk, node_mask, prefix_k, prefix_v,
     *rest) = ctx.saved_tensors
    xs, rp_v, rp_k = (rest[:ctx.n_xs], rest[ctx.n_xs:ctx.n_xs + 8],
                      rest[ctx.n_xs + 8:])
    (nq, nxs, ncoords, nrp_v, nwv, nbv, nrp_k, nwk, nbk, _, npk,
     npv) = ctx.needs_input_grad[:12]

    def leaf(t, want):
        return None if t is None else t.detach().requires_grad_(bool(want))
    ops = _global_ops(leaf(q, nq), [leaf(x, w) for x, w in zip(xs, nxs)],
                      leaf(coords, ncoords),
                      [leaf(t, w) for t, w in zip(rp_v, nrp_v)],
                      leaf(wv, nwv), leaf(bv, nbv),
                      [leaf(t, w) for t, w in zip(rp_k, nrp_k)],
                      leaf(wk, nwk), leaf(bk, nbk), node_mask,
                      leaf(prefix_k, npk), leaf(prefix_v, npv))
    leaves = [t for k, v in ops.items() if k != 'node_mask'
              for t in (v if isinstance(v, tuple) else (v,))
              if t is not None and t.requires_grad]
    g = g.contiguous()
    n = q.shape[1]
    rows = stream_rows(ctx.cfg, ops)
    if leaves:
        with torch.enable_grad():
            for s in range(0, n, rows):
                e = min(s + rows, n)
                out = _global_chunk_body(ctx.cfg, slice(s, e), ops)
                torch.autograd.backward(out, g[:, s:e], inputs=leaves)

    def grad(t):
        return None if t is None else t.grad
    return (grad(ops['q']), [grad(x) for x in ops['xs']],
            grad(ops['coords']), [grad(t) for t in ops['rp_v']],
            grad(ops['wv']), grad(ops['bv']),
            [grad(t) for t in ops['rp_k']], grad(ops['wk']),
            grad(ops['bk']), None, grad(ops['prefix_k']),
            grad(ops['prefix_v']), None, None, None, None, None, None, None)


_global_op.register_autograd(_global_backward, setup_context=_global_setup)


def flash_global_operands(q, xs, coords, rp_v, wv, bv, *, pairs, d_out,
                          heads, kv_heads, scale, arm='dense', rp_k=None,
                          wk=None, bk=None, node_mask=None, prefix_k=None,
                          prefix_v=None, exclude_self=True):
    """flash_global_attention's arguments as the plain stream and the
    kernel take them: (FlashConfig, ops), every operand contiguous, the
    trunks' 1-D leaves as [1, mid]; without wk (and rp_k, bk) the keys are
    tied to the values; `arm` ('dense' or 'so2') serves the keys and the
    values. flash_global_plain(*flash_global_operands(...)) is the plain
    stream in its row chunks under autograd, the route of a configuration
    past global_limit."""
    if arm not in ARMS:
        raise ValueError(f'unknown contraction arm {arm!r} (known: {ARMS})')
    tie = wk is None
    if tie and (bk is not None or rp_k is not None):
        raise ValueError('tied keys and values (no wk) take no rp_k or bk')
    if not tie and rp_k is None:
        raise ValueError('untied keys need their radial params')
    if (prefix_k is None) != (prefix_v is None):
        raise ValueError('prefix_k and prefix_v come together')

    def c(t):
        return None if t is None else t.contiguous()

    def trunk(rp):
        return [c(p.reshape(1, -1) if p.ndim == 1 else p) for p in rp]
    flat = [int(v) for pair in pairs for v in pair]
    cfg = _global_config(flat, int(d_out), int(heads), int(kv_heads),
                         float(scale), prefix_k, exclude_self, tie, arm)
    return cfg, _global_ops(c(q), [c(x) for x in xs], c(coords), trunk(rp_v),
                            c(wv), c(bv), trunk(rp_k or ()), c(wk), c(bk),
                            c(node_mask), c(prefix_k), c(prefix_v))


def flash_global_attention(q, xs, coords, rp_v, wv, bv,
                           materialize=False, **config) -> torch.Tensor:
    """kNN-free global equivariant attention for ONE output degree, with
    the signature of pallas_flash.py::flash_global_attention (the keywords
    of flash_global_operands): q [B, n, h, Dh]; xs one [B, n, C, 2 d_in +
    1] per input degree (`pairs` order); coords [B, n, 3]; rp_v / rp_k the
    trunks' 8-tuples (1-D leaves taken as [1, mid]); wv, wk [mid, IF, O]
    and bv, bk [IF, O]; node_mask [B, n] bool (masks columns) or None;
    prefix_k / prefix_v [B, n, S0, kv_heads * Dh] or None -> out [B, n, h,
    Dh] float32. Every node attends to the prefix slots and every other
    node (every node with exclude_self False). Differentiable in every
    floating operand; saves only its inputs, and its backward replays the
    plain stream chunk by chunk.

    materialize=True is the control arm: the plain stream as one chunk
    (every [B, n, n, ...] pair tensor at once), differentiated by plain
    autograd."""
    cfg, ops = flash_global_operands(q, xs, coords, rp_v, wv, bv, **config)
    if materialize:
        return flash_global_plain(cfg, ops, rows=q.shape[1])
    return _global_op(*(list(v) if isinstance(v, tuple) else v
                        for v in ops.values()),
                      [v for pair in cfg.pairs for v in pair], cfg.d_out,
                      cfg.heads, cfg.kv_heads, cfg.scale, cfg.exclude_self,
                      cfg.arm_v)
