"""The banded SO(2) contraction, conv backend 'so2': the port of
se3_transformer_tpu/so2/contract.py.

The same function as the dense pairwise contraction up to the canonical
blocks (so2.canonical), with the same parameters (w3 [mid, C*F, O], b3
[C*F, O]) and output [..., O, P], through the eSCN factorization:

  1. rotate in   xr = D_in(R_e)^T x                       (frames.rotate_in)
  2. banded      z[p, (c, f)] = (Kc_f xr_c)[p]: elementwise multiplies on
                 the +/-m component pairs (banded_z)
  3. radial      ops.conv._radial_contract(h, w3, b3, z): kernel #3 on a
                 card, as the dense path's V2, its backward kernels A and B
  4. rotate out  out = D_out(R_e) out_rot                 (frames.rotate_out)

edge_chunks keeps the dense path's meaning; with None the node-axis chunk
count is the 'so2' pick of kernels.tuning (pick_so2_chunks, the port of
_pick_so2_chunks: env SE3_TORCH_SO2_CHUNKS > forced > table > the
heuristic's 1, unchunked).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F_

from ..utils.helpers import device_constant
from .canonical import canonical_blocks
from .frames import FRAME_KEYS, Frames, rotate_in, rotate_out


@device_constant
def _blocks(d_in: int, d_out: int, dtype: torch.dtype, device: torch.device):
    """canonical_blocks as tensors on `device`, made once."""
    a, b = canonical_blocks(d_in, d_out)
    with torch.inference_mode(False):
        return (torch.as_tensor(a, dtype=dtype, device=device),
                torch.as_tensor(b, dtype=dtype, device=device))


def banded_z(xr: torch.Tensor, d_in: int, d_out: int,
             pad_rows: bool = True) -> torch.Tensor:
    """The canonical banded kernels applied to edge-frame features: xr
    [..., C, Q] -> z [..., P, C * F] ((c, f) minor, as the dense path's
    V2). Rows with |m_out| > min(d_in, d_out) are zero and come from a pad;
    pad_rows=False returns only the B = 2 min(d_in, d_out) + 1 band rows."""
    a, b = _blocks(d_in, d_out, xr.dtype, xr.device)   # [F, mmin + 1]
    mmin = min(d_in, d_out)
    C = xr.shape[-2]
    xneg = xr[..., d_in - mmin:d_in + 1].flip(-1)[..., None, :]  # q = d_in - m
    xpos = xr[..., d_in:d_in + mmin + 1][..., None, :]           # q = d_in + m
    zneg = a * xneg + b * xpos                         # [..., C, F, mmin + 1]
    zpos = a * xpos - b * xneg
    # rows d_out - mmin .. d_out + mmin; the m = 0 row once (b[:, 0] = 0)
    band = torch.cat((zneg[..., 1:].flip(-1), zneg[..., :1], zpos[..., 1:]),
                     dim=-1)
    band = band.movedim(-1, -3)                        # [..., band, C, F]
    if pad_rows and d_out > mmin:
        band = F_.pad(band, (0, 0, 0, 0, d_out - mmin, d_out - mmin))
    return band.reshape(*band.shape[:-2], C * band.shape[-1])


def pick_so2_chunks(shape, dtype: str, device=None) -> int:
    """The node-axis chunk count of an so2 contraction whose edge_chunks is
    None (1 = unchunked, the heuristic: the banded working set is small;
    chunking is the memory ceiling for huge channel counts and the
    tuner's knob): the 'so2' pick of kernels.tuning, keyed as JAX keys it
    ((n, C, O, P, Q, F) here, V2ConvSE3's own key there)."""
    from ..kernels import tuning
    return tuning.pick('so2', shape, dtype, lambda: (1,), device)[0]


def so2_pair_contract(h: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                      frames: Frames, x: torch.Tensor, *, d_in: int,
                      d_out: int, edge_chunks: Optional[int] = None,
                      edge_frame_io: bool = False, conv_bf16: bool = False,
                      pallas: Optional[bool] = None) -> torch.Tensor:
    """One (d_in -> d_out) pair by the SO(2) reduction: h [b, n, k, mid],
    w3 [mid, C*F, O], b3 [C*F, O], x [b, n, k, C, Q] -> [b, n, k, O, P].
    Only the band rows go through the radial product, padded to P after.
    edge_frame_io: x is already in the edge frame and the output stays
    there (ConvSE3 rotates once per degree instead of once per pair).
    conv_bf16 and pallas as ops.conv._radial_contract takes them."""
    from ..ops.conv import _radial_contract, _stream_node_chunks
    mmin = min(d_in, d_out)
    if edge_chunks is None:
        C, Q = x.shape[-2], x.shape[-1]
        shape = (x.shape[1], C, w3.shape[-1], 2 * d_out + 1, Q,
                 2 * mmin + 1)
        edge_chunks = pick_so2_chunks(
            shape, str(x.dtype).replace('torch.', ''), x.device)
        edge_chunks = None if edge_chunks <= 1 else edge_chunks

    def contract(h_c, x_c, *frame_arrays):
        fr = dict(zip(FRAME_KEYS, frame_arrays))
        xr = x_c if edge_frame_io else rotate_in(x_c, fr, d_in)
        z = banded_z(xr, d_in, d_out, pad_rows=False)
        out = _radial_contract(h_c, w3, b3, z, None, conv_bf16,
                               pallas).transpose(-1, -2)
        if d_out > mmin:                               # [..., O, B] -> P
            out = F_.pad(out, (d_out - mmin, d_out - mmin))
        return out if edge_frame_io else rotate_out(out, fr, d_out)

    operands = (h, x) + (() if edge_frame_io
                         else tuple(frames[k] for k in FRAME_KEYS))
    return _stream_node_chunks(contract, operands, edge_chunks)
