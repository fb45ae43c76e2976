"""Per-m radial convolution, the SE3TransformerV2 contraction layer: the
port of se3_transformer_tpu/v2/conv.py.

The radial trunk emits the per-(+/-m) banded weight blocks directly
(EquiformerV2, arXiv:2306.12059). For a degree pair (d_in -> d_out) and
each m <= min(d_in, d_out) the learned per-edge kernel is the 2x2 block

    [[a, b], [-b, a]]   on the (d_in - m, d_in + m) components of the
                        edge-frame features,

with (a, b) produced per (channel, output channel) by R_m = h @ wm + bm.
Both the block and the frame rotation's Dz blocks lie in span{I, [[0, 1],
[-1, 0]]} on each +/-m pair, so they commute: the layer is exactly
equivariant, and truncating at |m| <= max_m (EquiformerV2's mmax) zeroes
whole blocks at no equivariance cost.

Per output degree and m, every input degree whose band reaches m adds a
segment along the contracted axis K (fiber_in order): the m = 0 row
x_rot[..., d_in] (K = C) and, for m > 0, the rows [x_neg | x_pos] and
[x_pos | -x_neg] (K = 2C). One _radial_contract per (d_out, m) takes the
concatenated wm{m}_{d_in}_{d_out} [mid, K, c_out] and bm [K, c_out]: on a
card kernel #3 (and A and B under autograd) at mid 32 with P = 1 (m = 0)
or 2 (the -m, +m rows), the arms kernels.pairwise built for this family.
The band is assembled as neg[::-1] + [center] + pos, zero-padded to 2
d_out + 1 rows, and rotated out of the edge frame.

With edge_chunks=None the node-axis chunk count is the 'so2' pick of
kernels.tuning (so2.contract.pick_so2_chunks, keyed as JAX's layer keys
it), whose heuristic answers 1: unchunked. The
JAX layer tags its outputs checkpoint_name(..., 'conv_out') for a remat
trunk; V2 has no remat trunk, so nothing here needs the tag.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.conv import _radial_contract, add_radial_trunk, radial_hidden
from ..ops.core import LinearSE3, residual_se3
from ..ops.fiber import Fiber
from ..quant.qtensor import concat_weights
from ..so2.contract import pick_so2_chunks
from ..so2.frames import Frames, rotate_in, rotate_out
from ..utils.helpers import batched_index_select, masked_mean

Features = Dict[str, torch.Tensor]
EdgeInfo = Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                 Optional[torch.Tensor]]

# v2's compact trunk width: the per-m blocks are [mid, 2C, O] in place of
# v1's [mid, C*F, O], so a narrow trunk feeds them without starving the
# contraction (EquiformerV2 uses the same regime)
DEFAULT_V2_MID_DIM = 32


def v2_band_rows(d_in: int, d_out: int, max_m: Optional[int] = None) -> int:
    """Band rows a (d_in -> d_out) pair contributes: 2 M + 1 with M =
    min(d_in, d_out[, max_m])."""
    m = min(d_in, d_out)
    if max_m is not None:
        m = min(m, max_m)
    return 2 * m + 1


class V2ConvSE3(nn.Module):
    """Graph convolution over precomputed neighborhoods with the per-m
    radial parameterization (module docstring). ConvSE3's call contract
    with the edge frames (so2.frames.edge_frames) in place of the basis.
    Parameters under the flax names: the trunk's Dense_0 / LayerNorm_0 /
    Dense_1 / LayerNorm_1, wm{m}_{d_in}_{d_out} [mid, K, c_out] and
    bm{m}_{d_in}_{d_out} [K, c_out], self_interact."""

    def __init__(self, fiber_in: Fiber, fiber_out: Fiber,
                 self_interaction: bool = True, pool: bool = True,
                 edge_dim: int = 0, mid_dim: int = DEFAULT_V2_MID_DIM,
                 max_m: Optional[int] = None, pallas: Optional[bool] = None,
                 edge_chunks: Optional[int] = None, radial_bf16: bool = False,
                 conv_bf16: bool = False):
        super().__init__()
        if self_interaction and not pool:
            raise ValueError('must pool edges if followed with self '
                             'interaction')
        self.fiber_in, self.fiber_out = fiber_in, fiber_out
        self.pool = pool
        self.edge_dim = edge_dim
        self.max_m = max_m
        self.pallas = pallas
        self.edge_chunks = edge_chunks
        self.radial_dtype = torch.bfloat16 if radial_bf16 else None
        self.conv_bf16 = conv_bf16
        add_radial_trunk(self, 1 + edge_dim, mid_dim)
        self.max_din = max(d for d, _ in fiber_in)
        for d_out, m_out in fiber_out:
            for m in range(self.band_order(d_out) + 1):
                for d_in, m_in in self._reaching(d_out, m):
                    K = m_in if m == 0 else 2 * m_in
                    self.register_parameter(
                        f'wm{m}_{d_in}_{d_out}',
                        nn.Parameter(torch.zeros(mid_dim, K, m_out)))
                    self.register_parameter(
                        f'bm{m}_{d_in}_{d_out}',
                        nn.Parameter(torch.zeros(K, m_out)))
        self.self_interact = LinearSE3(fiber_in, fiber_out) \
            if self_interaction else None

    def band_order(self, d_out: int) -> int:
        """M, the +/-m reach of output degree d_out's band."""
        M = min(d_out, self.max_din)
        return M if self.max_m is None else min(M, self.max_m)

    def _reaching(self, d_out: int, m: int):
        """The input degrees (and channels) whose band with d_out reaches m,
        in fiber_in order."""
        return [(d_in, m_in) for d_in, m_in in self.fiber_in
                if min(d_in, d_out) >= m]

    def forward(self, inp: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, frames: Frames) -> Features:
        """inp {d: [b, n, c, 2d+1]}, edge_info (indices [b, n, k], mask [b,
        n, k] or None, edges [b, n, k, edge_dim] or None), rel_dist [b, n,
        k], frames the edge frames -> {d: [b, n, c_out, 2d+1]} (pooled;
        [b, n, k, c_out, 2d+1] with pool=False)."""
        neighbor_indices, neighbor_mask, edges = edge_info
        edge_features = rel_dist[..., None]
        if edges is not None:
            edge_features = torch.cat(
                (edge_features, edges.to(edge_features.dtype)), dim=-1)
        if edge_features.shape[-1] != 1 + self.edge_dim:
            raise ValueError(f'the conv takes edges of width {self.edge_dim}, '
                             f'got {edge_features.shape[-1] - 1}')
        hidden = radial_hidden(self, edge_features, self.radial_dtype)

        # gather and rotate into the edge frame once per input degree
        rotated = {str(d): rotate_in(batched_index_select(
            inp[str(d)], neighbor_indices, dim=1), frames, d)
            for d, _ in self.fiber_in}                # [b, n, k, c, 2d+1]

        # node-axis streaming rides _radial_contract's edge_chunks and
        # shares the so2 pick (one tuner knob for both families)
        chunks = self.edge_chunks
        if chunks is None:
            shape = (rel_dist.shape[1], max(c for _, c in self.fiber_in),
                     max(c for _, c in self.fiber_out),
                     max(d for d, _ in self.fiber_in),
                     max(d for d, _ in self.fiber_out),
                     -1 if self.max_m is None else int(self.max_m))
            chunks = pick_so2_chunks(
                shape, str(rel_dist.dtype).replace('torch.', ''),
                rel_dist.device)
            chunks = None if chunks <= 1 else chunks

        outputs = {}
        for d_out, _ in self.fiber_out:
            M = self.band_order(d_out)
            neg_rows, pos_rows, center = [], [], None
            for m in range(M + 1):
                rows_neg, rows_pos, wms, bms = [], [], [], []
                for d_in, _ in self._reaching(d_out, m):
                    wms.append(getattr(self, f'wm{m}_{d_in}_{d_out}'))
                    bms.append(getattr(self, f'bm{m}_{d_in}_{d_out}'))
                    xr = rotated[str(d_in)]
                    if m == 0:
                        rows_neg.append(xr[..., d_in])
                        continue
                    xneg, xpos = xr[..., d_in - m], xr[..., d_in + m]
                    rows_neg.append(torch.cat((xneg, xpos), dim=-1))
                    rows_pos.append(torch.cat((xpos, -xneg), dim=-1))
                # v2_m [..., rows, K]: rows (-m, +m) for m > 0
                v2_m = torch.stack([torch.cat(r, dim=-1) for r in
                                    (rows_neg, rows_pos) if r], dim=-2)
                out_m = _radial_contract(
                    hidden, concat_weights(wms, axis=1), torch.cat(bms, dim=0),
                    v2_m, chunks, self.conv_bf16,
                    self.pallas)                       # [..., rows, O]
                if m == 0:
                    center = out_m[..., 0, :]
                else:
                    neg_rows.append(out_m[..., 0, :])
                    pos_rows.append(out_m[..., 1, :])
            # rows d_out - M .. d_out + M carry the band; beyond (m past
            # max_m included) the rows are structurally zero
            band = torch.stack(neg_rows[::-1] + [center] + pos_rows, dim=-2)
            if d_out > M:
                band = nn.functional.pad(band, (0, 0, d_out - M, d_out - M))
            acc = rotate_out(band.transpose(-1, -2), frames, d_out)
            if self.pool:
                acc = masked_mean(acc, neighbor_mask, dim=2)
            outputs[str(d_out)] = acc

        if self.self_interact is not None:
            outputs = residual_se3(outputs, self.self_interact(inp))
        return outputs
