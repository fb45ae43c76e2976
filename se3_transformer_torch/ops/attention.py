"""Multi-degree SE(3)-equivariant attention: the port of
se3_transformer_tpu/ops/attention.py's kNN paths and its kNN-free global
mode (AttentionSE3 with kv_heads == heads, and AttentionBlockSE3).

KV slot order along the neighbor axis is [self, neighbors], the self slot
(the to_self_k / to_self_v projections) only with attend_self; the
neighbor mask is left-padded with True over the self slot, and masked
logits are filled with the finite float32 minimum. The layers' defaults
are JAX's: attend_self=False and shared_radial_hidden=False (the kv convs'
per-pair radial trunks; fuse_pairwise and the global mode take the shared
one, as in JAX); fourier_encode_dist and edge_dim (the width of
edge_info's edges) reach the kv convs' edge features.
Three attention cores, one function:

  * the einsums (the JAX default, pallas_attention None or False);
  * pallas_attention=True: kernels.attention.fused_attention per degree,
    (dim_head, m) flattened into one feature axis and the heads folded into
    the batch;
  * fuse_pairwise=True: the kv convs in program mode and
    kernels.flash.flash_attention per degree (the JAX `_flash_call`): the
    per-edge basis, the gathered features, k, v and the scores stay inside
    the kernel. Same parameters as the unfused path.

attention_mode='global' (the JAX `_global_call`) takes no neighborhoods:
every node attends to every other node through
kernels.flash.flash_global_attention per degree, the kv convs in
global_radial program mode, the pair payload rebuilt from the coordinates
in basis['global_coords'] (columns masked by basis['global_mask']). The
always-valid prefix slots are [null, self] with use_null_kv (the null_k{d}
/ null_v{d} parameters, zeros at init) and attend_self, each only with its
field. Global features are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import attention as ka
from ..kernels import flash as kf
from ..kernels import routing
from ..kernels.attention import fused_attention
from ..kernels.flash import flash_attention, flash_global_attention
from ..utils.helpers import to_order
from .conv import ConvSE3, EdgeInfo
from .core import LinearSE3, NormSE3, residual_se3
from .fiber import Fiber

Features = Dict[str, torch.Tensor]


class AttentionSE3(nn.Module):
    def __init__(self, fiber: Fiber, dim_head: int = 64, heads: int = 8,
                 attend_self: bool = False, fourier_encode_dist: bool = False,
                 rel_dist_num_fourier_features: int = 4,
                 use_null_kv: bool = False,
                 pallas_attention: Optional[bool] = None,
                 shared_radial_hidden: bool = False,
                 edge_chunks: Optional[int] = None, fuse_basis: bool = False,
                 radial_bf16: bool = False, fuse_pairwise: bool = False,
                 attention_mode: str = 'knn',
                 global_materialize: bool = False, edge_dim: int = 0):
        super().__init__()
        if attention_mode not in ('knn', 'global'):
            raise ValueError(f"unknown attention_mode {attention_mode!r} "
                             f"(want 'knn' or 'global')")
        if use_null_kv and attention_mode != 'global':
            raise NotImplementedError("use_null_kv is ported for "
                                      "attention_mode='global' only")
        self.fiber, self.dim_head, self.heads = fiber, dim_head, heads
        self.pallas_attention = bool(pallas_attention)
        self.fuse_pairwise = fuse_pairwise
        self.attention_mode = attention_mode
        self.global_materialize = global_materialize
        self.use_null_kv = use_null_kv
        self.attend_self = attend_self
        hidden_fiber = fiber.to(dim_head * heads)
        self.to_q = LinearSE3(fiber, hidden_fiber)
        conv_kwargs = dict(pool=False, self_interaction=False,
                           radial_bf16=radial_bf16)
        if attention_mode == 'global':
            conv_kwargs.update(global_radial=True, shared_radial_hidden=True)
        elif fuse_pairwise:
            conv_kwargs.update(fuse_pairwise=True, shared_radial_hidden=True)
        else:
            conv_kwargs.update(fuse_basis=fuse_basis, edge_chunks=edge_chunks,
                               shared_radial_hidden=shared_radial_hidden)
        if attention_mode != 'global':
            conv_kwargs.update(
                fourier_encode_dist=fourier_encode_dist,
                num_fourier_features=rel_dist_num_fourier_features,
                edge_dim=edge_dim)
        elif fourier_encode_dist or edge_dim:
            raise ValueError('global attention consumes raw distances only '
                             '(no fourier or edge features)')
        self.to_v = ConvSE3(fiber, hidden_fiber, **conv_kwargs)
        self.to_k = ConvSE3(fiber, hidden_fiber, **conv_kwargs)
        if attend_self:
            self.to_self_k = LinearSE3(fiber, hidden_fiber)
            self.to_self_v = LinearSE3(fiber, hidden_fiber)
        if use_null_kv:
            for degree, _ in fiber:
                for name in ('null_k', 'null_v'):
                    self.register_parameter(
                        f'{name}{degree}', nn.Parameter(torch.zeros(
                            heads, dim_head, 2 * degree + 1)))
        project_out = not (heads == 1 and len(fiber.dims) == 1
                           and dim_head == fiber.dims[0])
        self.to_out = LinearSE3(hidden_fiber, fiber) if project_out else None

    def forward(self, features: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor]
                ) -> Features:
        if self.attention_mode == 'global':
            outputs = self._global_call(features, basis)
        elif self.fuse_pairwise:
            outputs = self._flash_call(features, edge_info, rel_dist, basis)
        else:
            outputs = self._unfused_call(features, edge_info, rel_dist, basis)
        if self.to_out is not None:
            outputs = self.to_out(outputs)
        return outputs

    def _unfused_call(self, features, edge_info, rel_dist, basis) -> Features:
        h, dh = self.heads, self.dim_head
        neighbor_mask = edge_info[1]
        queries = self.to_q(features)
        values = self.to_v(features, edge_info, rel_dist, basis)
        keys = self.to_k(features, edge_info, rel_dist, basis)
        self_keys, self_values = self._self_kv(features)

        outputs = {}
        for degree in features.keys():
            m = to_order(int(degree))
            q = queries[degree]
            b, n = q.shape[0], q.shape[1]
            # q [b, h, n, d, m]; k/v [b, h, n, j, d, m]
            q = q.reshape(b, n, h, dh, m).permute(0, 2, 1, 3, 4)
            k, v = [t.reshape(b, n, t.shape[2], h, dh, m)
                    .permute(0, 3, 1, 2, 4, 5)
                    for t in (keys[degree], values[degree])]
            if self.attend_self:
                s_k, s_v = [t.reshape(b, n, h, dh, m).permute(0, 2, 1, 3, 4)
                            [:, :, :, None]
                            for t in (self_keys[degree], self_values[degree])]
                k = torch.cat((s_k, k), dim=3)
                v = torch.cat((s_v, v), dim=3)
            J = k.shape[3]
            padded = None
            if neighbor_mask is not None:
                padded = F.pad(neighbor_mask, (J - neighbor_mask.shape[-1], 0),
                               value=True)

            if self.pallas_attention:
                # (dim_head, m) flattened into one feature axis (the logits
                # reduce over both), the heads folded into the batch; past
                # the kernels' limits on a card, their plain version
                args = (q.reshape(b * h, n, dh * m),
                        k.reshape(b * h, n, J, dh * m),
                        v.reshape(b * h, n, J, dh * m), padded, h,
                        dh ** -0.5)
                if routing.route(ka.fused_attention_fwd, q.device.type,
                                 ka.attention_limit(J, dh * m), (J, dh * m)):
                    out = ka.fused_attention_plain(*args)
                else:
                    out = fused_attention(*args)
                out = out.reshape(b, h, n, dh, m)
            else:
                sim = torch.einsum('bhidm,bhijdm->bhij', q, k) * dh ** -0.5
                if padded is not None:
                    sim = sim.masked_fill(~padded[:, None],
                                          torch.finfo(sim.dtype).min)
                attn = sim.softmax(dim=-1)
                out = torch.einsum('bhij,bhijdm->bhidm', attn, v)
            outputs[degree] = out.permute(0, 2, 1, 3, 4).reshape(
                b, n, h * dh, m)
        return outputs

    def _self_kv(self, features: Features):
        """The self slot's keys and values (None, None without
        attend_self)."""
        if not self.attend_self:
            return None, None
        return self.to_self_k(features), self.to_self_v(features)

    def _prefix_slots(self, degree: str, b: int, n: int,
                      self_keys: Optional[Features],
                      self_values: Optional[Features]):
        """The always-valid kv slots left of the neighbor axis
        (pallas_flash's prefix_k/prefix_v [b, n, S0, kv_h * Dh]) in the
        unfused concat order [null, self], each with its field; (None,
        None) with neither."""
        pre_k, pre_v = [], []
        if self.use_null_kv:
            for name, dst in (('null_k', pre_k), ('null_v', pre_v)):
                t = getattr(self, f'{name}{degree}')
                dst.append(t.reshape(1, 1, 1, -1).expand(b, n, 1, -1))
        if self_keys is not None:
            for t, dst in ((self_keys, pre_k), (self_values, pre_v)):
                dst.append(t[degree].reshape(b, n, 1, -1))
        if not pre_k:
            return None, None
        return torch.cat(pre_k, dim=2), torch.cat(pre_v, dim=2)

    def _global_call(self, features, basis) -> Features:
        """The kNN-free path (JAX AttentionSE3._global_call): the same
        parameters as the kNN paths, the kv convs returning their trunk's
        raw parameters and grouped w3/b3, and no edge_info, rel_dist or
        per-pair basis: the kernel rebuilds the pair payload from the
        coordinates per tile."""
        h = self.heads
        coords = basis['global_coords']
        node_mask = basis.get('global_mask')
        queries = self.to_q(features)
        v_prog = self.to_v(features, None, None, basis)
        k_prog = self.to_k(features, None, None, basis)
        self_keys, self_values = self._self_kv(features)

        outputs = {}
        for degree in features.keys():
            m = to_order(int(degree))
            Dh = self.dim_head * m
            b, n = features[degree].shape[:2]
            prefix_k, prefix_v = self._prefix_slots(degree, b, n, self_keys,
                                                    self_values)
            S0 = 0 if prefix_k is None else prefix_k.shape[2]
            args = (queries[degree].reshape(b, n, h, Dh),
                    tuple(features[str(d_in)] for d_in, _ in v_prog['pairs']),
                    coords, v_prog['rp'], v_prog['w3'][degree],
                    v_prog['b3'][degree])
            config = dict(pairs=v_prog['pairs'], d_out=int(degree), heads=h,
                          kv_heads=h, scale=self.dim_head ** -0.5,
                          arm=v_prog['arm'], rp_k=k_prog['rp'],
                          wk=k_prog['w3'][degree], bk=k_prog['b3'][degree],
                          node_mask=node_mask, prefix_k=prefix_k,
                          prefix_v=prefix_v, exclude_self=True)
            limit = kf.global_limit(v_prog['pairs'], int(degree), h, h,
                                    self.dim_head, S0)
            # materialize runs the plain stream as one chunk anyway
            if not self.global_materialize and routing.route(
                    kf.flash_global_attention_fwd, coords.device.type, limit,
                    (v_prog['pairs'], int(degree), h, self.dim_head)):
                out = kf.flash_global_plain(
                    *kf.flash_global_operands(*args, **config))
            else:
                out = flash_global_attention(
                    *args, materialize=self.global_materialize, **config)
            outputs[degree] = out.reshape(b, n, h * self.dim_head, m)
        return outputs

    def _flash_call(self, features, edge_info, rel_dist, basis) -> Features:
        """The streaming path (JAX AttentionSE3._flash_call): the kv convs
        return their radial hidden and grouped w3/b3, and the kernel builds
        k and v per edge from the node features and the SH stack."""
        h = self.heads
        neighbor_indices, neighbor_mask, _ = edge_info
        queries = self.to_q(features)
        v_prog = self.to_v(features, edge_info, rel_dist, basis)
        k_prog = self.to_k(features, edge_info, rel_dist, basis)
        self_keys, self_values = self._self_kv(features)

        outputs = {}
        for degree in features.keys():
            m = to_order(int(degree))
            Dh = self.dim_head * m
            b, n = features[degree].shape[:2]
            prefix_k, prefix_v = self._prefix_slots(degree, b, n, self_keys,
                                                    self_values)
            S0 = 0 if prefix_k is None else prefix_k.shape[2]
            h_v, K = v_prog['h'], neighbor_indices.shape[-1]
            args = (queries[degree].reshape(b, n, h, Dh),
                    tuple(features[str(d_in)] for d_in, _ in v_prog['pairs']),
                    neighbor_indices, neighbor_mask, h_v,
                    v_prog['w3'][degree], v_prog['b3'][degree])
            config = dict(pairs=v_prog['pairs'], d_out=int(degree), heads=h,
                          kv_heads=h, scale=self.dim_head ** -0.5,
                          arm_v=v_prog['arm'], arm_k=k_prog['arm'],
                          h_k=k_prog['h'], wk=k_prog['w3'][degree],
                          bk=k_prog['b3'][degree], sh=basis['flash_sh'],
                          prefix_k=prefix_k, prefix_v=prefix_v)
            limit = kf.flash_limit(v_prog['pairs'], int(degree), h, h,
                                   self.dim_head, K, S0,
                                   h_v.shape[-1], h_v.dtype)
            if routing.route(kf.flash_attention_fwd, h_v.device.type, limit,
                             (v_prog['pairs'], int(degree), h,
                              self.dim_head, K)):
                out = kf.flash_attention_plain(
                    *kf.flash_operands(*args, **config))
            else:
                out = flash_attention(*args, **config)
            outputs[degree] = out.reshape(b, n, h * self.dim_head, m)
        return outputs


class AttentionBlockSE3(nn.Module):
    """Prenorm + attention + residual."""

    def __init__(self, fiber: Fiber, dim_head: int = 24, heads: int = 8,
                 attend_self: bool = False, use_null_kv: bool = False,
                 fourier_encode_dist: bool = False,
                 rel_dist_num_fourier_features: int = 4,
                 pallas_attention: Optional[bool] = None,
                 shared_radial_hidden: bool = False,
                 edge_chunks: Optional[int] = None, fuse_basis: bool = False,
                 radial_bf16: bool = False, fuse_pairwise: bool = False,
                 attention_mode: str = 'knn',
                 global_materialize: bool = False, edge_dim: int = 0):
        super().__init__()
        self.prenorm = NormSE3(fiber)
        self.attn = AttentionSE3(
            fiber, dim_head=dim_head, heads=heads, attend_self=attend_self,
            fourier_encode_dist=fourier_encode_dist,
            rel_dist_num_fourier_features=rel_dist_num_fourier_features,
            use_null_kv=use_null_kv, pallas_attention=pallas_attention,
            shared_radial_hidden=shared_radial_hidden or fuse_pairwise,
            edge_chunks=edge_chunks, fuse_basis=fuse_basis,
            radial_bf16=radial_bf16, fuse_pairwise=fuse_pairwise,
            attention_mode=attention_mode,
            global_materialize=global_materialize, edge_dim=edge_dim)

    def forward(self, features: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor]
                ) -> Features:
        out = self.attn(self.prenorm(features), edge_info, rel_dist, basis)
        return residual_se3(out, features)
