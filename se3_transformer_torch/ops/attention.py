"""Multi-degree SE(3)-equivariant attention: the port of
se3_transformer_tpu/ops/attention.py's kNN paths and its kNN-free global
mode (AttentionSE3, its one-headed kv variant, and AttentionBlockSE3).

KV slot order along the neighbor axis is [global, null, self, neighbors]:
the global slots (to_global_k / to_global_v of the global features, degree
0 only) with global features, the null slot (the null_k{d} / null_v{d}
parameters, zeros at init) with use_null_kv, the self slot (to_self_k /
to_self_v) with attend_self; the neighbor mask is left-padded with True
over them, and masked logits are filled with the finite float32 minimum.
Rotary embeddings (pos_emb) rotate the degree-0 q, k and v before the null
and global slots are prepended. The layers' defaults are JAX's:
attend_self=False and shared_radial_hidden=False (the kv convs' per-pair
radial trunks; fuse_pairwise and the global mode take the shared one, as in
JAX); fourier_encode_dist and edge_dim (the width of edge_info's edges)
reach the kv convs' edge features.

kv_heads (None: heads; 1: one kv head shared by every query head, the
multi-query variant that one_headed_key_values selects) sets the kv
fiber, dim_head * kv_heads. linear_proj_keys makes the keys a LinearSE3
of the node features gathered at the neighbors; tie_key_values makes them
the values themselves (no to_k). Three attention cores, one function:

  * the einsums (the JAX default, pallas_attention None or False);
  * pallas_attention=True: kernels.attention.fused_attention per degree,
    (dim_head, m) flattened into one feature axis, the query heads folded
    into the batch over their kv heads;
  * fuse_pairwise=True: the kv convs in program mode and
    kernels.flash.flash_attention per degree (the JAX `_flash_call`): the
    per-edge basis, the gathered features, k, v and the scores stay inside
    the kernel; the always-valid slots are its prefix. Same parameters as
    the unfused path. Each kv conv's backend (backend_v, backend_k) is its
    arm: the dense one reads basis['flash_sh'], the so2 one the edge
    frames basis['so2'].

attention_mode='global' (the JAX `_global_call`) takes no neighborhoods:
every node attends to every other node through
kernels.flash.flash_global_attention per degree, the kv convs in
global_radial program mode, the pair payload rebuilt from the coordinates
in basis['global_coords'] (columns masked by basis['global_mask']), the
[global, null, self] slots as its prefix. Rotary embeddings and
linear_proj_keys are refused there and with fuse_pairwise, as JAX does;
so is conv_bf16 (the stored-bf16 conv operands), which neither streaming
path materializes.

pallas=False (the JAX field) runs the kv convs' contractions, the
streaming kernel #7 and the global kernel 7g on their plain versions on
every device, with no launch and nothing counted in `.routed`; None and
True take the kernels on a card. pallas_attention keeps its own choice of
core.
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
from ..quant.qtensor import weight_or_none
from ..utils.helpers import batched_index_select, to_order
from .conv import ConvSE3, EdgeInfo
from .core import LinearSE3, NormSE3, residual_se3
from .fiber import Fiber
from .rotary import apply_rotary_pos_emb

Features = Dict[str, torch.Tensor]


# the JAX package's refusals of conv_bf16 where no conv operand is
# materialized (its ops/attention.py, the flash and global calls)
FUSED_CONV_BF16 = ('fuse_pairwise does not apply conv_bf16 (there is no '
                   'materialized V2/basis/gathered operand to store bf16 — '
                   'the knob would silently do nothing on this path)')
GLOBAL_CONV_BF16 = ('global attention has no materialized conv operand to '
                    'store bf16')


def _kernel_weight(w):
    """(storage, scale) of a grouped w3 for kernel #7: a QuantTensor's q and
    scale, else the weight as float32 and None (JAX's weight_or_none, with
    a bf16 cast upcast exactly)."""
    q, scale = weight_or_none(w)
    return (q, scale) if scale is not None else (q.float(), None)


class AttentionSE3(nn.Module):
    def __init__(self, fiber: Fiber, dim_head: int = 64, heads: int = 8,
                 kv_heads: Optional[int] = None, attend_self: bool = False,
                 fourier_encode_dist: bool = False,
                 rel_dist_num_fourier_features: int = 4,
                 use_null_kv: bool = False,
                 global_feats_dim: Optional[int] = None,
                 linear_proj_keys: bool = False,
                 tie_key_values: bool = False,
                 pallas_attention: Optional[bool] = None,
                 shared_radial_hidden: bool = False,
                 edge_chunks: Optional[int] = None, fuse_basis: bool = False,
                 radial_bf16: bool = False, fuse_pairwise: bool = False,
                 attention_mode: str = 'knn',
                 global_materialize: bool = False, edge_dim: int = 0,
                 backend_v: str = 'dense', backend_k: str = 'dense',
                 conv_bf16: bool = False, pallas: Optional[bool] = None):
        super().__init__()
        if attention_mode not in ('knn', 'global'):
            raise ValueError(f"unknown attention_mode {attention_mode!r} "
                             f"(want 'knn' or 'global')")
        if conv_bf16 and attention_mode == 'global':
            raise ValueError(GLOBAL_CONV_BF16)
        if conv_bf16 and fuse_pairwise:
            raise ValueError(FUSED_CONV_BF16)
        kv_h = heads if kv_heads is None else kv_heads
        if kv_h not in (1, heads):
            raise ValueError(f'kv_heads must be None, 1 or heads ({heads}), '
                             f'got {kv_heads}')
        if linear_proj_keys and tie_key_values:
            raise ValueError('cannot do linear projection of keys and tied '
                             'key/values together')
        if linear_proj_keys and attention_mode == 'global':
            raise ValueError('global attention needs conv keys '
                             '(linear_proj_keys gathers node-projected keys, '
                             'which presumes a neighbor list)')
        if linear_proj_keys and fuse_pairwise:
            raise ValueError('fuse_pairwise needs conv keys (linear_proj_keys '
                             'gathers node-projected keys instead)')
        self.fiber, self.dim_head, self.heads = fiber, dim_head, heads
        self.kv_heads = kv_h
        self.pallas_attention = bool(pallas_attention)
        self.fuse_pairwise = fuse_pairwise
        self.attention_mode = attention_mode
        self.global_materialize = global_materialize
        self.use_null_kv = use_null_kv
        self.attend_self = attend_self
        self.linear_proj_keys = linear_proj_keys
        self.tie_key_values = tie_key_values
        self.pallas = pallas
        hidden_fiber = fiber.to(dim_head * heads)
        kv_fiber = fiber.to(dim_head * kv_h)
        self.to_q = LinearSE3(fiber, hidden_fiber)
        conv_kwargs = dict(pool=False, self_interaction=False,
                           radial_bf16=radial_bf16, conv_bf16=conv_bf16,
                           pallas=pallas)
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
        self.to_v = ConvSE3(fiber, kv_fiber, backend=backend_v, **conv_kwargs)
        if linear_proj_keys:
            self.to_k = LinearSE3(fiber, kv_fiber)
        elif not tie_key_values:
            self.to_k = ConvSE3(fiber, kv_fiber, backend=backend_k,
                                **conv_kwargs)
        if attend_self:
            self.to_self_k = LinearSE3(fiber, kv_fiber)
            self.to_self_v = LinearSE3(fiber, kv_fiber)
        if use_null_kv:
            for degree, _ in fiber:
                for name in ('null_k', 'null_v'):
                    self.register_parameter(
                        f'{name}{degree}', nn.Parameter(torch.zeros(
                            kv_h, dim_head, 2 * degree + 1)))
        if global_feats_dim is not None:
            g_in = Fiber.create(1, global_feats_dim)
            g_out = Fiber.create(1, dim_head * kv_h)
            self.to_global_k = LinearSE3(g_in, g_out)
            self.to_global_v = LinearSE3(g_in, g_out)
        project_out = not (heads == 1 and len(fiber.dims) == 1
                           and dim_head == fiber.dims[0])
        self.to_out = LinearSE3(hidden_fiber, fiber) if project_out else None

    def forward(self, features: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor],
                global_feats: Optional[Features] = None,
                pos_emb=None) -> Features:
        """global_feats {'0': [b, num_global, global_feats_dim, 1]} adds
        the global slots; pos_emb (query [b, n, r], key [b, n, 1 + K, r])
        the rotary phases of the degree-0 q, k and v (kNN cores only)."""
        if global_feats is not None and not hasattr(self, 'to_global_k'):
            raise ValueError('global features were given but '
                             'global_feats_dim is not set')
        if pos_emb is not None and self.attention_mode == 'global':
            raise ValueError('global attention does not support rotary '
                             'embeddings')
        if pos_emb is not None and self.fuse_pairwise:
            raise ValueError('fuse_pairwise does not support rotary '
                             'embeddings (they rewrite k/v per slot before '
                             'the null/global prepends)')
        global_kv = (None, None) if global_feats is None else \
            (self.to_global_k(global_feats), self.to_global_v(global_feats))
        if self.attention_mode == 'global':
            outputs = self._global_call(features, basis, global_kv)
        elif self.fuse_pairwise:
            outputs = self._flash_call(features, edge_info, rel_dist, basis,
                                       global_kv)
        else:
            outputs = self._unfused_call(features, edge_info, rel_dist, basis,
                                         global_kv, pos_emb)
        if self.to_out is not None:
            outputs = self.to_out(outputs)
        return outputs

    def _keys(self, features, values, edge_info, rel_dist, basis):
        """The neighbor keys: the to_k conv, the to_k LinearSE3 gathered at
        the neighbors (linear_proj_keys), or the values (tie_key_values)."""
        if self.linear_proj_keys:
            return {d: batched_index_select(t, edge_info[0], dim=1)
                    for d, t in self.to_k(features).items()}
        if self.tie_key_values:
            return values
        return self.to_k(features, edge_info, rel_dist, basis)

    def _unfused_call(self, features, edge_info, rel_dist, basis, global_kv,
                      pos_emb) -> Features:
        h, kv_h, dh = self.heads, self.kv_heads, self.dim_head
        neighbor_mask = edge_info[1]
        queries = self.to_q(features)
        values = self.to_v(features, edge_info, rel_dist, basis)
        keys = self._keys(features, values, edge_info, rel_dist, basis)
        self_keys, self_values = self._self_kv(features)
        global_keys, global_values = global_kv

        outputs = {}
        for degree in features.keys():
            m = to_order(int(degree))
            q = queries[degree]
            b, n = q.shape[0], q.shape[1]
            # q [b, h, n, d, m]; k/v [b, kv_h, n, j, d, m]
            q = q.reshape(b, n, h, dh, m).permute(0, 2, 1, 3, 4)
            k, v = [t.reshape(b, n, t.shape[2], kv_h, dh, m)
                    .permute(0, 3, 1, 2, 4, 5)
                    for t in (keys[degree], values[degree])]
            if self.attend_self:
                s_k, s_v = [t.reshape(b, n, kv_h, dh, m).permute(0, 2, 1, 3, 4)
                            [:, :, :, None]
                            for t in (self_keys[degree], self_values[degree])]
                k = torch.cat((s_k, k), dim=3)
                v = torch.cat((s_v, v), dim=3)
            if pos_emb is not None and degree == '0':
                query_pos_emb, key_pos_emb = pos_emb
                q = apply_rotary_pos_emb(q, query_pos_emb[:, None])
                k = apply_rotary_pos_emb(k, key_pos_emb[:, None])
                v = apply_rotary_pos_emb(v, key_pos_emb[:, None])
            if self.use_null_kv:
                null_k, null_v = [
                    getattr(self, f'{name}{degree}')[None, :, None, None]
                    .expand(b, kv_h, n, 1, dh, m)
                    for name in ('null_k', 'null_v')]
                k = torch.cat((null_k, k), dim=3)
                v = torch.cat((null_v, v), dim=3)
            if global_keys is not None and degree == '0':
                num_g = global_keys['0'].shape[1]
                g_k, g_v = [t['0'].reshape(b, num_g, kv_h, dh, m)
                            .permute(0, 2, 1, 3, 4)[:, :, None]
                            .expand(b, kv_h, n, num_g, dh, m)
                            for t in (global_keys, global_values)]
                k = torch.cat((g_k, k), dim=3)
                v = torch.cat((g_v, v), dim=3)
            J = k.shape[3]
            padded = None
            if neighbor_mask is not None:
                padded = F.pad(neighbor_mask, (J - neighbor_mask.shape[-1], 0),
                               value=True)

            if self.pallas_attention:
                # (dim_head, m) flattened into one feature axis (the logits
                # reduce over both), the query heads folded into the batch
                # over their kv heads; past the kernels' limits on a card,
                # their plain version
                args = (q.reshape(b * h, n, dh * m),
                        k.reshape(b * kv_h, n, J, dh * m),
                        v.reshape(b * kv_h, n, J, dh * m), padded, h,
                        dh ** -0.5)
                if routing.route(ka.fused_attention_fwd, q.device.type,
                                 ka.attention_limit(J, dh * m), (J, dh * m)):
                    out = ka.fused_attention_plain(*args)
                else:
                    out = fused_attention(*args)
                out = out.reshape(b, h, n, dh, m)
            else:
                if kv_h == 1:
                    sim = torch.einsum('bhidm,bijdm->bhij', q, k[:, 0])
                else:
                    sim = torch.einsum('bhidm,bhijdm->bhij', q, k)
                sim = sim * dh ** -0.5
                if padded is not None:
                    sim = sim.masked_fill(~padded[:, None],
                                          torch.finfo(sim.dtype).min)
                attn = sim.softmax(dim=-1)
                if kv_h == 1:
                    out = torch.einsum('bhij,bijdm->bhidm', attn, v[:, 0])
                else:
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

    def _prefix_slots(self, degree: str, b: int, n: int, global_kv,
                      self_keys: Optional[Features],
                      self_values: Optional[Features]):
        """The always-valid kv slots left of the neighbor axis
        (pallas_flash's prefix_k/prefix_v [b, n, S0, kv_heads * Dh]) in the
        unfused concat order [global (degree 0), null, self], each with its
        field; (None, None) with none."""
        pre_k, pre_v = [], []
        global_keys, global_values = global_kv
        if global_keys is not None and degree == '0':
            num_g = global_keys['0'].shape[1]
            for t, dst in ((global_keys, pre_k), (global_values, pre_v)):
                dst.append(t['0'].reshape(b, 1, num_g, -1)
                           .expand(b, n, num_g, -1))
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

    def _global_call(self, features, basis, global_kv) -> Features:
        """The kNN-free path (JAX AttentionSE3._global_call): the same
        parameters as the kNN paths, the kv convs returning their trunk's
        raw parameters and grouped w3/b3 (the values' alone when tied), and
        no edge_info, rel_dist or per-pair basis: the kernel rebuilds the
        pair payload from the coordinates per tile."""
        h, kv_h = self.heads, self.kv_heads
        coords = basis['global_coords']
        node_mask = basis.get('global_mask')
        queries = self.to_q(features)
        v_prog = self.to_v(features, None, None, basis)
        k_prog = None if self.tie_key_values else \
            self.to_k(features, None, None, basis)
        self_keys, self_values = self._self_kv(features)

        outputs = {}
        for degree in features.keys():
            m = to_order(int(degree))
            Dh = self.dim_head * m
            b, n = features[degree].shape[:2]
            prefix_k, prefix_v = self._prefix_slots(degree, b, n, global_kv,
                                                    self_keys, self_values)
            S0 = 0 if prefix_k is None else prefix_k.shape[2]
            args = (queries[degree].reshape(b, n, h, Dh),
                    tuple(features[str(d_in)] for d_in, _ in v_prog['pairs']),
                    coords, v_prog['rp'], v_prog['w3'][degree],
                    v_prog['b3'][degree])
            config = dict(pairs=v_prog['pairs'], d_out=int(degree), heads=h,
                          kv_heads=kv_h, scale=self.dim_head ** -0.5,
                          arm=v_prog['arm'], node_mask=node_mask,
                          prefix_k=prefix_k, prefix_v=prefix_v,
                          exclude_self=True)
            if k_prog is not None:
                config.update(rp_k=k_prog['rp'], wk=k_prog['w3'][degree],
                              bk=k_prog['b3'][degree])
            limit = kf.global_limit(v_prog['pairs'], int(degree), h, kv_h,
                                    self.dim_head, S0)
            # materialize runs the plain stream as one chunk anyway;
            # pallas=False the plain stream, uncounted
            if not self.global_materialize and (
                    self.pallas is False or routing.route(
                        kf.flash_global_attention_fwd, coords.device.type,
                        limit, (v_prog['pairs'], int(degree), h, kv_h,
                                self.dim_head))):
                out = kf.flash_global_plain(
                    *kf.flash_global_operands(*args, **config))
            else:
                out = flash_global_attention(
                    *args, materialize=self.global_materialize, **config)
            outputs[degree] = out.reshape(b, n, h * self.dim_head, m)
        return outputs

    def _flash_call(self, features, edge_info, rel_dist, basis,
                    global_kv) -> Features:
        """The streaming path (JAX AttentionSE3._flash_call): the kv convs
        return their radial hidden and grouped w3/b3 (the values' alone
        when tied), and the kernel builds k and v per edge from the node
        features and the SH stack."""
        h, kv_h = self.heads, self.kv_heads
        neighbor_indices, neighbor_mask, _ = edge_info
        queries = self.to_q(features)
        v_prog = self.to_v(features, edge_info, rel_dist, basis)
        k_prog = None if self.tie_key_values else \
            self.to_k(features, edge_info, rel_dist, basis)
        self_keys, self_values = self._self_kv(features)

        outputs = {}
        for degree in features.keys():
            m = to_order(int(degree))
            Dh = self.dim_head * m
            b, n = features[degree].shape[:2]
            prefix_k, prefix_v = self._prefix_slots(degree, b, n, global_kv,
                                                    self_keys, self_values)
            S0 = 0 if prefix_k is None else prefix_k.shape[2]
            h_v, K = v_prog['h'], neighbor_indices.shape[-1]
            # quantized grouped w3: the storage and its scale go to the
            # kernel's scaled arm as they are; a bf16 cast is upcast
            wv, wv_scale = _kernel_weight(v_prog['w3'][degree])
            args = (queries[degree].reshape(b, n, h, Dh),
                    tuple(features[str(d_in)] for d_in, _ in v_prog['pairs']),
                    neighbor_indices, neighbor_mask, h_v, wv,
                    v_prog['b3'][degree])
            config = dict(pairs=v_prog['pairs'], d_out=int(degree), heads=h,
                          kv_heads=kv_h, scale=self.dim_head ** -0.5,
                          arm_v=v_prog['arm'], sh=basis.get('flash_sh'),
                          frames=basis.get('so2'), prefix_k=prefix_k,
                          prefix_v=prefix_v, wv_scale=wv_scale)
            if k_prog is not None:
                wk, wk_scale = _kernel_weight(k_prog['w3'][degree])
                config.update(arm_k=k_prog['arm'], h_k=k_prog['h'], wk=wk,
                              bk=k_prog['b3'][degree], wk_scale=wk_scale)
            limit = kf.flash_limit(v_prog['pairs'], int(degree), h, kv_h,
                                   self.dim_head, K, S0,
                                   h_v.shape[-1], h_v.dtype,
                                   arms=(config.get('arm_k', v_prog['arm']),
                                         v_prog['arm']),
                                   storages=(config.get('wk', wv).dtype,
                                             wv.dtype))
            if self.pallas is False or routing.route(
                    kf.flash_attention_fwd, h_v.device.type, limit,
                    (v_prog['pairs'], int(degree), h, kv_h, self.dim_head,
                     K)):
                out = kf.flash_attention_plain(
                    *kf.flash_operands(*args, **config))
            else:
                out = flash_attention(*args, **config)
            outputs[degree] = out.reshape(b, n, h * self.dim_head, m)
        return outputs


class OneHeadedKVAttentionSE3(AttentionSE3):
    """Shazeer's multi-query attention: AttentionSE3 with one key/value head
    shared by every query head (kv_heads=1), the JAX
    OneHeadedKVAttentionSE3."""

    def __init__(self, fiber: Fiber, kv_heads: Optional[int] = 1, **kwargs):
        super().__init__(fiber, kv_heads=kv_heads, **kwargs)


class AttentionBlockSE3(nn.Module):
    """Prenorm + attention + residual; one_headed_key_values gives the
    attention one kv head (kv_heads=1)."""

    def __init__(self, fiber: Fiber, dim_head: int = 24, heads: int = 8,
                 attend_self: bool = False, use_null_kv: bool = False,
                 fourier_encode_dist: bool = False,
                 rel_dist_num_fourier_features: int = 4,
                 global_feats_dim: Optional[int] = None,
                 linear_proj_keys: bool = False,
                 tie_key_values: bool = False,
                 one_headed_key_values: bool = False,
                 pallas_attention: Optional[bool] = None,
                 shared_radial_hidden: bool = False,
                 edge_chunks: Optional[int] = None, fuse_basis: bool = False,
                 radial_bf16: bool = False, fuse_pairwise: bool = False,
                 attention_mode: str = 'knn',
                 global_materialize: bool = False, edge_dim: int = 0,
                 backend_v: str = 'dense', backend_k: str = 'dense',
                 norm_gated_scale: bool = False, conv_bf16: bool = False,
                 pallas: Optional[bool] = None):
        super().__init__()
        self.prenorm = NormSE3(fiber, gated_scale=norm_gated_scale)
        self.attn = AttentionSE3(
            fiber, dim_head=dim_head, heads=heads,
            kv_heads=1 if one_headed_key_values else None,
            attend_self=attend_self, fourier_encode_dist=fourier_encode_dist,
            rel_dist_num_fourier_features=rel_dist_num_fourier_features,
            use_null_kv=use_null_kv, global_feats_dim=global_feats_dim,
            linear_proj_keys=linear_proj_keys, tie_key_values=tie_key_values,
            pallas_attention=pallas_attention,
            shared_radial_hidden=shared_radial_hidden or fuse_pairwise,
            edge_chunks=edge_chunks, fuse_basis=fuse_basis,
            radial_bf16=radial_bf16, fuse_pairwise=fuse_pairwise,
            attention_mode=attention_mode,
            global_materialize=global_materialize, edge_dim=edge_dim,
            backend_v=backend_v, backend_k=backend_k, conv_bf16=conv_bf16,
            pallas=pallas)

    def forward(self, features: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor],
                global_feats: Optional[Features] = None,
                pos_emb=None) -> Features:
        out = self.attn(self.prenorm(features), edge_info, rel_dist, basis,
                        global_feats, pos_emb)
        return residual_se3(out, features)
