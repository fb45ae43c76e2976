"""The trunk: depth x (AttentionBlockSE3 -> FeedForwardBlockSE3), the port
of se3_transformer_tpu/ops/trunk.py::SequentialTrunk.

reversible=True wraps each block in a non-reentrant
torch.utils.checkpoint, as the JAX package wraps it in nn.remat: the
block's activations are dropped after the forward and recomputed in the
backward. remat_policy='save_conv_outputs' (the JAX
save_only_these_names('conv_out')) keeps the pairwise contractions'
outputs through a selective checkpoint policy that marks the
kernels.pairwise custom ops MUST_SAVE, so the replay launches no pairwise
forward kernel; the attention ops (kernels.attention.fused_attention,
kernels.flash.flash_attention) are recomputed, as JAX's policy saves
neither. remat_policy=None replays everything. Neither changes the forward,
and without autograd (serving) the blocks run as a plain loop.

The attention fields (attend_self, use_null_kv, fourier_encode_dist,
rel_dist_num_fourier_features, global_feats_dim, linear_proj_keys,
tie_key_values, one_headed_key_values, shared_radial_hidden, edge_dim,
with the JAX defaults), `pallas_attention`, `pallas`, `conv_bf16` and
`norm_gated_scale` (every block's prenorms) reach every attention block,
and the forward's global_feats and pos_emb (the rotary phases) every
block's call;
`fused_attention` holds one fuse_pairwise flag per block (the model
resolves its rules).
attention_mode='global' makes every block the kNN-free global attention
(with `global_materialize` and `use_null_kv`); its blocks get no
rel_dist.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..kernels.pairwise import PAIRWISE_CONTRACT_OPS
from .attention import AttentionBlockSE3
from .conv import EdgeInfo
from .core import FeedForwardBlockSE3
from .fiber import Fiber

Features = Dict[str, torch.Tensor]


def _save_conv_outputs(ctx, op, *args, **kwargs):
    if op in PAIRWISE_CONTRACT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _resolve_remat_policy(name: Optional[str]):
    """The checkpoint context_fn for a remat policy name (None replays
    the whole block)."""
    if name is None:
        return None
    if name == 'save_conv_outputs':
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_conv_outputs)
    raise ValueError(f'unknown remat_policy {name!r}; expected None or '
                     f"'save_conv_outputs'")


class SequentialTrunk(nn.Module):
    def __init__(self, fiber: Fiber, depth: int, heads: int = 8,
                 dim_head: int = 24, attend_self: bool = False,
                 use_null_kv: bool = False, fourier_encode_dist: bool = False,
                 rel_dist_num_fourier_features: int = 4,
                 global_feats_dim: Optional[int] = None,
                 linear_proj_keys: bool = False, tie_key_values: bool = False,
                 one_headed_key_values: bool = False,
                 reversible: bool = False,
                 remat_policy: Optional[str] = None,
                 pallas_attention: Optional[bool] = None,
                 shared_radial_hidden: bool = False,
                 edge_chunks: Optional[int] = None, fuse_basis: bool = False,
                 radial_bf16: bool = False,
                 fused_attention: Optional[Sequence[bool]] = None,
                 attention_mode: str = 'knn',
                 global_materialize: bool = False, edge_dim: int = 0,
                 value_backends: Optional[Sequence[str]] = None,
                 key_backends: Optional[Sequence[str]] = None,
                 norm_gated_scale: bool = False, conv_bf16: bool = False,
                 pallas: Optional[bool] = None):
        super().__init__()
        if remat_policy is not None and not reversible:
            raise ValueError(f'remat_policy={remat_policy!r} requires '
                             f'reversible=True')
        self.depth = depth
        self.reversible = reversible
        self.attention_mode = attention_mode
        self._context_fn = _resolve_remat_policy(remat_policy)
        for i in range(depth):
            self.add_module(f'attn_block{i}', AttentionBlockSE3(
                fiber, dim_head=dim_head, heads=heads,
                attend_self=attend_self, use_null_kv=use_null_kv,
                fourier_encode_dist=fourier_encode_dist,
                rel_dist_num_fourier_features=rel_dist_num_fourier_features,
                global_feats_dim=global_feats_dim,
                linear_proj_keys=linear_proj_keys,
                tie_key_values=tie_key_values,
                one_headed_key_values=one_headed_key_values,
                pallas_attention=pallas_attention,
                shared_radial_hidden=shared_radial_hidden,
                edge_chunks=edge_chunks, fuse_basis=fuse_basis,
                radial_bf16=radial_bf16,
                fuse_pairwise=bool(fused_attention and fused_attention[i]),
                attention_mode=attention_mode,
                global_materialize=global_materialize, edge_dim=edge_dim,
                backend_v=value_backends[i] if value_backends else 'dense',
                backend_k=key_backends[i] if key_backends else 'dense',
                norm_gated_scale=norm_gated_scale, conv_bf16=conv_bf16,
                pallas=pallas))
            self.add_module(f'ff_block{i}', FeedForwardBlockSE3(
                fiber, norm_gated_scale=norm_gated_scale))

    def _run(self, block: nn.Module, *args):
        if not (self.reversible and torch.is_grad_enabled()):
            return block(*args)
        kwargs = {} if self._context_fn is None else \
            dict(context_fn=self._context_fn)
        return checkpoint(block, *args, use_reentrant=False, **kwargs)

    def forward(self, x: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor],
                global_feats: Optional[Features] = None,
                pos_emb=None) -> Features:
        if self.attention_mode == 'global':
            rel_dist = None
        for i in range(self.depth):
            x = self._run(getattr(self, f'attn_block{i}'), x, edge_info,
                          rel_dist, basis, global_feats, pos_emb)
            x = self._run(getattr(self, f'ff_block{i}'), x)
        return x
