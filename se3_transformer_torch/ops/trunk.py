"""The trunk: depth x (AttentionBlockSE3 -> FeedForwardBlockSE3), the port
of se3_transformer_tpu/ops/trunk.py::SequentialTrunk.

reversible=True wraps each block in a non-reentrant
torch.utils.checkpoint, as the JAX package wraps it in nn.remat: the
block's activations are dropped after the forward and recomputed in the
backward. remat_policy='save_conv_outputs' (the JAX
save_only_these_names('conv_out')) keeps the pairwise contractions'
outputs through a selective checkpoint policy that marks the
kernels.pairwise custom op MUST_SAVE, so the replay launches no forward
kernel; remat_policy=None replays everything. Neither changes the forward,
and without autograd (serving) the blocks run as a plain loop.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..kernels.pairwise import PAIRWISE_CONTRACT_OP
from .attention import AttentionBlockSE3
from .conv import EdgeInfo
from .core import FeedForwardBlockSE3
from .fiber import Fiber

Features = Dict[str, torch.Tensor]


def _save_conv_outputs(ctx, op, *args, **kwargs):
    if op is PAIRWISE_CONTRACT_OP:
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
                 dim_head: int = 24, radial_bf16: bool = False,
                 reversible: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        if remat_policy is not None and not reversible:
            raise ValueError(f'remat_policy={remat_policy!r} requires '
                             f'reversible=True')
        self.depth = depth
        self.reversible = reversible
        self._context_fn = _resolve_remat_policy(remat_policy)
        for i in range(depth):
            self.add_module(f'attn_block{i}', AttentionBlockSE3(
                fiber, dim_head=dim_head, heads=heads,
                radial_bf16=radial_bf16))
            self.add_module(f'ff_block{i}', FeedForwardBlockSE3(fiber))

    def _run(self, block: nn.Module, *args):
        if not (self.reversible and torch.is_grad_enabled()):
            return block(*args)
        kwargs = {} if self._context_fn is None else \
            dict(context_fn=self._context_fn)
        return checkpoint(block, *args, use_reentrant=False, **kwargs)

    def forward(self, x: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor]
                ) -> Features:
        for i in range(self.depth):
            x = self._run(getattr(self, f'attn_block{i}'), x, edge_info,
                          rel_dist, basis)
            x = self._run(getattr(self, f'ff_block{i}'), x)
        return x
