"""The trunk: depth x (AttentionBlockSE3 -> FeedForwardBlockSE3), the port
of se3_transformer_tpu/ops/trunk.py::SequentialTrunk.

The JAX package's reversible=True only rematerializes blocks in the
backward pass; it does not change the forward, so serving runs this plain
loop either way.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .attention import AttentionBlockSE3
from .conv import EdgeInfo
from .core import FeedForwardBlockSE3
from .fiber import Fiber

Features = Dict[str, torch.Tensor]


class SequentialTrunk(nn.Module):
    def __init__(self, fiber: Fiber, depth: int, heads: int = 8,
                 dim_head: int = 24, radial_bf16: bool = False):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f'attn_block{i}', AttentionBlockSE3(
                fiber, dim_head=dim_head, heads=heads,
                radial_bf16=radial_bf16))
            self.add_module(f'ff_block{i}', FeedForwardBlockSE3(fiber))

    def forward(self, x: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor]
                ) -> Features:
        for i in range(self.depth):
            x = getattr(self, f'attn_block{i}')(x, edge_info, rel_dist, basis)
            x = getattr(self, f'ff_block{i}')(x)
        return x
