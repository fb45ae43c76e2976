"""flax -> torch parameter conversion.

The port's modules name their parameters after the flax ones, so a flax
path maps to a state_dict key by joining with '.', except for the three
layer kinds whose torch holders differ:

    <path>/Dense_k/kernel [in, out]  ->  <path>.Dense_k.weight [out, in]
    <path>/Dense_k/bias              ->  <path>.Dense_k.bias
    <path>/LayerNorm_k/scale         ->  <path>.LayerNorm_k.weight
    <path>/LayerNorm_k/bias          ->  <path>.LayerNorm_k.bias
    <path>/embedding (nn.Embed)      ->  <path>.weight (nn.Embedding)
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def convert_flax_params(params: Mapping, model: torch.nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays keyed on flax paths (e.g.
    'conv_in/Dense_0/kernel', 'conv_in/w3_0_1', 'conv_in/pair_0_1/w3',
    'preconv0/pair_1_1/Dense_0/bias',
    'trunk/attn_block0/attn/to_k/LayerNorm_1/scale') -> a state_dict of
    float32 CPU tensors for `model`.

    The conversion is total: a flax leaf with no torch parameter of
    `model`, a parameter no leaf fills, or a shape mismatch raises."""
    state = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        *head, layer, name = path if len(path) > 1 else ('',) + path
        if re.fullmatch(r'Dense_\d+', layer) and name == 'kernel':
            arr, name = arr.T, 'weight'
        elif re.fullmatch(r'LayerNorm_\d+', layer) and name == 'scale':
            name = 'weight'
        elif name == 'embedding':
            name = 'weight'
        key = '.'.join(p for p in (*head, layer, name) if p)
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))

    expected = dict(model.state_dict())
    unused = sorted(set(state) - set(expected))
    unfilled = sorted(set(expected) - set(state))
    if unused or unfilled:
        raise ValueError(f'flax leaves without a torch parameter: '
                         f'{unused}; torch parameters no leaf fills: '
                         f'{unfilled}')
    for key, value in state.items():
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(f'{key}: flax shape {tuple(value.shape)}, '
                             f'torch shape {tuple(expected[key].shape)}')
    return state
