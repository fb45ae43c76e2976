"""flax -> torch parameter conversion.

The port's modules name their parameters after the flax ones, so a flax
path maps to a state_dict key by joining with '.', except for the three
layer kinds whose torch holders differ:

    <path>/<dense>/kernel [in, out]  ->  <path>.<dense>.weight [out, in]
    <path>/<dense>/bias              ->  <path>.<dense>.bias
    <path>/LayerNorm_k/scale         ->  <path>.LayerNorm_k.weight
    <path>/LayerNorm_k/bias          ->  <path>.LayerNorm_k.bias
    <path>/embedding (nn.Embed)      ->  <path>.weight (nn.Embedding)

where <dense> is any nn.Dense (the auto-named Dense_k, the EGNN's named
edge_mlp0, node_mlp1, htype_gate1, ...: every flax `kernel` is a Dense's)
and the EGNN's LayerNorm `node_norm` maps as LayerNorm_k does.

A quantized tree (the JAX package's quant.quantize_params) converts too:
a QuantTensor leaf (any leaf with `q` and `scale` arrays) becomes the
entries `<key>.q` and `<key>.scale` of the port's QuantTensor (a Dense
kernel's transposed, as its weight is), a bf16 leaf a bf16 tensor, fp8
storage a torch.float8_e4m3fn tensor of the same bits. load_flax_params
puts the quantized holders into a model before loading such a tree.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# numpy dtypes (ml_dtypes') whose bits the port keeps: the torch dtype and
# the numpy integer type of the same width the bits travel as
_BIT_DTYPES = {'bfloat16': (torch.bfloat16, np.uint16),
               'float8_e4m3fn': (torch.float8_e4m3fn, np.uint8)}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _torch_key(path) -> Tuple[str, bool]:
    """A flax path -> (state_dict key, whether the array is transposed)."""
    *head, layer, name = path if len(path) > 1 else ('',) + tuple(path)
    transposed = False
    if name == 'kernel':
        name, transposed = 'weight', True
    elif re.fullmatch(r'LayerNorm_\d+|node_norm', layer) and name == 'scale':
        name = 'weight'
    elif name == 'embedding':
        name = 'weight'
    return '.'.join(p for p in (*head, layer, name) if p), transposed


def flax_path(owner_name: str, owner: nn.Module, name: str
              ) -> Tuple[str, bool]:
    """The flax path of parameter `name` of the module `owner` (named
    `owner_name` in the model) -> ('/'-joined path, whether the flax array
    is the torch one transposed); the inverse of the table above."""
    transposed = False
    if isinstance(owner, nn.Linear) and name == 'weight':
        name, transposed = 'kernel', True
    elif isinstance(owner, nn.LayerNorm) and name == 'weight':
        name = 'scale'
    elif isinstance(owner, nn.Embedding) and name == 'weight':
        name = 'embedding'
    return '/'.join(p for p in (*owner_name.split('.'), name) if p), \
        transposed


def _tensor(arr) -> torch.Tensor:
    """A host array -> a CPU tensor: bf16 and fp8 bits kept, every other
    floating dtype as float32, integers as they are."""
    arr = np.asarray(arr)
    if arr.dtype.name in _BIT_DTYPES:
        dtype, bits = _BIT_DTYPES[arr.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(arr).view(bits)).view(
            dtype)
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _state(params: Mapping) -> Dict[str, torch.Tensor]:
    state = {}
    for path, leaf in _flatten(params):
        key, transposed = _torch_key(path)
        quantized = hasattr(leaf, 'q') and hasattr(leaf, 'scale')
        parts = (('q', leaf.q), ('scale', leaf.scale)) if quantized \
            else (('', leaf),)
        for suffix, arr in parts:
            t = _tensor(arr)
            if transposed:
                t = t.t().contiguous()
            state[f'{key}.{suffix}' if suffix else key] = t
    return state


def convert_flax_params(params: Mapping, model: torch.nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays keyed on flax paths (e.g.
    'conv_in/Dense_0/kernel', 'conv_in/w3_0_1', 'conv_in/pair_0_1/w3',
    'preconv0/pair_1_1/Dense_0/bias',
    'trunk/attn_block0/attn/to_k/LayerNorm_1/scale') -> a state_dict of
    CPU tensors for `model` (float32, or the bits of a quantized tree).

    The conversion is total: a flax leaf with no torch parameter of
    `model`, a parameter no leaf fills, or a shape mismatch raises."""
    state = _state(params)
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


def load_flax_params(model: torch.nn.Module, params: Mapping
                     ) -> torch.nn.Module:
    """Load a flax tree, quantized or not, into `model`: where the tree
    holds a QuantTensor the model's parameter is replaced by a port
    QuantTensor, where it holds bf16 the parameter becomes bf16, then the
    state_dict loads (convert_flax_params' checks included)."""
    from .quant.qtensor import QuantTensor
    state = _state(params)
    for key, value in state.items():
        base, _, suffix = key.rpartition('.')
        owner_name, _, name = base.rpartition('.')
        if suffix == 'q' and f'{base}.scale' in state:
            owner = model.get_submodule(owner_name)
            if name in owner._parameters:
                del owner._parameters[name]
                setattr(owner, name, QuantTensor(
                    torch.empty_like(value),
                    torch.empty_like(state[f'{base}.scale'])))
        elif value.dtype == torch.bfloat16:
            owner_name, _, name = key.rpartition('.')
            owner = model.get_submodule(owner_name)
            p = owner._parameters.get(name)
            if p is not None and p.dtype != torch.bfloat16:
                owner._parameters[name] = nn.Parameter(
                    p.detach().to(torch.bfloat16))
    model.load_state_dict(convert_flax_params(params, model))
    return model
