"""SE3TransformerModule: the port of se3_transformer_tpu/models/se3_transformer.py
restricted to the fields its recipes (`flagship_fast`, `flagship`,
`af2_refinement`, `molecular_edges`, `toy_denoise`), the assembly model
(attention_mode='global') and the JAX default model surface use.

The fibers are resolved as the JAX `_resolved`: fiber_in from
input_degrees and dim_in (an int or a tuple per degree; dim without it),
the hidden fiber from hidden_fiber_dict or (num_degrees, dim) (num_degrees
None takes hidden_fiber_dict's top degree + 1), fiber_out from
out_fiber_dict or (output_degrees, dim_out or dim).

The forward is the JAX module's kNN path, step for step: the input (a
[b, n, dim] tensor, or a dict of degrees {'0': [b, n, c, 1], '1': [b, n,
c, 3], ...} whose degree 1 is permuted Cartesian -> irrep; integer tokens
through `token_emb`, plus `pos_emb` of the positions with num_positions)
-> self-excluded pairwise geometry -> the adjacency predicates (adj_mat
grown to num_adj_degrees hops with ring labels; with
attend_sparse_neighbors up to max_sparse_neighbors bonded pairs a row,
picked by a jittered top-k) -> the edges (token edges through `edge_emb`,
the ring labels' `adj_emb` concatenated) -> fixed-K neighbor selection
(bonded pairs first, user-masked and, with causal, future pairs last;
num_neighbors + the bonded budget slots, only bonded ones valid when
num_neighbors is 0) -> the edges gathered at the selected slots -> the basis
(the flat 'pfq_flat' layout with fuse_basis, the structured 'pqf' one
without, as the JAX module picks it on the kernel path; differentiable
with differentiable_coors) -> conv_in -> num_conv_layers x (preconv_norm,
preconv) -> trunk -> conv_out -> norm_out (on with reversible) ->
linear_out (reduce_dim_out) -> the degree-1 Cartesian permutation -> the
output of `return_type` (with return_pooled, its masked mean over the
nodes), with the JAX conventions. edge_chunks streams
every ConvSE3's contraction over that many node chunks. pallas_attention=True runs every unfused attention
block's core through the fused attention kernel; fuse_pairwise (a bool, or
first-match-wins (pattern, 'flash' | 'xla') rules on 'attn_block{i}')
routes the chosen blocks through the streaming attention kernel, which
reads the SH stack basis['flash_sh'] instead of the per-pair basis.

attention_mode='global' is the JAX module's `_global_forward`: no
neighbor selection and no basis; a LinearSE3 `lift_in` (the hidden degrees
the input lacks start at zero), a trunk of global attention blocks that
rebuild the pair payload from the coordinates, a LinearSE3 `lift_out`,
then the same output tail. num_tokens embeds integer tokens first
(`token_emb`), in either mode; norm_out applies the output NormSE3 (on
with reversible, as in JAX); use_null_kv adds the null kv slot of the
global blocks.

The attention variants, in either mode but where JAX refuses them:
global_feats_dim (the forward's global_feats [b, num_global,
global_feats_dim] become degree-0 kv slots of every block),
one_headed_key_values (one kv head), tie_key_values (keys are the
values), linear_proj_keys (kNN, unfused blocks only), use_null_kv (a null
kv slot), rotary_position and
rotary_rel_dist (rotary phases of the degree-0 q, k and v from the slots'
sequence positions and distances; kNN, unfused blocks only).

conv_backend (the JAX field): 'dense', 'so2', or first-match-wins
(layer regex, backend) pairs on 'conv_in', 'preconv{i}',
'attn_block{i}/to_v', 'attn_block{i}/to_k' and 'conv_out'; each layer
gets its backend, and the forward builds only the payloads its layers
read (_payloads: the per-pair basis, the SH stack of the dense fused
blocks, the so2 edge frames).

use_egnn (egnn_hidden_dim, egnn_weights_clamp_value, egnn_feedforward)
makes the trunk the EGNN backbone (ops.egnn.EGnnNetwork), as JAX does: no
attention blocks and no conv_out (output_degrees becomes None: the output
is the hidden fiber's degrees, through linear_out with reduce_dim_out),
remat_policy refused, fuse_pairwise and the kv convs' backends not read.
norm_gated_scale gives every NormSE3 (the blocks' prenorms, preconv_norm,
norm_out) a gating matrix w_gate{d} in place of scale{d}. conv_bf16 stores
every contraction's equivariant operand bf16 (ops.conv; the basis-fused
contraction's basis once for all convs, in _payloads), refused with
fuse_pairwise and in global mode as JAX's attention refuses it. pallas
(None / True: the kernels on a card; False: the plain versions on every
device, no basis-fused contraction and the 'pqf' basis layout, as JAX's
XLA path) reaches every conv and attention block.

The forward's `neighbors=(indices [b, n, k], mask [b, n, k] or None)` takes
precomputed neighbor lists (the JAX argument, for a host-side graph
builder) in place of the kNN selection: plain kNN semantics only (no
sparse or causal attention, no adjacency, no edges, no neighbor_mask); the
indices are clamped to [0, n), and a slot is valid when its node is within
valid_radius, is not the node itself (a self-inclusive list) and, with
them, where the given mask and both nodes' mask allow.

Quantized serving (se3_transformer_torch.quant.quantize_params, or
InferenceEngine(precision=...)): a model holding int8/fp8 weights serves
only. Its forward refuses to run with autograd enabled (a training step
included), as the JAX package refuses a gradient through the quantized
tree: no weight is silently dequantized to train.

Every other JAX field is accepted only at its JAX default: any other value
raises NotImplementedError, so nothing is silently ignored.
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..basis import get_basis
from ..kernels.flash import flash_sh_payload
from ..ops.conv import ConvSE3, resolve_conv_backend
from ..ops.attention import FUSED_CONV_BF16, GLOBAL_CONV_BF16
from ..ops.core import LinearSE3, NormSE3
from ..ops.egnn import EGnnNetwork
from ..ops.fiber import Fiber
from ..ops.neighbors import (
    Neighborhood, exclude_self_indices, expand_adjacency, remove_self,
    select_neighbors, sparse_neighbor_mask,
)
from ..ops.rotary import sinusoidal_embeddings
from ..ops.trunk import SequentialTrunk
from ..quant.qtensor import is_quantized
from ..so2.frames import edge_frames
from ..utils.helpers import (
    batched_index_select, cast_tuple, masked_mean, resolve_device, safe_norm,
)

# JAX SE3TransformerModule fields this port does not implement, with the
# JAX defaults they must keep: the TPU interpreter flags (tests of the
# Pallas kernels in interpret mode), the matmul precision policy (the
# port's matmuls are IEEE float32) and the parallel fields
_JAX_ONLY_DEFAULTS = dict(
    flash_interpret=False, pallas_interpret=False,
    pallas_attention_interpret=False,
    matmul_precision=None, sequence_parallel=None,
    mesh=None, ring_overlap=True, ring_exchange=True)

# what the JAX _global_forward asserts, as (field, its only allowed value,
# the reason); checked before the port's own refusals
_NOT_WITH_GLOBAL = (
    ('attend_sparse_neighbors', False, 'sparse neighbors presume a '
     'neighbor list'),
    ('causal', False, 'causal masking presumes a neighbor list'),
    ('num_adj_degrees', None, 'adjacency presumes a neighbor list'),
    ('edge_dim', None, 'edge features presume a neighbor list'),
    ('use_egnn', False, 'egnn blocks presume a neighbor list'),
    ('conv_bf16', False, GLOBAL_CONV_BF16),
    ('rotary_position', False, 'global attention does not support rotary '
     'embeddings'),
    ('rotary_rel_dist', False, 'global attention does not support rotary '
     'embeddings'),
    ('linear_proj_keys', False, 'global attention needs conv keys'),
    ('fourier_encode_dist', False, 'global attention consumes raw '
     'distances only'),
    ('num_conv_layers', 0, 'global mode has no per-edge convs'))


# what the JAX module refuses beside fuse_pairwise (its _forward asserts),
# as _NOT_WITH_GLOBAL
_NOT_WITH_FUSE_PAIRWISE = (
    ('sequence_parallel', None, 'fuse_pairwise streams its own gathers and '
     'does not compose with the sequence-parallel ring exchange yet'),
    ('rotary_position', False, 'fuse_pairwise does not support rotary '
     'embeddings'),
    ('rotary_rel_dist', False, 'fuse_pairwise does not support rotary '
     'embeddings'),
    ('linear_proj_keys', False, 'fuse_pairwise needs conv keys '
     '(linear_proj_keys is the gathered node-projection variant)'),
    ('conv_bf16', False, FUSED_CONV_BF16))


def resolve_fused_attention(spec, depth: int) -> tuple:
    """One fuse_pairwise flag per attention block from a bool, or from
    first-match-wins (pattern, 'flash' | 'xla') rules on 'attn_block{i}'
    (the JAX module's _attention_fused; no match means 'xla')."""
    if isinstance(spec, bool):
        return (spec,) * depth
    out = []
    for i in range(depth):
        val = next((v for pat, v in spec if re.search(pat, f'attn_block{i}')),
                   'xla')
        if val not in ('flash', 'xla'):
            raise ValueError(f'fuse_pairwise rule value {val!r} (want flash|'
                             f'xla)')
        out.append(val == 'flash')
    return tuple(out)


def _backend_spec(spec):
    """conv_backend as a string, or as an order-preserving tuple of
    (pattern, backend) pairs from a dict or a list of pairs (first match
    wins, so never sorted)."""
    if isinstance(spec, str):
        return spec
    items = spec.items() if hasattr(spec, 'items') else spec
    return tuple((str(p), str(b)) for p, b in items)


# degree-1 features are in the irrep order (y, z, x) of the real spherical
# harmonics; a degree-1 input is permuted from Cartesian (x, y, z) on the
# way in and the output back to Cartesian
_CART_TO_IRREP = (1, 2, 0)
_IRREP_TO_CART = (2, 0, 1)


def _permute_degree1(features: dict, perm) -> dict:
    """features with degree 1's last axis permuted (slices, not an index
    list: that would be copied to the device)."""
    if '1' not in features:
        return features
    t = features['1']
    return {**features, '1': torch.stack([t[..., k] for k in perm], -1)}


def _fiber_structure(value):
    """A fiber dict field ({degree: channels} or (degree, channels) pairs)
    as sorted pairs, as the JAX module normalizes it."""
    if value is None:
        return None
    items = value.items() if hasattr(value, 'items') else value
    return tuple(sorted((int(d), int(c)) for d, c in items))


def _truncated_normal_(t: torch.Tensor, std: float,
                       generator: torch.Generator) -> None:
    """flax's truncated_normal: N(0, std) cut at +-2 std, by inverse CDF."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    z = torch.erfinv(2 * (lo + u * (hi - lo)) - 1) * math.sqrt(2)
    t.copy_((z * std).to(t.dtype))


# flax's truncated normal of unit variance has this std before scaling
_TRUNC_STD = 0.87962566103423978


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter from `generator` the way the flax module
    initializes its counterpart: variance-scaling truncated normals for
    Dense kernels and w3, normal(dim_in**-0.5) for LinearSE3, ones for
    scales, zeros for biases; the EGNN's Dense kernels normal(1e-3), its
    HtypesNorm constants 1e-2 and NormSE3's w_gate uniform(+-1e-3); the v2
    family's gate{l} Dense kernels and per-m blocks wm{m}_{i}_{o} as Dense
    kernels and w3, their bm as biases."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            parts = name.split('.')
            leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else '')
            egnn_dense = re.fullmatch(
                r'(edge|htypes|node)_mlp\d|htype_gate\d+', parent)
            if egnn_dense and leaf == 'weight':
                p.copy_(torch.randn(p.shape, generator=generator) * 1e-3)
            elif re.fullmatch(r'htype_norm\d+', parent):
                p.fill_(1e-2)
            elif re.fullmatch(r'w_gate\d+', leaf):
                p.copy_(torch.rand(p.shape, generator=generator) * 2e-3
                        - 1e-3)
            elif re.fullmatch(r'Dense_\d+|gate\d+', parent) \
                    and leaf == 'weight':
                _truncated_normal_(p, (1 / p.shape[1]) ** 0.5 / _TRUNC_STD,
                                   generator)
            elif parent.endswith('_emb') and leaf == 'weight':
                # token_emb, pos_emb, edge_emb, adj_emb; flax nn.Embed:
                # normal of variance 1 / features
                p.copy_(torch.randn(p.shape, generator=generator)
                        * p.shape[1] ** -0.5)
            elif leaf.startswith('w3_') or re.fullmatch(r'wm\d+_\d+_\d+',
                                                        leaf) or (
                    leaf == 'w3' and re.fullmatch(r'pair_\d+_\d+', parent)):
                _truncated_normal_(p, (1 / p.shape[0]) ** 0.5 / _TRUNC_STD,
                                   generator)
            elif re.fullmatch(r'w\d+', leaf):
                p.copy_(torch.randn(p.shape, generator=generator)
                        * p.shape[0] ** -0.5)
            elif leaf == 'weight' or leaf.startswith('scale'):
                p.fill_(1.)
            elif leaf in ('bias', 'b3') or leaf.startswith(('b3_', 'null_')) \
                    or re.fullmatch(r'bm\d+_\d+_\d+', leaf):
                p.zero_()
            else:
                raise ValueError(f'no initializer for parameter {name}')


class SE3TransformerModule(nn.Module):
    # the family stamp checkpoints carry (training.checkpoint), as the JAX
    # module's: a checkpoint of another family refuses to restore into it
    model_family = 'se3_v1'

    def __init__(self, dim, heads: int = 8, dim_head: int = 24,
                 depth: int = 2, input_degrees: int = 1,
                 num_degrees: Optional[int] = None, output_degrees: int = 1,
                 valid_radius: float = 1e5, reversible: bool = False,
                 remat_policy: Optional[str] = None,
                 attend_self: bool = True,
                 differentiable_coors: bool = False,
                 fourier_encode_dist: bool = False,
                 rel_dist_num_fourier_features: int = 4,
                 num_neighbors=float('inf'), dim_in=None,
                 dim_out: Optional[int] = None, num_conv_layers: int = 0,
                 hidden_fiber_dict=None, out_fiber_dict=None,
                 shared_radial_hidden: bool = False, fuse_basis: bool = False,
                 radial_bf16: bool = False, reduce_dim_out: bool = False,
                 edge_chunks: Optional[int] = None,
                 pallas_attention: Optional[bool] = None,
                 fuse_pairwise=False, num_tokens: Optional[int] = None,
                 use_null_kv: bool = False, norm_out: bool = False,
                 attention_mode: str = 'knn',
                 global_materialize: bool = False,
                 num_positions: Optional[int] = None,
                 num_edge_tokens: Optional[int] = None,
                 edge_dim: Optional[int] = None,
                 attend_sparse_neighbors: bool = False,
                 num_adj_degrees: Optional[int] = None, adj_dim: int = 0,
                 max_sparse_neighbors=float('inf'), causal: bool = False,
                 global_feats_dim: Optional[int] = None,
                 linear_proj_keys: bool = False,
                 one_headed_key_values: bool = False,
                 tie_key_values: bool = False,
                 rotary_position: bool = False,
                 rotary_rel_dist: bool = False, conv_backend='dense',
                 norm_gated_scale: bool = False, use_egnn: bool = False,
                 egnn_hidden_dim: int = 32,
                 egnn_weights_clamp_value: Optional[float] = None,
                 egnn_feedforward: bool = False, conv_bf16: bool = False,
                 pallas: Optional[bool] = None, *,
                 device='cuda', generator: Optional[torch.Generator] = None,
                 **jax_fields):
        super().__init__()
        device = resolve_device(device)
        if attention_mode not in ('knn', 'global'):
            raise ValueError(f"unknown attention_mode {attention_mode!r} "
                             f"(want 'knn' or 'global')")
        self.attention_mode = attention_mode
        hidden_fiber_dict = _fiber_structure(hidden_fiber_dict)
        out_fiber_dict = _fiber_structure(out_fiber_dict)
        if num_degrees is None and hidden_fiber_dict is None:
            raise ValueError('either num_degrees or hidden_fiber_dict must be '
                             'specified')
        if causal and not attend_self:
            raise ValueError('attend_self must be on in causal '
                             '(autoregressive) mode')
        if num_adj_degrees is not None and num_adj_degrees < 1:
            raise ValueError('num_adj_degrees must be at least 1')
        if num_edge_tokens is not None and edge_dim is None:
            raise ValueError('num_edge_tokens embeds edges into edge_dim '
                             'features; set edge_dim')
        if reversible and global_feats_dim is not None:
            raise ValueError('reversibility and global features are not '
                             'compatible')
        if use_egnn and remat_policy is not None:
            raise ValueError('remat_policy applies to the conv-attention '
                             'trunk only')
        if pallas not in (None, False, True):
            raise ValueError(f'pallas must be None, False or True, got '
                             f'{pallas!r}')
        fields = dict(jax_fields, fourier_encode_dist=fourier_encode_dist,
                      num_conv_layers=num_conv_layers,
                      attend_sparse_neighbors=attend_sparse_neighbors,
                      causal=causal, num_adj_degrees=num_adj_degrees,
                      edge_dim=edge_dim, rotary_position=rotary_position,
                      rotary_rel_dist=rotary_rel_dist,
                      linear_proj_keys=linear_proj_keys, use_egnn=use_egnn,
                      conv_bf16=conv_bf16)
        if attention_mode == 'global':
            for key, allowed, why in _NOT_WITH_GLOBAL:
                if fields.get(key, allowed) != allowed:
                    raise ValueError(f"attention_mode='global' does not "
                                     f"take {key}={fields[key]!r}: {why}")
            if resolve_fused_attention(fuse_pairwise, depth) != \
                    (False,) * depth:
                raise ValueError("fuse_pairwise is subsumed by "
                                 "attention_mode='global'; leave it False")
            if remat_policy is not None:
                raise ValueError(f'remat_policy={remat_policy!r} tags conv '
                                 f'outputs, which the global trunk never '
                                 f'materializes')
        if pallas_attention not in (None, False, True):
            raise ValueError(f'pallas_attention must be None, False or True, '
                             f'got {pallas_attention!r}')
        # an EGNN trunk has no attention blocks to fuse (JAX
        # _attention_fused)
        self.fused_attention = () if use_egnn else \
            resolve_fused_attention(fuse_pairwise, depth)
        self.conv_backend = _backend_spec(conv_backend)
        if any(self.fused_attention):
            for key, allowed, why in _NOT_WITH_FUSE_PAIRWISE:
                if fields.get(key, allowed) != allowed:
                    raise ValueError(f'fuse_pairwise does not compose with '
                                     f'{key}={fields[key]!r}: {why}')
        for key, value in jax_fields.items():
            if key not in _JAX_ONLY_DEFAULTS:
                raise TypeError(f'unknown field {key!r}')
            if value != _JAX_ONLY_DEFAULTS[key]:
                raise NotImplementedError(
                    f'{key}={value!r} is not ported (only the JAX default '
                    f'{_JAX_ONLY_DEFAULTS[key]!r})')
        if edge_chunks is not None and (isinstance(edge_chunks, bool) or
                                        not isinstance(edge_chunks, int) or
                                        edge_chunks < 1):
            raise ValueError(f'edge_chunks must be None or a positive int, '
                             f'got {edge_chunks!r}')

        # the fibers, as the JAX _resolved builds them
        if num_degrees is None:
            num_degrees = max(d for d, _ in hidden_fiber_dict) + 1
        dim_in = dim if dim_in is None else dim_in
        fiber_in = Fiber.create(input_degrees,
                                cast_tuple(dim_in, input_degrees))
        fiber_hidden = Fiber(hidden_fiber_dict) if hidden_fiber_dict \
            is not None else Fiber.create(num_degrees, dim)
        # the EGNN trunk's output is the hidden fiber: no conv_out (JAX
        # _resolved)
        if use_egnn:
            output_degrees = None
        if out_fiber_dict is not None:
            fiber_out = Fiber(out_fiber_dict)
            output_degrees = max(d for d, _ in out_fiber_dict) + 1
        elif output_degrees is not None:
            fiber_out = Fiber.create(output_degrees,
                                     dim if dim_out is None else dim_out)
        else:
            fiber_out = None
        if attention_mode == 'global' and \
                not all(d in fiber_hidden for d, _ in fiber_out):
            raise ValueError('global mode projects out with a LinearSE3, so '
                             'every output degree must exist in the hidden '
                             'fiber')
        self.input_degrees = input_degrees
        self.num_degrees = num_degrees
        self.output_degrees = output_degrees
        self.fiber_in, self.fiber_hidden = fiber_in, fiber_hidden
        self.differentiable_coors = differentiable_coors
        self.valid_radius = valid_radius
        self.num_neighbors = num_neighbors
        self.num_conv_layers = num_conv_layers
        self.num_positions = num_positions
        self.edge_dim = edge_dim
        self.attend_sparse_neighbors = attend_sparse_neighbors
        self.num_adj_degrees = num_adj_degrees
        self.max_sparse_neighbors = max_sparse_neighbors
        self.causal = causal
        self.global_feats_dim = global_feats_dim
        self.rotary_position, self.rotary_rel_dist = \
            rotary_position, rotary_rel_dist
        self.dim_head = dim_head
        self.use_egnn = use_egnn
        self.fiber_out = fiber_out
        # the convs' edge width: the edges, then the ring labels' embedding
        # (the JAX module reads it off the edges at trace time)
        embed_adjacency = num_adj_degrees is not None and adj_dim > 0
        self.edge_width = (edge_dim or 0) + (adj_dim if embed_adjacency
                                             else 0)
        # reversible blocks imply the output norm (JAX _body); there is
        # none without an output fiber (the EGNN trunk)
        self.apply_norm_out = (norm_out or reversible) and \
            fiber_out is not None
        # the basis layout the convs take (the JAX module's choice: the
        # flat one on the kernel path of the basis-fused contraction)
        self.basis_layout = 'pfq_flat' if fuse_basis and pallas is not False \
            else 'pqf'
        self.conv_bf16 = conv_bf16

        if num_tokens is not None:
            self.token_emb = nn.Embedding(num_tokens, fiber_in[0])
        if num_positions is not None:
            self.pos_emb = nn.Embedding(num_positions, fiber_in[0])
        if num_edge_tokens is not None:
            self.edge_emb = nn.Embedding(num_edge_tokens, edge_dim)
        if embed_adjacency:
            self.adj_emb = nn.Embedding(num_adj_degrees + 1, adj_dim)
        conv_kwargs = dict(fourier_encode_dist=fourier_encode_dist,
                           edge_dim=self.edge_width,
                           num_fourier_features=rel_dist_num_fourier_features,
                           shared_radial_hidden=shared_radial_hidden,
                           edge_chunks=edge_chunks, fuse_basis=fuse_basis,
                           radial_bf16=radial_bf16, conv_bf16=conv_bf16,
                           pallas=pallas)
        # the conv layers' backends by name (the JAX _layer_backends)
        names = ['conv_in'] + [f'preconv{i}' for i in range(num_conv_layers)]
        for i in range(0 if use_egnn else depth):
            names.append(f'attn_block{i}/to_v')
            if not (linear_proj_keys or tie_key_values):
                names.append(f'attn_block{i}/to_k')
        if attention_mode != 'global' and fiber_out is not None:
            names.append('conv_out')
        self.backends = {name: resolve_conv_backend(self.conv_backend, name)
                         for name in names}
        if attention_mode == 'global':
            self.lift_in = LinearSE3(fiber_in, fiber_hidden)
        else:
            self.conv_in = ConvSE3(fiber_in, fiber_hidden,
                                   backend=self.backends['conv_in'],
                                   **conv_kwargs)
        for i in range(num_conv_layers):
            self.add_module(f'preconv_norm{i}', NormSE3(
                fiber_hidden, gated_scale=norm_gated_scale))
            self.add_module(f'preconv{i}', ConvSE3(
                fiber_hidden, fiber_hidden,
                backend=self.backends[f'preconv{i}'], **conv_kwargs))
        if use_egnn:
            self.egnn_net = EGnnNetwork(
                fiber_hidden, depth=depth, edge_dim=self.edge_width,
                hidden_dim=egnn_hidden_dim,
                coor_weights_clamp_value=egnn_weights_clamp_value,
                feedforward=egnn_feedforward, reversible=reversible)
        else:
            self.trunk = SequentialTrunk(
                fiber_hidden, depth=depth, heads=heads, dim_head=dim_head,
                attend_self=attend_self, use_null_kv=use_null_kv,
                fourier_encode_dist=fourier_encode_dist,
                rel_dist_num_fourier_features=rel_dist_num_fourier_features,
                global_feats_dim=global_feats_dim,
                linear_proj_keys=linear_proj_keys,
                tie_key_values=tie_key_values,
                one_headed_key_values=one_headed_key_values,
                reversible=reversible, remat_policy=remat_policy,
                pallas_attention=pallas_attention,
                shared_radial_hidden=shared_radial_hidden,
                edge_chunks=edge_chunks, fuse_basis=fuse_basis,
                radial_bf16=radial_bf16,
                fused_attention=self.fused_attention,
                attention_mode=attention_mode,
                global_materialize=global_materialize,
                edge_dim=self.edge_width,
                value_backends=tuple(self.backends[f'attn_block{i}/to_v']
                                     for i in range(depth)),
                key_backends=tuple(self.backends.get(f'attn_block{i}/to_k',
                                                     'dense')
                                   for i in range(depth)),
                norm_gated_scale=norm_gated_scale, conv_bf16=conv_bf16,
                pallas=pallas)
        if attention_mode == 'global':
            self.lift_out = LinearSE3(fiber_hidden, fiber_out)
        elif fiber_out is not None:
            self.conv_out = ConvSE3(fiber_hidden, fiber_out,
                                    backend=self.backends['conv_out'],
                                    **conv_kwargs)
        if self.apply_norm_out:
            self.norm_out = NormSE3(fiber_out, nonlin=lambda t: t,
                                    gated_scale=norm_gated_scale)
        final_fiber = fiber_hidden if fiber_out is None else fiber_out
        self.linear_out = LinearSE3(final_fiber, final_fiber.to(1)) \
            if reduce_dim_out else None
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)
        self.to(device)

    def forward(self, feats, coors: torch.Tensor,
                mask: Optional[torch.Tensor] = None, adj_mat=None,
                edges: Optional[torch.Tensor] = None,
                return_type: Optional[int] = None,
                return_pooled: bool = False,
                neighbor_mask: Optional[torch.Tensor] = None,
                global_feats=None, neighbors=None, *,
                neighbor_noise: Optional[torch.Generator] = None):
        """feats [b, n, dim] (integer tokens [b, n] with num_tokens), or a
        dict of the input degrees {'0': [b, n, c0, 1], '1': [b, n, c1, 3],
        ...} with degree 1 in Cartesian order; coors [b, n, 3], mask [b, n]
        bool; adj_mat [b, n, n] or [n, n] bool (nonzero = bonded) for
        num_adj_degrees and attend_sparse_neighbors (ignored without
        them); edges [b, n, n] integer tokens with num_edge_tokens, else
        [b, n, n, edge_dim] features; neighbor_mask [b, n, n] bool, False
        keeping a pair out of the selection -> the output of degree
        `return_type`, or the dict of every output degree when it is None;
        one output degree forces return_type 0. Degree 0 is [b, n, c]
        ([b, n] with reduce_dim_out); degree 1 is [b, n, c, 3] ([b, n, 3]
        with reduce_dim_out), in Cartesian order. return_pooled takes the
        mean over the nodes (the real ones, with mask): [b, c] and [b, c,
        3]. global_feats [b, num_global, global_feats_dim] (or {'0': [b,
        num_global, global_feats_dim, 1]}) is passed iff global_feats_dim
        is set. neighbors=(indices [b, n, k], mask [b, n, k] or None) are
        precomputed neighbor lists (module docstring). With use_egnn the
        output is the hidden fiber's (return_type picks a degree).

        neighbor_noise is a torch.Generator on the input's device that the
        bonded top-k's tie-breaking jitter U(-0.01, 0.01) is drawn from,
        the counterpart of the JAX module's rngs={'neighbor_noise': key};
        without one each forward draws it from a fresh generator seeded 0,
        so that plain inference is reproducible, as JAX's PRNGKey(0)
        default is. Its bits differ from JAX's, which matters only in a
        row with more bonds than max_sparse_neighbors."""
        if torch.is_grad_enabled() and is_quantized(self):
            raise RuntimeError(
                'a quantized model serves only: run it under torch.no_grad() '
                'or torch.inference_mode(); no gradient flows through int8/'
                'fp8 weights (train the float32 model, then quantize it)')
        if (self.global_feats_dim is not None) != (global_feats is not None):
            raise ValueError('global features must be passed iff '
                             'global_feats_dim is set')
        if global_feats is not None and not isinstance(global_feats, dict):
            global_feats = {'0': global_feats[..., None]}
        if self.attend_sparse_neighbors and adj_mat is None:
            raise ValueError('adjacency matrix must be passed in when '
                             'attending to sparse neighbors')
        if (self.edge_dim or 0) > 0 and edges is None:
            raise ValueError('edge tokens/features must be supplied when '
                             'edge_dim is set')
        if edges is not None and not self.edge_dim:
            raise ValueError('edges were given but edge_dim is not set')
        if self.output_degrees == 1:
            return_type = 0
        if hasattr(self, 'token_emb'):
            feats = self.token_emb(feats)
        if hasattr(self, 'pos_emb'):
            if isinstance(feats, dict):
                raise ValueError('num_positions embeds a [b, n, dim] input')
            if feats.shape[1] > self.num_positions:
                raise ValueError('sequence length exceeds num_positions')
            feats = feats + self.pos_emb.weight[:feats.shape[1]][None]
        if not isinstance(feats, dict):
            feats = {'0': feats[..., None]}
        feats = _permute_degree1(feats, _CART_TO_IRREP)
        if feats['0'].shape[2] != self.fiber_in[0]:
            raise ValueError(f"feature dim {feats['0'].shape[2]} != "
                             f"configured {self.fiber_in[0]}")
        if set(map(int, feats)) != set(range(self.input_degrees)):
            raise ValueError(f'input must have degrees 0..'
                             f'{self.input_degrees - 1}')
        if self.attention_mode == 'global':
            return self._global_forward(feats, coors, mask, return_type,
                                        return_pooled, global_feats)
        if not self.attend_sparse_neighbors and self.num_neighbors <= 0 \
                and neighbors is None:
            raise ValueError('either attend to sparse neighbors or use '
                             'num_neighbors > 0')
        b, n = feats['0'].shape[0], feats['0'].shape[1]
        if neighbors is not None:
            if (self.attend_sparse_neighbors or self.causal
                    or neighbor_mask is not None
                    or self.num_adj_degrees is not None
                    or edges is not None):
                raise ValueError('precomputed neighbors support plain kNN '
                                 'semantics only')
            return self._body(feats, self._given_neighbors(
                neighbors, coors, mask, n), None, global_feats, return_type,
                return_pooled, mask, b, n)
        num_neighbors = int(min(self.num_neighbors, n - 1))

        self_excl = exclude_self_indices(n, device=coors.device)
        adj_indices, sparse_mask, num_sparse = self._adjacency_predicates(
            adj_mat, b, n, self_excl, neighbor_noise)
        rel_pos = remove_self(coors[:, :, None, :] - coors[:, None, :, :],
                              self_excl)                   # [b, n, n-1, 3]
        indices = self_excl[None].expand(b, n, n - 1)
        pair_mask = None
        if mask is not None:
            pair_mask = remove_self(mask[:, :, None] & mask[:, None, :],
                                    self_excl)
        if edges is not None:
            if hasattr(self, 'edge_emb'):
                edges = self.edge_emb(edges)
            edges = remove_self(edges, self_excl)
        if hasattr(self, 'adj_emb'):
            adj_emb = self.adj_emb(adj_indices)
            edges = adj_emb if edges is None else \
                torch.cat((edges, adj_emb), dim=-1)
        if neighbor_mask is not None:
            neighbor_mask = remove_self(neighbor_mask, self_excl)

        # with no kNN budget only the bonded slots (rank 0) are valid
        valid_radius = self.valid_radius if num_neighbors > 0 else 0.
        total_neighbors = int(min(num_neighbors + num_sparse, n - 1))
        if total_neighbors <= 0:
            raise ValueError('must fetch at least 1 neighbor')
        hood, nearest = select_neighbors(
            rel_pos, indices, total_neighbors, valid_radius,
            pair_mask=pair_mask, neighbor_mask=neighbor_mask,
            sparse_mask=sparse_mask, causal=self.causal)
        if edges is not None:
            edges = batched_index_select(edges, nearest, dim=2)
        return self._body(feats, hood, edges, global_feats, return_type,
                          return_pooled, mask, b, n)

    def _given_neighbors(self, neighbors, coors, mask, n) -> Neighborhood:
        """The neighborhood of precomputed lists (the JAX module's
        precomputed branch): indices clamped to [0, n), slots valid within
        valid_radius, not the node itself (self-inclusive lists, and
        sentinels the clamp mapped onto a real node), where the given mask
        and both nodes' mask allow."""
        nbr_idx, nbr_mask = neighbors
        nbr_idx = torch.as_tensor(nbr_idx, device=coors.device).long()
        nbr_idx = nbr_idx.clamp(0, n - 1)
        rel_pos = coors[:, :, None, :] - batched_index_select(coors, nbr_idx,
                                                              dim=1)
        rel_dist = safe_norm(rel_pos, dim=-1)
        valid = (rel_dist <= self.valid_radius) & (
            nbr_idx != torch.arange(n, device=coors.device)[None, :, None])
        if nbr_mask is not None:
            valid = valid & torch.as_tensor(nbr_mask,
                                            device=coors.device).bool()
        if mask is not None:
            valid = valid & batched_index_select(mask, nbr_idx, dim=1) \
                & mask[:, :, None]
        return Neighborhood(nbr_idx, valid, rel_pos, rel_dist)

    def _body(self, feats, hood, edges, global_feats, return_type,
              return_pooled, mask, b, n):
        """The JAX _body from the neighborhood on: the payloads, conv_in,
        the preconvs, the trunk (attention blocks or the EGNN), conv_out
        and the output tail."""
        basis = self._payloads(hood.rel_pos)
        edge_info = (hood.indices, hood.mask, edges)

        x = self.conv_in(feats, edge_info, hood.rel_dist, basis)
        for i in range(self.num_conv_layers):
            x = getattr(self, f'preconv_norm{i}')(x)
            x = getattr(self, f'preconv{i}')(x, edge_info, hood.rel_dist,
                                             basis)
        trunk = self.egnn_net if self.use_egnn else self.trunk
        x = trunk(x, edge_info, hood.rel_dist, basis, global_feats,
                  self._rotary_embeddings(b, n, hood))
        if self.fiber_out is not None:
            x = self.conv_out(x, edge_info, hood.rel_dist, basis)
        return self._output(x, return_type, return_pooled, mask)

    def _payloads(self, rel_pos: torch.Tensor) -> dict:
        """The per-edge payloads the conv layers read (the JAX _body): the
        per-pair basis for dense layers outside fused blocks, the SH stack
        'flash_sh' for dense kv convs of fused blocks, the edge frames
        'so2' for so2 layers; an all-so2 model builds no basis."""
        fused = {f'attn_block{i}/{kv}'
                 for i, on in enumerate(self.fused_attention) if on
                 for kv in ('to_v', 'to_k')}
        dense = [name for name, backend in self.backends.items()
                 if backend == 'dense']
        degree = self.num_degrees - 1
        basis = {}
        if any(name not in fused for name in dense):
            basis = get_basis(rel_pos, degree,
                              differentiable=self.differentiable_coors,
                              layout=self.basis_layout)
            if self.conv_bf16 and self.basis_layout == 'pfq_flat':
                # every conv stores the basis bf16 for the basis-fused
                # contraction: cast once, so that the convs share one bf16
                # copy (and residual) and the float32 basis is freed. A
                # basis that carries gradients stays float32, so that each
                # conv's bf16 gradient is summed in float32, as in JAX.
                basis = {key: b if b.requires_grad else b.to(torch.bfloat16)
                         for key, b in basis.items()}
        if any(name in fused for name in dense):
            basis['flash_sh'] = flash_sh_payload(
                rel_pos, degree, differentiable=self.differentiable_coors)
        if 'so2' in self.backends.values():
            basis['so2'] = edge_frames(
                rel_pos, degree, differentiable=self.differentiable_coors)
        return basis

    def _adjacency_predicates(self, adj_mat, b, n, self_excl, generator):
        """The JAX _adjacency_predicates on the self-excluded layout: (the
        ring labels [b, n, n-1] with num_adj_degrees, the bonded mask [b,
        n, n-1] with attend_sparse_neighbors, the bonded budget). adj_mat
        is grown to num_adj_degrees hops with its diagonal in; the bonded
        top-k runs over the full-width layout with the diagonal removed
        and the jitter scattered off it."""
        if self.num_adj_degrees is None and not self.attend_sparse_neighbors:
            return None, None, 0
        if adj_mat is None:
            raise ValueError('num_adj_degrees needs an adjacency matrix')
        device = self_excl.device
        adj_mat = torch.as_tensor(adj_mat, device=device).bool()
        if adj_mat.ndim == 2:
            adj_mat = adj_mat[None].expand(b, n, n)
        adj_indices = None
        if self.num_adj_degrees is not None:
            adj_mat, adj_ind_full = expand_adjacency(adj_mat,
                                                     self.num_adj_degrees)
            adj_indices = remove_self(adj_ind_full, self_excl)
        if not self.attend_sparse_neighbors:
            return adj_indices, None, 0
        num_sparse = int(min(self.max_sparse_neighbors, n - 1))
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        noise = torch.rand((b, n, n - 1), generator=generator,
                           device=device) * 0.02 - 0.01
        noise_full = noise.new_zeros(b, n, n).scatter(
            2, self_excl[None].expand(b, n, n - 1), noise)
        eye = torch.eye(n, dtype=torch.bool, device=device)
        sparse_full = sparse_neighbor_mask(adj_mat & ~eye, num_sparse,
                                           noise_full)
        return adj_indices, remove_self(sparse_full, self_excl), num_sparse

    def _rotary_embeddings(self, b, n, hood):
        """The rotary phases (JAX _rotary_embeddings): (query [b, n, r],
        key [b, n, 1 + K, r]) over the [self, neighbors] slots, from the
        sequence positions and/or the distances x 1e2 (zero for the query
        and the self slot), rot_dim = dim_head // their count per kind;
        None without either."""
        if not (self.rotary_position or self.rotary_rel_dist):
            return None
        rot_dim = self.dim_head // (int(self.rotary_position)
                                    + int(self.rotary_rel_dist))
        device = hood.rel_dist.device
        query, key = [], []
        if self.rotary_position:
            seq_emb = sinusoidal_embeddings(torch.arange(n, device=device),
                                            rot_dim)           # [n, r]
            idx_with_self = torch.cat(
                (torch.arange(n, device=device)[None, :, None]
                 .expand(b, n, 1).to(hood.indices.dtype), hood.indices),
                dim=2)
            key.append(seq_emb[idx_with_self])          # [b, n, 1 + K, r]
            query.append(seq_emb[None].expand(b, n, rot_dim))
        if self.rotary_rel_dist:
            dist_with_self = F.pad(hood.rel_dist, (1, 0)) * 1e2
            key.append(sinusoidal_embeddings(dist_with_self, rot_dim))
            q_emb = sinusoidal_embeddings(
                torch.zeros(n, device=device), rot_dim)
            query.append(q_emb[None].expand(b, n, rot_dim))
        return torch.cat(query, dim=-1), torch.cat(key, dim=-1)

    def _global_forward(self, feats, coors, mask, return_type,
                        return_pooled, global_feats):
        """attention_mode='global' (the JAX _global_forward): lift in, the
        global trunk with the coordinates (and the mask) as its only
        basis, lift out, then the output tail."""
        b, n = feats['0'].shape[0], feats['0'].shape[1]
        basis = {'global_coords': coors if self.differentiable_coors
                 else coors.detach()}
        if mask is not None:
            basis['global_mask'] = mask
        x = dict(self.lift_in(feats))
        for degree, c in self.fiber_hidden:
            if str(degree) not in x:
                x[str(degree)] = feats['0'].new_zeros(b, n, c,
                                                      2 * degree + 1)
        x = self.trunk(x, (None, None, None), None, basis, global_feats)
        return self._output(self.lift_out(x), return_type, return_pooled,
                            mask)

    def _output(self, x, return_type, return_pooled, mask):
        """The output tail shared by both modes: norm_out, linear_out
        (reduce_dim_out), the degree-1 Cartesian permutation, the mean over
        the (real) nodes with return_pooled, the conventions of
        `forward`."""
        if self.apply_norm_out:
            x = self.norm_out(x)
        if self.linear_out is not None:
            x = {d: t[..., 0, :] for d, t in self.linear_out(x).items()}
        x = _permute_degree1(x, _IRREP_TO_CART)
        if return_pooled:
            x = {d: masked_mean(t, mask, dim=1) for d, t in x.items()}
        if '0' in x:
            x['0'] = x['0'][..., 0]
        if return_type is not None:
            return x[str(return_type)]
        return x


class SE3Transformer:
    """Eager convenience wrapper mirroring the JAX SE3Transformer's call
    style:

        model = SE3Transformer(dim=64, depth=2, num_degrees=2, device='cpu')
        out = model(feats, coors, mask, return_type=0)

    The module (`module_class` with the keyword fields given) is built, its
    parameters drawn from a generator seeded `seed`, on the first call, or
    by init(); `params` is its state dict (None before). For training and
    serving use the module itself (training, inference): this wrapper is
    for parity tests and interactive exploration."""

    model_family = 'se3_v1'
    module_class = SE3TransformerModule

    def __init__(self, *, seed: int = 0, **kwargs):
        self.kwargs = kwargs
        self.seed = seed
        self.module = None

    @property
    def params(self):
        return None if self.module is None else self.module.state_dict()

    def init(self, generator: Optional[torch.Generator] = None):
        """Build the module with its parameters drawn from `generator`
        (default: seeded `seed`); returns its state dict."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        self.module = self.module_class(**self.kwargs, generator=generator)
        return self.params

    def __call__(self, feats, coors, mask=None, **kwargs):
        if self.module is None:
            self.init()
        return self.module(feats, coors, mask=mask, **kwargs)
