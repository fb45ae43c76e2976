"""SE3TransformerModule: the port of se3_transformer_tpu/models/se3_transformer.py
restricted to the fields the `flagship_fast` and `flagship` recipes and the
assembly model (attention_mode='global') use.

The forward is the JAX module's kNN path, step for step: self-excluded
pairwise geometry -> fixed-K neighbor selection -> the basis (the flat
'pfq_flat' layout with fuse_basis, the structured 'pqf' one without, as
the JAX module picks it on the kernel path) -> conv_in -> trunk ->
conv_out -> norm_out (on with reversible) -> linear_out (reduce_dim_out)
-> the degree-1 Cartesian permutation -> the output of `return_type`, with
the JAX conventions. edge_chunks streams every ConvSE3's contraction over
that many node chunks. pallas_attention=True runs every unfused attention
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

Every other JAX field is accepted only at its JAX default: any other value
raises NotImplementedError, so nothing is silently ignored. The branches
the port does not implement (shared_radial_hidden=False,
attend_self=False, input_degrees other than 1, output_degrees other than
1 or 2) raise likewise.
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch
from torch import nn

from ..basis import get_basis
from ..kernels.flash import flash_sh_payload
from ..ops.conv import ConvSE3
from ..ops.core import LinearSE3, NormSE3
from ..ops.fiber import Fiber
from ..ops.neighbors import exclude_self_indices, remove_self, select_neighbors
from ..ops.trunk import SequentialTrunk
from ..utils.helpers import resolve_device

# JAX SE3TransformerModule fields this port does not implement, with the
# JAX defaults they must keep
_JAX_ONLY_DEFAULTS = dict(
    num_positions=None, num_edge_tokens=None, edge_dim=None,
    differentiable_coors=False, fourier_encode_dist=False,
    rel_dist_num_fourier_features=4, attend_sparse_neighbors=False,
    num_adj_degrees=None, adj_dim=0, max_sparse_neighbors=float('inf'),
    dim_in=None, dim_out=None, num_conv_layers=0,
    causal=False,
    global_feats_dim=None, linear_proj_keys=False,
    one_headed_key_values=False, tie_key_values=False,
    rotary_position=False, rotary_rel_dist=False, norm_gated_scale=False,
    use_egnn=False, egnn_hidden_dim=32, egnn_weights_clamp_value=None,
    egnn_feedforward=False, hidden_fiber_dict=None, out_fiber_dict=None,
    conv_backend='dense', flash_interpret=False,
    pallas=None, conv_bf16=False, pallas_interpret=False,
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
    ('rotary_position', False, 'global attention does not support rotary '
     'embeddings'),
    ('rotary_rel_dist', False, 'global attention does not support rotary '
     'embeddings'),
    ('linear_proj_keys', False, 'global attention needs conv keys'),
    ('fourier_encode_dist', False, 'global attention consumes raw '
     'distances only'),
    ('num_conv_layers', 0, 'global mode has no per-edge convs'))


# fields the JAX module refuses beside fuse_pairwise (its _forward asserts)
_NOT_WITH_FUSE_PAIRWISE = ('sequence_parallel', 'rotary_position',
                           'rotary_rel_dist', 'linear_proj_keys', 'conv_bf16')


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


# degree-1 features are in the irrep order (y, z, x) of the real spherical
# harmonics; the output is permuted back to Cartesian (x, y, z)
_IRREP_TO_CART = (2, 0, 1)


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
    scales, zeros for biases."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            parts = name.split('.')
            leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else '')
            if re.fullmatch(r'Dense_\d+', parent) and leaf == 'weight':
                _truncated_normal_(p, (1 / p.shape[1]) ** 0.5 / _TRUNC_STD,
                                   generator)
            elif name == 'token_emb.weight':
                # flax nn.Embed: normal of variance 1 / features
                p.copy_(torch.randn(p.shape, generator=generator)
                        * p.shape[1] ** -0.5)
            elif leaf.startswith('w3_'):
                _truncated_normal_(p, (1 / p.shape[0]) ** 0.5 / _TRUNC_STD,
                                   generator)
            elif re.fullmatch(r'w\d+', leaf):
                p.copy_(torch.randn(p.shape, generator=generator)
                        * p.shape[0] ** -0.5)
            elif leaf == 'weight' or leaf.startswith('scale'):
                p.fill_(1.)
            elif leaf == 'bias' or leaf.startswith(('b3_', 'null_')):
                p.zero_()
            else:
                raise ValueError(f'no initializer for parameter {name}')


class SE3TransformerModule(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 24,
                 depth: int = 2, input_degrees: int = 1,
                 num_degrees: Optional[int] = None, output_degrees: int = 1,
                 valid_radius: float = 1e5, reversible: bool = False,
                 remat_policy: Optional[str] = None,
                 attend_self: bool = True,
                 num_neighbors=float('inf'),
                 shared_radial_hidden: bool = False, fuse_basis: bool = False,
                 radial_bf16: bool = False, reduce_dim_out: bool = False,
                 edge_chunks: Optional[int] = None,
                 pallas_attention: Optional[bool] = None,
                 fuse_pairwise=False, num_tokens: Optional[int] = None,
                 use_null_kv: bool = False, norm_out: bool = False,
                 attention_mode: str = 'knn',
                 global_materialize: bool = False, *, device='cuda',
                 generator: Optional[torch.Generator] = None, **jax_fields):
        super().__init__()
        device = resolve_device(device)
        if attention_mode not in ('knn', 'global'):
            raise ValueError(f"unknown attention_mode {attention_mode!r} "
                             f"(want 'knn' or 'global')")
        self.attention_mode = attention_mode
        if attention_mode == 'global':
            for key, allowed, why in _NOT_WITH_GLOBAL:
                if jax_fields.get(key, allowed) != allowed:
                    raise ValueError(f"attention_mode='global' does not "
                                     f"take {key}={jax_fields[key]!r}: {why}")
            if resolve_fused_attention(fuse_pairwise, depth) != \
                    (False,) * depth:
                raise ValueError("fuse_pairwise is subsumed by "
                                 "attention_mode='global'; leave it False")
            if remat_policy is not None:
                raise ValueError(f'remat_policy={remat_policy!r} tags conv '
                                 f'outputs, which the global trunk never '
                                 f'materializes')
            if reversible and jax_fields.get('global_feats_dim') is not None:
                raise ValueError('reversibility and global features are '
                                 'not compatible')
            if num_degrees is not None and output_degrees > num_degrees:
                raise ValueError('global mode projects out with a '
                                 'LinearSE3, so every output degree must '
                                 'exist in the hidden fiber')
        elif use_null_kv:
            raise NotImplementedError("use_null_kv is ported for "
                                      "attention_mode='global' only")
        if pallas_attention not in (None, False, True):
            raise ValueError(f'pallas_attention must be None, False or True, '
                             f'got {pallas_attention!r}')
        self.fused_attention = resolve_fused_attention(fuse_pairwise, depth)
        if any(self.fused_attention):
            for key in _NOT_WITH_FUSE_PAIRWISE:
                if jax_fields.get(key, _JAX_ONLY_DEFAULTS[key]) != \
                        _JAX_ONLY_DEFAULTS[key]:
                    raise ValueError(f'fuse_pairwise does not compose with '
                                     f'{key}={jax_fields[key]!r}')
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
        # the global convs are always grouped (JAX forces the shared trunk)
        shared = shared_radial_hidden or attention_mode == 'global'
        for ok, what in ((shared, 'shared_radial_hidden=False'),
                         (attend_self, 'attend_self=False'),
                         (input_degrees == 1, f'input_degrees={input_degrees}'),
                         (output_degrees in (1, 2),
                          f'output_degrees={output_degrees}'),
                         (num_degrees is not None, 'num_degrees=None')):
            if not ok:
                raise NotImplementedError(f'{what} is not ported')
        self.num_degrees = num_degrees
        self.output_degrees = output_degrees
        # always False: differentiable_coors=True is refused above
        self.differentiable_coors = jax_fields.get('differentiable_coors',
                                                   False)
        self.valid_radius = valid_radius
        self.num_neighbors = num_neighbors
        # reversible blocks imply the output norm (JAX _body)
        self.apply_norm_out = norm_out or reversible
        # the basis layout the convs take (the JAX module's choice on the
        # kernel path)
        self.basis_layout = 'pfq_flat' if fuse_basis else 'pqf'

        fiber_in = Fiber.create(1, dim)
        self.fiber_hidden = fiber_hidden = Fiber.create(num_degrees, dim)
        fiber_out = Fiber.create(output_degrees, dim)
        if num_tokens is not None:
            self.token_emb = nn.Embedding(num_tokens, dim)
        conv_kwargs = dict(radial_bf16=radial_bf16, fuse_basis=fuse_basis,
                           edge_chunks=edge_chunks)
        if attention_mode == 'global':
            self.lift_in = LinearSE3(fiber_in, fiber_hidden)
        else:
            self.conv_in = ConvSE3(fiber_in, fiber_hidden, **conv_kwargs)
        self.trunk = SequentialTrunk(fiber_hidden, depth=depth, heads=heads,
                                     dim_head=dim_head,
                                     reversible=reversible,
                                     remat_policy=remat_policy,
                                     pallas_attention=pallas_attention,
                                     fused_attention=self.fused_attention,
                                     attention_mode=attention_mode,
                                     global_materialize=global_materialize,
                                     use_null_kv=use_null_kv,
                                     **conv_kwargs)
        if attention_mode == 'global':
            self.lift_out = LinearSE3(fiber_hidden, fiber_out)
        else:
            self.conv_out = ConvSE3(fiber_hidden, fiber_out, **conv_kwargs)
        if self.apply_norm_out:
            self.norm_out = NormSE3(fiber_out, nonlin=lambda t: t)
        self.linear_out = LinearSE3(fiber_out, fiber_out.to(1)) \
            if reduce_dim_out else None
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)
        self.to(device)

    def forward(self, feats: torch.Tensor, coors: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                return_type: Optional[int] = None):
        """feats [b, n, dim] (integer tokens [b, n] with num_tokens),
        coors [b, n, 3], mask [b, n] bool -> the output of degree
        `return_type`, or the dict of every output degree when it is None;
        output_degrees == 1 forces return_type 0. Degree 0 is [b, n, dim]
        ([b, n] with reduce_dim_out); degree 1 is [b, n, dim, 3] ([b, n,
        3] with reduce_dim_out), in Cartesian order."""
        if self.output_degrees == 1:
            return_type = 0
        if hasattr(self, 'token_emb'):
            feats = self.token_emb(feats)
        if self.attention_mode == 'global':
            return self._global_forward(feats, coors, mask, return_type)
        b, n = feats.shape[0], feats.shape[1]
        num_neighbors = int(min(self.num_neighbors, n - 1))
        if num_neighbors <= 0:
            raise ValueError('must fetch at least 1 neighbor')

        self_excl = exclude_self_indices(n, device=coors.device)
        rel_pos = remove_self(coors[:, :, None, :] - coors[:, None, :, :],
                              self_excl)                   # [b, n, n-1, 3]
        indices = self_excl[None].expand(b, n, n - 1)
        pair_mask = None
        if mask is not None:
            pair_mask = remove_self(mask[:, :, None] & mask[:, None, :],
                                    self_excl)
        hood, _ = select_neighbors(rel_pos, indices, num_neighbors,
                                   self.valid_radius, pair_mask=pair_mask)
        # conv_in and conv_out always take the per-pair basis; the fused
        # attention blocks take the SH stack
        basis = get_basis(hood.rel_pos, self.num_degrees - 1,
                          differentiable=self.differentiable_coors,
                          layout=self.basis_layout)
        if any(self.fused_attention):
            basis['flash_sh'] = flash_sh_payload(hood.rel_pos,
                                                 self.num_degrees - 1)
        edge_info = (hood.indices, hood.mask)

        x = {'0': feats[..., None]}
        x = self.conv_in(x, edge_info, hood.rel_dist, basis)
        x = self.trunk(x, edge_info, hood.rel_dist, basis)
        x = self.conv_out(x, edge_info, hood.rel_dist, basis)
        return self._output(x, return_type)

    def _global_forward(self, feats, coors, mask, return_type):
        """attention_mode='global' (the JAX _global_forward): lift in, the
        global trunk with the coordinates (and the mask) as its only
        basis, lift out, then the output tail."""
        b, n = feats.shape[0], feats.shape[1]
        # coordinates take no gradient (differentiable_coors=False)
        basis = {'global_coords': coors.detach()}
        if mask is not None:
            basis['global_mask'] = mask
        x = dict(self.lift_in({'0': feats[..., None]}))
        for degree, c in self.fiber_hidden:
            if str(degree) not in x:
                x[str(degree)] = feats.new_zeros(b, n, c, 2 * degree + 1)
        x = self.trunk(x, (None, None), None, basis)
        return self._output(self.lift_out(x), return_type)

    def _output(self, x, return_type):
        """The output tail shared by both modes: norm_out, linear_out
        (reduce_dim_out), the degree-1 Cartesian permutation, the
        conventions of `forward`."""
        if self.apply_norm_out:
            x = self.norm_out(x)
        if self.linear_out is not None:
            x = {d: t[..., 0, :] for d, t in self.linear_out(x).items()}
        if '1' in x:
            # slices, not an index list: that would be copied to the device
            x['1'] = torch.stack([x['1'][..., k] for k in _IRREP_TO_CART], -1)
        x['0'] = x['0'][..., 0]
        if return_type is not None:
            return x[str(return_type)]
        return x
