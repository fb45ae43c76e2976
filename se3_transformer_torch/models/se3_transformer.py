"""SE3TransformerModule: the port of se3_transformer_tpu/models/se3_transformer.py
restricted to the fields the `flagship_fast` recipe uses.

The forward is the JAX module's kNN path, step for step: self-excluded
pairwise geometry -> fixed-K neighbor selection -> the flat 'pfq_flat'
basis -> conv_in -> trunk -> conv_out -> norm_out (on with reversible)
-> linear_out (reduce_dim_out) -> the degree-1 Cartesian permutation ->
the output of `return_type`, with the JAX conventions.

Every other JAX field is accepted only at its JAX default: any other value
raises NotImplementedError, so nothing is silently ignored. The branches
the port does not implement (shared_radial_hidden=False, fuse_basis=False,
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
from ..ops.conv import ConvSE3
from ..ops.core import LinearSE3, NormSE3
from ..ops.fiber import Fiber
from ..ops.neighbors import exclude_self_indices, remove_self, select_neighbors
from ..ops.trunk import SequentialTrunk
from ..utils.helpers import resolve_device

# JAX SE3TransformerModule fields this port does not implement, with the
# JAX defaults they must keep
_JAX_ONLY_DEFAULTS = dict(
    num_tokens=None, num_positions=None,
    num_edge_tokens=None, edge_dim=None, use_null_kv=False,
    differentiable_coors=False, fourier_encode_dist=False,
    rel_dist_num_fourier_features=4, attend_sparse_neighbors=False,
    num_adj_degrees=None, adj_dim=0, max_sparse_neighbors=float('inf'),
    dim_in=None, dim_out=None, norm_out=False, num_conv_layers=0,
    causal=False,
    global_feats_dim=None, linear_proj_keys=False,
    one_headed_key_values=False, tie_key_values=False,
    rotary_position=False, rotary_rel_dist=False, norm_gated_scale=False,
    use_egnn=False, egnn_hidden_dim=32, egnn_weights_clamp_value=None,
    egnn_feedforward=False, hidden_fiber_dict=None, out_fiber_dict=None,
    conv_backend='dense', fuse_pairwise=False, flash_interpret=False,
    pallas=None, conv_bf16=False, pallas_interpret=False,
    pallas_attention=None, pallas_attention_interpret=False,
    matmul_precision=None, edge_chunks=None, sequence_parallel=None,
    mesh=None, ring_overlap=True, ring_exchange=True, attention_mode='knn',
    global_materialize=False)


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
            elif leaf.startswith('w3_'):
                _truncated_normal_(p, (1 / p.shape[0]) ** 0.5 / _TRUNC_STD,
                                   generator)
            elif re.fullmatch(r'w\d+', leaf):
                p.copy_(torch.randn(p.shape, generator=generator)
                        * p.shape[0] ** -0.5)
            elif leaf == 'weight' or leaf.startswith('scale'):
                p.fill_(1.)
            elif leaf == 'bias' or leaf.startswith('b3_'):
                p.zero_()
            else:
                raise ValueError(f'no initializer for parameter {name}')


class SE3TransformerModule(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 24,
                 depth: int = 2, input_degrees: int = 1,
                 num_degrees: Optional[int] = None, output_degrees: int = 1,
                 valid_radius: float = 1e5, reversible: bool = False,
                 remat_policy: Optional[str] = None,
                 attend_self: bool = False,
                 num_neighbors=float('inf'),
                 shared_radial_hidden: bool = False, fuse_basis: bool = False,
                 radial_bf16: bool = False, reduce_dim_out: bool = False, *,
                 device='cuda',
                 generator: Optional[torch.Generator] = None, **jax_fields):
        super().__init__()
        device = resolve_device(device)
        for key, value in jax_fields.items():
            if key not in _JAX_ONLY_DEFAULTS:
                raise TypeError(f'unknown field {key!r}')
            if value != _JAX_ONLY_DEFAULTS[key]:
                raise NotImplementedError(
                    f'{key}={value!r} is not ported (only the JAX default '
                    f'{_JAX_ONLY_DEFAULTS[key]!r})')
        for ok, what in ((shared_radial_hidden, 'shared_radial_hidden=False'),
                         (fuse_basis, 'fuse_basis=False'),
                         (attend_self, 'attend_self=False'),
                         (input_degrees == 1, f'input_degrees={input_degrees}'),
                         (output_degrees in (1, 2),
                          f'output_degrees={output_degrees}'),
                         (num_degrees is not None, 'num_degrees=None')):
            if not ok:
                raise NotImplementedError(f'{what} is not ported')
        self.num_degrees = num_degrees
        self.output_degrees = output_degrees
        self.valid_radius = valid_radius
        self.num_neighbors = num_neighbors
        # reversible blocks imply the output norm (JAX _body)
        self.apply_norm_out = reversible

        fiber_in = Fiber.create(1, dim)
        fiber_hidden = Fiber.create(num_degrees, dim)
        fiber_out = Fiber.create(output_degrees, dim)
        self.conv_in = ConvSE3(fiber_in, fiber_hidden,
                               radial_bf16=radial_bf16)
        self.trunk = SequentialTrunk(fiber_hidden, depth=depth, heads=heads,
                                     dim_head=dim_head,
                                     radial_bf16=radial_bf16,
                                     reversible=reversible,
                                     remat_policy=remat_policy)
        self.conv_out = ConvSE3(fiber_hidden, fiber_out,
                                radial_bf16=radial_bf16)
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
        """feats [b, n, dim], coors [b, n, 3], mask [b, n] bool -> the
        output of degree `return_type`, or the dict of every output degree
        when it is None; output_degrees == 1 forces return_type 0.
        Degree 0 is [b, n, dim] ([b, n] with reduce_dim_out); degree 1 is
        [b, n, dim, 3] ([b, n, 3] with reduce_dim_out), in Cartesian
        order."""
        if self.output_degrees == 1:
            return_type = 0
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
        basis = get_basis(hood.rel_pos, self.num_degrees - 1,
                          layout='pfq_flat')
        edge_info = (hood.indices, hood.mask)

        x = {'0': feats[..., None]}
        x = self.conv_in(x, edge_info, hood.rel_dist, basis)
        x = self.trunk(x, edge_info, hood.rel_dist, basis)
        x = self.conv_out(x, edge_info, hood.rel_dist, basis)
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
