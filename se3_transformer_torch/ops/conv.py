"""Tensor-field-network convolution: the port of se3_transformer_tpu/ops/conv.py
(its dense contraction backend, and the registry that adds the so2 one).

The radial trunk (Dense -> LayerNorm -> GELU, twice) reads the edge
features: the distance, or with fourier_encode_dist its sin/cos features at
num_fourier_features dyadic scales and the distance itself
(utils.helpers.fourier_encode), then the gathered edges [b, n, k, edge_dim]
of edge_info when edge_dim > 0 (the model's edge and adjacency
embeddings). The edges widen the trunk's input only: the kernels take h
after the trunk.

shared_radial_hidden=False (the JAX default): each (d_in, d_out) pair is a
PairwiseConvSE3 `pair_{d_in}_{d_out}` with its own trunk, w3 [mid, c_in*F,
c_out] and b3 [c_in*F, c_out], and one contraction of its own:
_radial_contract on V2 = basis . x (kernel #3), or with fuse_basis
_radial_contract_bx (kernel #1 with the flat basis, #2 with the structured
one).

shared_radial_hidden=True: one trunk is shared by every pair of the
ConvSE3, each pair with its own grouped parameters w3_{d_in}_{d_out} and
b3_{d_in}_{d_out}:

  * fuse_basis=True: one basis-fused call per pair, contracting the basis
    with the gathered neighbor features inside the kernel:
    kernels.pairwise.pairwise_contract_bxf for the flat (p, f, q) basis
    (get_basis layout 'pfq_flat', kernel #1) and
    kernels.pairwise.pairwise_contract_bx for the structured [P, Q, F] one
    (get_basis's default 'pqf', kernel #2), as the JAX ConvSE3 takes both.
  * fuse_basis=False: per pair, V2 = basis . x by einsum from the
    structured (P, Q, F) basis; the pairs of one output degree are
    concatenated along the contracted axis (V2, w3 and b3 alike) and make
    one call of kernels.pairwise.pairwise_contract per output degree.

  * fuse_pairwise=True (program mode, for the streaming attention of
    kernels.flash): the radial trunk only. forward returns {'h', 'pairs',
    'arm', 'w3', 'b3'}, the grouped w3/b3 of each output degree
    concatenated along IF as the fuse_basis=False branch does, and gathers
    nothing; the per-edge contraction runs inside the attention kernel.
  * global_radial=True (program mode of the kNN-free global attention):
    not even the trunk runs. forward returns {'rp', 'pairs', 'arm', 'w3',
    'b3'}, rp the trunk's raw parameters as the 8-tuple (w1 [1, mid], b1,
    ln1 scale, ln1 bias, w2 [mid, mid] (in, out), b2, ln2 scale, ln2 bias)
    of kernels.flash's global mode, which rebuilds distances, the trunk
    and the harmonics per tile from coordinates.

Both program modes take the shared trunk only, as JAX asserts.

backend='so2' (se3_transformer_torch/so2, JAX's conv_backend): the same
parameters; the layer reads the edge frames basis['so2'] in place of the
per-pair basis, rotates each input degree into the frames once, and per
pair takes the band z = banded_z(xr) in place of V2 (grouped: the pairs of
an output degree concatenated into one _radial_contract, as the dense V2s;
per pair: so2_pair_contract on the band rows alone), then rotates each
output degree back once. fuse_basis does not apply to it, as in JAX. In the
program modes the arm rides in the program ('arm') to the streaming
kernels.

edge_chunks streams the node axis through either contraction in that many
chunks, zero-padding it to a multiple (_stream_node_chunks). Under
autograd the backward runs the fused backward kernels; gradients reach w3
through its cast to the radial dtype, b3, the radial trunk and the
gathered features.

On a CUDA tensor each contraction launches its kernel, unless its widths
are past what the kernel is built for (kernels.pairwise.pairwise_limit):
such a call runs the kernel's plain version under autograd instead, warns
once per (kernel, widths) and counts in the wrapper's `.routed`
(kernels.routing.route). The decision is made here, from the widths alone,
before any launch; the backward of a call that launched runs kernels A
and B, which take every width the forwards take. The flagship recipes'
widths never route.

radial_bf16 runs the trunk and the radial operands (h, w3) in bfloat16; the
bias and every accumulation stay float32, and LayerNorm statistics are
float32 as in flax.

conv_bf16 (the JAX field) stores the equivariant operands of each
contraction bf16: V2 (or the so2 band z) in _radial_contract, the basis and
the gathered features in _radial_contract_bx, cast before the node-chunk
split so that every chunk and every saved residual is half-width. The math
stays float32 on the exactly upcast values: on a card the kernels' bf16
storage arms (kernels.pairwise), on the CPU the plain versions. The
basis-fused backward rebuilds V2 in float32 from the upcast residuals (so
kernels A and B run their float32 arm there) and returns the basis' and
x's gradients bf16; the V2-given backward runs A and B on the bf16 V2 and
returns dV2 bf16, as JAX's custom VJPs do.

pallas (the JAX field): None or True runs the kernels on a card and their
plain versions on the CPU; False runs the plain versions on every device,
with no launch and nothing counted in `.routed` (a choice, not a route),
and, as JAX's XLA path, no basis-fused contraction: V2 = basis . x by
einsum, one _radial_contract a pair or an output degree.

PairwiseConvSE3(fused=False) is JAX's RadialFunc formulation, the numerics
oracle of the fused path that no model reaches: a radial MLP `radial`
(the trunk, then Dense_2 [mid -> F * c_in * c_out]) gives each edge's
kernel R [c_out, c_in, F], contracted in the reference order (R with x,
then with the basis); dense backend only.
"""
from __future__ import annotations

import importlib
import re
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F_
from torch import nn

from ..kernels import pairwise as kp
from ..kernels import routing
from ..kernels.pairwise import (
    pairwise_contract, pairwise_contract_bx, pairwise_contract_bxf,
)
from ..quant.qtensor import (
    QuantTensor, concat_weights, float_weight, weight_or_none,
)
from ..so2.contract import banded_z
from ..so2.frames import rotate_in, rotate_out
from ..utils.helpers import (
    batched_index_select, fourier_encode, masked_mean, to_order,
)
from .core import LinearSE3, gelu, residual_se3
from .fiber import Fiber

Features = Dict[str, torch.Tensor]
# edge_info = (neighbor_indices [b,n,k], neighbor_mask [b,n,k] | None,
#              edges [b,n,k,edge_dim] | None)
EdgeInfo = Tuple[torch.Tensor, Optional[torch.Tensor],
                 Optional[torch.Tensor]]

# radial-MLP hidden width (the JAX package's DEFAULT_MID_DIM)
DEFAULT_MID_DIM = 128

# The contraction backends (the JAX package's CONV_BACKENDS). 'dense' is the
# Clebsch-Gordan path of this file; another backend registers a pairwise
# contract callable
#     impl(h, w3, b3, payload, x, *, d_in, d_out, edge_chunks, conv_bf16,
#          pallas, edge_frame_io=False) -> [..., c_out, P]
# with the dense path's parameters, `payload` being what the model puts
# under the backend's name in the basis dict (the so2 backend's edge frames
# under basis['so2']). 'so2' registers itself on first use.
CONV_BACKENDS: Dict[str, Optional[Callable]] = {'dense': None}
_LAZY_BACKENDS = {'so2': 'se3_transformer_torch.so2.contract'}

# one backend for every layer, or first-match-wins (layer regex, backend)
# pairs
BackendSpec = Union[str, Tuple[Tuple[str, str], ...]]


def register_conv_backend(name: str, impl: Callable) -> None:
    """Register a pairwise-contraction backend; the latest registration of
    a name wins."""
    CONV_BACKENDS[name] = impl


def get_conv_backend(name: str) -> Optional[Callable]:
    """The contract callable of backend `name` (None for 'dense', whose
    path is inline here); KeyError for an unknown name."""
    if name not in CONV_BACKENDS and name in _LAZY_BACKENDS:
        module = importlib.import_module(_LAZY_BACKENDS[name])
        register_conv_backend(name, module.so2_pair_contract)
    if name not in CONV_BACKENDS:
        raise KeyError(f'unknown conv backend {name!r} (registered: '
                       f'{sorted(set(CONV_BACKENDS) | set(_LAZY_BACKENDS))})')
    return CONV_BACKENDS[name]


def resolve_conv_backend(spec: BackendSpec, layer_name: str) -> str:
    """The backend of one conv layer ('conv_in', 'preconv{i}',
    'attn_block{i}/to_v', 'attn_block{i}/to_k', 'conv_out'): a string
    applies to every layer; (pattern, backend) pairs match first-match-wins
    by re.search, with an implicit ('.*', 'dense') tail."""
    if isinstance(spec, str):
        return spec
    for pattern, backend in spec:
        if re.search(pattern, layer_name):
            return backend
    return 'dense'


def dense(x: torch.Tensor, layer: nn.Linear, dtype=None) -> torch.Tensor:
    """flax nn.Dense(dtype=...): input, kernel and bias cast to `dtype`,
    the product rounded to it, then the bias added in it. A quantized
    kernel (a QuantTensor weight [out, in], scale [out, 1]) is the JAX
    _QuantDense: the storage contracts in float32, the scale multiplies
    the product, the float32 bias is added, and the result is float32."""
    if isinstance(layer.weight, QuantTensor):
        y = torch.matmul(x.float(), layer.weight.q.float().t())
        return y * layer.weight.scale.t() + layer.bias
    dtype = dtype or x.dtype
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).t())
    return y + layer.bias.to(dtype)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm,
               dtype=None) -> torch.Tensor:
    """flax nn.LayerNorm(dtype=...): float32 statistics with the one-pass
    variance E[x^2] - E[x]^2 (clipped at 0), result cast to `dtype` (None:
    x's dtype)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp(min=0.)
    mul = torch.rsqrt(var + layer.eps) * layer.weight
    return ((x32 - mean) * mul + layer.bias).to(dtype or x.dtype)


def unflatten_basis(basis_flat: torch.Tensor, P: int, Q: int,
                    F: int) -> torch.Tensor:
    """[..., P*F*Q] (p, f, q)-ordered flat basis -> the structured
    [..., P, Q, F] form."""
    b = basis_flat.reshape(*basis_flat.shape[:-1], P, F, Q)
    return b.transpose(-1, -2)


def _basis_is_flat(basis: torch.Tensor, x: torch.Tensor) -> bool:
    """get_basis(layout='pfq_flat') entries are [..., P*F*Q]: one axis
    fewer than the neighbor features x [..., C, Q]; the structured form
    has one more."""
    return basis.ndim == x.ndim - 1


def _stream_node_chunks(contract: Callable, operands: Sequence[torch.Tensor],
                        edge_chunks: Optional[int]) -> torch.Tensor:
    """contract(*operands) over the node axis (axis 1) in `edge_chunks`
    chunks (None: in one call), one contraction per chunk. When n is not
    a multiple of the
    chunk count the node axis is zero-padded up to one and the pad rows
    are sliced off the result; every operand is per node, so the pad rows
    add nothing, and under autograd their cotangents are zero.

    The JAX package wraps each chunk in jax.checkpoint so that the XLA
    path's materialized R is not kept for the backward. Here each chunk's
    contraction is one custom op whose autograd saves only its operands
    (the chunk's slices), so R lives only inside the call, on the CPU's
    plain path as well; the backward reruns no forward."""
    if edge_chunks is None:
        return contract(*operands)
    n = operands[0].shape[1]
    c = min(edge_chunks, n)
    n_pad = -(-n // c) * c

    def split(a):
        if n_pad != n:
            a = F_.pad(a, (0, 0) * (a.ndim - 2) + (0, n_pad - n))
        return a.reshape(a.shape[0], c, n_pad // c, *a.shape[2:]).unbind(1)

    out = torch.stack([contract(*chunk) for chunk in
                       zip(*(split(a) for a in operands))], dim=1)
    out = out.reshape(out.shape[0], n_pad, *out.shape[3:])
    return out[:, :n] if n_pad != n else out


def _radial_contract(h: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                     v2: torch.Tensor, edge_chunks: Optional[int],
                     conv_bf16: bool = False,
                     pallas: Optional[bool] = None) -> torch.Tensor:
    """h [b,n,k,mid], w3 [mid,IF,O], b3 [IF,O], v2 [b,n,k,P,IF] ->
    [b,n,k,P,O] through pairwise_contract (or, past the kernels' limits on
    a card, or with pallas=False, its plain version), optionally streaming
    the node axis in `edge_chunks` chunks; conv_bf16 stores v2 bf16 first.
    A QuantTensor w3 takes kernel #3's scaled arm (fused_pairwise_conv
    with w3_scale): serving only, no backward."""
    P, IF = v2.shape[-2:]
    mid, O = h.shape[-1], w3.shape[-1]
    if conv_bf16:
        # before the chunk split: every chunk and saved residual half-width
        v2 = v2.to(torch.bfloat16)
    w3c, w3_scale = weight_or_none(w3)
    if w3_scale is None:
        w3c = w3c.to(h.dtype)
    limit = kp.pairwise_limit('fwd', mid, O, P, dtype=h.dtype,
                              operand_dtype=v2.dtype,
                              scaled=w3_scale is not None)

    def contract(h_c, v2_c):
        lead = h_c.shape[:-1]
        E = lead.numel()
        h2 = h_c.reshape(E, mid).contiguous()
        v2_2 = v2_c.reshape(E, P, IF).contiguous()
        if pallas is False or routing.route(
                kp.fused_pairwise_conv, h2.device.type, limit,
                (mid, IF, O, P)):
            out = kp.fused_pairwise_conv_plain(h2, w3c, v2_2, b3,
                                               w3_scale=w3_scale)
        elif w3_scale is not None:
            out = kp.fused_pairwise_conv(h2, w3c, v2_2, b3,
                                         w3_scale=w3_scale)
        else:
            out = pairwise_contract(h2, w3c, b3, v2_2)
        return out.reshape(*lead, P, O)

    return _stream_node_chunks(contract, (h, v2), edge_chunks)


def _radial_contract_bx(h: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                        basis: torch.Tensor, x: torch.Tensor,
                        pqf: Tuple[int, int, int],
                        edge_chunks: Optional[int],
                        conv_bf16: bool = False) -> torch.Tensor:
    """Basis-fused: h [b,n,k,mid], w3 [mid,C*F,O], b3 [C*F,O], the flat
    basis [b,n,k,P*F*Q] (through pairwise_contract_bxf) or the structured
    one [b,n,k,P,Q,F] (through pairwise_contract_bx), x [b,n,k,C,Q] ->
    [b,n,k,P,O], optionally streaming the node axis; conv_bf16 stores the
    basis and x bf16 first. A QuantTensor w3 is dequantized as a transient
    (kernels #1 and #2 take no scale epilogue, as in JAX)."""
    P, Q, F = pqf
    C, O, mid = x.shape[-2], w3.shape[-1], h.shape[-1]
    if conv_bf16:
        # before the chunk split, as _radial_contract's v2 (the model's
        # basis arrives bf16 already: it casts it once, in its payloads)
        basis, x = basis.to(torch.bfloat16), x.to(torch.bfloat16)
    w3c = float_weight(w3).to(h.dtype)
    flat = _basis_is_flat(basis, x)
    limit = kp.pairwise_limit('bxf' if flat else 'bx', mid, O, P, Q, h.dtype,
                              operand_dtype=x.dtype)

    def contract(h_c, basis_c, x_c):
        lead = h_c.shape[:-1]
        E = lead.numel()
        # the kernel takes contiguous rows; a gather from an einsum's
        # permuted output can keep the source's strides
        h2 = h_c.reshape(E, mid).contiguous()
        x2 = x_c.reshape(E, C, Q).contiguous()
        if flat:
            b2 = basis_c.reshape(E, P * F * Q).contiguous()
            if routing.route(kp.fused_pairwise_conv_bxf, h2.device.type,
                             limit, (mid, C, O, P, Q)):
                out = kp.fused_pairwise_conv_bxf_plain(h2, w3c, b2, x2, pqf,
                                                       b3)
            else:
                out = pairwise_contract_bxf(h2, w3c, b3, b2, x2, pqf)
        else:
            b2 = basis_c.reshape(E, P, Q, F).contiguous()
            if routing.route(kp.fused_pairwise_conv_bx, h2.device.type,
                             limit, (mid, C, O, P, Q)):
                out = kp.fused_pairwise_conv_bx_plain(h2, w3c, b2, x2, b3)
            else:
                out = pairwise_contract_bx(h2, w3c, b3, b2, x2)
        return out.reshape(*lead, P, O)

    return _stream_node_chunks(contract, (h, basis, x), edge_chunks)


def add_radial_trunk(module: nn.Module, in_dim: int,
                     mid: int = DEFAULT_MID_DIM) -> None:
    """The radial trunk's layers on `module`, under the flax names."""
    module.Dense_0 = nn.Linear(in_dim, mid)
    module.LayerNorm_0 = nn.LayerNorm(mid, eps=1e-6)
    module.Dense_1 = nn.Linear(mid, mid)
    module.LayerNorm_1 = nn.LayerNorm(mid, eps=1e-6)


def radial_hidden(module: nn.Module, x: torch.Tensor,
                  dtype=None) -> torch.Tensor:
    """Dense -> LayerNorm -> GELU, twice, in `dtype` (None: x's), with the
    layers add_radial_trunk put on `module`."""
    x = gelu(layer_norm(dense(x, module.Dense_0, dtype), module.LayerNorm_0,
                        dtype))
    return gelu(layer_norm(dense(x, module.Dense_1, dtype),
                           module.LayerNorm_1, dtype))


class RadialFunc(nn.Module):
    """JAX RadialFunc: the radial trunk (float32), then Dense_2 to each
    edge's kernel R [..., c_out, c_in, F] (the unfused formulation)."""

    def __init__(self, num_freq: int, in_dim: int, out_dim: int,
                 edge_dim: int, mid: int = DEFAULT_MID_DIM):
        super().__init__()
        self.shape = (out_dim, in_dim, num_freq)
        add_radial_trunk(self, edge_dim, mid)
        self.Dense_2 = nn.Linear(mid, num_freq * in_dim * out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dense(radial_hidden(self, x), self.Dense_2)
        return x.reshape(*x.shape[:-1], *self.shape)


def pairwise_conv_contract(R: torch.Tensor, B: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """The reference-ordered contraction of one pair (JAX
    pairwise_conv_contract): R [..., c_out, c_in, F], the structured basis
    B [..., P, Q, F], x [..., c_in, Q] -> [..., c_out, P]."""
    W = torch.einsum('...oif,...iq->...oqf', R, x)
    return torch.einsum('...oqf,...pqf->...op', W, B)


class PairwiseConvSE3(nn.Module):
    """One (d_in -> d_out) pair with its own radial trunk, w3 and b3: the
    port of JAX PairwiseConvSE3. backend: 'dense', or a registered backend
    (get_conv_backend) that takes the backend's payload in place of the
    pair's basis and ignores fuse_basis, as in JAX; so2_edge_frame_io: x
    arrives in the edge frame and the output stays there (ConvSE3's
    rotation hoist). The parameters are the same for every backend.
    fused=False is the RadialFunc oracle (module docstring): its own
    parameters under `radial`, the dense backend only."""

    def __init__(self, degree_in: int, nc_in: int, degree_out: int,
                 nc_out: int, edge_dim: int = 1, radial_bf16: bool = False,
                 fuse_basis: bool = False,
                 edge_chunks: Optional[int] = None, backend: str = 'dense',
                 so2_edge_frame_io: bool = False, conv_bf16: bool = False,
                 pallas: Optional[bool] = None, fused: bool = True):
        super().__init__()
        if not fused and backend != 'dense':
            raise ValueError(f'backend {backend!r} requires the fused '
                             f'parameterization (fused=False is the '
                             f'dense-path oracle)')
        self.pqf = (to_order(degree_out), to_order(degree_in),
                    to_order(min(degree_in, degree_out)))
        self.degrees = (degree_in, degree_out)
        self.radial_dtype = torch.bfloat16 if radial_bf16 else None
        # the basis-fused contraction takes the kernel path (JAX's
        # fuse_basis with the Pallas kernel)
        self.fuse_basis = fuse_basis and pallas is not False
        self.edge_chunks = edge_chunks
        self.backend = backend
        self.backend_impl = get_conv_backend(backend)
        self.so2_edge_frame_io = so2_edge_frame_io
        self.conv_bf16 = conv_bf16
        self.pallas = pallas
        self.fused = fused
        if not fused:
            self.radial = RadialFunc(self.pqf[2], nc_in, nc_out, edge_dim)
            return
        add_radial_trunk(self, edge_dim)
        IF = nc_in * self.pqf[2]
        self.w3 = nn.Parameter(torch.zeros(DEFAULT_MID_DIM, IF, nc_out))
        self.b3 = nn.Parameter(torch.zeros(IF, nc_out))

    def forward(self, edge_feats: torch.Tensor, basis: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        """edge_feats [b, n, k, e]; the pair's basis [b, n, k, P*F*Q]
        ('pfq_flat') or [b, n, k, P, Q, F] ('pqf'), or the backend's
        payload; x [b, n, k, c_in, Q] -> [b, n, k, c_out, P]."""
        P, Q, F = self.pqf
        if not self.fused:
            if _basis_is_flat(basis, x):
                basis = unflatten_basis(basis, P, Q, F)
            return pairwise_conv_contract(self.radial(edge_feats), basis, x)
        h = radial_hidden(self, edge_feats, self.radial_dtype)
        if self.backend_impl is not None:
            extra = dict(edge_frame_io=True) if self.so2_edge_frame_io \
                else {}
            return self.backend_impl(h, self.w3, self.b3, basis, x,
                                     d_in=self.degrees[0],
                                     d_out=self.degrees[1],
                                     edge_chunks=self.edge_chunks,
                                     conv_bf16=self.conv_bf16,
                                     pallas=self.pallas, **extra)
        if self.fuse_basis:
            out = _radial_contract_bx(h, self.w3, self.b3, basis, x,
                                      self.pqf, self.edge_chunks,
                                      self.conv_bf16)
        else:
            if _basis_is_flat(basis, x):
                basis = unflatten_basis(basis, P, Q, F)
            v2 = torch.einsum('...pqf,...cq->...pcf', basis, x)
            out = _radial_contract(h, self.w3, self.b3,
                                   v2.reshape(*v2.shape[:-2], -1),
                                   self.edge_chunks, self.conv_bf16,
                                   self.pallas)
        return out.transpose(-1, -2)


class ConvSE3(nn.Module):
    """Graph TFN convolution over precomputed neighborhoods."""

    def __init__(self, fiber_in: Fiber, fiber_out: Fiber,
                 self_interaction: bool = True, pool: bool = True,
                 fourier_encode_dist: bool = False,
                 num_fourier_features: int = 4,
                 edge_chunks: Optional[int] = None,
                 shared_radial_hidden: bool = False, fuse_basis: bool = False,
                 radial_bf16: bool = False, fuse_pairwise: bool = False,
                 global_radial: bool = False, edge_dim: int = 0,
                 backend: str = 'dense', conv_bf16: bool = False,
                 pallas: Optional[bool] = None):
        super().__init__()
        backend_impl = get_conv_backend(backend)
        if backend not in ('dense', 'so2') and (
                shared_radial_hidden or fuse_pairwise or global_radial):
            raise NotImplementedError(
                f'backend {backend!r} runs per pair only: the shared trunk '
                f'and the program modes take the dense and so2 arms')
        if self_interaction and not pool:
            raise ValueError('must pool edges if followed with self '
                             'interaction')
        if (fuse_pairwise or global_radial) and pool:
            raise ValueError('fuse_pairwise and global_radial serve the '
                             'attention kv path (pool=False)')
        if (fuse_pairwise or global_radial) and not shared_radial_hidden:
            raise ValueError('fuse_pairwise and global_radial require '
                             'shared_radial_hidden=True (their kernels take '
                             'the grouped w3/b3 layout)')
        if global_radial and (fourier_encode_dist or edge_dim):
            raise ValueError('global_radial consumes raw distances only (no '
                             'fourier or edge features)')
        self.fiber_in, self.fiber_out = fiber_in, fiber_out
        self.pool = pool
        self.fourier_features = num_fourier_features \
            if fourier_encode_dist else None
        self.radial_dtype = torch.bfloat16 if radial_bf16 else None
        self.shared_radial_hidden = shared_radial_hidden
        # the basis-fused contraction takes the kernel path (module
        # docstring: pallas=False contracts V2 by einsum, as JAX's XLA path)
        self.fuse_basis = fuse_basis and pallas is not False
        self.edge_chunks = edge_chunks
        self.conv_bf16 = conv_bf16
        self.pallas = pallas
        self.fuse_pairwise = fuse_pairwise
        self.global_radial = global_radial
        self.edge_dim = edge_dim
        self.backend = backend
        self.backend_impl = backend_impl
        mid = DEFAULT_MID_DIM
        # the trunk's input: the distance features, then the edges
        in_dim = edge_dim + (1 if not fourier_encode_dist
                             else 2 * num_fourier_features + 1)
        if shared_radial_hidden:
            add_radial_trunk(self, in_dim, mid)
        for d_out, m_out in fiber_out:
            for d_in, m_in in fiber_in:
                if not shared_radial_hidden:
                    self.add_module(f'pair_{d_in}_{d_out}', PairwiseConvSE3(
                        d_in, m_in, d_out, m_out, edge_dim=in_dim,
                        radial_bf16=radial_bf16, fuse_basis=fuse_basis,
                        edge_chunks=edge_chunks, backend=backend,
                        so2_edge_frame_io=backend == 'so2',
                        conv_bf16=conv_bf16, pallas=pallas))
                    continue
                F = to_order(min(d_in, d_out))
                self.register_parameter(
                    f'w3_{d_in}_{d_out}',
                    nn.Parameter(torch.zeros(mid, m_in * F, m_out)))
                self.register_parameter(
                    f'b3_{d_in}_{d_out}',
                    nn.Parameter(torch.zeros(m_in * F, m_out)))
        self.self_interact = LinearSE3(fiber_in, fiber_out) \
            if self_interaction else None

    def edge_features(self, rel_dist: torch.Tensor,
                      edges: Optional[torch.Tensor]) -> torch.Tensor:
        """The trunk's input: [b, n, k] distances -> [b, n, k, 1], or with
        fourier_encode_dist [b, n, k, 2 * num_fourier_features + 1], then
        the edges [b, n, k, edge_dim] concatenated after them."""
        if (edges is None) != (self.edge_dim == 0) or (
                edges is not None and edges.shape[-1] != self.edge_dim):
            raise ValueError(f'the conv takes edges of width {self.edge_dim}, '
                             f'got {None if edges is None else edges.shape}')
        feats = rel_dist[..., None]
        if self.fourier_features is not None:
            feats = fourier_encode(feats, num_encodings=self.fourier_features)
        if edges is not None:
            feats = torch.cat((feats, edges.to(feats.dtype)), dim=-1)
        return feats

    def radial_hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The shared trunk in the radial dtype."""
        return radial_hidden(self, x, self.radial_dtype)

    def _grouped(self):
        """Per output degree, the pairs' w3 [mid, IF, c_out] and b3 [IF,
        c_out] concatenated along IF in fiber_in order (quantized w3 as
        one QuantTensor)."""
        w3s, b3s = {}, {}
        for d_out, _ in self.fiber_out:
            w3s[str(d_out)] = concat_weights(
                [getattr(self, f'w3_{d_in}_{d_out}')
                 for d_in, _ in self.fiber_in], axis=1)
            b3s[str(d_out)] = torch.cat([getattr(self, f'b3_{d_in}_{d_out}')
                                         for d_in, _ in self.fiber_in], dim=0)
        return w3s, b3s

    def _program(self, rel_dist: torch.Tensor,
                 edges: Optional[torch.Tensor]) -> dict:
        """The pairwise program of JAX ConvSE3(fuse_pairwise=True): the
        radial hidden [b, n, k, mid] (of the distances and the edges) and
        the grouped w3/b3."""
        w3s, b3s = self._grouped()
        return dict(h=self.radial_hidden(self.edge_features(rel_dist, edges)),
                    pairs=tuple((d, c) for d, c in self.fiber_in),
                    arm=self.backend, w3=w3s, b3=b3s)

    def _global_program(self) -> dict:
        """The program of JAX ConvSE3(global_radial=True): the trunk's raw
        parameters in flax orientation (Dense kernels [in, out]) and the
        grouped w3/b3, float32: quantized weights dequantized as a
        transient (the global kernel takes no scale epilogue, as in
        JAX)."""
        w3s, b3s = self._grouped()
        w3s = {d: float_weight(w) for d, w in w3s.items()}
        rp = (float_weight(self.Dense_0.weight).t(), self.Dense_0.bias,
              self.LayerNorm_0.weight, self.LayerNorm_0.bias,
              float_weight(self.Dense_1.weight).t(), self.Dense_1.bias,
              self.LayerNorm_1.weight, self.LayerNorm_1.bias)
        return dict(rp=rp, pairs=tuple((d, c) for d, c in self.fiber_in),
                    arm=self.backend, w3=w3s, b3=b3s)

    def forward(self, inp: Features, edge_info: EdgeInfo,
                rel_dist: torch.Tensor, basis: Dict[str, torch.Tensor]
                ) -> Features:
        """inp {d: [b, n, c, 2d+1]}; rel_dist [b, n, k]; basis
        {'d_in,d_out': [b, n, k, P*F*Q] (layout 'pfq_flat') or [b, n, k,
        P, Q, F] ('pqf')}, either with fuse_basis or without; a non-dense
        backend reads its payload basis[backend] instead (the so2 edge
        frames). Pooled: {d: [b, n, c_out, 2d+1]}; else [b, n, k, c_out,
        2d+1]; with fuse_pairwise or global_radial the program dict (module
        docstring; global_radial reads none of the arguments)."""
        if self.global_radial:
            return self._global_program()
        neighbor_indices, neighbor_mask, edges = edge_info
        if self.fuse_pairwise:
            return self._program(rel_dist, edges)
        gathered = {str(d): batched_index_select(inp[str(d)],
                                                 neighbor_indices, dim=1)
                    for d, _ in self.fiber_in}       # [b, n, k, c_in, Q]
        edge_feats = self.edge_features(rel_dist, edges)
        so2 = self.backend == 'so2'
        if so2:
            # the rotation hoist: every input degree rotated into the edge
            # frames once, every output degree rotated back once after the
            # sum over input degrees (parameter-free, so the parameters are
            # those of the unhoisted path)
            frames = basis['so2']
            gathered = {str(d): rotate_in(gathered[str(d)], frames, d)
                        for d, _ in self.fiber_in}
        if not self.shared_radial_hidden:
            outputs = {}
            for d_out, _ in self.fiber_out:
                acc = None
                for d_in, _ in self.fiber_in:
                    payload = basis[self.backend] \
                        if self.backend_impl is not None \
                        else basis[f'{d_in},{d_out}']
                    y = getattr(self, f'pair_{d_in}_{d_out}')(
                        edge_feats, payload,
                        gathered[str(d_in)])          # [b, n, k, c_out, P]
                    acc = y if acc is None else acc + y
                if so2:
                    acc = rotate_out(acc, frames, d_out)
                if self.pool:
                    acc = masked_mean(acc, neighbor_mask, dim=2)
                outputs[str(d_out)] = acc
            return self._self_interact(inp, outputs)
        hidden = self.radial_hidden(edge_feats)            # [b, n, k, mid]

        outputs = {}
        for d_out, m_out in self.fiber_out:
            P = to_order(d_out)
            acc, v2s, w3s, b3s = None, [], [], []
            for d_in, m_in in self.fiber_in:
                Q, F = to_order(d_in), to_order(min(d_in, d_out))
                w3 = getattr(self, f'w3_{d_in}_{d_out}')
                b3 = getattr(self, f'b3_{d_in}_{d_out}')
                x = gathered[str(d_in)]
                w3s.append(w3)
                b3s.append(b3)
                if so2:
                    # the edge-frame band z [b, n, k, P, C*F] in place of V2
                    v2s.append(banded_z(x, d_in, d_out))
                    continue
                basis_pair = basis[f'{d_in},{d_out}']
                if self.fuse_basis:
                    y = _radial_contract_bx(hidden, w3, b3, basis_pair, x,
                                            (P, Q, F), self.edge_chunks,
                                            self.conv_bf16)
                    acc = y if acc is None else acc + y
                    continue
                if _basis_is_flat(basis_pair, x):
                    basis_pair = unflatten_basis(basis_pair, P, Q, F)
                # V2[..., p, (c, f)] = sum_q B[..., p, q, f] x[..., c, q]
                v2 = torch.einsum('...pqf,...cq->...pcf', basis_pair, x)
                v2s.append(v2.reshape(*v2.shape[:-2], m_in * F))
            if v2s:
                acc = _radial_contract(hidden, concat_weights(w3s, axis=1),
                                       torch.cat(b3s, dim=0),
                                       torch.cat(v2s, dim=-1),
                                       self.edge_chunks, self.conv_bf16,
                                       self.pallas)
            acc = acc.transpose(-1, -2)               # [b, n, k, c_out, P]
            if so2:
                acc = rotate_out(acc, frames, d_out)
            if self.pool:
                acc = masked_mean(acc, neighbor_mask, dim=2)
            outputs[str(d_out)] = acc
        return self._self_interact(inp, outputs)

    def _self_interact(self, inp: Features, outputs: Features) -> Features:
        if self.self_interact is None:
            return outputs
        return residual_se3(outputs, self.self_interact(inp))
