"""Fused multi-degree kNN attention: plain versions, wrappers, and the
differentiable op.

    sim[bh, i, j] = scale * q[bh, i] . k[bh // group, i, j]   (masked slots:
                    the finite float32 minimum, as the JAX kernel fills them)
    out[bh, i]    = sum_j softmax_j(sim[bh, i]) v[bh // group, i, j]

Port of se3_transformer_tpu/kernels/pallas_attention.py::fused_attention:
the forward `_fused_attention_fwd_impl` and the backward
`_fused_attention_bwd_impl`, with the same layouts. q [B*h, n, D], k/v
[B*kv_h, n, J, D] (kv heads shared by contiguous groups of group = h //
kv_h query heads), mask [B, n, J] bool or None -> out [B*h, n, D]; D is
one degree's (dim_head, m) axes flattened. A fully masked row gives the
uniform average of its slots, as the XLA softmax does.

A CPU tensor takes the plain PyTorch version. A CUDA tensor launches the
hand-written Hopper kernels of csrc/attention.cu or raises; nothing falls
back. `attention_limit`, the kernels' fits predicate, says whether they
take J slots of D features (J <= MAX_SLOTS, D <= MAX_FEATURES); past them
the wrappers raise, and the attention layer (ops/attention.py), like the
JAX module, warns and runs the plain version instead, counted in
`fused_attention_fwd.routed` (routing.route). `fused_attention_fwd.launches` and
`fused_attention_bwd.launches` count kernel launches.

`fused_attention` is the differentiable form: the torch.library custom op
`se3_torch::fused_attention`, whose autograd runs the backward kernel (the
port of the JAX custom_vjp `_fa_fwd`/`_fa_bwd`), under the profiler scope
'pallas_attention' (JAX's name; observability.timing.MODEL_SCOPES). Each
launch records the 'attention' / 'attention_bwd' consult of its built tile
(one kv row a warp) with kernels.tuning, keyed (n, J, D) and q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from .pairwise import _stream

# the finite float32 minimum (pallas_attention.py::NEG_INF)
NEG_INF = float(torch.finfo(torch.float32).min)
# the kernels' limits (csrc/attention.cu MAX_J: a lane holds the softmax
# weights of J / 32 slots; MAX_D)
MAX_SLOTS = 128
MAX_FEATURES = 256


def attention_limit(J: int, D: int) -> Optional[str]:
    """None when kernels #5 and #6 take rows of J slots and D features,
    else the limit the call exceeds: the port's fused_attention_fits."""
    if J > MAX_SLOTS:
        return f'J = {J} slots exceeds the kernel limit of {MAX_SLOTS}'
    if D > MAX_FEATURES:
        return f'D = {D} features exceeds the kernel limit of {MAX_FEATURES}'
    return None


def _repeat(t, times):
    """t with each row of dim 0 repeated `times` times in a row
    (repeat_interleave's result without its device-to-host sync)."""
    if times == 1:
        return t
    return t[:, None].expand(t.shape[0], times, *t.shape[1:]).reshape(
        t.shape[0] * times, *t.shape[1:])


def _expand(q, k, v, mask):
    """k, v repeated over each kv head's query-head group, the mask over
    the heads: the operands of one query head per row."""
    group = q.shape[0] // k.shape[0]
    mq = None if mask is None else _repeat(mask, q.shape[0] // mask.shape[0])
    return _repeat(k, group), _repeat(v, group), mq


def _softmax_rows(q, kq, mq, scale):
    sim = torch.einsum('bnd,bnjd->bnj', q, kq) * scale
    if mq is not None:
        sim = sim.masked_fill(~mq, NEG_INF)
    return sim.softmax(dim=-1)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor], heads: int,
                          scale: float) -> torch.Tensor:
    """The port of pallas_attention.py::attention_reference (the heads
    per mask row are read off the shapes, as there)."""
    kq, vq, mq = _expand(q, k, v, mask)
    attn = _softmax_rows(q, kq, mq, scale)
    return torch.einsum('bnj,bnjd->bnd', attn, vq)


def fused_attention_bwd_plain(q, k, v, mask, g, heads: int, scale: float):
    """The port of pallas_attention.py::_bwd_compute: the softmax
    recomputed, then
        da_j = <g, v_j>,  dsim_j = a_j (da_j - sum_l a_l da_l),
        dq = scale sum_j dsim_j k_j,  dk_j = scale dsim_j q,  dv_j = a_j g,
    with dk and dv summed over each kv head's query-head group ->
    (dq, dk, dv) in the dtypes of q, k and v."""
    kq, vq, mq = _expand(q, k, v, mask)
    a = _softmax_rows(q, kq, mq, scale)
    da = torch.einsum('bnd,bnjd->bnj', g, vq)
    dsim = a * (da - (a * da).sum(-1, keepdim=True))
    dq = scale * torch.einsum('bnj,bnjd->bnd', dsim, kq)
    dk = scale * dsim[..., None] * q[:, :, None, :]
    dv = a[..., None] * g[:, :, None, :]
    shape = (k.shape[0], q.shape[0] // k.shape[0], *k.shape[1:])
    return (dq.to(q.dtype), dk.reshape(shape).sum(1).to(k.dtype),
            dv.reshape(shape).sum(1).to(v.dtype))


def _check(q, k, v, mask, heads, g=None):
    dev = q.device
    named = [('k', k), ('v', v)] + ([('g', g)] if g is not None else [])
    for name, t in named + ([('mask', mask)] if mask is not None else []):
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, q on {dev}')
    for name, t in [('q', q)] + named:
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f'q must be [BH, n, D] and k, v [BKV, n, J, D], got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    BH, n, D = q.shape
    BKV, _, J, _ = k.shape
    if BKV == 0 or BH % BKV or k.shape[1] != n or k.shape[3] != D:
        raise ValueError(f'k/v {tuple(k.shape)} do not match q '
                         f'{tuple(q.shape)}')
    if g is not None and g.shape != q.shape:
        raise ValueError(f'g must be {tuple(q.shape)}, got {tuple(g.shape)}')
    limit = attention_limit(J, D)
    if limit is not None:
        raise ValueError(limit)
    if mask is not None:
        if mask.dtype != torch.bool or not mask.is_contiguous() \
                or BH % heads or tuple(mask.shape) != (BH // heads, n, J):
            raise ValueError(f'mask must be contiguous bool [{BH // heads}, '
                             f'{n}, {J}] (heads = {heads}), got '
                             f'{mask.dtype} {tuple(mask.shape)}')
    return BH, BKV, n, J, D


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _record_tile(kind, q, n, J, D):
    from . import tuning
    tuning.built_tile(kind, (n, J, D), str(q.dtype).replace('torch.', ''),
                      tuning.BUILT_TILES[kind], q.device)


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], heads: int,
                        scale: float) -> torch.Tensor:
    """q [B*h, n, D], k/v [B*kv_h, n, J, D], mask [B, n, J] or None ->
    out [B*h, n, D] float32."""
    if q.device.type == 'cpu':
        return fused_attention_plain(q, k, v, mask, heads, scale)
    if q.device.type != 'cuda':
        raise ValueError(f'no kernel for device {q.device}')
    BH, BKV, n, J, D = _check(q, k, v, mask, heads)
    _record_tile('attention', q, n, J, D)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    from .build import load_library
    with torch.cuda.device(q.device):
        rc = load_library().se3_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            out.data_ptr(), BH, BKV, n, J, D, heads, float(scale),
            _stream(q))
    if rc != 0:
        raise RuntimeError(f'se3_attention_fwd launch failed: CUDA error {rc}')
    fused_attention_fwd.launches += 1
    return out


fused_attention_fwd.launches = 0
fused_attention_fwd.routed = 0


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], g: torch.Tensor,
                        heads: int, scale: float):
    """The backward of fused_attention_fwd: g [B*h, n, D] -> (dq, dk, dv),
    float32. On a card one kernel computes all three; each warp owns one
    kv head's row and walks its query-head group in order, so dk and dv
    are summed without atomics, the same bits on every run."""
    if q.device.type == 'cpu':
        return fused_attention_bwd_plain(q, k, v, mask, g, heads, scale)
    if q.device.type != 'cuda':
        raise ValueError(f'no kernel for device {q.device}')
    BH, BKV, n, J, D = _check(q, k, v, mask, heads, g=g)
    _record_tile('attention_bwd', q, n, J, D)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    from .build import load_library
    with torch.cuda.device(q.device):
        rc = load_library().se3_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
            BKV, n, J, D, heads, float(scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f'se3_attention_bwd launch failed: CUDA error {rc}')
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


# ---------------------------------------------------------------------- #
# the differentiable op
# ---------------------------------------------------------------------- #
@torch.library.custom_op('se3_torch::fused_attention', mutates_args=(),
                         device_types='cpu')
def _fused_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], heads: int,
                        scale: float) -> torch.Tensor:
    return fused_attention_plain(q, k, v, mask, heads, scale)


@_fused_attention_op.register_kernel('cuda')
def _(q, k, v, mask, heads, scale):
    return fused_attention_fwd(q, k, v, mask, heads, scale)


def _fa_setup(ctx, inputs, output):
    q, k, v, mask, heads, scale = inputs
    ctx.save_for_backward(q, k, v, mask)
    ctx.heads, ctx.scale = heads, scale


def _fa_backward(ctx, g):
    q, k, v, mask = ctx.saved_tensors
    dq, dk, dv = fused_attention_bwd(q, k, v, mask, g.contiguous(),
                                     ctx.heads, ctx.scale)
    return dq, dk, dv, None, None, None


_fused_attention_op.register_autograd(_fa_backward, setup_context=_fa_setup)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], heads: int,
                    scale: float) -> torch.Tensor:
    """Differentiable fused attention (the layouts of fused_attention_fwd,
    any strides); gradients flow to q, k and v."""
    from ..observability.timing import named_scope
    with named_scope('pallas_attention'):
        return _fused_attention_op(
            q.contiguous(), k.contiguous(), v.contiguous(),
            None if mask is None else mask.contiguous(), int(heads),
            float(scale))
