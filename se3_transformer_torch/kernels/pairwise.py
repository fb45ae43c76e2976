"""The pairwise convolutions and their backward: wrappers, plain versions,
dispatch, and the differentiable ops.

    out[e, p, o] = sum_i V2[e, p, i] * (h[e] . W3[:, i, o] + b3[i, o])
    V2[e, p, c, f] = sum_q B[e, (p, f, q)] * x[e, c, q]      (i = c*F + f)

Port of se3_transformer_tpu/kernels/pallas_pairwise.py::fused_pairwise_conv
(V2 given), ::fused_pairwise_conv_bxf (V2 built from the flat basis and x
inside the kernel), ::fused_pairwise_conv_bx (the same from the structured
basis [E, P, Q, F]) and ::fused_pairwise_conv_bwd (the backward of all),
with the same signatures and row-major layouts: h [E, mid], w3 [mid, IF, O]
(i = c*F + f, c-major; the V2-given form takes the pairs of one output
degree concatenated along i), v2 [E, P, IF], basis_flat [E, P*F*Q] in (p,
f, q) order, x [E, C, Q], b3 [IF, O] -> out [E, P, O] float32; the backward
takes v2 and g [E, P, O].

A CPU tensor takes the plain PyTorch version. A CUDA tensor launches the
hand-written Hopper kernels (csrc/pairwise_fwd.cu, csrc/pairwise_bxf.cu,
csrc/pairwise_bwd.cu; the narrow-O arms of #3, A and B, O = 8, 16 or 32,
in csrc/pairwise_narrow.cuh) or raises; nothing falls back.
`fused_pairwise_conv.launches`, `fused_pairwise_conv_bxf.launches`,
`fused_pairwise_conv_bx.launches` and `fused_pairwise_conv_bwd.launches_a`
/ `.launches_b` count kernel launches (the narrow-O arm's also in
`fused_pairwise_conv.narrow_launches` and
`fused_pairwise_conv_bwd.narrow_launches_a` / `_b`).

`pairwise_limit` is the kernels' fits predicate: from the widths alone it
says whether a built kernel takes a call; the wrappers' checks are built on
it. Past a forward kernel's limits on a card, the conv layer (ops/conv.py)
sends the call to the plain version itself: it asks routing.route, which
counts the call in the wrapper's `.routed` and warns once per (kernel,
shape), and the call's backward is the plain version's autograd. Kernels
A and B take every width the forwards take, so the ops' backward (of a
call that launched) runs them.

`pairwise_contract`, `pairwise_contract_bxf` and `pairwise_contract_bx`
are the differentiable forms (the ports of
se3_transformer_tpu/ops/conv.py::_pairwise_contract_pallas,
::_pairwise_contract_pallas_bxf and ::_pairwise_contract_pallas_bx with
their custom_vjps): torch.library
custom ops, so that a selective activation checkpoint policy sees each
forward as one op and can save its output.

Quantized serving (se3_transformer_torch.quant): fused_pairwise_conv
takes `w3_scale` [1, IF, O] (or [IF, O]) float32 with w3 in int8 or
float8_e4m3fn storage, the JAX `w3_scale` epilogue: out = v2 . ((h @ w3) *
scale + b3), h float32 or bf16. On a card this is kernel #3's scaled arm
(csrc/pairwise_fwd.cu, se3_pairwise_fwd_q), which reads the 1-byte storage
into its tile and writes no dequantized W3; each of its launches counts in
`fused_pairwise_conv.launches` and `.scaled_launches`. The arm has no
backward: a call whose inputs need a gradient raises.

conv_bf16 (the JAX field): the equivariant operand stored bf16, V2 for
fused_pairwise_conv and the backward, the basis and x (both) for the
basis-fused forms. Each is upcast exactly to float32 where it is used and
the math after is the float32 arm's; h and w3 keep their dtypes. On a card
each kernel has a bf16-storage arm (the `_v16` C entry points, compiled as
units of their own) that stages the operand at 2 bytes a value; each of
its launches counts in the wrapper's `.launches` (`.launches_a` /
`.launches_b`) and in `.conv_bf16_launches` (`.conv_bf16_launches_a` /
`_b`). dV2 stays float32, as in JAX. The scaled arm of #3 takes float32 V2
only: pairwise_limit routes a quantized w3 beside bf16 V2.

The mid-32 arms (the SE3TransformerV2 family, se3_transformer_torch.v2:
its per-m blocks have a radial trunk of width 32 and P = 1 or 2 rows):
#3, A and B take mid = 32 beside 128 (MIDS) with P in MID32_ORDERS, wide
and narrow O, float32 or bf16 h, float32 V2 and a float w3. On a card
they are the _m32 C entry points (csrc/pairwise_fwd.cu,
csrc/pairwise_bwd.cu and csrc/pairwise_narrow.cuh built with
-DSE3_M32=1): h and w3 keep their width, nothing is padded to 128. Each
of their launches counts in `.launches` (`.launches_a` / `.launches_b`)
and in `fused_pairwise_conv.mid32_launches`
(`fused_pairwise_conv_bwd.mid32_launches_a` / `_b`). P = 2 (V2's -m/+m
row pair) is built beside 1, 3, 5 and 7 in #3, A and B at both widths;
the scaled and conv_bf16 arms stay at mid 128 and odd P, and #1 and #2 at
mid 128 with P and Q odd.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

MID = 128          # the radial hidden width #1 and #2 are built for
MIDS = (128, 32)   # the radial widths #3, A and B take (32: V2's trunk)
MID32_ORDERS = (1, 2)   # P of the mid-32 arms: V2's (m = 0) and (-m, +m) rows
O_TILE = 64        # output channels per CTA of the wide tiles: O a multiple
# the O values of the narrow-O arms of #3, A and B (csrc/pairwise_narrow.cuh):
# one tile of 16 columns (O = 8, 16) or 32, the columns past O masked
NARROW_O = (8, 16, 32)
NARROW_I_CHUNK = 4  # the narrow arms' i chunk (a kernel-A CTA's i values)
EDGE_TILE = 64     # edges per CTA
ORDERS = (1, 3, 5, 7)   # P and Q the kernel is instantiated for (degree <= 3)
# P of #3, A and B's float arms: also V2's (-m, +m) row pairs
PAIR_ORDERS = (1, 2, 3, 5, 7)
# the i-range split of the V2-given forward kernel and of backward kernel B
SPLIT_TARGET_CTAS = 132  # one CTA per SM of an H100 (both run one per SM)
SPLIT_MIN_I = 64         # the fewest i values a split takes
FWD_I_CHUNK = 16         # V2's i chunk in csrc/pairwise_fwd.cu: splits start on one
DTYPES = (torch.bfloat16, torch.float32)   # h and w3 types the kernels take
# the storage of the equivariant operand (V2, or the basis and x) the
# kernels take: float32, or bf16 (conv_bf16)
OPERAND_DTYPES = (torch.float32, torch.bfloat16)
# the quantized storage of w3 that kernel #3's scaled arm takes (and its
# flag in the C interface: 0 int8, 1 float8_e4m3fn)
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)


def pairwise_limit(kernel: str, mid: int, O: int, P: int, Q: int = 1,
                   dtype: torch.dtype = torch.float32,
                   operand_dtype: torch.dtype = torch.float32,
                   scaled: bool = False) -> Optional[str]:
    """None when the built `kernel` takes a call of these widths, else the
    limit the call exceeds. `kernel` is 'bxf' or 'bx' (#1 and #2, which
    also read Q), 'fwd' (#3) or 'bwd' (kernels A and B); `dtype` is h's
    (and w3's), `operand_dtype` the storage of V2 (or of the basis and x),
    `scaled` a quantized w3 (#3's scaled arm). #3, A and B also take O in
    NARROW_O (their narrow-O arms) with float32 V2 and a float w3; #1 and
    #2, the scaled arm and the conv_bf16 arms take O a multiple of 64
    only. #3, A and B take mid 32 (with P 1 or 2, V2's rows) beside 128
    and P = 2 beside the odd orders in their float arms; #1 and #2, the
    scaled arm and the conv_bf16 arms take mid 128 and odd P only. A
    function of widths and dtypes alone, the counterpart of the JAX
    package's fused_attention_fits: the kernels' fits predicate."""
    if dtype not in DTYPES:
        return f'h dtype {dtype} exceeds the built dtypes (bfloat16, float32)'
    if operand_dtype not in OPERAND_DTYPES:
        return (f'operand dtype {operand_dtype} exceeds the built storages '
                f'(float32, bfloat16)')
    if scaled and operand_dtype != torch.float32:
        return ('a quantized w3 beside bf16 V2 exceeds the scaled arm (built '
                'for float32 V2)')
    pairwise = kernel in ('fwd', 'bwd')
    if pairwise and mid in MIDS and mid != MID:
        if P not in MID32_ORDERS:
            return (f'P = {P} at mid = {mid} exceeds the mid-{mid} arms '
                    f'(built for the V2 rows, P in {MID32_ORDERS})')
        if scaled:
            return (f'mid = {mid} with a quantized w3 exceeds the scaled arm '
                    f'(built for mid = {MID})')
        if operand_dtype != torch.float32:
            return (f'mid = {mid} with bf16 V2 exceeds the conv_bf16 arms '
                    f'(built for mid = {MID})')
    elif mid != MID:
        built = f'mids {MIDS}' if pairwise else f'mid = {MID}'
        return f'mid = {mid} exceeds the built {built}'
    if O in NARROW_O and kernel in ('fwd', 'bwd'):
        if scaled:
            return (f'O = {O} with a quantized w3 exceeds the scaled arm '
                    f'(built for O a multiple of {O_TILE})')
        if operand_dtype != torch.float32:
            return (f'O = {O} with bf16 V2 exceeds the conv_bf16 arms (built '
                    f'for O a multiple of {O_TILE})')
    elif O <= 0 or O % O_TILE:
        built = ('8, 16, 32 or a multiple of 64' if kernel in ('fwd', 'bwd')
                 else f'a multiple of {O_TILE}')
        return f'O = {O} exceeds the built O: {built}'
    if pairwise and P in PAIR_ORDERS and P not in ORDERS:
        if scaled:
            return (f'P = {P} with a quantized w3 exceeds the scaled arm '
                    f'(built for the orders {ORDERS})')
        if operand_dtype != torch.float32:
            return (f'P = {P} with bf16 V2 exceeds the conv_bf16 arms (built '
                    f'for the orders {ORDERS})')
    elif P not in ORDERS:
        built = PAIR_ORDERS if pairwise else ORDERS
        return f'P = {P} exceeds the built orders {built} (degree <= 3)'
    if kernel in ('bxf', 'bx') and Q not in ORDERS:
        return f'Q = {Q} exceeds the built orders {ORDERS} (degree <= 3)'
    return None


def fused_pairwise_conv_bxf_plain(h: torch.Tensor, w3: torch.Tensor,
                                  basis_flat: torch.Tensor, x: torch.Tensor,
                                  pqf, b3: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: V2 by einsum, R = h.W3 + b3
    with float32 accumulation (bf16 products are exact in float32), then
    the per-edge apply. Materializes V2 and R."""
    P, Q, F = pqf
    E, mid = h.shape
    C = x.shape[1]
    O = w3.shape[-1]
    b4 = basis_flat.float().reshape(E, P, F, Q)
    v2 = torch.einsum('epfq,ecq->epcf', b4, x.float()).reshape(E, P, C * F)
    R = torch.matmul(h.float(), w3.float().reshape(mid, C * F * O))
    R = R.reshape(E, C * F, O) + b3.float()
    return torch.bmm(v2, R)


def _check(h, w3, basis_flat, x, pqf, b3, structured=False):
    """The operands kernel #1 takes (kernel #2 with `structured`: the
    basis [E, P, Q, F] in place of the flat [E, P*F*Q]); returns
    (E, C, O)."""
    P, Q, F = pqf
    E = h.shape[0]
    dev = h.device
    for name, t in (('w3', w3), ('basis_flat', basis_flat), ('x', x),
                    ('b3', b3)):
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, h on {dev}')
    if w3.dtype != h.dtype:
        raise TypeError(f'h/w3 must have one dtype, got {h.dtype}/{w3.dtype}')
    if b3.dtype != torch.float32:
        raise TypeError(f'b3 must be float32, got {b3.dtype}')
    if basis_flat.dtype != x.dtype:
        raise TypeError(f'the basis and x must have one dtype (float32, or '
                        f'bfloat16 for conv_bf16), got {basis_flat.dtype}/'
                        f'{x.dtype}')
    if h.ndim != 2 or w3.ndim != 3 or x.ndim != 3:
        raise ValueError(f'h, w3 and x must be [E, mid], [mid, C*F, O] and '
                         f'[E, C, Q], got {tuple(h.shape)}, '
                         f'{tuple(w3.shape)}, {tuple(x.shape)}')
    limit = pairwise_limit('bx' if structured else 'bxf', h.shape[1],
                           w3.shape[2], P, Q, h.dtype, x.dtype)
    if limit is not None:
        raise ValueError(limit)
    if F != min(P, Q):
        raise ValueError(f'unsupported (P, Q, F) = {pqf}')
    if x.shape[0] != E or x.shape[2] != Q:
        raise ValueError(f'x must be [E, C, {Q}], got {tuple(x.shape)}')
    C = x.shape[1]
    if w3.shape[:2] != (MID, C * F):
        raise ValueError(f'w3 must be [{MID}, {C * F}, O], got '
                         f'{tuple(w3.shape)}')
    O = w3.shape[2]
    if tuple(b3.shape) != (C * F, O):
        raise ValueError(f'b3 must be [{C * F}, {O}], got {tuple(b3.shape)}')
    want = (E, P, Q, F) if structured else (E, P * F * Q)
    if tuple(basis_flat.shape) != want:
        raise ValueError(f'the basis must be {list(want)}, got '
                         f'{tuple(basis_flat.shape)}')
    for name, t in (('h', h), ('w3', w3), ('basis_flat', basis_flat),
                    ('x', x), ('b3', b3)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    return E, C, O


def bxf_tiles(P: int, Q: int, dtype: torch.dtype):
    """(chunk, stage_c) of kernels #1 and #2 (csrc/pairwise_bxf.cu): the
    values of i = (c, f) walked behind one barrier (2 for bf16 h/w3; 1 for
    float32, whose three bf16 passes make a chunk as long), and the channels
    c whose V2 one stage builds: a whole number of chunks, at least 3, so
    that a stage's x rows land before its build. A function of (P, Q, dtype)
    alone; the kernel refuses a launch whose values are not its own."""
    F = min(P, Q)
    chunk = 2 if dtype == torch.bfloat16 else 1
    return chunk, 3 * chunk if F == 1 else chunk


def _launch_bxf(fn, h, w3, b3, basis, x, P, Q, C, O):
    """Launch kernel #1 (fn = se3_pairwise_bxf) or #2 (se3_pairwise_bx), or
    their conv_bf16 arms (the _v16 entries); float32 w3 is split into its
    bf16 hi and lo arrays by the launch's own split pass, into scratch
    allocated here."""
    E = h.shape[0]
    out = torch.empty(E, P, O, dtype=torch.float32, device=h.device)
    if E == 0:
        return out
    h, w3, b3 = _aligned(h), _aligned(w3), _aligned(b3)
    bf16 = h.dtype == torch.bfloat16
    w3_split = w3 if bf16 else torch.empty(
        2 * w3.numel(), dtype=torch.bfloat16, device=h.device)
    chunk, stage_c = bxf_tiles(P, Q, h.dtype)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), w3.data_ptr(), b3.data_ptr(), basis.data_ptr(),
                x.data_ptr(), out.data_ptr(), w3_split.data_ptr(), E, C, O, P,
                Q, chunk, stage_c, int(bf16), _stream(h))
    if rc != 0:
        raise RuntimeError(f'{fn.__name__} launch failed: CUDA error {rc}')
    return out


def fused_pairwise_conv_bxf(h: torch.Tensor, w3: torch.Tensor,
                            basis_flat: torch.Tensor, x: torch.Tensor,
                            pqf, b3: torch.Tensor) -> torch.Tensor:
    """h [E, mid], w3 [mid, C*F, O], basis_flat [E, P*F*Q], x [E, C, Q],
    pqf = (P, Q, F), b3 [C*F, O] -> [E, P, O] float32."""
    pqf = tuple(int(v) for v in pqf)
    if h.device.type == 'cpu':
        return fused_pairwise_conv_bxf_plain(h, w3, basis_flat, x, pqf, b3)
    if h.device.type != 'cuda':
        raise ValueError(f'no kernel for device {h.device}')
    E, C, O = _check(h, w3, basis_flat, x, pqf, b3)
    from .build import load_library
    v16 = x.dtype == torch.bfloat16
    lib = load_library()
    out = _launch_bxf(lib.se3_pairwise_bxf_v16 if v16 else lib.se3_pairwise_bxf,
                      h, w3, b3, basis_flat, x, pqf[0], pqf[1], C, O)
    if E:
        fused_pairwise_conv_bxf.launches += 1
        fused_pairwise_conv_bxf.conv_bf16_launches += v16
    return out


# every launch counts in .launches, the conv_bf16 arm's in
# .conv_bf16_launches too
fused_pairwise_conv_bxf.launches = 0
fused_pairwise_conv_bxf.conv_bf16_launches = 0
fused_pairwise_conv_bxf.routed = 0


# ---------------------------------------------------------------------- #
# the basis-fused forward with the structured basis
# ---------------------------------------------------------------------- #
def fused_pairwise_conv_bx_plain(h: torch.Tensor, w3: torch.Tensor,
                                 basis: torch.Tensor, x: torch.Tensor,
                                 b3: torch.Tensor) -> torch.Tensor:
    """fused_pairwise_conv_bx in plain PyTorch: V2 by einsum from the
    structured basis, R = h.W3 + b3 with float32 accumulation, then the
    per-edge apply. Materializes V2 and R."""
    E, P, Q, F = basis.shape
    mid = h.shape[1]
    C = x.shape[1]
    O = w3.shape[-1]
    v2 = torch.einsum('epqf,ecq->epcf', basis.float(),
                      x.float()).reshape(E, P, C * F)
    R = torch.matmul(h.float(), w3.float().reshape(mid, C * F * O))
    R = R.reshape(E, C * F, O) + b3.float()
    return torch.bmm(v2, R)


def _check_bx(h, w3, basis, x, b3):
    """What kernel #2 takes: kernel #1's operands with the basis [E, P, Q,
    F]; returns (E, C, O, (P, Q, F))."""
    if basis.ndim != 4:
        raise ValueError(f'basis must be [E, P, Q, F], got '
                         f'{tuple(basis.shape)}')
    pqf = tuple(basis.shape[1:])
    return (*_check(h, w3, basis, x, pqf, b3, structured=True), pqf)


def fused_pairwise_conv_bx(h: torch.Tensor, w3: torch.Tensor,
                           basis: torch.Tensor, x: torch.Tensor,
                           b3: torch.Tensor) -> torch.Tensor:
    """h [E, mid], w3 [mid, C*F, O], basis [E, P, Q, F] (get_basis's
    'pqf' layout), x [E, C, Q], b3 [C*F, O] -> [E, P, O] float32: the
    structured-basis form of fused_pairwise_conv_bxf, computed by the same
    tile (csrc/pairwise_bxf.cu) with [E, P, Q, F] indexing."""
    if h.device.type == 'cpu':
        return fused_pairwise_conv_bx_plain(h, w3, basis, x, b3)
    if h.device.type != 'cuda':
        raise ValueError(f'no kernel for device {h.device}')
    E, C, O, (P, Q, _) = _check_bx(h, w3, basis, x, b3)
    from .build import load_library
    v16 = x.dtype == torch.bfloat16
    lib = load_library()
    out = _launch_bxf(lib.se3_pairwise_bx_v16 if v16 else lib.se3_pairwise_bx,
                      h, w3, b3, basis, x, P, Q, C, O)
    if E:
        fused_pairwise_conv_bx.launches += 1
        fused_pairwise_conv_bx.conv_bf16_launches += v16
    return out


fused_pairwise_conv_bx.launches = 0
fused_pairwise_conv_bx.conv_bf16_launches = 0
fused_pairwise_conv_bx.routed = 0


# ---------------------------------------------------------------------- #
# the forward with V2 given
# ---------------------------------------------------------------------- #
def fused_pairwise_conv_plain(h: torch.Tensor, w3: torch.Tensor,
                              v2: torch.Tensor, b3: torch.Tensor = None,
                              w3_scale: torch.Tensor = None) -> torch.Tensor:
    """The same function in plain PyTorch: R = h.W3 (* w3_scale) + b3 with
    float32 accumulation (bf16 products, and int8 or fp8 storage upcast,
    are exact in float32), then the per-edge apply. Materializes R [E, IF,
    O]."""
    E, mid = h.shape
    _, IF, O = w3.shape
    if w3_scale is not None:
        serving_only('the quantized w3_scale arm', h, v2, b3)
    R = torch.matmul(h.float(), w3.float().reshape(mid, IF * O))
    R = R.reshape(E, IF, O)
    if w3_scale is not None:
        R = R * w3_scale.reshape(IF, O)
    if b3 is not None:
        R = R + b3.float()
    return torch.bmm(v2.float(), R)


def serving_only(what: str, *tensors) -> None:
    """Refuse a call of a quantized arm whose inputs need a gradient: the
    int8/fp8 storage is a serving artifact, with no backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f'{what} serves only: no gradient flows through '
                           f'int8/fp8 storage (run under torch.no_grad or '
                           f'inference_mode; train the float32 model)')


def _check_fwd(h, w3, v2, b3, w3_scale=None):
    dev = h.device
    for name, t in (('w3', w3), ('v2', v2), ('b3', b3),
                    ('w3_scale', w3_scale)):
        if t is not None and t.device != dev:
            raise ValueError(f'{name} is on {t.device}, h on {dev}')
    if w3_scale is None and w3.dtype != h.dtype:
        raise TypeError(f'h/w3 must have one dtype, got {h.dtype}/{w3.dtype}')
    if w3_scale is not None:
        if w3.dtype not in QUANT_DTYPES or h.dtype not in DTYPES:
            raise TypeError(f'the scaled arm takes w3 in {QUANT_DTYPES} and '
                            f'h in {DTYPES}, got {w3.dtype}/{h.dtype}')
        if w3_scale.dtype != torch.float32 or w3.ndim != 3 or tuple(
                w3_scale.shape[-2:]) != tuple(w3.shape[1:]) \
                or w3_scale.numel() != w3.shape[1] * w3.shape[2] \
                or not w3_scale.is_contiguous():
            raise ValueError(f'w3_scale must be contiguous float32 [1, IF, O] '
                             f'for w3 {tuple(w3.shape)}, got {w3_scale.dtype} '
                             f'{tuple(w3_scale.shape)}')
    if b3.dtype != torch.float32:
        raise TypeError(f'b3 must be float32, got {b3.dtype}')
    if h.ndim != 2 or w3.ndim != 3 or v2.ndim != 3:
        raise ValueError(f'h, w3 and v2 must be [E, mid], [mid, IF, O] and '
                         f'[E, P, IF], got {tuple(h.shape)}, '
                         f'{tuple(w3.shape)}, {tuple(v2.shape)}')
    limit = pairwise_limit('fwd', h.shape[1], w3.shape[2], v2.shape[1],
                           dtype=h.dtype, operand_dtype=v2.dtype,
                           scaled=w3_scale is not None)
    if limit is not None:
        raise ValueError(limit)
    E, mid = h.shape
    if w3.shape[0] != mid or w3.shape[1] == 0:
        raise ValueError(f'w3 must be [{mid}, IF, O], got {tuple(w3.shape)}')
    _, IF, O = w3.shape
    if v2.shape[0] != E or v2.shape[2] != IF:
        raise ValueError(f'v2 must be [{E}, P, {IF}], got {tuple(v2.shape)}')
    if tuple(b3.shape) != (IF, O):
        raise ValueError(f'b3 must be [{IF}, {O}], got {tuple(b3.shape)}')
    for name, t in (('h', h), ('w3', w3), ('v2', v2), ('b3', b3)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    return E, IF, O, v2.shape[1]


def o_tile(O: int) -> int:
    """The O tile of the kernels that take a call with O output channels:
    the narrow arms' 16 (O = 8, 16) or 32, else the wide tiles' 64."""
    if O in NARROW_O:
        return 16 if O <= 16 else 32
    return O_TILE


def o_slots(O: int) -> int:
    """CTAs along O: O's tiles, the columns past O of a narrow tile masked."""
    return -(-O // o_tile(O))


def i_per_split(E: int, IF: int, O: int = O_TILE) -> int:
    """How many i values each CTA of the forward kernel (csrc/pairwise_fwd.cu,
    one CTA per SM) or of backward kernel B contracts: the whole of IF when
    the edge and O tiles (the call's tile, o_tile) alone fill the card, else
    IF split so that they do (each split at least SPLIT_MIN_I values, and a
    multiple of FWD_I_CHUNK so that every split starts on one of the
    forward's 16-byte V2 chunks). The narrow arms stage their h tile once
    and walk i in NARROW_I_CHUNK values: their splits are whole chunks,
    as many as fill the card (at a DenoiseConfig micro-batch's 12 edge
    tiles one CTA each left 120 SMs idle). A function of the shapes only,
    so the partial sums and their reduce order (and so the output, bit
    for bit) are the same on every run."""
    tiles = -(-E // EDGE_TILE) * o_slots(O)
    if O in NARROW_O:
        splits = max(1, min(SPLIT_TARGET_CTAS // tiles,
                            -(-IF // NARROW_I_CHUNK)))
        per = -(-IF // splits)
        return -(-per // NARROW_I_CHUNK) * NARROW_I_CHUNK
    splits = max(1, min(SPLIT_TARGET_CTAS // tiles, -(-IF // SPLIT_MIN_I)))
    if splits == 1:
        return IF
    per = -(-IF // splits)
    return -(-per // FWD_I_CHUNK) * FWD_I_CHUNK


def fused_pairwise_conv(h: torch.Tensor, w3: torch.Tensor, v2: torch.Tensor,
                        b3: torch.Tensor = None,
                        w3_scale: torch.Tensor = None) -> torch.Tensor:
    """h [E, mid], w3 [mid, IF, O], v2 [E, P, IF] (float32, or bf16:
    conv_bf16), b3 [IF, O] (zeros when None) -> out [E, P, O] float32: out
    = v2 . (h@w3 + b3). With w3_scale (float32 [1, IF, O]) w3 is int8 or
    float8_e4m3fn storage and out = v2 . ((h@w3) * w3_scale + b3): kernel
    #3's scaled arm, serving only (float32 v2)."""
    if h.device.type == 'cpu':
        return fused_pairwise_conv_plain(h, w3, v2, b3, w3_scale=w3_scale)
    if h.device.type != 'cuda':
        raise ValueError(f'no kernel for device {h.device}')
    if b3 is None:
        b3 = torch.zeros(w3.shape[1:], dtype=torch.float32, device=h.device)
    E, IF, O, P = _check_fwd(h, w3, v2, b3, w3_scale)
    out = torch.empty(E, P, O, dtype=torch.float32, device=h.device)
    if E == 0:
        return out
    per = i_per_split(E, IF, O)
    splits = -(-IF // per)
    work = out if splits == 1 else torch.empty(
        splits * E * P * O, dtype=torch.float32, device=h.device)
    bf16 = h.dtype == torch.bfloat16
    if w3_scale is not None:
        serving_only('the quantized w3_scale arm', h, v2, b3)
        # the 1-byte storage goes to the kernel as it is: no split, no
        # dequantized copy
        w3 = _aligned(w3)
        from .build import load_library
        with torch.cuda.device(h.device):
            rc = load_library().se3_pairwise_fwd_q(
                h.data_ptr(), w3.data_ptr(), w3_scale.data_ptr(),
                b3.data_ptr(), v2.data_ptr(), out.data_ptr(),
                work.data_ptr(), E, IF, O, P, per, int(bf16),
                int(w3.dtype == torch.float8_e4m3fn), _stream(h))
        if rc != 0:
            raise RuntimeError(f'se3_pairwise_fwd_q launch failed: CUDA '
                               f'error {rc}')
        fused_pairwise_conv.launches += 1
        fused_pairwise_conv.scaled_launches += 1
        return out
    # float32 w3 is split into its bf16 hi and lo arrays by the kernel's
    # own split pass, into this scratch (the narrow arm splits each chunk
    # as it stages it)
    w3_split = w3 if bf16 or O in NARROW_O else torch.empty(
        2 * w3.numel(), dtype=torch.bfloat16, device=h.device)
    from .build import load_library
    v16 = v2.dtype == torch.bfloat16
    m32 = h.shape[1] != MID
    lib = load_library()
    fn = lib.se3_pairwise_fwd_v16 if v16 else (
        lib.se3_pairwise_fwd_m32 if m32 else lib.se3_pairwise_fwd)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), w3.data_ptr(), b3.data_ptr(), v2.data_ptr(),
                out.data_ptr(), work.data_ptr(), w3_split.data_ptr(), E, IF, O,
                P, per, int(bf16), _stream(h))
    if rc != 0:
        raise RuntimeError(f'{fn.__name__} launch failed: CUDA error {rc}')
    fused_pairwise_conv.launches += 1
    fused_pairwise_conv.conv_bf16_launches += v16
    fused_pairwise_conv.narrow_launches += O in NARROW_O
    fused_pairwise_conv.mid32_launches += m32
    return out


# every launch counts in .launches, the scaled arm's in .scaled_launches
# too, the conv_bf16 arm's in .conv_bf16_launches, the narrow-O arm's in
# .narrow_launches, the mid-32 arm's in .mid32_launches
fused_pairwise_conv.launches = 0
fused_pairwise_conv.scaled_launches = 0
fused_pairwise_conv.conv_bf16_launches = 0
fused_pairwise_conv.narrow_launches = 0
fused_pairwise_conv.mid32_launches = 0
fused_pairwise_conv.routed = 0


# ---------------------------------------------------------------------- #
# backward
# ---------------------------------------------------------------------- #
BWD_I_CHUNK = 2      # i = (c, f) values per kernel-A CTA (csrc/pairwise_bwd.cu)


def fused_pairwise_conv_bwd_a_plain(h, w3, v2, g, b3):
    """Kernel A's outputs in plain PyTorch, float32 throughout (bf16 h/w3
    upcast exactly): R = h.W3 + b3, dV2 = g.R, dR = V2^T.g, dW3 = H^T.dR,
    dB3 = sum_e dR -> (dw3, dv2, db3). Materializes R and dR [E, IF, O]."""
    E, mid = h.shape
    _, IF, O = w3.shape
    h32, g32 = h.float(), g.float()
    R = torch.matmul(h32, w3.float().reshape(mid, IF * O)).reshape(E, IF, O)
    dv2 = torch.bmm(g32, (R + b3.float()).transpose(1, 2))
    dR = torch.bmm(v2.float().transpose(1, 2), g32)
    dw3 = torch.matmul(h32.t(), dR.reshape(E, IF * O)).reshape(mid, IF, O)
    return dw3, dv2, dR.sum(0)


def fused_pairwise_conv_bwd_b_plain(w3, v2, g):
    """Kernel B's output in plain PyTorch: dH = dR.W3^T with dR = V2^T.g
    rebuilt, float32."""
    mid, IF, O = w3.shape
    dR = torch.bmm(v2.float().transpose(1, 2), g.float())
    return torch.matmul(dR.reshape(-1, IF * O),
                        w3.float().reshape(mid, IF * O).t())


def fused_pairwise_conv_bwd_plain(h: torch.Tensor, w3: torch.Tensor,
                                  v2: torch.Tensor, g: torch.Tensor,
                                  b3: torch.Tensor):
    """The backward in plain PyTorch: (dh, dw3, dv2, db3), float32."""
    dw3, dv2, db3 = fused_pairwise_conv_bwd_a_plain(h, w3, v2, g, b3)
    return fused_pairwise_conv_bwd_b_plain(w3, v2, g), dw3, dv2, db3


def _check_bwd(h, w3, v2, g, b3):
    """What kernels A and B take; returns (E, IF, O, P)."""
    dev = h.device
    for name, t in (('w3', w3), ('v2', v2), ('g', g), ('b3', b3)):
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, h on {dev}')
    if w3.dtype != h.dtype:
        raise TypeError(f'h/w3 must have one dtype, got {h.dtype}/{w3.dtype}')
    for name, t in (('g', g), ('b3', b3)):
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
    if h.ndim != 2 or w3.ndim != 3 or v2.ndim != 3:
        raise ValueError(f'h, w3 and v2 must be [E, mid], [mid, IF, O] and '
                         f'[E, P, IF], got {tuple(h.shape)}, '
                         f'{tuple(w3.shape)}, {tuple(v2.shape)}')
    limit = pairwise_limit('bwd', h.shape[1], w3.shape[2], v2.shape[1],
                           dtype=h.dtype, operand_dtype=v2.dtype)
    if limit is not None:
        raise ValueError(limit)
    E, mid = h.shape
    if w3.shape[0] != mid or w3.shape[1] == 0:
        raise ValueError(f'w3 must be [{mid}, IF, O], got {tuple(w3.shape)}')
    _, IF, O = w3.shape
    if v2.shape[0] != E or v2.shape[2] != IF:
        raise ValueError(f'v2 must be [{E}, P, {IF}], got {tuple(v2.shape)}')
    P = v2.shape[1]
    if tuple(g.shape) != (E, P, O):
        raise ValueError(f'g must be [{E}, {P}, {O}], got {tuple(g.shape)}')
    if tuple(b3.shape) != (IF, O):
        raise ValueError(f'b3 must be [{IF}, {O}], got {tuple(b3.shape)}')
    for name, t in (('h', h), ('w3', w3), ('v2', v2), ('g', g), ('b3', b3)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    return E, IF, O, P


@functools.lru_cache(maxsize=None)
def bwd_splits(E: int, IF: int, O: int = O_TILE) -> int:
    """How many edge ranges kernel A splits E into: the count that finishes
    soonest with one CTA per SM of an H100 (whole waves of equal ranges,
    each split's partial dW3 written and reduced at about IF/128 tiles'
    time), each range at least one 64-edge tile; O's tiles share the grid
    (a narrow O is one tile, its CTAs NARROW_I_CHUNK values of i). A
    function of the shapes only, so the partial sums and their reduce order
    (and so dW3 and dB3, bit for bit) are the same on every run."""
    n_tiles = -(-E // EDGE_TILE)
    chunk = NARROW_I_CHUNK if O in NARROW_O else BWD_I_CHUNK
    groups = -(-IF // chunk) * o_slots(O)

    # a split's partial dW3 is written and reduced at about IF/128 tiles'
    # time at a wide O tile, in proportion to IF * O at a narrow one
    partial = IF * O / (128 * O_TILE) if O in NARROW_O else IF / 128

    def cost(s):
        return (-(-groups * s // SPLIT_TARGET_CTAS) * -(-n_tiles // s)
                + s * partial)
    splits = min(range(1, min(n_tiles, 64) + 1), key=cost)
    per_split = -(-n_tiles // splits)
    return -(-n_tiles // per_split)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it that starts on 16 bytes (the kernels' 16-byte
    copies and vector loads need that)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_bwd_a(h, w3, v2, g, b3, E, IF, O, P):
    """Kernel A and its reduces on operands that passed _check_bwd,
    E > 0 -> (dw3, dv2, db3); counts one kernel-A launch. Each 64-wide O
    tile is a CTA of its own: past one, their dV2 partials go to dv2_work
    and are summed in tile order. A narrow O (the narrow arm) is one tile
    and takes no split scratch."""
    f32 = dict(dtype=torch.float32, device=h.device)
    h, w3, g = _aligned(h), _aligned(w3), _aligned(g)
    mid = h.shape[1]
    dv2 = torch.empty(E, P, IF, **f32)
    dw3 = torch.empty(mid, IF, O, **f32)
    db3 = torch.empty(IF, O, **f32)
    slots = o_slots(O)
    splits = bwd_splits(E, IF, O)
    work = torch.empty(splits * (mid + 1) * IF * O, **f32)
    dv2_work = dv2 if slots == 1 else torch.empty(slots * E * P * IF, **f32)
    # float32 h and w3 are split into bf16 hi and lo arrays by the kernel's
    # own split pass, into this scratch
    bf16 = h.dtype == torch.bfloat16
    split = work if bf16 or O in NARROW_O else torch.empty(
        2 * (E * mid + mid * IF * O), dtype=torch.bfloat16, device=h.device)
    from .build import load_library
    v16 = v2.dtype == torch.bfloat16
    m32 = mid != MID
    lib = load_library()
    fn = lib.se3_pairwise_bwd_a_v16 if v16 else (
        lib.se3_pairwise_bwd_a_m32 if m32 else lib.se3_pairwise_bwd_a)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), w3.data_ptr(), b3.data_ptr(), v2.data_ptr(),
                g.data_ptr(), dv2.data_ptr(), dv2_work.data_ptr(),
                work.data_ptr(), split.data_ptr(), dw3.data_ptr(),
                db3.data_ptr(), E, IF, O, P, splits, int(bf16), _stream(h))
    if rc != 0:
        raise RuntimeError(f'{fn.__name__} launch failed: CUDA error {rc}')
    fused_pairwise_conv_bwd.launches_a += 1
    fused_pairwise_conv_bwd.conv_bf16_launches_a += v16
    fused_pairwise_conv_bwd.narrow_launches_a += O in NARROW_O
    fused_pairwise_conv_bwd.mid32_launches_a += m32
    return dw3, dv2, db3


def _launch_bwd_b(w3, v2, g, E, IF, O, P):
    """Kernel B (and, with its i range split or more than one 64-wide O
    tile, the partials' reduce) on operands that passed _check_bwd, E > 0
    -> dh; counts one kernel-B launch. A narrow O is one tile and takes no
    split scratch."""
    mid = w3.shape[0]
    dh = torch.empty(E, mid, dtype=torch.float32, device=w3.device)
    w3, g = _aligned(w3), _aligned(g)
    per = i_per_split(E, IF, O)
    partials = -(-IF // per) * o_slots(O)
    work = dh if partials == 1 else torch.empty(
        partials * E * mid, dtype=torch.float32, device=w3.device)
    # float32 w3 is split into bf16 hi and lo arrays by the kernel's own
    # split pass, into this scratch
    bf16 = w3.dtype == torch.bfloat16
    split = dh if bf16 or O in NARROW_O else torch.empty(
        2 * w3.numel(), dtype=torch.bfloat16, device=w3.device)
    from .build import load_library
    v16 = v2.dtype == torch.bfloat16
    m32 = mid != MID
    lib = load_library()
    fn = lib.se3_pairwise_bwd_b_v16 if v16 else (
        lib.se3_pairwise_bwd_b_m32 if m32 else lib.se3_pairwise_bwd_b)
    with torch.cuda.device(w3.device):
        rc = fn(w3.data_ptr(), v2.data_ptr(), g.data_ptr(), dh.data_ptr(),
                work.data_ptr(), split.data_ptr(), E, IF, O, P, per,
                int(bf16), _stream(w3))
    if rc != 0:
        raise RuntimeError(f'{fn.__name__} launch failed: CUDA error {rc}')
    fused_pairwise_conv_bwd.launches_b += 1
    fused_pairwise_conv_bwd.conv_bf16_launches_b += v16
    fused_pairwise_conv_bwd.narrow_launches_b += O in NARROW_O
    fused_pairwise_conv_bwd.mid32_launches_b += m32
    return dh


def fused_pairwise_conv_bwd(h: torch.Tensor, w3: torch.Tensor,
                            v2: torch.Tensor, g: torch.Tensor,
                            b3: torch.Tensor = None):
    """Backward of fused_pairwise_conv and fused_pairwise_conv_bxf (V2
    given): h [E, mid], w3 [mid, IF, O], v2 [E, P, IF] (float32, or bf16:
    conv_bf16), g [E, P, O], b3 [IF, O] (zeros when None) -> (dh [E, mid],
    dw3 [mid, IF, O], dv2 [E, P, IF], db3 [IF, O]), all float32. On a
    card: kernel A (dV2, dW3, dB3, with its deterministic edge reduce) then
    kernel B (dH); mid in MIDS and O a multiple of 64, or O in NARROW_O with
    float32 V2 (the narrow arms), there."""
    if b3 is None:
        b3 = torch.zeros(w3.shape[1:], dtype=torch.float32, device=h.device)
    if h.device.type == 'cpu':
        return fused_pairwise_conv_bwd_plain(h, w3, v2, g, b3)
    if h.device.type != 'cuda':
        raise ValueError(f'no kernel for device {h.device}')
    E, IF, O, P = _check_bwd(h, w3, v2, g, b3)
    if E == 0:
        f32 = dict(dtype=torch.float32, device=h.device)
        mid = h.shape[1]
        return (torch.empty(0, mid, **f32), torch.zeros(mid, IF, O, **f32),
                torch.empty(0, P, IF, **f32), torch.zeros(IF, O, **f32))
    dw3, dv2, db3 = _launch_bwd_a(h, w3, v2, g, b3, E, IF, O, P)
    return _launch_bwd_b(w3, v2, g, E, IF, O, P), dw3, dv2, db3


# every launch counts in .launches_a / .launches_b, the conv_bf16 arm's in
# .conv_bf16_launches_a / _b too, the narrow-O arm's in .narrow_launches_a
# / _b, the mid-32 arm's in .mid32_launches_a / _b
fused_pairwise_conv_bwd.launches_a = 0
fused_pairwise_conv_bwd.launches_b = 0
fused_pairwise_conv_bwd.conv_bf16_launches_a = 0
fused_pairwise_conv_bwd.conv_bf16_launches_b = 0
fused_pairwise_conv_bwd.narrow_launches_a = 0
fused_pairwise_conv_bwd.narrow_launches_b = 0
fused_pairwise_conv_bwd.mid32_launches_a = 0
fused_pairwise_conv_bwd.mid32_launches_b = 0


# ---------------------------------------------------------------------- #
# the differentiable op
# ---------------------------------------------------------------------- #
@torch.library.custom_op('se3_torch::pairwise_contract_bxf', mutates_args=(),
                         device_types='cpu')
def _pairwise_contract_op(h: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                          basis_flat: torch.Tensor, x: torch.Tensor, P: int,
                          Q: int, F: int) -> torch.Tensor:
    return fused_pairwise_conv_bxf_plain(h, w3, basis_flat, x, (P, Q, F), b3)


@_pairwise_contract_op.register_kernel('cuda')
def _(h, w3, b3, basis_flat, x, P, Q, F):
    return fused_pairwise_conv_bxf(h, w3, basis_flat, x, (P, Q, F), b3)


def _pc_setup(ctx, inputs, output):
    h, w3, b3, basis_flat, x, P, Q, F = inputs
    ctx.save_for_backward(h, w3, b3, basis_flat, x)
    ctx.pqf = (P, Q, F)


def _pc_backward(ctx, g):
    """The port of ops/conv.py::_pc_bxf_bwd: V2 rebuilt in float32, the
    fused backward, then dV2 folded back into dx (and dbasis when asked)
    by einsums; dh and dw3 in the dtypes of h and w3."""
    h, w3, b3, basis_flat, x = ctx.saved_tensors
    P, Q, F = ctx.pqf
    E, C = x.shape[0], x.shape[1]
    b4 = basis_flat.float().reshape(E, P, F, Q)
    x32 = x.float()
    v2 = torch.einsum('epfq,ecq->epcf', b4, x32).reshape(E, P, C * F)
    dh, dw3, dv2, db3 = fused_pairwise_conv_bwd(h, w3, v2, g.contiguous(), b3)
    dv2 = dv2.reshape(E, P, C, F)
    dbasis = dx = None
    if ctx.needs_input_grad[3]:
        dbasis = torch.einsum('ecq,epcf->epfq', x32, dv2).reshape(
            E, P * F * Q).to(basis_flat.dtype)
    if ctx.needs_input_grad[4]:
        dx = torch.einsum('epfq,epcf->ecq', b4, dv2).to(x.dtype)
    return (dh.to(h.dtype), dw3.to(w3.dtype), db3.to(b3.dtype), dbasis, dx,
            None, None, None)


_pairwise_contract_op.register_autograd(_pc_backward, setup_context=_pc_setup)


@torch.library.custom_op('se3_torch::pairwise_contract', mutates_args=(),
                         device_types='cpu')
def _contract_op(h: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                 v2: torch.Tensor) -> torch.Tensor:
    return fused_pairwise_conv_plain(h, w3, v2, b3)


@_contract_op.register_kernel('cuda')
def _(h, w3, b3, v2):
    return fused_pairwise_conv(h, w3, v2, b3)


def _contract_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _contract_backward(ctx, g):
    """The port of ops/conv.py::_pc_bwd: the fused backward on the saved
    operands; dh and dw3 in the dtypes of h and w3, dv2 to V2, whose own
    einsum carries it on to the basis and the features under autograd."""
    h, w3, b3, v2 = ctx.saved_tensors
    dh, dw3, dv2, db3 = fused_pairwise_conv_bwd(h, w3, v2, g.contiguous(), b3)
    return dh.to(h.dtype), dw3.to(w3.dtype), db3.to(b3.dtype), dv2.to(v2.dtype)


_contract_op.register_autograd(_contract_backward, setup_context=_contract_setup)


@torch.library.custom_op('se3_torch::pairwise_contract_bx', mutates_args=(),
                         device_types='cpu')
def _contract_bx_op(h: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                    basis: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return fused_pairwise_conv_bx_plain(h, w3, basis, x, b3)


@_contract_bx_op.register_kernel('cuda')
def _(h, w3, b3, basis, x):
    return fused_pairwise_conv_bx(h, w3, basis, x, b3)


def _contract_bx_backward(ctx, g):
    """The port of ops/conv.py::_pc_bx_bwd: V2 rebuilt in float32 from the
    structured basis, the fused backward (kernels A and B on a card), then
    dV2 folded back into dx and dbasis by einsums; dh and dw3 in the
    dtypes of h and w3."""
    h, w3, b3, basis, x = ctx.saved_tensors
    E, P, Q, F = basis.shape
    C = x.shape[1]
    b32, x32 = basis.float(), x.float()
    v2 = torch.einsum('epqf,ecq->epcf', b32, x32).reshape(E, P, C * F)
    dh, dw3, dv2, db3 = fused_pairwise_conv_bwd(h, w3, v2, g.contiguous(), b3)
    dv2 = dv2.reshape(E, P, C, F)
    dbasis = dx = None
    if ctx.needs_input_grad[3]:
        dbasis = torch.einsum('ecq,epcf->epqf', x32, dv2).to(basis.dtype)
    if ctx.needs_input_grad[4]:
        dx = torch.einsum('epqf,epcf->ecq', b32, dv2).to(x.dtype)
    return dh.to(h.dtype), dw3.to(w3.dtype), db3.to(b3.dtype), dbasis, dx


_contract_bx_op.register_autograd(_contract_bx_backward,
                                  setup_context=_contract_setup)

# the ops' overloads, as a checkpoint policy sees them
PAIRWISE_CONTRACT_OPS = (torch.ops.se3_torch.pairwise_contract_bxf.default,
                         torch.ops.se3_torch.pairwise_contract.default,
                         torch.ops.se3_torch.pairwise_contract_bx.default)


def pairwise_contract_bxf(h: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                          basis_flat: torch.Tensor, x: torch.Tensor,
                          pqf) -> torch.Tensor:
    """Differentiable fused_pairwise_conv_bxf (same operands, b3 third as
    in the JAX custom_vjp); gradients flow to h, w3, b3, basis_flat and x."""
    P, Q, F = (int(v) for v in pqf)
    return _pairwise_contract_op(h, w3, b3, basis_flat, x, P, Q, F)


def pairwise_contract_bx(h: torch.Tensor, w3: torch.Tensor,
                         b3: torch.Tensor, basis: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Differentiable fused_pairwise_conv_bx (b3 third, as in the JAX
    custom_vjp _pairwise_contract_pallas_bx); gradients flow to h, w3, b3,
    the structured basis and x. Saves only its operands."""
    return _contract_bx_op(h, w3, b3, basis, x)


def pairwise_contract(h: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                      v2: torch.Tensor) -> torch.Tensor:
    """Differentiable fused_pairwise_conv (b3 third as in the JAX
    custom_vjp); gradients flow to h, w3, b3 and v2. Saves only its
    operands for the backward: R never outlives the call."""
    return _contract_op(h, w3, b3, v2)
