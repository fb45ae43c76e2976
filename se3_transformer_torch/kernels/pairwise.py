"""The basis-fused pairwise convolution and its backward: wrappers, plain
versions, dispatch, and the differentiable op.

    out[e, p, o] = sum_{c, f} V2[e, p, c, f] * (h[e] . W3[:, (c, f), o] + b3[(c, f), o])
    V2[e, p, c, f] = sum_q B[e, (p, f, q)] * x[e, c, q]

Port of se3_transformer_tpu/kernels/pallas_pairwise.py::fused_pairwise_conv_bxf
and ::fused_pairwise_conv_bwd with the same signatures and row-major
layouts: h [E, mid], w3 [mid, C*F, O] (i = c*F + f, c-major), basis_flat
[E, P*F*Q] in (p, f, q) order, x [E, C, Q], b3 [C*F, O] -> out [E, P, O]
float32; the backward takes v2 [E, P, C*F] and g [E, P, O].

A CPU tensor takes the plain PyTorch version. A CUDA tensor launches the
hand-written Hopper kernels (csrc/pairwise_bxf.cu, csrc/pairwise_bwd.cu) or
raises; nothing falls back. `fused_pairwise_conv_bxf.launches` and
`fused_pairwise_conv_bwd.launches_a` / `.launches_b` count kernel launches.

`pairwise_contract_bxf` is the differentiable form (the port of
se3_transformer_tpu/ops/conv.py::_pairwise_contract_pallas_bxf and its
custom_vjp): a torch.library custom op, so that a selective activation
checkpoint policy sees the forward as one op and can save its output.
"""
from __future__ import annotations

import ctypes

import torch

MID = 128          # the radial hidden width the kernel is built for
O_TILE = 64        # output channels per CTA: O must be a multiple
EDGE_TILE = 64     # edges per CTA
ORDERS = (1, 3, 5, 7)   # P and Q the kernel is instantiated for (degree <= 3)


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


def _check(h, w3, basis_flat, x, pqf, b3):
    P, Q, F = pqf
    E = h.shape[0]
    dev = h.device
    for name, t in (('w3', w3), ('basis_flat', basis_flat), ('x', x),
                    ('b3', b3)):
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, h on {dev}')
    if h.dtype not in (torch.bfloat16, torch.float32) or w3.dtype != h.dtype:
        raise TypeError(f'h/w3 must both be bfloat16 or float32, got '
                        f'{h.dtype}/{w3.dtype}')
    for name, t in (('basis_flat', basis_flat), ('x', x), ('b3', b3)):
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
    if P not in ORDERS or Q not in ORDERS or F != min(P, Q):
        raise ValueError(f'unsupported (P, Q, F) = {pqf}')
    if h.ndim != 2 or h.shape[1] != MID:
        raise ValueError(f'h must be [E, {MID}], got {tuple(h.shape)}')
    if x.ndim != 3 or x.shape[0] != E or x.shape[2] != Q:
        raise ValueError(f'x must be [E, C, {Q}], got {tuple(x.shape)}')
    C = x.shape[1]
    if w3.ndim != 3 or w3.shape[:2] != (MID, C * F) \
            or w3.shape[2] % O_TILE != 0 or w3.shape[2] == 0:
        raise ValueError(f'w3 must be [{MID}, {C * F}, k*{O_TILE}], got '
                         f'{tuple(w3.shape)}')
    O = w3.shape[2]
    if tuple(b3.shape) != (C * F, O):
        raise ValueError(f'b3 must be [{C * F}, {O}], got {tuple(b3.shape)}')
    if tuple(basis_flat.shape) != (E, P * F * Q):
        raise ValueError(f'basis_flat must be [{E}, {P * F * Q}], got '
                         f'{tuple(basis_flat.shape)}')
    for name, t in (('h', h), ('w3', w3), ('basis_flat', basis_flat),
                    ('x', x), ('b3', b3)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    return E, C, O


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
    P, Q, _ = pqf
    out = torch.empty(E, P, O, dtype=torch.float32, device=h.device)
    if E == 0:
        return out
    from .build import load_library
    lib = load_library()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.se3_pairwise_bxf(
            h.data_ptr(), w3.data_ptr(), b3.data_ptr(), basis_flat.data_ptr(),
            x.data_ptr(), out.data_ptr(), E, C, O, P, Q,
            int(h.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f'se3_pairwise_bxf launch failed: CUDA error {rc}')
    fused_pairwise_conv_bxf.launches += 1
    return out


fused_pairwise_conv_bxf.launches = 0


# ---------------------------------------------------------------------- #
# backward
# ---------------------------------------------------------------------- #
BWD_I_CHUNK = 2      # i = (c, f) values per kernel-A CTA (csrc/pairwise_bwd.cu)
BWD_TARGET_CTAS = 264  # kernel A's grid: about two CTAs per SM of an H100


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
    dev = h.device
    for name, t in (('w3', w3), ('v2', v2), ('g', g), ('b3', b3)):
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, h on {dev}')
    if h.dtype not in (torch.bfloat16, torch.float32) or w3.dtype != h.dtype:
        raise TypeError(f'h/w3 must both be bfloat16 or float32, got '
                        f'{h.dtype}/{w3.dtype}')
    for name, t in (('v2', v2), ('g', g), ('b3', b3)):
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
    if h.ndim != 2 or h.shape[1] != MID:
        raise ValueError(f'h must be [E, {MID}], got {tuple(h.shape)}')
    E = h.shape[0]
    if w3.ndim != 3 or w3.shape[0] != MID or w3.shape[2] != O_TILE \
            or w3.shape[1] == 0:
        raise ValueError(f'w3 must be [{MID}, IF, {O_TILE}], got '
                         f'{tuple(w3.shape)}')
    IF = w3.shape[1]
    if v2.ndim != 3 or v2.shape[0] != E or v2.shape[1] not in ORDERS \
            or v2.shape[2] != IF:
        raise ValueError(f'v2 must be [{E}, P, {IF}] with P in {ORDERS}, got '
                         f'{tuple(v2.shape)}')
    P = v2.shape[1]
    if tuple(g.shape) != (E, P, O_TILE):
        raise ValueError(f'g must be [{E}, {P}, {O_TILE}], got '
                         f'{tuple(g.shape)}')
    if tuple(b3.shape) != (IF, O_TILE):
        raise ValueError(f'b3 must be [{IF}, {O_TILE}], got '
                         f'{tuple(b3.shape)}')
    for name, t in (('h', h), ('w3', w3), ('v2', v2), ('g', g), ('b3', b3)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    return E, IF, P


def bwd_splits(E: int, IF: int) -> int:
    """How many edge ranges kernel A splits E into: enough CTAs to fill
    the card, each range at least one 64-edge tile. A function of the
    shapes only, so the partial sums and their reduce order (and so dW3
    and dB3, bit for bit) are the same on every run."""
    n_tiles = -(-E // EDGE_TILE)
    n_chunks = -(-IF // BWD_I_CHUNK)
    splits = max(1, min(n_tiles, -(-BWD_TARGET_CTAS // n_chunks)))
    per_split = -(-n_tiles // splits)
    return -(-n_tiles // per_split)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch_bwd_a(h, w3, v2, g, b3, E, IF, P):
    """Kernel A and its edge reduce on operands that passed _check_bwd,
    E > 0 -> (dw3, dv2, db3); counts one kernel-A launch."""
    f32 = dict(dtype=torch.float32, device=h.device)
    dv2 = torch.empty(E, P, IF, **f32)
    dw3 = torch.empty(MID, IF, O_TILE, **f32)
    db3 = torch.empty(IF, O_TILE, **f32)
    splits = bwd_splits(E, IF)
    work = torch.empty(splits * (MID + 1) * IF * O_TILE, **f32)
    from .build import load_library
    with torch.cuda.device(h.device):
        rc = load_library().se3_pairwise_bwd_a(
            h.data_ptr(), w3.data_ptr(), b3.data_ptr(), v2.data_ptr(),
            g.data_ptr(), dv2.data_ptr(), work.data_ptr(), dw3.data_ptr(),
            db3.data_ptr(), E, IF, P, splits,
            int(h.dtype == torch.bfloat16), _stream(h))
    if rc != 0:
        raise RuntimeError(f'se3_pairwise_bwd_a launch failed: CUDA error '
                           f'{rc}')
    fused_pairwise_conv_bwd.launches_a += 1
    return dw3, dv2, db3


def _launch_bwd_b(w3, v2, g, E, IF, P):
    """Kernel B on operands that passed _check_bwd, E > 0 -> dh; counts
    one kernel-B launch."""
    dh = torch.empty(E, MID, dtype=torch.float32, device=w3.device)
    from .build import load_library
    with torch.cuda.device(w3.device):
        rc = load_library().se3_pairwise_bwd_b(
            w3.data_ptr(), v2.data_ptr(), g.data_ptr(), dh.data_ptr(), E, IF,
            P, int(w3.dtype == torch.bfloat16), _stream(w3))
    if rc != 0:
        raise RuntimeError(f'se3_pairwise_bwd_b launch failed: CUDA error '
                           f'{rc}')
    fused_pairwise_conv_bwd.launches_b += 1
    return dh


def fused_pairwise_conv_bwd(h: torch.Tensor, w3: torch.Tensor,
                            v2: torch.Tensor, g: torch.Tensor,
                            b3: torch.Tensor = None):
    """Backward of fused_pairwise_conv_bxf (given V2): h [E, mid], w3
    [mid, IF, O], v2 [E, P, IF], g [E, P, O], b3 [IF, O] (zeros when None)
    -> (dh [E, mid], dw3 [mid, IF, O], dv2 [E, P, IF], db3 [IF, O]), all
    float32. On a card: kernel A (dV2, dW3, dB3, with its deterministic
    edge reduce) then kernel B (dH); mid = 128 and O = 64 there."""
    if b3 is None:
        b3 = torch.zeros(w3.shape[1:], dtype=torch.float32, device=h.device)
    if h.device.type == 'cpu':
        return fused_pairwise_conv_bwd_plain(h, w3, v2, g, b3)
    if h.device.type != 'cuda':
        raise ValueError(f'no kernel for device {h.device}')
    E, IF, P = _check_bwd(h, w3, v2, g, b3)
    if E == 0:
        f32 = dict(dtype=torch.float32, device=h.device)
        return (torch.empty(0, MID, **f32), torch.zeros(MID, IF, O_TILE, **f32),
                torch.empty(0, P, IF, **f32), torch.zeros(IF, O_TILE, **f32))
    dw3, dv2, db3 = _launch_bwd_a(h, w3, v2, g, b3, E, IF, P)
    return _launch_bwd_b(w3, v2, g, E, IF, P), dw3, dv2, db3


fused_pairwise_conv_bwd.launches_a = 0
fused_pairwise_conv_bwd.launches_b = 0


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

# the op's overload, as a checkpoint policy sees it
PAIRWISE_CONTRACT_OP = torch.ops.se3_torch.pairwise_contract_bxf.default


def pairwise_contract_bxf(h: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                          basis_flat: torch.Tensor, x: torch.Tensor,
                          pqf) -> torch.Tensor:
    """Differentiable fused_pairwise_conv_bxf (same operands, b3 third as
    in the JAX custom_vjp); gradients flow to h, w3, b3, basis_flat and x."""
    P, Q, F = (int(v) for v in pqf)
    return _pairwise_contract_op(h, w3, b3, basis_flat, x, P, Q, F)
