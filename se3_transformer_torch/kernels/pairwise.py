"""The basis-fused pairwise convolution: wrapper, plain version, dispatch.

    out[e, p, o] = sum_{c, f} V2[e, p, c, f] * (h[e] . W3[:, (c, f), o] + b3[(c, f), o])
    V2[e, p, c, f] = sum_q B[e, (p, f, q)] * x[e, c, q]

Port of se3_transformer_tpu/kernels/pallas_pairwise.py::fused_pairwise_conv_bxf
with the same signature and row-major layouts: h [E, mid], w3 [mid, C*F, O]
(i = c*F + f, c-major), basis_flat [E, P*F*Q] in (p, f, q) order,
x [E, C, Q], b3 [C*F, O] -> out [E, P, O] float32.

A CPU tensor takes the plain PyTorch version. A CUDA tensor launches the
hand-written Hopper kernel (csrc/pairwise_bxf.cu) or raises; nothing falls
back. `fused_pairwise_conv_bxf.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

MID = 128          # the radial hidden width the kernel is built for
O_TILE = 64        # output channels per CTA: O must be a multiple
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
