"""QuantTensor: an int8 or fp8-e4m3 weight with its per-output-channel
scales: the port of se3_transformer_tpu/quant/qtensor.py.

Post-training quantization replaces a matmul weight by

    q      int8 (torch.int8) or fp8 (torch.float8_e4m3fn), the float32
           weight's shape
    scale  float32, the contracted axes kept at size 1 (symmetric absmax
           scales per output channel, so `q * scale` broadcasts to the
           dequantized weight)

and the consumers fold the scale in after their contraction, `(x @ q) *
scale`: the float32 weight never exists as a device buffer. Here a
QuantTensor is an nn.Module whose two buffers take the place of the
float32 Parameter in its owner (quant.rules.quantize_params), so that
`module.to(device)` moves the 1-byte storage and a state_dict holds
`<name>.q` and `<name>.scale`.

`quantize` runs on the host with numpy and gives the JAX package's bits:
the same float32 scale, np.rint (half to even) for int8, and
round-to-nearest-even for fp8 (torch's cast, which ml_dtypes' matches).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# symmetric quantization ranges per storage dtype
INT8_MAX = 127.0
FP8_E4M3_MAX = 448.0


class QuantTensor(nn.Module):
    """One quantized weight: buffers `q` (int8 or fp8, the float32 weight's
    shape) and `scale` (float32, contracted axes of size 1). Consumers
    contract q and multiply by the scale after (the dequant epilogue)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer('q', q)
        self.register_buffer('scale', scale)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """The full-precision weight, as a transient value (the paths that
        take no in-tile epilogue) or a test oracle; never stored."""
        return self.q.to(dtype) * self.scale

    def extra_repr(self) -> str:
        return (f'q={tuple(self.q.shape)}:{self.q.dtype}, '
                f'scale={tuple(self.scale.shape)}')


def quantize(w, contract_axes: Sequence[int] = (0,),
             storage: str = 'int8') -> QuantTensor:
    """Symmetric per-output-channel quantization on the host: the absmax
    reduces over `contract_axes` (the matmul's contracted dims), every
    other dim keeps its own scale; an all-zero channel gets scale 1. `w` is
    a numpy array or a tensor (read on the host). Returns CPU tensors."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().float().numpy()
    w = np.asarray(w, np.float32)
    axes = tuple(int(a) % w.ndim for a in contract_axes)
    amax = np.max(np.abs(w), axis=axes, keepdims=True)
    if storage == 'int8':
        qmax = INT8_MAX
    elif storage == 'fp8_e4m3':
        qmax = FP8_E4M3_MAX
    else:
        raise ValueError(f"unknown quant storage {storage!r} (known: 'int8', "
                         f"'fp8_e4m3')")
    scale = amax / qmax
    scale = np.where(amax == 0.0, 1.0, scale).astype(np.float32)
    if storage == 'int8':
        q = torch.from_numpy(np.clip(np.rint(w / scale), -INT8_MAX, INT8_MAX)
                             .astype(np.int8))
    else:
        q = torch.from_numpy(np.ascontiguousarray(w / scale)).to(
            torch.float8_e4m3fn)
    return QuantTensor(q, torch.from_numpy(np.ascontiguousarray(scale)))


def dequantize(qt: QuantTensor) -> np.ndarray:
    """Host-side oracle: the float32 weight the epilogues compute with (up
    to one multiply's reassociation)."""
    return (qt.q.detach().cpu().to(torch.float32).numpy()
            * qt.scale.detach().cpu().numpy())


def is_quantized(obj) -> bool:
    """True for a QuantTensor, or a module that holds one."""
    if isinstance(obj, QuantTensor):
        return True
    return isinstance(obj, nn.Module) and any(
        isinstance(m, QuantTensor) for m in obj.modules())


def concat_weights(ws, axis: int):
    """Concatenate grouped radial weights along a non-contracted axis:
    QuantTensors of one storage dtype concatenate q and scale along it (the
    contracted dims are size 1 in the scale, so the axis is a per-channel
    axis in both); a mixed group dequantizes its quantized members."""
    ws = list(ws)
    if not any(isinstance(w, QuantTensor) for w in ws):
        return torch.cat(ws, dim=axis)
    if all(isinstance(w, QuantTensor) for w in ws) and len(
            {w.q.dtype for w in ws}) == 1:
        return QuantTensor(torch.cat([w.q for w in ws], dim=axis),
                           torch.cat([w.scale for w in ws], dim=axis))
    return torch.cat([w.dequant() if isinstance(w, QuantTensor)
                      else w.float() for w in ws], dim=axis)


def weight_or_none(w) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(storage, scale) for kernel plumbing: a QuantTensor yields (q,
    scale); a tensor yields (w, None)."""
    if isinstance(w, QuantTensor):
        return w.q, w.scale
    return w, None


def float_weight(w) -> torch.Tensor:
    """A weight as float32 for a path with no dequant epilogue: a
    QuantTensor dequantized, a bf16 cast upcast (exact), a float32 weight
    itself."""
    return w.dequant() if isinstance(w, QuantTensor) else w.float()
