"""Generic tensor helpers: the port of se3_transformer_tpu/utils/helpers.py
restricted to what the serving forward uses."""
from __future__ import annotations

import torch


def to_order(degree: int) -> int:
    """Dimension of the degree-l irrep of SO(3): 2l + 1."""
    return 2 * degree + 1


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and there
    is none (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device!r} requested but torch.cuda.is_available() is '
            f'False; pass device="cpu" to run on the CPU')
    return dev


def batched_index_select(values: torch.Tensor, indices: torch.Tensor,
                         dim: int = 1) -> torch.Tensor:
    """Gather `values` along `dim` with batched integer `indices`.

    values:  [*B, n, *V] with n at `dim`
    indices: [*B, *I] — leading dims equal values.shape[:dim]
    returns: [*B, *I, *V]
    """
    batch = values.shape[:dim]
    value_dims = values.shape[dim + 1:]
    idx_extra = indices.shape[len(batch):]
    nb = 1
    for s in batch:
        nb *= s
    v = values.reshape(nb, values.shape[dim], *value_dims)
    idx = indices.reshape(nb, -1)
    rows = torch.arange(nb, device=values.device)[:, None]
    out = v[rows, idx]
    return out.reshape(*batch, *idx_extra, *value_dims)


def masked_mean(tensor: torch.Tensor, mask, dim: int = -1) -> torch.Tensor:
    """Mean over `dim` counting only entries where mask is True; 0 where
    nothing is valid. mask broadcasts from the left."""
    if mask is None:
        return tensor.mean(dim=dim)
    diff_len = tensor.ndim - mask.ndim
    mask = mask.reshape(mask.shape + (1,) * diff_len)
    tensor = torch.where(mask, tensor, torch.zeros((), dtype=tensor.dtype,
                                                   device=tensor.device))
    total_el = mask.sum(dim=dim)
    mean = tensor.sum(dim=dim) / total_el.clamp(min=1).to(tensor.dtype)
    return torch.where(total_el == 0, torch.zeros_like(mean), mean)


def safe_norm(x: torch.Tensor, dim: int = -1,
              keepdim: bool = False) -> torch.Tensor:
    """L2 norm that is exactly 0 (with a zero gradient) at x = 0."""
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    is_zero = sq == 0
    safe = torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq))
    return torch.where(is_zero, torch.zeros_like(safe), safe)
