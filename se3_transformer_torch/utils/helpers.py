"""Generic tensor helpers: the port of se3_transformer_tpu/utils/helpers.py
restricted to what the model uses."""
from __future__ import annotations

import functools

import torch

# One-time host work that a forward can set off: each build of a cached
# device constant (a blocking host-to-device copy) and the load of the
# kernels' library. observability.runtime reads the count: after an
# engine's warmup, a request that adds to it paid that work in its latency.
ONE_TIME_WORK = [0]


def device_constant(fn):
    """functools.lru_cache(maxsize=None) over fn, each miss (each build of
    the constant) counted in ONE_TIME_WORK; cache_info and cache_clear are
    lru_cache's."""
    @functools.wraps(fn)
    def build(*args):
        ONE_TIME_WORK[0] += 1
        return fn(*args)
    return functools.lru_cache(maxsize=None)(build)


def to_order(degree: int) -> int:
    """Dimension of the degree-l irrep of SO(3): 2l + 1."""
    return 2 * degree + 1


def cast_tuple(val, depth: int) -> tuple:
    """val itself when it is a tuple, else val repeated `depth` times."""
    return val if isinstance(val, tuple) else (val,) * depth


def fourier_encode(x: torch.Tensor, num_encodings: int = 4,
                   include_self: bool = True,
                   flatten: bool = True) -> torch.Tensor:
    """Sin/cos features of x at the dyadic scales 2**0 .. 2**(E-1), then x
    itself: [..., d] -> [..., d, 2E (+1)], flattened over the trailing
    axes after the first three as the JAX function does."""
    x = x[..., None]
    orig_x = x
    scales = 2 ** torch.arange(num_encodings, dtype=x.dtype, device=x.device)
    x = x / scales
    x = torch.cat([torch.sin(x), torch.cos(x)], dim=-1)
    if include_self:
        x = torch.cat((x, orig_x), dim=-1)
    if flatten:
        x = x.reshape(*x.shape[:3], -1)
    return x


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
