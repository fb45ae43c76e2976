"""Rotary position embeddings for the degree-0 channels: the port of
se3_transformer_tpu/ops/rotary.py. They rotate only the invariant (degree-0)
q, k and v, so they do not touch equivariance. Layouts keep the trailing
irrep axis m: t [..., d, m], frequencies [..., rot_dim].
"""
from __future__ import annotations

import torch


def sinusoidal_embeddings(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Positions t [...] -> [..., dim] rotary phase angles, each frequency
    repeated for its pair of channels (f1, f1, f2, f2, ...)."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=t.device) / dim))
    freqs = t[..., None].float() * inv_freq
    # each frequency twice (repeat_interleave by an int would wait for the
    # device)
    return freqs[..., None].expand(*freqs.shape, 2).reshape(
        *freqs.shape[:-1], -1)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x1, x2) -> (-x2, x1) over consecutive channel pairs of x [..., d,
    m]."""
    x = x.reshape(*x.shape[:-2], -1, 2, x.shape[-1])
    x1, x2 = x[..., 0, :], x[..., 1, :]
    out = torch.stack((-x2, x1), dim=-2)
    return out.reshape(*out.shape[:-3], -1, out.shape[-1])


def apply_rotary_pos_emb(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """t [..., d, m] with its first rot_dim channels rotated by freqs
    [..., rot_dim] (broadcast over m)."""
    freqs = freqs[..., None]
    rot_dim = freqs.shape[-2]
    t_rot, t_pass = t[..., :rot_dim, :], t[..., rot_dim:, :]
    t_rot = t_rot * torch.cos(freqs) + _rotate_half(t_rot) * torch.sin(freqs)
    return torch.cat((t_rot, t_pass), dim=-2)
