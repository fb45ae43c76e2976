"""The port's pairwise kernel module (se3_transformer_torch.kernels.pairwise)
against the JAX package's fused_pairwise_conv_bxf.

On the CPU the wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernel body in interpret mode. Inputs are made from a seed with
numpy and fed to both. The CUDA kernel itself is held against the plain
version by tests/test_torch_kernels.py on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu.kernels.pallas_pairwise import (
    fused_pairwise_conv_bxf as jax_bxf,
)
from se3_transformer_torch.kernels import pairwise as kp

PAIRS = [(di, do) for di in range(4) for do in range(4)]
# E = 70 is not a multiple of the CUDA kernel's 64-edge tile (ragged tail)
E, MID, C, O = 70, 16, 3, 4
# Both sides sum the same float32 products (bf16 products are exact in
# float32) in different orders: float32 rounding, relative to the output
RTOL = 1e-5


def _operands(di, do, seed, e=E, mid=MID, c=C, o=O):
    rng = np.random.RandomState(seed)
    P, Q, F = 2 * do + 1, 2 * di + 1, 2 * min(di, do) + 1
    return dict(
        h=rng.normal(size=(e, mid)).astype(np.float32),
        w3=(rng.normal(size=(mid, c * F, o)) / np.sqrt(mid)).astype(np.float32),
        basis=rng.normal(size=(e, P * F * Q)).astype(np.float32),
        x=rng.normal(size=(e, c, Q)).astype(np.float32),
        b3=rng.normal(size=(c * F, o)).astype(np.float32),
        pqf=(P, Q, F))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('di,do', PAIRS)
def test_plain_matches_jax_interpret_kernel(di, do, dtype):
    a = _operands(di, do, seed=10 * di + do)
    h_j = jnp.asarray(a['h'], dtype)
    w3_j = jnp.asarray(a['w3'], dtype)
    ref = np.asarray(jax_bxf(h_j, w3_j, a['basis'], a['x'], a['pqf'],
                             b3=a['b3'], interpret=True))
    tdt = getattr(torch, dtype)
    out = kp.fused_pairwise_conv_bxf(
        torch.from_numpy(a['h']).to(tdt), torch.from_numpy(a['w3']).to(tdt),
        torch.from_numpy(a['basis']), torch.from_numpy(a['x']), a['pqf'],
        torch.from_numpy(a['b3'])).numpy()
    assert out.shape == ref.shape == (E, 2 * do + 1, O)
    assert np.abs(out - ref).max() <= RTOL * np.abs(ref).max()
