"""The port's pairwise kernel module (se3_transformer_torch.kernels.pairwise)
against the JAX package's fused_pairwise_conv_bxf, fused_pairwise_conv_bwd
and the custom_vjp around them (ops/conv.py::_pairwise_contract_pallas_bxf).

On the CPU the wrappers run their plain PyTorch versions; the JAX side runs
the Pallas kernel bodies in interpret mode. Inputs are made from a seed with
numpy and fed to both. The CUDA kernels themselves are held against the
plain versions by tests/test_torch_kernels.py on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu.kernels.pallas_pairwise import (
    fused_pairwise_conv_bwd as jax_bwd,
    fused_pairwise_conv_bxf as jax_bxf,
)
from se3_transformer_tpu.ops.conv import _pairwise_contract_pallas_bxf
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


def _bwd_operands(di, do, seed):
    rng = np.random.RandomState(seed)
    P, F = 2 * do + 1, 2 * min(di, do) + 1
    IF = C * F
    return dict(
        h=rng.normal(size=(E, MID)).astype(np.float32),
        w3=(rng.normal(size=(MID, IF, O)) / np.sqrt(MID)).astype(np.float32),
        v2=rng.normal(size=(E, P, IF)).astype(np.float32),
        g=rng.normal(size=(E, P, O)).astype(np.float32),
        b3=rng.normal(size=(IF, O)).astype(np.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('di,do', PAIRS)
def test_plain_backward_matches_jax_interpret_kernels(di, do, dtype):
    """fused_pairwise_conv_bwd_plain against the two Pallas backward
    kernels (A: dV2, dW3, dB3; B: dH). The JAX implementation upcasts bf16
    h/w3 to float32 before anything else (pallas_pairwise.py:944), so its
    bf16 result is its float32 result on the rounded values: it is fed
    those, which keeps one interpret-mode compile per pair shape. The port
    gets the bf16 tensors themselves."""
    a = _bwd_operands(di, do, seed=100 + 10 * di + do)
    tdt = getattr(torch, dtype)
    h_t, w3_t = (torch.from_numpy(a[k]).to(tdt) for k in ('h', 'w3'))
    refs = jax_bwd(h_t.float().numpy(), w3_t.float().numpy(), a['v2'],
                   a['g'], b3=a['b3'], interpret=True)
    outs = kp.fused_pairwise_conv_bwd(
        h_t, w3_t, *(torch.from_numpy(a[k]) for k in ('v2', 'g', 'b3')))
    for name, out, ref in zip(('dh', 'dw3', 'dv2', 'db3'), outs, refs):
        ref = np.asarray(ref)
        assert out.dtype == torch.float32, name
        assert out.shape == ref.shape, name
        assert np.abs(out.numpy() - ref).max() <= RTOL * np.abs(ref).max(), \
            name


# one bf16 step (2**-8 relative): the float32 gradients agree to RTOL, but
# the two sides round them to bf16 independently, and a value within RTOL
# of a rounding boundary may land one step apart
BF16_GRAD_RTOL = 2 ** -8


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('di,do', [(2, 1), (0, 3)])
def test_differentiable_op_matches_jax_vjp(di, do, dtype):
    """pairwise_contract_bxf's autograd against jax.vjp of the JAX
    custom_vjp (_pc_bxf_fwd/_pc_bxf_bwd, kernels in interpret mode): dh
    and dw3 come back in the dtypes of h and w3, db3 and dx in float32."""
    a = _operands(di, do, seed=200 + 10 * di + do)
    P, Q, F = a['pqf']
    g = np.random.RandomState(7).normal(size=(E, P, O)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def f(h, w3, b3, x):
        return _pairwise_contract_pallas_bxf(h, w3, b3, a['basis'], x,
                                             a['pqf'], True, None)
    _, vjp = jax.vjp(f, jnp.asarray(a['h'], jdt), jnp.asarray(a['w3'], jdt),
                     jnp.asarray(a['b3']), jnp.asarray(a['x']))
    refs = vjp(jnp.asarray(g))

    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a['h']).to(tdt).requires_grad_(),
              torch.from_numpy(a['w3']).to(tdt).requires_grad_(),
              torch.from_numpy(a['b3']).requires_grad_(),
              torch.from_numpy(a['x']).requires_grad_()]
    h, w3, b3, x = leaves
    kp.pairwise_contract_bxf(h, w3, b3, torch.from_numpy(a['basis']), x,
                             a['pqf']).backward(torch.from_numpy(g))
    for name, leaf, ref in zip(('dh', 'dw3', 'db3', 'dx'), leaves, refs):
        ref = np.asarray(ref.astype(jnp.float32))
        assert leaf.grad.dtype == leaf.dtype, name
        tol = BF16_GRAD_RTOL if leaf.dtype == torch.bfloat16 else RTOL
        err = np.abs(leaf.grad.float().numpy() - ref).max()
        assert err <= tol * np.abs(ref).max(), name
