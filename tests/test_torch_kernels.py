"""The kernel wrappers of se3_transformer_torch.kernels.pairwise without
JAX: their dispatch (a CPU tensor never launches or counts), their input
checks, and — on a card — the CUDA kernels against their plain versions.

This file imports no JAX, so the card's machine runs it as
`python -m pytest --noconftest tests/test_torch_kernels.py`; the
`cuda`-marked tests skip on a host without one.
"""
import numpy as np
import pytest
import torch

from se3_transformer_torch.kernels import pairwise as kp


def _operands(di, do, seed, e, mid, c, o):
    rng = np.random.RandomState(seed)
    P, Q, F = 2 * do + 1, 2 * di + 1, 2 * min(di, do) + 1
    return dict(
        h=rng.normal(size=(e, mid)).astype(np.float32),
        w3=(rng.normal(size=(mid, c * F, o)) / np.sqrt(mid)).astype(np.float32),
        basis=rng.normal(size=(e, P * F * Q)).astype(np.float32),
        x=rng.normal(size=(e, c, Q)).astype(np.float32),
        b3=rng.normal(size=(c * F, o)).astype(np.float32),
        pqf=(P, Q, F))


def test_cpu_tensors_never_count_a_launch():
    a = _operands(2, 3, seed=1, e=70, mid=16, c=3, o=4)
    before = kp.fused_pairwise_conv_bxf.launches
    kp.fused_pairwise_conv_bxf(*(torch.from_numpy(a[k]) for k in
                                 ('h', 'w3', 'basis', 'x')), a['pqf'],
                               torch.from_numpy(a['b3']))
    assert kp.fused_pairwise_conv_bxf.launches == before


def _kernel_args(di=1, do=2, e=96, dtype=torch.bfloat16):
    a = _operands(di, do, seed=3, e=e, mid=kp.MID, c=5, o=kp.O_TILE)
    t = {k: torch.from_numpy(a[k]) for k in ('h', 'w3', 'basis', 'x', 'b3')}
    return [t['h'].to(dtype), t['w3'].to(dtype), t['basis'], t['x'],
            a['pqf'], t['b3']]


@pytest.mark.parametrize('bad', [
    'h_dtype', 'mixed_hw3', 'basis_dtype', 'mid', 'o_tile', 'pqf',
    'basis_shape', 'x_shape', 'b3_shape', 'noncontig'])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The CUDA path validates before launching; the checks read only
    metadata, so they are exercised here on CPU tensors."""
    args = _kernel_args()
    E_, C_ = args[0].shape[0], args[3].shape[1]
    assert kp._check(*args) == (E_, C_, kp.O_TILE)
    if bad == 'h_dtype':
        args[0] = args[0].half()
    elif bad == 'mixed_hw3':
        args[1] = args[1].float()
    elif bad == 'basis_dtype':
        args[2] = args[2].double()
    elif bad == 'mid':
        args[0] = args[0][:, :64].contiguous()
    elif bad == 'o_tile':
        args[1] = args[1][..., :32].contiguous()
        args[5] = args[5][:, :32].contiguous()
    elif bad == 'pqf':
        args[4] = (5, 3, 5)
    elif bad == 'basis_shape':
        args[2] = args[2][:-1]
    elif bad == 'x_shape':
        args[3] = args[3][..., :2].contiguous()
    elif bad == 'b3_shape':
        args[5] = args[5][:-1]
    elif bad == 'noncontig':
        args[3] = args[3].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        kp._check(*args)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('di,do,e', [(0, 0, 64), (3, 3, 200), (2, 1, 1000),
                                     (1, 3, 77)])
def test_cuda_kernel_matches_plain(cuda_card, di, do, e, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() if isinstance(a, torch.Tensor) else a
            for a in _kernel_args(di, do, e, dtype)]
    before = kp.fused_pairwise_conv_bxf.launches
    out = kp.fused_pairwise_conv_bxf(*args)
    torch.cuda.synchronize()
    assert kp.fused_pairwise_conv_bxf.launches == before + 1
    ref = kp.fused_pairwise_conv_bxf_plain(*args)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


def _bwd_args(di=1, do=2, e=96, c=5, dtype=torch.bfloat16, seed=4):
    """Backward operands at the kernels' widths (mid 128, O 64)."""
    rng = np.random.RandomState(seed)
    P, F = 2 * do + 1, 2 * min(di, do) + 1
    IF = c * F
    h = torch.from_numpy(rng.normal(size=(e, kp.MID)).astype(np.float32))
    w3 = torch.from_numpy((rng.normal(size=(kp.MID, IF, kp.O_TILE))
                           / np.sqrt(kp.MID)).astype(np.float32))
    return [h.to(dtype), w3.to(dtype),
            torch.from_numpy(rng.normal(size=(e, P, IF)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(e, P, kp.O_TILE))
                             .astype(np.float32)),
            torch.from_numpy(0.1 * rng.normal(size=(IF, kp.O_TILE))
                             .astype(np.float32))]


def test_cpu_backward_never_counts_a_launch():
    before = (kp.fused_pairwise_conv_bwd.launches_a,
              kp.fused_pairwise_conv_bwd.launches_b)
    outs = kp.fused_pairwise_conv_bwd(*_bwd_args(e=70))
    assert [tuple(o.shape) for o in outs] == [
        (70, kp.MID), (kp.MID, 15, kp.O_TILE), (70, 5, 15), (15, kp.O_TILE)]
    assert all(o.dtype == torch.float32 for o in outs)
    assert (kp.fused_pairwise_conv_bwd.launches_a,
            kp.fused_pairwise_conv_bwd.launches_b) == before


@pytest.mark.parametrize('bad', [
    'h_dtype', 'mixed_hw3', 'v2_dtype', 'mid', 'o', 'p', 'v2_if', 'g_shape',
    'b3_shape', 'noncontig_g'])
def test_bwd_wrapper_rejects_what_the_kernels_do_not_take(bad):
    args = _bwd_args()
    assert kp._check_bwd(*args) == (96, 15, 5)
    if bad == 'h_dtype':
        args[0] = args[0].half()
    elif bad == 'mixed_hw3':
        args[1] = args[1].float()
    elif bad == 'v2_dtype':
        args[2] = args[2].double()
    elif bad == 'mid':
        args[0] = args[0][:, :64].contiguous()
    elif bad == 'o':
        args[1] = args[1][..., :32].contiguous()
        args[3] = args[3][..., :32].contiguous()
        args[4] = args[4][:, :32].contiguous()
    elif bad == 'p':
        args[2] = args[2][:, :4].contiguous()
        args[3] = args[3][:, :4].contiguous()
    elif bad == 'v2_if':
        args[2] = args[2][..., :-1].contiguous()
    elif bad == 'g_shape':
        args[3] = args[3][:-1]
    elif bad == 'b3_shape':
        args[4] = args[4][:-1]
    elif bad == 'noncontig_g':
        args[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        kp._check_bwd(*args)


@pytest.mark.parametrize('E,IF', [(1, 1), (64, 15), (5000, 15), (32768, 64),
                                  (32768, 448), (32731, 192)])
def test_bwd_splits_give_every_split_a_tile(E, IF):
    """Kernel A's edge splits: each owns at least one 64-edge tile and
    together they cover every tile (the C side divides the same way)."""
    splits = kp.bwd_splits(E, IF)
    n_tiles = -(-E // kp.EDGE_TILE)
    per_split = -(-n_tiles // splits)
    assert 1 <= splits <= n_tiles
    assert (splits - 1) * per_split < n_tiles <= splits * per_split


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('di,do,e', [(0, 0, 64), (3, 3, 200), (2, 1, 1000),
                                     (1, 3, 77), (3, 2, 5000)])
def test_cuda_backward_kernels_match_plain(cuda_card, di, do, e, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() for a in _bwd_args(di, do, e, dtype=dtype)]
    before = (kp.fused_pairwise_conv_bwd.launches_a,
              kp.fused_pairwise_conv_bwd.launches_b)
    outs = kp.fused_pairwise_conv_bwd(*args)
    torch.cuda.synchronize()
    assert (kp.fused_pairwise_conv_bwd.launches_a,
            kp.fused_pairwise_conv_bwd.launches_b) == (before[0] + 1,
                                                       before[1] + 1)
    refs = kp.fused_pairwise_conv_bwd_plain(*args)
    for name, out, ref in zip(('dh', 'dw3', 'dv2', 'db3'), outs, refs):
        assert out.shape == ref.shape, name
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max(), name


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_cuda_backward_dw3_db3_are_bit_identical(cuda_card, dtype):
    """The edge reduction uses no atomics: two runs agree bit for bit."""
    args = [a.cuda() for a in _bwd_args(3, 3, 5000, dtype=dtype)]
    first = kp.fused_pairwise_conv_bwd(*args)
    second = kp.fused_pairwise_conv_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
