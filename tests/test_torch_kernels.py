"""The kernel wrappers of se3_transformer_torch.kernels.pairwise without
JAX: their dispatch (a CPU tensor never launches or counts), their input
checks, and — on a card — the CUDA kernels against their plain versions.

This file imports no JAX, so the card's machine runs it as
`python -m pytest --noconftest tests/test_torch_kernels.py`; the
`cuda`-marked tests skip on a host without one.
"""
import warnings

import numpy as np
import pytest
import torch

from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.kernels import routing

# one intra-op thread: these operands are tiny, and pytest-xdist's workers
# would otherwise oversubscribe the CPU with spinning thread pools
torch.set_num_threads(1)


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


def _kernel_args(di=1, do=2, e=96, dtype=torch.bfloat16, c=5):
    a = _operands(di, do, seed=3, e=e, mid=kp.MID, c=c, o=kp.O_TILE)
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


# kernels #1 and #2 on the card: every (P, Q) at a ragged E with C = 5
# (an odd C*F: a last chunk half past the last i, a ragged last V2 stage),
# and the flagship's C = 64 (many stages) at whole and ragged E
BXF_CASES = ([(di, do, 61 + 13 * (4 * di + do), 5)
              for di in range(4) for do in range(4)]
             + [(0, 0, 1000, 64), (3, 3, 200, 64), (2, 1, 1024, 64),
                (1, 3, 77, 64), (3, 0, 131, 64), (0, 3, 64, 64)])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('di,do,e,c', BXF_CASES)
def test_cuda_kernel_matches_plain(cuda_card, di, do, e, c, dtype):
    """Kernel #1 against its plain version within 1e-4 of max|plain|, and
    the same bits on a repeat."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() if isinstance(a, torch.Tensor) else a
            for a in _kernel_args(di, do, e, dtype, c)]
    before = kp.fused_pairwise_conv_bxf.launches
    out = kp.fused_pairwise_conv_bxf(*args)
    torch.cuda.synchronize()
    assert kp.fused_pairwise_conv_bxf.launches == before + 1
    ref = kp.fused_pairwise_conv_bxf_plain(*args)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(out, kp.fused_pairwise_conv_bxf(*args))


def _bwd_args(di=1, do=2, e=96, c=5, dtype=torch.bfloat16, seed=4,
              o=kp.O_TILE):
    """Backward operands at the kernels' widths (mid 128, O 64 unless
    given)."""
    rng = np.random.RandomState(seed)
    P, F = 2 * do + 1, 2 * min(di, do) + 1
    IF = c * F
    h = torch.from_numpy(rng.normal(size=(e, kp.MID)).astype(np.float32))
    w3 = torch.from_numpy((rng.normal(size=(kp.MID, IF, o))
                           / np.sqrt(kp.MID)).astype(np.float32))
    return [h.to(dtype), w3.to(dtype),
            torch.from_numpy(rng.normal(size=(e, P, IF)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(e, P, o)).astype(np.float32)),
            torch.from_numpy(0.1 * rng.normal(size=(IF, o))
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
    assert kp._check_bwd(*args) == (96, 15, kp.O_TILE, 5)
    if bad == 'h_dtype':
        args[0] = args[0].half()
    elif bad == 'mixed_hw3':
        args[1] = args[1].float()
    elif bad == 'v2_dtype':
        args[2] = args[2].double()
    elif bad == 'mid':
        args[0] = args[0][:, :64].contiguous()
    elif bad == 'o':
        # 32 is a narrow arm's O; 24 is neither narrow nor a 64 multiple
        args[1] = args[1][..., :24].contiguous()
        args[3] = args[3][..., :24].contiguous()
        args[4] = args[4][:, :24].contiguous()
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
@pytest.mark.parametrize('di,do,e', [(0, 0, 77), (1, 1, 1000), (2, 3, 130),
                                     (3, 3, 4100)])
def test_cuda_backward_a_even_if_matches_plain(cuda_card, di, do, e, dtype):
    """Kernel A where IF is even (c = 4): a row's two values of V2 and dV2
    move as one 8-byte copy; ragged E, every P."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() for a in _bwd_args(di, do, e, c=4, dtype=dtype)]
    assert args[2].shape[2] % 2 == 0
    shape = kp._check_bwd(*args)
    outs = kp._launch_bwd_a(*args, *shape)
    torch.cuda.synchronize()
    refs = kp.fused_pairwise_conv_bwd_a_plain(*args)
    for name, out, ref in zip(('dw3', 'dv2', 'db3'), outs, refs):
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max(), name


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('di,do,e,c,o', [
    (0, 0, 77, 32, 192), (1, 1, 1000, 32, 192), (0, 1, 300, 5, 128),
    (3, 3, 130, 4, 192)])
def test_cuda_backward_kernels_take_o_tiles(cuda_card, di, do, e, c, o, dtype):
    """Kernels A and B at O = 128 and 192 (two and three 64-wide O tiles,
    one CTA each, their partials reduced in tile order): within 1e-4 of
    the plain versions, and the same bits on a second run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() for a in _bwd_args(di, do, e, c=c, dtype=dtype, o=o)]
    shape = kp._check_bwd(*args)
    outs = (kp._launch_bwd_b(*args[1:4], *shape),
            *kp._launch_bwd_a(*args, *shape))
    again = (kp._launch_bwd_b(*args[1:4], *shape),
             *kp._launch_bwd_a(*args, *shape))
    torch.cuda.synchronize()
    refs = (kp.fused_pairwise_conv_bwd_b_plain(*args[1:4]),
            *kp.fused_pairwise_conv_bwd_a_plain(*args))
    for name, out, ref, out2 in zip(('dh', 'dw3', 'dv2', 'db3'), outs, refs,
                                    again):
        assert out.shape == ref.shape, name
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max(), name
        assert torch.equal(out, out2), name


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


# ---------------------------------------------------------------------- #
# the forward with V2 given (fused_pairwise_conv)
# ---------------------------------------------------------------------- #
def _fwd_args(P=5, IF=70, e=96, dtype=torch.bfloat16, seed=5):
    """Forward operands at the kernel's widths (mid 128, O 64); IF is the
    concatenated (c, f) axis of one output degree's pairs."""
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.normal(size=(e, kp.MID)).astype(np.float32))
    w3 = torch.from_numpy((rng.normal(size=(kp.MID, IF, kp.O_TILE))
                           / np.sqrt(kp.MID)).astype(np.float32))
    return [h.to(dtype), w3.to(dtype),
            torch.from_numpy(rng.normal(size=(e, P, IF)).astype(np.float32)),
            torch.from_numpy(0.1 * rng.normal(size=(IF, kp.O_TILE))
                             .astype(np.float32))]


def test_cpu_forward_never_counts_a_launch():
    before = kp.fused_pairwise_conv.launches
    out = kp.fused_pairwise_conv(*_fwd_args(e=70))
    assert tuple(out.shape) == (70, 5, kp.O_TILE)
    assert out.dtype == torch.float32
    assert kp.fused_pairwise_conv.launches == before


@pytest.mark.parametrize('bad', [
    'h_dtype', 'mixed_hw3', 'v2_dtype', 'b3_dtype', 'mid', 'o_tile', 'p',
    'v2_if', 'v2_edges', 'b3_shape', 'noncontig_v2'])
def test_fwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = _fwd_args()
    assert kp._check_fwd(*args) == (96, 70, kp.O_TILE, 5)
    if bad == 'h_dtype':
        args[0] = args[0].half()
    elif bad == 'mixed_hw3':
        args[1] = args[1].float()
    elif bad == 'v2_dtype':
        args[2] = args[2].double()
    elif bad == 'b3_dtype':
        args[3] = args[3].double()
    elif bad == 'mid':
        args[0] = args[0][:, :64].contiguous()
    elif bad == 'o_tile':
        # 32 is a narrow arm's O; 24 is neither narrow nor a 64 multiple
        args[1] = args[1][..., :24].contiguous()
        args[3] = args[3][:, :24].contiguous()
    elif bad == 'p':
        args[2] = args[2][:, :4].contiguous()
    elif bad == 'v2_if':
        args[2] = args[2][..., :-1].contiguous()
    elif bad == 'v2_edges':
        args[2] = args[2][:-1]
    elif bad == 'b3_shape':
        args[3] = args[3][:-1]
    elif bad == 'noncontig_v2':
        args[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        kp._check_fwd(*args)


@pytest.mark.parametrize('E,IF,O', [(1, 1, 64), (70, 20, 64), (4096, 64, 64),
                                    (4096, 1024, 64), (4096, 256, 128),
                                    (32768, 1024, 64), (1000, 896, 64)])
def test_i_splits_cover_IF(E, IF, O):
    """The i splits of the forward kernel and kernel B: none empty,
    together all of IF, no more
    CTAs than one per SM unless the edge tiles alone need more, and no
    split under SPLIT_MIN_I values of i unless IF is."""
    per = kp.i_per_split(E, IF, O)
    splits = -(-IF // per)
    assert 1 <= per <= IF
    assert (splits - 1) * per < IF <= splits * per
    tiles = -(-E // kp.EDGE_TILE) * (O // kp.O_TILE)
    assert splits * tiles <= max(tiles, kp.SPLIT_TARGET_CTAS)
    assert per >= min(IF, kp.SPLIT_MIN_I)
    assert splits > 1 or tiles * 2 > kp.SPLIT_TARGET_CTAS \
        or IF < 2 * kp.SPLIT_MIN_I
    # every split but a lone one starts on a 16-wide V2 chunk of the
    # forward kernel
    assert splits == 1 or per % kp.FWD_I_CHUNK == 0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('P,IF,e', [(1, 20, 64), (3, 35, 200), (5, 70, 1000),
                                    (7, 80, 77), (7, 1024, 4096),
                                    (3, 640, 4133)])
def test_cuda_fwd_kernel_matches_plain(cuda_card, P, IF, e, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() for a in _fwd_args(P, IF, e, dtype)]
    before = kp.fused_pairwise_conv.launches
    out = kp.fused_pairwise_conv(*args)
    torch.cuda.synchronize()
    assert kp.fused_pairwise_conv.launches == before + 1
    ref = kp.fused_pairwise_conv_plain(*args)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('P,IF,e', [(7, 1000, 4133), (7, 1001, 300),
                                    (1, 37, 64), (3, 24, 4096),
                                    (5, 1024, 4095)])
def test_cuda_fwd_tile_edges_match_plain_and_repeat(cuda_card, P, IF, e,
                                                    dtype):
    """The tile's edge cases: ragged E, IF not a multiple of the 16-wide i
    chunk (a partial chunk in the rotated walk; odd IF takes 4-byte V2
    copies), i splits, P = 7 and the two-CTA configurations (P = 1, bf16
    P = 3): within 1e-4 of max|plain| and the same bits on two runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() for a in _fwd_args(P, IF, e, dtype)]
    first = kp.fused_pairwise_conv(*args)
    second = kp.fused_pairwise_conv(*args)
    torch.cuda.synchronize()
    ref = kp.fused_pairwise_conv_plain(*args)
    assert (first - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_cuda_fwd_split_sums_are_bit_identical(cuda_card, dtype):
    """The i splits' partials are reduced in a fixed order: two runs agree
    bit for bit."""
    args = [a.cuda() for a in _fwd_args(7, 1024, 4096, dtype)]
    assert kp.i_per_split(4096, 1024, kp.O_TILE) < 1024
    first = kp.fused_pairwise_conv(*args)
    second = kp.fused_pairwise_conv(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('di,do,e,c,split', [
    (3, 3, 4096, 64, True),     # P 7, IF 448: the i range split in two
    (0, 0, 4096, 64, False),    # P 1, IF 64: one split
    (1, 2, 4133, 64, True),     # P 5, IF 192, ragged E (65 tiles)
    (2, 3, 4096, 64, True),     # P 7, IF 320
    (2, 1, 300, 5, False),      # P 3, IF 15: odd, 4-byte V2 copies
    (3, 3, 77, 3, False),       # P 7, IF 21: odd, one ragged tile
    (1, 1, 1000, 2, False),     # P 3, IF 6: even, not 16-byte V2 rows
    (3, 2, 4095, 30, True)])    # P 5, IF 150: split, 4-byte V2 copies
def test_cuda_backward_b_split_matches_plain_and_is_bit_identical(
        cuda_card, di, do, e, c, split, dtype):
    """Kernel B at even and odd IF, ragged E, every P, with and without its
    i range split: dH against the plain version, and the same bits from
    two runs (of every output of the backward)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() for a in _bwd_args(di, do, e, c=c, dtype=dtype)]
    IF = args[1].shape[1]
    assert (kp.i_per_split(e, IF) < IF) == split
    first = kp.fused_pairwise_conv_bwd(*args)
    second = kp.fused_pairwise_conv_bwd(*args)
    torch.cuda.synchronize()
    ref = kp.fused_pairwise_conv_bwd_b_plain(args[1], args[2], args[3])
    assert (first[0] - ref).abs().max() <= 1e-4 * ref.abs().max()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------- #
# the fused attention (kernels/attention.py)
# ---------------------------------------------------------------------- #
from se3_transformer_torch.kernels import attention as ka  # noqa: E402
from se3_transformer_torch.kernels import flash as kf  # noqa: E402


def _attn_args(BH=4, BKV=2, n=10, J=5, D=6, heads=2, masked=True,
               full_row=True, seed=6):
    """q, k, v, mask, g, heads, scale; with `full_row` one row of the
    mask is all False (the uniform-average case)."""
    rng = np.random.RandomState(seed)
    t = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((BH, n, D), (BKV, n, J, D), (BKV, n, J, D), (BH, n, D))]
    mask = None
    if masked:
        m = rng.rand(BH // heads, n, J) > 0.3
        if full_row:
            m[0, min(3, n - 1)] = False
        mask = torch.from_numpy(m)
    return t[0], t[1], t[2], mask, t[3], heads, D ** -0.5


def test_cpu_attention_never_counts_a_launch():
    q, k, v, mask, g, heads, scale = _attn_args()
    before = (ka.fused_attention_fwd.launches, ka.fused_attention_bwd.launches)
    out = ka.fused_attention_fwd(q, k, v, mask, heads, scale)
    dq, dk, dv = ka.fused_attention_bwd(q, k, v, mask, g, heads, scale)
    assert out.shape == q.shape and dq.shape == q.shape
    assert dk.shape == k.shape and dv.shape == v.shape
    assert (ka.fused_attention_fwd.launches,
            ka.fused_attention_bwd.launches) == before


@pytest.mark.parametrize('bad', ['dtype', 'slots', 'features', 'mask_shape',
                                 'mask_dtype', 'group', 'noncontig', 'g'])
def test_attention_wrapper_rejects_what_the_kernels_do_not_take(bad):
    q, k, v, mask, g, heads, scale = _attn_args()
    assert ka._check(q, k, v, mask, heads, g=g) == (4, 2, 10, 5, 6)
    if bad == 'dtype':
        q = q.double()
    elif bad == 'slots':
        J = ka.MAX_SLOTS + 1
        k = torch.zeros(2, 10, J, 6)
        v = torch.zeros(2, 10, J, 6)
        mask = torch.ones(2, 10, J, dtype=torch.bool)
    elif bad == 'features':
        D = ka.MAX_FEATURES + 1
        q, g = torch.zeros(4, 10, D), torch.zeros(4, 10, D)
        k, v = torch.zeros(2, 10, 5, D), torch.zeros(2, 10, 5, D)
    elif bad == 'mask_shape':
        mask = mask[:, :, :-1].contiguous()
    elif bad == 'mask_dtype':
        mask = mask.to(torch.uint8)
    elif bad == 'group':
        k, v = k[:1].repeat(3, 1, 1, 1), v[:1].repeat(3, 1, 1, 1)
    elif bad == 'noncontig':
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == 'g':
        g = g[:, :-1]
    with pytest.raises((TypeError, ValueError)):
        ka._check(q, k, v, mask, heads, g=g)


def _check_attention_kernels(q, k, v, mask, g, heads, scale):
    """Forward and backward kernels against their plain versions within
    1e-5 of max|plain|, each launched and counted, and the backward the
    same bits on two runs."""
    before = (ka.fused_attention_fwd.launches, ka.fused_attention_bwd.launches)
    out = ka.fused_attention_fwd(q, k, v, mask, heads, scale)
    grads = ka.fused_attention_bwd(q, k, v, mask, g, heads, scale)
    again = ka.fused_attention_bwd(q, k, v, mask, g, heads, scale)
    torch.cuda.synchronize()
    assert (ka.fused_attention_fwd.launches,
            ka.fused_attention_bwd.launches) == (before[0] + 1, before[1] + 2)
    ref = ka.fused_attention_plain(q, k, v, mask, heads, scale)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    refs = ka.fused_attention_bwd_plain(q, k, v, mask, g, heads, scale)
    for name, got, want, rerun in zip(('dq', 'dk', 'dv'), grads, refs, again):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), name
        assert torch.equal(got, rerun), name


# kernels #5 and #6: the compiled widths D = 8, 24, 40, 56 (staged by bulk
# copies) and runtime ones (6, 12, 256: read from device memory), J = 1 ..
# 128, n off any CTA's rows, groups 1 .. 16 (past 8 the query heads go in
# passes, from device memory), masks with a fully masked row, and the
# limits J = 128, D = 256
ATTENTION_CASES = [
    (4, 2, 10, 5, 6, 2, True), (8, 8, 1024, 33, 56, 8, True),
    (8, 8, 1000, 33, 8, 8, False), (6, 3, 77, 40, 24, 3, True),
    (2, 1, 33, 128, 256, 2, True),
    (8, 8, 1024, 33, 8, 8, True), (8, 8, 1024, 33, 24, 8, True),
    (8, 8, 1024, 33, 40, 8, True), (3, 3, 77, 1, 8, 3, True),
    (6, 2, 1000, 33, 40, 6, True), (8, 1, 77, 33, 56, 8, True),
    (8, 1, 77, 33, 56, 8, False), (16, 1, 50, 20, 8, 16, True),
    (4, 4, 100, 128, 56, 4, True), (4, 4, 1000, 40, 12, 2, True),
    (2, 2, 64, 128, 256, 2, False), (8, 1, 1000, 33, 6, 8, True)]


@pytest.mark.cuda
@pytest.mark.parametrize('BH,BKV,n,J,D,heads,masked', ATTENTION_CASES)
def test_cuda_attention_kernels_match_plain(cuda_card, BH, BKV, n, J, D,
                                            heads, masked):
    """Forward and backward kernels against their plain versions (see
    ATTENTION_CASES), and the backward's group sums the same bits on two
    runs."""
    args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in
            _attn_args(BH, BKV, n, J, D, heads, masked)]
    _check_attention_kernels(*args)


@pytest.mark.cuda
@pytest.mark.parametrize('D', [8, 24])
def test_cuda_attention_kernels_take_misaligned_operands(cuda_card, D):
    """Operands 4 bytes off a 16-byte boundary (contiguous views at an odd
    storage offset) cannot be staged by bulk copies: the kernels read them
    from device memory, and still match."""
    q, k, v, mask, g, heads, scale = _attn_args(8, 4, 300, 33, D, 4, True)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device='cuda')
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out
    _check_attention_kernels(shifted(q), shifted(k), shifted(v), mask.cuda(),
                             shifted(g), heads, scale)


# ---------------------------------------------------------------------- #
# the streaming kNN attention (kernels/flash.py)
# ---------------------------------------------------------------------- #
def _flash_case(d_out=2, n=13, K=6, prefix=1, masked=True, h_dtype=torch.float32,
                pairs=((0, 5), (1, 3), (2, 4), (3, 2)), heads=8, seed=7,
                w_scale=None):
    """(cfg, ops) at the kernel's widths (mid 128, O 64), with one node's
    neighbors all masked; W3 drawn at w_scale (default mid^-1/2)."""
    rng = np.random.RandomState(seed)
    P = 2 * d_out + 1
    dim_head = kf.O_WIDTH // heads
    Dh = dim_head * P
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in pairs)
    w_scale = kf.MID ** -0.5 if w_scale is None else w_scale

    def f32(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32))
    rel = f32(1, n, K, 3)
    ops = dict(q=f32(1, n, heads, Dh),
               xs=tuple(f32(1, n, c, 2 * d + 1) for d, c in pairs),
               idx=torch.from_numpy(rng.randint(0, n, (1, n, K))),
               nmask=None, h_v=f32(1, n, K, kf.MID).to(h_dtype),
               h_k=f32(1, n, K, kf.MID).to(h_dtype),
               wv=f32(kf.MID, IF, kf.O_WIDTH, scale=w_scale),
               wk=f32(kf.MID, IF, kf.O_WIDTH, scale=w_scale),
               bv=f32(IF, kf.O_WIDTH, scale=0.1),
               bk=f32(IF, kf.O_WIDTH, scale=0.1),
               sh=kf.flash_sh_payload(rel, 3), prefix_k=None, prefix_v=None)
    if masked:
        m = rng.rand(1, n, K) > 0.3
        m[0, 2] = False
        ops['nmask'] = torch.from_numpy(m)
    if prefix:
        ops['prefix_k'] = f32(1, n, prefix, heads * Dh)
        ops['prefix_v'] = f32(1, n, prefix, heads * Dh)
    cfg = kf.FlashConfig(pairs=pairs, d_out=d_out, heads=heads,
                         kv_heads=heads, scale=dim_head ** -0.5,
                         prefix=prefix)
    return cfg, ops


def test_cpu_flash_never_counts_a_launch():
    cfg, ops = _flash_case()
    before = kf.flash_attention_fwd.launches
    out = kf.flash_attention_fwd(cfg, ops)
    assert out.shape == ops['q'].shape and out.dtype == torch.float32
    assert kf.flash_attention_fwd.launches == before


@pytest.mark.parametrize('bad', ['q_dtype', 'kv_heads', 'slots', 'x_shape',
                                 'idx_dtype', 'h_dtype', 'w_shape', 'sh',
                                 'prefix', 'noncontig', 'degree'])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad):
    cfg, ops = _flash_case()
    assert kf._check(cfg, ops)[:5] == (1, 13, 6, 49, 1)
    if bad == 'q_dtype':
        ops['q'] = ops['q'].double()
    elif bad == 'kv_heads':
        cfg = cfg._replace(kv_heads=4)
    elif bad == 'slots':
        K = kf.MAX_SLOTS + 1
        ops['idx'] = torch.zeros(1, 13, K, dtype=torch.int64)
    elif bad == 'x_shape':
        ops['xs'] = ops['xs'][:3] + (ops['xs'][3][..., :-1].contiguous(),)
    elif bad == 'idx_dtype':
        ops['idx'] = ops['idx'].int()
    elif bad == 'h_dtype':
        ops['h_k'] = ops['h_k'].to(torch.bfloat16)
    elif bad == 'w_shape':
        ops['wk'] = ops['wk'][:, :-1].contiguous()
    elif bad == 'sh':
        ops['sh'] = ops['sh'][..., :16].contiguous()
    elif bad == 'prefix':
        cfg = cfg._replace(prefix=kf.MAX_PREFIX + 1)
    elif bad == 'noncontig':
        ops['q'] = ops['q'].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == 'degree':
        cfg = cfg._replace(d_out=4)
    with pytest.raises((TypeError, ValueError)):
        kf._check(cfg, ops)


# the flagship's widths: 64 channels in each of degrees 0-3
FLAGSHIP_PAIRS = tuple((d, 64) for d in range(4))


@pytest.mark.cuda
@pytest.mark.parametrize('h_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('d_out,n,K,prefix,masked,wide', [
    (0, 13, 6, 1, True, False), (1, 40, 32, 1, True, False),
    (2, 13, 6, 0, True, False), (3, 33, 32, 2, False, False),
    (3, 7, 16, 1, True, False), (0, 40, 32, 1, True, True),
    (1, 40, 32, 1, True, True), (2, 37, 30, 0, True, True),
    (3, 40, 32, 1, True, True)])
def test_cuda_flash_kernel_matches_plain(cuda_card, h_dtype, d_out, n, K,
                                         prefix, masked, wide):
    """The kernel against its plain version, at small widths and at the
    flagship's (64 channels per degree, W3 scaled to keep k and v O(1)),
    and the same bits from a repeated launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pairs = FLAGSHIP_PAIRS if wide else ((0, 5), (1, 3), (2, 4), (3, 2))
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in pairs)
    cfg, ops = _flash_case(d_out, n, K, prefix, masked, h_dtype, pairs=pairs,
                           w_scale=(kf.MID * IF) ** -0.5 if wide else None)
    ops = {k: (tuple(x.cuda() for x in v) if k == 'xs' else
               None if v is None else v.cuda()) for k, v in ops.items()}
    before = kf.flash_attention_fwd.launches
    out = kf.flash_attention_fwd(cfg, ops)
    again = kf.flash_attention_fwd(cfg, ops)
    torch.cuda.synchronize()
    assert kf.flash_attention_fwd.launches == before + 2
    assert torch.equal(out, again)
    # the kernel and the plain version sum the same float32 products in
    # other orders; the scores (O(10) here) carry their ~1e-6 relative
    # differences through the softmax's exponent, as in the other kernels'
    # 1e-4 bound
    ref = kf.flash_attention_plain(cfg, ops)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


def _tied(cfg, ops, names=('h_k', 'wk', 'bk')):
    """A case with its keys tied to its values: no key operands."""
    return cfg._replace(tie=True), dict(ops, **{k: None for k in names})


def test_flash_check_takes_tied_operands_only_with_tie():
    """The wrapper's check takes a tied call without h_k, wk and bk, and
    refuses key operands beside tie or a missing wk without it."""
    cfg, ops = _flash_case()
    tcfg, tops = _tied(cfg, ops)
    assert kf._check(tcfg, tops)[:5] == (1, 13, 6, 49, 1)
    for bad_cfg, bad_ops in ((tcfg, dict(tops, wk=ops['wk'])),
                             (tcfg, dict(tops, h_k=ops['h_k'])),
                             (cfg, dict(ops, wk=None))):
        with pytest.raises(ValueError, match='tied'):
            kf._check(bad_cfg, bad_ops)


@pytest.mark.cuda
@pytest.mark.parametrize('h_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('d_out,n,K,prefix,masked,wide', [
    (0, 13, 6, 1, True, False), (2, 37, 30, 0, True, True),
    (3, 33, 32, 2, False, False), (0, 1024, 32, 2, True, True),
    (1, 1024, 32, 2, True, True), (2, 1024, 32, 2, True, True),
    (3, 1024, 32, 2, True, True)])
def test_cuda_flash_tie_kernel_matches_plain(cuda_card, h_dtype, d_out, n, K,
                                             prefix, masked, wide):
    """Kernel #7's tied variant (one conv pass, its tile read as k and as
    v) against the tied plain stream, at ragged shapes and at
    flagship_fast's (n 1024, K 32, the [null, self] prefix, 64 channels a
    degree), and the same bits from a repeated launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pairs = FLAGSHIP_PAIRS if wide else ((0, 5), (1, 3), (2, 4), (3, 2))
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in pairs)
    cfg, ops = _tied(*_flash_case(
        d_out, n, K, prefix, masked, h_dtype, pairs=pairs,
        w_scale=(kf.MID * IF) ** -0.5 if wide else None))
    ops = {k: (tuple(x.cuda() for x in v) if k == 'xs' else
               None if v is None else v.cuda()) for k, v in ops.items()}
    before = kf.flash_attention_fwd.launches
    out = kf.flash_attention_fwd(cfg, ops)
    again = kf.flash_attention_fwd(cfg, ops)
    torch.cuda.synchronize()
    assert kf.flash_attention_fwd.launches == before + 2
    assert torch.equal(out, again)
    ref = kf.flash_attention_plain(cfg, ops)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


# ---------------------------------------------------------------------- #
# kernel #2: the basis-fused forward with the structured basis
# ---------------------------------------------------------------------- #
def _bx_args(di=1, do=2, e=96, dtype=torch.bfloat16, c=5):
    """Kernel #1's operands with the basis in get_basis's [E, P, Q, F]
    layout, and the same basis flat, for the bxf yardstick."""
    args = _kernel_args(di, do, e, dtype, c)
    P, Q, F = args[4]
    structured = args[2].reshape(e, P, F, Q).transpose(2, 3).contiguous()
    return [args[0], args[1], structured, args[3], args[5]], args


def test_cpu_bx_never_counts_a_launch():
    args, flat = _bx_args(e=70)
    before = kp.fused_pairwise_conv_bx.launches
    out = kp.fused_pairwise_conv_bx(*args)
    assert kp.fused_pairwise_conv_bx.launches == before
    assert torch.equal(out, kp.fused_pairwise_conv_bxf(*flat))


@pytest.mark.parametrize('bad', ['basis_ndim', 'basis_dtype', 'basis_pqf',
                                 'basis_rows', 'noncontig', 'o_tile'])
def test_bx_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args, _ = _bx_args()
    E_, C_ = args[0].shape[0], args[3].shape[1]
    assert kp._check_bx(*args) == (E_, C_, kp.O_TILE, (5, 3, 3))
    if bad == 'basis_ndim':
        args[2] = args[2].reshape(args[2].shape[0], -1)
    elif bad == 'basis_dtype':
        args[2] = args[2].double()
    elif bad == 'basis_pqf':
        args[2] = args[2][:, :, :, :1].contiguous()
    elif bad == 'basis_rows':
        args[2] = args[2][:-1]
    elif bad == 'noncontig':
        args[2] = args[2].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == 'o_tile':
        args[1] = args[1][..., :32].contiguous()
        args[4] = args[4][:, :32].contiguous()
    with pytest.raises((TypeError, ValueError)):
        kp._check_bx(*args)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('di,do,e,c', BXF_CASES)
def test_cuda_bx_kernel_matches_plain_and_bxf(cuda_card, di, do, e, c, dtype):
    """Kernel #2 against its plain version, and against kernel #1 on the
    same basis flattened: the one tile with two indexings, bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args, flat = _bx_args(di, do, e, dtype, c)
    args = [a.cuda() for a in args]
    flat = [a.cuda() if isinstance(a, torch.Tensor) else a for a in flat]
    before = kp.fused_pairwise_conv_bx.launches
    out = kp.fused_pairwise_conv_bx(*args)
    torch.cuda.synchronize()
    assert kp.fused_pairwise_conv_bx.launches == before + 1
    ref = kp.fused_pairwise_conv_bx_plain(*args)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(out, kp.fused_pairwise_conv_bxf(*flat))


# ---------------------------------------------------------------------- #
# kernel 7g: the global attention
# ---------------------------------------------------------------------- #
def _global_case(d_out=1, n=37, prefix=2, masked=True, heads=2,
                 exclude_self=True, pairs=((0, 8), (1, 8)), seed=5):
    """Operands at the global kernel's widths (mid 128, kv_heads *
    dim_head = 16), random-walk coordinates with the last 5 nodes padded
    at the origin, weights scaled to keep k and v O(1)."""
    rng = np.random.RandomState(seed)
    mid, O, P = kf.MID, kf.GLOBAL_O_WIDTH, 2 * d_out + 1
    dim_head = O // heads
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in pairs)

    def f(*shape, s=1.0):
        return torch.from_numpy((rng.normal(size=shape) * s)
                                .astype(np.float32))

    def trunk():
        return (f(1, mid), f(1, mid, s=0.1), 1 + f(1, mid, s=0.1),
                f(1, mid, s=0.1), f(mid, mid, s=mid ** -0.5),
                f(1, mid, s=0.1), 1 + f(1, mid, s=0.1), f(1, mid, s=0.1))
    coords = torch.cumsum(f(1, n, 3), dim=1)
    coords[:, n - 5:] = 0.
    w = (mid * IF) ** -0.5
    ops = dict(q=f(1, n, heads, dim_head * P),
               xs=tuple(f(1, n, c, 2 * d + 1) for d, c in pairs),
               coords=coords, rp_v=trunk(), rp_k=trunk(),
               wv=f(mid, IF, O, s=w), bv=f(IF, O, s=0.1),
               wk=f(mid, IF, O, s=w), bk=f(IF, O, s=0.1),
               node_mask=torch.arange(n)[None] < n - 5 if masked else None,
               prefix_k=f(1, n, prefix, O * P) if prefix else None,
               prefix_v=f(1, n, prefix, O * P) if prefix else None)
    cfg = kf.FlashConfig(pairs=pairs, d_out=d_out, heads=heads,
                         kv_heads=heads, scale=dim_head ** -0.5,
                         prefix=prefix, mode='global',
                         exclude_self=exclude_self)
    return cfg, ops


def test_cpu_flash_global_never_counts_a_launch():
    cfg, ops = _global_case()
    before = kf.flash_global_attention_fwd.launches
    out = kf.flash_global_attention_fwd(cfg, ops)
    assert out.shape == ops['q'].shape and torch.isfinite(out).all()
    assert kf.flash_global_attention_fwd.launches == before


@pytest.mark.parametrize('bad', ['q_dtype', 'kv_heads', 'width', 'x_shape',
                                 'coords', 'rp', 'w_shape', 'mask_dtype',
                                 'prefix', 'noncontig', 'degree', 'pif',
                                 'mode'])
def test_flash_global_wrapper_rejects_what_the_kernel_does_not_take(bad):
    cfg, ops = _global_case()
    assert kf._check_global(cfg, ops) == (1, 37, 2, 32)
    if bad == 'q_dtype':
        ops['q'] = ops['q'].double()
    elif bad == 'kv_heads':
        cfg = cfg._replace(kv_heads=1)
    elif bad == 'width':
        ops['q'] = torch.zeros(1, 37, 2, 48)
    elif bad == 'x_shape':
        ops['xs'] = (ops['xs'][0], ops['xs'][1][..., :-1].contiguous())
    elif bad == 'coords':
        ops['coords'] = ops['coords'][..., :2].contiguous()
    elif bad == 'rp':
        ops['rp_k'] = ops['rp_k'][:4] + (ops['rp_k'][4][:64],) \
            + ops['rp_k'][5:]
    elif bad == 'w_shape':
        ops['wk'] = ops['wk'][:, :-1].contiguous()
    elif bad == 'mask_dtype':
        ops['node_mask'] = ops['node_mask'].float()
    elif bad == 'prefix':
        cfg = cfg._replace(prefix=kf.MAX_PREFIX + 1)
    elif bad == 'noncontig':
        ops['q'] = ops['q'].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == 'degree':
        cfg = cfg._replace(d_out=4)
    elif bad == 'pif':
        cfg, ops = _global_case(pairs=((0, 8), (1, 48)))
    elif bad == 'mode':
        cfg = cfg._replace(mode='knn')
    with pytest.raises((TypeError, ValueError)):
        kf._check_global(cfg, ops)


@pytest.mark.cuda
@pytest.mark.parametrize('case', [
    dict(d_out=0), dict(d_out=1), dict(d_out=1, n=100, prefix=0),
    dict(d_out=1, masked=False, exclude_self=False, heads=4),
    dict(d_out=2, n=21, pairs=((0, 4), (1, 4), (2, 4)), prefix=1),
    dict(d_out=3, n=19, pairs=((3, 2), (1, 3)), heads=1),
    # n not a multiple of the tile (8 query x 16 kv nodes) on either axis
    dict(d_out=0, n=203), dict(d_out=1, n=131, prefix=1),
    # P * IF = 256 (the 64-pair tile), P = 7, 16 heads of width 1
    dict(d_out=0, n=70, pairs=((0, 128), (1, 128))),
    dict(d_out=3, n=45, pairs=((3, 3), (1, 4)), heads=2),
    dict(d_out=1, n=50, heads=16)])
def test_cuda_flash_global_kernel_matches_plain(cuda_card, case):
    """The kernel's online softmax over kv blocks of 16 (the last one
    ragged) against the plain stream's row softmax: float32 products as
    three bf16 passes, in other orders; the same bits on a repeat."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ops = _global_case(**case)
    ops = {k: (tuple(x.cuda() for x in v) if isinstance(v, tuple) else
               None if v is None else v.cuda()) for k, v in ops.items()}
    before = kf.flash_global_attention_fwd.launches
    out = kf.flash_global_attention_fwd(cfg, ops)
    again = kf.flash_global_attention_fwd(cfg, ops)
    torch.cuda.synchronize()
    assert kf.flash_global_attention_fwd.launches == before + 2
    assert torch.equal(out, again)
    ref = kf.flash_global_plain(cfg, ops)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_flash_global_check_takes_tied_operands_only_with_tie():
    """The global wrapper's check takes a tied call without rp_k, wk and
    bk, and refuses key operands beside tie."""
    cfg, ops = _global_case()
    tcfg, tops = _tied(cfg, ops, ('wk', 'bk'))
    tops['rp_k'] = ()
    assert kf._check_global(tcfg, tops) == (1, 37, 2, 32)
    for bad in (dict(tops, wk=ops['wk']), dict(tops, rp_k=ops['rp_k'])):
        with pytest.raises(ValueError, match='tied'):
            kf._check_global(tcfg, bad)


@pytest.mark.cuda
@pytest.mark.parametrize('case', [
    dict(d_out=0), dict(d_out=1, n=131, prefix=1),
    dict(d_out=3, n=19, pairs=((3, 2), (1, 3)), heads=1),
    dict(d_out=0, n=70, pairs=((0, 128), (1, 128))),
    dict(d_out=0, n=4096), dict(d_out=1, n=4096)])
def test_cuda_flash_global_tie_kernel_matches_plain(cuda_card, case):
    """Kernel 7g's tied variant (one trunk and one radial product a tile)
    against the tied plain stream, at ragged shapes, the 64-pair tile and
    the assembly model's bucket (n 4096), and the same bits on a
    repeat."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ops = _tied(*_global_case(**case), ('wk', 'bk'))
    ops['rp_k'] = ()
    ops = {k: (tuple(x.cuda() for x in v) if isinstance(v, tuple) else
               None if v is None else v.cuda()) for k, v in ops.items()}
    before = kf.flash_global_attention_fwd.launches
    out = kf.flash_global_attention_fwd(cfg, ops)
    again = kf.flash_global_attention_fwd(cfg, ops)
    torch.cuda.synchronize()
    assert kf.flash_global_attention_fwd.launches == before + 2
    assert torch.equal(out, again)
    ref = kf.flash_global_plain(cfg, ops)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


# ---------------------------------------------------------------------- #
# the so2 arm of #7 and 7g (conv_backend='so2')
# ---------------------------------------------------------------------- #
from se3_transformer_torch.so2.frames import edge_frames  # noqa: E402


def _so2(cfg, ops, seed=9, degree=3):
    """A kNN (cfg, ops) on the so2 arm: the packed frames of random
    offsets (slot 0 on the +z pole, slot 1 at zero length) in place of
    the SH stack."""
    rng = np.random.RandomState(seed)
    B, n, K = ops['idx'].shape
    rel = rng.normal(size=(B, n, K, 3)).astype(np.float32)
    rel[:, :, 0] = [0., 0., 1.2]
    rel[:, :, 1:2] = 0.
    fr = kf.pack_frames(edge_frames(torch.from_numpy(rel), degree))
    return cfg._replace(arm_v='so2', arm_k='so2'), \
        dict(ops, sh=None, fr=fr.contiguous())


def _on_card(ops):
    return {k: (tuple(x.cuda() for x in v) if isinstance(v, tuple) else
                None if v is None else v.cuda()) for k, v in ops.items()}


def test_cpu_flash_so2_never_counts_a_launch():
    cfg, ops = _so2(*_flash_case())
    before = (kf.flash_attention_fwd.launches,
              kf.flash_attention_fwd.so2_launches)
    out = kf.flash_attention_fwd(cfg, ops)
    assert out.shape == ops['q'].shape and torch.isfinite(out).all()
    assert (kf.flash_attention_fwd.launches,
            kf.flash_attention_fwd.so2_launches) == before


def test_flash_check_takes_so2_frames():
    """The wrapper's check takes the packed frames (S = 4 L1) on the so2
    arm, and refuses frames narrower than the degrees and mixed arms."""
    cfg, ops = _so2(*_flash_case())
    assert kf._check(cfg, ops)[3] == 16
    _, narrow = _so2(cfg, ops, degree=2)
    with pytest.raises(ValueError, match='fr must be'):
        kf._check(cfg, narrow)
    with pytest.raises(ValueError, match='mixed contraction arms'):
        kf._check(cfg._replace(arm_k='dense'), dict(ops, sh=ops['fr']))


@pytest.mark.cuda
@pytest.mark.parametrize('h_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('d_out,n,K,prefix,masked,wide,tie', [
    (0, 13, 6, 1, True, False, False), (1, 40, 32, 2, True, False, False),
    (2, 13, 6, 0, True, False, True), (3, 33, 32, 2, False, False, False),
    (0, 40, 32, 1, True, True, False), (1, 40, 32, 2, True, True, True),
    (2, 37, 30, 0, True, True, False), (3, 40, 32, 2, True, True, False)])
def test_cuda_flash_so2_kernel_matches_plain(cuda_card, h_dtype, d_out, n, K,
                                             prefix, masked, wide, tie):
    """Kernel #7's so2 arm (tied and untied) against the so2 plain stream,
    at small widths and at the flagship's, each counted in .launches and
    .so2_launches, and the same bits from a repeated launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pairs = FLAGSHIP_PAIRS if wide else ((0, 5), (1, 3), (2, 4), (3, 2))
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in pairs)
    cfg, ops = _so2(*_flash_case(
        d_out, n, K, prefix, masked, h_dtype, pairs=pairs,
        w_scale=(kf.MID * IF) ** -0.5 if wide else None))
    if tie:
        cfg, ops = _tied(cfg, ops)
    ops = _on_card(ops)
    before = (kf.flash_attention_fwd.launches,
              kf.flash_attention_fwd.so2_launches)
    out = kf.flash_attention_fwd(cfg, ops)
    again = kf.flash_attention_fwd(cfg, ops)
    torch.cuda.synchronize()
    assert (kf.flash_attention_fwd.launches,
            kf.flash_attention_fwd.so2_launches) == (before[0] + 2,
                                                     before[1] + 2)
    assert torch.equal(out, again)
    ref = kf.flash_attention_plain(cfg, ops)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_cpu_flash_global_so2_never_counts_a_launch():
    cfg, ops = _global_case()
    cfg = cfg._replace(arm_v='so2', arm_k='so2')
    before = (kf.flash_global_attention_fwd.launches,
              kf.flash_global_attention_fwd.so2_launches)
    out = kf.flash_global_attention_fwd(cfg, ops)
    assert out.shape == ops['q'].shape and torch.isfinite(out).all()
    assert (kf.flash_global_attention_fwd.launches,
            kf.flash_global_attention_fwd.so2_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize('tie', [False, True])
@pytest.mark.parametrize('case', [
    dict(d_out=0), dict(d_out=1), dict(d_out=1, n=131, prefix=1),
    dict(d_out=1, masked=False, exclude_self=False, heads=4),
    dict(d_out=2, n=21, pairs=((0, 4), (1, 4), (2, 4)), prefix=1),
    dict(d_out=3, n=45, pairs=((3, 3), (1, 4)), heads=2),
    dict(d_out=0, n=70, pairs=((0, 128), (1, 128)))])
def test_cuda_flash_global_so2_kernel_matches_plain(cuda_card, case, tie):
    """Kernel 7g's so2 arm (frames from the in-tile offsets; the padded
    nodes' pairs and, without exclude_self, the diagonal at zero length)
    against the so2 plain stream, tied and untied, ragged tiles, the
    64-pair tile and P = 7; counted in .so2_launches; the same bits on a
    repeat."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ops = _global_case(**case)
    cfg = cfg._replace(arm_v='so2', arm_k='so2')
    if tie:
        cfg, ops = _tied(cfg, ops, ('wk', 'bk'))
        ops['rp_k'] = ()
    ops = _on_card(ops)
    before = kf.flash_global_attention_fwd.so2_launches
    out = kf.flash_global_attention_fwd(cfg, ops)
    again = kf.flash_global_attention_fwd(cfg, ops)
    torch.cuda.synchronize()
    assert kf.flash_global_attention_fwd.so2_launches == before + 2
    assert torch.equal(out, again)
    ref = kf.flash_global_plain(cfg, ops)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


# ---------------------------------------------------------------------- #
# the fits predicates: at, just inside and just past every limit
# ---------------------------------------------------------------------- #
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize('kernel', ['bxf', 'bx', 'fwd', 'bwd'])
@pytest.mark.parametrize('widths,fits', [
    (dict(), True),
    (dict(dtype=BF16), True), (dict(dtype=torch.float16), False),
    (dict(mid=127), False), (dict(mid=129), False),
    (dict(mid=32, P=2), None), (dict(mid=32), False),
    (dict(O=63), False), (dict(O=65), False), (dict(O=0), False),
    (dict(P=7), True), (dict(P=9), False), (dict(P=2), None),
    (dict(Q=7), True), (dict(Q=9), None)])
def test_pairwise_fits_at_each_limit(kernel, widths, fits):
    """mid = 128, O a multiple of 64, P and Q in (1, 3, 5, 7), h in bf16 or
    float32; Q is read by the basis-fused kernels only, and #3, A and B
    also take P = 2, and mid = 32 with P 1 or 2 (their V2 arms; fits None:
    True for 'fwd' and 'bwd' only)."""
    args = dict(dict(mid=128, O=64, P=3, Q=5, dtype=F32), **widths)
    if fits is None:
        fits = kernel in ('fwd', 'bwd')
    limit = kp.pairwise_limit(kernel, **args)
    assert (limit is None) is fits
    if not fits:
        assert 'exceeds' in limit


@pytest.mark.parametrize('kernel,fits', [('bxf', True), ('bx', True),
                                         ('fwd', True), ('bwd', True)])
def test_pairwise_fits_wider_o_in_the_forwards_only(kernel, fits):
    """O = 128 is two O tiles of the forwards and, now that they take any
    multiple of 64, of kernels A and B too."""
    assert (kp.pairwise_limit(kernel, 128, 128, 3, 3, F32) is None) is fits


@pytest.mark.parametrize('O,P,ok', [(64, 7, True), (128, 1, True),
                                    (32, 3, True), (24, 3, False),
                                    (64, 9, False)])
def test_pairwise_checks_follow_the_predicates(O, P, ok):
    """The forward wrapper's check raises exactly where pairwise_limit
    finds a limit, and raises that limit's text."""
    rng = np.random.RandomState(0)
    h = torch.from_numpy(rng.normal(size=(5, kp.MID)).astype(np.float32))
    w3 = torch.zeros(kp.MID, 12, O)
    v2, b3 = torch.zeros(5, P, 12), torch.zeros(12, O)
    limit = kp.pairwise_limit('fwd', kp.MID, O, P)
    assert (limit is None) is ok
    if ok:
        assert kp._check_fwd(h, w3, v2, b3) == (5, 12, O, P)
    else:
        with pytest.raises(ValueError, match=limit.split(' exceeds')[0]):
            kp._check_fwd(h, w3, v2, b3)


@pytest.mark.parametrize('kernel,O,kw,fits', [
    ('fwd', 8, dict(), True), ('fwd', 16, dict(), True),
    ('fwd', 32, dict(), True), ('bwd', 8, dict(), True),
    ('bwd', 16, dict(), True), ('bwd', 32, dict(dtype=BF16), True),
    ('fwd', 8, dict(dtype=BF16), True),
    ('fwd', 24, dict(), False), ('bwd', 48, dict(), False),
    ('fwd', 4, dict(), False), ('bxf', 8, dict(), False),
    ('bx', 32, dict(), False),
    ('fwd', 16, dict(scaled=True), False),
    ('fwd', 16, dict(operand_dtype=BF16), False),
    ('bwd', 32, dict(operand_dtype=BF16), False)])
def test_pairwise_fits_narrow_o(kernel, O, kw, fits):
    """#3, A and B take O = 8, 16 and 32 (their narrow arms) with float32
    V2 and a float w3, h in either dtype; #1 and #2, the scaled arm and the
    conv_bf16 arms refuse a narrow O, and the message names the arm."""
    limit = kp.pairwise_limit(kernel, 128, O, 3, 3, **kw)
    assert (limit is None) is fits
    if not fits:
        assert limit.startswith(f'O = {O} ')
        if kw.get('scaled'):
            assert 'scaled arm' in limit
        elif kw.get('operand_dtype') is BF16:
            assert 'conv_bf16' in limit


@pytest.mark.parametrize('O,tile,slots', [(8, 16, 1), (16, 16, 1),
                                          (32, 32, 1), (64, 64, 1),
                                          (192, 64, 3)])
def test_the_o_tile_follows_from_o(O, tile, slots):
    """The narrow arms' tile is 16 (O = 8, 16) or 32; the wide tiles' 64
    otherwise. The splits of #3/B and of A take the call's tile: a narrow O
    is one tile. A DenoiseConfig micro-batch (E = 96 x 8 edges: 12 tiles;
    IF 8 or 24) splits i into whole 4-value chunks, as many as fill the
    card; af2's 192 tiles fill it unsplit; A gives every edge split a
    tile."""
    assert (kp.o_tile(O), kp.o_slots(O)) == (tile, slots)
    if O in kp.NARROW_O:
        for IF in (8, 24):
            per = kp.i_per_split(768, IF, O)
            assert per == kp.NARROW_I_CHUNK
            assert 12 * -(-IF // per) <= kp.SPLIT_TARGET_CTAS
            splits = kp.bwd_splits(768, IF, O)
            per = -(-12 // splits)
            assert 1 <= splits <= 12 and -(-12 // per) == splits
        assert kp.i_per_split(12288, 96, O) == 96


def test_cpu_narrow_o_takes_the_plain_versions():
    """A narrow O on the CPU runs the plain versions and counts nothing."""
    h, _, v2, _ = _fwd_args(P=3, IF=24, e=70, dtype=torch.float32)
    rng = np.random.RandomState(9)
    w3 = torch.from_numpy(rng.normal(size=(kp.MID, 24, 8)).astype(np.float32))
    b3 = torch.from_numpy(rng.normal(size=(24, 8)).astype(np.float32))
    before = (kp.fused_pairwise_conv.launches,
              kp.fused_pairwise_conv_bwd.launches_a)
    out = kp.fused_pairwise_conv(h, w3, v2, b3)
    assert torch.equal(out, kp.fused_pairwise_conv_plain(h, w3, v2, b3))
    g = torch.from_numpy(rng.normal(size=(70, 3, 8)).astype(np.float32))
    grads = kp.fused_pairwise_conv_bwd(h, w3, v2, g, b3)
    for got, ref in zip(grads, kp.fused_pairwise_conv_bwd_plain(h, w3, v2, g,
                                                                b3)):
        assert torch.equal(got, ref)
    assert (kp.fused_pairwise_conv.launches,
            kp.fused_pairwise_conv_bwd.launches_a) == before


# the narrow arms on the card: the DenoiseConfig widths (O 8 and 16, C 8:
# IF 8 and 24), af2's O = 32 pairs (C 32), ragged E, odd IF, i and edge
# splits
NARROW_CASES = [(0, 0, 768, 8, 8), (1, 1, 768, 8, 16), (0, 1, 768, 8, 16),
                (1, 0, 770, 8, 8), (0, 0, 4096, 32, 32), (1, 1, 32768, 32, 32),
                (2, 3, 200, 5, 32), (3, 3, 77, 3, 16), (1, 1, 4133, 64, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('di,do,e,c,o', NARROW_CASES)
def test_cuda_narrow_fwd_matches_plain(cuda_card, di, do, e, c, o, dtype):
    """#3's narrow-O arm within 1e-4 of max|plain| (the wide arms' bound:
    the same three-pass bf16 product on the tensor cores), the same bits on
    a repeat, one launch counted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w3, v2, _, b3 = (a.cuda() for a in _bwd_args(di, do, e, c=c,
                                                     dtype=dtype, o=o))
    before = kp.fused_pairwise_conv.launches
    out = kp.fused_pairwise_conv(h, w3, v2, b3)
    torch.cuda.synchronize()
    assert kp.fused_pairwise_conv.launches == before + 1
    ref = kp.fused_pairwise_conv_plain(h, w3, v2, b3)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(out, kp.fused_pairwise_conv(h, w3, v2, b3))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('di,do,e,c,o', NARROW_CASES)
def test_cuda_narrow_backward_matches_plain(cuda_card, di, do, e, c, o,
                                            dtype):
    """Kernels A and B's narrow-O arms: every output within 1e-4 of
    max|plain| (the wide arms' bound: their three-pass bf16 products), the
    same bits on a repeat, one launch of each counted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() for a in _bwd_args(di, do, e, c=c, dtype=dtype, o=o)]
    bwd = kp.fused_pairwise_conv_bwd
    before = (bwd.launches_a, bwd.launches_b)
    outs = bwd(*args)
    torch.cuda.synchronize()
    assert (bwd.launches_a, bwd.launches_b) == (before[0] + 1, before[1] + 1)
    refs = kp.fused_pairwise_conv_bwd_plain(*args)
    for name, out, ref in zip(('dh', 'dw3', 'dv2', 'db3'), outs, refs):
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max(), name
    for a, b in zip(outs, bwd(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('J,D,fits', [
    (ka.MAX_SLOTS, ka.MAX_FEATURES, True), (ka.MAX_SLOTS - 1, 8, True),
    (ka.MAX_SLOTS + 1, 8, False), (33, ka.MAX_FEATURES + 1, False)])
def test_attention_fits_at_each_limit(J, D, fits):
    assert (ka.attention_limit(J, D) is None) is fits
    q = torch.zeros(2, 3, D)
    kv = torch.zeros(2, 3, J, D)
    if fits:
        assert ka._check(q, kv, kv, None, 2) == (2, 2, 3, J, D)
    else:
        with pytest.raises(ValueError, match='exceeds'):
            ka._check(q, kv, kv, None, 2)


FLASH_OK = dict(pairs=((0, 64), (1, 64), (2, 64), (3, 64)), d_out=3,
                heads=8, kv_heads=8, dim_head=8, K=32, prefix=4)


@pytest.mark.parametrize('over,fits', [
    (dict(), True), (dict(K=1), True), (dict(K=33), False), (dict(K=0), False),
    (dict(heads=4, kv_heads=4, dim_head=16), True),
    (dict(heads=16, kv_heads=16, dim_head=4), False),
    (dict(dim_head=4), False), (dict(dim_head=9), False),
    (dict(kv_heads=4), False), (dict(prefix=5), False),
    (dict(d_out=4), False), (dict(pairs=((4, 8),)), False),
    (dict(pairs=((0, 8),) * 5), False), (dict(pairs=()), False),
    (dict(mid=64), False), (dict(h_dtype=BF16), True),
    (dict(h_dtype=torch.float16), False)])
def test_flash_fits_at_each_limit(over, fits):
    args = dict(FLASH_OK, **over)
    assert (kf.flash_limit(**args) is None) is fits


GLOBAL_OK = dict(pairs=((0, 8), (1, 8)), d_out=1, heads=2, kv_heads=2,
                 dim_head=8, prefix=2)


@pytest.mark.parametrize('over,fits', [
    (dict(), True), (dict(heads=16, kv_heads=16, dim_head=1), True),
    (dict(heads=1, kv_heads=1, dim_head=16), True),
    (dict(dim_head=16), False), (dict(dim_head=4), False),
    (dict(kv_heads=1), False), (dict(prefix=4), True), (dict(prefix=5), False),
    # P * IF: 3 * (8 + 3 * 24) = 240 inside, 3 * (8 + 3 * 28) = 276 past,
    # 1 * (8 * 32) = 256 at the limit
    (dict(pairs=((0, 8), (1, 24))), True),
    (dict(pairs=((0, 8), (1, 28))), False),
    (dict(pairs=((0, 256),), d_out=0), True),
    (dict(pairs=((0, 257),), d_out=0), False),
    (dict(d_out=4), False)])
def test_global_fits_at_each_limit(over, fits):
    args = dict(GLOBAL_OK, **over)
    assert (kf.global_limit(**args) is None) is fits


@pytest.mark.parametrize('device_type,limit,routes', [
    ('cuda', 'O = 16 exceeds the built O: a multiple of 64', True),
    ('cuda', None, False), ('cpu', 'O = 16 exceeds', False),
    ('meta', 'O = 16 exceeds', False)])
def test_route_decides_by_device_type_and_limit(monkeypatch, device_type,
                                                limit, routes):
    """route: a call routes only on a 'cuda' device past a limit; only
    such a call counts."""
    monkeypatch.setattr(routing, '_WARNED', set())
    monkeypatch.setattr(kp.fused_pairwise_conv, 'routed', 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        assert routing.route(kp.fused_pairwise_conv, device_type, limit,
                             (128, 24, 16, 3)) is routes
    assert kp.fused_pairwise_conv.routed == int(routes)
    assert len(caught) == int(routes)


def test_route_counts_and_warns_once_per_shape(monkeypatch):
    """route: one .routed per call, one warning per (kernel, shape) that
    names the kernel and the limit, worded as the JAX fallbacks are."""
    monkeypatch.setattr(routing, '_WARNED', set())
    monkeypatch.setattr(kp.fused_pairwise_conv, 'routed', 0)
    limit = kp.pairwise_limit('fwd', 128, 24, 3)
    with pytest.warns(UserWarning) as caught:
        for shape in ((128, 24, 24, 3), (128, 24, 24, 3), (128, 48, 24, 3)):
            assert routing.route(kp.fused_pairwise_conv, 'cuda', limit, shape)
    assert kp.fused_pairwise_conv.routed == 3
    texts = [str(w.message) for w in caught]
    assert len(texts) == 2
    assert texts[0] == ('fused_pairwise_conv kernel: O = 24 exceeds the built '
                        'O: 8, 16, 32 or a multiple of 64 (shape (128, 24, 24, '
                        '3)); using the plain path')


@pytest.mark.parametrize('op', ['fwd', 'bxf', 'bx'])
@pytest.mark.parametrize('O', [32, 64, 128, 192])
def test_contract_backward_runs_the_fused_backward(monkeypatch, op, O):
    """Each op's backward calls fused_pairwise_conv_bwd (kernels A and B
    on a card; here its plain version) once, at any O, with no route
    decision of its own (a call past the kernels' limits was routed by its
    layer before the forward); its gradients are the plain forward's
    under autograd."""
    di, do, e = 1, 2, 40
    a = _operands(di, do, seed=5, e=e, mid=kp.MID, c=3, o=O)
    P, Q, F = a['pqf']
    t = {k: torch.from_numpy(a[k]) for k in ('h', 'w3', 'basis', 'x', 'b3')}
    basis = t['basis'].reshape(e, P, F, Q)
    v2 = torch.einsum('epfq,ecq->epcf', basis, t['x']).reshape(e, P, 3 * F)

    def run(contract):
        leaves = {k: v.clone().requires_grad_() for k, v in t.items()}
        lv = leaves
        if op == 'fwd':
            lv2 = v2.clone().requires_grad_()
            out = contract(lv['h'], lv['w3'], lv['b3'], lv2)
            grads_of = [lv['h'], lv['w3'], lv['b3'], lv2]
        elif op == 'bxf':
            out = contract(lv['h'], lv['w3'], lv['b3'], lv['basis'], lv['x'],
                           a['pqf'])
            grads_of = [lv['h'], lv['w3'], lv['b3'], lv['basis'], lv['x']]
        else:
            pqf_basis = basis.permute(0, 1, 3, 2).contiguous()
            lb = pqf_basis.clone().requires_grad_()
            out = contract(lv['h'], lv['w3'], lv['b3'], lb, lv['x'])
            grads_of = [lv['h'], lv['w3'], lv['b3'], lb, lv['x']]
        return torch.autograd.grad((out ** 2).sum(), grads_of)

    plain = dict(
        fwd=lambda h, w3, b3, v2_: kp.fused_pairwise_conv_plain(h, w3, v2_,
                                                                 b3),
        bxf=lambda h, w3, b3, bf, x, pqf: kp.fused_pairwise_conv_bxf_plain(
            h, w3, bf, x, pqf, b3),
        bx=lambda h, w3, b3, bb, x: kp.fused_pairwise_conv_bx_plain(
            h, w3, bb, x, b3))[op]
    ref = run(plain)
    calls = []
    real = kp.fused_pairwise_conv_bwd_plain
    monkeypatch.setattr(kp, 'fused_pairwise_conv_bwd_plain',
                        lambda *args: calls.append(1) or real(*args))
    got = run(dict(fwd=kp.pairwise_contract, bxf=kp.pairwise_contract_bxf,
                   bx=kp.pairwise_contract_bx)[op])
    assert len(calls) == 1
    for g, r in zip(got, ref):
        assert (g - r).abs().max() <= 1e-5 * r.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('fuse_basis', [True, False])
def test_cuda_wide_conv_launches_forward_and_routes_backward(cuda_card,
                                                             fuse_basis):
    """A ConvSE3 of 128 channels (O = 128: two O tiles of #1 and #3, and of
    kernels A and B) on the card: without grad it launches its forward
    kernel and routes nothing; with grad the forward still launches and
    the backward launches kernels A and B, routing nothing, within 1e-4 of
    the CPU."""
    from se3_transformer_torch import ConvSE3, Fiber, get_basis
    from se3_transformer_torch.models.se3_transformer import init_parameters
    torch.backends.cuda.matmul.allow_tf32 = False
    fwd = kp.fused_pairwise_conv_bxf if fuse_basis else kp.fused_pairwise_conv
    gen = torch.Generator().manual_seed(7)
    n, k = 24, 8
    fiber = Fiber.create(2, 128)
    feats = {str(d): torch.randn(1, n, 128, 2 * d + 1, generator=gen)
             for d in range(2)}
    idx = torch.randint(0, n, (1, n, k), generator=gen)
    mask = torch.ones(1, n, k, dtype=torch.bool)
    rel = torch.randn(1, n, k, 3, generator=gen) * 3.0
    conv = ConvSE3(fiber, fiber, fuse_basis=fuse_basis,
                   shared_radial_hidden=True)
    init_parameters(conv, torch.Generator().manual_seed(0))
    results = {}
    for device in ('cpu', 'cuda'):
        c = conv.to(device)
        xs = {d: v.to(device).requires_grad_() for d, v in feats.items()}
        r = rel.to(device)
        basis = get_basis(r, 1, layout='pfq_flat' if fuse_basis else 'pqf')
        args = (xs, (idx.to(device), mask.to(device), None),
                r.norm(dim=-1), basis)
        launches, fwd_routes = fwd.launches, fwd.routed
        bwd_launches = kp.fused_pairwise_conv_bwd.launches_a
        with torch.no_grad():
            c(*args)
        torch.cuda.synchronize()
        if device == 'cuda':
            assert fwd.launches > launches
            assert fwd.routed == fwd_routes
        out = c(*args)
        loss = sum((o ** 2).sum() for o in out.values())
        grads = torch.autograd.grad(loss, [xs['0'], xs['1']]
                                    + list(c.parameters()))
        if device == 'cuda':
            torch.cuda.synchronize()
            assert fwd.routed == fwd_routes
            assert kp.fused_pairwise_conv_bwd.launches_a > bwd_launches
        results[device] = [o.detach().cpu() for o in out.values()] + \
            [g.cpu() for g in grads]
    for got, ref in zip(results['cuda'], results['cpu']):
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


# the thirteen configurations of tests/test_equivariance.py that the port
# builds (all but the EGNN one): name -> (model fields, batch, input dims
# per degree, return type, the extra inputs), as the reference tests build
# them
EQUIVARIANCE_CONFIGS = {
    'test_transformer': (dict(dim=64, depth=1, num_degrees=2,
                              num_neighbors=4, valid_radius=10), 1, (64,), 0,
                         None),
    'test_causal_se3_transformer': (
        dict(dim=64, depth=1, num_degrees=2, num_neighbors=4,
             valid_radius=10, causal=True), 1, (64,), 0, None),
    'test_transformer_with_edges': (
        dict(dim=64, depth=1, num_degrees=2, num_neighbors=4, edge_dim=4,
             num_edge_tokens=4), 1, (64,), 0, 'edge_tokens'),
    'test_transformer_with_continuous_edges': (
        dict(dim=64, depth=1, attend_self=True, num_degrees=2,
             output_degrees=2, edge_dim=34), 1, (64,), 1,
        'continuous_edges'),
    'test_different_input_dimensions_for_types': (
        dict(dim_in=(4, 2), dim=4, depth=1, input_degrees=2, num_degrees=2,
             output_degrees=2, reduce_dim_out=True), 2, (4, 2), 1, None),
    'test_equivariance': (dict(dim=64, depth=1, attend_self=True,
                               num_neighbors=4, num_degrees=2,
                               output_degrees=2, fourier_encode_dist=True),
                          1, (64,), 1, None),
    'test_equivariance_only_sparse_neighbors': (
        dict(dim=64, depth=1, attend_self=True, num_degrees=2,
             output_degrees=2, num_neighbors=0, attend_sparse_neighbors=True,
             num_adj_degrees=2, adj_dim=4), 1, (64,), 1, 'band_adjacency'),
    'test_equivariance_with_reversible_network': (
        dict(dim=64, depth=1, attend_self=True, num_neighbors=4,
             num_degrees=2, output_degrees=2, reversible=True), 1, (64,), 1,
        None),
    'test_equivariance_with_type_one_input': (
        dict(dim=64, depth=1, attend_self=True, num_neighbors=4,
             num_degrees=2, input_degrees=2, output_degrees=2), 1, (64, 64),
        1, None),
    'test_se3_transformer_with_global_nodes': (
        dict(dim=64, depth=1, num_degrees=2, num_neighbors=4,
             valid_radius=10, global_feats_dim=16), 1, (64,), 0,
        'global_feats'),
    'test_one_headed_key_values_se3_transformer_with_global_nodes': (
        dict(dim=64, depth=1, num_degrees=2, num_neighbors=4,
             valid_radius=10, global_feats_dim=16,
             one_headed_key_values=True), 1, (64,), 0, 'global_feats'),
    'test_rotary': (
        dict(dim=64, depth=1, attend_self=True, num_neighbors=4,
             num_degrees=2, output_degrees=2, fourier_encode_dist=True,
             rotary_position=True, rotary_rel_dist=True), 1, (64,), 1, None),
    'test_equivariance_linear_proj_keys': (
        dict(dim=64, depth=1, attend_self=True, num_neighbors=4,
             num_degrees=2, output_degrees=2, fourier_encode_dist=True,
             linear_proj_keys=True), 1, (64,), 1, None),
}


def _extra_inputs(kind, b, n, rng):
    """The reference tests' edge, adjacency and global inputs as tensors:
    edge tokens constant along a row, Fourier features of random integer
    pairs (34 wide), the band |i - j| <= 1 with the diagonal set, two
    global nodes of 16 features."""
    from se3_transformer_torch.utils.helpers import fourier_encode
    if kind == 'edge_tokens':
        tokens = torch.from_numpy(rng.randint(0, 4, (b, n)))
        return dict(edges=tokens[:, :, None].expand(b, n, n))
    if kind == 'continuous_edges':
        values = rng.randint(0, 4, (b, n, n, 2)).astype(np.float32)
        return dict(edges=fourier_encode(torch.from_numpy(values),
                                         num_encodings=8))
    if kind == 'band_adjacency':
        seq = torch.arange(n)
        return dict(adj_mat=(seq[:, None] - seq[None, :]).abs() <= 1)
    if kind == 'global_feats':
        return dict(global_feats=torch.from_numpy(
            rng.normal(size=(b, 2, 16)).astype(np.float32)))
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(EQUIVARIANCE_CONFIGS))
def test_cuda_equivariance_configs_match_cpu(cuda_card, case):
    """Each configuration built on the card (its kv convs' O = 192 on #3
    and, under grad, kernels A and B; O not a multiple of 64 routed): the
    output within 1e-4 of the same weights on the CPU, and equivariant on
    the card within the reference's 1e-4."""
    from se3_transformer_torch import SE3TransformerModule
    from se3_transformer_torch.so3 import rot
    torch.backends.cuda.matmul.allow_tf32 = False
    fields, b, dims, return_type, kind = EQUIVARIANCE_CONFIGS[case]
    rng = np.random.RandomState(0)
    n = 32
    if len(dims) == 1:
        feats = rng.normal(size=(b, n, dims[0])).astype(np.float32)
    else:
        feats = {str(d): rng.normal(size=(b, n, c, 2 * d + 1))
                 .astype(np.float32) for d, c in enumerate(dims)}
    coors = rng.normal(size=(b, n, 3)).astype(np.float32)
    extra = _extra_inputs(kind, b, n, rng)
    R = rot(15, 0, 45)

    def rotate(x):
        return (np.asarray(x, np.float64) @ R).astype(np.float32)

    def run(model, device, f, c):
        f = {k: torch.from_numpy(v).to(device) for k, v in f.items()} \
            if isinstance(f, dict) else torch.from_numpy(f).to(device)
        with torch.no_grad():
            return model(f, torch.from_numpy(c).to(device),
                         torch.ones(b, n, dtype=torch.bool, device=device),
                         return_type=return_type,
                         **{k: v.to(device) for k, v in extra.items()}
                         ).cpu().numpy()
    outs = {}
    for device in ('cpu', 'cuda'):
        model = SE3TransformerModule(
            **fields, device=device,
            generator=torch.Generator().manual_seed(0))
        outs[device] = run(model, device, feats, coors)
    assert np.abs(outs['cuda'] - outs['cpu']).max() <= \
        1e-4 * np.abs(outs['cpu']).max()
    feats_r = {k: (rotate(v) if k == '1' else v) for k, v in feats.items()} \
        if isinstance(feats, dict) else feats
    out_r = run(model, 'cuda', feats_r, rotate(coors))
    expected = rotate(outs['cuda']) if return_type else outs['cuda']
    assert np.abs(out_r - expected).max() < 1e-4


# ---------------------------------------------------------------------- #
# the scaled arms of #3 and #7 (quantized serving, se3_transformer_torch
# .quant): W3 as int8 or fp8 storage with a float32 scale per (i, o)
# ---------------------------------------------------------------------- #
from se3_transformer_torch import quant  # noqa: E402

QUANT_STORAGES = ('int8', 'fp8_e4m3')
# the scaled arms against their plain versions, relative to max|plain|:
# the same exact products (int8 and e4m3 are exact in bf16) summed in
# float32 in other orders
QUANT_RTOL = 1e-5


def _quantized(w, storage):
    qt = quant.quantize(w, (0,), storage)
    return qt.q, qt.scale


def _fwd_q_args(P=5, IF=70, e=96, dtype=torch.bfloat16, storage='int8',
                seed=5):
    """_fwd_args with W3 quantized: (h, q, v2, b3, scale)."""
    h, w3, v2, b3 = _fwd_args(P, IF, e, torch.float32, seed)
    q, scale = _quantized(w3, storage)
    return [h.to(dtype), q, v2, b3, scale]


def test_cpu_scaled_forward_never_counts_a_launch():
    h, q, v2, b3, scale = _fwd_q_args(e=70)
    before = (kp.fused_pairwise_conv.launches,
              kp.fused_pairwise_conv.scaled_launches)
    out = kp.fused_pairwise_conv(h, q, v2, b3, w3_scale=scale)
    assert tuple(out.shape) == (70, 5, kp.O_TILE)
    assert (kp.fused_pairwise_conv.launches,
            kp.fused_pairwise_conv.scaled_launches) == before
    ref = kp.fused_pairwise_conv_plain(
        h, q.float() * scale, v2, b3)
    assert (out - ref).abs().max() <= QUANT_RTOL * ref.abs().max()


@pytest.mark.parametrize('bad', ['float_w3', 'scale_dtype', 'scale_shape',
                                 'h_dtype', 'noncontig_scale'])
def test_scaled_fwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    h, q, v2, b3, scale = _fwd_q_args()
    assert kp._check_fwd(h, q, v2, b3, scale) == (96, 70, kp.O_TILE, 5)
    if bad == 'float_w3':
        q = q.float()
    elif bad == 'scale_dtype':
        scale = scale.double()
    elif bad == 'scale_shape':
        scale = scale[..., :-1].contiguous()
    elif bad == 'h_dtype':
        h = h.half()
    elif bad == 'noncontig_scale':
        scale = scale.expand(2, -1, -1)[:1].transpose(1, 2).contiguous() \
            .transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        kp._check_fwd(h, q, v2, b3, scale)


@pytest.mark.cuda
@pytest.mark.parametrize('storage', QUANT_STORAGES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('P,IF,e', [(1, 20, 64), (3, 35, 200), (5, 70, 1000),
                                    (7, 80, 77), (7, 1024, 4096),
                                    (3, 640, 4133), (7, 1001, 300)])
def test_cuda_scaled_fwd_matches_plain(cuda_card, storage, dtype, P, IF, e):
    """#3's scaled arm against its plain version: int8 and fp8, float32
    and bf16 h, ragged E, IF off the 16-wide chunk, i splits; each launch
    counted in .launches and .scaled_launches, the same bits on a
    repeat."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() for a in _fwd_q_args(P, IF, e, dtype, storage)]
    h, q, v2, b3, scale = args
    before = (kp.fused_pairwise_conv.launches,
              kp.fused_pairwise_conv.scaled_launches)
    out = kp.fused_pairwise_conv(h, q, v2, b3, w3_scale=scale)
    again = kp.fused_pairwise_conv(h, q, v2, b3, w3_scale=scale)
    torch.cuda.synchronize()
    assert (kp.fused_pairwise_conv.launches,
            kp.fused_pairwise_conv.scaled_launches) == (before[0] + 2,
                                                        before[1] + 2)
    assert torch.equal(out, again)
    ref = kp.fused_pairwise_conv_plain(h, q, v2, b3, w3_scale=scale)
    assert (out - ref).abs().max() <= QUANT_RTOL * ref.abs().max()


def _flash_q(cfg, ops, storage):
    """A kNN (cfg, ops) with W_v (and, untied, W_k) quantized."""
    ops = dict(ops)
    for c in ('v',) if cfg.tie else ('k', 'v'):
        ops[f'w{c}'], ops[f'w{c}_scale'] = _quantized(ops[f'w{c}'], storage)
    return cfg, ops


def test_flash_check_takes_scaled_weights():
    """The wrapper's check takes int8 / fp8 W3 with float32 scales, and
    refuses a float32 W3 beside a scale, a scale on one conv alone, and a
    mis-shaped scale."""
    cfg, ops = _flash_q(*_flash_case(), 'int8')
    assert kf._check(cfg, ops)[:5] == (1, 13, 6, 49, 1)
    plain_cfg, plain_ops = _flash_case()
    for bad in (dict(ops, wv=plain_ops['wv']), dict(ops, wk_scale=None),
                dict(ops, wv_scale=ops['wv_scale'][..., :-1].contiguous())):
        with pytest.raises((TypeError, ValueError)):
            kf._check(cfg, bad)


def test_cpu_flash_scaled_never_counts_a_launch():
    cfg, ops = _flash_q(*_flash_case(), 'fp8_e4m3')
    before = (kf.flash_attention_fwd.launches,
              kf.flash_attention_fwd.scaled_launches)
    out = kf.flash_attention_fwd(cfg, ops)
    assert out.shape == ops['q'].shape
    assert (kf.flash_attention_fwd.launches,
            kf.flash_attention_fwd.scaled_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize('storage', QUANT_STORAGES)
@pytest.mark.parametrize('arm', ['dense', 'so2'])
@pytest.mark.parametrize('tie', [False, True])
@pytest.mark.parametrize('h_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('d_out,n,K,prefix,wide', [
    (0, 13, 6, 1, False), (2, 37, 30, 0, True), (3, 40, 32, 2, True)])
def test_cuda_flash_scaled_matches_plain(cuda_card, storage, arm, tie,
                                         h_dtype, d_out, n, K, prefix, wide):
    """#7's scaled arm against its plain stream: int8 and fp8, dense and
    so2, untied and tied, bf16 and float32 h, ragged n and K; each launch
    counted in .launches and .scaled_launches, the same bits on a
    repeat."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pairs = FLAGSHIP_PAIRS if wide else ((0, 5), (1, 3), (2, 4), (3, 2))
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in pairs)
    cfg, ops = _flash_case(d_out, n, K, prefix, True, h_dtype, pairs=pairs,
                           w_scale=(kf.MID * IF) ** -0.5 if wide else None)
    if arm == 'so2':
        cfg, ops = _so2(cfg, ops)
    if tie:
        cfg, ops = _tied(cfg, ops)
    cfg, ops = _flash_q(cfg, ops, storage)
    ops = _on_card(ops)
    before = (kf.flash_attention_fwd.launches,
              kf.flash_attention_fwd.scaled_launches)
    out = kf.flash_attention_fwd(cfg, ops)
    again = kf.flash_attention_fwd(cfg, ops)
    torch.cuda.synchronize()
    assert (kf.flash_attention_fwd.launches,
            kf.flash_attention_fwd.scaled_launches) == (before[0] + 2,
                                                        before[1] + 2)
    assert torch.equal(out, again)
    ref = kf.flash_attention_plain(cfg, ops)
    assert (out - ref).abs().max() <= QUANT_RTOL * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('rules', [
    ((r'to_v/w3_\d+_\d+$', 'int8', 3), (r'.*', 'fp32')),
    ((r'to_k/w3_\d+_\d+$', 'int8', 3), (r'to_v/w3_\d+_\d+$', 'fp8_e4m3', 3),
     (r'.*', 'fp32'))], ids=['values_int8', 'keys_int8_values_fp8'])
def test_cuda_mixed_kv_storage_routes_to_the_plain_stream(
        cuda_card, monkeypatch, rules):
    """A rule list that gives the keys' and the values' W3 different
    storage: kernel #7 (one storage for both) is past flash_limit, so each
    streaming call routes to the plain stream (.routed, no #7 launch) and
    the output matches the same weights on the CPU within 1e-4."""
    import copy
    from se3_transformer_torch import SE3TransformerModule
    torch.backends.cuda.matmul.allow_tf32 = False
    # flagship_fast's widths at depth 1 with a float32 trunk
    host = SE3TransformerModule(
        dim=64, depth=1, num_degrees=4, heads=8, dim_head=8,
        attend_self=True, num_neighbors=16, shared_radial_hidden=True,
        fuse_basis=True, fuse_pairwise=True, device='cpu',
        generator=torch.Generator().manual_seed(4)).eval()
    quant.quantize_params(host, rules)
    card = copy.deepcopy(host).to('cuda')
    rng = np.random.RandomState(3)
    n = 48
    inputs = (rng.normal(size=(1, n, 64)).astype(np.float32),
              np.cumsum(rng.normal(size=(1, n, 3)), 1).astype(np.float32),
              np.ones((1, n), bool))
    monkeypatch.setattr(kf.flash_attention_fwd, 'routed', 0)
    monkeypatch.setattr(routing, '_WARNED', set())
    launches = kf.flash_attention_fwd.launches
    outs = {}
    for model, device in ((card, 'cuda'), (host, 'cpu')):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter('always')
            with torch.inference_mode():
                outs[device] = model(*(torch.from_numpy(a).to(device)
                                       for a in inputs)).cpu().numpy()
        if device == 'cuda':
            assert any('mixed W3 storage' in str(w.message) for w in seen)
    # one streaming block, one call per output degree
    assert kf.flash_attention_fwd.routed == 4
    assert kf.flash_attention_fwd.launches == launches
    assert np.isfinite(outs['cuda']).all()
    assert np.abs(outs['cuda'] - outs['cpu']).max() <= \
        1e-4 * np.abs(outs['cpu']).max()


# ---------------------------------------------------------------------- #
# conv_bf16: the bf16-storage arms of #1/#2, #3, A and B
# ---------------------------------------------------------------------- #
def _bf16(t):
    """The bf16 storage of an operand, as conv_bf16 casts it."""
    return t.to(torch.bfloat16)


@pytest.mark.parametrize('kernel,Q', [('bxf', 5), ('bx', 5), ('fwd', 1),
                                      ('bwd', 1)])
@pytest.mark.parametrize('operand,scaled,fits', [
    (F32, False, True), (BF16, False, True), (torch.float16, False, False),
    (torch.float64, False, False), (F32, True, True), (BF16, True, False)])
def test_pairwise_fits_the_operand_storage(kernel, Q, operand, scaled, fits):
    """Every pairwise kernel takes its equivariant operand float32 or bf16
    (conv_bf16); #3's scaled arm takes float32 V2 only."""
    limit = kp.pairwise_limit(kernel, 128, 64, 3, Q, F32,
                              operand_dtype=operand, scaled=scaled)
    assert (limit is None) is fits
    if not fits:
        assert 'exceeds' in limit


def test_wrappers_check_bf16_operands():
    """The checks take bf16 V2 and a bf16 basis with bf16 x, and refuse a
    basis and x of different storage and a scaled call with bf16 V2."""
    args = _kernel_args()
    args[2], args[3] = _bf16(args[2]), _bf16(args[3])
    assert kp._check(*args) == (args[0].shape[0], args[3].shape[1],
                                kp.O_TILE)
    bx, _ = _bx_args()
    bx[2], bx[3] = _bf16(bx[2]), _bf16(bx[3])
    assert kp._check_bx(*bx)[:3] == (96, 5, kp.O_TILE)
    args[3] = args[3].float()
    with pytest.raises(TypeError, match='one dtype'):
        kp._check(*args)
    fwd = _fwd_args()
    fwd[2] = _bf16(fwd[2])
    assert kp._check_fwd(*fwd) == (96, 70, kp.O_TILE, 5)
    bwd = _bwd_args()
    bwd[2] = _bf16(bwd[2])
    assert kp._check_bwd(*bwd) == (96, 15, kp.O_TILE, 5)
    q = fwd[1].float().to(torch.int8)
    with pytest.raises(ValueError, match='scaled arm'):
        kp._check_fwd(fwd[0].float(), q, fwd[2], fwd[3],
                      torch.ones(1, 70, kp.O_TILE))


def test_plain_versions_upcast_bf16_operands_exactly():
    """Each plain version given bf16 storage computes what it computes on
    the same values upcast to float32, bit for bit (the upcast is exact);
    no launch is counted on the CPU."""
    counts = (kp.fused_pairwise_conv_bxf.conv_bf16_launches,
              kp.fused_pairwise_conv.conv_bf16_launches,
              kp.fused_pairwise_conv_bwd.conv_bf16_launches_a)
    args = _kernel_args(2, 3, e=70, dtype=F32)
    b16, x16 = _bf16(args[2]), _bf16(args[3])
    assert torch.equal(
        kp.fused_pairwise_conv_bxf(args[0], args[1], b16, x16, args[4],
                                   args[5]),
        kp.fused_pairwise_conv_bxf(args[0], args[1], b16.float(),
                                   x16.float(), args[4], args[5]))
    bx, _ = _bx_args(e=70, dtype=F32)
    s16, xs16 = _bf16(bx[2]), _bf16(bx[3])
    assert torch.equal(
        kp.fused_pairwise_conv_bx(bx[0], bx[1], s16, xs16, bx[4]),
        kp.fused_pairwise_conv_bx(bx[0], bx[1], s16.float(), xs16.float(),
                                  bx[4]))
    h, w3, v2, b3 = _fwd_args(e=70, dtype=F32)
    v16 = _bf16(v2)
    assert torch.equal(kp.fused_pairwise_conv(h, w3, v16, b3),
                       kp.fused_pairwise_conv(h, w3, v16.float(), b3))
    h, w3, v2, g, b3 = _bwd_args(e=70, dtype=F32)
    v16 = _bf16(v2)
    for a, b in zip(kp.fused_pairwise_conv_bwd(h, w3, v16, g, b3),
                    kp.fused_pairwise_conv_bwd(h, w3, v16.float(), g, b3)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert counts == (kp.fused_pairwise_conv_bxf.conv_bf16_launches,
                      kp.fused_pairwise_conv.conv_bf16_launches,
                      kp.fused_pairwise_conv_bwd.conv_bf16_launches_a)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('di,do,e,c', BXF_CASES)
def test_cuda_conv_bf16_bxf_and_bx_match_plain(cuda_card, di, do, e, c,
                                               dtype):
    """The bf16-storage arm of kernels #1 and #2 (basis and x bf16, h bf16
    or float32): within 1e-4 of max|plain| on the same bf16 operands, the
    same bits on a repeat and between the two basis layouts, one launch
    each counted in .conv_bf16_launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() if isinstance(a, torch.Tensor) else a
            for a in _kernel_args(di, do, e, dtype, c)]
    args[2], args[3] = _bf16(args[2]), _bf16(args[3])
    P, Q, F = args[4]
    structured = args[2].reshape(e, P, F, Q).transpose(2, 3).contiguous()
    before = (kp.fused_pairwise_conv_bxf.conv_bf16_launches,
              kp.fused_pairwise_conv_bx.conv_bf16_launches)
    out = kp.fused_pairwise_conv_bxf(*args)
    out_bx = kp.fused_pairwise_conv_bx(args[0], args[1], structured, args[3],
                                       args[5])
    torch.cuda.synchronize()
    assert (kp.fused_pairwise_conv_bxf.conv_bf16_launches,
            kp.fused_pairwise_conv_bx.conv_bf16_launches) == (
        before[0] + 1, before[1] + 1)
    ref = kp.fused_pairwise_conv_bxf_plain(*args)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(out, kp.fused_pairwise_conv_bxf(*args))
    assert torch.equal(out, out_bx)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('P,IF,e', [(1, 20, 64), (3, 35, 200), (5, 70, 1000),
                                    (7, 80, 77), (7, 1024, 4096),
                                    (3, 640, 4133), (7, 1001, 300),
                                    (5, 1024, 4095), (1, 37, 64)])
def test_cuda_conv_bf16_fwd_matches_plain(cuda_card, P, IF, e, dtype):
    """The bf16-V2 arm of kernel #3: 16-byte copies of 8 values (IF a
    multiple of 8), plain loads (odd IF), i splits, ragged E: within 1e-4
    of max|plain| on the same bf16 V2 and the same bits on a repeat."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w3, v2, b3 = (a.cuda() for a in _fwd_args(P, IF, e, dtype))
    v2 = _bf16(v2)
    before = (kp.fused_pairwise_conv.launches,
              kp.fused_pairwise_conv.conv_bf16_launches)
    out = kp.fused_pairwise_conv(h, w3, v2, b3)
    torch.cuda.synchronize()
    assert (kp.fused_pairwise_conv.launches,
            kp.fused_pairwise_conv.conv_bf16_launches) == (before[0] + 1,
                                                           before[1] + 1)
    ref = kp.fused_pairwise_conv_plain(h, w3, v2, b3)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(out, kp.fused_pairwise_conv(h, w3, v2, b3))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('di,do,e,c,o', [
    (0, 0, 64, 5, 64), (3, 3, 200, 5, 64), (2, 1, 1000, 5, 64),
    (3, 2, 5000, 5, 64), (1, 1, 1000, 4, 64), (3, 3, 4096, 64, 64),
    (2, 3, 4133, 64, 64), (0, 0, 77, 32, 192), (1, 1, 1000, 32, 192),
    (3, 3, 130, 4, 192), (2, 1, 300, 5, 64)])
def test_cuda_conv_bf16_backward_matches_plain(cuda_card, di, do, e, c, o,
                                               dtype):
    """The bf16-V2 arm of kernels A and B (even and odd IF: 4- and 8-byte
    copies or plain loads; i splits; O tiles; ragged E): every output
    within 1e-4 of max|plain| on the same bf16 V2, dV2 float32, the same
    bits on a second run, one launch each counted in
    .conv_bf16_launches_a / _b."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.cuda() for a in _bwd_args(di, do, e, c=c, dtype=dtype, o=o)]
    args[2] = _bf16(args[2])
    bwd = kp.fused_pairwise_conv_bwd
    before = (bwd.conv_bf16_launches_a, bwd.conv_bf16_launches_b)
    outs = bwd(*args)
    again = bwd(*args)
    torch.cuda.synchronize()
    assert (bwd.conv_bf16_launches_a, bwd.conv_bf16_launches_b) == (
        before[0] + 2, before[1] + 2)
    refs = kp.fused_pairwise_conv_bwd_plain(*args)
    for name, out, ref, out2 in zip(('dh', 'dw3', 'dv2', 'db3'), outs, refs,
                                    again):
        assert out.dtype == torch.float32 and out.shape == ref.shape, name
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max(), name
        assert torch.equal(out, out2), name


# the mid-32 arms (the V2 family's per-m blocks: mid 32, P 1 or 2) and P =
# 2 at mid 128 on the card: V2's hidden-block widths (O 64, IF 64 to 768),
# a wider O, the JAX sweep's narrow O = 8 (C 8: IF 8 to 96), the other
# narrow tiles, ragged E and odd IF
MID32_CASES = [(32, 1, 448, 4133, 64), (32, 2, 768, 4096, 64),
               (32, 2, 128, 1000, 128), (32, 1, 64, 777, 64),
               (32, 2, 100, 300, 64), (32, 1, 46, 501, 64),
               (32, 2, 24, 1536, 8), (32, 1, 8, 1536, 8),
               (32, 2, 96, 200, 16), (32, 1, 40, 500, 32),
               (128, 2, 128, 2000, 64), (128, 2, 24, 768, 8)]


def _m32_args(mid, P, IF, e, o, dtype, seed=11):
    rng = np.random.RandomState(seed)
    f32 = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.normal(size=s)).astype(np.float32)).cuda()
    return (f32(e, mid).to(dtype), f32(mid, IF, o, scale=mid ** -0.5).to(dtype),
            f32(e, P, IF), f32(e, P, o), f32(IF, o, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('mid,P,IF,e,o', MID32_CASES)
def test_cuda_mid32_and_two_row_fwd_match_plain(cuda_card, mid, P, IF, e, o,
                                                dtype):
    """#3's mid-32 and P = 2 arms within 1e-4 of max|plain| (the three-pass
    bf16 product's bound, as the other arms), the same bits on a repeat,
    one launch counted (in .mid32_launches too at mid 32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w3, v2, _, b3 = _m32_args(mid, P, IF, e, o, dtype)
    fn = kp.fused_pairwise_conv
    before = (fn.launches, fn.mid32_launches)
    out = fn(h, w3, v2, b3)
    torch.cuda.synchronize()
    assert (fn.launches, fn.mid32_launches) == (before[0] + 1,
                                                before[1] + (mid == 32))
    ref = kp.fused_pairwise_conv_plain(h, w3, v2, b3)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(out, fn(h, w3, v2, b3))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('mid,P,IF,e,o', MID32_CASES)
def test_cuda_mid32_and_two_row_backward_match_plain(cuda_card, mid, P, IF, e,
                                                     o, dtype):
    """Kernels A and B's mid-32 and P = 2 arms: every output within 1e-4 of
    max|plain|, the same bits on a repeat, one launch of each counted (in
    .mid32_launches_a / _b too at mid 32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w3, v2, g, b3 = _m32_args(mid, P, IF, e, o, dtype)
    bwd = kp.fused_pairwise_conv_bwd
    before = (bwd.launches_a, bwd.launches_b, bwd.mid32_launches_a,
              bwd.mid32_launches_b)
    outs = bwd(h, w3, v2, g, b3)
    torch.cuda.synchronize()
    m32 = int(mid == 32)
    assert (bwd.launches_a, bwd.launches_b, bwd.mid32_launches_a,
            bwd.mid32_launches_b) == (before[0] + 1, before[1] + 1,
                                      before[2] + m32, before[3] + m32)
    refs = kp.fused_pairwise_conv_bwd_plain(h, w3, v2, g, b3)
    for name, out, ref in zip(('dh', 'dw3', 'dv2', 'db3'), outs, refs):
        assert out.shape == ref.shape, name
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max(), name
    for a, b in zip(outs, bwd(h, w3, v2, g, b3)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('arm', ['scaled arm', 'conv_bf16'])
def test_cuda_mid32_refused_arms_raise(cuda_card, arm):
    """The scaled and conv_bf16 arms are built for mid 128: a mid-32 call
    of either on a CUDA tensor raises its limit and launches nothing,
    rather than falling back to the plain version."""
    h, w3, v2, g, b3 = _m32_args(32, 2, 64, 256, 64, torch.float32)
    before = (kp.fused_pairwise_conv.launches,
              kp.fused_pairwise_conv_bwd.launches_a)
    with pytest.raises(ValueError, match=arm):
        if arm == 'scaled arm':
            q = w3.to(torch.int8)
            scale = torch.ones(1, 64, 64, device='cuda')
            with torch.no_grad():
                kp.fused_pairwise_conv(h, q, v2, b3, w3_scale=scale)
        else:
            kp.fused_pairwise_conv(h, w3, v2.to(torch.bfloat16), b3)
    if arm == 'conv_bf16':
        with pytest.raises(ValueError, match=arm):
            kp.fused_pairwise_conv_bwd(h, w3, v2.to(torch.bfloat16), g, b3)
    assert (kp.fused_pairwise_conv.launches,
            kp.fused_pairwise_conv_bwd.launches_a) == before
