"""The port's pairwise kernel module (se3_transformer_torch.kernels.pairwise)
against the JAX package's fused_pairwise_conv, fused_pairwise_conv_bxf,
fused_pairwise_conv_bx, fused_pairwise_conv_bwd and the custom_vjps around
them (ops/conv.py::_pairwise_contract_pallas, ::_pairwise_contract_pallas_bxf
and ::_pairwise_contract_pallas_bx), and ConvSE3 given the structured basis
with fuse_basis against the JAX ConvSE3.

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

from se3_transformer_tpu.basis import get_basis as jax_get_basis
from se3_transformer_tpu.kernels.pallas_pairwise import (
    fused_pairwise_conv as jax_fwd,
    fused_pairwise_conv_bwd as jax_bwd,
    fused_pairwise_conv_bx as jax_bx,
    fused_pairwise_conv_bxf as jax_bxf,
)
from se3_transformer_tpu.ops.conv import ConvSE3 as JConv
from se3_transformer_tpu.ops.conv import (
    _pairwise_contract_pallas, _pairwise_contract_pallas_bx,
    _pairwise_contract_pallas_bxf,
)
from se3_transformer_tpu.ops.fiber import Fiber as JFiber
from se3_transformer_torch import convert_flax_params
from se3_transformer_torch.basis import get_basis
from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.ops import ConvSE3, Fiber

# one intra-op thread: these operands are small, and pytest-xdist's
# workers would otherwise oversubscribe the CPU with spinning thread pools
torch.set_num_threads(1)

PAIRS = [(di, do) for di in range(4) for do in range(4)]
# E = 70 is not a multiple of the CUDA kernel's 64-edge tile (ragged tail)
E, MID, C, O = 70, 16, 3, 4
# Both sides sum the same float32 products (bf16 products are exact in
# float32) in different orders: float32 rounding, relative to the output
RTOL = 1e-5


# the narrow-O arms of #3, A and B (O = 8, 16, 32) at the kernels' mid and
# the DenoiseConfig's C = 8 (IF 8 and 24); ids keep the (di, do) cases' own
NARROW = [(0, 0, 8), (1, 1, 16), (0, 1, 32)]
PAIRS_O = ([pytest.param(di, do, None, id=f'{di}-{do}') for di, do in PAIRS]
           + [pytest.param(di, do, o, id=f'{di}-{do}-o{o}')
              for di, do, o in NARROW])


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
@pytest.mark.parametrize('di,do,o', PAIRS_O)
def test_plain_matches_jax_interpret_kernel(di, do, o, dtype):
    """The basis-fused forward's plain version against the Pallas kernel;
    with a narrow `o`, the V2-given forward's (fused_pairwise_conv, the
    function of #3's narrow arm) at mid 128 and C 8."""
    if o is not None:
        a = _operands(di, do, seed=10 * di + do + o, mid=kp.MID, c=8, o=o)
        P, Q, F = a['pqf']
        v2 = np.einsum('epfq,ecq->epcf', a['basis'].reshape(E, P, F, Q),
                       a['x']).reshape(E, P, -1).astype(np.float32)
        ref = np.asarray(jax_fwd(jnp.asarray(a['h'], dtype),
                                 jnp.asarray(a['w3'], dtype), v2,
                                 b3=a['b3'], interpret=True))
        tdt = getattr(torch, dtype)
        out = kp.fused_pairwise_conv(
            torch.from_numpy(a['h']).to(tdt),
            torch.from_numpy(a['w3']).to(tdt), torch.from_numpy(v2),
            torch.from_numpy(a['b3'])).numpy()
        assert out.shape == ref.shape == (E, P, o)
        assert np.abs(out - ref).max() <= RTOL * np.abs(ref).max()
        return
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


def _bwd_operands(di, do, seed, mid=MID, c=C, o=O):
    rng = np.random.RandomState(seed)
    P, F = 2 * do + 1, 2 * min(di, do) + 1
    IF = c * F
    return dict(
        h=rng.normal(size=(E, mid)).astype(np.float32),
        w3=(rng.normal(size=(mid, IF, o)) / np.sqrt(mid)).astype(np.float32),
        v2=rng.normal(size=(E, P, IF)).astype(np.float32),
        g=rng.normal(size=(E, P, o)).astype(np.float32),
        b3=rng.normal(size=(IF, o)).astype(np.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('di,do,o', PAIRS_O)
def test_plain_backward_matches_jax_interpret_kernels(di, do, o, dtype):
    """fused_pairwise_conv_bwd_plain against the two Pallas backward
    kernels (A: dV2, dW3, dB3; B: dH). The JAX implementation upcasts bf16
    h/w3 to float32 before anything else (pallas_pairwise.py:944), so its
    bf16 result is its float32 result on the rounded values: it is fed
    those, which keeps one interpret-mode compile per pair shape. The port
    gets the bf16 tensors themselves. A narrow `o`: the widths of kernels
    A and B's narrow arms (mid 128, C 8)."""
    a = _bwd_operands(di, do, seed=100 + 10 * di + do) if o is None else \
        _bwd_operands(di, do, seed=100 + 10 * di + do + o, mid=kp.MID, c=8,
                      o=o)
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


# ---------------------------------------------------------------------- #
# the forward with V2 given (fused_pairwise_conv) and its custom op
# ---------------------------------------------------------------------- #
def _grouped_operands(do, n_in, seed, e=E, mid=MID, c=C, o=O):
    """Operands of one output degree's grouped contraction: the pairs
    d_in = 0 .. n_in-1 concatenated along IF, as ConvSE3 builds them."""
    rng = np.random.RandomState(seed)
    P = 2 * do + 1
    IF = c * sum(2 * min(di, do) + 1 for di in range(n_in))
    return dict(
        h=rng.normal(size=(e, mid)).astype(np.float32),
        w3=(rng.normal(size=(mid, IF, o)) / np.sqrt(mid)).astype(np.float32),
        v2=rng.normal(size=(e, P, IF)).astype(np.float32),
        b3=rng.normal(size=(IF, o)).astype(np.float32))


GROUPED = [(0, 2), (1, 3), (2, 4), (3, 4), (3, 2)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('do,n_in', GROUPED)
def test_grouped_plain_matches_jax_interpret_kernel(do, n_in, dtype):
    """fused_pairwise_conv_plain against the JAX fused_pairwise_conv
    (the _fwd_kernel body in interpret mode) at grouped shapes: P = 1, 3,
    5, 7 and IF from two to four concatenated pairs."""
    a = _grouped_operands(do, n_in, seed=300 + 10 * do + n_in)
    ref = np.asarray(jax_fwd(jnp.asarray(a['h'], dtype),
                             jnp.asarray(a['w3'], dtype), a['v2'],
                             b3=a['b3'], interpret=True))
    tdt = getattr(torch, dtype)
    out = kp.fused_pairwise_conv(
        torch.from_numpy(a['h']).to(tdt), torch.from_numpy(a['w3']).to(tdt),
        torch.from_numpy(a['v2']), torch.from_numpy(a['b3'])).numpy()
    assert out.shape == ref.shape == (E, 2 * do + 1, O)
    assert np.abs(out - ref).max() <= RTOL * np.abs(ref).max()


# chip_smoke.py's bar for a kernel against its plain version
KERNEL_RTOL = 1e-4


def _bf16_split(x):
    """x = hi + lo + O(2^-16 x): hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_product(h, w3, v2, b3, passes=3):
    """The float32 arithmetic of csrc/pairwise_fwd.cu, emulated in torch:
    h and W3 split into bf16 hi and lo, R = h_hi.W_hi + h_hi.W_lo +
    h_lo.W_hi (passes=3; products of bf16 values are exact in float32,
    sums float32), or h_hi.W_hi alone (passes=1), then the float32 apply
    with b3."""
    E, mid = h.shape
    _, IF, O = w3.shape
    hh, hl = _bf16_split(h)
    wh, wl = (t.reshape(mid, IF * O) for t in _bf16_split(w3))
    R = hh @ wh
    if passes == 3:
        R = R + hh @ wl + hl @ wh
    return torch.bmm(v2, R.reshape(E, IF, O) + b3)


def test_three_bf16_passes_meet_the_kernel_bar():
    """At the flagship's widths (mid 128, IF 1024, O 64, P 7) on a few
    hundred edges, the three-pass split product is within KERNEL_RTOL of
    max|plain| of both the float32 plain version and the JAX kernel
    (interpret mode), so the card's float32 kernel has its error budget
    before it runs; one bf16 pass is not."""
    a = _grouped_operands(3, 4, seed=41, e=300, mid=kp.MID, c=64, o=64)
    assert a['w3'].shape == (128, 1024, 64)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    plain = kp.fused_pairwise_conv_plain(t['h'], t['w3'], t['v2'], t['b3'])
    ref = torch.from_numpy(np.asarray(jax_fwd(
        jnp.asarray(a['h']), jnp.asarray(a['w3']), a['v2'], b3=a['b3'],
        interpret=True)))
    split = _split_product(t['h'], t['w3'], t['v2'], t['b3'])
    scale = plain.abs().max()
    for other in (plain, ref):
        err = (split - other).abs().max()
        assert 0 < err <= KERNEL_RTOL * scale
    one_pass = _split_product(t['h'], t['w3'], t['v2'], t['b3'], passes=1)
    assert (one_pass - plain).abs().max() > KERNEL_RTOL * scale


def _bwd_a_split(h, w3, v2, g, b3, passes=3, tile=kp.EDGE_TILE):
    """The float32 arithmetic of kernel A (csrc/pairwise_bwd.cu), emulated
    in torch: R = h_hi.W_hi + h_hi.W_lo + h_lo.W_hi + b3 (passes=3; bf16
    products are exact in float32, sums float32), dV2 = g.R^T and dR =
    V2^T.g in float32, dR split into bf16 hi + lo, and dW3 summed over
    64-edge tiles, each tile's h_hi^T.dR_hi + h_hi^T.dR_lo + h_lo^T.dR_hi
    in a fresh sum added to the running one; passes=1 keeps h_hi.W_hi and
    h_hi^T.dR_hi alone. -> (dw3, dv2, db3)."""
    E, mid = h.shape
    _, IF, O = w3.shape
    hh, hl = _bf16_split(h)
    wh, wl = (t.reshape(mid, IF * O) for t in _bf16_split(w3))
    R = hh @ wh
    if passes == 3:
        R = R + hh @ wl + hl @ wh
    R = R.reshape(E, IF, O) + b3
    dv2 = torch.bmm(g, R.transpose(1, 2))
    dR = torch.bmm(v2.transpose(1, 2), g).reshape(E, IF * O)
    dh_, dl_ = _bf16_split(dR)
    dw3 = torch.zeros(mid, IF * O)
    for e0 in range(0, E, tile):
        a_hi, a_lo = hh[e0:e0 + tile].t(), hl[e0:e0 + tile].t()
        d_hi, d_lo = dh_[e0:e0 + tile], dl_[e0:e0 + tile]
        part = a_hi @ d_hi
        if passes == 3:
            part = part + a_hi @ d_lo + a_lo @ d_hi
        dw3 = dw3 + part
    return dw3.reshape(mid, IF, O), dv2, dR.reshape(E, IF, O).sum(0)


def test_kernel_a_float32_passes_meet_the_kernel_bar():
    """Kernel A's float32 arithmetic on the tensor cores (three bf16
    passes for R and for dW3, dR as bf16 hi + lo, per-tile sums) on a few
    hundred edges at the flagship's largest grouped shape (mid 128, IF
    1024, O 64, P 7) is within KERNEL_RTOL of max|plain| of
    fused_pairwise_conv_bwd_a_plain for dW3, dV2 and dB3, so the card's
    kernel has its error budget before it runs; one pass is not."""
    a = _grouped_operands(3, 4, seed=43, e=300, mid=kp.MID, c=64, o=64)
    assert a['w3'].shape == (128, 1024, 64)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    g = torch.from_numpy(np.random.RandomState(44).normal(
        size=(300, 7, 64)).astype(np.float32))
    plain = kp.fused_pairwise_conv_bwd_a_plain(t['h'], t['w3'], t['v2'], g,
                                               t['b3'])
    split = _bwd_a_split(t['h'], t['w3'], t['v2'], g, t['b3'])
    for name, got, ref in zip(('dw3', 'dv2', 'db3'), split, plain):
        assert got.shape == ref.shape, name
        assert (got - ref).abs().max() <= KERNEL_RTOL * ref.abs().max(), name
    assert (split[0] - plain[0]).abs().max() > 0
    one_pass = _bwd_a_split(t['h'], t['w3'], t['v2'], g, t['b3'], passes=1)
    assert (one_pass[0] - plain[0]).abs().max() \
        > KERNEL_RTOL * plain[0].abs().max()


# every (E, IF) at which chip_smoke.py runs kernel A: the flagship_fast
# pairs (IF = 64 F, whole and ragged E) and the flagship's grouped output
# degrees (per node chunk and unchunked)
SMOKE_A_SHAPES = ([(E_, 64 * F) for E_ in (32768, 32731) for F in (1, 3, 5, 7)]
                  + [(E_, IF) for E_ in (4096, 32768)
                     for IF in (256, 640, 896, 1024)])


@pytest.mark.parametrize('E_,IF', SMOKE_A_SHAPES)
def test_kernel_a_grid_is_a_function_of_the_shapes(E_, IF):
    """Kernel A's grid (ceil(IF / 2) CTAs along i times bwd_splits edge
    ranges) depends on E and IF alone, so its partial sums and their
    reduce order, and so dW3 and dB3 bit for bit, are the same on every
    run: recomputed from scratch it is the same, and the edge ranges cover
    every 64-edge tile, each at least one."""
    splits = kp.bwd_splits(E_, IF)
    kp.bwd_splits.cache_clear()
    assert kp.bwd_splits(E_, IF) == splits
    n_tiles = -(-E_ // kp.EDGE_TILE)
    per_split = -(-n_tiles // splits)
    assert 1 <= splits <= n_tiles
    assert (splits - 1) * per_split < n_tiles <= splits * per_split


def _bwd_b_split(w3, v2, g, passes=3, chunk=2):
    """The float32 arithmetic of kernel B (csrc/pairwise_bwd.cu), emulated
    in torch: dR = V2^T.g in float32, dR and W3 split into bf16 hi + lo,
    and dH summed over chunks of `chunk` values of i (K = chunk x O, the
    kernel's CI), each chunk's dR_hi.W_hi^T + dR_lo.W_hi^T + dR_hi.W_lo^T
    (passes=3; bf16 products are exact in float32, sums float32) in a fresh
    sum added to the running one; passes=1 keeps dR_hi.W_hi^T alone."""
    mid, IF, O = w3.shape
    E = v2.shape[0]
    d_hi, d_lo = _bf16_split(torch.bmm(v2.transpose(1, 2), g))
    w_hi, w_lo = _bf16_split(w3)
    dh = torch.zeros(E, mid)
    for i0 in range(0, IF, chunk):
        a_hi, a_lo = (t[:, i0:i0 + chunk].reshape(E, -1) for t in (d_hi, d_lo))
        b_hi, b_lo = (t[:, i0:i0 + chunk].reshape(mid, -1).t()
                      for t in (w_hi, w_lo))
        part = a_hi @ b_hi
        if passes == 3:
            part = part + a_lo @ b_hi + a_hi @ b_lo
        dh = dh + part
    return dh


def test_kernel_b_float32_passes_meet_the_kernel_bar():
    """Kernel B's float32 arithmetic on the tensor cores (dR and W3 as bf16
    hi + lo, three passes, a fresh sum per chunk of 2 i) on a few hundred
    edges at the flagship's largest grouped shape (mid 128, IF 1024, O 64,
    P 7) is within KERNEL_RTOL of max|plain| of
    fused_pairwise_conv_bwd_b_plain, so the card's kernel has its error
    budget before it runs; one pass is not."""
    a = _grouped_operands(3, 4, seed=45, e=300, mid=kp.MID, c=64, o=64)
    assert a['w3'].shape == (128, 1024, 64)
    w3, v2 = torch.from_numpy(a['w3']), torch.from_numpy(a['v2'])
    g = torch.from_numpy(np.random.RandomState(46).normal(
        size=(300, 7, 64)).astype(np.float32))
    plain = kp.fused_pairwise_conv_bwd_b_plain(w3, v2, g)
    split = _bwd_b_split(w3, v2, g)
    assert split.shape == plain.shape == (300, 128)
    scale = plain.abs().max()
    assert 0 < (split - plain).abs().max() <= KERNEL_RTOL * scale
    one_pass = _bwd_b_split(w3, v2, g, passes=1)
    assert (one_pass - plain).abs().max() > KERNEL_RTOL * scale


def _bxf_split(h, w3, basis_flat, x, pqf, b3, passes=3):
    """The float32 arithmetic of kernels #1 and #2 (csrc/pairwise_bxf.cu),
    emulated in torch: V2 in float32, h and W3 split into bf16 hi and lo, R
    = h_hi.W_hi + h_hi.W_lo + h_lo.W_hi (passes=3; products of bf16 values
    are exact in float32, sums float32) or h_hi.W_hi alone (passes=1), plus
    b3, then the float32 apply."""
    P, Q, F = pqf
    E, mid = h.shape
    C = x.shape[1]
    O = w3.shape[-1]
    v2 = torch.einsum('epfq,ecq->epcf', basis_flat.reshape(E, P, F, Q),
                      x).reshape(E, P, C * F)
    hh, hl = _bf16_split(h)
    wh, wl = (t.reshape(mid, C * F * O) for t in _bf16_split(w3))
    R = hh @ wh
    if passes == 3:
        R = R + hh @ wl + hl @ wh
    return torch.bmm(v2, R.reshape(E, C * F, O) + b3)


def test_bxf_float32_passes_meet_the_kernel_bar():
    """Kernel #1's float32 arithmetic on the tensor cores (three bf16
    passes over h and W3 split into hi + lo) on a few hundred edges at the
    flagship's (3,3) pair (mid 128, C 64, O 64, P = Q = F = 7) is within
    KERNEL_RTOL of max|plain| of fused_pairwise_conv_bxf_plain, so the
    card's float32 kernel has its error budget before it runs; one bf16
    pass is not."""
    a = _operands(3, 3, seed=47, e=300, mid=kp.MID, c=64, o=64)
    assert a['w3'].shape == (128, 448, 64)
    t = {k: torch.from_numpy(a[k]) for k in ('h', 'w3', 'basis', 'x', 'b3')}
    args = (t['h'], t['w3'], t['basis'], t['x'], a['pqf'], t['b3'])
    plain = kp.fused_pairwise_conv_bxf_plain(*args)
    split = _bxf_split(*args)
    assert split.shape == plain.shape == (300, 7, 64)
    scale = plain.abs().max()
    assert 0 < (split - plain).abs().max() <= KERNEL_RTOL * scale
    one_pass = _bxf_split(*args, passes=1)
    assert (one_pass - plain).abs().max() > KERNEL_RTOL * scale


@pytest.mark.parametrize('dtype', kp.DTYPES)
@pytest.mark.parametrize('P,Q', [(P_, Q_) for P_ in kp.ORDERS
                                 for Q_ in kp.ORDERS])
def test_bxf_tiles_are_a_function_of_the_shapes(P, Q, dtype):
    """Kernels #1 and #2 take their chunk of i (one barrier each) and their
    V2 stage from (P, Q, dtype) alone, so their sums, and so their output
    bit for bit, are the same on every run and for both basis layouts; a
    stage is a whole number of chunks, at least 3 (its x rows, issued in
    the previous stage's first chunk, land before its first chunk), and the
    float32 chunk is one i (its three bf16 passes make it as long)."""
    chunk, stage_c = kp.bxf_tiles(P, Q, dtype)
    assert kp.bxf_tiles(P, Q, dtype) == (chunk, stage_c)
    F = min(P, Q)
    assert chunk == (2 if dtype == torch.bfloat16 else 1)
    assert (stage_c * F) % chunk == 0 and stage_c * F // chunk >= 3
    assert stage_c in (chunk, 3 * chunk)


@pytest.mark.parametrize('do,n_in,dtype', [(1, 3, 'float32'),
                                           (3, 2, 'bfloat16')])
def test_contract_op_matches_jax_vjp(do, n_in, dtype):
    """pairwise_contract's autograd against jax.vjp of the JAX custom_vjp
    _pairwise_contract_pallas (_pc_fwd/_pc_bwd, kernels in interpret
    mode): dh and dw3 in the dtypes of h and w3, db3 and dv2 in float32."""
    a = _grouped_operands(do, n_in, seed=400 + 10 * do + n_in)
    P = 2 * do + 1
    g = np.random.RandomState(8).normal(size=(E, P, O)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def f(h, w3, b3, v2):
        return _pairwise_contract_pallas(h, w3, b3, v2, True, None)
    _, vjp = jax.vjp(f, jnp.asarray(a['h'], jdt), jnp.asarray(a['w3'], jdt),
                     jnp.asarray(a['b3']), jnp.asarray(a['v2']))
    refs = vjp(jnp.asarray(g))

    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a['h']).to(tdt).requires_grad_(),
              torch.from_numpy(a['w3']).to(tdt).requires_grad_(),
              torch.from_numpy(a['b3']).requires_grad_(),
              torch.from_numpy(a['v2']).requires_grad_()]
    kp.pairwise_contract(*leaves).backward(torch.from_numpy(g))
    for name, leaf, ref in zip(('dh', 'dw3', 'db3', 'dv2'), leaves, refs):
        ref = np.asarray(ref.astype(jnp.float32))
        assert leaf.grad.dtype == leaf.dtype, name
        tol = BF16_GRAD_RTOL if leaf.dtype == torch.bfloat16 else RTOL
        err = np.abs(leaf.grad.float().numpy() - ref).max()
        assert err <= tol * np.abs(ref).max(), name


# ---------------------------------------------------------------------- #
# kernel #2: the basis-fused forward with the structured basis
# ---------------------------------------------------------------------- #
def _structured(a):
    """_operands with the basis in get_basis's [E, P, Q, F] layout."""
    P, Q, F = a['pqf']
    return a['basis'].reshape(-1, P, F, Q).transpose(0, 1, 3, 2).copy()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('di,do', [(0, 0), (1, 2), (3, 1), (2, 3), (3, 3)])
def test_bx_plain_matches_jax_interpret_kernel(di, do, dtype):
    """fused_pairwise_conv_bx_plain against the JAX fused_pairwise_conv_bx
    (the _fwd_bx_kernel body with the structured basis, interpret mode)."""
    a = _operands(di, do, seed=500 + 10 * di + do)
    basis = _structured(a)
    ref = np.asarray(jax_bx(jnp.asarray(a['h'], dtype),
                            jnp.asarray(a['w3'], dtype), basis, a['x'],
                            b3=a['b3'], interpret=True))
    tdt = getattr(torch, dtype)
    out = kp.fused_pairwise_conv_bx(
        torch.from_numpy(a['h']).to(tdt), torch.from_numpy(a['w3']).to(tdt),
        torch.from_numpy(basis), torch.from_numpy(a['x']),
        torch.from_numpy(a['b3'])).numpy()
    assert out.shape == ref.shape == (E, 2 * do + 1, O)
    assert np.abs(out - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize('di,do', [(2, 1), (1, 3)])
def test_bx_op_matches_jax_vjp(di, do):
    """pairwise_contract_bx's autograd (V2 rebuilt, the fused backward,
    then dx and dbasis by einsum) against jax.vjp of the JAX custom_vjp
    _pairwise_contract_pallas_bx (_pc_bx_fwd/_pc_bx_bwd, interpret-mode
    kernels): the gradients of h, w3, b3, the basis and x."""
    a = _operands(di, do, seed=600 + 10 * di + do)
    basis = _structured(a)
    P = a['pqf'][0]
    g = np.random.RandomState(9).normal(size=(E, P, O)).astype(np.float32)
    vals = (a['h'], a['w3'], a['b3'], basis, a['x'])
    _, vjp = jax.vjp(lambda *t: _pairwise_contract_pallas_bx(*t, True, None),
                     *map(jnp.asarray, vals))
    refs = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(v).requires_grad_() for v in vals]
    kp.pairwise_contract_bx(*leaves).backward(torch.from_numpy(g))
    for name, leaf, ref in zip(('dh', 'dw3', 'db3', 'dbasis', 'dx'), leaves,
                               refs):
        ref = np.asarray(ref)
        assert leaf.grad.shape == ref.shape, name
        err = np.abs(leaf.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), name


@pytest.mark.parametrize('deg_in,deg_out,pool', [(2, 2, True), (3, 2, False)])
def test_conv_takes_the_structured_basis_as_jax_does(deg_in, deg_out, pool):
    """The repaired fault: the JAX ConvSE3 with fuse_basis=True takes
    get_basis's default structured layout (on the CPU through its einsum
    path, on a TPU through kernel #2), and the port raised on it. The port
    now contracts it through pairwise_contract_bx, float32 trunk, within
    1e-4 of the output's largest magnitude."""
    rng = np.random.RandomState(deg_in + 3 * deg_out)
    b, n, k = 1, 9, 4
    fin, fout = Fiber.create(deg_in, 3), Fiber.create(deg_out, 5)
    feats = {str(d): rng.normal(size=(b, n, c, 2 * d + 1)).astype(np.float32)
             for d, c in fin}
    idx = rng.randint(0, n, size=(b, n, k)).astype(np.int32)
    mask = rng.rand(b, n, k) > 0.25
    rel_pos = rng.normal(size=(b, n, k, 3)).astype(np.float32)
    rel_dist = np.linalg.norm(rel_pos, axis=-1).astype(np.float32)
    max_degree = max(deg_in, deg_out) - 1
    jmod = JConv(JFiber.create(deg_in, 3), JFiber.create(deg_out, 5),
                 shared_radial_hidden=True, fuse_basis=True, pool=pool,
                 self_interaction=pool)
    j_args = ({d: jnp.asarray(v) for d, v in feats.items()},
              (jnp.asarray(idx), jnp.asarray(mask), None),
              jnp.asarray(rel_dist),
              jax_get_basis(jnp.asarray(rel_pos), max_degree, layout='pqf'))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              *j_args))['params']
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(s.shape[0]))
        .astype(np.float32), shapes)
    ref = jmod.apply({'params': params}, *j_args)
    conv = ConvSE3(fin, fout, fuse_basis=True, pool=pool,
                   self_interaction=pool, shared_radial_hidden=True)
    conv.load_state_dict(convert_flax_params(params, conv))
    with torch.no_grad():
        out = conv({d: torch.from_numpy(v) for d, v in feats.items()},
                   (torch.from_numpy(idx).long(),
                    torch.from_numpy(mask), None),
                   torch.from_numpy(rel_dist),
                   get_basis(torch.from_numpy(rel_pos), max_degree,
                             layout='pqf'))
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    assert set(out) == set(ref)
    for d in ref:
        assert out[d].shape == ref[d].shape
        assert np.abs(out[d].numpy() - np.asarray(ref[d])).max() \
            <= 1e-4 * scale, d
