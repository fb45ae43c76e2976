"""FLOP accounting: the analytic count of a training step, the card's
peaks, and the per-kernel cost model that sets every kernel's bound.

The analytic model is the port of se3_transformer_tpu/utils/flops.py
(conv_flops, linear_flops, train_step_flops_estimate) for the port's
SE3TransformerModule: multiply-adds (x2) of the terms that matter, the
per-edge radial trunk and radial weight application, the basis and
feature contractions, attention's similarity and weighted sum, and the
degree-wise linear layers; a step is 4x the forward with reversible blocks
(forward, recompute, ~2x backward), else 3x. It counts the work the
hand-written kernels do, which a profiler's op counters cannot see.

The peaks (PEAKS, peaks_for) are the card's, from NVIDIA's data sheets,
found by device name: bf16 tensor-core and float32 CUDA-core FLOP/s and
the device memory rate. They replace the JAX module's TPU peak.

The kernel costs (pairwise_cost, fwd_cost, fwd_q_cost,
pairwise_bwd_cost, attention_cost, flash_cost, global_cost) give each
hand-written kernel's bound: the larger of the bytes it must move (each
input read once, each output written once) over the memory rate and its
operations over the peak of the pipe they run on. chip_smoke.py reads
them for every kernel's `bound_ms`; a benchmark reads the same yardstick.
"""
from __future__ import annotations

from ..ops.fiber import Fiber
from .helpers import to_order

# the radial trunk width (ops/conv.py's DEFAULT_MID_DIM)
MID = 128

# published dense peaks by card (NVIDIA data sheets): bf16 tensor core,
# float32 CUDA core (FLOP/s), device memory bandwidth (bytes/s)
PEAKS = {
    'H100 PCIe': (756e12, 51e12, 2.0e12),
    'H100': (989e12, 67e12, 3.35e12),
    'H200': (989e12, 67e12, 4.8e12),
}

# the trunk's LayerNorm and GELU, counted per element on the CUDA cores:
# LN 7 (the mean 1, the centered square 3, the normalization 3) and GELU 9
# (its cubic and scale 5, tanh counted as 1, the product 3)
LN_GELU_OPS = 16

# a pair's frame from its offset on the CUDA cores (common.cuh,
# so2_edge_frame): the normalization and rho (~20) and the two angle
# recursions (6 a step, to degree 3)
SO2_FRAME_OPS = 20 + 2 * 6 * 3


def peaks_for(name: str):
    """(the PEAKS key, its peaks) of a card by device name; an unknown
    name (the CPU included) is taken for an H100 SXM."""
    for key in ('H100 PCIe', 'H200', 'H100'):
        if key in name:
            return key, PEAKS[key]
    return 'H100 (assumed)', PEAKS['H100']


# --------------------------------------------------------------------- #
# the analytic model of a step
# --------------------------------------------------------------------- #
def conv_flops(fiber_in, fiber_out, E: int, shared_trunk: bool = True
               ) -> float:
    """One ConvSE3 application over E edges (the fused formulation)."""
    total = 0.0
    # shared trunk: one 2-layer mid x mid MLP per edge; unshared: one per
    # degree pair
    n_trunks = 1 if shared_trunk else (
        sum(1 for _ in fiber_in) * sum(1 for _ in fiber_out))
    total += n_trunks * 2 * E * 2 * MID * MID
    for d_out, c_out in fiber_out:
        P = to_order(d_out)
        for d_in, c_in in fiber_in:
            Q = to_order(d_in)
            F = to_order(min(d_in, d_out))
            # radial weight apply: h[mid] @ w3[mid, c_in*F, c_out]
            total += 2 * E * MID * c_in * F * c_out
            # v2 = basis . x  and  out = v2 . R
            total += 2 * E * P * Q * F * c_in
            total += 2 * E * P * c_in * F * c_out
    return total


def linear_flops(fiber_in, fiber_out, N: int) -> float:
    """LinearSE3 over N nodes: per shared degree, [c_in -> c_out] x m."""
    total = 0.0
    fo = {d: c for d, c in fiber_out}
    for d_in, c_in in fiber_in:
        if d_in in fo:
            total += 2 * N * c_in * fo[d_in] * to_order(d_in)
    return total


def forward_flops_estimate(module, n: int, k: int, batch: int = 1) -> float:
    """The forward's FLOPs for an SE3TransformerModule on [batch, n] nodes
    with k neighbors (train_step_flops_estimate's forward term)."""
    E = batch * n * (k + (1 if module.attend_self else 0))
    N = batch * n
    num_degrees = module.num_degrees
    dim = module.dim
    hidden = Fiber.create(num_degrees, dim) \
        if module.hidden_fiber_dict is None \
        else Fiber(module.hidden_fiber_dict)
    kv_dim = module.dim_head * module.heads
    kv = Fiber.create(num_degrees, kv_dim)
    shared = module.shared_radial_hidden

    fwd = 0.0
    # conv_in: input degrees -> hidden
    in_fiber = Fiber.create(module.input_degrees, dim)
    fwd += conv_flops(in_fiber, hidden, E, shared)
    fwd += module.num_conv_layers * conv_flops(hidden, hidden, E, shared)

    if not module.use_egnn:
        convs_per_block = 1 if (module.tie_key_values
                                or module.linear_proj_keys) else 2
        att_lin = (linear_flops(hidden, kv, N) * 2          # q + self-k/v-ish
                   + linear_flops(kv, hidden, N))           # to_out
        # sim + weighted sum: per degree 2 * E * h * dim_head * m, twice
        att_einsum = sum(4 * E * module.heads * module.dim_head
                         * to_order(d) for d in range(num_degrees))
        # feed-forward block: two LinearSE3 at mult=4
        ff_hidden = Fiber.create(num_degrees, dim * 4)
        ff = linear_flops(hidden, ff_hidden, N) \
            + linear_flops(ff_hidden, hidden, N)
        fwd += module.depth * (convs_per_block
                               * conv_flops(hidden, kv, E, shared)
                               + att_lin + att_einsum + ff)
    # conv_out
    out_fiber = Fiber.create(module.output_degrees or num_degrees, dim) \
        if module.out_fiber_dict is None else Fiber(module.out_fiber_dict)
    fwd += conv_flops(hidden, out_fiber, E, shared)
    return fwd


def train_step_flops_estimate(module, n: int, k: int, batch: int = 1
                              ) -> float:
    """Training-step FLOPs for an SE3TransformerModule on [batch, n] nodes
    with k neighbors: the forward once, times the step multiplier
    (reversible: 4x, forward + recompute + ~2x backward; else 3x)."""
    mult = 4.0 if module.reversible else 3.0
    return mult * forward_flops_estimate(module, n, k, batch)


# --------------------------------------------------------------------- #
# the kernels' cost model
# --------------------------------------------------------------------- #
def pairwise_cost(E, mid, C, O, P, Q, F, h_bytes, peaks, v_bytes=4):
    """(bound_ms, bound_by, flops, bound_ms_fma) of one
    fused_pairwise_conv_bxf call: each input read once (the basis and x at
    v_bytes a value: 2 for conv_bf16's storage), the output written
    once. The V2 build and apply run at the float32 CUDA-core rate, beside
    the radial product on the tensor cores, so the operations take the
    longer of the two pipes: one bf16 pass, or with float32 h three (the
    kernel's h_hi.W_hi + h_hi.W_lo + h_lo.W_hi). bound_ms_fma is the bound
    of the float32 work all on fp32 FMAs (what the kernel's earlier
    float32 tile ran on)."""
    bf16_peak, f32_peak, mem = peaks
    radial = 2.0 * E * mid * C * F * O
    apply = 2.0 * E * P * C * F * O + 2.0 * E * P * F * C * Q
    passes = 1 if h_bytes == 2 else 3
    ops_s = max(passes * radial / bf16_peak, apply / f32_peak)
    nbytes = (E * mid * h_bytes + mid * C * F * O * h_bytes + C * F * O * 4
              + (E * P * F * Q + E * C * Q) * v_bytes + E * P * O * 4)
    bytes_s = nbytes / mem
    bound_by = 'operations' if ops_s >= bytes_s else 'bytes'
    fma_s = max((radial + apply) / f32_peak, bytes_s)
    return (max(ops_s, bytes_s) * 1e3, bound_by, radial + apply,
            fma_s * 1e3)


def fwd_cost(E, mid, IF, O, P, h_bytes, peaks, v_bytes=4):
    """(bound_ms, bound_by, flops, bound_ms_fma) of one fused_pairwise_conv
    call (V2 given) as the kernel does the work: each input read once (V2
    at v_bytes a value: 2 for conv_bf16's storage), the output written
    once. The radial product runs on the tensor cores, one
    bf16 pass for bf16 h/w3 and three (hi.hi, hi.lo, lo.hi of the operands
    split into bf16 hi + lo) for float32, while the apply runs on the
    float32 CUDA cores at the same time: the operations take the longer of
    the two pipes. bound_ms_fma is the float32 bound of the FMA tile the
    kernel replaced (product and apply both on the CUDA cores), for
    comparison. flops counts the product once."""
    bf16_peak, f32_peak, mem = peaks
    radial = 2.0 * E * mid * IF * O
    apply = 2.0 * E * P * IF * O
    passes = 1 if h_bytes == 2 else 3
    ops_s = max(passes * radial / bf16_peak, apply / f32_peak)
    fma_s = ops_s if h_bytes == 2 else (radial + apply) / f32_peak
    nbytes = (E * mid * h_bytes + mid * IF * O * h_bytes + IF * O * 4
              + E * P * IF * v_bytes + E * P * O * 4)
    bytes_s = nbytes / mem
    return max(ops_s, bytes_s) * 1e3, \
        'operations' if ops_s >= bytes_s else 'bytes', radial + apply, \
        max(fma_s, bytes_s) * 1e3


def fwd_q_cost(E, mid, IF, O, P, h_bytes, peaks):
    """(bound_ms, bound_by) of one call of #3's scaled arm: W3 read at one
    byte a value and its float32 scale beside b3, each input read once and
    the output written once; the radial product as the passes the arm
    needs (q is exact in bf16: two with float32 h, h_hi.q and h_lo.q, one
    with bf16 h) on the tensor cores, beside the apply and the scale's
    multiply on the CUDA cores."""
    bf16_peak, f32_peak, mem = peaks
    radial = 2.0 * E * mid * IF * O
    apply = 2.0 * E * P * IF * O + E * IF * O
    passes = 1 if h_bytes == 2 else 2
    ops_s = max(passes * radial / bf16_peak, apply / f32_peak)
    nbytes = (E * mid * h_bytes + mid * IF * O + 2 * IF * O * 4
              + E * P * IF * 4 + E * P * O * 4)
    bytes_s = nbytes / mem
    return max(ops_s, bytes_s) * 1e3, \
        'operations' if ops_s >= bytes_s else 'bytes'


def pairwise_bwd_cost(kernel, E, mid, IF, O, P, h_bytes, peaks, v_bytes=4):
    """(bound_ms, bound_by, bound_ms_fma) of backward kernel 'a' (R
    recompute, dV2, dR, dW3, dB3) or 'b' (dR, dH) as the kernels do the
    work: each input read once (V2 at v_bytes a value: 2 for conv_bf16's
    storage; dV2 is written float32), each output written once. The products run
    on the tensor cores at the bf16 rate while the P-contractions and dB3
    run on the float32 CUDA cores at the same time: the operations take the
    longer of the two pipes. Kernel A: with bf16 h/w3 the R recompute is
    one pass and dW3 two (dR split into bf16 hi and lo); with float32 h/w3
    both are three (hi.hi, hi.lo, lo.hi of the operands split into bf16 hi
    + lo). Kernel B: dH is two passes with bf16 w3 (dR split into bf16 hi
    and lo) and three with float32 w3 (dR_hi.W_hi, dR_lo.W_hi, dR_hi.W_lo).
    bound_ms_fma is the bound of every product on fp32 FMAs beside the
    P-contractions (the float32 kernels A and B as they first ran), for
    comparison."""
    bf16_peak, f32_peak, mem = peaks
    radial = 2.0 * E * mid * IF * O
    pcontract = 2.0 * E * P * IF * O
    if kernel == 'a':
        passes = 3 if h_bytes == 2 else 6
        cuda = 2 * pcontract + E * IF * O
        fma_ops = radial * 2 + cuda
        nbytes = (E * mid * h_bytes + mid * IF * O * h_bytes + IF * O * 4
                  + E * P * IF * (v_bytes + 4) + E * P * O * 4
                  + mid * IF * O * 4 + IF * O * 4)
    else:
        passes = 2 if h_bytes == 2 else 3
        cuda = pcontract
        fma_ops = radial + pcontract
        nbytes = (mid * IF * O * h_bytes + E * P * IF * v_bytes
                  + E * P * O * 4 + E * mid * 4)
    ops_s = max(passes * radial / bf16_peak, cuda / f32_peak)
    bytes_s = nbytes / mem
    return max(ops_s, bytes_s) * 1e3, \
        'operations' if ops_s >= bytes_s else 'bytes', \
        max(fma_ops / f32_peak, bytes_s) * 1e3


def attention_cost(BH, n, J, D, bwd, peaks):
    """(bound_ms, bound_by) of the fused attention forward or backward at
    group 1 and batch 1: each input read once (q, k, v, the [1, n, J]
    mask; g in the backward), each output written once (out; dq, dk, dv).
    The operations (scores, softmax, weighted sum; their derivatives) run
    at the float32 CUDA-core rate."""
    _, f32_peak, mem = peaks
    rows = BH * n
    if bwd:
        nbytes = 4 * rows * (3 * D + 4 * J * D) + n * J
        ops = rows * (8 * J * D + 12 * J)
    else:
        nbytes = 4 * rows * (2 * D + 2 * J * D) + n * J
        ops = rows * (4 * J * D + 5 * J)
    ops_s, bytes_s = ops / f32_peak, nbytes / mem
    return max(ops_s, bytes_s) * 1e3, \
        'operations' if ops_s >= bytes_s else 'bytes'


def so2_rotation_ops(l):
    """Operations of one factored Wigner rotation of degree l (common.cuh,
    so2_rotate_in / so2_rotate_out): two J_l matvecs (2 N^2 each) and two
    Dz passes (4 N each), N = 2 l + 1; none at l = 0."""
    N = 2 * l + 1
    return 0.0 if l == 0 else 4.0 * N * N + 8.0 * N


def so2_basis_ops(d_in, d_out):
    """Operations of the so2 arm's basis of one pair at one edge
    (common.cuh, so2_basis_row, per output row p): a rotation in at d_out,
    then per frequency the band (1 + 6 M) and a rotation out at d_in."""
    P, M = 2 * d_out + 1, min(d_in, d_out)
    F = 2 * M + 1
    return P * (so2_rotation_ops(d_out)
                + F * (1.0 + 6.0 * M + so2_rotation_ops(d_in)))


def basis_ops(d_in, d_out, arm):
    """Operations of one pair's basis at one edge: the dense arm's SH x
    Q_J contraction, or the so2 arm's rotations and band."""
    if arm == 'so2':
        return so2_basis_ops(d_in, d_out)
    P, Q = 2 * d_out + 1, 2 * d_in + 1
    return sum(2.0 * P * Q * (2 * J + 1)
               for J in range(abs(d_in - d_out), d_in + d_out + 1))


def flash_cost(n, K, pairs, d_out, heads, Dh, S, S0, h_bytes, peaks,
               convs=2, arm='dense', scaled=False):
    """(bound_ms, bound_by, flops, bound_ms_fma) of one flash_attention
    call: each input read once (q, the node features, idx, the mask, h_k
    and h_v, both convs' w3 and b3, the SH stack, the prefix slots), the
    output written once. The operations: the radial products of k and v on
    the tensor cores as bf16 passes over W3 split into hi + lo (two with
    bf16 h, three with float32 h: the kernel's h.W_hi + h.W_lo [+
    h_lo.W_hi]), beside the float32 work on the CUDA cores (the basis and
    V2 once, the applies of k and v, the attention); the operations take
    the longer of the two pipes. bound_ms_fma is the bound with all of it
    on fp32 FMAs (what the kernel's earlier version ran). convs=1 is the
    tied call: one h, one w3 and b3, one radial product and apply.
    arm='so2': the basis by the so2 arm's rotations (so2_basis_ops) from
    the frames (S = 4 L1 floats an edge) in place of the SH stack's.
    scaled: the scaled arm (quantized W3: one byte a value, and a float32
    scale beside b3; no lo half, so one bf16 pass with bf16 h, two with
    float32 h, and the scale's multiply on the CUDA cores)."""
    bf16_peak, f32_peak, mem = peaks
    E, mid, O, P = n * K, 128, 64, 2 * d_out + 1
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in pairs)
    basis = v2 = 0.0
    for d, c in pairs:
        F = 2 * min(d, d_out) + 1
        basis += E * basis_ops(d, d_out, arm)
        v2 += 2.0 * E * P * c * F * (2 * d + 1)
    radial = convs * 2.0 * E * mid * IF * O
    apply = convs * (2.0 * E * P * IF * O + (E * IF * O if scaled else 0))
    attn = 4.0 * n * heads * (S0 + K) * Dh
    flops = basis + v2 + radial + apply + attn
    passes = (2 if h_bytes == 2 else 3) - scaled
    # W3 (1 or 4 bytes a value), b3 and the scale (4 bytes each)
    w3_bytes = convs * ((mid + 8) * IF * O if scaled
                        else (mid + 1) * IF * O * 4)
    nbytes = (2 * n * heads * Dh * 4 + sum(n * c * (2 * d + 1) * 4
                                           for d, c in pairs)
              + E * 8 + E + convs * E * mid * h_bytes + w3_bytes
              + E * S * 4 + 2 * n * S0 * heads * Dh * 4)
    ops_s = max(passes * radial / bf16_peak,
                (basis + v2 + apply + attn) / f32_peak)
    bytes_s = nbytes / mem
    fma_s = max(flops / f32_peak, bytes_s)
    return max(ops_s, bytes_s) * 1e3, \
        'operations' if ops_s >= bytes_s else 'bytes', flops, fma_s * 1e3


def global_cost(n, pairs, d_out, heads, dim_head, S0, peaks, nodes=8,
                cluster=2, trunks=2, arm='dense'):
    """(bound_ms, bound_by, flops, bound_ms_fma, w_l2_gb) of one
    flash_global_attention call over all n^2 pairs: each input read once
    (q, the node features, the coordinates and mask, both trunks'
    parameters, both convs' w3 and b3, the prefix slots), the output
    written once. The operations run on two pipes and take the longer:
    the tensor cores, both trunks' Dense_1 (2 * 2 * 128 * 128 per pair) and
    the k and v radial products (2 * 2 * 128 * IF * O) as three bf16 passes
    each over float32 operands split into hi + lo (the kernel's h_hi.W_hi
    + h_hi.W_lo + h_lo.W_hi); the CUDA cores in float32, both trunks'
    Dense_0 (2 * 2 * 128), LayerNorms and GELUs (2 * 2 * 128 elements at
    LN_GELU_OPS each), the basis and V2, the k and v applies, the scores
    and the weighted sum. flops counts every product once.
    bound_ms_fma: the bound with Dense_1, the basis, V2, the radial
    products, the applies and the attention all on fp32 FMAs (the
    kernel's earlier version). w_l2_gb: the bytes of W2 and W3 (both
    trunks, bf16 hi + lo, W3's i padded to 4 a stage) and b3 that the
    kernel reads from L2: once per block of 16 kv nodes for each cluster
    of `cluster` CTAs of `nodes` query nodes (a tile of 128 pairs a CTA,
    each stage multicast to the cluster). trunks=1 is the tied call: one
    trunk, one w3 and b3, one radial product and apply. arm='so2': each
    pair's frame and the so2 arm's basis (so2_basis_ops) in place of the
    harmonics' basis."""
    bf16_peak, f32_peak, mem = peaks
    mid, P = 128, 2 * d_out + 1
    O = heads * dim_head
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in pairs)
    dense1 = trunks * 2.0 * mid * mid
    radial = trunks * 2.0 * mid * IF * O
    basis_v2 = SO2_FRAME_OPS if arm == 'so2' else 0.0
    for d, c in pairs:
        F = 2 * min(d, d_out) + 1
        basis_v2 += basis_ops(d, d_out, arm) + 2.0 * P * c * F * (2 * d + 1)
    apply = trunks * 2.0 * P * IF * O
    attn = 4.0 * O * P
    trunk = trunks * (2.0 * mid + 2 * mid * LN_GELU_OPS)
    pairs_n = float(n) * n
    fma_flops = (dense1 + basis_v2 + radial + apply + attn) * pairs_n
    flops = fma_flops + trunk * pairs_n
    Dh = dim_head * P
    nbytes = 4 * (2 * n * heads * Dh + sum(n * c * (2 * d + 1)
                                           for d, c in pairs)
                  + 3 * n + trunks * (7 * mid + mid * mid)
                  + trunks * (mid + 1) * IF * O + 2 * n * S0 * heads * Dh) + n
    bytes_s = nbytes / mem
    ops_s = max(3 * (dense1 + radial) * pairs_n / bf16_peak,
                (basis_v2 + apply + attn + trunk) * pairs_n / f32_peak)
    fma_s = max(fma_flops / f32_peak, bytes_s)
    IF4 = -(-IF // 4) * 4
    tiles = -(-n // (nodes * cluster)) * -(-n // 16)
    w_l2_gb = tiles * trunks * (2 * mid * (mid + IF4 * O) * 2
                                + IF4 * O * 4) / 1e9
    return max(ops_s, bytes_s) * 1e3, \
        'operations' if ops_s >= bytes_s else 'bytes', flops, fma_s * 1e3, \
        w_l2_gb
