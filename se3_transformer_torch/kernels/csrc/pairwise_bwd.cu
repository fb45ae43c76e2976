// Backward of the basis-fused pairwise convolution for Hopper (sm_90a).
//
// Forward (pairwise_bxf.cu):  out[e, p, o] = sum_i V2[e, p, i] * R[e, i, o],
// R[e, i, o] = sum_m h[e, m] * W3[m, i, o] + b3[i, o], i = c*F + f.
// Given g = d out, the cotangents are
//   dV2[e, p, i] = sum_o g[e, p, o] * R[e, i, o]        (R includes b3)
//   dR [e, i, o] = sum_p V2[e, p, i] * g[e, p, o]
//   dW3[m, i, o] = sum_e h[e, m] * dR[e, i, o]
//   dB3[i, o]    = sum_e dR[e, i, o]
//   dH [e, m]    = sum_{i, o} dR[e, i, o] * W3[m, i, o]
//
// Replaces se3_transformer_tpu/kernels/pallas_pairwise.py::_bwd_a_kernel
// (kernel A here: dV2, dW3, dB3) and ::_bwd_b_kernel (kernel B: dH), driven
// by fused_pairwise_conv_bwd. As there, R and dR never reach device memory:
// at the (3,3) pair dR alone would be [E, 448, 64] float32, 3.7 GB at
// E = 32768. Inputs and outputs are float32 but for h/W3, which may be
// bf16 (the TPU kernels upcast those exactly).
//
// What bounds it on this card. Per hidden->hidden ConvSE3 (16 pairs,
// E = 32768, mid = 128, C = O = 64) the backward is three radial-sized
// products of 1.51 TFLOP each (the R recompute, dW3 and dH), ~0.17 TFLOP
// of P-contractions (dV2, and dR once in each kernel) and ~5 GB of V2 and
// dV2 traffic: compute-bound. The products run on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate) on exact bf16 operands. dW3 =
// h^T.dR and dH = dR.W3^T multiply the float32 dR, which one bf16 pass
// would round to 2^-9 relative and miss the 1e-4 tolerance; so dR is split
// into bf16 hi + lo (hi = bf16(dR), lo = bf16(dR - hi), together within
// 2^-17 of dR) and each product runs as one mma.sync pass per half. Both
// kernels split float32 h and W3 the same way (split_bf16_kernel, once per
// launch) and run each float32 product x.y as the passes x_hi.y_hi +
// x_hi.y_lo + x_lo.y_hi, as pairwise_fwd.cu does: no product of either
// kernel runs on fp32 FMAs. The P-contractions run on the CUDA cores.
//
// Kernel A (grid: ceil(IF / 2) CTAs along i x edge splits, bwd_splits in
// kernels/pairwise.py; 8 warps, one CTA per SM).
//  * What held the previous version back (PERF.md, PR 9: timing-only
//    variants of it on an H100). Every CTA read each g row from L2 once per
//    value of i, in dependent __ldg chains at 8 warps per SM: g from a
//    constant made the bf16 kernel 34-38% faster, and with g, V2 and the
//    dV2 stores all off the path it ran in a third to a half of the time.
//    The float32 kernel spent 71% of its time in its two fp32-FMA products.
//  * A CTA owns 2 values of i and a contiguous range of 64-edge tiles. Its
//    W3[:, i, :] slices are staged once; h and V2[tile, :, i0 .. i0 + 1]
//    are staged a tile ahead (16- and 8-byte cp.async, two buffers). Per
//    tile it recomputes R = h . W3 + b3 for both values of i (per kk, h's
//    A fragments once for both), then walks g's P slices in p order: each
//    staged g value feeds dV2 (a register sum over o, then across the 4
//    lanes and the 2 O-warps, in a fixed order) and dR (a sum over p) of
//    both values of i, and a per-thread column sum of dR for dB3.
//  * g streams through a ring of slices g[tile, p, :], S - 1 ahead (6
//    stages for bf16; 2 for float32, whose h and W3 take twice the room).
//    A warp reads only its own 16 x 32 block of a slice, so it copies that
//    block itself (swizzled: conflict-free float2 reads) and waits on its
//    own copies: no barrier of the whole CTA per slice.
//  * dR goes to shared memory as bf16 hi and lo, and dW3 += h^T . dR runs
//    over the tile (2 passes for bf16 h, 3 for float32) into a fresh
//    register tile that is added, with float32 adds, to accumulators held
//    across all the CTA's tiles (a 32 x 32 mma tile per warp and i).
//  * dW3 and dB3 are sums over all E edges. The TPU kernel revisits one
//    output block along a sequential edge axis; Hopper's blocks run in no
//    order. So each edge split writes its partial [mid, IF, O] and [IF, O]
//    to a workspace, and bwd_reduce_kernel sums the partials in split
//    order: no float atomics, bit-identical from run to run.
//  * Tried on the card and dropped (PERF.md, PR 9): a cluster of 4 CTAs
//    along i sharing each g slice through multicast bulk copies issued by
//    a producer warp (1.5-1.8x slower than the same kernel with clusters
//    of 1, and clusters of 4 keep only 120 CTAs resident; its 9 warps held
//    it to 168 registers, with spills), and one value of i per float32 CTA
//    with a 6-stage ring (the waits on g shrank, the per-i work grew more).
// Kernel B (grid: 64-edge tiles x i splits; 8 warps, one CTA per SM).
//  * What held the previous version back (PERF.md, section 6: timing-only
//    variants of it on an H100). bf16: rebuilding dR from a g tile re-read
//    from shared memory for every i (37-40% of its time, g's re-reads
//    alone 19-25%) and V2 gathered one float at a time with __ldg, all
//    landing before a barrier (20-33%); its three barriers per i cost only
//    2-5%. float32: W3[:, i, :] staged per i by synchronous scalar loads
//    with 4-way conflicted transposed stores, its 29-33.5 MB re-read by
//    every tile falling out of L2 at IF >= 896 (29-45%), and the fp32-FMA
//    product (36-48%).
//  * A CTA owns one 64-edge tile and a range of i. Each thread holds its
//    16 columns of its g row for every p in registers (16 P floats), so g
//    is read once per CTA and feeds the dR of every i. i is walked in
//    chunks of CI = 2 (K = 128 per barrier, one barrier per chunk): after
//    the barrier a step runs chunk k - 1's dH += dR . W3^T (8 warps of 32 x
//    32 mma tiles; float32 as dR_hi.W_hi + dR_lo.W_hi + dR_hi.W_lo, bf16 as
//    dR_hi.W + dR_lo.W) and then rebuilds chunk k's dR (float32 sums over
//    p, stored as bf16 hi + lo) into the other of two dR buffers. W3 goes
//    through a 2-stage ring of chunks (float32 W3 split into bf16 hi + lo
//    by split_bf16_kernel inside B's launch), its copies issued one per
//    k-step of the product, so that they queue behind the mma.sync stream
//    rather than stall every warp in one burst after the barrier; V2 goes
//    through a 2-stage ring of 4-i stages, one 16-byte cp.async a row. All
//    shared tiles are swizzled (16-byte chunk ^ row % 8): no padding, no
//    bank conflicts.
//  * Each chunk's product goes into a fresh register tile that is added to
//    the running dH with float32 adds; with the i range split
//    (i_per_split, kernel #3's rule: splits start on 16-wide i chunks, so
//    on B's chunks too) bwd_reduce_kernel sums the partials in split order:
//    dH is the same bits on every run.
//  * What bounds it now (PERF.md, section 6): the mma.sync stream. With the
//    ldmatrix loads replaced by constants the kernel still takes 56-70% of
//    its time (at float32 d_out 3, 2.2 clocks per m16n8k16 per SM: 45% of
//    the bf16 tensor-core peak); with the mma removed it takes 41-52%.
//  * Tried on the card and dropped (PERF.md, section 6): the W3 chunk
//    issued in one burst after the barrier and V2 by 8-byte copies of 2 i
//    (12-20% slower in float32); the next k-step's fragments loaded before
//    this one's mma (0-4% slower, and 80-120 bytes of spills at P = 7,
//    where g takes 112 registers); the mma in pass-major order (within
//    1%); the next chunk's dR rebuilt in quarters between the k-steps of
//    this one's product, so that its FMAs issue beside the mma (2-9%
//    slower).
// Any O that is a multiple of 64 (the TPU kernels take any O). Both kernels
// tile O by BO = 64 as before, one CTA per O tile along the grid's z; the
// sums over o (dV2 in A, dH in B) span the O tiles, so each z slot writes
// dV2 (A) and dH (B) partials that bwd_reduce_kernel sums in slot order:
// every output is the same bits on every run. dW3 and dB3 are per o and
// need no sum over O tiles: each tile writes its own columns of the
// split's partial. At O = 64 this is the old kernel. One CTA walking every
// O tile, carrying those sums across them, was built and timed beside the
// grid and dropped: B 6-9% slower, A within 1% (PERF.md, section 6).
// Left for later. Kernel A: every edge-warp reads each W3 fragment from
// shared memory (wgmma would read it once per warpgroup), the float32
// ring's 2 stages still leave the P = 7 tile waiting on g, and one CTA of 8
// warps per SM hides little latency between its barriers. Kernel B: wgmma,
// whose peak is about twice the rate mma.sync reaches here and which reads
// W3 from shared memory once per warpgroup; W3 re-read from L2 by every
// 64-edge tile (64 KB per float32 chunk; a cluster could multicast it).
//
// The conv_bf16 arm (TV = bf16; entry points se3_pairwise_bwd_a_v16 and
// se3_pairwise_bwd_b_v16, compiled as a unit of their own with
// -DSE3_V16=1 so that the float32 instantiations are the code they were):
// V2 arrives stored bf16, as JAX's _bwd_a_kernel and _bwd_b_kernel take
// it, and is staged at 2 bytes a value (A: a row's 2 values by one 4-byte
// cp.async; B: a row's 4 values of a stage by one 8-byte cp.async; plain
// loads where IF does not allow them). Each staged pair is upcast exactly
// to float32 where it is read (JAX upcasts the V2 row right after its
// load); everything after is the float arm's. dV2 stays a float32 output,
// as JAX's out_shape is.
//
// The mid-32 arm (KM = 32; entry points se3_pairwise_bwd_a_m32 and
// se3_pairwise_bwd_b_m32, compiled as a unit of their own with -DSE3_M32=1):
// the backward of the SE3TransformerV2 family's per-m blocks (radial width
// 32, P = 1 or 2; the TPU kernels are the same _bwd_a_kernel and
// _bwd_b_kernel). h [E, 32], W3 [32, IF, O], dH [E, 32]: nothing is padded
// to 128. The products that contract over mid (A's R) are two k-steps of
// 16; the ones whose rows or columns run over m change their warp roles:
// A's dW3 tile [32 m][64 o] is one warp row of 32 m by 8 warps of 8
// columns (in place of 4 x 2 warps of 32 x 32), B's dH tile [64 e][32 m]
// two warp rows of 32 edges by 4 warps of 8 columns of m (in place of 32),
// read by ldmatrix .x2; a B chunk's W3 is 2 copies a thread a half (in
// place of 8), issued at the first two k-steps of the product. What bounds
// it: at mid 32 every product is a quarter of its mid-128 size while the
// P-contractions (A's dV2 and dR, B's dR rebuild, on the CUDA cores) are
// not, so those and the per-tile barriers bound both kernels, not the
// tensor cores. Float V2 only, P = 1 and 2 only (V2's rows: no model makes
// a mid-32 call of more), and built for runtime O (the kWide form) alone,
// which halves the unit's instantiations.
//
// P = 2 (V2's -m/+m row pair) is built beside 1, 3, 5 and 7 at both
// widths: both kernels walk P in loops of their own, with nothing that
// groups the rows in fours or assumes P odd.

#include "common.cuh"

#ifndef SE3_V16
#define SE3_V16 0
#endif
#ifndef SE3_M32
#define SE3_M32 0
#endif
#if !SE3_V16
// the narrow-O arms (O = 8, 16 or 32) of kernels A and B, a unit of their
// own
#include "pairwise_narrow.h"
#endif

namespace {

using namespace se3;

using bf16 = __nv_bfloat16;

// the radial width this unit's float arm is built for
constexpr int KMID = SE3_M32 ? MID32 : MID;
constexpr int BI = 2;                      // i values per kernel-A CTA
constexpr int DSB = BO + 8;                // row stride of a bf16 dR tile: conflict-free ldmatrix
constexpr int WG = 16 * 32;                // one warp's g block per ring stage: 16 rows x 32 floats

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Two consecutive staged V2 values as float32: a float2, or a bf16 pair
// (conv_bf16) upcast exactly.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Kernel A's shared memory by h's kind (bf16, or float32 given as bf16 hi +
// lo halves), P and the radial width KM, as byte offsets. The g ring is as
// deep as what is left allows: 6 stages for bf16, 2 for float32, whose h
// and W3 take two halves. dW3's warp roles: KM / 32 rows of 32 m, the rest
// of the 8 warps along O, NC columns (NT 8-column blocks) each.
template <bool kSplit, int P, typename TV = float, int KM = MID>
struct ACfg {
  static constexpr int NS = kSplit ? 2 : 1;  // bf16 halves of h and W3
  static constexpr int STAGES = kSplit ? 2 : 6;
  static constexpr int WS = Tile<bf16, KM>::WS, HS = Tile<bf16, KM>::HS;
  static constexpr int WARPS_M = KM / 32, NC = BO * WARPS_M / 8, NT = NC / 8;
  static_assert(KM % 32 == 0 && KM <= 128, "KM / 32 warp rows of dW3");
  static constexpr size_t W = 0;                                   // [BI][NS][KM][WS] bf16
  static constexpr size_t H = W + 2ull * BI * NS * KM * WS;        // [2][NS][BE][HS] bf16
  static constexpr size_t DR = H + 2ull * 2 * NS * BE * HS;        // [BI][hi, lo][BE][DSB] bf16
  static constexpr size_t G = DR + 2ull * BI * 2 * BE * DSB;       // [STAGES][8 warps][WG] float
  static constexpr size_t V = G + 4ull * STAGES * 8 * WG;          // [2][BE][P][BI] TV
  static constexpr size_t PP = V + sizeof(TV) * 2 * BE * P * BI;   // [BI][2][BE][P] float
  static constexpr size_t SMEM = PP + 4ull * BI * 2 * BE * P;
  static_assert(SMEM <= 232448, "kernel A's tile fits one SM's shared memory");
  static_assert(4ull * 4 * BI * BO <= G - DR, "dB3's reduction fits the dR tiles");
};

// Kernel A: a CTA owns BI values of i and a range of 64-edge tiles, with
// 8 warps (4 along edges x 2 along O). g streams through a ring of slices
// g[tile, p, :], each read once by the CTA for all of its i; each warp
// loads and reads only its own 16 x 32 block of a slice, so a slice needs
// no barrier of the whole CTA.
// TV is V2's type: float, or bf16 (the conv_bf16 arm). KM: the radial width.
template <bool kSplit, int P, bool kWide, typename TV, int KM>
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_a_kernel(const bf16* __restrict__ hhi, const bf16* __restrict__ hlo,
             const bf16* __restrict__ whi, const bf16* __restrict__ wlo,
             const float* __restrict__ b3, const TV* __restrict__ v2,
             const float* __restrict__ g, float* __restrict__ dv2,
             float* __restrict__ part, int E, int IF, int O, int tiles_per_split, int v2_pairs) {
  using C = ACfg<kSplit, P, TV, KM>;
  constexpr int S = C::STAGES, NS = C::NS, WS = C::WS, HS = C::HS;
  constexpr int NC = C::NC, NT = C::NT;
  static_assert(BI == 2, "a row's BI values of V2 and dV2 move as one float2");
  // O is the constant BO, and the O tile the first, unless the kernel is
  // built for wider O (kWide): with O and the tile runtime values the
  // compiler allocated registers differently and the O = 64 kernel ran up
  // to 4% slower at bf16 P = 3 and 7 (timing-only variants)
  if constexpr (!kWide) O = BO;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem + C::W);
  bf16* sH = reinterpret_cast<bf16*>(smem + C::H);
  bf16* sDR = reinterpret_cast<bf16*>(smem + C::DR);
  float* sG = reinterpret_cast<float*>(smem + C::G);
  TV* sV = reinterpret_cast<TV*>(smem + C::V);
  float* sP = reinterpret_cast<float*>(smem + C::PP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we = warp & 3, wo = warp >> 2;
  const int t = lane & 3, j = lane >> 3, rr = lane & 7;
  const int e_lo = we * 16 + (lane >> 2), e_hi = e_lo + 8;
  const int i0 = blockIdx.x * BI;
  const int nI = min(BI, IF - i0);  // 1 or 2: the grid stops at IF
  const int n_tiles = (E + BE - 1) / BE;
  const int tile_lo = blockIdx.y * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);
  // The CTA walks slices n = (tile - tile_lo) * P + p in order; slice n
  // lands in ring stage n % S by 16-byte cp.async, one group per slice,
  // S - 1 slices ahead of the one in use. A warp's block row r holds its
  // 16-byte chunk c at c ^ 2(r % 4) (the float2 reads of 4 rows then hit
  // 32 distinct banks). Rows past E are not copied (and read as zeros).
  const int n_slices = max(0, tile_hi - tile_lo) * P;
  // the CTA's O tile, blockIdx.z; its dV2 goes to slot blockIdx.z of dv2
  // (the launch sums the slots when there are several)
  const int o0 = kWide ? blockIdx.z * BO : 0;
  float* dv2z = kWide ? dv2 + (size_t)blockIdx.z * E * P * IF : dv2;
  float* sGw = sG + warp * WG;  // this warp's block of stage 0
  auto stage_g = [&](int n) {
    if (n >= n_slices) return;
    const int tile = tile_lo + n / P, p = n % P;
    const int rows = min(BE, E - tile * BE) - we * 16;
    const float* src = g + ((size_t)(tile * BE + we * 16) * P + p) * O + o0 + wo * 32;
    float* dst = sGw + (n % S) * 8 * WG;
#pragma unroll
    for (int k = lane; k < 16 * 8; k += 32) {
      const int r = k >> 3, c = k & 7;
      if (r < rows)
        cp_async16(dst + r * 32 + ((c ^ ((r & 3) << 1)) << 2), src + (size_t)r * P * O + c * 4);
    }
  };
  // h (hi[, lo]) and V2[tile, :, i0 .. i0 + BI] of a tile into buffer buf
  auto stage_tile = [&](int tile, int buf) {
    const int e0 = tile * BE, rows = min(BE, E - e0);
#pragma unroll
    for (int half = 0; half < NS; ++half)
      load_h<bf16, KM>(sH + (buf * NS + half) * BE * HS, half ? hlo : hhi, e0, rows, tid);
    TV* sv = sV + buf * BE * P * BI;
    for (int idx = tid; idx < BE * P; idx += NTHREADS) {
      const int e = idx / P;
      TV* dst = sv + idx * BI;
      const TV* src = v2 + ((size_t)e0 * P + idx) * IF + i0;
      if (e < rows && v2_pairs) {
        if constexpr (sizeof(TV) == 2)
          cp_async4(dst, src);
        else
          cp_async8(dst, src);
      } else {
#pragma unroll
        for (int ii = 0; ii < BI; ++ii) {
          if constexpr (sizeof(TV) == 2)
            dst[ii] = e < rows && ii < nI ? src[ii] : __float2bfloat16(0.f);
          else if (e < rows && ii < nI)
            cp_async4(dst + ii, src + ii);
          else
            dst[ii] = 0.f;
        }
      }
    }
  };

  // W3[:, i, O tile] of the CTA's i values (the last valid i past IF's
  // end: those outputs are not stored), the first tile, then the ring's
  // first S - 1 slices.
#pragma unroll
  for (int ii = 0; ii < BI; ++ii)
#pragma unroll
    for (int half = 0; half < NS; ++half)
      load_w<bf16, KM>(sW + (ii * NS + half) * KM * WS, half ? wlo : whi, min(i0 + ii, IF - 1),
                       IF, O, o0, tid);
  if (tile_lo < tile_hi) stage_tile(tile_lo, 0);
  cp_async_commit();
#pragma unroll
  for (int n = 0; n < S - 1; ++n) {
    stage_g(n);
    cp_async_commit();
  }

  // dW3 accumulators, per i: the mma.sync layout of a 32 (m) x NC (o)
  // warp tile, m = (warp % WARPS_M)*32 + mt*16 + {g, g+8}, o = (warp /
  // WARPS_M)*NC + nt*8 + 2t + {0, 1} at [mt*NT + nt][..]
  float acc[BI][2 * NT][4];
  // dB3: this thread's dR columns summed over its rows (both halves)
  float dbias[BI][4][2];
#pragma unroll
  for (int ii = 0; ii < BI; ++ii) {
#pragma unroll
    for (int a = 0; a < 2 * NT; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[ii][a][c] = 0.f;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) dbias[ii][nb][0] = dbias[ii][nb][1] = 0.f;
  }

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int it = tile - tile_lo, buf = it & 1;
    const int e0 = tile * BE, rows = min(BE, E - e0);
    const bool lo_ok = e_lo < rows, hi_ok = e_hi < rows;
    // this tile's h, V2 and first S - 1 slices have landed, and every warp
    // is done with the previous tile (its h/V2 buffer, the ring stage of
    // its last slice, the dR tiles and the dV2 partials)
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < tile_hi) stage_tile(tile + 1, buf ^ 1);
    cp_async_commit();

    // R = h . W3 for the CTA's i values: per kk, h's A fragments once
    // for every i; float32 as three passes (hi.hi, hi.lo, lo.hi)
    const bf16* sh = sH + buf * NS * BE * HS;
    float r[BI][4][4];
#pragma unroll
    for (int ii = 0; ii < BI; ++ii)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int v = 0; v < 4; ++v) r[ii][nb][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KM / 16; ++kk) {
      const int aoff = (we * 16 + (j & 1) * 8 + rr) * HS + kk * 16 + (j >> 1) * 8;
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, sh + aoff);
      if constexpr (kSplit) ldmatrix_x4(al, sh + BE * HS + aoff);
#pragma unroll
      for (int ii = 0; ii < BI; ++ii) {
        const bf16* sw = sW + ii * NS * KM * WS;
#pragma unroll
        for (int nb2 = 0; nb2 < 2; ++nb2) {
          const int boff = (kk * 16 + (j & 1) * 8 + rr) * WS + wo * 32 + nb2 * 16 + (j >> 1) * 8;
          uint32_t bh[4];
          ldmatrix_x4_trans(bh, sw + boff);
          mma_bf16(r[ii][nb2 * 2 + 0], ah, bh[0], bh[1]);
          mma_bf16(r[ii][nb2 * 2 + 1], ah, bh[2], bh[3]);
          if constexpr (kSplit) {
            uint32_t bl[4];
            ldmatrix_x4_trans(bl, sw + KM * WS + boff);
            mma_bf16(r[ii][nb2 * 2 + 0], ah, bl[0], bl[1]);
            mma_bf16(r[ii][nb2 * 2 + 1], ah, bl[2], bl[3]);
            mma_bf16(r[ii][nb2 * 2 + 0], al, bh[0], bh[1]);
            mma_bf16(r[ii][nb2 * 2 + 1], al, bh[2], bh[3]);
          }
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < BI; ++ii) {
      const float* bi = b3 + (size_t)min(i0 + ii, IF - 1) * O + o0;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bi + wo * 32 + nb * 8 + 2 * t));
        r[ii][nb][0] += bb.x;
        r[ii][nb][1] += bb.y;
        r[ii][nb][2] += bb.x;
        r[ii][nb][3] += bb.y;
      }
    }

    // the P-contractions, slice by slice in p order, every i on each
    // slice: dV2 partials (a sum over the warp's 32 columns) and dR
    float dr[BI][4][4];
#pragma unroll
    for (int ii = 0; ii < BI; ++ii)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int v = 0; v < 4; ++v) dr[ii][nb][v] = 0.f;
    const TV* sv = sV + buf * BE * P * BI;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int n = it * P + p;
      if (p > 0) {
        // slice n has landed, and this warp is done with slice n - 1
        cp_async_wait<S - 2>();
        __syncwarp();
      }
      // refill the stage of slice n - 1
      stage_g(n + S - 1);
      cp_async_commit();
      const float* sg = sGw + (n % S) * 8 * WG;
      const int gr = lane >> 2, sw = (gr & 3) << 1;
      const float2 vl = load_pair(sv + (e_lo * P + p) * BI);
      const float2 vh = load_pair(sv + (e_hi * P + p) * BI);
      const float vlo[BI] = {vl.x, vl.y}, vhi[BI] = {vh.x, vh.y};
      float sl[BI], su[BI];
#pragma unroll
      for (int ii = 0; ii < BI; ++ii) sl[ii] = su[ii] = 0.f;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = (((nb * 2 + (t >> 1)) ^ sw) << 2) + (t & 1) * 2;
        float2 a = *reinterpret_cast<const float2*>(sg + gr * 32 + col);
        float2 b = *reinterpret_cast<const float2*>(sg + (gr + 8) * 32 + col);
        if (!lo_ok) a = make_float2(0.f, 0.f);
        if (!hi_ok) b = make_float2(0.f, 0.f);
#pragma unroll
        for (int ii = 0; ii < BI; ++ii) {
          sl[ii] = fmaf(a.x, r[ii][nb][0], fmaf(a.y, r[ii][nb][1], sl[ii]));
          su[ii] = fmaf(b.x, r[ii][nb][2], fmaf(b.y, r[ii][nb][3], su[ii]));
          dr[ii][nb][0] = fmaf(vlo[ii], a.x, dr[ii][nb][0]);
          dr[ii][nb][1] = fmaf(vlo[ii], a.y, dr[ii][nb][1]);
          dr[ii][nb][2] = fmaf(vhi[ii], b.x, dr[ii][nb][2]);
          dr[ii][nb][3] = fmaf(vhi[ii], b.y, dr[ii][nb][3]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < BI; ++ii) {
        float a = sl[ii], b = su[ii];
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        b += __shfl_xor_sync(0xffffffffu, b, 1);
        b += __shfl_xor_sync(0xffffffffu, b, 2);
        if (t == 0) {
          sP[((ii * 2 + wo) * BE + e_lo) * P + p] = a;
          sP[((ii * 2 + wo) * BE + e_hi) * P + p] = b;
        }
      }
    }

    // dB3 partial sums; dR into shared memory as bf16 hi + lo halves
#pragma unroll
    for (int ii = 0; ii < BI; ++ii) {
      bf16* dh_ = sDR + (ii * 2 + 0) * BE * DSB;
      bf16* dl_ = sDR + (ii * 2 + 1) * BE * DSB;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = wo * 32 + nb * 8 + 2 * t;
        dbias[ii][nb][0] += dr[ii][nb][0] + dr[ii][nb][2];
        dbias[ii][nb][1] += dr[ii][nb][1] + dr[ii][nb][3];
        const __nv_bfloat162 hl = __floats2bfloat162_rn(dr[ii][nb][0], dr[ii][nb][1]);
        const __nv_bfloat162 hh = __floats2bfloat162_rn(dr[ii][nb][2], dr[ii][nb][3]);
        *reinterpret_cast<__nv_bfloat162*>(dh_ + e_lo * DSB + col) = hl;
        *reinterpret_cast<__nv_bfloat162*>(dh_ + e_hi * DSB + col) = hh;
        *reinterpret_cast<__nv_bfloat162*>(dl_ + e_lo * DSB + col) = __floats2bfloat162_rn(
            dr[ii][nb][0] - __low2float(hl), dr[ii][nb][1] - __high2float(hl));
        *reinterpret_cast<__nv_bfloat162*>(dl_ + e_hi * DSB + col) = __floats2bfloat162_rn(
            dr[ii][nb][2] - __low2float(hh), dr[ii][nb][3] - __high2float(hh));
      }
    }
    __syncthreads();

    // dV2 of the tile: the two O-halves added in a fixed order, the CTA's
    // BI values of a row as one 8-byte store
    for (int idx = tid; idx < rows * P; idx += NTHREADS) {
      const int e = idx / P, p = idx - e * P;
      float d[BI];
#pragma unroll
      for (int ii = 0; ii < BI; ++ii)
        d[ii] = sP[((ii * 2 + 0) * BE + e) * P + p] + sP[((ii * 2 + 1) * BE + e) * P + p];
      float* dst = dv2z + ((size_t)e0 * P + idx) * IF + i0;
      if (v2_pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(d[0], d[1]);
      } else {
#pragma unroll
        for (int ii = 0; ii < BI; ++ii)
          if (ii < nI) dst[ii] = d[ii];
      }
    }

    // dW3 += h^T . dR over the tile (rows past E are 0): dR's hi and lo
    // halves on h (bf16), or hi.hi, hi.lo, lo.hi (float32 h split). The
    // tensor cores' fp32 accumulation is not round-to-nearest, and over a
    // chain of ~16k edges its error grew to ~5e-5 of dW3; so each tile's
    // product is accumulated in a fresh register tile and added to the
    // running sum with ordinary float32 adds.
    const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
#pragma unroll
    for (int ii = 0; ii < BI; ++ii) {
      float tacc[2 * NT][4];
#pragma unroll
      for (int a = 0; a < 2 * NT; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) tacc[a][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BE / 16; ++kk) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int off = (kk * 16 + (j >> 1) * 8 + rr) * HS + wm * 32 + mt * 16 + (j & 1) * 8;
          ldmatrix_x4_trans(ah[mt], sh + off);
          if constexpr (kSplit) ldmatrix_x4_trans(al[mt], sh + BE * HS + off);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const bf16* sd = sDR + (ii * 2 + half) * BE * DSB;
          // pairs of 8-column blocks of dR (x4), or one (x2: NT = 1)
#pragma unroll
          for (int nb2 = 0; nb2 < (NT + 1) / 2; ++nb2) {
            uint32_t b[4];
            const bf16* src = sd + (kk * 16 + (j & 1) * 8 + rr) * DSB + wn * NC + nb2 * 16 +
                              (j >> 1) * 8;
            if constexpr (NT == 1)
              ldmatrix_x2_trans(b, src);
            else
              ldmatrix_x4_trans(b, src);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nb = 0; nb < (NT == 1 ? 1 : 2); ++nb) {
                float(&d)[4] = tacc[mt * NT + nb2 * 2 + nb];
                mma_bf16(d, ah[mt], b[2 * nb], b[2 * nb + 1]);
                if (kSplit && half == 0) mma_bf16(d, al[mt], b[2 * nb], b[2 * nb + 1]);
              }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 2 * NT; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[ii][a][c] += tacc[a][c];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the last tile's dR tiles are read: dB3 takes their space

  // dB3: over the 8 row groups of a warp (lanes that share t), then over
  // the 4 edge warps in order
  float* sB = reinterpret_cast<float*>(smem + C::DR);  // [4][BI][BO]
#pragma unroll
  for (int ii = 0; ii < BI; ++ii)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = dbias[ii][nb][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) sB[(we * BI + ii) * BO + wo * 32 + nb * 8 + 2 * t + c] = v;
      }
  __syncthreads();

  // this split's partial sums, the O tile's columns: [KM][IF][O] then
  // [IF][O]
  float* pw = part + (size_t)blockIdx.y * ((size_t)KM * IF * O + (size_t)IF * O);
  for (int idx = tid; idx < nI * BO; idx += NTHREADS) {
    const int ii = idx / BO, o = idx % BO;
    pw[(size_t)KM * IF * O + (size_t)(i0 + ii) * O + o0 + o] =
        ((sB[(0 * BI + ii) * BO + o] + sB[(1 * BI + ii) * BO + o]) +
         sB[(2 * BI + ii) * BO + o]) + sB[(3 * BI + ii) * BO + o];
  }
  const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M, gq = lane >> 2;
#pragma unroll
  for (int ii = 0; ii < BI; ++ii) {
    if (ii >= nI) continue;
    const int i = i0 + ii;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = wm * 32 + mt * 16 + gq, o = o0 + wn * NC + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(pw + ((size_t)m * IF + i) * O + o) =
            make_float2(acc[ii][mt * NT + nt][0], acc[ii][mt * NT + nt][1]);
        *reinterpret_cast<float2*>(pw + ((size_t)(m + 8) * IF + i) * O + o) =
            make_float2(acc[ii][mt * NT + nt][2], acc[ii][mt * NT + nt][3]);
      }
  }
}

unsigned grid_for(size_t n) {
  const size_t blocks = (n + NTHREADS - 1) / NTHREADS;
  return (unsigned)(blocks > 4096 ? 4096 : blocks);
}

// dW3 and dB3 (or kernel B's dH, with n_b = 0): the splits' partials summed
// in split order (deterministic).
__global__ void bwd_reduce_kernel(const float* __restrict__ part, int splits,
                                  size_t n_w, size_t n_b, float* __restrict__ dw3,
                                  float* __restrict__ db3) {
  const size_t n = n_w + n_b;
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + j];
    if (j < n_w)
      dw3[j] = s;
    else
      db3[j - n_w] = s;
  }
}

// Kernel B's shared memory by W3's kind (bf16, or float32 given as bf16 hi
// + lo halves), P and the radial width KM, as byte offsets. Every tile is
// bf16 with 64-element (128-byte) rows whose 16-byte chunks sit at chunk ^
// (row % 8): ldmatrix and the 16-byte stores of dR hit 8 distinct chunks of
// each 8 rows. The product's warps: 2 along edges x 4 along m, KM / 4
// columns of m (NT 8-column blocks) each; a chunk's W3 half is COPIES
// 16-byte copies a thread.
template <bool kSplit, int P, typename TV = float, int KM = MID>
struct BCfg {
  static constexpr int NS = kSplit ? 2 : 1;  // bf16 halves of W3
  static constexpr int CI = 2;               // i values per chunk: K = 128 per barrier
  static constexpr int VI = 2 * CI;          // i values per V2 stage: 16 (bf16: 8) bytes a row
  static constexpr int NT = KM / 32;         // 8-column blocks of m a warp
  static constexpr int COPIES = KM * CI * 8 / NTHREADS;
  static_assert(KM % 32 == 0 && KM * CI * 8 % NTHREADS == 0 && COPIES <= CI * BO / 16,
                "a W3 half is whole copies a thread, at most one a k-step");
  static constexpr size_t WSL = 2ull * KM * BO;    // bytes of one W3[:, i, :] half
  static constexpr size_t DSL = 2ull * BE * BO;    // bytes of one dR[tile, i, :] half
  static constexpr size_t W = 0;                   // [2 stages][CI][NS][KM][BO] bf16
  static constexpr size_t DR = W + 2 * CI * NS * WSL;  // [2 buffers][CI][hi, lo][BE][BO] bf16
  static constexpr size_t V = DR + 2 * CI * 2 * DSL;   // [2 stages][BE][P][VI] TV
  static constexpr size_t SMEM = V + sizeof(TV) * 2 * BE * P * VI;
  static_assert(SMEM <= 232448, "kernel B's tile fits one SM's shared memory");
};

// Kernel B: a CTA owns one 64-edge tile and a range of i, walked in chunks
// of CI values. Its thread (row re, quarter q) holds g[tile row re, :, 16q
// .. 16q + 16] in registers for the whole kernel, so each g value feeds the
// dR of every i. Step k, after one barrier: dH += dR . W3^T runs for chunk
// k - 1 on the tensor cores (8 warps: 2 along edges x 4 along mid, 32 x 32
// each) while chunk k's W3 is issued behind it (cp.async), then chunk k's
// dR is rebuilt into the other dR buffer; V2 is issued two chunks at a time.
// TV is V2's type: float, or bf16 (the conv_bf16 arm). KM: the radial width
// (dH [E, KM]).
template <bool kSplit, int P, bool kWide, typename TV, int KM>
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_b_kernel(const bf16* __restrict__ whi, const bf16* __restrict__ wlo,
             const TV* __restrict__ v2, const float* __restrict__ g,
             float* __restrict__ dh, int E, int IF, int O, int i_per_split, int v2_quads) {
  using C = BCfg<kSplit, P, TV, KM>;
  constexpr int CI = C::CI, NS = C::NS;
  constexpr int VI = C::VI, NT = C::NT, COPIES = C::COPIES;
  static_assert(CI == 2, "a row's CI values of V2 are read as one float2");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem + C::W);
  bf16* sDR = reinterpret_cast<bf16*>(smem + C::DR);
  TV* sV = reinterpret_cast<TV*>(smem + C::V);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e0 = blockIdx.x * BE, rows = min(BE, E - e0);
  const int i_lo = blockIdx.y * i_per_split, i_hi = min(IF, i_lo + i_per_split);
  const int n_chunks = (i_hi - i_lo + CI - 1) / CI;
  // O is the constant BO unless the kernel is built for wider O (kWide):
  // with O a runtime value, kernel B ran 13% slower at P = 1 (the stride
  // of g's loads, by timing-only variants; likely g reloaded in the chunk
  // loop rather than held in registers)
  if constexpr (!kWide) O = BO;
  const int o0 = kWide ? blockIdx.z * BO : 0;  // the CTA's O tile

  // W3[:, chunk c, :] (hi[, lo]) goes into ring stage c % 2 as KM x CI x 8
  // 16-byte cp.async per half, COPIES a thread (8 at mid 128, 2 at 32);
  // this is the thread's r-th (r < COPIES NS). i past IF's end reads the
  // last i (its dR is 0).
  auto stage_w = [&](int c, int r) {
    const int f = tid + (r % COPIES) * NTHREADS, half = r / COPIES;
    const int ch = f & 7, ii = (f >> 3) & (CI - 1), m = f >> 4;
    const int i = min(i_lo + c * CI + ii, IF - 1);
    cp_async16(sW + ((size_t)((c & 1) * CI + ii) * NS + half) * KM * BO + swz(m, ch * 8),
               (half ? wlo : whi) + ((size_t)m * IF + i) * O + o0 + ch * 8);
  };
  // V2[tile, :, VI i from i_lo + s VI] into stage s % 2 (chunks 2s and 2s +
  // 1): one 16-byte copy a row where IF allows, else 4-byte copies; zeros
  // past E and past the i range
  auto stage_v = [&](int s) {
    const int i0 = i_lo + s * VI;
    if (i0 >= i_hi) return;
    TV* dst = sV + (s & 1) * BE * P * VI;
    for (int idx = tid; idx < BE * P; idx += NTHREADS) {
      const int e = idx / P;
      const TV* src = v2 + ((size_t)e0 * P + idx) * IF + i0;
      TV* d = dst + idx * VI;
      if (e < rows && v2_quads) {
        if constexpr (sizeof(TV) == 2)
          cp_async8(d, src);
        else
          cp_async16(d, src);
      } else {
#pragma unroll
        for (int ii = 0; ii < VI; ++ii) {
          if constexpr (sizeof(TV) == 2)
            d[ii] = e < rows && i0 + ii < i_hi ? src[ii] : __float2bfloat16(0.f);
          else if (e < rows && i0 + ii < i_hi)
            cp_async4(d + ii, src + ii);
          else
            d[ii] = 0.f;
        }
      }
    }
  };

  stage_v(0);
  cp_async_commit();

  // this thread's g values: row re of the tile, columns o0 + 16q .. + 16
  const int re = tid >> 2, q = tid & 3;
  float gr[P][16];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 x =
          re < rows
              ? __ldg(reinterpret_cast<const float4*>(g + ((size_t)(e0 + re) * P + p) * O + o0 +
                                                      q * 16) + k)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      gr[p][4 * k + 0] = x.x;
      gr[p][4 * k + 1] = x.y;
      gr[p][4 * k + 2] = x.z;
      gr[p][4 * k + 3] = x.w;
    }

  // dR[re, i, 16q ..] = sum_p V2[re, p, i] g[re, p, ..] for the chunk's i,
  // as bf16 hi + lo into dR buffer c % 2
  auto rebuild = [&](int c) {
    const TV* sv = sV + ((c >> 1) & 1) * BE * P * VI + re * P * VI + (c & 1) * CI;
    bf16* sd = sDR + (size_t)(c & 1) * CI * 2 * BE * BO;
    float2 vv[P];
#pragma unroll
    for (int p = 0; p < P; ++p) vv[p] = load_pair(sv + p * VI);
#pragma unroll
    for (int ii = 0; ii < CI; ++ii) {
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float v = ii ? vv[p].y : vv[p].x;
#pragma unroll
        for (int k = 0; k < 16; ++k) d[k] = fmaf(v, gr[p][k], d[k]);
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float a = d[s * 8 + 2 * k], b = d[s * 8 + 2 * k + 1];
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
          const __nv_bfloat162 l2 =
              __floats2bfloat162_rn(a - __low2float(h2), b - __high2float(h2));
          hi[k] = *reinterpret_cast<const uint32_t*>(&h2);
          lo[k] = *reinterpret_cast<const uint32_t*>(&l2);
        }
        const int off = swz(re, (2 * q + s) * 8);
        *reinterpret_cast<uint4*>(sd + (ii * 2 + 0) * BE * BO + off) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(sd + (ii * 2 + 1) * BE * BO + off) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  };

  // dH accumulators: the mma.sync layout of a 32 (e) x KM / 4 (m) warp
  // tile, e = (warp & 1)*32 + mt*16 + {g, g+8}, m = (warp >> 1)*KM/4 +
  // nt*8 + 2t + {0, 1} at [mt][nt][..]
  const int we = warp & 1, wm = warp >> 1, j = lane >> 3, rr = lane & 7;
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;

  // one chunk's dR . W3^T (K = CI x 64) into a fresh register tile, added
  // to the running sum with float32 adds (the tensor cores' accumulation is
  // not round-to-nearest; see kernel A). bf16 W3: dR_hi.W + dR_lo.W; float32
  // W3: dR_hi.W_hi + dR_lo.W_hi + dR_hi.W_lo.
  auto product = [&](int c, bool issue_next) {
    const bf16* sw = sW + (size_t)(c & 1) * CI * NS * KM * BO;
    const bf16* sd = sDR + (size_t)(c & 1) * CI * 2 * BE * BO;
    float tacc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) tacc[mt][nt][v] = 0.f;
#pragma unroll
    for (int ii = 0; ii < CI; ++ii) {
#pragma unroll
      for (int kk = 0; kk < BO / 16; ++kk) {
        // chunk c + 1's W3, one copy (each half) a k-step for the first
        // COPIES k-steps: the copies queue behind the products instead of
        // stalling the warp in one burst
        const int step = ii * (BO / 16) + kk;
        if (issue_next && step < COPIES) {
#pragma unroll
          for (int half = 0; half < NS; ++half) stage_w(c + 1, half * COPIES + step);
        }
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int off = swz(we * 32 + mt * 16 + (j & 1) * 8 + rr, kk * 16 + (j >> 1) * 8);
          ldmatrix_x4(ah[mt], sd + (ii * 2 + 0) * BE * BO + off);
          ldmatrix_x4(al[mt], sd + (ii * 2 + 1) * BE * BO + off);
        }
        // pairs of 8-column blocks of m (x4), or one (x2: NT = 1)
#pragma unroll
        for (int nb2 = 0; nb2 < (NT + 1) / 2; ++nb2) {
          const int off =
              swz(wm * (KM / 4) + nb2 * 16 + (j >> 1) * 8 + rr, kk * 16 + (j & 1) * 8);
          const bf16* wh = sw + (size_t)(ii * NS + 0) * KM * BO + off;
          uint32_t bh[4], bl[4];
          if constexpr (NT == 1) {
            ldmatrix_x2(bh, wh);
            if constexpr (kSplit) ldmatrix_x2(bl, wh + KM * BO);
          } else {
            ldmatrix_x4(bh, wh);
            if constexpr (kSplit) ldmatrix_x4(bl, wh + KM * BO);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if constexpr (NT == 1) {
              float(&t0)[4] = tacc[mt][0];
              mma_bf16(t0, ah[mt], bh[0], bh[1]);
              mma_bf16(t0, al[mt], bh[0], bh[1]);
              if constexpr (kSplit) mma_bf16(t0, ah[mt], bl[0], bl[1]);
            } else {
              float(&t0)[4] = tacc[mt][nb2 * 2 + 0];
              float(&t1)[4] = tacc[mt][nb2 * 2 + 1];
              mma_bf16(t0, ah[mt], bh[0], bh[1]);
              mma_bf16(t1, ah[mt], bh[2], bh[3]);
              mma_bf16(t0, al[mt], bh[0], bh[1]);
              mma_bf16(t1, al[mt], bh[2], bh[3]);
              if constexpr (kSplit) {
                mma_bf16(t0, ah[mt], bl[0], bl[1]);
                mma_bf16(t1, ah[mt], bl[2], bl[3]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][nt][v] += tacc[mt][nt][v];
  };

  // Step k: the product of chunk k - 1 and the dR of chunk k, behind one
  // barrier. Everything issued in step k - 1 (chunk k - 1's W3; V2 of
  // chunks k and k + 1 when k - 1 is odd) has landed, chunk k - 1's dR is
  // written, and every warp is done with step k - 1: chunk k - 2's W3 stage
  // and dR buffer, and (k odd) the V2 stage of chunks k - 3 and k - 2.
  for (int k = 0; k <= n_chunks; ++k) {
    cp_async_wait<0>();
    __syncthreads();
    if (k & 1) stage_v((k + 1) >> 1);
    if (k == 0) {
#pragma unroll
      for (int r = 0; r < COPIES * NS; ++r) stage_w(0, r);
    } else {
      product(k - 1, k < n_chunks);
    }
    cp_async_commit();
    if (k < n_chunks) rebuild(k);
  }

  const int gq = lane >> 2, t = lane & 3;
  // this (O tile, i range) slot's dH
  float* dst = dh + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * E * KM;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int e = we * 32 + mt * 16 + gq, m = wm * (KM / 4) + nt * 8 + 2 * t;
      if (e < rows)
        *reinterpret_cast<float2*>(dst + (size_t)(e0 + e) * KM + m) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (e + 8 < rows)
        *reinterpret_cast<float2*>(dst + (size_t)(e0 + e + 8) * KM + m) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

template <bool kSplit, int P, typename TV, int KM>
cudaError_t launch_a(const void* h, const void* w3, const void* b3, const void* v2,
                     const void* g, void* dv2, void* dv2_work, void* work, void* split,
                     void* dw3, void* db3, int E, int IF, int O, int splits,
                     cudaStream_t stream) {
  using C = ACfg<kSplit, P, TV, KM>;
  const int groups = (IF + BI - 1) / BI;
  const int slots = O / BO;  // CTAs along O, each with its dV2 slot
  const bf16 *hhi = static_cast<const bf16*>(h), *whi = static_cast<const bf16*>(w3);
  const bf16 *hlo = nullptr, *wlo = nullptr;
  cudaError_t err;
  if constexpr (kSplit) {
    // float32 h and W3 into their bf16 hi and lo arrays (h [E, KM] and W3
    // [KM, IF, O] are whole numbers of float4s)
    const size_t nh = (size_t)E * KM, nw = (size_t)KM * IF * O;
    bf16* sp = static_cast<bf16*>(split);
    split_bf16_kernel<<<grid_for(nh / 4), NTHREADS, 0, stream>>>(
        static_cast<const float4*>(h), nh / 4, reinterpret_cast<uint2*>(sp),
        reinterpret_cast<uint2*>(sp + nh));
    split_bf16_kernel<<<grid_for(nw / 4), NTHREADS, 0, stream>>>(
        static_cast<const float4*>(w3), nw / 4, reinterpret_cast<uint2*>(sp + 2 * nh),
        reinterpret_cast<uint2*>(sp + 2 * nh + nw));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    hhi = sp;
    hlo = sp + nh;
    whi = sp + 2 * nh;
    wlo = sp + 2 * nh + nw;
  }
  // mid 32 is built for runtime O (kWide) alone
  auto kern = bwd_a_kernel<kSplit, P, true, TV, KM>;
  if constexpr (KM == MID)
    if (O == BO) kern = bwd_a_kernel<kSplit, P, false, TV, KM>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const int n_tiles = (E + BE - 1) / BE;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  float* dv2_out = static_cast<float*>(slots > 1 ? dv2_work : dv2);
  // a row's two V2 values move as one copy (8 bytes, bf16 4) and its two
  // dV2 values as one 8-byte store when IF is even
  const int v2_pairs = IF % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(v2) % (2 * sizeof(TV)) == 0 &&
                       reinterpret_cast<uintptr_t>(dv2_out) % 8 == 0;
  kern<<<dim3(groups, splits, slots), NTHREADS, C::SMEM, stream>>>(
      hhi, hlo, whi, wlo, static_cast<const float*>(b3), static_cast<const TV*>(v2),
      static_cast<const float*>(g), dv2_out, static_cast<float*>(work), E, IF, O,
      tiles_per_split, v2_pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n_w = (size_t)KM * IF * O, n_b = (size_t)IF * O;
  bwd_reduce_kernel<<<grid_for(n_w + n_b), NTHREADS, 0, stream>>>(
      static_cast<const float*>(work), splits, n_w, n_b, static_cast<float*>(dw3),
      static_cast<float*>(db3));
  if ((err = cudaGetLastError()) != cudaSuccess || slots == 1) return err;
  // dV2: the O slots' partials summed in slot order
  const size_t n_v = (size_t)E * P * IF;
  bwd_reduce_kernel<<<grid_for(n_v), NTHREADS, 0, stream>>>(
      static_cast<const float*>(dv2_work), slots, n_v, 0, static_cast<float*>(dv2), nullptr);
  return cudaGetLastError();
}

template <bool kSplit, int P, typename TV, int KM>
cudaError_t launch_b(const void* w3, const void* v2, const void* g, void* dh, void* work,
                     void* split, int E, int IF, int O, int i_per_split,
                     cudaStream_t stream) {
  using C = BCfg<kSplit, P, TV, KM>;
  const bf16 *whi = static_cast<const bf16*>(w3), *wlo = nullptr;
  cudaError_t err;
  if constexpr (kSplit) {
    // float32 W3 [KM, IF, O] (a whole number of float4s) into its bf16
    // hi and lo arrays
    const size_t nw = (size_t)KM * IF * O;
    bf16* sp = static_cast<bf16*>(split);
    split_bf16_kernel<<<grid_for(nw / 4), NTHREADS, 0, stream>>>(
        static_cast<const float4*>(w3), nw / 4, reinterpret_cast<uint2*>(sp),
        reinterpret_cast<uint2*>(sp + nw));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    whi = sp;
    wlo = sp + nw;
  }
  // mid 32 is built for runtime O (kWide) alone
  auto kern = bwd_b_kernel<kSplit, P, true, TV, KM>;
  if constexpr (KM == MID)
    if (O == BO) kern = bwd_b_kernel<kSplit, P, false, TV, KM>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const int splits = (IF + i_per_split - 1) / i_per_split;
  const int slots = O / BO;  // CTAs along O
  const int partials = splits * slots;
  // a row's VI values of V2 move as one copy (16 bytes, bf16 8) when every
  // stage is whole and starts on the copy's size
  const int v2_quads = IF % C::VI == 0 && i_per_split % C::VI == 0 &&
                       reinterpret_cast<uintptr_t>(v2) % (C::VI * sizeof(TV)) == 0;
  kern<<<dim3((E + BE - 1) / BE, splits, slots), NTHREADS, C::SMEM, stream>>>(
      whi, wlo, static_cast<const TV*>(v2), static_cast<const float*>(g),
      static_cast<float*>(partials > 1 ? work : dh), E, IF, O, i_per_split, v2_quads);
  err = cudaGetLastError();
  if (err != cudaSuccess || partials == 1) return err;
  const size_t n = (size_t)E * KM;
  bwd_reduce_kernel<<<grid_for(n), NTHREADS, 0, stream>>>(
      static_cast<const float*>(work), partials, n, 0, static_cast<float*>(dh), nullptr);
  return cudaGetLastError();
}


}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch status
// (cudaGetLastError() right after its launches); 0 is success. Pointers are
// device pointers to contiguous tensors; the caller checks shapes: mid ==
// KM (128; 32 for the _m32 entry points, this file compiled with
// -DSE3_M32=1), O a multiple of 64 (or, in the float32-V2 units, 8, 16 or
// 32: the narrow arms of pairwise_narrow.cu, one O tile, which read neither
// split nor dv2_work), P in {1, 2, 3, 5, 7} (the conv_bf16 arm: 1, 3, 5,
// 7; mid 32: 1, 2), h/w3 bf16 or f32, the rest f32. Each 64-wide O tile is one CTA along the grid's z; their dV2
// (kernel A) and dH (kernel B) partials are summed in order by the reduce.

// Kernel A and its reduces: dv2 [E, P, IF], dw3 [KM, IF, O], db3 [IF, O].
// work holds splits x (KM*IF*O + IF*O) floats; every split must own at
// least one 64-edge tile. With more than one CTA along O, dv2_work holds
// that many [E, P, IF] float partials; it is not read otherwise. h, w3 and
// g start on 16 bytes. With float32 h/w3, split holds 2 * (E*KM +
// KM*IF*O) bf16 (h's hi and lo arrays, then W3's); it is not read
// otherwise. The _v16 entry points (this file compiled with -DSE3_V16=1)
// take v2 bf16, starting on 2 bytes.
#if SE3_V16
#define SE3_ENTRY(name) name##_v16
using TVU = bf16;
#elif SE3_M32
#define SE3_ENTRY(name) name##_m32
using TVU = float;
#else
#define SE3_ENTRY(name) name
using TVU = float;
#endif
extern "C" int SE3_ENTRY(se3_pairwise_bwd_a)(const void* h, const void* w3, const void* b3,
                                             const void* v2, const void* g, void* dv2,
                                             void* dv2_work, void* work, void* split,
                                             void* dw3, void* db3, int E, int IF, int O,
                                             int P, int splits, int h_is_bf16, void* stream) {
#if !SE3_V16
  if (E > 0 && IF > 0 && splits > 0 && SE3N::narrow(O)) {
    // one O tile, dV2 written whole; the edge splits' dW3 and dB3 partials
    // summed in split order
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        SE3N::launch_bwd_a(h_is_bf16 != 0, h, w3, b3, v2, g, dv2, work, E, IF, O, P, splits, s);
    if (err != cudaSuccess) return (int)err;
    const size_t n_w = (size_t)KMID * IF * O, n_b = (size_t)IF * O;
    bwd_reduce_kernel<<<grid_for(n_w + n_b), NTHREADS, 0, s>>>(
        static_cast<const float*>(work), splits, n_w, n_b, static_cast<float*>(dw3),
        static_cast<float*>(db3));
    return (int)cudaGetLastError();
  }
#endif
  if (E <= 0 || IF <= 0 || splits <= 0 || O <= 0 || O % BO)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SE3_A(PP)                                                                        \
  if (P == PP)                                                                           \
    return (int)(h_is_bf16 ? launch_a<false, PP, TVU, KMID>(h, w3, b3, v2, g, dv2,       \
                                                            dv2_work, work, split, dw3,  \
                                                            db3, E, IF, O, splits, s)    \
                           : launch_a<true, PP, TVU, KMID>(h, w3, b3, v2, g, dv2,        \
                                                           dv2_work, work, split, dw3,   \
                                                           db3, E, IF, O, splits, s));
  SE3_A(1)
#if !SE3_M32
  SE3_A(3) SE3_A(5) SE3_A(7)
#endif
#if !SE3_V16
  SE3_A(2)
#endif
#undef SE3_A
  return (int)cudaErrorInvalidValue;
}

// Kernel B: dh [E, KM]. With more than one partial (ceil(IF / i_per_split)
// i splits times the CTAs along O) work holds that many [E, KM] float
// partials; it is not read otherwise. w3 and g start on 16 bytes. With
// float32 w3, split holds 2 * KM*IF*O bf16 (W3's hi and lo arrays); it is
// not read otherwise.
extern "C" int SE3_ENTRY(se3_pairwise_bwd_b)(const void* w3, const void* v2, const void* g,
                                             void* dh, void* work, void* split, int E, int IF,
                                             int O, int P, int i_per_split, int w3_is_bf16,
                                             void* stream) {
#if !SE3_V16
  if (E > 0 && IF > 0 && i_per_split > 0 && SE3N::narrow(O)) {
    // one O tile; the i splits' dH partials summed in split order
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int parts = (IF + i_per_split - 1) / i_per_split;
    cudaError_t err = SE3N::launch_bwd_b(w3_is_bf16 != 0, w3, v2, g, parts > 1 ? work : dh, E,
                                         IF, O, P, i_per_split, s);
    if (err != cudaSuccess || parts == 1) return (int)err;
    const size_t n = (size_t)E * KMID;
    bwd_reduce_kernel<<<grid_for(n), NTHREADS, 0, s>>>(
        static_cast<const float*>(work), parts, n, 0, static_cast<float*>(dh), nullptr);
    return (int)cudaGetLastError();
  }
#endif
  if (E <= 0 || IF <= 0 || i_per_split <= 0 || O <= 0 || O % BO)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SE3_B(PP)                                                                         \
  if (P == PP)                                                                            \
    return (int)(w3_is_bf16 ? launch_b<false, PP, TVU, KMID>(w3, v2, g, dh, work, split, E, \
                                                             IF, O, i_per_split, s)       \
                            : launch_b<true, PP, TVU, KMID>(w3, v2, g, dh, work, split, E,  \
                                                            IF, O, i_per_split, s));
  SE3_B(1)
#if !SE3_M32
  SE3_B(3) SE3_B(5) SE3_B(7)
#endif
#if !SE3_V16
  SE3_B(2)
#endif
#undef SE3_B
  return (int)cudaErrorInvalidValue;
}
