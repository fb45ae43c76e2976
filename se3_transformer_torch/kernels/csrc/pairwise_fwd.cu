// Pairwise convolution with V2 given, for Hopper (sm_90a).
//
//   out[e, p, o] = sum_i V2[e, p, i] * R[e, i, o]
//   R[e, i, o]   = sum_m h[e, m] * W3[m, i, o] + b3[i, o]
//
// Replaces se3_transformer_tpu/kernels/pallas_pairwise.py::_fwd_kernel
// (driven by fused_pairwise_conv) on its floating-point path and its
// quantized-serving path (the w3_scale epilogue, below). As there, R is
// never written to device memory. V2 = basis . x is built outside the kernel (an einsum), and the
// degree pairs of one output degree arrive concatenated along i, so one
// launch covers every input degree: IF = sum over d_in of C * F runs to
// 1024 at the flagship shape (C = 64, four degrees).
//
// What bounds it on this card. At the flagship shape one hidden->hidden
// ConvSE3 (four launches, IF = 256, 640, 896, 1024; E = 32768 edges,
// mid = 128, O = 64) is 1.51 TFLOP of radial product against ~1.8 GB of
// V2. The conservative recipe runs it in float32. On fp32 FMAs that is
// 22.6 ms at the 67 TFLOP/s CUDA-core peak, and an FMA tile that reads
// shared memory every few FMAs reaches a third of it. So the float32
// product runs on the tensor cores as three bf16 passes: each float32
// operand x splits exactly into hi = bf16(x) and lo = bf16(x - hi)
// (together within 2^-16 of x, relative), and
//     h.W3 ~ h_hi.W_hi + h_hi.W_lo + h_lo.W_hi
// drops only h_lo.W_lo (~2^-16 of each product); the tensor cores'
// products are exact and their sums float32. Three passes are
// 3 x 1.51 TFLOP = 4.5 TFLOP at 989 TFLOP/s: 4.6 ms per hidden conv, plus
// the float32 epilogue (2 * E * sum(P * IF) * O = 58 GFLOP, 0.9 ms at the
// FMA peak) and ~1.8 GB of V2 (0.55 ms at 3.35 TB/s). bf16 h/W3 take one
// pass on the same tile.
//
// What the design does about it:
//  * A CTA owns 64 edges x 64 output channels with 8 warps (4 along edges
//    x 2 along O); the [edge, P, O-tile] accumulator stays in registers
//    over the loop over i, and the epilogue (R + b3) x V2 runs on the
//    mma.sync m16n8k16 accumulator registers, so R never leaves them.
//  * mma.sync, not wgmma. The P-deep accumulator is 16 * P registers a
//    thread (112 at P = 7), and h's hi and lo A fragments stay loaded for
//    the whole i loop (64 more): a 64 x N wgmma accumulator does not fit
//    beside them. The warp tile's A fragments match wgmma's register-A
//    layout, so a later wgmma tile keeps this epilogue.
//  * h is split into hi/lo bf16 as its tile is staged (once per CTA, from
//    float32 rows) and its fragments are loaded before the loop; the h
//    tiles borrow the ring's shared memory until then. W3 is split by
//    fwd_w3_split_kernel, once per call, into a bf16 hi array and a lo
//    array in scratch that the wrapper allocates; each i's [128 x 64] hi
//    and lo slices stream through a ring of STAGES (cp.async, 16 bytes a
//    thread), STAGES - 1 slices in flight while one is multiplied.
//  * Per kk (16 of mid) and per 8-column group the passes are issued in a
//    fixed order (hi.hi, hi.lo, lo.hi) into one accumulator: the same bits
//    on every run.
//  * V2[tile, :, i] is read in chunks of KI values of i by 16-byte
//    cp.async (rows are contiguous along i; 4-byte copies only when IF is
//    not a multiple of 4), double-buffered one chunk ahead; the ragged
//    tail of a chunk is zero-filled.
//  * Each CTA walks its i range in chunk order starting at a chunk set by
//    its edge tile, so that the CTAs on the card at one time fetch
//    different W3 slices rather than all the same one (faster in bf16 in
//    an A/B of both orders on an H100).
//  * Filling the card. Where the accumulator leaves room (P = 1, and bf16
//    P = 3) the tile is held to 128 registers and ~100 KB of shared memory
//    so that two CTAs share an SM and hide each other's barriers and
//    fetches (faster at those P in the same A/B). Elsewhere one CTA runs
//    per SM. The recipe streams E in 8 node chunks, so a launch has 4096
//    edges: 64 edge tiles. The i range is then split across grid.z
//    (i_per_split in kernels/pairwise.py, a function of the shapes, each
//    split a multiple of KI): each split writes a partial [E, P, O] to a
//    workspace and fwd_reduce_kernel sums the partials in split order. No
//    atomics: the result is the same bit for bit on every run.
//  * Ragged edge tails are masked: rows past E load zeros, store nothing.
// Where it stands (PERF.md, row #3): float32 runs at about 3.4x the
// speed of the FMA tile it replaced and under the FMA bound, ~4x its
// three-pass bound. The four edge-warps each read every W3 fragment with
// ldmatrix (~1 KB per 3 mma), and mma.sync issues from registers at well
// under the wgmma rate: the next step is wgmma with W3 read from shared
// memory by the hardware once per warpgroup, TMA (and a cluster
// multicast) for the W3 ring, and an epilogue that does not keep the
// P-deep accumulator beside two sets of A fragments.
//
// The scaled arm (kQ; se3_pairwise_fwd_q): quantized serving hands W3 as
// int8 or fp8 e4m3 storage with a float32 scale per (i, o), and
//     R[e, i, o] = (sum_m h[e, m] q[m, i, o]) * scale[i, o] + b3[i, o],
// JAX's `rt * st + b3`. Every int8 and e4m3 value is exact in bf16, so q
// needs no lo half: float32 h runs two bf16 passes (h_hi.q, h_lo.q, in that
// order per kk and column group) and bf16 h one, where the float32 arm
// runs three. W3's bytes fall from 4 a value (hi + lo) to 1. Each i's
// [128 x 64] slice of q goes by 16-byte cp.async (16 values a copy) into a
// ring of QSTAGES 8 KB landing slots, and is upcast to bf16 one position
// ahead of its product into one of two [MID][WS] tiles that the mma.sync
// B fragments read (ldmatrix), so the conversion costs no barrier of its
// own; no dequantized W3 is written to device memory. The scale multiplies
// the pass sum before b3 is added; the V2 epilogue, the i splits and their
// ordered reduce are the float arm's.
//
// The conv_bf16 arm (TV = bf16; entry point se3_pairwise_fwd_v16, compiled
// as a unit of its own with -DSE3_V16=1 so that the float32 instantiations
// are the code they were): V2 arrives stored bf16, as JAX's _fwd_kernel
// takes it, and is staged at 2 bytes a value, 16-byte cp.async of 8 values
// (a [BE][P*KI + 8] bf16 tile: 16 bytes of pad a row, which keeps the 8
// rows a warp's epilogue reads on distinct banks), or plain loads when IF
// is not a multiple of 8. The epilogue upcasts each staged value exactly
// to float32 as it reads it (JAX upcasts the V2 row right after its load);
// everything after is the float arm's, with float32 or bf16 h. No scaled
// arm: a quantized W3 beside bf16 V2 takes the plain version.
//
// The mid-32 arm (KM = 32; entry point se3_pairwise_fwd_m32, compiled as a
// unit of its own with -DSE3_M32=1): the SE3TransformerV2 family's per-m
// blocks (se3_transformer_tpu/v2/conv.py, through the same _fwd_kernel)
// have a radial trunk of width 32, and P = 1 (m = 0) or 2 (the -m, +m
// rows). h and W3 keep their width: no padding to 128, which would do the
// product four times over. The tile is the same with K = 32, two k-steps
// of 16 a value of i: each i's W3 slice is [32][64] (a quarter of the
// mid-128 one) and h's A fragments 8 (float32: 16) registers. What bounds
// it then: not the tensor cores. At V2's hidden block (E = 32768, O = 64,
// 28 launches, sum of IF 14784) the three passes are ~6 ms at the bf16
// peak, but a value of i carries only 24 mma.sync a warp (float32's three
// passes; bf16 8) against one barrier, a W3 slice copy and the P-deep
// epilogue; the per-i overhead of
// the loop (barrier and copy latency) is what the arm pays, partly hidden
// by two CTAs an SM where the accumulator leaves room (Cfg::BLOCKS). A
// stage of several values of i per barrier is the next step. Float V2 and
// a float W3 only (the scaled and conv_bf16 arms stay at mid 128), and P =
// 1 and 2 only: V2's rows; no model makes a mid-32 call of more rows, and
// each order is a kernel to build.
//
// P = 2 (V2's -m/+m row pair) is built beside 1, 3, 5 and 7 in the float
// arm at both widths: the epilogue reads P values of V2 a row from the
// staged tile one at a time, so nothing in it assumes P odd or P >= 3.

#include "common.cuh"

#ifndef SE3_V16
#define SE3_V16 0
#endif
#ifndef SE3_M32
#define SE3_M32 0
#endif
#if !SE3_V16
// the narrow-O arm (O = 8, 16 or 32) of se3_pairwise_fwd, a unit of its own
#include "pairwise_narrow.h"
#endif

namespace {

using namespace se3;

using bf16 = __nv_bfloat16;
constexpr int KI = 16;  // i values of V2 staged per chunk
constexpr int WS = Tile<bf16>::WS;
constexpr int W_SLICE = MID * WS;  // one staged [MID][BO] bf16 slice (the scaled arm's)
constexpr int QSTAGES = 4;         // the scaled arm's landing slots
constexpr int Q_SLICE = MID * BO;  // one landing slot: [MID][BO] bytes
// the radial width this unit's float arm is built for
constexpr int KMID = SE3_M32 ? MID32 : MID;

// The tile's shape by h's type T, P and the radial width KM (kQ: the
// scaled arm). BLOCKS CTAs share an SM where the P-deep accumulator, h's A
// fragments and R leave room for 128 registers a thread (at most 96 of
// them, ~113 KB of shared memory each; their barriers and fetch latencies
// then overlap): at mid 128, P = 1 and bf16 P = 3; at mid 32, P <= 3. The
// ring holds STAGES x (hi, lo) W3 slices for float32, STAGES x hi for
// bf16; the scaled arm's, two bf16 tiles and QSTAGES landing slots.
template <typename T, int P, bool kQ = false, typename TV = float, int KM = MID>
struct Cfg {
  static constexpr bool kSplit = sizeof(T) == 4;
  static constexpr int HS = Tile<bf16, KM>::HS;
  static constexpr int SLICE = KM * WS;  // one staged [KM][BO] bf16 slice
  static constexpr int REGS = 16 * P + (kSplit ? 2 : 1) * (KM / 16) * 4 + 16;
  static constexpr int BLOCKS = REGS <= 96 ? 2 : 1;
  static constexpr int STAGES = BLOCKS == 2 ? (kSplit ? 2 : 3) : (kSplit ? 3 : 6);
  static constexpr int SLICES = kSplit ? 2 : 1;
  // bytes of the W3 ring (the scaled arm: the tiles, then the landing slots)
  static constexpr size_t RING = kQ ? sizeof(bf16) * 2 * W_SLICE + (size_t)QSTAGES * Q_SLICE
                                    : sizeof(bf16) * (size_t)STAGES * SLICES * SLICE;
  // V2's row stride in the staged tile (values): 16 bytes of pad
  static constexpr int VS = P * KI + 16 / (int)sizeof(TV);
  static constexpr size_t SMEM = RING + sizeof(TV) * (size_t)2 * BE * VS;
};

// V2[e0 .. e0+BE, :, c0 .. c0+nk] -> a [BE][P*KI + 4] float tile (the row
// stride puts the 8 rows that a warp's epilogue reads on distinct banks);
// zeros past the tile's rows and past nk.
// conv_bf16 (TV = bf16): a [BE][P*KI + 8] bf16 tile, 16-byte copies of 8
// values where IF allows, else plain loads.
template <int P, typename TV>
__device__ __forceinline__ void load_v(TV* sv, const TV* __restrict__ v2, int e0,
                                       int rows, int IF, int c0, int nk, bool vec,
                                       int tid) {
  if constexpr (sizeof(TV) == 2) {
    constexpr int VS = P * KI + 8;
    if (vec) {  // IF % 8 == 0, c0 % 8 == 0 and nk % 8 == 0: 16-byte copies
      constexpr int Q8 = KI / 8;
      for (int idx = tid; idx < BE * P * Q8; idx += NTHREADS) {
        const int r = idx / (P * Q8), rest = idx - r * (P * Q8);
        const int p = rest / Q8, k = (rest - p * Q8) * 8;
        TV* dst = sv + r * VS + p * KI + k;
        if (r < rows && k < nk)
          cp_async16(dst, v2 + ((size_t)(e0 + r) * P + p) * IF + c0 + k);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int idx = tid; idx < BE * P * KI; idx += NTHREADS) {
        const int r = idx / (P * KI), rest = idx - r * (P * KI);
        const int p = rest / KI, k = rest - p * KI;
        sv[r * VS + p * KI + k] = r < rows && k < nk
                                      ? v2[((size_t)(e0 + r) * P + p) * IF + c0 + k]
                                      : __float2bfloat16(0.f);
      }
    }
  } else {
    constexpr int VS = P * KI + 4;
    if (vec) {  // IF % 4 == 0, c0 % 4 == 0 and nk % 4 == 0: 16-byte copies
      constexpr int Q4 = KI / 4;
      for (int idx = tid; idx < BE * P * Q4; idx += NTHREADS) {
        const int r = idx / (P * Q4), rest = idx - r * (P * Q4);
        const int p = rest / Q4, k = (rest - p * Q4) * 4;
        float* dst = sv + r * VS + p * KI + k;
        if (r < rows && k < nk)
          cp_async16(dst, v2 + ((size_t)(e0 + r) * P + p) * IF + c0 + k);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int idx = tid; idx < BE * P * KI; idx += NTHREADS) {
        const int r = idx / (P * KI), rest = idx - r * (P * KI);
        const int p = rest / KI, k = rest - p * KI;
        float* dst = sv + r * VS + p * KI + k;
        if (r < rows && k < nk)
          cp_async4(dst, v2 + ((size_t)(e0 + r) * P + p) * IF + c0 + k);
        else
          *dst = 0.f;
      }
    }
  }
}

// The CTA's float32 h rows [BE][KM] split into bf16 hi and lo tiles
// [BE][HS] (zeros past E); plain loads, once per CTA.
template <int KM>
__device__ __forceinline__ void split_h(bf16* shi, bf16* slo, const float* __restrict__ h,
                                        int e0, int rows, int tid) {
  constexpr int C4 = KM / 4, HS = Tile<bf16, KM>::HS;
  for (int idx = tid; idx < BE * C4; idx += NTHREADS) {
    const int r = idx / C4, c = (idx - r * C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = __ldg(reinterpret_cast<const float4*>(h + (size_t)(e0 + r) * KM + c));
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(x.z, x.w);
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(x.x - f01.x, x.y - f01.y);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(x.z - f23.x, x.w - f23.y);
    __nv_bfloat162* dh = reinterpret_cast<__nv_bfloat162*>(shi + r * HS + c);
    __nv_bfloat162* dl = reinterpret_cast<__nv_bfloat162*>(slo + r * HS + c);
    dh[0] = h01;
    dh[1] = h23;
    dl[0] = l01;
    dl[1] = l23;
  }
}

// R tile of one warp for one i: one bf16 pass, or the three split passes
// (hi.hi, hi.lo, lo.hi per kk and column group, in that order); K = KM.
template <bool kSplit, int KM>
__device__ __forceinline__ void radial_tile_split(float (&rs)[4][4],
                                                  const uint32_t (&ahi)[KM / 16][4],
                                                  const uint32_t (&alo)[KM / 16][4],
                                                  const bf16* swh, const bf16* swl, int wo,
                                                  int lane) {
  const int j = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KM / 16; ++kk) {
#pragma unroll
    for (int nb2 = 0; nb2 < 2; ++nb2) {
      const int off = (kk * 16 + (j & 1) * 8 + rr) * WS + wo * 32 + nb2 * 16 + (j >> 1) * 8;
      uint32_t bh[4];
      ldmatrix_x4_trans(bh, swh + off);
      mma_bf16(rs[nb2 * 2 + 0], ahi[kk], bh[0], bh[1]);
      mma_bf16(rs[nb2 * 2 + 1], ahi[kk], bh[2], bh[3]);
      if constexpr (kSplit) {
        uint32_t bl[4];
        ldmatrix_x4_trans(bl, swl + off);
        mma_bf16(rs[nb2 * 2 + 0], ahi[kk], bl[0], bl[1]);
        mma_bf16(rs[nb2 * 2 + 1], ahi[kk], bl[2], bl[3]);
        mma_bf16(rs[nb2 * 2 + 0], alo[kk], bh[0], bh[1]);
        mma_bf16(rs[nb2 * 2 + 1], alo[kk], bh[2], bh[3]);
      }
    }
  }
}

// The scaled arm's R tile of one warp for one i: h_hi.q, and with float32
// h (kLo) h_lo.q, per kk and column group in that order; q upcast to bf16.
template <bool kLo>
__device__ __forceinline__ void radial_tile_q(float (&rs)[4][4], const uint32_t (&ahi)[8][4],
                                              const uint32_t (&alo)[8][4], const bf16* sw,
                                              int wo, int lane) {
  const int j = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < MID / 16; ++kk) {
#pragma unroll
    for (int nb2 = 0; nb2 < 2; ++nb2) {
      const int off = (kk * 16 + (j & 1) * 8 + rr) * WS + wo * 32 + nb2 * 16 + (j >> 1) * 8;
      uint32_t bq[4];
      ldmatrix_x4_trans(bq, sw + off);
      mma_bf16(rs[nb2 * 2 + 0], ahi[kk], bq[0], bq[1]);
      mma_bf16(rs[nb2 * 2 + 1], ahi[kk], bq[2], bq[3]);
      if constexpr (kLo) {
        mma_bf16(rs[nb2 * 2 + 0], alo[kk], bq[0], bq[1]);
        mma_bf16(rs[nb2 * 2 + 1], alo[kk], bq[2], bq[3]);
      }
    }
  }
}

// Slice i of the quantized W3 [MID, IF, O] (columns o0 .. o0 + BO) into a
// landing slot [MID][BO] bytes: 16-byte cp.async, 16 values each.
__device__ __forceinline__ void load_q(uint8_t* slot, const uint8_t* __restrict__ q, int i,
                                       int IF, int O, int o0, int tid) {
  constexpr int CHUNKS = BO / 16;
  for (int idx = tid; idx < MID * CHUNKS; idx += NTHREADS) {
    const int m = idx / CHUNKS, ch = idx % CHUNKS;
    cp_async16(slot + m * BO + ch * 16, q + ((size_t)m * IF + i) * O + o0 + ch * 16);
  }
}

// A landing slot upcast to bf16 into a [MID][WS] tile (the layout that
// radial_tile_q's ldmatrix reads).
template <typename Q>
__device__ __forceinline__ void convert_q(bf16* tile, const uint8_t* slot, int tid) {
  constexpr int CHUNKS = BO / 16;
  for (int idx = tid; idx < MID * CHUNKS; idx += NTHREADS) {
    const int m = idx / CHUNKS, c = (idx % CHUNKS) * 16;
    uint4 lo, hi;
    q16_to_bf16<Q>(*reinterpret_cast<const uint4*>(slot + m * BO + c), lo, hi);
    *reinterpret_cast<uint4*>(tile + m * WS + c) = lo;
    *reinterpret_cast<uint4*>(tile + m * WS + c + 8) = hi;
  }
}

// Stage slice i of the (hi[, lo]) W3 arrays [KM, IF, O] into one ring stage.
template <bool kSplit, int KM>
__device__ __forceinline__ void load_slices(bf16* stage, const bf16* __restrict__ whi,
                                            const bf16* __restrict__ wlo, int i, int IF,
                                            int O, int o0, int tid) {
  load_w<bf16, KM>(stage, whi, i, IF, O, o0, tid);
  if constexpr (kSplit) load_w<bf16, KM>(stage + KM * WS, wlo, i, IF, O, o0, tid);
}

// T is h's type: float (split into hi/lo here, W3 given as its split
// arrays) or bf16 (W3 given as itself; wlo is unused). kQ: the scaled arm,
// W3 as the storage wq (fp8 e4m3 with `fp8`, else int8) with wscale [IF,
// O]; whi and wlo are unused. TV is V2's type: float, or bf16 (the
// conv_bf16 arm). KM: the radial width (h [E, KM], W3 [KM, IF, O]).
template <typename T, int P, bool kQ, typename TV, int KM>
__global__ void __launch_bounds__(NTHREADS, (Cfg<T, P, false, float, KM>::BLOCKS))
pairwise_fwd_kernel(const T* __restrict__ h, const bf16* __restrict__ whi,
                    const bf16* __restrict__ wlo, const uint8_t* __restrict__ wq,
                    const float* __restrict__ wscale, const float* __restrict__ b3,
                    const TV* __restrict__ v2, float* __restrict__ out, int E, int IF,
                    int O, int i_per_split, bool vec, bool fp8) {
  using C = Cfg<T, P, false, float, KM>;
  constexpr bool kSplit = C::kSplit;
  constexpr int STAGES = C::STAGES;
  constexpr int HS = C::HS, SLICE = C::SLICE;
  constexpr int STAGE = C::SLICES * SLICE;
  constexpr int VS = Cfg<T, P, kQ, TV, KM>::VS;
  static_assert(!kQ || KM == MID, "the scaled arm is built for mid 128");
  static_assert((kSplit ? 2 : 1) * BE * HS <= (kQ ? 2 * W_SLICE : STAGES * STAGE),
                "h tiles fit the ring");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);  // STAGES x STAGE (kQ: 2 tiles)
  // kQ: the landing slots after the two tiles
  uint8_t* sL = smem + sizeof(bf16) * 2 * W_SLICE;
  TV* sV = reinterpret_cast<TV*>(smem + Cfg<T, P, kQ, float, KM>::RING);  // 2 x [BE][VS]
  // the h tiles [BE][HS] (hi, and lo when split) take the ring's space
  // until their fragments are in registers
  bf16* sHh = sW;
  bf16* sHl = sW + BE * HS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we = warp & 3, wo = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int e0 = blockIdx.x * BE, o0 = blockIdx.y * BO;
  const int rows = min(BE, E - e0);
  // this split's i range; the wrapper leaves no split empty
  const int i_lo = blockIdx.z * i_per_split;
  const int n_i = min(IF, i_lo + i_per_split) - i_lo;
  // The range is walked in chunks of KI, starting at chunk `rot` (a
  // function of the edge tile), so that the CTAs resident at one time
  // fetch different W3 slices. Positions past n_i (in the last, partial
  // chunk) only keep the pipeline's count.
  const int n_ch = (n_i + KI - 1) / KI;
  const int rot = (int)(blockIdx.x % n_ch);
  const int n_pos = n_ch * KI;
  auto chunk_of = [&](int j) { return j + rot < n_ch ? j + rot : j + rot - n_ch; };
  auto local_i = [&](int pos) { return chunk_of(pos / KI) * KI + pos % KI; };

  // h's A fragments, loaded once: from the float32 rows split into hi and
  // lo, or from the bf16 rows
  uint32_t ahi[KM / 16][4], alo[KM / 16][4];
  if constexpr (kSplit) {
    split_h<KM>(sHh, sHl, h, e0, rows, tid);
  } else {
    load_h<T, KM>(sHh, h, e0, rows, tid);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  load_afrag<KM>(ahi, sHh, we, lane);
  if constexpr (kSplit) load_afrag<KM>(alo, sHl, we, lane);
  __syncthreads();  // the ring takes the h tiles' space from here

  // the ring's first STAGES - 1 slices, one cp.async group each; the
  // first V2 chunk rides in the first group
  {
    const int c = chunk_of(0);
    load_v<P>(sV, v2, e0, rows, IF, i_lo + c * KI, min(KI, n_i - c * KI), vec, tid);
  }
  auto valid = [&](int pos) { return pos < n_pos && local_i(pos) < n_i; };
  // kQ: slice pos's landing slot upcast into tile pos % 2
  auto convert = [&](int pos) {
    bf16* tile = sW + (pos & 1) * W_SLICE;
    const uint8_t* slot = sL + (pos % QSTAGES) * Q_SLICE;
    if (fp8)
      convert_q<__nv_fp8_e4m3>(tile, slot, tid);
    else
      convert_q<int8_t>(tile, slot, tid);
  };
  if constexpr (kQ) {
    // QSTAGES landing slots, one group each; slice 0 upcast before the loop
#pragma unroll
    for (int s = 0; s < QSTAGES; ++s) {
      if (valid(s)) load_q(sL + s * Q_SLICE, wq, i_lo + local_i(s), IF, O, o0, tid);
      cp_async_commit();
    }
    cp_async_wait<QSTAGES - 1>();
    __syncthreads();
    if (valid(0)) convert(0);
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_pos && local_i(s) < n_i)
        load_slices<kSplit, KM>(sW + s * STAGE, whi, wlo, i_lo + local_i(s), IF, O, o0, tid);
      cp_async_commit();
    }
  }

  float acc[P][4][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[p][nb][v] = 0.f;

  const int e_lo = we * 16 + g, e_hi = e_lo + 8;

  for (int n = 0; n < n_pos; ++n) {
    const int j = n / KI, k = n - j * KI;
    const int il = local_i(n);
    // slice n has landed (each iteration commits one group), and every
    // thread is done with iteration n - 1's stage and V2 buffer. kQ: slice
    // n + 1 has landed, and slice n's tile (upcast in iteration n - 1) is
    // written
    if constexpr (kQ)
      cp_async_wait<QSTAGES - 2>();
    else
      cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the stage freed by iteration n - 1 and, at a chunk's first
    // position, the V2 buffer freed by the previous chunk (kQ: the landing
    // slot of slice n, upcast in iteration n - 1)
    if constexpr (kQ) {
      if (valid(n + QSTAGES))
        load_q(sL + (n % QSTAGES) * Q_SLICE, wq, i_lo + local_i(n + QSTAGES), IF, O, o0, tid);
    } else {
      const int nxt = n + STAGES - 1;
      if (nxt < n_pos && local_i(nxt) < n_i)
        load_slices<kSplit, KM>(sW + (nxt % STAGES) * STAGE, whi, wlo, i_lo + local_i(nxt), IF,
                                O, o0, tid);
    }
    if (k == 0 && j + 1 < n_ch) {
      const int c = chunk_of(j + 1);
      load_v<P>(sV + ((j + 1) & 1) * BE * VS, v2, e0, rows, IF, i_lo + c * KI,
                min(KI, n_i - c * KI), vec, tid);
    }
    cp_async_commit();
    // kQ: slice n + 1 into the other tile, read after the next barrier
    if constexpr (kQ)
      if (valid(n + 1)) convert(n + 1);
    if (il >= n_i) continue;
    const int i = i_lo + il;

    float r[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) r[nb][v] = 0.f;
    if constexpr (kQ) {
      radial_tile_q<kSplit>(r, ahi, alo, sW + (n & 1) * W_SLICE, wo, lane);
      // the dequant epilogue: (h . q) * scale, before b3
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = o0 + wo * 32 + nb * 8 + 2 * t;
        const float2 sc = __ldg(reinterpret_cast<const float2*>(wscale + (size_t)i * O + col));
        r[nb][0] *= sc.x;
        r[nb][1] *= sc.y;
        r[nb][2] *= sc.x;
        r[nb][3] *= sc.y;
      }
    } else {
      const bf16* sw = sW + (n % STAGES) * STAGE;
      radial_tile_split<kSplit, KM>(r, ahi, alo, sw, sw + SLICE, wo, lane);
    }

    // epilogue: acc[p] += V2[e, p, i] * (R + b3)
    const TV* sv = sV + (j & 1) * BE * VS + k;
    float vl[P], vh[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      vl[p] = to_float(sv[e_lo * VS + p * KI]);
      vh[p] = to_float(sv[e_hi * VS + p * KI]);
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int col = o0 + wo * 32 + nb * 8 + 2 * t;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b3 + (size_t)i * O + col));
      const float r0 = r[nb][0] + bb.x, r1 = r[nb][1] + bb.y;
      const float r2 = r[nb][2] + bb.x, r3 = r[nb][3] + bb.y;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        acc[p][nb][0] = fmaf(vl[p], r0, acc[p][nb][0]);
        acc[p][nb][1] = fmaf(vl[p], r1, acc[p][nb][1]);
        acc[p][nb][2] = fmaf(vh[p], r2, acc[p][nb][2]);
        acc[p][nb][3] = fmaf(vh[p], r3, acc[p][nb][3]);
      }
    }
  }
  cp_async_wait<0>();

  // this split's [E, P, O] (the output itself when there is one split)
  float* dst = out + (size_t)blockIdx.z * E * P * O;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int col = o0 + wo * 32 + nb * 8 + 2 * t;
      if (e_lo < rows)
        *reinterpret_cast<float2*>(dst + ((size_t)(e0 + e_lo) * P + p) * O + col) =
            make_float2(acc[p][nb][0], acc[p][nb][1]);
      if (e_hi < rows)
        *reinterpret_cast<float2*>(dst + ((size_t)(e0 + e_hi) * P + p) * O + col) =
            make_float2(acc[p][nb][2], acc[p][nb][3]);
    }
}

// float32 W3 -> its bf16 hi and lo arrays (hi = bf16(w), lo = bf16(w - hi)).
__global__ void fwd_w3_split_kernel(const float4* __restrict__ w, size_t n4,
                                    uint2* __restrict__ hi, uint2* __restrict__ lo) {
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < n4;
       j += (size_t)gridDim.x * blockDim.x) {
    const float4 x = w[j];
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(x.z, x.w);
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(x.x - f01.x, x.y - f01.y);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(x.z - f23.x, x.w - f23.y);
    hi[j] = make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                       *reinterpret_cast<const uint32_t*>(&h23));
    lo[j] = make_uint2(*reinterpret_cast<const uint32_t*>(&l01),
                       *reinterpret_cast<const uint32_t*>(&l23));
  }
}

// out = the splits' partials summed in split order (deterministic).
__global__ void fwd_reduce_kernel(const float4* __restrict__ part, int splits, size_t n4,
                                  float4* __restrict__ out) {
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < n4;
       j += (size_t)gridDim.x * blockDim.x) {
    float4 s = part[j];
    for (int k = 1; k < splits; ++k) {
      const float4 v = part[(size_t)k * n4 + j];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[j] = s;
  }
}

unsigned grid_for(size_t n4) {
  const size_t blocks = (n4 + NTHREADS - 1) / NTHREADS;
  return (unsigned)(blocks > 4096 ? 4096 : blocks);
}

// kQ: w3 is the quantized storage (fp8 e4m3 with `fp8`, else int8) and
// wscale its scales; w3_split is unused. TV: V2's type. KM: the radial width.
template <typename T, int P, bool kQ, typename TV = float, int KM = MID>
cudaError_t launch(const void* h, const void* w3, const void* wscale, const void* b3,
                   const void* v2, void* out, void* work, void* w3_split, int E, int IF,
                   int O, int i_per_split, bool fp8, cudaStream_t stream) {
  constexpr bool kSplit = Cfg<T, P>::kSplit;
  constexpr size_t smem = Cfg<T, P, kQ, TV, KM>::SMEM;
  const bf16 *whi = static_cast<const bf16*>(w3), *wlo = nullptr;
  cudaError_t err;
  if constexpr (kSplit && !kQ) {
    // W3 [KM, IF, O] is a whole number of float4s (O % 64 == 0)
    const size_t n4 = (size_t)KM * IF * O / 4;
    uint2* hi = static_cast<uint2*>(w3_split);
    fwd_w3_split_kernel<<<grid_for(n4), NTHREADS, 0, stream>>>(
        static_cast<const float4*>(w3), n4, hi, hi + n4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    whi = static_cast<const bf16*>(w3_split);
    wlo = whi + (size_t)KM * IF * O;
  }
  auto kern = pairwise_fwd_kernel<T, P, kQ, TV, KM>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int splits = (IF + i_per_split - 1) / i_per_split;
  // 16-byte V2 copies (4 float values or 8 bf16) need every row and chunk
  // start on 16 bytes
  constexpr int VEC = 16 / sizeof(TV);
  const bool vec = IF % VEC == 0 && i_per_split % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(v2) % 16 == 0;
  dim3 grid((E + BE - 1) / BE, O / BO, splits);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(h), kQ ? nullptr : whi, wlo,
      kQ ? static_cast<const uint8_t*>(w3) : nullptr, static_cast<const float*>(wscale),
      static_cast<const float*>(b3), static_cast<const TV*>(v2),
      static_cast<float*>(splits > 1 ? work : out), E, IF, O, i_per_split, vec, fp8);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n4 = (size_t)E * P * O / 4;  // O is a multiple of 64
  fwd_reduce_kernel<<<grid_for(n4), NTHREADS, 0, stream>>>(
      static_cast<const float4*>(work), splits, n4, static_cast<float4*>(out));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the launch status
// (cudaGetLastError() right after the launches); 0 is success. Pointers are
// device pointers to contiguous tensors; the caller checks shapes: h [E,
// KM], w3 [KM, IF, O] with KM = 128 (se3_pairwise_fwd) or 32
// (se3_pairwise_fwd_m32, this file compiled with -DSE3_M32=1), O % 64 == 0
// or O in {8, 16, 32} (the narrow arm, pairwise_narrow.cu, which does not
// read w3_split), b3 [IF, O], v2 [E, P, IF] with P in {1, 2, 3, 5, 7} (at
// mid 32: 1, 2), out [E, P, O]; h/w3 bf16 or f32, the rest f32. With
// more than one split (ceil(IF / i_per_split)) work holds that many
// [E, P, O] float partials; it is not read otherwise. With float32 h/w3,
// w3_split holds 2 * KM * IF * O bf16 (W3's hi array, then its lo array);
// it is not read otherwise.
#if SE3_M32
#define SE3_FWD_ENTRY se3_pairwise_fwd_m32
#else
#define SE3_FWD_ENTRY se3_pairwise_fwd
#endif
#if !SE3_V16
extern "C" int SE3_FWD_ENTRY(const void* h, const void* w3, const void* b3, const void* v2,
                             void* out, void* work, void* w3_split, int E, int IF, int O,
                             int P, int i_per_split, int h_is_bf16, void* stream) {
  if (E <= 0) return 0;
  if (O <= 0 || (O % BO != 0 && !SE3N::narrow(O)) || IF <= 0 || i_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (SE3N::narrow(O)) {
    // one O tile; the i splits' partials summed in split order
    const int splits = (IF + i_per_split - 1) / i_per_split;
    cudaError_t err = SE3N::launch_fwd(h_is_bf16 != 0, h, w3, b3, v2, splits > 1 ? work : out,
                                       E, IF, O, P, i_per_split, s);
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t n4 = (size_t)E * P * O / 4;  // O is a multiple of 8
    fwd_reduce_kernel<<<grid_for(n4), NTHREADS, 0, s>>>(
        static_cast<const float4*>(work), splits, n4, static_cast<float4*>(out));
    return (int)cudaGetLastError();
  }
#define SE3_F(PP)                                                                          \
  if (P == PP)                                                                             \
    return (int)(h_is_bf16 ? launch<bf16, PP, false, float, KMID>(                         \
                                 h, w3, nullptr, b3, v2, out, work, w3_split, E, IF, O,    \
                                 i_per_split, false, s)                                    \
                           : launch<float, PP, false, float, KMID>(                        \
                                 h, w3, nullptr, b3, v2, out, work, w3_split, E, IF, O,    \
                                 i_per_split, false, s));
  SE3_F(1) SE3_F(2)
#if !SE3_M32
  SE3_F(3) SE3_F(5) SE3_F(7)
#endif
#undef SE3_F
  return (int)cudaErrorInvalidValue;
}
#endif

#if !SE3_V16 && !SE3_M32
// The scaled arm (quantized serving). q [128, IF, O] int8, or fp8 e4m3
// with fp8 != 0 (starting on 16 bytes); scale [IF, O] float32 (the [1, IF,
// O] keepdims array); the rest as se3_pairwise_fwd. No W3 split, no
// dequantized copy: the kernel reads q as it is.
extern "C" int se3_pairwise_fwd_q(const void* h, const void* q, const void* scale,
                                  const void* b3, const void* v2, void* out, void* work, int E,
                                  int IF, int O, int P, int i_per_split, int h_is_bf16, int fp8,
                                  void* stream) {
  if (E <= 0) return 0;
  if (O <= 0 || O % BO != 0 || IF <= 0 || i_per_split <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SE3_F(PP)                                                                          \
  if (P == PP)                                                                             \
    return (int)(h_is_bf16 ? launch<bf16, PP, true>(h, q, scale, b3, v2, out, work,        \
                                                    nullptr, E, IF, O, i_per_split,        \
                                                    fp8 != 0, s)                           \
                           : launch<float, PP, true>(h, q, scale, b3, v2, out, work,       \
                                                     nullptr, E, IF, O, i_per_split,       \
                                                     fp8 != 0, s));
  SE3_F(1) SE3_F(3) SE3_F(5) SE3_F(7)
#undef SE3_F
  return (int)cudaErrorInvalidValue;
}
#elif SE3_V16
// The conv_bf16 arm: se3_pairwise_fwd's arguments with v2 [E, P, IF] bf16
// (starting on 2 bytes; 16 for its 16-byte copies).
extern "C" int se3_pairwise_fwd_v16(const void* h, const void* w3, const void* b3,
                                    const void* v2, void* out, void* work, void* w3_split,
                                    int E, int IF, int O, int P, int i_per_split, int h_is_bf16,
                                    void* stream) {
  if (E <= 0) return 0;
  if (O <= 0 || O % BO != 0 || IF <= 0 || i_per_split <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SE3_F(PP)                                                                          \
  if (P == PP)                                                                             \
    return (int)(h_is_bf16 ? launch<bf16, PP, false, bf16>(h, w3, nullptr, b3, v2, out,    \
                                                           work, w3_split, E, IF, O,       \
                                                           i_per_split, false, s)          \
                           : launch<float, PP, false, bf16>(h, w3, nullptr, b3, v2, out,   \
                                                            work, w3_split, E, IF, O,      \
                                                            i_per_split, false, s));
  SE3_F(1) SE3_F(3) SE3_F(5) SE3_F(7)
#undef SE3_F
  return (int)cudaErrorInvalidValue;
}
#endif
