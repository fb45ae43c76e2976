// Narrow-O arms of the V2-given pairwise forward (kernel #3) and of its
// backward (kernels A and B), for Hopper (sm_90a): O = 8, 16 or 32 output
// channels, where the wide kernels (pairwise_fwd.cu, pairwise_bwd.cu) tile
// O by 64.
//
//   out[e, p, o] = sum_i V2[e, p, i] * R[e, i, o],
//   R[e, i, o]   = sum_m h[e, m] * W3[m, i, o] + b3[i, o]
//   dV2[e, p, i] = sum_o g[e, p, o] * R[e, i, o]
//   dR [e, i, o] = sum_p V2[e, p, i] * g[e, p, o]
//   dW3[m, i, o] = sum_e h[e, m] * dR[e, i, o],   dB3[i, o] = sum_e dR[e, i, o]
//   dH [e, m]    = sum_{i, o} dR[e, i, o] * W3[m, i, o]
//
// Replaces se3_transformer_tpu/kernels/pallas_pairwise.py::_fwd_kernel and
// ::_bwd_a_kernel / ::_bwd_b_kernel at the widths the Pallas kernels take
// and the 64-wide tiles do not: the JAX DenoiseConfig model (dim 8, heads 2
// x dim_head 8: O = 8 and 16) and the O = 32 pairs of af2_refinement's,
// egnn_stress's and molecular_edges' conv_in and conv_out. As there, R and
// dR never reach device memory.
//
// What bounds it on this card. At those widths a call is small: the
// DenoiseConfig trainer's micro-batch has E = 96 x 8 edges, IF = C * F = 8
// or 24, so a forward is ~0.04 GFLOP over ~0.4 MB of h and V2, a few
// microseconds at either peak; launch latency and the one wave of CTAs
// bound it, not the tensor cores. af2_refinement's O = 32 pairs (E =
// 12288, IF 32 or 96) are 3.2-9.7 GFLOP a radial product: 0.05-0.14 ms on
// the float32 CUDA cores, 0.01-0.03 ms as three bf16 passes on the tensor
// cores.
//
// What the design does about it: the simplest tile that is right. O is
// one tile of ON = 16 (O = 8 or 16) or 32 columns; the columns past O are
// zero at load (W3, b3, g) and are not stored, so W3 and b3 are never
// padded in device memory and an O of 8 does no product past its own
// columns but in the masked half of the tile. i walks in chunks of NI = 4
// values behind two barriers a chunk; a chunk's tail past IF (or past a
// split's end) loads zeros and stores nothing, so IF needs no multiple of
// anything. Every CTA has 256 threads (8 warps). Every staging loop keeps
// several global loads a thread in flight (`stage`: up to 16 values; the
// W3 and h tiles: 8 quads): one load then its store per iteration left
// the CTAs waiting out the memory latency 32-64 times in a row (the first
// build: 39-160 us a #3 launch at the DenoiseConfig shapes). Every product
// runs on mma.sync m16n8k16 with float32 accumulators; float32 operands are
// split into bf16 hi + lo and the lo.lo pass is dropped, as in the wide
// kernels, and the arms agree with the plain version within 1e-5 of its
// largest value.
//  * #3: one CTA per 64-edge tile and i split (grid.z, the wrapper's
//    i_per_split, partials summed in split order by the wide arm's reduce).
//    The radial product runs on the tensor cores, as in the wide #3 and in
//    #1: mma.sync m16n8k16, warps 4 along edges x 2 along the tile's
//    columns (ON / 2 each), h's A fragments in registers for the whole
//    call, W3's chunk staged as bf16 [NI][MID][ON + 8] (rows padded by 16
//    bytes: the 8 rows an ldmatrix reads fall in distinct banks) and read
//    by ldmatrix.trans. float32 h and W3 are split into bf16 hi + lo
//    and take three passes (hi.hi, hi.lo, lo.hi), bf16 ones one. R stays
//    in the accumulator layout, where the P-contraction with V2 and b3 runs
//    on the float32 CUDA cores into a [P][ON / 16][4] accumulator. (The
//    first build ran the product on float32 FMAs, one edge a thread: 2.5x
//    the plain version at af2's O = 32 pairs.)
//  * A: one CTA per chunk of NI values of i and edge split (bwd_splits),
//    W3's chunk staged once as bf16 [MID][NI * ON + 8] (hi + lo for
//    float32). Per edge tile, h staged as bf16 [BE][MID + 8] (hi + lo for
//    float32): R = h.W3 + b3 on mma.sync (three passes for float32, one
//    for bf16) into a float tile; thread (e, i) writes dV2 (it owns every
//    o of it: no partial over O) and turns its R row into dR in place and
//    into bf16 hi + lo; then dW3 += h^T.dR on mma.sync (h by ldmatrix.trans
//    of the same tile; h_hi.dR_hi + h_hi.dR_lo + h_lo.dR_hi, two passes
//    for bf16 h), warps 4 along m (32 rows) x 2 along the chunk's columns,
//    in registers over the split's edge tiles, and dB3 sums the float dR
//    in edge order. The partial dW3 and dB3 of each split go to the
//    workspace in the wide arm's layout, summed in split order by
//    bwd_reduce_kernel. (The first build ran both products on float32
//    FMAs: 1.8x the plain version at af2's largest pair.)
//  * B: one CTA per 64-edge tile and i split. Thread (e, i) builds dR
//    into shared memory as bf16 hi + lo [BE][NI * ON + 8]; then dR.W3^T
//    runs on mma.sync m16n8k16, warps 4 along edges x 2 along m (64 each),
//    both operands by ldmatrix from row-major tiles (W3's chunk staged
//    bf16 [MID][NI * ON + 8], hi + lo for float32 W3): dR_hi.W_hi +
//    dR_lo.W_hi (+ dR_hi.W_lo for float32 W3), as the wide B. (The first
//    build ran it on float32 FMAs: 3.6x the plain version at af2's
//    largest pair.)
// No atomics: every output is the same bits on every run.
//
// The radial width KM is a template parameter: 128, or 32 (V2's per-m
// blocks; the mid-32 unit, pairwise_narrow.cu with -DSE3_M32=1). At 32 the
// products' K (#3's R, A's R) is two k-steps of 16, and the products whose
// rows or columns run over m change their warp roles: A's dW3 takes its 32
// rows in one warp row (8 warps along the chunk's columns, K / 8 each, in
// place of 4 x 2), B's dH 16 columns of m a warp (in place of 64). What
// bounds the arm at the JAX sweep's V2 shape (dim 8, n 128, k 12, degree 6:
// E = 1536, IF = 8 to 96, P 1 or 2) is launch latency and the one wave of
// CTAs, as at mid 128.
#pragma once

#include "common.cuh"
#include "pairwise_narrow.h"

namespace SE3N {

using se3::BE;
using se3::MID;
using se3::NTHREADS;
using se3::to_float;

constexpr int NI = 4;          // i values per chunk

// the thread roles: (edge, i value) for dR; 8 warps, 4 along 16-row
// edge tiles x 2 along the columns (or KM / 32 along 32-row m tiles x the
// rest along the columns), for the products
static_assert(NI * BE == NTHREADS && NTHREADS == 8 * 32 && BE == 4 * 16,
              "the thread roles cover the CTA");

// The narrow O tile for an O of 8, 16 or 32 (narrow(O), pairwise_narrow.h).
inline int tile_for(int O) { return O <= 16 ? 16 : 32; }

// Shared memory (bytes) of each kernel by the tile width ON, P and the
// radial width KM; every buffer starts on 16 bytes.
template <int ON, int P, int KM>
struct NCfg {
  static_assert(KM % 32 == 0 && KM <= 128, "KM / 32 warp rows of dW3");
  static constexpr int K = NI * ON;  // a chunk's (i, o) columns
  static constexpr int B3 = NI * ON, V = BE * P * NI;
  // #3's bf16 W3 tile (hi, then lo): [NI][KM][WSN]
  static constexpr int WSN = ON + 8, WB = NI * KM * WSN;
  static constexpr size_t FWD = sizeof(__nv_bfloat16) * 2 * (size_t)WB +
                                sizeof(float) * (size_t)(B3 + V);
  // A's and B's bf16 tiles (hi, then lo): W3's chunk [KM][KP], dR [BE][KP]
  // and A's h [BE][HP]; A's float R + b3, then dR, [BE][RS]
  static constexpr int KP = K + 8, HP = KM + 8, RS = K + 4;
  static constexpr size_t A = sizeof(__nv_bfloat16) * 2 * (size_t)(KM * KP + BE * HP + BE * KP) +
                              sizeof(float) * (size_t)(BE * RS + B3 + V);
  static constexpr size_t B = sizeof(__nv_bfloat16) * 2 * (size_t)(KM + BE) * KP +
                              sizeof(float) * (size_t)V;
  // A's dW3 roles: KM / 32 warp rows of 32 m, the rest of the 8 warps along
  // the chunk's K columns, NC each (NBD 8-column blocks)
  static constexpr int WARPS_M = KM / 32, WARPS_N = 8 / WARPS_M;
  static constexpr int NC = K / WARPS_N, NBD = NC / 8;
  static_assert(B3 % 4 == 0 && V % 4 == 0 && WB % 8 == 0 && KP % 8 == 0 &&
                    (BE * RS) % 4 == 0,
                "16-byte buffer starts");
  static_assert(A <= 232448 && B <= 232448 && FWD <= 232448, "fits one SM");
};

// The largest divisor of n that is at most 16: how many loads of a
// staging loop a thread keeps in flight at once.
__host__ __device__ constexpr int batch_of(int n, int b = 16) {
  return n % b == 0 ? b : batch_of(n, b - 1);
}

// Stage COUNT values (a multiple of NTHREADS): thread tid loads index tid
// + k * NTHREADS for every k, a batch of loads issued before any of their
// stores, so that the batch's global latencies overlap rather than add up.
template <int COUNT, typename Load, typename Store>
__device__ __forceinline__ void stage(int tid, Load load, Store store) {
  static_assert(COUNT % NTHREADS == 0, "whole rounds of the CTA");
  constexpr int N = COUNT / NTHREADS, B = batch_of(N);
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += B) {
    float v[B];
#pragma unroll
    for (int k = 0; k < B; ++k) v[k] = load(tid + (k0 + k) * NTHREADS);
#pragma unroll
    for (int k = 0; k < B; ++k) store(tid + (k0 + k) * NTHREADS, v[k]);
  }
}

// Four consecutive W3 values (16 bytes of float32, 8 of bf16: O is a
// multiple of 8, so a quad of o starting at a multiple of 4 is aligned)
// as float.
__device__ __forceinline__ float4 load_quad(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

// Four float values at hi (8-byte aligned) as bf16, and with kLo the rest
// (v - hi) as bf16 at lo.
template <bool kLo>
__device__ __forceinline__ void store_split(__nv_bfloat16* hi, __nv_bfloat16* lo, float4 v) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&h01);
  u.y = *reinterpret_cast<const uint32_t*>(&h23);
  *reinterpret_cast<uint2*>(hi) = u;
  if constexpr (kLo) {
    const __nv_bfloat162 l01 =
        __floats2bfloat162_rn(v.x - __low2float(h01), v.y - __high2float(h01));
    const __nv_bfloat162 l23 =
        __floats2bfloat162_rn(v.z - __low2float(h23), v.w - __high2float(h23));
    u.x = *reinterpret_cast<const uint32_t*>(&l01);
    u.y = *reinterpret_cast<const uint32_t*>(&l23);
    *reinterpret_cast<uint2*>(lo) = u;
  }
}

// The same slice [KM][NI][ON] as bf16 [NI][KM][ON + 8] for #3's mma.sync B
// operand: whi its values rounded to bf16, and for float32 W3 wlo the rest
// (v - hi) rounded to bf16 (wlo is not written for bf16 W3, which whi holds
// exactly). A thread stages quads of o, up to 8 loads in flight at a time,
// in a loop the compiler does not unroll: the A fragments the kernel keeps
// for the whole call leave no registers for more.
template <int ON, int KM, typename T>
__device__ __forceinline__ void load_w_bf16(__nv_bfloat16* whi, __nv_bfloat16* wlo,
                                            const T* __restrict__ w3, int i0, int i_end,
                                            int IF, int O, int tid) {
  constexpr int WSN = ON + 8, Q = ON / 4, N = NI * KM * Q / NTHREADS, B = N < 8 ? N : 8;
  static_assert(NI * KM * Q % NTHREADS == 0 && N % B == 0, "whole rounds of the CTA");
#pragma unroll 1
  for (int k0 = 0; k0 < N; k0 += B) {
    float4 v[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int idx = tid + (k0 + k) * NTHREADS;
      const int o = 4 * (idx % Q), m = (idx / Q) % KM, i = i0 + idx / (Q * KM);
      v[k] = i < i_end && o < O ? load_quad(w3 + ((size_t)m * IF + i) * O + o)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int idx = tid + (k0 + k) * NTHREADS;
      const int at = (idx / Q) * WSN + 4 * (idx % Q);
      store_split<sizeof(T) == 4>(whi + at, wlo + at, v[k]);
    }
  }
}

// The same slice as bf16 [KM][KP] rows of m (a row's (i, o) columns
// contiguous, KP = NI * ON + 8) for kernel B's mma.sync B operand: whi
// and, for float32 W3, wlo as load_w_bf16 splits them. Quads of o, up to
// 8 loads in flight at a time.
template <int ON, int KM, typename T>
__device__ __forceinline__ void load_wk_bf16(__nv_bfloat16* whi, __nv_bfloat16* wlo,
                                             const T* __restrict__ w3, int i0, int i_end,
                                             int IF, int O, int tid) {
  constexpr int KP = NI * ON + 8, Q = ON / 4, N = NI * KM * Q / NTHREADS, B = N < 8 ? N : 8;
  static_assert(NI * KM * Q % NTHREADS == 0 && N % B == 0, "whole rounds of the CTA");
#pragma unroll 1
  for (int k0 = 0; k0 < N; k0 += B) {
    float4 v[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int idx = tid + (k0 + k) * NTHREADS;
      const int o = 4 * (idx % Q), il = (idx / Q) % NI, m = idx / (Q * NI), i = i0 + il;
      v[k] = i < i_end && o < O ? load_quad(w3 + ((size_t)m * IF + i) * O + o)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int idx = tid + (k0 + k) * NTHREADS;
      const int at = (idx / (Q * NI)) * KP + 4 * (idx % (Q * NI));
      store_split<sizeof(T) == 4>(whi + at, wlo + at, v[k]);
    }
  }
}

// h rows e0 .. e0 + BE as bf16 [BE][KM + 8] for kernel A's mma.sync
// operands: hhi and, for float32 h, hlo as load_w_bf16 splits them (zeros
// past E). Quads of m, a thread's loads (8 at KM = 128) in flight at once.
template <int KM, typename T>
__device__ __forceinline__ void load_h_bf16(__nv_bfloat16* hhi, __nv_bfloat16* hlo,
                                            const T* __restrict__ h, int e0, int rows,
                                            int tid) {
  constexpr int HP = KM + 8, Q = KM / 4, N = BE * Q / NTHREADS;
  static_assert(BE * Q % NTHREADS == 0, "whole rounds of the CTA");
  float4 v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int idx = tid + k * NTHREADS, r = idx / Q;
    v[k] = r < rows ? load_quad(h + (size_t)e0 * KM + 4 * idx) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int idx = tid + k * NTHREADS, at = (idx / Q) * HP + 4 * (idx % Q);
    store_split<sizeof(T) == 4>(hhi + at, hlo + at, v[k]);
  }
}

// b3[i0 .. i0 + NI, :] as [NI][ON] (zeros past i_end and O); NI * ON is
// under one round of the CTA.
template <int ON>
__device__ __forceinline__ void load_b(float* sb, const float* __restrict__ b3, int i0,
                                       int i_end, int O, int tid) {
  static_assert(NI * ON <= NTHREADS, "one round");
  if (tid < NI * ON) {
    const int o = tid % ON, i = i0 + tid / ON;
    sb[tid] = i < i_end && o < O ? b3[(size_t)i * O + o] : 0.f;
  }
}

// V2[e0 .. e0 + BE, :, i0 .. i0 + NI] as [BE][P][NI] (zeros past E and i_end).
template <int P>
__device__ __forceinline__ void load_v(float* sv, const float* __restrict__ v2, int e0,
                                       int rows, int i0, int i_end, int IF, int tid) {
  stage<BE * P * NI>(
      tid,
      [&](int idx) {
        const int il = idx % NI, rp = idx / NI, i = i0 + il;
        return rp / P < rows && i < i_end ? v2[((size_t)e0 * P + rp) * IF + i] : 0.f;
      },
      [&](int idx, float v) { sv[idx] = v; });
}

// #3, narrow: out (or this split's partial) [E, P, O].
template <typename T, int P, int ON, int KM>
__global__ void __launch_bounds__(NTHREADS)
fwd_kernel(const T* __restrict__ h, const T* __restrict__ w3, const float* __restrict__ b3,
           const float* __restrict__ v2, float* __restrict__ out, int E, int IF, int O,
           int i_per_split) {
  using C = NCfg<ON, P, KM>;
  using bf16 = __nv_bfloat16;
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int WSN = C::WSN, NBW = ON / 16;  // NBW: 8-column blocks a warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* swh = reinterpret_cast<bf16*>(smem);
  bf16* swl = swh + C::WB;
  float* sb = reinterpret_cast<float*>(swl + C::WB);
  float* sv = sb + C::B3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we = warp & 3, cw = (warp >> 2) * (ON / 2);  // the warp's rows / 16, first column
  const int g = lane >> 2, t = lane & 3, j8 = lane >> 3, rr = lane & 7;
  const int e0 = blockIdx.x * BE, rows = min(BE, E - e0);
  const int i_lo = blockIdx.z * i_per_split, i_end = min(IF, i_lo + i_per_split);
  const int e_lo = we * 16 + g, e_hi = e_lo + 8;
  // h's A fragments for the whole call; zeros past E
  uint32_t ahi[KM / 16][4], alo[kSplit ? KM / 16 : 1][4];
  se3::load_afrag_global<T, KM>(ahi, alo, e_lo < rows ? h + (size_t)(e0 + e_lo) * KM : nullptr,
                                e_hi < rows ? h + (size_t)(e0 + e_hi) * KM : nullptr, t);
  float acc[P][NBW][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[p][nb][v] = 0.f;
  for (int i0 = i_lo; i0 < i_end; i0 += NI) {
    __syncthreads();  // every warp is done with the last chunk's tiles
    load_w_bf16<ON, KM>(swh, swl, w3, i0, i_end, IF, O, tid);
    load_b<ON>(sb, b3, i0, i_end, O, tid);
    load_v<P>(sv, v2, e0, rows, i0, i_end, IF, tid);
    __syncthreads();
    // a warp whose columns are all past O (O = 8: the tile's upper half)
    // has nothing to compute
    if (cw >= O) continue;
    // R = h.W3[:, i0 .. i0 + NI, the warp's columns] in the accumulator
    // layout, the NI values' products interleaved (independent mma
    // chains); past i_end W3, b3 and V2 are zeros, so a tail adds nothing
    float r[NI][NBW][4];
#pragma unroll
    for (int il = 0; il < NI; ++il)
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
        for (int v = 0; v < 4; ++v) r[il][nb][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KM / 16; ++kk)
#pragma unroll
      for (int il = 0; il < NI; ++il) {
        const int off = (il * KM + kk * 16 + (j8 & 1) * 8 + rr) * WSN + cw + (j8 >> 1) * 8;
        uint32_t bh[4], bl[4];
        if constexpr (NBW == 2)
          se3::ldmatrix_x4_trans(bh, swh + off);
        else
          se3::ldmatrix_x2_trans(bh, swh + off);
#pragma unroll
        for (int nb = 0; nb < NBW; ++nb)
          se3::mma_bf16(r[il][nb], ahi[kk], bh[2 * nb], bh[2 * nb + 1]);
        if constexpr (kSplit) {
          if constexpr (NBW == 2)
            se3::ldmatrix_x4_trans(bl, swl + off);
          else
            se3::ldmatrix_x2_trans(bl, swl + off);
#pragma unroll
          for (int nb = 0; nb < NBW; ++nb) {
            se3::mma_bf16(r[il][nb], ahi[kk], bl[2 * nb], bl[2 * nb + 1]);
            se3::mma_bf16(r[il][nb], alo[kk], bh[2 * nb], bh[2 * nb + 1]);
          }
        }
      }
    // acc[p] += V2[e, p, i] * (R + b3), rows e_lo and e_hi
#pragma unroll
    for (int il = 0; il < NI; ++il) {
      float vl[P], vh[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        vl[p] = sv[(e_lo * P + p) * NI + il];
        vh[p] = sv[(e_hi * P + p) * NI + il];
      }
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb) {
        const float2 bb = *reinterpret_cast<const float2*>(sb + il * ON + cw + nb * 8 + 2 * t);
        const float r0 = r[il][nb][0] + bb.x, r1 = r[il][nb][1] + bb.y;
        const float r2 = r[il][nb][2] + bb.x, r3 = r[il][nb][3] + bb.y;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          acc[p][nb][0] = fmaf(vl[p], r0, acc[p][nb][0]);
          acc[p][nb][1] = fmaf(vl[p], r1, acc[p][nb][1]);
          acc[p][nb][2] = fmaf(vh[p], r2, acc[p][nb][2]);
          acc[p][nb][3] = fmaf(vh[p], r3, acc[p][nb][3]);
        }
      }
    }
  }
  float* dst = out + (size_t)blockIdx.z * E * P * O + (size_t)e0 * P * O;
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb) {
    const int col = cw + nb * 8 + 2 * t;  // even, and O is a multiple of 8
    if (col >= O) continue;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (e_lo < rows)
        *reinterpret_cast<float2*>(dst + ((size_t)e_lo * P + p) * O + col) =
            make_float2(acc[p][nb][0], acc[p][nb][1]);
      if (e_hi < rows)
        *reinterpret_cast<float2*>(dst + ((size_t)e_hi * P + p) * O + col) =
            make_float2(acc[p][nb][2], acc[p][nb][3]);
    }
  }
}

// Kernel A, narrow: dv2 [E, P, IF] and this split's partial dW3 [KM, IF,
// O] then dB3 [IF, O] in work (bwd_reduce_kernel's layout).
template <typename T, int P, int ON, int KM>
__global__ void __launch_bounds__(NTHREADS)
bwd_a_kernel(const T* __restrict__ h, const T* __restrict__ w3, const float* __restrict__ b3,
             const float* __restrict__ v2, const float* __restrict__ g,
             float* __restrict__ dv2, float* __restrict__ work, int E, int IF, int O,
             int tiles_per_split) {
  using C = NCfg<ON, P, KM>;
  using bf16 = __nv_bfloat16;
  constexpr bool kSplitH = sizeof(T) == 4;
  constexpr int K = C::K, KP = C::KP, HP = C::HP, RS = C::RS;
  constexpr int NBW = K / 16;  // 8-column blocks of a warp's K / 2 columns
  constexpr int NC = C::NC, NBD = C::NBD;  // dW3: a warp's columns, their blocks
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* swh = reinterpret_cast<bf16*>(smem);  // W3's chunk [KM][KP], hi then lo
  bf16* swl = swh + KM * KP;
  bf16* shh = swl + KM * KP;  // h [BE][HP], hi then lo
  bf16* shl = shh + BE * HP;
  bf16* sdh = shl + BE * HP;  // dR [BE][KP], hi then lo
  bf16* sdl = sdh + BE * KP;
  float* sr = reinterpret_cast<float*>(sdl + BE * KP);  // R + b3, then dR [BE][RS]
  float* sb = sr + BE * RS;                              // b3 [NI][ON]
  float* sv = sb + C::B3;                                // V2 [BE][P][NI]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t = lane & 3, j8 = lane >> 3, rr = lane & 7;
  // the products' roles: rows (edges for R, m for dW3) by warp & 3, the
  // chunk's columns by halves
  const int wr = warp & 3, wn = (warp >> 2) * (K / 2);
  // dW3's roles: rows wm * 32, columns wd .. wd + NC
  const int wm = warp % C::WARPS_M, wd = (warp / C::WARPS_M) * NC;
  const int i0 = blockIdx.x * NI, i_end = min(IF, i0 + NI);
  // the dR role: edge e, i value il
  const int e = tid % BE, il = tid / BE, i = i0 + il;
  load_wk_bf16<ON, KM>(swh, swl, w3, i0, i_end, IF, O, tid);
  load_b<ON>(sb, b3, i0, i_end, O, tid);
  float dw[2][NBD][4];  // dW3 rows wm * 32 + mt * 16, the warp's columns
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < NBD; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) dw[mt][nb][v] = 0.f;
  float db = 0.f;  // column tid of dB3, for tid < K
  const int n_tiles = (E + BE - 1) / BE;
  const int t_lo = blockIdx.y * tiles_per_split;
  const int t_hi = min(n_tiles, t_lo + tiles_per_split);
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int e0 = tile * BE, rows = min(BE, E - e0);
    __syncthreads();  // every warp is done with the last tile's h, dR and sr
    load_h_bf16<KM>(shh, shl, h, e0, rows, tid);
    load_v<P>(sv, v2, e0, rows, i0, i_end, IF, tid);
    __syncthreads();
    {
      // R = h.W3[:, chunk] on mma.sync (h_hi.W_hi + h_hi.W_lo + h_lo.W_hi,
      // one pass for bf16), plus b3, into sr
      float r[NBW][4];
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
        for (int v = 0; v < 4; ++v) r[nb][v] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KM / 16; ++kk) {
        const int a_off = (wr * 16 + (j8 & 1) * 8 + rr) * HP + kk * 16 + (j8 >> 1) * 8;
        uint32_t ahi[4], alo[4];
        se3::ldmatrix_x4(ahi, shh + a_off);
        if constexpr (kSplitH) se3::ldmatrix_x4(alo, shl + a_off);
#pragma unroll
        for (int nb2 = 0; nb2 < NBW / 2; ++nb2) {
          const int b_off = (kk * 16 + (j8 & 1) * 8 + rr) * KP + wn + nb2 * 16 + (j8 >> 1) * 8;
          uint32_t bh[4];
          se3::ldmatrix_x4_trans(bh, swh + b_off);
          se3::mma_bf16(r[2 * nb2], ahi, bh[0], bh[1]);
          se3::mma_bf16(r[2 * nb2 + 1], ahi, bh[2], bh[3]);
          if constexpr (kSplitH) {
            uint32_t bl[4];
            se3::ldmatrix_x4_trans(bl, swl + b_off);
            se3::mma_bf16(r[2 * nb2], ahi, bl[0], bl[1]);
            se3::mma_bf16(r[2 * nb2 + 1], ahi, bl[2], bl[3]);
            se3::mma_bf16(r[2 * nb2], alo, bh[0], bh[1]);
            se3::mma_bf16(r[2 * nb2 + 1], alo, bh[2], bh[3]);
          }
        }
      }
      const int e_lo = wr * 16 + g4;
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb) {
        const int col = wn + nb * 8 + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(sb + col);
        *reinterpret_cast<float2*>(sr + e_lo * RS + col) =
            make_float2(r[nb][0] + bb.x, r[nb][1] + bb.y);
        *reinterpret_cast<float2*>(sr + (e_lo + 8) * RS + col) =
            make_float2(r[nb][2] + bb.x, r[nb][3] + bb.y);
      }
    }
    __syncthreads();
    {
      // thread (e, il): dV2[e, p, i] = g[e, p, :] . R[e, i, :] and dR[e, i,
      // :] = sum_p V2[e, p, i] g[e, p, :], dR over R in sr and as bf16 hi +
      // lo; g straight from device memory (zeros past E and O)
      float* row = sr + e * RS + il * ON;
      float rv[ON], dr[ON];
#pragma unroll
      for (int c = 0; c < ON; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + c);
        rv[c] = x.x, rv[c + 1] = x.y, rv[c + 2] = x.z, rv[c + 3] = x.w;
        dr[c] = dr[c + 1] = dr[c + 2] = dr[c + 3] = 0.f;
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* gp = g + ((size_t)(e0 + e) * P + p) * O;
        const float v = sv[(e * P + p) * NI + il];
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < ON; c += 4) {
          const float4 x = e < rows && c < O ? __ldg(reinterpret_cast<const float4*>(gp + c))
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
          s = fmaf(x.x, rv[c], s);
          s = fmaf(x.y, rv[c + 1], s);
          s = fmaf(x.z, rv[c + 2], s);
          s = fmaf(x.w, rv[c + 3], s);
          dr[c] = fmaf(v, x.x, dr[c]);
          dr[c + 1] = fmaf(v, x.y, dr[c + 1]);
          dr[c + 2] = fmaf(v, x.z, dr[c + 2]);
          dr[c + 3] = fmaf(v, x.w, dr[c + 3]);
        }
        if (e < rows && i < i_end) dv2[((size_t)(e0 + e) * P + p) * IF + i] = s;
      }
#pragma unroll
      for (int c = 0; c < ON; c += 4) {
        const float4 x = make_float4(dr[c], dr[c + 1], dr[c + 2], dr[c + 3]);
        *reinterpret_cast<float4*>(row + c) = x;
        store_split<true>(sdh + e * KP + il * ON + c, sdl + e * KP + il * ON + c, x);
      }
    }
    __syncthreads();
    if (tid < K)
      for (int r = 0; r < BE; ++r) db += sr[r * RS + tid];
    // dW3 += h^T.dR over the tile's edges: h_hi.dR_hi + h_hi.dR_lo +
    // h_lo.dR_hi (h.dR_hi + h.dR_lo for bf16 h)
#pragma unroll
    for (int ks = 0; ks < BE / 16; ++ks) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int a_off = (ks * 16 + (j8 >> 1) * 8 + rr) * HP + wm * 32 + mt * 16 + (j8 & 1) * 8;
        uint32_t ahi[4], alo[4];
        se3::ldmatrix_x4_trans(ahi, shh + a_off);
        if constexpr (kSplitH) se3::ldmatrix_x4_trans(alo, shl + a_off);
        // one 8-column block (x2) or pairs of them (x4) of dR
#pragma unroll
        for (int nb2 = 0; nb2 < (NBD + 1) / 2; ++nb2) {
          const int b_off = (ks * 16 + (j8 & 1) * 8 + rr) * KP + wd + nb2 * 16 + (j8 >> 1) * 8;
          uint32_t bh[4], bl[4];
          if constexpr (NBD == 1) {
            se3::ldmatrix_x2_trans(bh, sdh + b_off);
            se3::ldmatrix_x2_trans(bl, sdl + b_off);
          } else {
            se3::ldmatrix_x4_trans(bh, sdh + b_off);
            se3::ldmatrix_x4_trans(bl, sdl + b_off);
          }
#pragma unroll
          for (int nb = 0; nb < (NBD == 1 ? 1 : 2); ++nb) {
            float(&d)[4] = dw[mt][2 * nb2 + nb];
            se3::mma_bf16(d, ahi, bh[2 * nb], bh[2 * nb + 1]);
            se3::mma_bf16(d, ahi, bl[2 * nb], bl[2 * nb + 1]);
            if constexpr (kSplitH) se3::mma_bf16(d, alo, bh[2 * nb], bh[2 * nb + 1]);
          }
        }
      }
    }
  }
  const size_t n_w = (size_t)KM * IF * O;
  float* part = work + (size_t)blockIdx.y * (n_w + (size_t)IF * O);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < NBD; ++nb) {
      const int col = wd + nb * 8 + 2 * t, ic = i0 + col / ON, o = col % ON;
      if (ic >= i_end || o >= O) continue;
      const int m = wm * 32 + mt * 16 + g4;
      *reinterpret_cast<float2*>(part + ((size_t)m * IF + ic) * O + o) =
          make_float2(dw[mt][nb][0], dw[mt][nb][1]);
      *reinterpret_cast<float2*>(part + ((size_t)(m + 8) * IF + ic) * O + o) =
          make_float2(dw[mt][nb][2], dw[mt][nb][3]);
    }
  if (tid < K) {
    const int ic = i0 + tid / ON, o = tid % ON;
    if (ic < i_end && o < O) part[n_w + (size_t)ic * O + o] = db;
  }
}

// Kernel B, narrow: dH (or this split's partial) [E, KM].
template <typename T, int P, int ON, int KM>
__global__ void __launch_bounds__(NTHREADS)
bwd_b_kernel(const T* __restrict__ w3, const float* __restrict__ v2,
             const float* __restrict__ g, float* __restrict__ dh, int E, int IF, int O,
             int i_per_split) {
  using C = NCfg<ON, P, KM>;
  using bf16 = __nv_bfloat16;
  constexpr bool kSplitW = sizeof(T) == 4;
  constexpr int K = C::K, KP = C::KP;
  constexpr int NM = KM / 16;  // 8-column blocks of a warp's KM / 2 columns of m
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* swh = reinterpret_cast<bf16*>(smem);  // W3's chunk [KM][KP], hi then lo
  bf16* swl = swh + KM * KP;
  bf16* sdh = swl + KM * KP;  // dR [BE][KP], hi then lo
  bf16* sdl = sdh + BE * KP;
  float* sv = reinterpret_cast<float*>(sdl + BE * KP);  // V2 [BE][P][NI]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = tid % BE, q = tid / BE;  // the dR role: edge e, i value q
  // the product role: warp rows we * 16, columns (m) wm .. wm + KM / 2
  const int we = warp & 3, wm = (warp >> 2) * (KM / 2);
  const int g4 = lane >> 2, t = lane & 3, j8 = lane >> 3, rr = lane & 7;
  const int e0 = blockIdx.x * BE, rows = min(BE, E - e0);
  const int i_lo = blockIdx.y * i_per_split, i_end = min(IF, i_lo + i_per_split);
  float acc[NM][4];
#pragma unroll
  for (int nb = 0; nb < NM; ++nb)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[nb][v] = 0.f;
  for (int i0 = i_lo; i0 < i_end; i0 += NI) {
    __syncthreads();  // every warp is done with the last chunk's tiles
    load_wk_bf16<ON, KM>(swh, swl, w3, i0, i_end, IF, O, tid);
    load_v<P>(sv, v2, e0, rows, i0, i_end, IF, tid);
    __syncthreads();
    {
      // dR[e, (q, o)] = sum_p V2[e, p, i0 + q] g[e, p, o], as bf16 hi + lo
      // (zeros past E, i_end and O); g straight from device memory (the
      // NI threads of an edge read the same row: one trip to L2), which
      // leaves two CTAs room on an SM
      float dr[ON];
#pragma unroll
      for (int c = 0; c < ON; ++c) dr[c] = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float v = sv[(e * P + p) * NI + q];
        const float* gp = g + ((size_t)(e0 + e) * P + p) * O;
#pragma unroll
        for (int c = 0; c < ON; c += 4) {
          const float4 x = e < rows && c < O ? __ldg(reinterpret_cast<const float4*>(gp + c))
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
          dr[c] = fmaf(v, x.x, dr[c]);
          dr[c + 1] = fmaf(v, x.y, dr[c + 1]);
          dr[c + 2] = fmaf(v, x.z, dr[c + 2]);
          dr[c + 3] = fmaf(v, x.w, dr[c + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < ON; c += 4)
        store_split<true>(sdh + e * KP + q * ON + c, sdl + e * KP + q * ON + c,
                          make_float4(dr[c], dr[c + 1], dr[c + 2], dr[c + 3]));
    }
    __syncthreads();
    // dH += dR . W3^T over the chunk's (i, o) columns: dR_hi.W_hi +
    // dR_lo.W_hi (+ dR_hi.W_lo for float32 W3)
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      const int a_off = (we * 16 + (j8 & 1) * 8 + rr) * KP + kk * 16 + (j8 >> 1) * 8;
      uint32_t ahi[4], alo[4];
      se3::ldmatrix_x4(ahi, sdh + a_off);
      se3::ldmatrix_x4(alo, sdl + a_off);
#pragma unroll
      for (int nb2 = 0; nb2 < NM / 2; ++nb2) {
        const int b_off = (wm + nb2 * 16 + (j8 >> 1) * 8 + rr) * KP + kk * 16 + (j8 & 1) * 8;
        uint32_t bh[4];
        se3::ldmatrix_x4(bh, swh + b_off);
        se3::mma_bf16(acc[2 * nb2], ahi, bh[0], bh[1]);
        se3::mma_bf16(acc[2 * nb2 + 1], ahi, bh[2], bh[3]);
        se3::mma_bf16(acc[2 * nb2], alo, bh[0], bh[1]);
        se3::mma_bf16(acc[2 * nb2 + 1], alo, bh[2], bh[3]);
        if constexpr (kSplitW) {
          uint32_t bl[4];
          se3::ldmatrix_x4(bl, swl + b_off);
          se3::mma_bf16(acc[2 * nb2], ahi, bl[0], bl[1]);
          se3::mma_bf16(acc[2 * nb2 + 1], ahi, bl[2], bl[3]);
        }
      }
    }
  }
  const int e_lo = we * 16 + g4, e_hi = e_lo + 8;
  float* dst = dh + (size_t)blockIdx.y * E * KM + (size_t)e0 * KM + wm + 2 * t;
#pragma unroll
  for (int nb = 0; nb < NM; ++nb) {
    if (e_lo < rows)
      *reinterpret_cast<float2*>(dst + (size_t)e_lo * KM + nb * 8) =
          make_float2(acc[nb][0], acc[nb][1]);
    if (e_hi < rows)
      *reinterpret_cast<float2*>(dst + (size_t)e_hi * KM + nb * 8) =
          make_float2(acc[nb][2], acc[nb][3]);
  }
}

}  // namespace SE3N
