// Basis-fused pairwise convolution for Hopper (sm_90a).
//
//   out[e, p, o] = sum_{c, f} V2[e, p, c, f] * R[e, (c, f), o]
//   R[e, i, o]   = sum_m h[e, m] * W3[m, i, o] + b3[i, o]      (i = c*F + f)
//   V2[e, p, c, f] = sum_q B[e, (p, f, q)] * x[e, c, q]
//
// Replaces se3_transformer_tpu/kernels/pallas_pairwise.py::_fwd_bx_kernel,
// driven by fused_pairwise_conv_bxf (the flat basis B[e, (p, f, q)], entry
// point se3_pairwise_bxf) and by fused_pairwise_conv_bx (the structured
// basis B[e, p, q, f] of get_basis's default layout, se3_pairwise_bx): one
// tile, templated on the basis layout, which only changes how the V2 build
// indexes the staged basis rows. As there, neither V2 nor R is ever written
// to device memory.
//
// What bounds it on this card. The radial product R = h.W3 is the work:
// at the flagship shape (E = 32768 edges, mid = 128, C = O = 64) the (3,3)
// degree pair alone is 2*E*mid*(C*F)*O = 240 GFLOP, 0.24 ms at the bf16
// tensor-core peak, beside 13 GFLOP of float32 epilogue (0.20 ms on the
// FMA pipe, which runs beside the tensor cores) and ~80 MB of operands:
// compute-bound. Two things cap it below that on this tile: mma.sync reads
// every W3 fragment from shared memory once per edge-warp (256 B per
// m16n8k16, so about 2 clocks per mma per SM), and every 64-edge tile
// re-reads all of W3 from L2 (16 KB per i; 3.7 GB per (3,3) launch).
//
// What held the previous version back (PERF.md, section 6: timing-only
// variants of it on an H100): the global loads inside its loop over i,
// 43-53% of its bf16 time. W3's 16 KB slice was issued as one burst per i
// right before the barrier (23-30%), and V2 was built per c from x rows
// read by scalar __ldg, a barrier, then two shared loads per FMA (8-24%).
// Its barriers cost 1-9%, a deeper W3 ring 0-2%. In float32 its fp32-FMA
// product took 75% of the time.
//
// What the design does about it:
//  * A CTA owns 64 edges x 64 output channels with 8 warps (4 along edges
//    x 2 along O); the [edge, P, O-tile] accumulator lives in registers for
//    the whole loop over i and is written once: no atomics, the same bits
//    on every run. h's A fragments come straight from device memory into
//    registers once per CTA (float32 h split there into bf16 hi + lo).
//  * i is walked in chunks of CI (2 for bf16, K = 256 per barrier; 1 for
//    float32, whose three passes make a chunk as long), one barrier each.
//    W3[:, chunk, O-tile] (bf16, or float32 split into bf16 hi + lo by
//    split_bf16_kernel once per launch) and b3[chunk] go through a 3-stage
//    ring of swizzled tiles, issued in one burst right after the barrier
//    two chunks ahead, so a chunk's copies have two chunks of products to
//    land in.
//  * V2 is built per stage of GC channels c (a whole number of chunks, at
//    least 3) at the stage's first chunk, behind a second barrier, from x
//    rows that arrived by cp.async during the previous stage. Each thread
//    builds one edge row, reading each basis value once per stage for all
//    GC channels. V2 is stored [edge][i][p] (p padded to 4) so the epilogue
//    reads a row's P values with float4 loads.
//  * The radial tiles R = h.W3[:, i, O-tile] of a chunk's CI values of i run
//    on the tensor cores with their k-steps interleaved (4 CI independent
//    accumulators a warp), as mma.sync m16n8k16 bf16 with fp32
//    accumulation; float32 runs as three passes h_hi.W_hi + h_hi.W_lo +
//    h_lo.W_hi in a fixed order, as pairwise_fwd.cu does, so no product
//    runs on fp32 FMAs. The epilogue acc[p] += V2[e, p, i] * (R + b3) runs
//    on the accumulator registers.
//  * Ragged edge tails are masked: rows past E load zeros, store nothing;
//    a chunk past the last i reads the last W3 slice against a V2 of 0.
// Where it stands (PERF.md, section 6): 1.2-1.6x the parent's speed in bf16
// and ~4x in float32, which now beats the library call. Its variants
// name no single bound: W3's delivery from L2 (every 64-edge tile re-reads
// all of it), the V2 build and the epilogue each cost ~20% at (3,3), the
// mma.sync stream and its B-fragment loads the rest, and little overlaps at
// 8 warps per SM with the P-deep accumulator (112 registers at P = 7).
// Tried on the card and dropped (PERF.md, section 6): the next chunk's copies
// issued one per k-step (kernel B's rule in pairwise_bwd.cu; here it exposed their
// latency at the barrier, 7-17% slower than a burst), a 2-stage ring with
// V2 double-buffered and built without the extra barrier, an L2 prefetch
// hint on the copies, the accumulators started from b3, two CTAs per SM
// (spills), and wgmma: m64n32k16 per warpgroup with A from registers and
// W3 in the no-swizzle core-matrix layout (LBO the K-group stride, SBO the
// N-group stride), the epilogue of chunk k - 1 overlapped with chunk k's
// product. It was right but 1.5-2x slower, serialized by ptxas at first
// and still slower once the pipeline was peeled.
// Left for later: W3 shared by two edge tiles (a cluster multicast, or a
// 128-edge tile where P <= 3 leaves registers) to halve its L2 traffic;
// wgmma with a swizzled W3 layout and a wider N.
//
// The conv_bf16 arm (TV = bf16; entry points se3_pairwise_bxf_v16 and
// se3_pairwise_bx_v16, compiled as a unit of its own with -DSE3_V16=1 so
// that the float32 instantiations are the code they were): the basis and x
// arrive stored bf16, as JAX's _fwd_bx_kernel takes them, and are staged
// at 2 bytes a value. The tile's basis rows go by 16-byte cp.async, 8
// values a copy, into a bf16 sB; x has no 4-byte alignment per row (C * Q
// values of 2 bytes), so a stage's x values are loaded into registers when
// the float arm would issue their copies and stored to a bf16 sX after the
// chunk's products, a stage ahead of their build as before. build_v2 upcasts
// both exactly to float32 where it builds V2 (JAX upcasts at the same
// place); everything after is the float arm's math.

#include "common.cuh"

#ifndef SE3_V16
#define SE3_V16 0
#endif

namespace {

using namespace se3;

using bf16 = __nv_bfloat16;

// The tile's shape by W3's kind (bf16, or float32 given as bf16 hi + lo)
// and (P, Q): the chunk and stage sizes, and shared memory as byte offsets.
template <bool kSplit, int P, int Q, bool kV16 = false>
struct BxfCfg {
  static constexpr int F = P < Q ? P : Q;
  static constexpr int NS = kSplit ? 2 : 1;  // bf16 halves of W3
  static constexpr int CI = kSplit ? 1 : 2;  // i values per chunk (one barrier each)
  static constexpr int RING = 3;             // W3 ring stages: copies issued 2 chunks ahead
  // channels c per V2 stage: a whole number of chunks, at least 3 (a
  // stage's x copies, issued in the previous stage's first chunk, must
  // land before its first chunk)
  static constexpr int GC = F == 1 ? 3 * CI : CI;
  static constexpr int SI = GC * F;    // i values per stage
  static constexpr int CPS = SI / CI;  // chunks per stage
  static constexpr int PP = P == 1 ? 1 : (P + 3) / 4 * 4;  // V2 values per (row, i)
  static constexpr int RS = SI * PP + (PP == 1 ? 1 : 4);  // sV row stride in floats
  static constexpr int XS = GC * Q + 1;                   // sX row stride in floats
  static constexpr int PFQ = P * F * Q;
  static constexpr size_t WSL = 2ull * MID * BO;        // bytes of one W3 slice (bf16)
  static constexpr size_t W = 0;                        // [RING][CI][NS] W3 slices
  static constexpr size_t B3 = W + RING * CI * NS * WSL;  // [RING][CI][BO] float
  static constexpr size_t TSB = kV16 ? 2 : 4;  // bytes of a staged basis or x value
  static constexpr size_t BS = B3 + 4ull * RING * CI * BO;  // [BE][PFQ]: the basis rows
  static constexpr size_t X = BS + TSB * BE * PFQ;       // [BE][XS]
  static constexpr size_t V = X + TSB * BE * XS;         // [BE][RS] float
  // the conv_bf16 arm: a stage's x values held by each thread between
  // their load and their store to sX
  static constexpr int XPT = (BE * GC * Q + NTHREADS - 1) / NTHREADS;
  static constexpr size_t SMEM = V + 4ull * BE * RS;
  static_assert(SI % CI == 0 && CPS >= 3, "a V2 stage is at least 3 whole chunks");
  static_assert(SMEM <= 232448, "the tile fits one SM's shared memory");
};

// T is h's type: bf16, or float (split into bf16 hi + lo here; W3 given as
// its split arrays whi and wlo). TV is the basis' and x's: float, or bf16
// (the conv_bf16 arm).
template <typename T, typename TV, int P, int Q, bool kPQF>
__global__ void __launch_bounds__(NTHREADS, 1)
pairwise_bxf_kernel(const T* __restrict__ h, const bf16* __restrict__ whi,
                    const bf16* __restrict__ wlo, const float* __restrict__ b3,
                    const TV* __restrict__ basis, const TV* __restrict__ x,
                    float* __restrict__ out, int E, int C, int O, int basis_quads) {
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr bool kV16 = sizeof(TV) == 2;
  using Cfg = BxfCfg<kSplit, P, Q, kV16>;
  constexpr int F = Cfg::F, NS = Cfg::NS, CI = Cfg::CI, GC = Cfg::GC, CPS = Cfg::CPS;
  constexpr int RING = Cfg::RING;
  constexpr int PP = Cfg::PP, RS = Cfg::RS, XS = Cfg::XS, PFQ = Cfg::PFQ;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem + Cfg::W);
  float* sb3 = reinterpret_cast<float*>(smem + Cfg::B3);
  TV* sB = reinterpret_cast<TV*>(smem + Cfg::BS);
  TV* sX = reinterpret_cast<TV*>(smem + Cfg::X);
  float* sV = reinterpret_cast<float*>(smem + Cfg::V);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we = warp & 3, wo = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int e0 = blockIdx.x * BE, o0 = blockIdx.y * BO;
  const int rows = min(BE, E - e0);
  const int CF = C * F;
  const int n_chunks = (CF + CI - 1) / CI;
  const int n_stages = (C + GC - 1) / GC;

  // Chunk k's W3 (hi[, lo]) and b3 into ring stage k % RING, in one burst
  // of 16-byte cp.async (CI NS 4 a thread for W3). i past CF reads slice
  // CF - 1 (its V2 is 0).
  auto stage_w = [&](int k) {
    const int kb = k % RING;
#pragma unroll
    for (int r = 0; r < CI * NS * 4; ++r) {
      const int half = r / (CI * 4), f = tid + (r % (CI * 4)) * NTHREADS;
      const int ch = f & 7, ii = (f >> 3) % CI, m = (f >> 3) / CI;
      const int i = min(k * CI + ii, CF - 1);
      cp_async16(sW + ((size_t)(kb * CI + ii) * NS + half) * MID * BO + swz(m, ch * 8),
                 (half ? wlo : whi) + ((size_t)m * CF + i) * O + o0 + ch * 8);
    }
    if (tid < CI * BO / 4) {
      const int ii = tid / (BO / 4), part = tid % (BO / 4);
      const int i = min(k * CI + ii, CF - 1);
      cp_async16(sb3 + (kb * CI + ii) * BO + part * 4, b3 + (size_t)i * O + o0 + part * 4);
    }
  };
  // x[tile, the GC channels of stage s, :] into sX (zeros past E and past
  // C); a row's GC Q values are contiguous in memory
  auto stage_x = [&](int s) {
    if constexpr (!kV16) {
      float* dst = sX;
      const int c0 = s * GC;
      for (int idx = tid; idx < BE * GC * Q; idx += NTHREADS) {
        const int r = idx / (GC * Q), j = idx - r * (GC * Q);
        if (r < rows && c0 * Q + j < C * Q)
          cp_async4(dst + r * XS + j, x + ((size_t)(e0 + r) * C + c0) * Q + j);
        else
          dst[r * XS + j] = 0.f;
      }
    }
  };
  // the conv_bf16 arm's x: stage s's values into this thread's registers
  // (zeros past E and past C), then, once the loads have had a chunk's
  // products to land, into sX
  unsigned short xs[kV16 ? Cfg::XPT : 1];
  auto load_x = [&](int s) {
    const unsigned short* x16 = reinterpret_cast<const unsigned short*>(x);
    const int c0 = s * GC;
#pragma unroll
    for (int u = 0; u < Cfg::XPT; ++u) {
      const int idx = tid + u * NTHREADS;
      const int r = idx / (GC * Q), j = idx - r * (GC * Q);
      xs[u] = idx < BE * GC * Q && r < rows && c0 * Q + j < C * Q
                  ? __ldg(x16 + ((size_t)(e0 + r) * C + c0) * Q + j)
                  : (unsigned short)0;
    }
  };
  auto store_x = [&]() {
    unsigned short* dst = reinterpret_cast<unsigned short*>(sX);
#pragma unroll
    for (int u = 0; u < Cfg::XPT; ++u) {
      const int idx = tid + u * NTHREADS;
      const int r = idx / (GC * Q), j = idx - r * (GC * Q);
      if (idx < BE * GC * Q) dst[r * XS + j] = xs[u];
    }
  };
  // V2 of the staged x's stage into sV, as [row][i - stage start][p]
  auto build = [&]() { build_v2<P, Q, GC, PP, RS, XS, PFQ, kPQF, TV>(sV, sX, sB, tid); };

  // prologue, two cp.async groups: chunk 0's W3 and b3, the tile's basis
  // rows (contiguous in either layout) and stage 0's x; chunk 1's W3 and b3
  stage_w(0);
  {
    const TV* src = basis + (size_t)e0 * PFQ;
    const int n = rows * PFQ;
    // 16-byte copies: 4 float values, or 8 bf16 (BE * PFQ is a multiple of 8)
    constexpr int VEC = 16 / sizeof(TV);
    for (int idx = tid; idx < BE * PFQ / VEC; idx += NTHREADS) {
      const int j = idx * VEC;
      if (basis_quads && j + VEC <= n) {
        cp_async16(sB + j, src + j);
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          if constexpr (kV16)
            sB[j + u] = j + u < n ? src[j + u] : __float2bfloat16(0.f);
          else if (j + u < n)
            cp_async4(sB + j + u, src + j + u);
          else
            sB[j + u] = 0.f;
        }
      }
    }
  }
  stage_x(0);
  if constexpr (kV16) {
    load_x(0);
    store_x();
  }
  cp_async_commit();
  if (n_chunks > 1) stage_w(1);
  cp_async_commit();

  // h's A fragments straight from device memory while the copies fly;
  // zeros past E
  const int e_lo = we * 16 + g, e_hi = e_lo + 8;
  uint32_t ahi[MID / 16][4], alo[kSplit ? MID / 16 : 1][4];
  load_afrag_global<T>(ahi, alo, e_lo < rows ? h + (size_t)(e0 + e_lo) * MID : nullptr,
                       e_hi < rows ? h + (size_t)(e0 + e_hi) * MID : nullptr, t);

  cp_async_wait<1>();
  __syncthreads();
  build();

  float acc[P][4][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[p][nb][v] = 0.f;

  const int j8 = lane >> 3, rr = lane & 7;

  // Chunk k, behind one barrier: chunk k's W3 and b3 (issued two chunks
  // ago) have landed, and every warp is done with chunk k - 1, whose ring
  // stage chunk k + 2's copies now refill. At a stage's first chunk the
  // stage's V2 is built first (its x issued in the previous stage's first
  // chunk), behind a second barrier, and the next stage's x is issued.
  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait<1>();
    __syncthreads();
    const int s = k / CPS, kin = k - s * CPS;
    if (kin == 0 && k > 0) {
      build();
      __syncthreads();
    }
    const bool next_x = kin == 0 && s + 1 < n_stages;
    if (next_x) {
      if constexpr (kV16)
        load_x(s + 1);
      else
        stage_x(s + 1);
    }
    if (k + 2 < n_chunks) stage_w(k + 2);
    cp_async_commit();

    // R = h.W3 for the chunk's CI values of i, their k-steps interleaved
    const bf16* sw = sW + (size_t)(k % RING) * CI * NS * MID * BO;
    float r[CI][4][4];
#pragma unroll
    for (int ii = 0; ii < CI; ++ii)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int v = 0; v < 4; ++v) r[ii][nb][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MID / 16; ++kk)
#pragma unroll
      for (int ii = 0; ii < CI; ++ii)
#pragma unroll
        for (int nb2 = 0; nb2 < 2; ++nb2) {
          const bf16* swh = sw + (size_t)ii * NS * MID * BO;
          const int off = swz(kk * 16 + (j8 & 1) * 8 + rr, wo * 32 + nb2 * 16 + (j8 >> 1) * 8);
          float(&r0)[4] = r[ii][nb2 * 2 + 0];
          float(&r1)[4] = r[ii][nb2 * 2 + 1];
          uint32_t bh[4];
          ldmatrix_x4_trans(bh, swh + off);
          mma_bf16(r0, ahi[kk], bh[0], bh[1]);
          mma_bf16(r1, ahi[kk], bh[2], bh[3]);
          if constexpr (kSplit) {
            uint32_t bl[4];
            ldmatrix_x4_trans(bl, swh + MID * BO + off);
            mma_bf16(r0, ahi[kk], bl[0], bl[1]);
            mma_bf16(r1, ahi[kk], bl[2], bl[3]);
            mma_bf16(r0, alo[kk], bh[0], bh[1]);
            mma_bf16(r1, alo[kk], bh[2], bh[3]);
          }
        }

    // epilogue: acc[p] += V2[e, p, i] * (R + b3)
    const float* sbb = sb3 + (k % RING) * CI * BO + wo * 32 + 2 * t;
#pragma unroll
    for (int ii = 0; ii < CI; ++ii)
      apply_v2<P, PP, RS>(acc, r[ii], sV + e_lo * RS + (kin * CI + ii) * PP,
                          sbb + ii * BO);
    // conv_bf16: the next stage's x, read by its build after a barrier
    if constexpr (kV16)
      if (next_x) store_x();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int col = o0 + wo * 32 + nb * 8 + 2 * t;
      if (e_lo < rows)
        *reinterpret_cast<float2*>(out + ((size_t)(e0 + e_lo) * P + p) * O + col) =
            make_float2(acc[p][nb][0], acc[p][nb][1]);
      if (e_hi < rows)
        *reinterpret_cast<float2*>(out + ((size_t)(e0 + e_hi) * P + p) * O + col) =
            make_float2(acc[p][nb][2], acc[p][nb][3]);
    }
}

template <typename T, typename TV, int P, int Q, bool kPQF>
cudaError_t launch(const void* h, const void* w3, const void* b3, const void* basis,
                   const void* x, void* out, void* w3_split, int E, int C, int O, int chunk,
                   int stage_c, cudaStream_t stream) {
  constexpr bool kSplit = sizeof(T) == 4;
  using Cfg = BxfCfg<kSplit, P, Q, sizeof(TV) == 2>;
  // the caller's chunk and stage sizes (kernels/pairwise.py::bxf_tiles)
  // must be the tile's own
  if (chunk != Cfg::CI || stage_c != Cfg::GC) return cudaErrorInvalidValue;
  const bf16 *whi = static_cast<const bf16*>(w3), *wlo = nullptr;
  cudaError_t err;
  if constexpr (kSplit) {
    // float32 W3 [MID, C*F, O] (a whole number of float4s) into its bf16
    // hi and lo arrays
    const size_t n4 = (size_t)MID * C * Cfg::F * O / 4;
    const size_t need = (n4 + NTHREADS - 1) / NTHREADS;
    const unsigned blocks = (unsigned)(need < 4096 ? need : 4096);
    uint2* hi = static_cast<uint2*>(w3_split);
    split_bf16_kernel<<<blocks, NTHREADS, 0, stream>>>(static_cast<const float4*>(w3), n4, hi,
                                                        hi + n4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    whi = static_cast<const bf16*>(w3_split);
    wlo = whi + 4 * n4;
  }
  auto kern = pairwise_bxf_kernel<T, TV, P, Q, kPQF>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
  if (err != cudaSuccess) return err;
  // 16-byte basis copies need the tile's rows to start on 16 bytes (a
  // tile is 64 rows, so every tile does when the first does)
  const int basis_quads = reinterpret_cast<uintptr_t>(basis) % 16 == 0;
  dim3 grid((E + BE - 1) / BE, O / BO);
  kern<<<grid, NTHREADS, Cfg::SMEM, stream>>>(
      static_cast<const T*>(h), whi, wlo, static_cast<const float*>(b3),
      static_cast<const TV*>(basis), static_cast<const TV*>(x),
      static_cast<float*>(out), E, C, O, basis_quads);
  return cudaGetLastError();
}

template <typename T, typename TV, bool kPQF>
cudaError_t dispatch(int P, int Q, const void* h, const void* w3, const void* b3,
                     const void* basis, const void* x, void* out, void* w3_split, int E,
                     int C, int O, int chunk, int stage_c, cudaStream_t s) {
#define SE3_PQ(PP, QQ)                                                                    \
  if (P == PP && Q == QQ)                                                                 \
    return launch<T, TV, PP, QQ, kPQF>(h, w3, b3, basis, x, out, w3_split, E, C, O,     \
                                       chunk, stage_c, s);
#define SE3_P(PP) SE3_PQ(PP, 1) SE3_PQ(PP, 3) SE3_PQ(PP, 5) SE3_PQ(PP, 7)
  SE3_P(1) SE3_P(3) SE3_P(5) SE3_P(7)
#undef SE3_P
#undef SE3_PQ
  return cudaErrorInvalidValue;
}

template <typename TV, bool kPQF>
int entry(const void* h, const void* w3, const void* b3, const void* basis, const void* x,
          void* out, void* w3_split, int E, int C, int O, int P, int Q, int chunk,
          int stage_c, int h_is_bf16, void* stream) {
  if (E <= 0) return 0;
  if (O <= 0 || O % BO != 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      h_is_bf16 ? dispatch<bf16, TV, kPQF>(P, Q, h, w3, b3, basis, x, out, w3_split, E, C, O,
                                           chunk, stage_c, s)
                : dispatch<float, TV, kPQF>(P, Q, h, w3, b3, basis, x, out, w3_split, E, C, O,
                                            chunk, stage_c, s);
  return (int)err;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch status
// (cudaGetLastError() right after the launches); 0 is success. Pointers are
// device pointers to contiguous tensors, h, w3 and b3 starting on 16 bytes;
// the caller checks shapes: mid == 128, O % 64 == 0, P and Q in {1, 3, 5,
// 7}, h/w3 bf16 or f32, the rest f32. se3_pairwise_bxf takes the flat basis
// [E, P*F*Q] in (p, f, q) order, se3_pairwise_bx the structured basis
// [E, P, Q, F]. chunk and stage_c are bxf_tiles' (checked). With float32
// h/w3, w3_split holds 2 * 128 * C*F * O bf16 (W3's hi array, then its lo
// array); it is not read otherwise. The _v16 entry points (the conv_bf16
// arm, this file compiled with -DSE3_V16=1) take the basis and x bf16, the
// basis starting on 2 bytes (16 for its 16-byte copies) and x on 2.
#if SE3_V16
extern "C" int se3_pairwise_bxf_v16(const void* h, const void* w3, const void* b3,
                                    const void* basis, const void* x, void* out,
                                    void* w3_split, int E, int C, int O, int P, int Q,
                                    int chunk, int stage_c, int h_is_bf16, void* stream) {
  return entry<bf16, false>(h, w3, b3, basis, x, out, w3_split, E, C, O, P, Q, chunk, stage_c,
                            h_is_bf16, stream);
}

extern "C" int se3_pairwise_bx_v16(const void* h, const void* w3, const void* b3,
                                   const void* basis, const void* x, void* out, void* w3_split,
                                   int E, int C, int O, int P, int Q, int chunk, int stage_c,
                                   int h_is_bf16, void* stream) {
  return entry<bf16, true>(h, w3, b3, basis, x, out, w3_split, E, C, O, P, Q, chunk, stage_c,
                           h_is_bf16, stream);
}
#else
extern "C" int se3_pairwise_bxf(const void* h, const void* w3, const void* b3,
                                const void* basis, const void* x, void* out, void* w3_split,
                                int E, int C, int O, int P, int Q, int chunk, int stage_c,
                                int h_is_bf16, void* stream) {
  return entry<float, false>(h, w3, b3, basis, x, out, w3_split, E, C, O, P, Q, chunk,
                             stage_c, h_is_bf16, stream);
}

extern "C" int se3_pairwise_bx(const void* h, const void* w3, const void* b3,
                               const void* basis, const void* x, void* out, void* w3_split,
                               int E, int C, int O, int P, int Q, int chunk, int stage_c,
                               int h_is_bf16, void* stream) {
  return entry<float, true>(h, w3, b3, basis, x, out, w3_split, E, C, O, P, Q, chunk,
                            stage_c, h_is_bf16, stream);
}
#endif
