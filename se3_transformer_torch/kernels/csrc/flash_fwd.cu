// Streaming kNN equivariant attention, dense arm, for Hopper (sm_90a).
//
// For one output degree d_out (P = 2 d_out + 1), node i and neighbor slot s
// (j = idx[i, s]):
//
//   basis[p, q, f] = sum_m Y[i, s, J^2 + m] Q_J[(p, q), m]      (J = lo + f)
//   V2[p, (c, f)]  = sum_q basis[p, q, f] x_{d_in}[j, c, q]      (all d_in, along i)
//   kv[p, o]       = sum_i V2[p, i] (sum_m h[i, s, m] W3[m, i, o] + b3[i, o])
//
// for the keys (h_k, wk, bk) and the values (h_v, wv, bv); then, per head,
// attention of q over [prefix slots, neighbor slots]: masked slots at the
// finite float32 minimum, slots past K with no weight at all. With tied
// keys and values (tie_key_values; the build's kTie variant) one conv by
// (h_v, wv, bv) makes the tile that serves as both k and v.
//
// Replaces se3_transformer_tpu/kernels/pallas_flash.py::_flash_kernel_body
// (driven by _flash_fwd_impl) in kNN mode with the dense arm (_kv_block's
// 'dense' branch, _init_state, _attend_block). As there, the per-edge basis,
// the gathered features, k, v and the scores never reach device memory.
//
// What bounds it on this card: the radial products. Each output degree runs
// two of them (k and v) over every edge: 2 * 2 * E * mid * IF * O flops,
// ~3.0 TFLOP per attention block at the flagship (E = 32768 edges, mid 128,
// O 64, IF = 256 + 640 + 896 + 1024). They are float32 (bf16-valued h times
// the float32 W3, as the JAX einsum promotes them). With W3 split into bf16
// hi + lo, bf16 h takes them exactly in two bf16 passes (h.W_hi + h.W_lo),
// 6.0 TFLOP or ~6.1 ms at the tensor cores' peak, float32 h in three; the
// float32 apply (R + b3) x V2 runs beside them on the FMA pipe. Every
// 64-edge tile reads all of W3's hi and lo from L2: ~94 GB per block.
//
// What held the previous version back (PERF.md, section 6: timing-only
// variants of it on an H100): the radial product on fp32 FMAs, 75% of the
// block at every degree; behind it W3 staged one slice per i (a cp.async
// double buffer, a barrier per i), 7%, and 18 of the remaining 38 ms once
// the product was gone; the V2 build and the x gather, 5% and 2%. The
// basis build, the epilogue and the attention tail were 1% each.
//
// What the design does about it (kernel #1's tile, common.cuh):
//  * A CTA owns 2 nodes x 32 slot rows = 64 edges and all 64 output
//    channels, 8 warps (4 along edges x 2 along O: two warpgroups of 64
//    edges x 32 channels), one CTA per SM; the [edge, P, O] accumulator
//    lives in registers over the loop over i. h's A fragments come from
//    device memory into registers once per pass (float32 h split into
//    bf16 hi + lo there).
//  * W_k and W_v are split into bf16 hi + lo by split_bf16_kernel in the
//    launch, into scratch the wrapper allocates. i walks the pairs'
//    concatenated (c, f) axis one value a chunk, behind one barrier; W3's
//    hi and lo tiles and b3 go through a 3-stage ring of swizzled tiles,
//    issued in one burst right after the barrier two chunks ahead.
//  * R = h.W3[:, i, :] runs on the tensor cores as wgmma m64n32k16 with
//    fp32 accumulation, h from registers and W3 read by the tensor cores
//    straight from the ring tile (its swizzle is wgmma's 128-byte one), so
//    each W3 element leaves shared memory once per warpgroup, not once
//    per warp as with mma.sync and ldmatrix: h.W_hi + h.W_lo for bf16 h,
//    plus h_lo.W_hi for float32 h, in that fixed order, waited for before
//    the epilogue. No product runs on fp32 FMAs.
//  * V2 is built per stage of channels (3 at F = 1, else 1: at least 3
//    chunks) at the stage's first chunk behind a second barrier, from the
//    neighbors' x rows gathered by idx with cp.async during the previous
//    stage; each basis value is read once a stage; V2 is stored
//    [edge][i][p] (p padded to 4) so the epilogue reads a row's P values as
//    float4s. A pair's basis is rebuilt from the CTA's SH rows (staged once)
//    and its Q_J constants at the pair's first chunk, behind its own
//    barrier (the copies are all waited for there: a pair's last stage may
//    be one chunk long).
//  * k and v do not both fit in shared memory (2 x 64 x 7 x 64 floats). The
//    k pass writes its tile over the ring and basis buffers, folds it into
//    the scores against q at once and leaves only the softmax weights
//    ([2 nodes, heads, prefix + 32 slots]); the v pass then builds v the
//    same way and folds it into the weighted sum. With K <= 32 a node's
//    slots are one block, so the online softmax reduces to one softmax
//    over the prefix slots (first) and the neighbor slots. No atomics: the
//    same bits on every run.
// Where it stands (PERF.md, section 6): 5.9x the previous version's speed
// over a bf16 block and 4.8x in float32, 4.2x its tensor-core bound. The
// variants of its mma.sync form named no single bound: the products about
// half the time, W3's delivery from L2 (every 64-edge tile reads all of
// W_k and W_v, ~94 GB a block) 14%, the epilogue 11%, the V2 build, x
// gather and basis 20% (the k and v passes rebuild the same V2).
// Tried on the card: mma.sync with ldmatrix (16 x 32 warp tiles, and
// 32 x 16 for bf16 h; wgmma took 10% less time in bf16, 29% in float32);
// separate accumulators for the W_lo pass (no gain); chunk i - 1's
// epilogue run while chunk i's wgmma is in flight (no gain at P <= 5,
// spills at P = 7).
// Left for later: W3 shared by two edge tiles (a cluster) to halve its L2
// reads; V2 built once for both passes.
//
// The scaled arm (kQ, quantized serving: se3_flash_fwd_q and
// se3_flash_fwd_so2_q, built as units of their own with -DSE3_QUANT=1):
// W_k and W_v arrive as int8 or fp8 e4m3 storage q with a float32 scale
// per (i, o), and R = (h . q[:, i, :]) * scale[i] + b3[i] (JAX's _kv_block:
// the scale before the bias), in both arms and tied or not. An int8 or
// e4m3 value is exact in bf16, so q needs no lo half: bf16 h takes one
// wgmma pass (h.q) and float32 h two (h_hi.q, h_lo.q), and W3's bytes fall
// from 4 a value to 1. Each i's [128 x 64] slice of q, with b3[i] and
// scale[i], goes by 16-byte cp.async into a ring of QSTAGES 1-byte landing
// slots, issued QSTAGES - 1 chunks ahead, and is upcast to bf16 one chunk
// ahead of its product into one of two 128-byte-swizzled tiles that wgmma
// reads (fenced to the async proxy at the next chunk's barrier), so the
// upcast costs no barrier of its own. No dequantized W3 reaches device
// memory, and no split pass runs. Everything after R is the float arm's.

#include <float.h>

#include "common.cuh"

// the unit's arm and W3 form (the build sets both; see the entry points)
#ifndef SE3_SO2
#define SE3_SO2 0
#endif
#ifndef SE3_QUANT
#define SE3_QUANT 0
#endif

namespace {

using namespace se3;

using bf16 = __nv_bfloat16;

constexpr int NODES = 2;       // nodes per CTA
constexpr int SLOTS = 32;      // slot rows per node (K <= 32)
static_assert(NODES * SLOTS == BE, "a CTA's edge rows are its nodes' slots");
constexpr int MAX_PAIRS = 4;
constexpr int MAX_PREFIX = 4;
constexpr int MAX_HEADS = 8;
constexpr int MAX_S = 49;      // SH stack rows: degrees 0 .. 6
constexpr int QMAX = 7;        // input degree <= 3
constexpr int AS = MAX_PREFIX + SLOTS;  // row stride of the softmax weights
constexpr int RING = 3;        // W3 ring stages: copies issued 2 chunks ahead
constexpr float NEG_INF = -FLT_MAX;

struct Pairs {
  const float* x[MAX_PAIRS];  // node features [B, n, C, 2 d + 1]
  int d[MAX_PAIRS];
  int c[MAX_PAIRS];
  int cg_off[MAX_PAIRS];      // the pair's Q_J blocks in cg
  int count;
};

struct Args {
  const float* q;             // [B, n, H, Dh]
  const long long* idx;       // [B, n, K]
  const uint8_t* nmask;       // [B, n, K] or null
  const void* h[2];           // h_k, h_v [B, n, K, MID]
  const bf16* whi[2];         // W_k, W_v [MID, IF, BO]: bf16 hi
  const bf16* wlo[2];         //   and lo halves
  const uint8_t* wq[2];       // the scaled arm: W_k, W_v storage [MID, IF, BO]
  const float* wsc[2];        //   and their scales [IF, BO]
  int fp8;                    //   e4m3 storage (else int8)
  const float* b3[2];         // bk, bv [IF, BO]
  const float* sh;            // [B, n, K, S]: the SH stack, or the so2 arm's frames
  const float* prefix[2];     // prefix_k, prefix_v [B, n, S0, H * Dh] or null
  const float* cg;            // Q_J constants, or the so2 arm's J_l and canonical blocks
  float* out;                 // [B, n, H, Dh]
  int n, K, S, S0, H, IF;
  float scale;
};

// One (d_in, d_out) pair's V2 stage: F values of f, GC channels a stage
// (a whole stage is at least 3 chunks of one i), x rows of GC * Q floats.
template <int P, int Q>
struct PairCfg {
  static constexpr int F = P < Q ? P : Q;
  static constexpr int GC = F == 1 ? 3 : 1;
  static constexpr int XS = GC * Q + 1;  // sX row stride
  static constexpr int PFQ = P * F * Q;  // sB row stride
};

constexpr int QSTAGES = 4;        // the scaled arm's landing slots
constexpr int Q_SLICE = MID * BO;  // one landing slot: [MID][BO] bytes

// Shared memory by P, as byte offsets; the k / v tile [BE][P][BO] reuses
// the ring and basis region once a pass's products are done. The scaled
// arm lays its ring out in the W region: two bf16 tiles (QT), QSTAGES
// landing slots (QL), then QSTAGES x [BO] floats of b3 (QB) and of the
// scale (QS).
template <int P>
struct Smem {
  static constexpr int PP = P == 1 ? 1 : (P + 3) / 4 * 4;  // V2 values per (row, i)
  static constexpr int SI = P > 3 ? P : 3;                 // i values of the longest stage
  static constexpr int RS = SI * PP + (PP == 1 ? 1 : 4);   // sV row stride in floats
  static constexpr int XS = 3 * QMAX + 1;                  // the widest sX row
  static constexpr int PFQ = P * P * QMAX;                 // the widest basis row
  static constexpr size_t WT = 2ull * MID * BO;            // bytes of one bf16 W3 tile
  static constexpr size_t W = 0;                           // [RING][hi, lo] W3 tiles
  static constexpr size_t B3 = W + RING * 2 * WT;          // [RING][BO] float
  static constexpr size_t BS = B3 + 4ull * RING * BO;      // [BE][PFQ] float: the basis
  static constexpr size_t KV_END = 4ull * BE * P * BO;
  static constexpr size_t REGION = BS + 4ull * BE * PFQ > KV_END ? BS + 4ull * BE * PFQ : KV_END;
  static constexpr size_t Y = REGION;                      // [BE][MAX_S] float: SH rows
  static constexpr size_t X = Y + 4ull * BE * MAX_S;       // [BE][XS] float
  static constexpr size_t V = X + 4ull * BE * XS;          // [BE][RS] float
  static constexpr size_t A = V + 4ull * BE * RS;          // softmax weights
  static constexpr size_t SRC = A + 4ull * NODES * MAX_HEADS * AS;
  static constexpr size_t OK = SRC + 4ull * BE;
  static constexpr size_t BYTES = OK + 4ull * BE;
  static_assert(BYTES <= 232448, "the tile fits one SM's shared memory");
  static constexpr size_t QT = W;
  static constexpr size_t QL = QT + 2 * WT;
  static constexpr size_t QB = QL + (size_t)QSTAGES * Q_SLICE;
  static constexpr size_t QS = QB + 4ull * QSTAGES * BO;
  static_assert(QS + 4ull * QSTAGES * BO <= B3, "the scaled ring fits the W region");
};

// The radial products on wgmma: a warpgroup (warps 4 wo .. 4 wo + 3)
// computes R for the 64 edges x its 32 channels as m64n32k16 steps, A (h)
// from registers in mma.sync's m16n8k16 fragment layout (warp w of the
// group holds rows 16 w .. 16 w + 15), B a [16][32] slice of a ring tile
// read by the tensor cores straight from shared memory, once per
// warpgroup, through sw128_desc (common.cuh). The accumulator comes back
// in mma.sync's [nb][4] layout for the warp's rows.
__device__ __forceinline__ void wgmma_k16(float (&d)[4][4], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// R = h.W3[:, i, the warpgroup's 32 channels] from ring stage sw (W_hi,
// then W_lo MID x BO elements later): per k-step h.W_hi, h.W_lo and, with
// float32 h (kLo), h_lo.W_hi, in that fixed order; synchronous.
template <bool kLo>
__device__ __forceinline__ void radial_wgmma(float (&r)[4][4], const uint32_t (&ahi)[MID / 16][4],
                                             const uint32_t (&alo)[kLo ? MID / 16 : 1][4],
                                             const bf16* sw) {
  const uint64_t dhi = sw128_desc(sw), dlo = sw128_desc(sw + MID * BO);
  fence_acc(r);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < MID / 16; ++kk) {
    const uint64_t step = kk * 16 * BO * sizeof(bf16) / 16;  // 16 rows, in 16-byte units
    wgmma_k16(r, ahi[kk], dhi + step);
    wgmma_k16(r, ahi[kk], dlo + step);
    if constexpr (kLo) wgmma_k16(r, alo[kk], dhi + step);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(r);
}

// The scaled arm's R: h.q[:, i, the warpgroup's 32 channels] from the
// upcast tile sw, with float32 h (kLo) h_lo.q after h_hi.q per k-step;
// synchronous.
template <bool kLo>
__device__ __forceinline__ void radial_wgmma_q(float (&r)[4][4],
                                               const uint32_t (&ahi)[MID / 16][4],
                                               const uint32_t (&alo)[kLo ? MID / 16 : 1][4],
                                               const bf16* sw) {
  const uint64_t d = sw128_desc(sw);
  fence_acc(r);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < MID / 16; ++kk) {
    const uint64_t step = kk * 16 * BO * sizeof(bf16) / 16;  // 16 rows, in 16-byte units
    wgmma_k16(r, ahi[kk], d + step);
    if constexpr (kLo) wgmma_k16(r, alo[kk], d + step);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(r);
}

// A landing slot [MID][BO] of storage Q upcast to bf16 into a swizzled
// tile (swz): each 16-byte chunk of 16 values into two 8-column chunks.
template <typename Q>
__device__ __forceinline__ void convert_swz(bf16* tile, const uint8_t* slot, int tid) {
  constexpr int CHUNKS = BO / 16;
  for (int f = tid; f < MID * CHUNKS; f += NTHREADS) {
    const int m = f / CHUNKS, c = (f % CHUNKS) * 16;
    uint4 lo, hi;
    q16_to_bf16<Q>(*reinterpret_cast<const uint4*>(slot + m * BO + c), lo, hi);
    *reinterpret_cast<uint4*>(tile + swz(m, c)) = lo;
    *reinterpret_cast<uint4*>(tile + swz(m, c + 8)) = hi;
  }
}

// V2 of the stage staged in sX (pair degree d_in) into sV.
template <int P>
__device__ __forceinline__ void build_stage(int d_in, float* sV, const float* sX,
                                            const float* sB, int tid) {
  using S = Smem<P>;
#define SE3_Q(QQ)                                                                          \
  build_v2<P, QQ, PairCfg<P, QQ>::GC, S::PP, S::RS, PairCfg<P, QQ>::XS, PairCfg<P, QQ>::PFQ, \
           false>(sV, sX, sB, tid)
  switch (d_in) {
    case 0: SE3_Q(1); break;
    case 1: SE3_Q(3); break;
    case 2: SE3_Q(5); break;
    default: SE3_Q(7); break;
  }
#undef SE3_Q
}

// The so2 arm's basis of one pair (input degree (Q - 1) / 2), the dense
// arm's sB layout: a thread per (edge, p) builds the row's F x Q values from
// the edge's frame (sY, S = 4 L1 floats a row) and the constants
// (common.cuh, so2_basis_row).
template <int P, int Q>
__device__ __forceinline__ void so2_stage_basis(float* sB, const float* sY, int L1,
                                                const float* __restrict__ so2c,
                                                const float* __restrict__ ab, int tid) {
  constexpr int F = P < Q ? P : Q, PFQ = P * F * Q;
  for (int k = tid; k < BE * P; k += NTHREADS) {
    const int e = k / P, p = k - e * P;
    float* dst = sB + e * PFQ + p * F * Q;
    so2_basis_row<P, Q>(sY + e * MAX_S, L1, p, so2c, ab,
                        [&](int f, int q, float v) { dst[f * Q + q] = v; });
  }
}

// One radial contraction (cv = 0: keys, 1: values) of the CTA's 64 edges
// into the k / v tile sKV[e][p][o] in shared memory; kSo2: the so2 arm's
// basis in place of the dense arm's; kQ: the scaled arm's W3.
template <typename T, int P, bool kSo2, bool kQ>
__device__ __forceinline__ void conv_pass(const Args& a, const Pairs& pairs, int cv, int b,
                                          int node0, unsigned char* smem) {
  using S = Smem<P>;
  constexpr bool kLo = sizeof(T) == 4;  // float32 h: the pass h_lo.W_hi (kQ: h_lo.q)
  // chunks ahead that a W3 slice's copies are issued
  constexpr int AHEAD = kQ ? QSTAGES - 1 : 2;
  bf16* sW = reinterpret_cast<bf16*>(smem + S::W);
  float* sb3 = reinterpret_cast<float*>(smem + S::B3);
  bf16* sQT = reinterpret_cast<bf16*>(smem + S::QT);
  uint8_t* sQL = smem + S::QL;
  float* sQB = reinterpret_cast<float*>(smem + S::QB);
  float* sQS = reinterpret_cast<float*>(smem + S::QS);
  float* sB = reinterpret_cast<float*>(smem + S::BS);
  const float* sY = reinterpret_cast<const float*>(smem + S::Y);
  float* sX = reinterpret_cast<float*>(smem + S::X);
  float* sV = reinterpret_cast<float*>(smem + S::V);
  const int* sSrc = reinterpret_cast<const int*>(smem + S::SRC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we = warp & 3, wo = warp >> 2;  // wo: the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int e_lo = we * 16 + g;       // the thread's first row
  const int col0 = wo * 32 + 2 * t;   // and first column
  const int n = a.n, K = a.K, IF = a.IF;
  const int d_out = (P - 1) / 2;
  const T* h = static_cast<const T*>(a.h[cv]);
  const bf16* whi = a.whi[cv];
  const bf16* wlo = a.wlo[cv];
  const uint8_t* wq = a.wq[cv];
  const float* wsc = a.wsc[cv];
  const float* b3 = a.b3[cv];

  // i's W3 hi and lo tiles and b3[i] into ring stage i % RING, in one burst
  // of 16-byte cp.async (8 a thread for W3)
  auto stage_w = [&](int i) {
    const int kb = i % RING;
#pragma unroll
    for (int r = 0; r < 2 * 4; ++r) {
      const int half = r / 4, f = tid + (r % 4) * NTHREADS;
      const int ch = f & 7, m = f >> 3;
      cp_async16(sW + (size_t)(kb * 2 + half) * MID * BO + swz(m, ch * 8),
                 (half ? wlo : whi) + ((size_t)m * IF + i) * BO + ch * 8);
    }
    if (tid < BO / 4) cp_async16(sb3 + kb * BO + tid * 4, b3 + (size_t)i * BO + tid * 4);
  };
  // the scaled arm: i's q slice, b3[i] and scale[i] into landing slot i %
  // QSTAGES (16-byte cp.async, 2 a thread for q)
  auto stage_q = [&](int i) {
    const int kb = i % QSTAGES;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int f = tid + r * NTHREADS, m = f >> 2, ch = f & 3;
      cp_async16(sQL + kb * Q_SLICE + m * BO + ch * 16, wq + ((size_t)m * IF + i) * BO + ch * 16);
    }
    if (tid < BO / 4)
      cp_async16(sQB + kb * BO + tid * 4, b3 + (size_t)i * BO + tid * 4);
    else if (tid < BO / 2)
      cp_async16(sQS + kb * BO + (tid - BO / 4) * 4, wsc + (size_t)i * BO + (tid - BO / 4) * 4);
  };
  auto issue = [&](int i) {
    if constexpr (kQ)
      stage_q(i);
    else
      stage_w(i);
  };
  // the scaled arm: i's landing slot upcast into tile i % 2
  auto convert = [&](int i) {
    bf16* tile = sQT + (i & 1) * MID * BO;
    const uint8_t* slot = sQL + (i % QSTAGES) * Q_SLICE;
    if (a.fp8)
      convert_swz<__nv_fp8_e4m3>(tile, slot, tid);
    else
      convert_swz<int8_t>(tile, slot, tid);
  };
  auto stage_c = [&](int pi) {  // channels per V2 stage of pair pi
    return min(P, 2 * pairs.d[pi] + 1) == 1 ? 3 : 1;
  };
  // the neighbors' x rows of pair pi's channels c0 .. c0 + GC into sX
  // (zeros where no edge and past C); a row's GC Q values are contiguous
  auto stage_x = [&](int pi, int c0) {
    const int C = pairs.c[pi], Q = 2 * pairs.d[pi] + 1;
    const int W = stage_c(pi) * Q, XS = W + 1;
    const float* x = pairs.x[pi];
    for (int k = tid; k < BE * W; k += NTHREADS) {
      const int r = k / W, j = k - r * W;
      const int src = sSrc[r];
      if (src >= 0 && c0 * Q + j < C * Q)
        cp_async4(sX + r * XS + j, x + (((size_t)b * n + src) * C + c0) * Q + j);
      else
        sX[r * XS + j] = 0.f;
    }
  };
  // pair pi's basis, (p, f, q)-ordered rows: sum over m of Y_J Q_J (the
  // so2 arm: from the frames)
  auto build_basis = [&](int pi) {
    if constexpr (kSo2) {
      const float* ab = a.cg + pairs.cg_off[pi];
      const int L1 = a.S / 4;
      switch (pairs.d[pi]) {
        case 0: so2_stage_basis<P, 1>(sB, sY, L1, a.cg, ab, tid); break;
        case 1: so2_stage_basis<P, 3>(sB, sY, L1, a.cg, ab, tid); break;
        case 2: so2_stage_basis<P, 5>(sB, sY, L1, a.cg, ab, tid); break;
        default: so2_stage_basis<P, 7>(sB, sY, L1, a.cg, ab, tid); break;
      }
      return;
    }
    const int d_in = pairs.d[pi], Q = 2 * d_in + 1;
    const int F = P < Q ? P : Q, PFQ = P * F * Q;
    const int lo = d_in > d_out ? d_in - d_out : d_out - d_in;
    const float* cg = a.cg + pairs.cg_off[pi];
    for (int k = tid; k < BE * PFQ; k += NTHREADS) {
      const int e = k / PFQ, rest = k - e * PFQ;
      const int pf = rest / Q, qq = rest - pf * Q;
      const int p = pf / F, f = pf - p * F, J = lo + f, M = 2 * J + 1;
      const float* qj = cg + P * Q * (J * J - lo * lo) + (p * Q + qq) * M;
      const float* y = sY + e * MAX_S + J * J;
      float s = 0.f;
      for (int m = 0; m < M; ++m) s = fmaf(y[m], __ldg(qj + m), s);
      sB[e * PFQ + rest] = s;
    }
  };

  // prologue, AHEAD cp.async groups: i = 0's W3 and b3 with pair 0's first
  // x stage; i = 1's (kQ: and i = 2's) W3 and b3
  issue(0);
  stage_x(0, 0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < AHEAD; ++s) {
    if (IF > s) issue(s);
    cp_async_commit();
  }

  // h's A fragments straight from device memory while the copies fly;
  // zeros where no edge
  auto h_row = [&](int e) -> const T* {
    const int node = node0 + e / SLOTS, s = e % SLOTS;
    return node < n && s < K ? h + (((size_t)b * n + node) * K + s) * MID : nullptr;
  };
  uint32_t ahi[MID / 16][4], alo[kLo ? MID / 16 : 1][4];
  load_afrag_global<T>(ahi, alo, h_row(e_lo), h_row(e_lo + 8), t);

  build_basis(0);
  cp_async_wait<AHEAD - 1>();
  __syncthreads();
  build_stage<P>(pairs.d[0], sV, sX, sB, tid);
  if constexpr (kQ) convert(0);

  float acc[P][4][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[p][nb][v] = 0.f;

  // Chunk i, behind one barrier: i's W3 and b3 (issued two chunks ago)
  // have landed, and every warp is done with i - 1, whose ring stage
  // i + 2's copies now refill. At a stage's first chunk the stage's V2 is
  // built first (at a pair's first chunk after the pair's basis), behind a
  // barrier each, and the next stage's x is issued. kQ: i + 1's slice has
  // landed and i's tile is written (the fence below orders the upcast's
  // writes before wgmma's reads); i + 3's copies refill the landing slot
  // of i - 1, and i + 1's slice is upcast into the tile i - 1 used.
  int pi = 0, c0 = 0, kin = 0;
  int slen = min(stage_c(0), pairs.c[0]) * min(P, 2 * pairs.d[0] + 1);
  for (int i = 0; i < IF; ++i) {
    if (i > 0 && kin == 0 && c0 == 0)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    // the ring's cp.async writes, before the tensor cores read them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kin == 0) {
      if (i > 0) {
        if (c0 == 0) {
          build_basis(pi);
          __syncthreads();
        }
        build_stage<P>(pairs.d[pi], sV, sX, sB, tid);
        __syncthreads();
      }
      int npi = pi, nc0 = c0 + stage_c(pi);
      if (nc0 >= pairs.c[pi]) ++npi, nc0 = 0;
      if (npi < pairs.count) stage_x(npi, nc0);
    }
    if (i + AHEAD < IF) issue(i + AHEAD);
    cp_async_commit();
    if constexpr (kQ)
      if (i + 1 < IF) convert(i + 1);

    float r[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) r[nb][v] = 0.f;
    if constexpr (kQ) {
      radial_wgmma_q<kLo>(r, ahi, alo, sQT + (size_t)(i & 1) * MID * BO + wo * 32);
      // the dequant epilogue: (h . q) * scale, before b3
      const float* sc = sQS + (i % QSTAGES) * BO + col0;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float2 s2 = *reinterpret_cast<const float2*>(sc + nb * 8);
        r[nb][0] *= s2.x;
        r[nb][1] *= s2.y;
        r[nb][2] *= s2.x;
        r[nb][3] *= s2.y;
      }
      apply_v2<P, S::PP, S::RS>(acc, r, sV + e_lo * S::RS + kin * S::PP,
                                sQB + (i % QSTAGES) * BO + col0);
    } else {
      radial_wgmma<kLo>(r, ahi, alo, sW + (size_t)(i % RING) * 2 * MID * BO + wo * 32);
      // epilogue: acc[p] += V2[e, p, i] * (R + b3)
      apply_v2<P, S::PP, S::RS>(acc, r, sV + e_lo * S::RS + kin * S::PP,
                                sb3 + (i % RING) * BO + col0);
    }

    if (++kin == slen) {
      kin = 0;
      c0 += stage_c(pi);
      if (c0 >= pairs.c[pi]) ++pi, c0 = 0;
      if (pi < pairs.count)
        slen = min(stage_c(pi), pairs.c[pi] - c0) * min(P, 2 * pairs.d[pi] + 1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and the basis are rewritten as the tile

  // the k / v tile [e][p][o] over the ring and basis buffers
  float* sKV = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int col = col0 + nb * 8;
      *reinterpret_cast<float2*>(sKV + (e_lo * P + p) * BO + col) =
          make_float2(acc[p][nb][0], acc[p][nb][1]);
      *reinterpret_cast<float2*>(sKV + ((e_lo + 8) * P + p) * BO + col) =
          make_float2(acc[p][nb][2], acc[p][nb][3]);
    }
  __syncthreads();
}

// kTie: the keys are the values (one conv pass, its tile read as k and as
// v); kSo2: both passes by the so2 arm, from the frames in a.sh; kQ: the
// scaled arm's W3. Each a compile-time variant, so that the dense untied
// build is unchanged.
template <typename T, int P, bool kTie, bool kSo2, bool kQ>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const Args a, const Pairs pairs) {
  using S = Smem<P>;
  // the ring's tiles start the region: wgmma's 128-byte swizzle reads them
  // as 1024-byte-aligned 8-row groups
  extern __shared__ __align__(1024) unsigned char smem[];
  const float* sKV = reinterpret_cast<const float*>(smem);
  float* sY = reinterpret_cast<float*>(smem + S::Y);
  float* sA = reinterpret_cast<float*>(smem + S::A);
  int* sSrc = reinterpret_cast<int*>(smem + S::SRC);
  int* sOk = reinterpret_cast<int*>(smem + S::OK);

  const int tid = threadIdx.x;
  const int b = blockIdx.y, node0 = blockIdx.x * NODES;
  const int n = a.n, K = a.K, S0 = a.S0, H = a.H;
  const int dim_head = BO / H, Dh = dim_head * P;

  // the edge rows: source node (-1: no edge), neighbor mask, SH (so2:
  // frame) rows
  for (int e = tid; e < BE; e += NTHREADS) {
    const int node = node0 + e / SLOTS, s = e % SLOTS;
    const bool edge = node < n && s < K;
    const size_t slot = ((size_t)b * n + node) * K + s;
    sSrc[e] = edge ? (int)a.idx[slot] : -1;
    sOk[e] = edge && (a.nmask == nullptr || a.nmask[slot]);
  }
  for (int k = tid; k < BE * a.S; k += NTHREADS) {
    const int e = k / a.S, m = k - e * a.S;
    const int node = node0 + e / SLOTS, s = e % SLOTS;
    sY[e * MAX_S + m] = node < n && s < K
                            ? __ldg(a.sh + (((size_t)b * n + node) * K + s) * a.S + m)
                            : 0.f;
  }
  __syncthreads();

  // keys: the tile (tied: the values' tile, which stays for the weighted
  // sum), then the scores against q (prefix slots first)
  conv_pass<T, P, kSo2, kQ>(a, pairs, kTie ? 1 : 0, b, node0, smem);
  for (int k = tid; k < NODES * H * (S0 + SLOTS); k += NTHREADS) {
    const int nl = k / (H * (S0 + SLOTS)), rest = k - nl * H * (S0 + SLOTS);
    const int hd = rest / (S0 + SLOTS), j = rest - hd * (S0 + SLOTS);
    const int node = node0 + nl;
    if (node >= n || j >= S0 + K) continue;
    const float* qn = a.q + (((size_t)b * n + node) * H + hd) * Dh;
    float s = 0.f;
    if (j < S0) {
      const float* pk = a.prefix[0] + (((size_t)b * n + node) * S0 + j) * H * Dh + hd * Dh;
      for (int d = 0; d < Dh; ++d) s = fmaf(__ldg(qn + d), __ldg(pk + d), s);
      s *= a.scale;
    } else {
      const int e = nl * SLOTS + j - S0;
      const float* kr = sKV + e * P * BO + hd * dim_head;
      for (int dh = 0; dh < dim_head; ++dh)
        for (int p = 0; p < P; ++p) s = fmaf(__ldg(qn + dh * P + p), kr[p * BO + dh], s);
      s *= a.scale;
      if (!sOk[e]) s = NEG_INF;
    }
    sA[(nl * MAX_HEADS + hd) * AS + j] = s;
  }
  __syncthreads();
  // softmax over the prefix and neighbor slots of each (node, head)
  for (int k = tid; k < NODES * H; k += NTHREADS) {
    const int nl = k / H, hd = k - nl * H;
    if (node0 + nl >= n) continue;
    float* row = sA + (nl * MAX_HEADS + hd) * AS;
    const int cnt = S0 + K;
    float mx = NEG_INF;
    for (int j = 0; j < cnt; ++j) mx = fmaxf(mx, row[j]);
    float l = 0.f;
    for (int j = 0; j < cnt; ++j) {
      const float p = expf(row[j] - mx);
      row[j] = p;
      l += p;
    }
    for (int j = 0; j < cnt; ++j) row[j] = row[j] / l;
  }
  __syncthreads();

  // values: the tile (tied: the keys' tile as it is), then the weighted sum
  if constexpr (!kTie) conv_pass<T, P, kSo2, kQ>(a, pairs, 1, b, node0, smem);
  for (int k = tid; k < NODES * H * Dh; k += NTHREADS) {
    const int nl = k / (H * Dh), rest = k - nl * H * Dh;
    const int hd = rest / Dh, d = rest - hd * Dh;
    const int dh = d / P, p = d - dh * P;
    const int node = node0 + nl;
    if (node >= n) continue;
    const float* row = sA + (nl * MAX_HEADS + hd) * AS;
    float o = 0.f;
    for (int j = 0; j < S0; ++j)
      o = fmaf(row[j], __ldg(a.prefix[1] + (((size_t)b * n + node) * S0 + j) * H * Dh +
                             hd * Dh + d),
               o);
    const float* vr = sKV + (nl * SLOTS * P + p) * BO + hd * dim_head + dh;
    for (int s = 0; s < K; ++s) o = fmaf(row[S0 + s], vr[s * P * BO], o);
    a.out[(((size_t)b * n + node) * H + hd) * Dh + d] = o;
  }
}

template <typename T, int P, bool kTie, bool kSo2, bool kQ>
cudaError_t launch(const Args& a, const Pairs& pairs, int B, cudaStream_t stream) {
  constexpr size_t smem = Smem<P>::BYTES;
  auto kern = flash_fwd_kernel<T, P, kTie, kSo2, kQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n + NODES - 1) / NODES, B);
  kern<<<grid, NTHREADS, smem, stream>>>(a, pairs);
  return cudaGetLastError();
}

// The entry points' body: the checks, the pairs, W_k's and W_v's split
// (the float arm) or storage and scales (kQ), and the launch of this
// unit's arm (SE3_SO2) by P, h's type and tie.
template <bool kQ>
int flash_entry(const void* q, const void* const* xs, const void* idx, const void* nmask,
                const void* h_v, const void* h_k, const void* wv, const void* wk,
                const void* bv, const void* bk, const void* sh, const void* prefix_k,
                const void* prefix_v, const void* cg, void* out, void* w_split,
                const void* wv_scale, const void* wk_scale, const int* ds, const int* cs,
                const int* offs, int n_pairs, int B, int n, int K, int S, int S0, int H,
                int IF, int P, int h_is_bf16, int tie, int so2, int fp8, float scale,
                void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (so2 != SE3_SO2 || n_pairs < 1 || n_pairs > MAX_PAIRS || K < 1 || K > SLOTS || S < 1 ||
      S > MAX_S || (so2 && (S % 4 || 2 * (S / 4) - 1 < P)) ||
      S0 < 0 || S0 > MAX_PREFIX || H < 1 || H > MAX_HEADS || BO % H || IF < 1)
    return (int)cudaErrorInvalidValue;
  Pairs pairs;
  for (int k = 0; k < MAX_PAIRS; ++k) {
    if (k < n_pairs &&
        (ds[k] < 0 || 2 * ds[k] + 1 > QMAX || cs[k] < 1 || (so2 && ds[k] >= S / 4)))
      return (int)cudaErrorInvalidValue;
    pairs.x[k] = static_cast<const float*>(xs[k]);
    pairs.d[k] = ds[k];
    pairs.c[k] = cs[k];
    pairs.cg_off[k] = offs[k];
  }
  pairs.count = n_pairs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.whi[0] = a.wlo[0] = a.whi[1] = a.wlo[1] = nullptr;
  a.wq[0] = a.wq[1] = nullptr;
  a.wsc[0] = a.wsc[1] = nullptr;
  a.fp8 = fp8;
  const void* w3s[2] = {wk, wv};
  if constexpr (kQ) {
    // the storage as it is: no split, no dequantized copy
    const void* scs[2] = {wk_scale, wv_scale};
    for (int cv = tie ? 1 : 0; cv < 2; ++cv) {
      a.wq[cv] = static_cast<const uint8_t*>(w3s[cv]);
      a.wsc[cv] = static_cast<const float*>(scs[cv]);
    }
  } else {
    // W_k and W_v [MID, IF, BO] float32 (a whole number of float4s) into
    // their bf16 hi and lo arrays (tied: W_v's only)
    const size_t nw = (size_t)MID * IF * BO;
    const size_t need = (nw / 4 + NTHREADS - 1) / NTHREADS;
    const unsigned blocks = (unsigned)(need < 4096 ? need : 4096);
    bf16* ws = static_cast<bf16*>(w_split);
    for (int cv = tie ? 1 : 0; cv < 2; ++cv) {
      bf16* hi = ws + 2 * (tie ? 0 : cv) * nw;
      split_bf16_kernel<<<blocks, NTHREADS, 0, s>>>(static_cast<const float4*>(w3s[cv]),
                                                    nw / 4, reinterpret_cast<uint2*>(hi),
                                                    reinterpret_cast<uint2*>(hi + nw));
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      a.whi[cv] = hi;
      a.wlo[cv] = hi + nw;
    }
  }
  a.q = static_cast<const float*>(q);
  a.idx = static_cast<const long long*>(idx);
  a.nmask = static_cast<const uint8_t*>(nmask);
  a.h[0] = h_k;
  a.h[1] = h_v;
  a.b3[0] = static_cast<const float*>(bk);
  a.b3[1] = static_cast<const float*>(bv);
  a.sh = static_cast<const float*>(sh);
  a.prefix[0] = static_cast<const float*>(prefix_k);
  a.prefix[1] = static_cast<const float*>(prefix_v);
  a.cg = static_cast<const float*>(cg);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.K = K;
  a.S = S;
  a.S0 = S0;
  a.H = H;
  a.IF = IF;
  a.scale = scale;
#define SE3_V(PP, TIE, SO2)                                                   \
  (h_is_bf16 ? launch<bf16, PP, TIE, SO2, kQ>(a, pairs, B, s)                 \
             : launch<float, PP, TIE, SO2, kQ>(a, pairs, B, s))
#define SE3_P(PP) \
  if (P == PP) return (int)(tie ? SE3_V(PP, true, SE3_SO2 != 0) : SE3_V(PP, false, SE3_SO2 != 0));
  SE3_P(1) SE3_P(3) SE3_P(5) SE3_P(7)
#undef SE3_P
#undef SE3_V
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch status
// (cudaGetLastError() right after the launches); 0 is success. Pointers are
// device pointers to contiguous tensors (the caller, kernels/flash.py,
// checks every shape; h, wv, wk, bv and bk start on 16 bytes): q [B, n, H,
// Dh] with H * dim_head = 64 and Dh = dim_head * P; x0..x3 the node
// features [B, n, C_k, 2 d_k + 1] of the n_pairs input degrees (d_k <= 3);
// idx int64 [B, n, K], K <= 32; nmask bool [B, n, K] or null; h_v, h_k [B,
// n, K, 128] (bf16 when h_is_bf16, else float32); wv, wk [128, IF, 64]
// float32; bv, bk [IF, 64]; sh [B, n, K, S], S <= 49 (so2: the packed
// frames, S = 4 L1, L1 above every degree); prefix_k, prefix_v
// [B, n, S0, H * Dh] (S0 <= 4; null when S0 = 0); cg the Q_J constants,
// pair k's from cg_off_k (so2: J_1..J_3, then pair k's canonical blocks
// from cg_off_k); out [B, n, H, Dh]; w_split scratch of 4 * 128 *
// IF * 64 bf16 (W_k's hi and lo arrays, then W_v's). tie: the keys are the
// values; h_k, wk and bk are not read (null), and w_split holds W_v's two
// arrays only (2 * 128 * IF * 64 bf16). so2: both passes by the so2 arm.
//
// The scaled arm's entry (se3_flash_fwd_q, se3_flash_fwd_so2_q) takes, in
// place of w_split, wv_scale and wk_scale [IF, 64] float32 (wk_scale null
// when tied), with wv and wk the int8 storage [128, IF, 64], or fp8 e4m3
// with fp8 != 0.
//
// The build compiles this source four times, once per arm (SE3_SO2 0 and
// 1) and per W3 form (SE3_QUANT 0 and 1), so that the instantiations
// compile in parallel: se3_flash_fwd launches the dense arm,
// se3_flash_fwd_so2 the so2 arm, each with an _q entry for the scaled arm;
// each refuses the other arm's `so2`.
#if SE3_SO2 && SE3_QUANT
#define SE3_FLASH_FWD_ENTRY se3_flash_fwd_so2_q
#elif SE3_SO2
#define SE3_FLASH_FWD_ENTRY se3_flash_fwd_so2
#elif SE3_QUANT
#define SE3_FLASH_FWD_ENTRY se3_flash_fwd_q
#else
#define SE3_FLASH_FWD_ENTRY se3_flash_fwd
#endif
#if SE3_QUANT
extern "C" int SE3_FLASH_FWD_ENTRY(const void* q, const void* x0, const void* x1, const void* x2,
                                   const void* x3, const void* idx, const void* nmask,
                                   const void* h_v, const void* h_k, const void* wv,
                                   const void* wk, const void* bv, const void* bk, const void* sh,
                                   const void* prefix_k, const void* prefix_v, const void* cg,
                                   void* out, const void* wv_scale, const void* wk_scale, int d0,
                                   int d1, int d2, int d3, int c0, int c1, int c2, int c3,
                                   int off0, int off1, int off2, int off3, int n_pairs, int B,
                                   int n, int K, int S, int S0, int H, int IF, int P,
                                   int h_is_bf16, int tie, int so2, int fp8, float scale,
                                   void* stream) {
  const void* xs[MAX_PAIRS] = {x0, x1, x2, x3};
  const int ds[MAX_PAIRS] = {d0, d1, d2, d3}, cs[MAX_PAIRS] = {c0, c1, c2, c3};
  const int offs[MAX_PAIRS] = {off0, off1, off2, off3};
  return flash_entry<true>(q, xs, idx, nmask, h_v, h_k, wv, wk, bv, bk, sh, prefix_k, prefix_v,
                           cg, out, nullptr, wv_scale, wk_scale, ds, cs, offs, n_pairs, B, n, K,
                           S, S0, H, IF, P, h_is_bf16, tie, so2, fp8, scale, stream);
}
#else
extern "C" int SE3_FLASH_FWD_ENTRY(const void* q, const void* x0, const void* x1, const void* x2,
                                   const void* x3, const void* idx, const void* nmask,
                                   const void* h_v, const void* h_k, const void* wv,
                                   const void* wk, const void* bv, const void* bk, const void* sh,
                                   const void* prefix_k, const void* prefix_v, const void* cg,
                                   void* out, void* w_split, int d0, int d1, int d2, int d3,
                                   int c0, int c1, int c2, int c3, int off0, int off1, int off2,
                                   int off3, int n_pairs, int B, int n, int K, int S, int S0,
                                   int H, int IF, int P, int h_is_bf16, int tie, int so2,
                                   float scale, void* stream) {
  const void* xs[MAX_PAIRS] = {x0, x1, x2, x3};
  const int ds[MAX_PAIRS] = {d0, d1, d2, d3}, cs[MAX_PAIRS] = {c0, c1, c2, c3};
  const int offs[MAX_PAIRS] = {off0, off1, off2, off3};
  return flash_entry<false>(q, xs, idx, nmask, h_v, h_k, wv, wk, bv, bk, sh, prefix_k,
                            prefix_v, cg, out, w_split, nullptr, nullptr, ds, cs, offs, n_pairs,
                            B, n, K, S, S0, H, IF, P, h_is_bf16, tie, so2, 0, scale, stream);
}
#endif
