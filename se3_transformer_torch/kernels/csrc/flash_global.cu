// kNN-free global equivariant attention, dense arm, for Hopper (sm_90a).
//
// For one output degree d_out (P = 2 d_out + 1) every query node i attends
// to the prefix slots and to every node j, the pair payload rebuilt per tile
// from the coordinates:
//
//   rel = c_i - c_j,  dist = sqrt(max(|rel|^2, 1e-16)),  rhat = rel / dist
//   h   = GELU(LN(GELU(LN(dist w1 + b1)) W2 + b2))      (one trunk for k, one for v)
//   Y   = real spherical harmonics of rhat, degrees 0 .. L
//   basis[p, q, f] = sum_m Y[J^2 + m] Q_J[(p, q), m]       (J = |d_in - d_out| + f)
//   V2[p, (c, f)]  = sum_q basis[p, q, f] x_{d_in}[j, c, q]  (all d_in, along i)
//   kv[o, p]       = sum_i V2[p, i] (sum_m h[m] W3[m, i, o] + b3[i, o])
//
// then the scores of q_i against k (masked columns at the finite float32
// minimum: the node mask, and j == i with exclude_self) and an online
// softmax over the kv blocks, seeded with the prefix slots; LN is the
// two-pass LayerNorm with eps 1e-6 and GELU the tanh approximation, as in
// the JAX trunk. With tied keys and values (tie_key_values; the build's
// kTie variant) there is one trunk and one radial product, by the values'
// parameters, and the tile serves as both k and v.
//
// Replaces se3_transformer_tpu/kernels/pallas_flash.py::_flash_kernel_body
// in global mode (driven by flash_global_attention -> _flash_core ->
// _flash_fwd_impl): its global branches (the payload from coordinates via
// _global_edge_payload and _radial_apply; the kv axis walked in blocks over
// all n nodes) with the dense arm of _kv_block, _init_state and
// _attend_block. As there, no per-pair tensor of any kind reaches device
// memory: activation memory is O(n), compute O(n^2).
//
// What bounds it on this card: the float32 products. Per pair and output
// degree: two trunks' 128 x 128 Dense_1 and the k and v radial products,
// 2 * 2 * 128 * IF * 16 flops (IF = 16 at d_out 0, 32 at d_out 1 for the
// assembly model): ~3.3 and ~5.5 TFLOP per launch at n = 4096. The trunk
// is float32, so each product runs as three bf16 passes over operands
// split into hi + lo (h_hi.W_hi + h_hi.W_lo + h_lo.W_hi, in that order per
// k-step): ~27 ms a request at the tensor cores' peak. Beside them, on the
// CUDA cores, both trunks' LayerNorms and exact tanh GELUs, 4 x 128 per
// pair, the basis, V2, the applies and the attention.
//
// What held the previous version back (PERF.md, section 6: timing-only
// variants of it on an H100): both products on fp32 FMAs, 65% of a
// request; behind them W2 and W3 staged per stage behind two barriers
// (14%), LN + GELU (14%) and the V2 build (14%: each V2 element rebuilt
// its pair's basis for every channel).
//
// What the design does about it:
//  * A CTA owns BN = 8 query nodes and walks the kv nodes in blocks of
//    BJ = 16: a tile of 128 pairs, two warpgroups of 64 pair rows (a warp:
//    one query node x 16 kv nodes), one CTA per SM. Widths whose V2 does
//    not fit beside the ring run a 64-pair tile of one warpgroup (BN = 4).
//    The online-softmax state lives in shared memory across the blocks.
//  * The trunk lives in registers. Dense_0, LN1 and GELU are made straight
//    in the register-A fragment layout of Dense_1 (row statistics by quad
//    shuffles), split into bf16 hi + lo; Dense_1 runs on wgmma m64n64k16
//    (two 64-column halves, h from registers); its accumulator fragments
//    take b2, LN2 and GELU in place and, split, are the A fragments of the
//    radial product (an mma's C layout is the next one's A layout). h goes
//    through no shared memory.
//  * The weights reach shared memory as one stream of 32 KB stages (a W2
//    half, or W3 for 4 consecutive i with their b3, as bf16 hi and lo
//    [128][64] tiles in wgmma's 128-byte swizzle): per tile the keys'
//    stages, then the values'. pack_stream_kernel writes the stream in
//    that layout in the launch (W2, W_k and W_v split into hi + lo there),
//    so a stage is two bulk copies, each multicast to both CTAs of a
//    cluster of two (hi from one, lo and b3 from the other): every weight
//    byte leaves L2 once per 256 pairs. A 3-stage ring of full and empty
//    mbarriers; thread 0 refills a slot, two stages ahead, once every warp
//    of both CTAs is done with it. Fetched per CTA by cp.async, without
//    the cluster, the stream cost 27% of the kernel (W from a constant
//    saved that, a deeper ring nothing); now 4%.
//  * The radial product of 4 i a stage is one m64n64k16 per k-step and
//    pass; in its C layout a thread holds the same four o columns for every
//    i, so the apply (R + b3) x V2 accumulates [2 rows][P][4] in registers
//    with no cross-thread sum. V2 for every (i, p) of the tile is built
//    once into shared memory, a thread per (pair, p) building its basis
//    values once for all channels, and serves k and v.
//  * k (then v) goes to shared memory as [pair][p][o] for the scores, the
//    online-softmax fold (a row's 16 columns on 16 lanes, max and sum by
//    shuffles) and the weighted sum. Column masks and the absolute-id self
//    mask are applied to the scores; columns past n get no weight. Pairs at
//    distance zero have a finite payload. No atomics: the same bits on
//    every run.
// Where it stands (PERF.md, section 6): ~4.7x the previous version over a
// request, 3.2x its tensor-core bound. Its variants: the products 36%, the
// trunk's two elementwise layers 23% (GELU 15%), V2 5%, the geometry and
// the tail 4% each, the weight stream 4%.
// Tried on the card: the next pass's first layer made in the shadow of the
// radial stages' wgmma (255 registers with spills, within 1% of the same
// work after the wait); a producer warp with the two warpgroups decoupled
// (per-warp release, named barriers), 4% slower, 7% with a 4-stage ring;
// the refill issued after a stage's products (one stage ahead), 22%
// slower; GELU through expf and an IEEE division, 27% slower.
// Left for later: overlapping the trunk's LayerNorms and GELUs with the
// tensor cores (registers and shared memory are spent); sharing the trunk
// across output degrees.

#include <float.h>

#include "common.cuh"

namespace {

using namespace se3;

using bf16 = __nv_bfloat16;

constexpr int BJ = 16;                // kv nodes per block
constexpr int OW = 16;                // kv_heads * dim_head
constexpr int WN = 64;                // columns of a weight stage
constexpr int IW = WN / OW;           // i values per W3 stage
constexpr int RING = 3;               // weight stages: copies issued 2 stages ahead
constexpr int CLUSTER = 2;            // CTAs that share each weight stage
constexpr size_t TILE_BYTES = (size_t)MID * WN * 2;  // one bf16 [MID][WN] tile
constexpr int NPAR = 7;               // a trunk's [MID] vectors: w1 b1 s1 o1 b2 s2 o2
constexpr int RP_STRIDE = NPAR * MID + MID * MID;  // one trunk's packed parameters
constexpr int MAX_PAIRS = 4;
constexpr int MAX_PREFIX = 4;
constexpr int MAX_HEADS = 16;
constexpr int MAX_L = 6;              // harmonics' degree
constexpr int QMAX = 7;               // input degree <= 3
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
  const float* coords;        // [B, n, 3]
  const uint8_t* nodemask;    // [B, n] or null
  const float* rp;            // [TR][RP_STRIDE]: keys' trunk, values' trunk (tied: values')
  const bf16* wpack;          // the weight stream's stages (pack_stream_kernel)
  const float* b3pack;        // [TR][NC][WN]: b3 of each W3 stage, zeros past IF
  const float* prefix[2];     // prefix_k, prefix_v [B, n, S0, H * Dh] or null
  const float* cg;            // Q_J constants, or the so2 arm's J_l and canonical blocks
  const float* shk;           // SH normalization K_lm [7 * 7]
  float* out;                 // [B, n, H, Dh]
  int n, S0, H, IF, L, exclude_self;  // L: the harmonics' (so2: the frames') degree
  float scale;
};

// A tile of 64 WG pairs: WG warpgroups, BN = 4 WG query nodes x BJ.
template <int WG>
struct GTile {
  static constexpr int NT = 128 * WG;  // threads
  static constexpr int BN = 4 * WG;    // query nodes
  static constexpr int ET = 64 * WG;   // pairs
};

// Shared memory in bytes (P, IF and the payload's S floats a pair per
// launch); the ring starts it, at 1024 bytes, as wgmma's swizzle wants.
template <int P, int WG>
struct Layout {
  static constexpr int BN = GTile<WG>::BN, ET = GTile<WG>::ET;
  static constexpr size_t STAGE = 2ull * MID * WN * sizeof(bf16);  // hi + lo tiles
  size_t b3, par, v2, kv, y, q, s, acc, m, l, alpha, dist, ok, bar, total;
  __host__ __device__ Layout(int IF, int S) {
    b3 = RING * STAGE;                          // [RING][IW][OW]
    par = b3 + 4ull * RING * WN;                // [2][NPAR][MID] trunk vectors
    v2 = par + 4ull * 2 * NPAR * MID;           // [IF][P][ET]
    kv = v2 + 4ull * IF * P * ET;               // [ET][P][OW]: the k or v tile
    y = kv + 4ull * ET * P * OW;                // [ET][S]: the harmonics (so2: the frames)
    q = y + 4ull * ET * S;                      // [BN][OW * P]
    s = q + 4ull * BN * OW * P;                 // [BN][MAX_HEADS][BJ]: scores, then weights
    acc = s + 4ull * BN * MAX_HEADS * BJ;       // [BN][OW * P]
    m = acc + 4ull * BN * OW * P;               // [BN][MAX_HEADS] running max
    l = m + 4ull * BN * MAX_HEADS;              // [BN][MAX_HEADS] running sum
    alpha = l + 4ull * BN * MAX_HEADS;          // [BN][MAX_HEADS] this block's rescale
    dist = alpha + 4ull * BN * MAX_HEADS;       // [ET]
    ok = dist + 4ull * ET;                      // [ET] ints: 1 valid, 0 masked, -1 no column
    bar = ok + 4ull * ET;                       // mbarriers: [RING] full, then [RING] empty
    total = bar + 16ull * RING;
  }
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// (x, y) as packed bf16 hi and lo halves: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Real spherical harmonics of degrees 0..L at the unit vector (x, y, z),
// m = -l..l at Y[l^2 + l + m]: the polynomial form of
// so3/spherical_harmonics.py, step for step.
__device__ void spherical_harmonics(float x, float y, float z, int L,
                                    const float* __restrict__ shk, float* Y) {
  float A[MAX_L + 1], B[MAX_L + 1], Pl[MAX_L + 1][MAX_L + 1];
  A[0] = 1.f;
  B[0] = 0.f;
  for (int m = 1; m <= L; ++m) {
    A[m] = x * A[m - 1] - y * B[m - 1];
    B[m] = x * B[m - 1] + y * A[m - 1];
  }
  float pmm = 1.f;  // (2m - 1)!!
  for (int m = 0; m <= L; ++m) {
    if (m > 0) pmm *= (float)(2 * m - 1);
    Pl[m][m] = pmm;
    if (m + 1 <= L) Pl[m + 1][m] = (float)(2 * m + 1) * pmm * z;
    for (int l = m + 2; l <= L; ++l)
      Pl[l][m] = ((float)(2 * l - 1) * z * Pl[l - 1][m] - (float)(l + m - 1) * Pl[l - 2][m]) /
                 (float)(l - m);
  }
  for (int l = 0; l <= L; ++l) {
    float* row = Y + l * l + l;
    row[0] = __ldg(shk + l * 7) * Pl[l][0];
    for (int m = 1; m <= l; ++m) {
      const float k = __ldg(shk + l * 7 + m) * Pl[l][m];
      row[-m] = k * B[m];
      row[m] = k * A[m];
    }
  }
}

// the cluster's mbarriers (sm_90; mbar_init, mbar_expect and mbar_wait are
// in common.cuh)
// one arrival on this CTA's barrier and on the same barrier of CTA `peer`
__device__ __forceinline__ void mbar_arrive_both(uint32_t bar, uint32_t peer) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(peer));
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// bytes [src, src + bytes) to shared offset dst of every CTA of the cluster,
// each CTA's barrier at offset bar counting them
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                               uint32_t bar) {
  const uint16_t mask = (1u << CLUSTER) - 1;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// The weight stream in device memory as the ring holds it: stage u of a
// tile's T = TR (2 + NC) stages is, for trunk tr = u / (2 + NC) and v = u %
// (2 + NC), W2's columns 64 v .. (v < 2) or W3 for i = IW (v - 2) .. + IW -
// 1 (zeros past IF), as a bf16 hi tile and a bf16 lo tile [MID][WN] in the
// swizzled layout (hi = bf16(w), lo = bf16(w - hi)); then b3 of every W3
// stage, [TR][NC][WN] floats. TR = 2 trunks (keys, then values: wk and bk,
// then wv and bv) or, tied, 1 (the caller passes the values' as wk and bk).
__global__ void pack_stream_kernel(const float* __restrict__ rp, const float* __restrict__ wk,
                                   const float* __restrict__ wv, const float* __restrict__ bk,
                                   const float* __restrict__ bv, bf16* __restrict__ wpack,
                                   float* __restrict__ b3pack, int IF, int NC, int TR) {
  const int HALF = 2 + NC, T = TR * HALF, chunks = T * MID * 8;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < chunks + TR * NC * WN;
       k += gridDim.x * blockDim.x) {
    if (k >= chunks) {
      const int q = k - chunks, tr = q / (NC * WN), col = q % WN;
      const int i = (q / WN - tr * NC) * IW + col / OW;
      b3pack[q] = i < IF ? __ldg((tr ? bv : bk) + i * OW + col % OW) : 0.f;
      continue;
    }
    const int u = k / (MID * 8), m = (k >> 3) & (MID - 1), ch = k & 7;
    const int tr = u / HALF, v = u - tr * HALF;
    float x[8];
    if (v < 2) {
      const float* w2 = rp + (size_t)tr * RP_STRIDE + NPAR * MID + (size_t)m * MID + v * WN + ch * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = __ldg(w2 + e);
    } else {
      const int i = (v - 2) * IW + ch / 2;
      const float* w3 = (tr ? wv : wk) + ((size_t)m * IF + i) * OW + (ch & 1) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = i < IF ? __ldg(w3 + e) : 0.f;
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(x[2 * e], x[2 * e + 1], hi[e], lo[e]);
    bf16* dst = wpack + (size_t)u * 2 * MID * WN + swz(m, ch * 8);
    *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + MID * WN) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// One m64n64k16 step of a warpgroup: d (the warp's rows 16 w + g and + 8,
// columns 8 nb + 2 t, + 1) += A (registers, mma.sync's m16n8k16 A layout)
// . B (a [16][64] slice of a swizzled ring tile).
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d = A . W over MID for one ring stage (W_hi, then W_lo MID x WN elements
// later): per k-step h_hi.W_hi, h_hi.W_lo, h_lo.W_hi, in that fixed order;
// synchronous.
__device__ __forceinline__ void stage_product(float (&d)[8][4], const uint32_t (&ahi)[8][4],
                                              const uint32_t (&alo)[8][4], const bf16* sw) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int v = 0; v < 4; ++v) d[nb][v] = 0.f;
  const uint64_t dhi = sw128_desc(sw), dlo = sw128_desc(sw + MID * WN);
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < MID / 16; ++kk) {
    const uint64_t step = kk * 16 * WN * sizeof(bf16) / 16;  // 16 rows, in 16-byte units
    wgmma_n64(d, ahi[kk], dhi + step);
    wgmma_n64(d, ahi[kk], dlo + step);
    wgmma_n64(d, alo[kk], dhi + step);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
}

// Dense_0, LN1 and GELU of the thread's rows (distances d[0], d[1]) as
// Dense_1's A fragments, split into bf16 hi + lo: fragment kk holds
// columns 16 kk + 2 t (+1) and + 8 of rows g, g + 8. par: the trunk's
// [NPAR][MID] vectors.
__device__ __forceinline__ void first_layer(uint32_t (&ahi)[8][4], uint32_t (&alo)[8][4],
                                            const float* par, const float (&d)[2], int t) {
  const float* w1 = par;
  const float* b1 = par + MID;
  const float* s1 = par + 2 * MID;
  const float* o1 = par + 3 * MID;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float u[8][2][2];  // the row's 32 columns: [kk][hc][pair of columns]
    float sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < MID / 16; ++kk)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int col = kk * 16 + hc * 8 + 2 * t;
        const float2 w = *reinterpret_cast<const float2*>(w1 + col);
        const float2 b = *reinterpret_cast<const float2*>(b1 + col);
        u[kk][hc][0] = fmaf(d[r], w.x, b.x);
        u[kk][hc][1] = fmaf(d[r], w.y, b.y);
        sum += u[kk][hc][0] + u[kk][hc][1];
      }
    const float mu = quad_sum(sum) * (1.f / MID);
    float sq = 0.f;
#pragma unroll
    for (int kk = 0; kk < MID / 16; ++kk)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          u[kk][hc][v] -= mu;
          sq += u[kk][hc][v] * u[kk][hc][v];
        }
    const float inv = 1.f / sqrtf(quad_sum(sq) * (1.f / MID) + 1e-6f);
#pragma unroll
    for (int kk = 0; kk < MID / 16; ++kk)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int col = kk * 16 + hc * 8 + 2 * t;
        const float2 s = *reinterpret_cast<const float2*>(s1 + col);
        const float2 o = *reinterpret_cast<const float2*>(o1 + col);
        split2(gelu_tanh(u[kk][hc][0] * inv * s.x + o.x),
               gelu_tanh(u[kk][hc][1] * inv * s.y + o.y), ahi[kk][r + 2 * hc],
               alo[kk][r + 2 * hc]);
      }
  }
}

// b2, LN2 and GELU on Dense_1's accumulators (c[hf]: columns 64 hf + 8 nb
// + 2 t (+1); [nb][0..1] row g, [nb][2..3] row g + 8), split into the A
// fragments of the radial product: column 64 hf + 8 nb is fragment 4 hf +
// nb / 2, half nb % 2.
__device__ __forceinline__ void second_layer(uint32_t (&ahi)[8][4], uint32_t (&alo)[8][4],
                                             float (&c)[2][8][4], const float* par, int t) {
  const float* b2 = par + 4 * MID;
  const float* s2 = par + 5 * MID;
  const float* o2 = par + 6 * MID;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 b = *reinterpret_cast<const float2*>(b2 + hf * 64 + nb * 8 + 2 * t);
      c[hf][nb][0] += b.x;
      c[hf][nb][1] += b.y;
      c[hf][nb][2] += b.x;
      c[hf][nb][3] += b.y;
      sum[0] += c[hf][nb][0] + c[hf][nb][1];
      sum[1] += c[hf][nb][2] + c[hf][nb][3];
    }
  const float mu[2] = {quad_sum(sum[0]) * (1.f / MID), quad_sum(sum[1]) * (1.f / MID)};
  float sq[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float u = c[hf][nb][v] - mu[v >> 1];
        sq[v >> 1] += u * u;
      }
  const float inv[2] = {1.f / sqrtf(quad_sum(sq[0]) * (1.f / MID) + 1e-6f),
                        1.f / sqrtf(quad_sum(sq[1]) * (1.f / MID) + 1e-6f)};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = hf * 64 + nb * 8 + 2 * t;
      const float2 s = *reinterpret_cast<const float2*>(s2 + col);
      const float2 o = *reinterpret_cast<const float2*>(o2 + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v0 = gelu_tanh((c[hf][nb][2 * r] - mu[r]) * inv[r] * s.x + o.x);
        const float v1 = gelu_tanh((c[hf][nb][2 * r + 1] - mu[r]) * inv[r] * s.y + o.y);
        split2(v0, v1, ahi[4 * hf + nb / 2][r + 2 * (nb & 1)],
               alo[4 * hf + nb / 2][r + 2 * (nb & 1)]);
      }
    }
}

// V2 of one degree pair (input degree (Q - 1) / 2, its i from off) into
// sV2 [i][p][pair]: a thread takes one (pair row, p), builds its F x Q
// basis values once from the harmonics and the pair's Q_J constants (J =
// lo + f known at compile time), or with kSo2 from the pair's frame, the
// J_l (so2c) and the pair's canonical blocks (cg; common.cuh,
// so2_basis_row), and contracts them with the C channels' x rows of the
// pair's kv node (zeros past n).
template <int P, int Q, int ET, int NT, bool kSo2>
__device__ __forceinline__ void build_v2(float* sV2, const float* sY, int S,
                                         const float* __restrict__ cg,
                                         const float* __restrict__ so2c,
                                         const float* __restrict__ x, int C, int off, int j0,
                                         int n, int b, int tid) {
  constexpr int F = P < Q ? P : Q;
  constexpr int d_in = (Q - 1) / 2, d_out = (P - 1) / 2;
  constexpr int lo = d_in > d_out ? d_in - d_out : d_out - d_in;
  for (int k = tid; k < ET * P; k += NT) {
    const int e = k % ET, p = k / ET;
    const int j = j0 + e % BJ;
    const float* y = sY + e * S;
    float bs[F][Q];
    if constexpr (kSo2) {
      so2_basis_row<P, Q>(y, S / 4, p, so2c, cg, [&](int f, int q, float v) { bs[f][q] = v; });
    } else {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int J = lo + f, M = 2 * J + 1;
      const float* qj = cg + P * Q * (J * J - lo * lo) + p * Q * M;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float v = 0.f;
#pragma unroll
        for (int m = 0; m < M; ++m) v = fmaf(y[J * J + m], __ldg(qj + q * M + m), v);
        bs[f][q] = v;
      }
    }
    }
    const float* xr = x + ((size_t)b * n + (j < n ? j : 0)) * C * Q;
    float* dst = sV2 + ((size_t)off * P + p) * ET + e;
    for (int c = 0; c < C; ++c) {
      float xv[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) xv[q] = j < n ? __ldg(xr + c * Q + q) : 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) v = fmaf(bs[f][q], xv[q], v);
        dst[(size_t)(c * F + f) * P * ET] = v;
      }
    }
  }
}

// kTie: the keys are the values (one trunk and one radial product a tile,
// the tile read as k and as v); kSo2: the so2 arm, the pairs' frames in
// place of their harmonics (a pair at distance zero takes the identity
// frame). Each a compile-time variant, so that the dense untied build is
// unchanged.
template <int P, int WG, bool kTie, bool kSo2>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(GTile<WG>::NT, 1)
flash_global_kernel(const Args a, const Pairs pairs) {
  constexpr int NT = GTile<WG>::NT, BN = GTile<WG>::BN, ET = GTile<WG>::ET;
  constexpr int TR = kTie ? 1 : 2;  // trunks (and radial products) a tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const int S = kSo2 ? 4 * (a.L + 1) : (a.L + 1) * (a.L + 1);
  const Layout<P, WG> lay(a.IF, S);
  bf16* sW = reinterpret_cast<bf16*>(smem);
  float* sB3 = reinterpret_cast<float*>(smem + lay.b3);
  float* sPar = reinterpret_cast<float*>(smem + lay.par);
  float* sV2 = reinterpret_cast<float*>(smem + lay.v2);
  float* sKV = reinterpret_cast<float*>(smem + lay.kv);
  float* sY = reinterpret_cast<float*>(smem + lay.y);
  float* sQ = reinterpret_cast<float*>(smem + lay.q);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sAcc = reinterpret_cast<float*>(smem + lay.acc);
  float* sM = reinterpret_cast<float*>(smem + lay.m);
  float* sL = reinterpret_cast<float*>(smem + lay.l);
  float* sAlpha = reinterpret_cast<float*>(smem + lay.alpha);
  float* sDist = reinterpret_cast<float*>(smem + lay.dist);
  int* sOk = reinterpret_cast<int*>(smem + lay.ok);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int e0 = warp * 16 + g;  // the thread's pair rows e0 and e0 + 8
  const int b = blockIdx.y, node0 = blockIdx.x * BN;
  const int n = a.n, S0 = a.S0, H = a.H, IF = a.IF;
  const int dim_head = OW / H, Dh = dim_head * P, HD = OW * P;

  // The weight stream: per tile T stages, the keys' trunk (W2's two
  // halves, then W3's NC chunks of IW values of i), then the values' (tied:
  // the values' alone). The
  // two CTAs of a cluster run the same stages in the same order; each
  // stage's hi tile comes from CTA 0 and its lo tile and b3 from CTA 1, one
  // bulk copy each, multicast to both.
  const int NC = (IF + IW - 1) / IW, HALF = 2 + NC, T = TR * HALF;
  const int total = ((n + BJ - 1) / BJ) * T;
  uint32_t rank;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const uint32_t full0 = smem_addr(smem + lay.bar), empty0 = full0 + 8 * RING;
  auto issue = [&](int gs) {  // by thread 0
    if (gs >= total) return;
    const int u = gs % T, slot = gs % RING, v = u % HALF;
    const uint32_t bar = full0 + 8 * slot;
    mbar_expect(bar, 2 * TILE_BYTES + (v >= 2 ? WN * 4 : 0));
    bulk_multicast(smem_addr(sW + (size_t)slot * 2 * MID * WN) + rank * TILE_BYTES,
                   a.wpack + (size_t)u * 2 * MID * WN + rank * MID * WN, TILE_BYTES, bar);
    if (v >= 2 && rank == 1)
      bulk_multicast(smem_addr(sB3 + slot * WN), a.b3pack + (size_t)((u / HALF) * NC + v - 2) * WN,
                     WN * 4, bar);
  };
  int gs = 0;  // the next stage to consume
  // Stage gs has landed and every warp is done with stage gs - 1; once both
  // CTAs are (its slot's empty barrier), stage gs + RING - 1 refills it.
  auto next_stage = [&]() -> int {
    const int slot = gs % RING;
    mbar_wait<false>(full0 + 8 * slot, (gs / RING) & 1);
    __syncthreads();
    if (tid == 0) {
      if (gs > 0) {
        const uint32_t e = empty0 + 8 * ((gs - 1) % RING);
        mbar_arrive_both(e, rank ^ 1);
        mbar_wait<true>(e, ((gs - 1) / RING) & 1);
      }
      issue(gs + RING - 1);
    }
    ++gs;
    return slot;
  };
  if (tid == 0) {
    for (int k = 0; k < RING; ++k) {
      mbar_init(full0 + 8 * k, 1);
      mbar_init(empty0 + 8 * k, CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  if (tid == 0)
    for (int k = 0; k < RING - 1; ++k) issue(k);

  // the trunks' vectors, the query rows and the state after the prefix
  // slots (_init_state)
  for (int k = tid; k < TR * NPAR * MID; k += NT) {
    const int tr = k / (NPAR * MID);
    sPar[k] = __ldg(a.rp + (size_t)tr * RP_STRIDE + (k - tr * NPAR * MID));
  }
  for (int k = tid; k < BN * HD; k += NT) {
    const int il = k / HD, node = node0 + il;
    sQ[k] = node < n ? __ldg(a.q + ((size_t)b * n + node) * HD + (k - il * HD)) : 0.f;
  }
  __syncthreads();
  for (int k = tid; k < BN * H; k += NT) {
    const int il = k / H, hd = k - il * H, node = node0 + il;
    float mx = NEG_INF;
    for (int j = 0; j < S0 && node < n; ++j) {
      const float* pk = a.prefix[0] + (((size_t)b * n + node) * S0 + j) * HD + hd * Dh;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(sQ[il * HD + hd * Dh + d], __ldg(pk + d), s);
      s *= a.scale;
      sS[(il * MAX_HEADS + hd) * BJ + j] = s;
      mx = fmaxf(mx, s);
    }
    float l = 0.f;
    for (int j = 0; j < S0 && node < n; ++j) {
      float* sp = sS + (il * MAX_HEADS + hd) * BJ + j;
      *sp = expf(*sp - mx);
      l += *sp;
    }
    sM[il * MAX_HEADS + hd] = mx;
    sL[il * MAX_HEADS + hd] = l;
  }
  __syncthreads();
  for (int k = tid; k < BN * HD; k += NT) {
    const int il = k / HD, rest = k - il * HD, hd = rest / Dh, node = node0 + il;
    float o = 0.f;
    for (int j = 0; j < S0 && node < n; ++j)
      o = fmaf(sS[(il * MAX_HEADS + hd) * BJ + j],
               __ldg(a.prefix[1] + (((size_t)b * n + node) * S0 + j) * HD + rest), o);
    sAcc[k] = o;
  }

  for (int j0 = 0; j0 < n; j0 += BJ) {
    // the pairs: distance, unit vector, harmonics (so2: frame), column mask
    // (every reader of the last tile's has passed a barrier since)
    for (int e = tid; e < ET; e += NT) {
      const int il = e / BJ, jl = e - il * BJ;
      const int i = node0 + il, j = j0 + jl;
      float rx = 0.f, ry = 0.f, rz = 0.f;
      if (i < n) {
        const float* ci = a.coords + ((size_t)b * n + i) * 3;
        rx = __ldg(ci);
        ry = __ldg(ci + 1);
        rz = __ldg(ci + 2);
      }
      if (j < n) {
        const float* cj = a.coords + ((size_t)b * n + j) * 3;
        rx -= __ldg(cj);
        ry -= __ldg(cj + 1);
        rz -= __ldg(cj + 2);
      }
      const float den = sqrtf(fmaxf(rx * rx + ry * ry + rz * rz, 1e-16f));
      sDist[e] = den;
      if constexpr (kSo2)
        so2_edge_frame(rx, ry, rz, a.L, sY + e * S);
      else
        spherical_harmonics(rx / den, ry / den, rz / den, a.L, a.shk, sY + e * S);
      int ok = -1;
      if (j < n)
        ok = (a.nodemask == nullptr || a.nodemask[(size_t)b * n + j]) &&
             !(a.exclude_self && i == j);
      sOk[e] = ok;
    }
    __syncthreads();
    // V2[i][p][pair] for every i of every degree pair (read from the first
    // radial stage on, behind its barrier)
    for (int pi = 0, off = 0; pi < pairs.count; ++pi) {
      const int C = pairs.c[pi];
      const float* cg = a.cg + pairs.cg_off[pi];
#define SE3_Q(QQ) \
  build_v2<P, QQ, ET, NT, kSo2>(sV2, sY, S, cg, a.cg, pairs.x[pi], C, off, j0, n, b, tid)
      switch (pairs.d[pi]) {
        case 0: SE3_Q(1); break;
        case 1: SE3_Q(3); break;
        case 2: SE3_Q(5); break;
        default: SE3_Q(7); break;
      }
#undef SE3_Q
      off += C * min(P, 2 * pairs.d[pi] + 1);
    }

    // the keys' pass (tr = 0), then the values' (tr = 1); tied, one pass
    for (int tr = 0; tr < TR; ++tr) {
      const float* par = sPar + tr * NPAR * MID;
      uint32_t ahi[8][4], alo[8][4];
      {
        const float d[2] = {sDist[e0], sDist[e0 + 8]};
        first_layer(ahi, alo, par, d, t);
      }
      float c[2][8][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int slot = next_stage();
        stage_product(c[hf], ahi, alo, sW + (size_t)slot * 2 * MID * WN);
      }
      second_layer(ahi, alo, c, par, t);

      // the radial product, IW values of i a stage, and its apply:
      // column 8 nb + 2 t (+1) of a stage is i = IW st + nb / 2, o = 8 (nb
      // % 2) + 2 t (+1)
      float kv[2][P][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int v = 0; v < 4; ++v) kv[r][p][v] = 0.f;
      for (int st = 0; st < NC; ++st) {
        const int slot = next_stage();
        float rr[8][4];
        stage_product(rr, ahi, alo, sW + (size_t)slot * 2 * MID * WN);
        const float* bb = sB3 + slot * WN + 2 * t;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int i = st * IW + nb / 2;
          if (i < IF) {
            const float2 b3v = *reinterpret_cast<const float2*>(bb + nb * 8);
            const float r0 = rr[nb][0] + b3v.x, r1 = rr[nb][1] + b3v.y;
            const float r2 = rr[nb][2] + b3v.x, r3 = rr[nb][3] + b3v.y;
            const float* v2 = sV2 + i * P * ET + e0;
#pragma unroll
            for (int p = 0; p < P; ++p) {
              const float v0 = v2[p * ET], v1 = v2[p * ET + 8];
              const int q4 = 2 * (nb & 1);
              kv[0][p][q4] = fmaf(v0, r0, kv[0][p][q4]);
              kv[0][p][q4 + 1] = fmaf(v0, r1, kv[0][p][q4 + 1]);
              kv[1][p][q4] = fmaf(v1, r2, kv[1][p][q4]);
              kv[1][p][q4 + 1] = fmaf(v1, r3, kv[1][p][q4 + 1]);
            }
          }
        }
      }
      // the k / v tile [pair][p][o]
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(sKV + ((e0 + 8 * r) * P + p) * OW + 8 * hh + 2 * t) =
                make_float2(kv[r][p][2 * hh], kv[r][p][2 * hh + 1]);
      __syncthreads();

      if (tr == 0) {
        // the scores and the online-softmax fold: a (node, head) row's BJ
        // columns on 16 consecutive lanes (whole warps: BN * BJ is a
        // multiple of 32), its max and sum by shuffles
        for (int k = tid; k < BN * H * BJ; k += NT) {
          const int row = k / BJ, jl = k - row * BJ, il = row / H, hd = row - il * H;
          const int e = il * BJ + jl, ok = sOk[e];
          float s = NEG_INF;
          if (ok > 0) {
            const float* qh = sQ + il * HD + hd * Dh;
            const float* kr = sKV + e * P * OW + hd * dim_head;
            s = 0.f;
            for (int dh = 0; dh < dim_head; ++dh)
              for (int p = 0; p < P; ++p) s = fmaf(qh[dh * P + p], kr[p * OW + dh], s);
            s *= a.scale;
          }
          const float m_old = sM[il * MAX_HEADS + hd];
          float mx = fmaxf(m_old, s);
#pragma unroll
          for (int o = BJ / 2; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float pw = ok >= 0 ? expf(s - mx) : 0.f;
          float l = pw;
#pragma unroll
          for (int o = BJ / 2; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
          sS[(il * MAX_HEADS + hd) * BJ + jl] = pw;
          if (jl == 0) {
            const float alpha = expf(m_old - mx);
            sM[il * MAX_HEADS + hd] = mx;
            sL[il * MAX_HEADS + hd] = sL[il * MAX_HEADS + hd] * alpha + l;
            sAlpha[il * MAX_HEADS + hd] = alpha;
          }
        }
        // (the values' first stage barrier comes before sKV is rewritten)
      }
      if (tr == TR - 1) {
        // the weighted sum (tied: of the keys' tile, once every score and
        // weight is in)
        if constexpr (kTie) __syncthreads();
        for (int k = tid; k < BN * HD; k += NT) {
          const int il = k / HD, rest = k - il * HD;
          const int hd = rest / Dh, d = rest - hd * Dh, dh = d / P, p = d - dh * P;
          const float* w = sS + (il * MAX_HEADS + hd) * BJ;
          const float* vr = sKV + (il * BJ * P + p) * OW + hd * dim_head + dh;
          float o = sAcc[k] * sAlpha[il * MAX_HEADS + hd];
          for (int jl = 0; jl < BJ; ++jl) o = fmaf(w[jl], vr[jl * P * OW], o);
          sAcc[k] = o;
        }
      }
    }
  }
  __syncthreads();
  for (int k = tid; k < BN * HD; k += NT) {
    const int il = k / HD, rest = k - il * HD, hd = rest / Dh, node = node0 + il;
    if (node < n)
      a.out[((size_t)b * n + node) * HD + rest] = sAcc[k] / sL[il * MAX_HEADS + hd];
  }
  cluster_sync();  // the peer's last arrivals on this CTA's barriers are in
}

template <int P, int WG, bool kTie, bool kSo2>
cudaError_t launch_tile(const Args& a, const Pairs& pairs, int B, size_t smem,
                        cudaStream_t stream) {
  auto kern = flash_global_kernel<P, WG, kTie, kSo2>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // a whole number of clusters: a CTA past the last query node runs the
  // stream with its partner and writes nothing
  const int ctas = (a.n + GTile<WG>::BN - 1) / GTile<WG>::BN;
  kern<<<dim3((ctas + CLUSTER - 1) / CLUSTER * CLUSTER, B), GTile<WG>::NT, smem, stream>>>(a,
                                                                                         pairs);
  return cudaGetLastError();
}

// the tile of 128 pairs where its shared memory fits, else of 64
template <int P, bool kTie, bool kSo2>
cudaError_t launch(const Args& a, const Pairs& pairs, int B, cudaStream_t stream) {
  int max_smem = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int S = kSo2 ? 4 * (a.L + 1) : (a.L + 1) * (a.L + 1);
  const size_t smem2 = Layout<P, 2>(a.IF, S).total, smem1 = Layout<P, 1>(a.IF, S).total;
  if (smem2 <= (size_t)max_smem)
    return launch_tile<P, 2, kTie, kSo2>(a, pairs, B, smem2, stream);
  if (smem1 <= (size_t)max_smem)
    return launch_tile<P, 1, kTie, kSo2>(a, pairs, B, smem1, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the launch status
// (cudaGetLastError() right after the launches); 0 is success. Pointers are
// device pointers to contiguous float32 tensors (the caller,
// kernels/flash.py, checks every shape; rp, wk, wv, bk and bv start on 16
// bytes): q [B, n, H, Dh] with H * dim_head = 16 and Dh = dim_head * P;
// x0..x3 the node features [B, n, C_k, 2 d_k + 1] of the n_pairs input
// degrees (d_k <= 3); coords [B, n, 3]; nodemask bool [B, n] or null; rp
// both trunks' packed parameters (per trunk, keys first: w1, b1, s1, o1,
// b2, s2, o2 [128] each, then w2 [128, 128] (in, out)); wk, wv [128, IF,
// 16]; bk, bv [IF, 16]; prefix_k, prefix_v [B, n, S0, H * Dh] (S0 <= 4;
// null when S0 = 0); cg the Q_J constants, pair k's from cg_off_k; shk the
// SH constants K_lm [7 * 7]; out [B, n, H, Dh]; w_split scratch of 2 (2 +
// NC) * 32768 + 2 NC * 256 bytes, NC = ceil(IF / 4), on 16 bytes (the
// weight stream, packed here); L the harmonics' degree (<= 6). tie: the
// keys are the values; rp holds the values' trunk alone, wk and bk are not
// read (null), and w_split needs half the bytes. so2: the so2 arm for keys
// and values; cg holds J_1..J_3, then pair k's canonical blocks from
// cg_off_k, shk is not read, and L is the frames' degree (every d_k and
// d_out, <= 3).
//
// The build compiles this source twice, once per arm (SE3_SO2 0 and 1), so
// that the two arms' instantiations compile in parallel: se3_flash_global
// launches the dense arm, se3_flash_global_so2 the so2 arm; each refuses
// the other's `so2`.
#ifndef SE3_SO2
#define SE3_SO2 0
#endif
#if SE3_SO2
#define SE3_FLASH_GLOBAL_ENTRY se3_flash_global_so2
#else
#define SE3_FLASH_GLOBAL_ENTRY se3_flash_global
#endif
extern "C" int SE3_FLASH_GLOBAL_ENTRY(const void* q, const void* x0, const void* x1, const void* x2,
                                const void* x3, const void* coords, const void* nodemask,
                                const void* rp, const void* wk, const void* wv, const void* bk,
                                const void* bv, const void* prefix_k, const void* prefix_v,
                                const void* cg, const void* shk, void* out, void* w_split,
                                int d0, int d1, int d2, int d3, int c0, int c1, int c2, int c3,
                                int off0, int off1, int off2, int off3, int n_pairs, int B, int n,
                                int S0, int H, int IF, int P, int L, int exclude_self, int tie,
                                int so2, float scale, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (so2 != SE3_SO2 || n_pairs < 1 || n_pairs > MAX_PAIRS || S0 < 0 || S0 > MAX_PREFIX ||
      S0 > BJ || H < 1 ||
      H > MAX_HEADS || OW % H || IF < 1 || L < 0 || L > (so2 ? (QMAX - 1) / 2 : MAX_L) ||
      (so2 && 2 * L + 1 < P))
    return (int)cudaErrorInvalidValue;
  Pairs pairs;
  const void* xs[MAX_PAIRS] = {x0, x1, x2, x3};
  const int ds[MAX_PAIRS] = {d0, d1, d2, d3}, cs[MAX_PAIRS] = {c0, c1, c2, c3};
  const int offs[MAX_PAIRS] = {off0, off1, off2, off3};
  int total_if = 0;
  for (int k = 0; k < MAX_PAIRS; ++k) {
    if (k < n_pairs) {
      if (ds[k] < 0 || 2 * ds[k] + 1 > QMAX || cs[k] < 1 || (so2 && ds[k] > L))
        return (int)cudaErrorInvalidValue;
      const int d_out = (P - 1) / 2;
      total_if += cs[k] * (2 * (ds[k] < d_out ? ds[k] : d_out) + 1);
    }
    pairs.x[k] = static_cast<const float*>(xs[k]);
    pairs.d[k] = ds[k];
    pairs.c[k] = cs[k];
    pairs.cg_off[k] = offs[k];
  }
  if (total_if != IF) return (int)cudaErrorInvalidValue;
  pairs.count = n_pairs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // both trunks' W2, W_k, W_v and b3 as the weight stream's stages (tied:
  // the values' W2, W_v and b3)
  Args a;
  const int TR = tie ? 1 : 2;
  const int NC = (IF + IW - 1) / IW, T = TR * (2 + NC);
  bf16* wpack = static_cast<bf16*>(w_split);
  float* b3pack = reinterpret_cast<float*>(wpack + (size_t)T * 2 * MID * WN);
  const int work = T * MID * 8 + TR * NC * WN;
  pack_stream_kernel<<<(work + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(rp), static_cast<const float*>(tie ? wv : wk),
      static_cast<const float*>(wv), static_cast<const float*>(tie ? bv : bk),
      static_cast<const float*>(bv), wpack, b3pack, IF, NC, TR);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  a.wpack = wpack;
  a.b3pack = b3pack;
  a.q = static_cast<const float*>(q);
  a.coords = static_cast<const float*>(coords);
  a.nodemask = static_cast<const uint8_t*>(nodemask);
  a.rp = static_cast<const float*>(rp);
  a.prefix[0] = static_cast<const float*>(prefix_k);
  a.prefix[1] = static_cast<const float*>(prefix_v);
  a.cg = static_cast<const float*>(cg);
  a.shk = static_cast<const float*>(shk);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.S0 = S0;
  a.H = H;
  a.IF = IF;
  a.L = L;
  a.exclude_self = exclude_self;
  a.scale = scale;
#define SE3_P(PP)                                                     \
  if (P == PP)                                                        \
    return (int)(tie ? launch<PP, true, SE3_SO2 != 0>(a, pairs, B, s) \
                     : launch<PP, false, SE3_SO2 != 0>(a, pairs, B, s));
  SE3_P(1) SE3_P(3) SE3_P(5) SE3_P(7)
#undef SE3_P
  return (int)cudaErrorInvalidValue;
}
