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
// the JAX trunk.
//
// Replaces se3_transformer_tpu/kernels/pallas_flash.py::_flash_kernel_body
// in global mode (driven by flash_global_attention -> _flash_core ->
// _flash_fwd_impl): its global branches (the payload from coordinates via
// _global_edge_payload and _radial_apply; the kv axis walked in blocks over
// all n nodes) with the dense arm of _kv_block, _init_state and
// _attend_block. As there, no per-pair tensor of any kind reaches device
// memory: activation memory is O(n), compute O(n^2).
//
// What bounds it on this card: the float32 products on the CUDA cores.
// Per pair and output degree: two trunks' 128 x 128 Dense_1 (2 x 32.8 K
// flops) and the k and v radial products 2 * 2 * 128 * IF * O (O = 16;
// IF = 16 at d_out 0, 32 at d_out 1 for the assembly model: 131 K and
// 262 K flops). At n = 4096 that is ~3.3 and ~5.5 TFLOP per launch, ~131
// ms per request at 67 TFLOP/s, against under 2 MB of operands.
//
// What the design does about it:
//  * A CTA owns BN = 4 query nodes and walks the kv nodes in blocks of
//    BJ = 16: a tile of 64 pairs. The online-softmax state (running max,
//    sum and accumulator per node and head) lives in shared memory across
//    the blocks and is divided out once, at the end.
//  * Per tile the pairs' distances, unit vectors and harmonics are made by
//    one thread each; V2 for every (i, p) of the 64 pairs is built once
//    into shared memory (from the harmonics, the Q_J constants and the kv
//    nodes' x rows, read through the cache) and serves k and v alike.
//  * The trunk: Dense_0 and both LayerNorms run on register tiles of 4
//    pairs x 8 columns (row statistics by half-warp shuffles); Dense_1 is a
//    64 x 128 x 128 fp32-FMA product with W2 streamed through a cp.async
//    double buffer, and h is kept transposed, [m][pair], so that one
//    float4 load feeds 4 pairs.
//  * The radial product and its apply: four groups of 64 threads each
//    take one i at a time (W3[:, i, :] slices, 8 KB, four per cp.async
//    stage), a thread a 4-pair x 4-channel register tile; the apply (R +
//    b3) x V2 accumulates [P][4][4] in registers over the group's i, and
//    the groups' partial sums are added in group order (deterministic).
//  * Column masks and the absolute-id self mask are applied to the scores;
//    columns past n get no weight at all. Pairs at distance zero (the self
//    pair, padded nodes at the origin) have a finite payload: dist and the
//    normalization clamp at 1e-8.
// Left for later: sharing the trunk across output degrees (~12% of the
// flops), the float32 products on the tensor cores, wgmma and TMA.

#include <float.h>

#include "common.cuh"

namespace {

using namespace se3;

constexpr int BN = 4;                 // query nodes per CTA
constexpr int BJ = 16;                // kv nodes per block
constexpr int ET = BN * BJ;           // pairs per tile
constexpr int OW = 16;                // kv_heads * dim_head
constexpr int GROUPS = NTHREADS / 64; // i values in flight in the radial product
constexpr int HT = ET + 4;            // row stride of the transposed h tile
constexpr int STAGE = GROUPS * MID * OW;  // floats per cp.async stage (32 KB)
constexpr int W2_ROWS = STAGE / MID;  // Dense_1 rows per stage
constexpr int RP_STRIDE = 7 * MID + MID * MID;  // one trunk's packed parameters
constexpr int MAX_PAIRS = 4;
constexpr int MAX_PREFIX = 4;
constexpr int MAX_HEADS = 16;
constexpr int MAX_L = 6;              // harmonics' degree
constexpr int QMAX = 7;               // input degree <= 3
constexpr float NEG_INF = -FLT_MAX;
static_assert(MID % W2_ROWS == 0, "W2 streams in whole stages");

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
  const float* rp;            // [2][RP_STRIDE]: keys' trunk, values' trunk
  const float* w3[2];         // wk, wv [MID, IF, OW]
  const float* b3[2];         // bk, bv [IF, OW]
  const float* prefix[2];     // prefix_k, prefix_v [B, n, S0, H * Dh] or null
  const float* cg;            // Q_J constants
  const float* shk;           // SH normalization K_lm [7 * 7]
  float* out;                 // [B, n, H, Dh]
  int n, S0, H, IF, L, exclude_self;
  float scale;
};

// Shared-memory layout in floats (P, IF and L are per launch).
struct Layout {
  int h, w, v2, kv, y, q, s, acc, m, l, alpha, dist, ok, total;
  __host__ __device__ Layout(int P, int IF, int L) {
    const int S = (L + 1) * (L + 1);
    h = 0;                            // [MID][HT]: the trunk's activations, transposed
    w = h + MID * HT;                 // 2 stages of W3 slices or W2 rows
    v2 = w + 2 * STAGE;               // [IF][P][ET]
    kv = v2 + IF * P * ET;            // [ET][P][OW]: the k or v tile
    y = kv + ET * P * OW;             // [ET][S]: the harmonics
    q = y + ET * S;                   // [BN][OW * P]
    s = q + BN * OW * P;              // [BN][MAX_HEADS][BJ]: scores, then weights
    acc = s + BN * MAX_HEADS * BJ;    // [BN][OW * P]
    m = acc + BN * OW * P;            // [BN][MAX_HEADS] running max
    l = m + BN * MAX_HEADS;           // [BN][MAX_HEADS] running sum
    alpha = l + BN * MAX_HEADS;       // [BN][MAX_HEADS] this block's rescale
    dist = alpha + BN * MAX_HEADS;    // [ET]
    ok = dist + ET;                   // [ET] ints: 1 valid, 0 masked, -1 no column
    total = ok + ET;
  }
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
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

// LayerNorm (two-pass variance, eps 1e-6) and GELU of a [4 pairs][8 cols]
// register tile whose rows are spread over the 16 lanes of a half-warp,
// then its transposed store into sH[col][pair].
__device__ __forceinline__ void ln_gelu_store(float (&u)[4][8], const float* __restrict__ s,
                                              const float* __restrict__ o, const int (&col)[8],
                                              int eg, float* sH) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) sum += u[e][c];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mu = sum * (1.f / MID);
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float d = u[e][c] - mu;
      sq += d * d;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float inv = 1.f / sqrtf(sq * (1.f / MID) + 1e-6f);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      u[e][c] = gelu_tanh((u[e][c] - mu) * inv * __ldg(s + col[c]) + __ldg(o + col[c]));
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    *reinterpret_cast<float4*>(sH + col[c] * HT + 4 * eg) =
        make_float4(u[0][c], u[1][c], u[2][c], u[3][c]);
}

// Stage W2 rows [r0, r0 + W2_ROWS) as a [W2_ROWS][MID] tile.
__device__ __forceinline__ void stage_w2(float* sw, const float* __restrict__ w2, int r0,
                                         int tid) {
  constexpr int CH = MID / 4;
  for (int k = tid; k < W2_ROWS * CH; k += NTHREADS)
    cp_async16(sw + k * 4, w2 + (size_t)r0 * MID + k * 4);
}

// h^T [MID][pair] of the tile's pairs through trunk `tr` (0 keys, 1 values).
__device__ void trunk(const Args& a, int tr, const float* sDist, float* sH, float* sW,
                      int tid) {
  const float* rp = a.rp + (size_t)tr * RP_STRIDE;
  const float* w1 = rp;
  const float* b1 = rp + MID;
  const float* s1 = rp + 2 * MID;
  const float* o1 = rp + 3 * MID;
  const float* b2 = rp + 4 * MID;
  const float* s2 = rp + 5 * MID;
  const float* o2 = rp + 6 * MID;
  const float* w2 = rp + 7 * MID;
  stage_w2(sW, w2, 0, tid);
  cp_async_commit();

  // pairs 4eg .. 4eg+3; columns 4mg .. 4mg+3 and 64 + 4mg .. 64 + 4mg+3
  const int eg = tid >> 4, mg = tid & 15;
  int col[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) col[c] = (c < 4 ? 4 * mg : 64 + 4 * mg - 4) + c;
  float u[4][8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float d = sDist[4 * eg + e];
#pragma unroll
    for (int c = 0; c < 8; ++c) u[e][c] = d * __ldg(w1 + col[c]) + __ldg(b1 + col[c]);
  }
  ln_gelu_store(u, s1, o1, col, eg, sH);

#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < 8; ++c) u[e][c] = 0.f;
  constexpr int CHUNKS = MID / W2_ROWS;
  for (int k = 0; k < CHUNKS; ++k) {
    if (k + 1 < CHUNKS) {
      stage_w2(sW + ((k + 1) & 1) * STAGE, w2, (k + 1) * W2_ROWS, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the staged rows, and (k = 0) the Dense_0 tile
    const float* sw = sW + (k & 1) * STAGE;
#pragma unroll 4
    for (int r = 0; r < W2_ROWS; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(sH + (k * W2_ROWS + r) * HT + 4 * eg);
      const float4 wa = *reinterpret_cast<const float4*>(sw + r * MID + 4 * mg);
      const float4 wb = *reinterpret_cast<const float4*>(sw + r * MID + 64 + 4 * mg);
      const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
      const float ww[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 8; ++c) u[e][c] = fmaf(hh[e], ww[c], u[e][c]);
    }
    __syncthreads();  // the stage is restaged next; sH is rewritten below
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < 8; ++c) u[e][c] += __ldg(b2 + col[c]);
  ln_gelu_store(u, s2, o2, col, eg, sH);
  __syncthreads();
}

// Stage W3[:, i0 .. i0 + GROUPS, :] as GROUPS [MID][OW] tiles.
__device__ __forceinline__ void stage_w3(float* sw, const float* __restrict__ w3, int i0,
                                         int IF, int tid) {
  constexpr int CH = OW / 4;
  for (int k = tid; k < GROUPS * MID * CH; k += NTHREADS) {
    const int g = k / (MID * CH), rest = k - g * MID * CH;
    const int m = rest / CH, ch = rest - m * CH;
    if (i0 + g < IF)
      cp_async16(sw + (g * MID + m) * OW + ch * 4,
                 w3 + ((size_t)m * IF + i0 + g) * OW + ch * 4);
  }
}

// One radial contraction (cv = 0: keys, 1: values) of the tile's pairs into
// sKV[pair][p][o].
template <int P>
__device__ void conv_pass(const Args& a, int cv, const float* sH, const float* sV2, float* sW,
                          float* sKV, int tid) {
  const float* w3 = a.w3[cv];
  const float* b3 = a.b3[cv];
  const int IF = a.IF;
  const int g = tid >> 6, lt = tid & 63, eg = lt >> 2, og = lt & 3;
  float acc[P][4][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int o = 0; o < 4; ++o) acc[p][e][o] = 0.f;

  const int steps = (IF + GROUPS - 1) / GROUPS;
  stage_w3(sW, w3, 0, IF, tid);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      stage_w3(sW + ((st + 1) & 1) * STAGE, w3, (st + 1) * GROUPS, IF, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i = st * GROUPS + g;
    if (i < IF) {
      const float* sw = sW + (st & 1) * STAGE + g * MID * OW;
      float r[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int o = 0; o < 4; ++o) r[e][o] = 0.f;
#pragma unroll 8
      for (int m = 0; m < MID; ++m) {
        const float4 hv = *reinterpret_cast<const float4*>(sH + m * HT + 4 * eg);
        const float4 wv = *reinterpret_cast<const float4*>(sw + m * OW + 4 * og);
        const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
        const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int o = 0; o < 4; ++o) r[e][o] = fmaf(hh[e], ww[o], r[e][o]);
      }
      const float4 bb = __ldg(reinterpret_cast<const float4*>(b3 + (size_t)i * OW + 4 * og));
      const float bbs[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(sV2 + (i * P + p) * ET + 4 * eg);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int o = 0; o < 4; ++o) acc[p][e][o] = fmaf(vv[e], r[e][o] + bbs[o], acc[p][e][o]);
      }
    }
    __syncthreads();  // the stage is restaged next
  }
  // the groups' partial sums, added in group order
  for (int gg = 0; gg < GROUPS; ++gg) {
    if (g == gg) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4* dst = reinterpret_cast<float4*>(sKV + ((4 * eg + e) * P + p) * OW + 4 * og);
          float4 t = make_float4(acc[p][e][0], acc[p][e][1], acc[p][e][2], acc[p][e][3]);
          if (gg > 0) {
            const float4 prev = *dst;
            t.x += prev.x;
            t.y += prev.y;
            t.z += prev.z;
            t.w += prev.w;
          }
          *dst = t;
        }
    }
    __syncthreads();
  }
}

template <int P>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_global_kernel(const Args a, const Pairs pairs) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(P, a.IF, a.L);
  float* sH = smem + lay.h;
  float* sW = smem + lay.w;
  float* sV2 = smem + lay.v2;
  float* sKV = smem + lay.kv;
  float* sY = smem + lay.y;
  float* sQ = smem + lay.q;
  float* sS = smem + lay.s;
  float* sAcc = smem + lay.acc;
  float* sM = smem + lay.m;
  float* sL = smem + lay.l;
  float* sAlpha = smem + lay.alpha;
  float* sDist = smem + lay.dist;
  int* sOk = reinterpret_cast<int*>(smem + lay.ok);

  const int tid = threadIdx.x;
  const int b = blockIdx.y, node0 = blockIdx.x * BN;
  const int n = a.n, S0 = a.S0, H = a.H, IF = a.IF;
  const int S = (a.L + 1) * (a.L + 1);
  const int dim_head = OW / H, Dh = dim_head * P, HD = OW * P;
  const int d_out = (P - 1) / 2;

  // the query rows and the state after the prefix slots (_init_state)
  for (int k = tid; k < BN * HD; k += NTHREADS) {
    const int il = k / HD, node = node0 + il;
    sQ[k] = node < n ? __ldg(a.q + ((size_t)b * n + node) * HD + (k - il * HD)) : 0.f;
  }
  __syncthreads();
  for (int k = tid; k < BN * H; k += NTHREADS) {
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
  for (int k = tid; k < BN * HD; k += NTHREADS) {
    const int il = k / HD, rest = k - il * HD, hd = rest / Dh, node = node0 + il;
    float o = 0.f;
    for (int j = 0; j < S0 && node < n; ++j)
      o = fmaf(sS[(il * MAX_HEADS + hd) * BJ + j],
               __ldg(a.prefix[1] + (((size_t)b * n + node) * S0 + j) * HD + rest), o);
    sAcc[k] = o;
  }

  for (int j0 = 0; j0 < n; j0 += BJ) {
    __syncthreads();  // the last block's state update is done with the tile
    // the pairs: distance, unit vector, harmonics, column mask
    for (int e = tid; e < ET; e += NTHREADS) {
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
      spherical_harmonics(rx / den, ry / den, rz / den, a.L, a.shk, sY + e * S);
      int ok = -1;
      if (j < n)
        ok = (a.nodemask == nullptr || a.nodemask[(size_t)b * n + j]) &&
             !(a.exclude_self && i == j);
      sOk[e] = ok;
    }
    __syncthreads();
    // V2[i][p][pair] for every i of every degree pair
    for (int k = tid; k < IF * P * ET; k += NTHREADS) {
      const int e = k % ET, ip = k / ET, p = ip % P, i = ip / P;
      const int j = j0 + e % BJ;
      int pi = 0, off = 0;
      int C = pairs.c[0], d_in = pairs.d[0];
      int F = 2 * min(d_in, d_out) + 1;
      while (i >= off + C * F) {
        off += C * F;
        ++pi;
        C = pairs.c[pi];
        d_in = pairs.d[pi];
        F = 2 * min(d_in, d_out) + 1;
      }
      const int c = (i - off) / F, f = i - off - c * F;
      const int Q = 2 * d_in + 1, lo = d_in > d_out ? d_in - d_out : d_out - d_in;
      const int J = lo + f, M = 2 * J + 1;
      float v = 0.f;
      if (j < n) {
        const float* xr = pairs.x[pi] + (((size_t)b * n + j) * C + c) * Q;
        const float* qj = a.cg + pairs.cg_off[pi] + P * Q * (J * J - lo * lo) + p * Q * M;
        const float* y = sY + e * S + J * J;
        for (int q = 0; q < Q; ++q) {
          float bs = 0.f;
          for (int m = 0; m < M; ++m) bs = fmaf(y[m], __ldg(qj + q * M + m), bs);
          v = fmaf(bs, __ldg(xr + q), v);
        }
      }
      sV2[ip * ET + e] = v;
    }
    __syncthreads();

    // keys: the tile, then the scores and the online-softmax fold
    trunk(a, 0, sDist, sH, sW, tid);
    conv_pass<P>(a, 0, sH, sV2, sW, sKV, tid);
    for (int k = tid; k < BN * H * BJ; k += NTHREADS) {
      const int il = k / (H * BJ), rest = k - il * H * BJ;
      const int hd = rest / BJ, jl = rest - hd * BJ, e = il * BJ + jl;
      float s = NEG_INF;
      if (sOk[e] > 0) {
        const float* qh = sQ + il * HD + hd * Dh;
        const float* kr = sKV + e * P * OW + hd * dim_head;
        s = 0.f;
        for (int dh = 0; dh < dim_head; ++dh)
          for (int p = 0; p < P; ++p) s = fmaf(qh[dh * P + p], kr[p * OW + dh], s);
        s *= a.scale;
      }
      sS[(il * MAX_HEADS + hd) * BJ + jl] = s;
    }
    __syncthreads();
    for (int k = tid; k < BN * H; k += NTHREADS) {
      const int il = k / H, hd = k - il * H;
      float* row = sS + (il * MAX_HEADS + hd) * BJ;
      const int* ok = sOk + il * BJ;
      const float m_old = sM[il * MAX_HEADS + hd];
      float mx = m_old;
      for (int jl = 0; jl < BJ; ++jl) mx = fmaxf(mx, row[jl]);
      const float alpha = expf(m_old - mx);
      float l = sL[il * MAX_HEADS + hd] * alpha;
      for (int jl = 0; jl < BJ; ++jl) {
        const float p = ok[jl] >= 0 ? expf(row[jl] - mx) : 0.f;
        row[jl] = p;
        l += p;
      }
      sM[il * MAX_HEADS + hd] = mx;
      sL[il * MAX_HEADS + hd] = l;
      sAlpha[il * MAX_HEADS + hd] = alpha;
    }
    // (trunk() syncs before it overwrites anything the fold reads)

    // values: the tile, then the weighted sum
    trunk(a, 1, sDist, sH, sW, tid);
    conv_pass<P>(a, 1, sH, sV2, sW, sKV, tid);
    for (int k = tid; k < BN * HD; k += NTHREADS) {
      const int il = k / HD, rest = k - il * HD;
      const int hd = rest / Dh, d = rest - hd * Dh, dh = d / P, p = d - dh * P;
      const float* w = sS + (il * MAX_HEADS + hd) * BJ;
      const float* vr = sKV + (il * BJ * P + p) * OW + hd * dim_head + dh;
      float o = sAcc[k] * sAlpha[il * MAX_HEADS + hd];
      for (int jl = 0; jl < BJ; ++jl) o = fmaf(w[jl], vr[jl * P * OW], o);
      sAcc[k] = o;
    }
  }
  __syncthreads();
  for (int k = tid; k < BN * HD; k += NTHREADS) {
    const int il = k / HD, rest = k - il * HD, hd = rest / Dh, node = node0 + il;
    if (node < n)
      a.out[((size_t)b * n + node) * HD + rest] = sAcc[k] / sL[il * MAX_HEADS + hd];
  }
}

template <int P>
cudaError_t launch(const Args& a, const Pairs& pairs, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Layout(P, a.IF, a.L).total;
  int max_smem = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  auto kern = flash_global_kernel<P>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n + BN - 1) / BN, B);
  kern<<<grid, NTHREADS, smem, stream>>>(a, pairs);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the launch status
// (cudaGetLastError() right after the launch); 0 is success. Pointers are
// device pointers to contiguous float32 tensors (the caller,
// kernels/flash.py, checks every shape): q [B, n, H, Dh] with H * dim_head
// = 16 and Dh = dim_head * P; x0..x3 the node features [B, n, C_k, 2 d_k
// + 1] of the n_pairs input degrees (d_k <= 3); coords [B, n, 3];
// nodemask bool [B, n] or null; rp both trunks' packed parameters (per
// trunk, keys first: w1, b1, s1, o1, b2, s2, o2 [128] each, then w2 [128,
// 128] (in, out)); wk, wv [128, IF, 16]; bk, bv [IF, 16]; prefix_k,
// prefix_v [B, n, S0, H * Dh] (S0 <= 4; null when S0 = 0); cg the Q_J
// constants, pair k's from cg_off_k; shk the SH constants K_lm [7 * 7];
// out [B, n, H, Dh]; L the harmonics' degree (<= 6).
extern "C" int se3_flash_global(const void* q, const void* x0, const void* x1, const void* x2,
                                const void* x3, const void* coords, const void* nodemask,
                                const void* rp, const void* wk, const void* wv, const void* bk,
                                const void* bv, const void* prefix_k, const void* prefix_v,
                                const void* cg, const void* shk, void* out, int d0, int d1,
                                int d2, int d3, int c0, int c1, int c2, int c3, int off0,
                                int off1, int off2, int off3, int n_pairs, int B, int n, int S0,
                                int H, int IF, int P, int L, int exclude_self, float scale,
                                void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (n_pairs < 1 || n_pairs > MAX_PAIRS || S0 < 0 || S0 > MAX_PREFIX || S0 > BJ || H < 1 ||
      H > MAX_HEADS || OW % H || IF < 1 || L < 0 || L > MAX_L)
    return (int)cudaErrorInvalidValue;
  Pairs pairs;
  const void* xs[MAX_PAIRS] = {x0, x1, x2, x3};
  const int ds[MAX_PAIRS] = {d0, d1, d2, d3}, cs[MAX_PAIRS] = {c0, c1, c2, c3};
  const int offs[MAX_PAIRS] = {off0, off1, off2, off3};
  int total_if = 0;
  for (int k = 0; k < MAX_PAIRS; ++k) {
    if (k < n_pairs) {
      if (ds[k] < 0 || 2 * ds[k] + 1 > QMAX || cs[k] < 1) return (int)cudaErrorInvalidValue;
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
  Args a;
  a.q = static_cast<const float*>(q);
  a.coords = static_cast<const float*>(coords);
  a.nodemask = static_cast<const uint8_t*>(nodemask);
  a.rp = static_cast<const float*>(rp);
  a.w3[0] = static_cast<const float*>(wk);
  a.w3[1] = static_cast<const float*>(wv);
  a.b3[0] = static_cast<const float*>(bk);
  a.b3[1] = static_cast<const float*>(bv);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SE3_P(PP) \
  if (P == PP) return (int)launch<PP>(a, pairs, B, s);
  SE3_P(1) SE3_P(3) SE3_P(5) SE3_P(7)
#undef SE3_P
  return (int)cudaErrorInvalidValue;
}
