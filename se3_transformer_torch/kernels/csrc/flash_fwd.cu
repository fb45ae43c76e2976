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
// finite float32 minimum, slots past K with no weight at all.
//
// Replaces se3_transformer_tpu/kernels/pallas_flash.py::_flash_kernel_body
// (driven by _flash_fwd_impl) in kNN mode with the dense arm (_kv_block's
// 'dense' branch, _init_state, _attend_block). As there, the per-edge basis,
// the gathered features, k, v and the scores never reach device memory.
//
// What bounds it on this card: the radial products. Each output degree runs
// two of them (k and v) over every edge: 2 * 2 * E * mid * IF * O flops,
// ~3.0 TFLOP per attention block at the flagship (E = 32768 edges, mid 128,
// O 64, IF = 256 + 640 + 896 + 1024), against ~0.1 GB of operands. They are
// float32 (bf16-valued h times the float32 W3, as the JAX einsum promotes
// them), so they run on the CUDA cores: ~45 ms per block at 67 TFLOP/s.
//
// What the design does about it:
//  * A CTA owns 2 nodes x 32 slot rows = 64 edges and all 64 output
//    channels, the tile of kernels #1 and #3 (common.cuh): the [edge, P, O]
//    accumulator stays in registers over the loop over i, R = h . W3[:, i,
//    O] is the fp32-FMA register tile with W3 slices streamed through a
//    cp.async double buffer, and the apply (R + b3) x V2 runs on the
//    accumulator registers.
//  * The basis is rebuilt per degree pair into shared memory from the
//    CTA's SH rows (staged once) and the pair's Q_J constants (one small
//    buffer, read through the cache): only degree J's Q_J feeds f = J - lo,
//    at most P * Q * (2J+1) constants per f instead of the dense T tensor.
//    V2 for one channel c is built from it and the gathered x rows of c,
//    as kernel #1 builds it from the flat basis.
//  * The gather: every degree's node features (4 MB at n = 1024) stay in
//    L2; each CTA reads its neighbors' rows by index.
//  * k and v do not both fit in shared memory (2 x 64 x 7 x 64 floats). The
//    k pass writes its tile over the W3 / basis buffers, folds it into the
//    scores against q at once and leaves only the softmax weights
//    ([2 nodes, heads, prefix + 32 slots]); the v pass then builds v the
//    same way and folds it into the weighted sum. With K <= 32 a node's
//    slots are one block, so the online softmax reduces to one softmax
//    over the prefix slots (first) and the neighbor slots.
// Left for later: the float32 product as bf16 hi + lo mma.sync passes on
// the tensor cores (h is exact in bf16, W3 would split), wgmma and TMA.

#include <float.h>

#include "common.cuh"

namespace {

using namespace se3;

constexpr int NODES = 2;       // nodes per CTA
constexpr int SLOTS = 32;      // slot rows per node (K <= 32)
static_assert(NODES * SLOTS == BE, "a CTA's edge rows are its nodes' slots");
constexpr int MAX_PAIRS = 4;
constexpr int MAX_PREFIX = 4;
constexpr int MAX_HEADS = 8;
constexpr int MAX_S = 49;      // SH stack rows: degrees 0 .. 6
constexpr int QMAX = 7;        // input degree <= 3
constexpr int XS = 8;          // row stride of the gathered x of one channel
constexpr int AS = MAX_PREFIX + SLOTS;  // row stride of the softmax weights
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
  const float* w3[2];         // wk, wv [MID, IF, BO]
  const float* b3[2];         // bk, bv [IF, BO]
  const float* sh;            // [B, n, K, S]
  const float* prefix[2];     // prefix_k, prefix_v [B, n, S0, H * Dh] or null
  const float* cg;            // Q_J constants
  float* out;                 // [B, n, H, Dh]
  int n, K, S, S0, H, IF;
  float scale;
};

// The fp32-FMA R tile (common.cuh's radial_tile_f32) with bf16 h upcast.
__device__ __forceinline__ void radial_tile_f32_h16(float (&r)[4][4], const __nv_bfloat16* sh,
                                                    const float* sw, int e_lo, int wo, int t) {
  constexpr int HS = Tile<__nv_bfloat16>::HS;
  const __nv_bfloat16* hlo = sh + e_lo * HS;
  const __nv_bfloat16* hhi = hlo + 8 * HS;
  const float* wcol = sw + wo * 32 + 2 * t;
#pragma unroll 4
  for (int m = 0; m < MID; ++m) {
    const float a0 = __bfloat162float(hlo[m]), a1 = __bfloat162float(hhi[m]);
    const float* wrow = wcol + m * Tile<float>::WS;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const float2 w = *reinterpret_cast<const float2*>(wrow + nb * 8);
      r[nb][0] = fmaf(a0, w.x, r[nb][0]);
      r[nb][1] = fmaf(a0, w.y, r[nb][1]);
      r[nb][2] = fmaf(a1, w.x, r[nb][2]);
      r[nb][3] = fmaf(a1, w.y, r[nb][3]);
    }
  }
}

template <typename T, int P>
struct Smem {
  static constexpr int PFQ = P * P * QMAX;  // basis row, the largest pair
  static constexpr int PF = P * P;          // V2 row of one channel
  static constexpr size_t W_BYTES = 2 * MID * Tile<float>::WS * sizeof(float);
  static constexpr size_t B_BYTES = BE * PFQ * sizeof(float);
  static constexpr size_t KV_BYTES = BE * P * BO * sizeof(float);
  // the W3 double buffer and the basis tile; the k / v tile reuses them
  static constexpr size_t REGION = W_BYTES + B_BYTES > KV_BYTES ? W_BYTES + B_BYTES : KV_BYTES;
  static constexpr size_t H_OFF = REGION;
  static constexpr size_t Y_OFF = H_OFF + BE * Tile<T>::HS * sizeof(T);
  static constexpr size_t V_OFF = Y_OFF + BE * MAX_S * sizeof(float);
  static constexpr size_t X_OFF = V_OFF + BE * PF * sizeof(float);
  static constexpr size_t A_OFF = X_OFF + BE * XS * sizeof(float);
  static constexpr size_t SRC_OFF = A_OFF + NODES * MAX_HEADS * AS * sizeof(float);
  static constexpr size_t OK_OFF = SRC_OFF + BE * sizeof(int);
  static constexpr size_t BYTES = OK_OFF + BE * sizeof(int);
};

// One radial contraction (cv = 0: keys, 1: values) of the CTA's 64 edges
// into the k / v tile sKV[e][p][o] in shared memory.
template <typename T, int P>
__device__ __forceinline__ void conv_pass(const Args& a, const Pairs& pairs, int cv, int b,
                                          int node0, unsigned char* smem) {
  using S = Smem<T, P>;
  constexpr int HS = Tile<T>::HS, WS = Tile<float>::WS;
  float* sW = reinterpret_cast<float*>(smem);
  float* sB = reinterpret_cast<float*>(smem + S::W_BYTES);
  T* sH = reinterpret_cast<T*>(smem + S::H_OFF);
  const float* sY = reinterpret_cast<const float*>(smem + S::Y_OFF);
  float* sV = reinterpret_cast<float*>(smem + S::V_OFF);
  float* sX = reinterpret_cast<float*>(smem + S::X_OFF);
  const int* sSrc = reinterpret_cast<const int*>(smem + S::SRC_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we = warp & 3, wo = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int e_lo = we * 16 + g, e_hi = e_lo + 8;
  const int n = a.n, K = a.K, IF = a.IF;
  const int d_out = (P - 1) / 2;
  const T* h = static_cast<const T*>(a.h[cv]);
  const float* w3 = a.w3[cv];
  const float* b3 = a.b3[cv];

  // the edge rows' h (zeros where no edge) and the first W3 slice
  constexpr int VEC = 16 / sizeof(T), CHUNKS = MID / VEC;
  for (int k = tid; k < BE * CHUNKS; k += NTHREADS) {
    const int r = k / CHUNKS, ch = k - r * CHUNKS;
    const int node = node0 + r / SLOTS, s = r % SLOTS;
    T* dst = sH + r * HS + ch * VEC;
    if (node < n && s < K)
      cp_async16(dst, h + (((size_t)b * n + node) * K + s) * MID + ch * VEC);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  load_w(sW, w3, 0, IF, BO, 0, tid);
  cp_async_commit();

  float acc[P][4][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[p][nb][v] = 0.f;

  int i = 0;
  for (int pi = 0; pi < pairs.count; ++pi) {
    const int d_in = pairs.d[pi], C = pairs.c[pi], Q = 2 * d_in + 1;
    const int F = P < Q ? P : Q, PFQ = P * F * Q, PF = P * F;
    const int lo = d_in > d_out ? d_in - d_out : d_out - d_in;
    const float* x = pairs.x[pi];
    const float* cg = a.cg + pairs.cg_off[pi];
    // the pair's basis, (p, f, q)-ordered rows: sum over m of Y_J Q_J
    for (int k = tid; k < BE * PFQ; k += NTHREADS) {
      const int e = k / PFQ, rest = k - e * PFQ;
      const int pf = rest / Q, qq = rest - pf * Q;
      const int p = pf / F, f = pf - p * F, J = lo + f, M = 2 * J + 1;
      const float* qj = cg + P * Q * (J * J - lo * lo) + (p * Q + qq) * M;
      const float* y = sY + e * MAX_S + J * J;
      float s = 0.f;
      for (int m = 0; m < M; ++m) s = fmaf(y[m], __ldg(qj + m), s);
      sB[e * S::PFQ + rest] = s;
    }
    for (int c = 0; c < C; ++c) {
      // the neighbors' features of channel c
      for (int k = tid; k < BE * Q; k += NTHREADS) {
        const int e = k / Q, qq = k - e * Q;
        const int src = sSrc[e];
        sX[e * XS + qq] = src >= 0 ? __ldg(x + (((size_t)b * n + src) * C + c) * Q + qq) : 0.f;
      }
      __syncthreads();
      // V2[e, p, c, f] for this c
      for (int k = tid; k < BE * PF; k += NTHREADS) {
        const int e = k / PF, pf = k - e * PF;
        const float* brow = sB + e * S::PFQ + pf * Q;
        const float* xr = sX + e * XS;
        float v = 0.f;
        for (int qq = 0; qq < Q; ++qq) v = fmaf(brow[qq], xr[qq], v);
        sV[e * S::PF + pf] = v;
      }
      for (int f = 0; f < F; ++f, ++i) {
        if (i + 1 < IF) {
          load_w(sW + ((i + 1) & 1) * MID * WS, w3, i + 1, IF, BO, 0, tid);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();

        float r[4][4];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int v = 0; v < 4; ++v) r[nb][v] = 0.f;
        if constexpr (sizeof(T) == 2)
          radial_tile_f32_h16(r, sH, sW + (i & 1) * MID * WS, e_lo, wo, t);
        else
          se3::radial_tile_f32(r, sH, sW + (i & 1) * MID * WS, e_lo, wo, t);

        // epilogue: acc[p] += V2[e, p, i] * (R + b3)
        float vl[P], vh[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          vl[p] = sV[e_lo * S::PF + p * F + f];
          vh[p] = sV[e_hi * S::PF + p * F + f];
        }
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int col = wo * 32 + nb * 8 + 2 * t;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b3 + (size_t)i * BO + col));
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
        __syncthreads();  // sW[i & 1], sV, sX and sB are rewritten next
      }
    }
  }

  // the k / v tile [e][p][o] over the (now idle) W3 and basis buffers
  float* sKV = sW;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int col = wo * 32 + nb * 8 + 2 * t;
      *reinterpret_cast<float2*>(sKV + (e_lo * P + p) * BO + col) =
          make_float2(acc[p][nb][0], acc[p][nb][1]);
      *reinterpret_cast<float2*>(sKV + (e_hi * P + p) * BO + col) =
          make_float2(acc[p][nb][2], acc[p][nb][3]);
    }
  __syncthreads();
}

template <typename T, int P>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const Args a, const Pairs pairs) {
  using S = Smem<T, P>;
  extern __shared__ __align__(16) unsigned char smem[];
  const float* sKV = reinterpret_cast<const float*>(smem);
  float* sY = reinterpret_cast<float*>(smem + S::Y_OFF);
  float* sA = reinterpret_cast<float*>(smem + S::A_OFF);
  int* sSrc = reinterpret_cast<int*>(smem + S::SRC_OFF);
  int* sOk = reinterpret_cast<int*>(smem + S::OK_OFF);

  const int tid = threadIdx.x;
  const int b = blockIdx.y, node0 = blockIdx.x * NODES;
  const int n = a.n, K = a.K, S0 = a.S0, H = a.H;
  const int dim_head = BO / H, Dh = dim_head * P;

  // the edge rows: source node (-1: no edge), neighbor mask, SH rows
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

  // keys: the tile, then the scores against q (prefix slots first)
  conv_pass<T, P>(a, pairs, 0, b, node0, smem);
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

  // values: the tile, then the weighted sum
  conv_pass<T, P>(a, pairs, 1, b, node0, smem);
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

template <typename T, int P>
cudaError_t launch(const Args& a, const Pairs& pairs, int B, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, P>::BYTES;
  auto kern = flash_fwd_kernel<T, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n + NODES - 1) / NODES, B);
  kern<<<grid, NTHREADS, smem, stream>>>(a, pairs);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the launch status
// (cudaGetLastError() right after the launch); 0 is success. Pointers are
// device pointers to contiguous tensors (the caller, kernels/flash.py,
// checks every shape): q [B, n, H, Dh] with H * dim_head = 64 and Dh =
// dim_head * P; x0..x3 the node features [B, n, C_k, 2 d_k + 1] of the
// n_pairs input degrees (d_k <= 3); idx int64 [B, n, K], K <= 32; nmask
// bool [B, n, K] or null; h_v, h_k [B, n, K, 128] (bf16 when h_is_bf16, else
// float32); wv, wk [128, IF, 64]; bv, bk [IF, 64]; sh [B, n, K, S], S <= 49;
// prefix_k, prefix_v [B, n, S0, H * Dh] (S0 <= 4; null when S0 = 0); cg the
// Q_J constants, pair k's from cg_off_k; out [B, n, H, Dh].
extern "C" int se3_flash_fwd(const void* q, const void* x0, const void* x1, const void* x2,
                             const void* x3, const void* idx, const void* nmask,
                             const void* h_v, const void* h_k, const void* wv, const void* wk,
                             const void* bv, const void* bk, const void* sh,
                             const void* prefix_k, const void* prefix_v, const void* cg,
                             void* out, int d0, int d1, int d2, int d3, int c0, int c1, int c2,
                             int c3, int off0, int off1, int off2, int off3, int n_pairs, int B,
                             int n, int K, int S, int S0, int H, int IF, int P, int h_is_bf16,
                             float scale, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (n_pairs < 1 || n_pairs > MAX_PAIRS || K < 1 || K > SLOTS || S < 1 || S > MAX_S ||
      S0 < 0 || S0 > MAX_PREFIX || H < 1 || H > MAX_HEADS || BO % H || IF < 1)
    return (int)cudaErrorInvalidValue;
  Pairs pairs;
  const void* xs[MAX_PAIRS] = {x0, x1, x2, x3};
  const int ds[MAX_PAIRS] = {d0, d1, d2, d3}, cs[MAX_PAIRS] = {c0, c1, c2, c3};
  const int offs[MAX_PAIRS] = {off0, off1, off2, off3};
  for (int k = 0; k < MAX_PAIRS; ++k) {
    if (k < n_pairs && (ds[k] < 0 || 2 * ds[k] + 1 > QMAX || cs[k] < 1))
      return (int)cudaErrorInvalidValue;
    pairs.x[k] = static_cast<const float*>(xs[k]);
    pairs.d[k] = ds[k];
    pairs.c[k] = cs[k];
    pairs.cg_off[k] = offs[k];
  }
  pairs.count = n_pairs;
  Args a;
  a.q = static_cast<const float*>(q);
  a.idx = static_cast<const long long*>(idx);
  a.nmask = static_cast<const uint8_t*>(nmask);
  a.h[0] = h_k;
  a.h[1] = h_v;
  a.w3[0] = static_cast<const float*>(wk);
  a.w3[1] = static_cast<const float*>(wv);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SE3_P(PP)                                                                      \
  if (P == PP)                                                                         \
    return (int)(h_is_bf16 ? launch<__nv_bfloat16, PP>(a, pairs, B, s)                \
                           : launch<float, PP>(a, pairs, B, s));
  SE3_P(1) SE3_P(3) SE3_P(5) SE3_P(7)
#undef SE3_P
  return (int)cudaErrorInvalidValue;
}
