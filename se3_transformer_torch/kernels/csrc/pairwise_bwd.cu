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
// dV2 traffic: compute-bound. With bf16 h/W3 all three products run on the
// tensor cores (mma.sync m16n8k16, fp32 accumulate). The R recompute's
// products are exact. dW3 = h^T.dR and dH = dR.W3^T multiply the float32
// dR, which one bf16 pass would round to 2^-9 relative and miss the 1e-4
// tolerance; so dR is split into bf16 hi + lo (hi = bf16(dR), lo =
// bf16(dR - hi), together within 2^-17 of dR) and each product runs as two
// mma.sync passes, one per half, on exact bf16 partners. That keeps ~16
// mantissa bits at tensor-core rate. What is left on the CUDA cores is the
// P-contractions. With float32 h/W3, which are not exact in bf16, every
// product runs on fp32 FMAs (no TF32).
//
// Kernel A (grid: i-chunks of BI = 2 x edge splits).
//  * A CTA owns BI values of i and a contiguous range of 64-edge tiles.
//    Its W3[:, i, :] slices are staged once; per tile it stages h and
//    recomputes R = h . W3 + b3 in the forward's register layout, then
//    forms dV2 (a register sum over o, then across the 4 lanes and the 2
//    O-warps, in a fixed order) and dR (a sum over p) on the same
//    fragments, and keeps a per-thread column sum of dR for dB3.
//  * dR goes to shared memory (bf16 hi and lo, or float32), and dW3 +=
//    h^T . dR runs over the tile into accumulators held in registers
//    across all the CTA's tiles (bf16: a 32 x 32 mma tile per warp and i;
//    float32: an 8 x 4 FMA block per thread and i).
//  * dW3 and dB3 are sums over all E edges. The TPU kernel revisits one
//    output block along a sequential edge axis; Hopper's blocks run in no
//    order. So each edge split writes its partial [mid, IF, O] and [IF, O]
//    to a workspace, and bwd_reduce_kernel sums the partials in split
//    order: no float atomics, bit-identical from run to run.
// Kernel B (grid: 64-edge tiles x i splits).
//  * A CTA stages its g rows once, then loops over its range of i: it
//    stages V2[tile, :, i] and W3[:, i, :] (a cp.async double buffer for
//    bf16), rebuilds dR[e, i, :] in shared memory (bf16 hi + lo, or
//    float32), and adds dR . W3[:, i, :]^T into register accumulators: a
//    16 x 64 mma tile per warp for bf16, a 4 x 8 FMA block per thread for
//    float32. dH (or the split's partial) is written once; no atomics.
//  * A node chunk of the conservative recipe has 4096 edges: 64 tiles for
//    132 SMs. As in pairwise_fwd.cu, the i range is then split across
//    grid.y (i_per_split in kernels/pairwise.py) and bwd_reduce_kernel sums
//    the partial dH in split order.
// Left for later: wgmma, TMA, more than one CTA per SM, and whatever holds
// kernel A at ~5 us per 64-edge tile when its mma work is a few hundred
// cycles (prefetching the next tile's h did not move it).

#include "common.cuh"

namespace {

using namespace se3;

constexpr int BI = 2;        // i values per kernel-A CTA
constexpr int DS = BO + 4;   // row stride of a float32 dR tile (floats)
constexpr int DSB = BO + 8;  // row stride of a bf16 dR tile: conflict-free ldmatrix
// bytes of kernel A's staged dR: hi + lo bf16 halves, or float32
template <typename T>
constexpr int DR_BYTES = sizeof(T) == 2 ? 2 * BI * BE * DSB * 2 : BI * BE * DS * 4;

template <typename T, int P>
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_a_kernel(const T* __restrict__ h, const T* __restrict__ w3,
             const float* __restrict__ b3, const float* __restrict__ v2,
             const float* __restrict__ g, float* __restrict__ dv2,
             float* __restrict__ part, int E, int IF, int tiles_per_split) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int HS = Tile<T>::HS, WS = Tile<T>::WS;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sW = reinterpret_cast<T*>(smem);  // BI x [MID][WS]
  T* sH = sW + BI * MID * WS;          // [BE][HS]
  // dR of the tile: bf16 hi and lo halves BI x [BE][DSB] each, or float32
  // BI x [BE][DS]
  unsigned char* sDR = reinterpret_cast<unsigned char*>(sH + BE * HS);
  __nv_bfloat16* sDh = reinterpret_cast<__nv_bfloat16*>(sDR);
  __nv_bfloat16* sDl = sDh + BI * BE * DSB;
  float* sD = reinterpret_cast<float*>(sDR);
  float* sP = reinterpret_cast<float*>(sDR + DR_BYTES<T>);  // BI x 2 x [BE][P]
  float* sB = sP + BI * 2 * BE * P;                          // 4 x BI x [BO]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we = warp & 3, wo = warp >> 2;
  const int t = lane & 3, j = lane >> 3, rr = lane & 7;
  const int e_lo = we * 16 + (lane >> 2), e_hi = e_lo + 8;
  const int i0 = blockIdx.x * BI;
  const int nI = min(BI, IF - i0);
  const int n_tiles = (E + BE - 1) / BE;
  const int tile_lo = blockIdx.y * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);

#pragma unroll
  for (int ii = 0; ii < BI; ++ii)
    if (ii < nI) load_w(sW + ii * MID * WS, w3, i0 + ii, IF, BO, 0, tid);
  cp_async_commit();

  // dW3 accumulators, per i. bf16: the mma.sync layout of a 32 (m) x 32
  // (o) warp tile, m = (warp & 3)*32 + mt*16 + {g, g+8}, o = (warp >> 2)*32
  // + nt*8 + 2t + {0, 1} at [mt*4 + nt][..]. float32: an 8 (m) x 4 (o)
  // thread block, m = (tid >> 4)*8 + a, o = (tid & 15)*4 + c at [a][c].
  float acc[BI][8][4];
  // dB3: this thread's dR columns summed over its rows (both halves)
  float dbias[BI][4][2];
#pragma unroll
  for (int ii = 0; ii < BI; ++ii) {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[ii][a][c] = 0.f;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) dbias[ii][nb][0] = dbias[ii][nb][1] = 0.f;
  }

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int e0 = tile * BE, rows = min(BE, E - e0);
    const bool lo_ok = e_lo < rows, hi_ok = e_hi < rows;
    load_h(sH, h, e0, rows, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    uint32_t afrag[MID / 16][4];
    if constexpr (kBf16) load_afrag(afrag, sH, we, lane);

#pragma unroll
    for (int ii = 0; ii < BI; ++ii) {
      if (ii >= nI) continue;
      const int i = i0 + ii;
      const T* sw = sW + ii * MID * WS;
      float r[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int v = 0; v < 4; ++v) r[nb][v] = 0.f;
      if constexpr (kBf16)
        radial_tile(r, afrag, sw, wo, lane);
      else
        radial_tile_f32(r, sH, sw, e_lo, wo, t);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = wo * 32 + nb * 8 + 2 * t;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b3 + (size_t)i * BO + col));
        r[nb][0] += bb.x;
        r[nb][1] += bb.y;
        r[nb][2] += bb.x;
        r[nb][3] += bb.y;
      }

      float dr[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int v = 0; v < 4; ++v) dr[nb][v] = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const size_t row_lo = (size_t)(e0 + e_lo) * P + p;
        const size_t row_hi = (size_t)(e0 + e_hi) * P + p;
        const float vl = lo_ok ? __ldg(v2 + row_lo * IF + i) : 0.f;
        const float vh = hi_ok ? __ldg(v2 + row_hi * IF + i) : 0.f;
        float sl = 0.f, sh = 0.f;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int col = wo * 32 + nb * 8 + 2 * t;
          const float2 a = lo_ok ? __ldg(reinterpret_cast<const float2*>(g + row_lo * BO + col))
                                 : make_float2(0.f, 0.f);
          const float2 b = hi_ok ? __ldg(reinterpret_cast<const float2*>(g + row_hi * BO + col))
                                 : make_float2(0.f, 0.f);
          sl = fmaf(a.x, r[nb][0], fmaf(a.y, r[nb][1], sl));
          sh = fmaf(b.x, r[nb][2], fmaf(b.y, r[nb][3], sh));
          dr[nb][0] = fmaf(vl, a.x, dr[nb][0]);
          dr[nb][1] = fmaf(vl, a.y, dr[nb][1]);
          dr[nb][2] = fmaf(vh, b.x, dr[nb][2]);
          dr[nb][3] = fmaf(vh, b.y, dr[nb][3]);
        }
        // sum over the warp's 32 columns: the 4 lanes of one row
        sl += __shfl_xor_sync(0xffffffffu, sl, 1);
        sl += __shfl_xor_sync(0xffffffffu, sl, 2);
        sh += __shfl_xor_sync(0xffffffffu, sh, 1);
        sh += __shfl_xor_sync(0xffffffffu, sh, 2);
        if (t == 0) {
          sP[((ii * 2 + wo) * BE + e_lo) * P + p] = sl;
          sP[((ii * 2 + wo) * BE + e_hi) * P + p] = sh;
        }
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = wo * 32 + nb * 8 + 2 * t;
        dbias[ii][nb][0] += dr[nb][0] + dr[nb][2];
        dbias[ii][nb][1] += dr[nb][1] + dr[nb][3];
        if constexpr (kBf16) {
          __nv_bfloat16* dh_ = sDh + ii * BE * DSB;
          __nv_bfloat16* dl_ = sDl + ii * BE * DSB;
          const __nv_bfloat162 hl = __floats2bfloat162_rn(dr[nb][0], dr[nb][1]);
          const __nv_bfloat162 hh = __floats2bfloat162_rn(dr[nb][2], dr[nb][3]);
          *reinterpret_cast<__nv_bfloat162*>(dh_ + e_lo * DSB + col) = hl;
          *reinterpret_cast<__nv_bfloat162*>(dh_ + e_hi * DSB + col) = hh;
          *reinterpret_cast<__nv_bfloat162*>(dl_ + e_lo * DSB + col) = __floats2bfloat162_rn(
              dr[nb][0] - __low2float(hl), dr[nb][1] - __high2float(hl));
          *reinterpret_cast<__nv_bfloat162*>(dl_ + e_hi * DSB + col) = __floats2bfloat162_rn(
              dr[nb][2] - __low2float(hh), dr[nb][3] - __high2float(hh));
        } else {
          float* sd = sD + ii * BE * DS;
          *reinterpret_cast<float2*>(sd + e_lo * DS + col) = make_float2(dr[nb][0], dr[nb][1]);
          *reinterpret_cast<float2*>(sd + e_hi * DS + col) = make_float2(dr[nb][2], dr[nb][3]);
        }
      }
    }
    __syncthreads();

    // dV2 of the tile: the two O-halves added in a fixed order
    for (int idx = tid; idx < rows * P * nI; idx += NTHREADS) {
      const int ii = idx % nI, rest = idx / nI;
      const int p = rest % P, e = rest / P;
      dv2[((size_t)(e0 + e) * P + p) * IF + i0 + ii] =
          sP[((ii * 2 + 0) * BE + e) * P + p] + sP[((ii * 2 + 1) * BE + e) * P + p];
    }
    // dW3 += h^T . dR over the tile (rows past E are 0)
    if constexpr (kBf16) {
      // two mma.sync passes, dR's hi and lo halves: h is exact in bf16. The
      // tensor cores' fp32 accumulation is not round-to-nearest, and over a
      // chain of ~16k edges its error grew to ~5e-5 of dW3; so each tile's
      // product is accumulated in a fresh register tile and added to the
      // running sum with ordinary float32 adds.
      const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
      for (int ii = 0; ii < BI; ++ii) {
        if (ii >= nI) continue;
        float tile_acc[8][4];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) tile_acc[a][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BE / 16; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4_trans(a[mt], sH + (kk * 16 + (j >> 1) * 8 + rr) * HS + wm * 32 +
                                         mt * 16 + (j & 1) * 8);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const __nv_bfloat16* sd = (half ? sDl : sDh) + ii * BE * DSB;
#pragma unroll
            for (int nb2 = 0; nb2 < 2; ++nb2) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, sd + (kk * 16 + (j & 1) * 8 + rr) * DSB + wn * 32 +
                                       nb2 * 16 + (j >> 1) * 8);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(tile_acc[mt * 4 + nb2 * 2 + 0], a[mt], b[0], b[1]);
                mma_bf16(tile_acc[mt * 4 + nb2 * 2 + 1], a[mt], b[2], b[3]);
              }
            }
          }
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[ii][a][c] += tile_acc[a][c];
      }
    } else {
      // fp32 FMAs (float32 h; no TF32)
      const int tm = tid >> 4, to = tid & 15;
      for (int e = 0; e < BE; ++e) {
        const float* hrow = reinterpret_cast<const float*>(sH) + e * HS + tm * 8;
        const float4 h0 = *reinterpret_cast<const float4*>(hrow);
        const float4 h1 = *reinterpret_cast<const float4*>(hrow + 4);
        const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int ii = 0; ii < BI; ++ii) {
          if (ii >= nI) continue;
          const float4 d = *reinterpret_cast<const float4*>(sD + ii * BE * DS + e * DS + to * 4);
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            acc[ii][a][0] = fmaf(hv[a], d.x, acc[ii][a][0]);
            acc[ii][a][1] = fmaf(hv[a], d.y, acc[ii][a][1]);
            acc[ii][a][2] = fmaf(hv[a], d.z, acc[ii][a][2]);
            acc[ii][a][3] = fmaf(hv[a], d.w, acc[ii][a][3]);
          }
        }
      }
    }
    __syncthreads();  // sH, the dR tile and sP are rewritten by the next tile
  }
  cp_async_wait<0>();

  // dB3: over the 8 row groups of a warp (lanes that share t), then over
  // the 4 edge warps in order
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

  // this split's partial sums: [MID][IF][BO] then [IF][BO]
  float* pw = part + (size_t)blockIdx.y * ((size_t)MID * IF * BO + (size_t)IF * BO);
  for (int idx = tid; idx < nI * BO; idx += NTHREADS) {
    const int ii = idx / BO, o = idx % BO;
    pw[(size_t)MID * IF * BO + (size_t)(i0 + ii) * BO + o] =
        ((sB[(0 * BI + ii) * BO + o] + sB[(1 * BI + ii) * BO + o]) +
         sB[(2 * BI + ii) * BO + o]) + sB[(3 * BI + ii) * BO + o];
  }
#pragma unroll
  for (int ii = 0; ii < BI; ++ii) {
    if (ii >= nI) continue;
    const int i = i0 + ii;
    if constexpr (kBf16) {
      const int wm = warp & 3, wn = warp >> 2, gq = lane >> 2;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int m = wm * 32 + mt * 16 + gq, o = wn * 32 + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(pw + ((size_t)m * IF + i) * BO + o) =
              make_float2(acc[ii][mt * 4 + nt][0], acc[ii][mt * 4 + nt][1]);
          *reinterpret_cast<float2*>(pw + ((size_t)(m + 8) * IF + i) * BO + o) =
              make_float2(acc[ii][mt * 4 + nt][2], acc[ii][mt * 4 + nt][3]);
        }
    } else {
      const int tm = tid >> 4, to = tid & 15;
#pragma unroll
      for (int a = 0; a < 8; ++a)
        *reinterpret_cast<float4*>(pw + ((size_t)(tm * 8 + a) * IF + i) * BO + to * 4) =
            make_float4(acc[ii][a][0], acc[ii][a][1], acc[ii][a][2], acc[ii][a][3]);
    }
  }
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

// Kernel B for float32 W3, on fp32 FMAs: per i, dR[e, i, :] is rebuilt in
// shared memory and dR . W3[:, i, :]^T added into a 4 (e) x 8 (m) register
// block per thread.
template <int P>
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_b_f32_kernel(const float* __restrict__ w3, const float* __restrict__ v2,
                 const float* __restrict__ g, float* __restrict__ dh, int E, int IF,
                 int i_per_split) {
  constexpr int GS = P * BO + 1;  // g row stride: column reads hit 32 banks
  constexpr int WTS = MID + 4;    // W3[:, i, :]^T row stride
  constexpr int DTS = BE + 4;     // dR^T row stride

  extern __shared__ __align__(16) unsigned char smem[];
  float* sG = reinterpret_cast<float*>(smem);  // [BE][GS]
  float* sWt = sG + BE * GS;                   // [BO][WTS]
  float* sDt = sWt + BO * WTS;                 // [BO][DTS]
  float* sV = sDt + BO * DTS;                  // [P][BE]

  const int tid = threadIdx.x;
  const int te = tid & 15, tm = tid >> 4;  // dH block: e = te*4.., m = tm*8..
  const int e0 = blockIdx.x * BE, rows = min(BE, E - e0);
  const int i_lo = blockIdx.y * i_per_split, i_hi = min(IF, i_lo + i_per_split);

  for (int idx = tid; idx < BE * P * BO; idx += NTHREADS) {
    const int r = idx / (P * BO), c = idx - r * (P * BO);
    sG[r * GS + c] = r < rows ? __ldg(g + (size_t)e0 * P * BO + idx) : 0.f;
  }

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int i = i_lo; i < i_hi; ++i) {
    for (int idx = tid; idx < MID * BO; idx += NTHREADS) {
      const int m = idx / BO, o = idx - m * BO;
      sWt[o * WTS + m] = w3[((size_t)m * IF + i) * BO + o];
    }
    for (int idx = tid; idx < P * BE; idx += NTHREADS) {
      const int p = idx / BE, e = idx - p * BE;
      sV[idx] = e < rows ? __ldg(v2 + ((size_t)(e0 + e) * P + p) * IF + i) : 0.f;
    }
    __syncthreads();
    // dR[e, i, o] = sum_p V2[e, p, i] g[e, p, o], stored transposed
    for (int idx = tid; idx < BE * BO; idx += NTHREADS) {
      const int e = idx % BE, o = idx / BE;
      float d = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) d = fmaf(sV[p * BE + e], sG[e * GS + p * BO + o], d);
      sDt[o * DTS + e] = d;
    }
    __syncthreads();
    // dH[e, m] += sum_o dR[e, i, o] W3[m, i, o]
#pragma unroll 4
    for (int o = 0; o < BO; ++o) {
      const float4 d = *reinterpret_cast<const float4*>(sDt + o * DTS + te * 4);
      const float4 wa = *reinterpret_cast<const float4*>(sWt + o * WTS + tm * 8);
      const float4 wb = *reinterpret_cast<const float4*>(sWt + o * WTS + tm * 8 + 4);
      const float dv[4] = {d.x, d.y, d.z, d.w};
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(dv[r], wv[c], acc[r][c]);
    }
    __syncthreads();  // sWt, sV and sDt are rewritten for the next i
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = te * 4 + r;
    if (e >= rows) continue;
    float* dst = dh + ((size_t)blockIdx.y * E + e0 + e) * MID + tm * 8;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// Kernel B for bf16 W3: per i, dR[e, i, :] is rebuilt in float32, split
// into bf16 hi + lo halves in shared memory, and dH += dR . W3[:, i, :]^T
// runs as two mma.sync passes (W3 is exact in bf16). Warps: 4 along edges
// (16 rows each) x 2 along mid (64 columns each).
template <int P>
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_b_mma_kernel(const __nv_bfloat16* __restrict__ w3, const float* __restrict__ v2,
                 const float* __restrict__ g, float* __restrict__ dh, int E, int IF,
                 int i_per_split) {
  using T = __nv_bfloat16;
  constexpr int WS = Tile<T>::WS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sG = reinterpret_cast<float*>(smem);  // [BE][P*BO]
  T* sW = reinterpret_cast<T*>(sG + BE * P * BO);  // 2 x [MID][WS]: W3[:, i, :]
  T* sDh = sW + 2 * MID * WS;                  // [BE][DSB]: dR hi
  T* sDl = sDh + BE * DSB;                     // [BE][DSB]: dR lo
  float* sV = reinterpret_cast<float*>(sDl + BE * DSB);  // [P][BE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we = warp & 3, wn = warp >> 2;
  const int t = lane & 3, j = lane >> 3, rr = lane & 7;
  const int e0 = blockIdx.x * BE, rows = min(BE, E - e0);
  const int i_lo = blockIdx.y * i_per_split, i_hi = min(IF, i_lo + i_per_split);

  load_w(sW, w3, i_lo, IF, BO, 0, tid);
  cp_async_commit();
  for (int idx = tid; idx < BE * P * BO / 4; idx += NTHREADS) {
    const int r = idx / (P * BO / 4);
    reinterpret_cast<float4*>(sG)[idx] =
        r < rows ? __ldg(reinterpret_cast<const float4*>(g + (size_t)e0 * P * BO) + idx)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;

  for (int i = i_lo; i < i_hi; ++i) {
    for (int idx = tid; idx < P * BE; idx += NTHREADS) {
      const int p = idx / BE, e = idx - p * BE;
      sV[idx] = e < rows ? __ldg(v2 + ((size_t)(e0 + e) * P + p) * IF + i) : 0.f;
    }
    if (i + 1 < i_hi) {
      load_w(sW + ((i + 1 - i_lo) & 1) * MID * WS, w3, i + 1, IF, BO, 0, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // dR[e, i, o] = sum_p V2[e, p, i] g[e, p, o], two columns per step
    for (int idx = tid; idx < BE * BO / 2; idx += NTHREADS) {
      const int e = idx / (BO / 2), o = (idx % (BO / 2)) * 2;
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float v = sV[p * BE + e];
        const float2 gg = *reinterpret_cast<const float2*>(sG + (e * P + p) * BO + o);
        d0 = fmaf(v, gg.x, d0);
        d1 = fmaf(v, gg.y, d1);
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(d0, d1);
      *reinterpret_cast<__nv_bfloat162*>(sDh + e * DSB + o) = hi;
      *reinterpret_cast<__nv_bfloat162*>(sDl + e * DSB + o) =
          __floats2bfloat162_rn(d0 - __low2float(hi), d1 - __high2float(hi));
    }
    __syncthreads();
    const T* sw = sW + ((i - i_lo) & 1) * MID * WS;
    // one i's product in a fresh register tile, added to the running sum
    // with float32 adds (the tensor cores' accumulation is not
    // round-to-nearest; see kernel A)
    float part_acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) part_acc[nt][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BO / 16; ++kk) {
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, sDh + (we * 16 + (j & 1) * 8 + rr) * DSB + kk * 16 + (j >> 1) * 8);
      ldmatrix_x4(al, sDl + (we * 16 + (j & 1) * 8 + rr) * DSB + kk * 16 + (j >> 1) * 8);
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        uint32_t b[4];
        ldmatrix_x4(b, sw + (wn * 64 + nb2 * 16 + (j >> 1) * 8 + rr) * WS + kk * 16 +
                           (j & 1) * 8);
        mma_bf16(part_acc[nb2 * 2 + 0], ah, b[0], b[1]);
        mma_bf16(part_acc[nb2 * 2 + 0], al, b[0], b[1]);
        mma_bf16(part_acc[nb2 * 2 + 1], ah, b[2], b[3]);
        mma_bf16(part_acc[nb2 * 2 + 1], al, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[nt][v] += part_acc[nt][v];
    __syncthreads();  // sV, the dR halves and this W3 buffer are rewritten
  }

  const int e_lo = we * 16 + (lane >> 2), e_hi = e_lo + 8;
  float* dst = dh + (size_t)blockIdx.y * E * MID;  // this split's dH
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int m = wn * 64 + nt * 8 + 2 * t;
    if (e_lo < rows)
      *reinterpret_cast<float2*>(dst + (size_t)(e0 + e_lo) * MID + m) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (e_hi < rows)
      *reinterpret_cast<float2*>(dst + (size_t)(e0 + e_hi) * MID + m) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <typename T, int P>
cudaError_t launch_a(const void* h, const void* w3, const void* b3, const void* v2,
                     const void* g, void* dv2, void* work, void* dw3, void* db3, int E,
                     int IF, int splits, cudaStream_t stream) {
  constexpr size_t smem = sizeof(T) * (size_t)(BI * MID * Tile<T>::WS + BE * Tile<T>::HS) +
                          DR_BYTES<T> + sizeof(float) * (size_t)(BI * 2 * BE * P + 4 * BI * BO);
  auto kern = bwd_a_kernel<T, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (E + BE - 1) / BE;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((IF + BI - 1) / BI, splits);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w3), static_cast<const float*>(b3),
      static_cast<const float*>(v2), static_cast<const float*>(g), static_cast<float*>(dv2),
      static_cast<float*>(work), E, IF, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n_w = (size_t)MID * IF * BO, n_b = (size_t)IF * BO;
  size_t blocks = (n_w + n_b + NTHREADS - 1) / NTHREADS;
  if (blocks > 4096) blocks = 4096;
  bwd_reduce_kernel<<<(unsigned)blocks, NTHREADS, 0, stream>>>(
      static_cast<const float*>(work), splits, n_w, n_b, static_cast<float*>(dw3),
      static_cast<float*>(db3));
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_b(const void* w3, const void* v2, const void* g, void* dh, void* work,
                     int E, int IF, int i_per_split, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr size_t smem =
      kBf16 ? sizeof(float) * (size_t)(BE * P * BO + P * BE) +
                  sizeof(T) * (size_t)(2 * MID * Tile<T>::WS + 2 * BE * DSB)
            : sizeof(float) * (size_t)(BE * (P * BO + 1) + BO * (MID + 4) + BO * (BE + 4) +
                                       P * BE);
  void (*kern)(const T*, const float*, const float*, float*, int, int, int);
  if constexpr (kBf16)
    kern = bwd_b_mma_kernel<P>;
  else
    kern = bwd_b_f32_kernel<P>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int splits = (IF + i_per_split - 1) / i_per_split;
  dim3 grid((E + BE - 1) / BE, splits);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(w3), static_cast<const float*>(v2), static_cast<const float*>(g),
      static_cast<float*>(splits > 1 ? work : dh), E, IF, i_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)E * MID;
  size_t blocks = (n + NTHREADS - 1) / NTHREADS;
  if (blocks > 4096) blocks = 4096;
  bwd_reduce_kernel<<<(unsigned)blocks, NTHREADS, 0, stream>>>(
      static_cast<const float*>(work), splits, n, 0, static_cast<float*>(dh), nullptr);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch status
// (cudaGetLastError() right after its launches); 0 is success. Pointers are
// device pointers to contiguous tensors; the caller checks shapes: mid ==
// 128, O == 64, P in {1, 3, 5, 7}, h/w3 bf16 or f32, the rest f32.

// Kernel A and its reduce: dv2 [E, P, IF], dw3 [128, IF, 64], db3 [IF, 64].
// work holds splits x (128*IF*64 + IF*64) floats; every split must own at
// least one 64-edge tile.
extern "C" int se3_pairwise_bwd_a(const void* h, const void* w3, const void* b3,
                                  const void* v2, const void* g, void* dv2, void* work,
                                  void* dw3, void* db3, int E, int IF, int P, int splits,
                                  int h_is_bf16, void* stream) {
  if (E <= 0 || IF <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SE3_A(PP)                                                                         \
  if (P == PP)                                                                            \
    return (int)(h_is_bf16                                                                \
                     ? launch_a<__nv_bfloat16, PP>(h, w3, b3, v2, g, dv2, work, dw3, db3, \
                                                   E, IF, splits, s)                      \
                     : launch_a<float, PP>(h, w3, b3, v2, g, dv2, work, dw3, db3, E, IF,  \
                                           splits, s));
  SE3_A(1) SE3_A(3) SE3_A(5) SE3_A(7)
#undef SE3_A
  return (int)cudaErrorInvalidValue;
}

// Kernel B: dh [E, 128]. With more than one split (ceil(IF / i_per_split))
// work holds that many [E, 128] float partials; it is not read otherwise.
extern "C" int se3_pairwise_bwd_b(const void* w3, const void* v2, const void* g, void* dh,
                                  void* work, int E, int IF, int P, int i_per_split,
                                  int w3_is_bf16, void* stream) {
  if (E <= 0 || IF <= 0 || i_per_split <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SE3_B(PP)                                                                     \
  if (P == PP)                                                                        \
    return (int)(w3_is_bf16                                                           \
                     ? launch_b<__nv_bfloat16, PP>(w3, v2, g, dh, work, E, IF,        \
                                                   i_per_split, s)                    \
                     : launch_b<float, PP>(w3, v2, g, dh, work, E, IF, i_per_split, s));
  SE3_B(1) SE3_B(3) SE3_B(5) SE3_B(7)
#undef SE3_B
  return (int)cudaErrorInvalidValue;
}
