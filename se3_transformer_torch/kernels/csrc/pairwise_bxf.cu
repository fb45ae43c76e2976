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
// What bounds it on this card: the radial product R = h.W3 is the work.
// At the flagship shape (E = 32768 edges, mid = 128, C = O = 64) the (3,3)
// degree pair alone is 2*E*mid*(C*F)*O = 240 GFLOP against ~170 MB of
// operands (the basis and the gathered features dominate), i.e. >1000
// FLOP/byte: compute-bound on the tensor cores, far right of the ridge.
//
// What the design does about it:
//  * One CTA owns a tile of 64 edges x 64 output channels; the [edge, P,
//    O-tile] accumulator lives in registers for the whole loop over
//    i = (c, f) and is written once — no atomics, a deterministic result.
//    O is embarrassingly parallel, so wider O adds CTAs along grid.y.
//  * The radial product runs on the tensor cores: bf16 mma.sync m16n8k16
//    with fp32 accumulation (h's A fragments are loaded once per CTA and
//    stay in registers; each W3[:, i, O-tile] slice is a 128 x 64 bf16 B
//    operand streamed through a cp.async double buffer in shared memory).
//    For float32 h/W3 the same tile is computed with fp32 FMAs (no TF32).
//  * The accumulator layout of mma.sync is known, so the apply epilogue
//    (R + b3, times V2, summed into out) runs on the fragment registers
//    directly: R never leaves the registers either.
//  * V2 for one channel c (all p, f of the tile's edges) is built once per
//    c into shared memory from the CTA's basis tile (staged once) and the
//    x rows of that c, in fp32.
//  * Ragged edge tails are masked: rows past E load zeros, store nothing.
// Left for later: wgmma, TMA, warp specialisation, clusters (W3 multicast).

#include "common.cuh"

namespace {

using namespace se3;

template <typename T, int P, int Q, bool kPQF>
__global__ void __launch_bounds__(NTHREADS, 1)
pairwise_bxf_kernel(const T* __restrict__ h, const T* __restrict__ w3,
                    const float* __restrict__ b3, const float* __restrict__ basis,
                    const float* __restrict__ x, float* __restrict__ out,
                    int E, int C, int O) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int F = P < Q ? P : Q;
  constexpr int PF = P * F;
  constexpr int PFQ = PF * Q;
  constexpr int HS = Tile<T>::HS, WS = Tile<T>::WS;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sH = reinterpret_cast<T*>(smem);                     // [BE][HS]
  T* sW = sH + BE * HS;                                   // 2 x [MID][WS]
  float* sB = reinterpret_cast<float*>(sW + 2 * MID * WS);  // [BE][PFQ]
  float* sX = sB + BE * PFQ;                              // [BE][Q]
  float* sV = sX + BE * Q;                                // [BE][PF]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we = warp & 3, wo = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int e0 = blockIdx.x * BE, o0 = blockIdx.y * BO;
  const int rows = min(BE, E - e0);
  const int CF = C * F;

  // h tile (zeros past E) and the first W3 slice: one cp.async group
  load_h(sH, h, e0, rows, tid);
  load_w(sW, w3, 0, CF, O, o0, tid);
  cp_async_commit();
  // basis tile: the CTA's rows are contiguous in memory (either layout)
  for (int idx = tid; idx < BE * PFQ; idx += NTHREADS)
    sB[idx] = idx < rows * PFQ ? __ldg(basis + (size_t)e0 * PFQ + idx) : 0.f;

  float acc[P][4][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[p][nb][v] = 0.f;

  uint32_t afrag[8][4];
  const int e_lo = we * 16 + g, e_hi = e_lo + 8;

  for (int i = 0; i < CF; ++i) {
    const int c = i / F, f = i - c * F;
    if (f == 0) {
      // V2[e, p, c, f] for this c, all p and f, into sV
      for (int idx = tid; idx < BE * Q; idx += NTHREADS) {
        const int r = idx / Q, q = idx - r * Q;
        sX[idx] = r < rows ? __ldg(x + ((size_t)(e0 + r) * C + c) * Q + q) : 0.f;
      }
      __syncthreads();
      for (int idx = tid; idx < BE * PF; idx += NTHREADS) {
        const int r = idx / PF, pf = idx - r * PF;
        const float* xr = sX + r * Q;
        float v = 0.f;
        if constexpr (kPQF) {
          // B[e, p, q, f]: the q run of (p, f) has stride F
          const int p = pf / F, ff = pf - p * F;
          const float* bcol = sB + r * PFQ + p * Q * F + ff;
#pragma unroll
          for (int q = 0; q < Q; ++q) v = fmaf(bcol[q * F], xr[q], v);
        } else {
          const float* brow = sB + r * PFQ + pf * Q;
#pragma unroll
          for (int q = 0; q < Q; ++q) v = fmaf(brow[q], xr[q], v);
        }
        sV[idx] = v;
      }
    }
    if (i + 1 < CF) {
      load_w(sW + ((i + 1) & 1) * MID * WS, w3, i + 1, CF, O, o0, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const T* sw = sW + (i & 1) * MID * WS;
    float r[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) r[nb][v] = 0.f;
    if constexpr (kBf16) {
      if (i == 0) load_afrag(afrag, sH, we, lane);
      radial_tile(r, afrag, sw, wo, lane);
    } else {
      radial_tile_f32(r, sH, sw, e_lo, wo, t);
    }

    // epilogue: acc[p] += V2[e, p, i] * (R + b3)
    float vl[P], vh[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      vl[p] = sV[e_lo * PF + p * F + f];
      vh[p] = sV[e_hi * PF + p * F + f];
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
    __syncthreads();  // sW[i & 1] and sV are rewritten next
  }

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

template <typename T, int P, int Q, bool kPQF>
cudaError_t launch(const void* h, const void* w3, const void* b3, const void* basis,
                   const void* x, void* out, int E, int C, int O, cudaStream_t stream) {
  constexpr int F = P < Q ? P : Q;
  constexpr size_t smem =
      sizeof(T) * (size_t)(BE * Tile<T>::HS + 2 * MID * Tile<T>::WS) +
      sizeof(float) * (size_t)(BE * P * F * Q + BE * Q + BE * P * F);
  auto kern = pairwise_bxf_kernel<T, P, Q, kPQF>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((E + BE - 1) / BE, O / BO);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w3), static_cast<const float*>(b3),
      static_cast<const float*>(basis), static_cast<const float*>(x),
      static_cast<float*>(out), E, C, O);
  return cudaGetLastError();
}

template <typename T, bool kPQF>
cudaError_t dispatch(int P, int Q, const void* h, const void* w3, const void* b3,
                     const void* basis, const void* x, void* out, int E, int C, int O,
                     cudaStream_t s) {
#define SE3_PQ(PP, QQ) \
  if (P == PP && Q == QQ) return launch<T, PP, QQ, kPQF>(h, w3, b3, basis, x, out, E, C, O, s);
#define SE3_P(PP) SE3_PQ(PP, 1) SE3_PQ(PP, 3) SE3_PQ(PP, 5) SE3_PQ(PP, 7)
  SE3_P(1) SE3_P(3) SE3_P(5) SE3_P(7)
#undef SE3_P
#undef SE3_PQ
  return cudaErrorInvalidValue;
}

template <bool kPQF>
int entry(const void* h, const void* w3, const void* b3, const void* basis, const void* x,
          void* out, int E, int C, int O, int P, int Q, int h_is_bf16, void* stream) {
  if (E <= 0) return 0;
  if (O <= 0 || O % BO != 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      h_is_bf16 ? dispatch<__nv_bfloat16, kPQF>(P, Q, h, w3, b3, basis, x, out, E, C, O, s)
                : dispatch<float, kPQF>(P, Q, h, w3, b3, basis, x, out, E, C, O, s);
  return (int)err;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch status
// (cudaGetLastError() right after the launch); 0 is success. Pointers are
// device pointers to contiguous tensors; the caller checks shapes: mid ==
// 128, O % 64 == 0, P and Q in {1, 3, 5, 7}, h/w3 bf16 or f32, the rest f32.
// se3_pairwise_bxf takes the flat basis [E, P*F*Q] in (p, f, q) order,
// se3_pairwise_bx the structured basis [E, P, Q, F].
extern "C" int se3_pairwise_bxf(const void* h, const void* w3, const void* b3,
                                const void* basis, const void* x, void* out, int E,
                                int C, int O, int P, int Q, int h_is_bf16,
                                void* stream) {
  return entry<false>(h, w3, b3, basis, x, out, E, C, O, P, Q, h_is_bf16, stream);
}

extern "C" int se3_pairwise_bx(const void* h, const void* w3, const void* b3,
                               const void* basis, const void* x, void* out, int E,
                               int C, int O, int P, int Q, int h_is_bf16,
                               void* stream) {
  return entry<true>(h, w3, b3, basis, x, out, E, C, O, P, Q, h_is_bf16, stream);
}
