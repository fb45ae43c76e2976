// Pairwise convolution with V2 given, for Hopper (sm_90a).
//
//   out[e, p, o] = sum_i V2[e, p, i] * R[e, i, o]
//   R[e, i, o]   = sum_m h[e, m] * W3[m, i, o] + b3[i, o]
//
// Replaces se3_transformer_tpu/kernels/pallas_pairwise.py::_fwd_kernel
// (driven by fused_pairwise_conv) on its floating-point path; the int8/fp8
// w3_scale epilogue is not ported. As there, R is never written to device
// memory. V2 = basis . x is built outside the kernel (an einsum), and the
// degree pairs of one output degree arrive concatenated along i, so one
// launch covers every input degree: IF = sum over d_in of C * F runs to
// 1024 at the flagship shape (C = 64, four degrees).
//
// What bounds it on this card. At the flagship shape one hidden->hidden
// ConvSE3 (four launches, IF = 256, 640, 896, 1024; E = 32768 edges,
// mid = 128, O = 64) is 1.51 TFLOP of radial product against ~1.8 GB of
// V2: compute-bound. The conservative recipe runs it in float32, on the
// CUDA cores (no TF32): 22.6 ms at 67 TFLOP/s. In bf16 the product runs on
// the tensor cores.
//
// What the design does about it:
//  * The structure of pairwise_bxf.cu: a CTA owns 64 edges x 64 output
//    channels; the [edge, P, O-tile] accumulator stays in registers over
//    its loop over i; R = h . W3[:, i, O-tile] is one bf16 mma.sync tile
//    (h's fragments loaded once) or one fp32-FMA tile, with W3 slices
//    streamed through a cp.async double buffer; the epilogue (R + b3) x V2
//    runs on the accumulator registers.
//  * V2[tile, :, i] is read from device memory in chunks of KI values of
//    i, each staged by 4-byte cp.async into a second double buffer, one
//    chunk ahead of its use.
//  * Filling the card. The recipe streams E in 8 node chunks, so a launch
//    has 4096 edges: 64 edge tiles for 132 SMs. The i range is then split
//    across grid.z (i_per_split in kernels/pairwise.py, a function of the
//    shapes): each split writes a partial [E, P, O] to a
//    workspace and fwd_reduce_kernel sums the partials in split order. No
//    atomics: the result is the same bit for bit on every run.
//  * Ragged edge tails are masked: rows past E load zeros, store nothing.
// Left for later: wgmma, TMA, a larger per-thread fp32 tile (the FMA tile
// reads shared memory once per 2.7 FMAs), a bf16 hi/lo split of the float32
// product onto the tensor cores.

#include "common.cuh"

namespace {

using namespace se3;

constexpr int KI = 16;  // i values of V2 staged per chunk

// V2[e0 .. e0+BE, :, c0 .. c0+nk] -> a [BE][P*KI + 4] float tile (the row
// stride puts the 8 rows that a warp's epilogue reads on distinct banks).
template <int P>
__device__ __forceinline__ void load_v(float* sv, const float* __restrict__ v2, int e0,
                                       int rows, int IF, int c0, int nk, int tid) {
  constexpr int VS = P * KI + 4;
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

template <typename T, int P>
__global__ void __launch_bounds__(NTHREADS, 1)
pairwise_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w3,
                    const float* __restrict__ b3, const float* __restrict__ v2,
                    float* __restrict__ out, int E, int IF, int O, int i_per_split) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int HS = Tile<T>::HS, WS = Tile<T>::WS;
  constexpr int VS = P * KI + 4;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sH = reinterpret_cast<T*>(smem);                       // [BE][HS]
  T* sW = sH + BE * HS;                                     // 2 x [MID][WS]
  float* sV = reinterpret_cast<float*>(sW + 2 * MID * WS);  // 2 x [BE][VS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we = warp & 3, wo = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int e0 = blockIdx.x * BE, o0 = blockIdx.y * BO;
  const int rows = min(BE, E - e0);
  // this split's i range; the wrapper leaves no split empty
  const int i_lo = blockIdx.z * i_per_split;
  const int n_i = min(IF, i_lo + i_per_split) - i_lo;

  // h tile, the first W3 slice and the first V2 chunk: one cp.async group
  load_h(sH, h, e0, rows, tid);
  load_w(sW, w3, i_lo, IF, O, o0, tid);
  load_v<P>(sV, v2, e0, rows, IF, i_lo, min(KI, n_i), tid);
  cp_async_commit();

  float acc[P][4][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[p][nb][v] = 0.f;

  uint32_t afrag[8][4];
  const int e_lo = we * 16 + g, e_hi = e_lo + 8;

  for (int n = 0; n < n_i; ++n) {
    const int i = i_lo + n;
    const int chunk = n / KI, k = n - chunk * KI;
    if (n + 1 < n_i) {
      // the next W3 slice and, at a chunk's first i, the next V2 chunk
      load_w(sW + ((n + 1) & 1) * MID * WS, w3, i + 1, IF, O, o0, tid);
      const int c1 = (chunk + 1) * KI;
      if (k == 0 && c1 < n_i)
        load_v<P>(sV + ((chunk + 1) & 1) * BE * VS, v2, e0, rows, IF, i_lo + c1,
                  min(KI, n_i - c1), tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const T* sw = sW + (n & 1) * MID * WS;
    float r[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) r[nb][v] = 0.f;
    if constexpr (kBf16) {
      if (n == 0) load_afrag(afrag, sH, we, lane);
      radial_tile(r, afrag, sw, wo, lane);
    } else {
      radial_tile_f32(r, sH, sw, e_lo, wo, t);
    }

    // epilogue: acc[p] += V2[e, p, i] * (R + b3)
    const float* sv = sV + (chunk & 1) * BE * VS + k;
    float vl[P], vh[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      vl[p] = sv[e_lo * VS + p * KI];
      vh[p] = sv[e_hi * VS + p * KI];
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
    __syncthreads();  // sW[n & 1] and the V2 buffers are rewritten next
  }

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

template <typename T, int P>
cudaError_t launch(const void* h, const void* w3, const void* b3, const void* v2, void* out,
                   void* work, int E, int IF, int O, int i_per_split, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(T) * (size_t)(BE * Tile<T>::HS + 2 * MID * Tile<T>::WS) +
      sizeof(float) * (size_t)(2 * BE * (P * KI + 4));
  auto kern = pairwise_fwd_kernel<T, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int splits = (IF + i_per_split - 1) / i_per_split;
  dim3 grid((E + BE - 1) / BE, O / BO, splits);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w3), static_cast<const float*>(b3),
      static_cast<const float*>(v2), static_cast<float*>(splits > 1 ? work : out), E, IF, O,
      i_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n4 = (size_t)E * P * O / 4;  // O is a multiple of 64
  size_t blocks = (n4 + NTHREADS - 1) / NTHREADS;
  if (blocks > 4096) blocks = 4096;
  fwd_reduce_kernel<<<(unsigned)blocks, NTHREADS, 0, stream>>>(
      static_cast<const float4*>(work), splits, n4, static_cast<float4*>(out));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the launch status
// (cudaGetLastError() right after the launches); 0 is success. Pointers are
// device pointers to contiguous tensors; the caller checks shapes: h [E,
// 128], w3 [128, IF, O] with O % 64 == 0, b3 [IF, O], v2 [E, P, IF] with P
// in {1, 3, 5, 7}, out [E, P, O]; h/w3 bf16 or f32, the rest f32. With
// more than one split (ceil(IF / i_per_split)) work holds that many
// [E, P, O] float partials; it is not read otherwise.
extern "C" int se3_pairwise_fwd(const void* h, const void* w3, const void* b3, const void* v2,
                                void* out, void* work, int E, int IF, int O, int P,
                                int i_per_split, int h_is_bf16, void* stream) {
  if (E <= 0) return 0;
  if (O <= 0 || O % BO != 0 || IF <= 0 || i_per_split <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SE3_F(PP)                                                                          \
  if (P == PP)                                                                             \
    return (int)(h_is_bf16 ? launch<__nv_bfloat16, PP>(h, w3, b3, v2, out, work, E, IF, O, \
                                                       i_per_split, s)                     \
                           : launch<float, PP>(h, w3, b3, v2, out, work, E, IF, O,         \
                                               i_per_split, s));
  SE3_F(1) SE3_F(3) SE3_F(5) SE3_F(7)
#undef SE3_F
  return (int)cudaErrorInvalidValue;
}
