// Tile constants, mma.sync helpers and the float32 split shared by the
// pairwise kernels (pairwise_bxf.cu and pairwise_fwd.cu, the forwards;
// pairwise_bwd.cu, the backward).
//
// Both kernels tile edges by BE = 64 and output channels by BO = 64 with
// 8 warps (4 along edges x 2 along O), and both compute the radial tile
// R = h . W3[:, i, O-tile] in the mma.sync m16n8k16 accumulator layout:
// rows we*16 + {g, g+8}, columns wo*32 + nb*8 + 2t + {0, 1} for nb = 0..3
// (g = lane / 4, t = lane % 4).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace se3 {

constexpr int MID = 128;       // radial hidden width (K of the product)
constexpr int BE = 64;         // edges per CTA (M tile)
constexpr int BO = 64;         // output channels per CTA (N tile)
constexpr int NTHREADS = 256;  // 8 warps: 4 along edges x 2 along O

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int HS = MID + 8;  // h row stride: conflict-free ldmatrix
  static constexpr int WS = BO + 8;   // W row stride: conflict-free ldmatrix
};
template <> struct Tile<float> {
  static constexpr int HS = MID + 4;
  static constexpr int WS = BO + 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage W3[:, i, o0:o0+BO] as a [MID][BO] row-major tile (16-byte cp.async).
template <typename T>
__device__ __forceinline__ void load_w(T* sw, const T* __restrict__ w3, int i,
                                       int CF, int O, int o0, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = BO / VEC;
  for (int idx = tid; idx < MID * CHUNKS; idx += NTHREADS) {
    const int m = idx / CHUNKS, ch = idx % CHUNKS;
    cp_async16(sw + m * Tile<T>::WS + ch * VEC,
               w3 + ((size_t)m * CF + i) * O + o0 + ch * VEC);
  }
}

// Stage the CTA's h rows [BE][MID] (zeros past E) with 16-byte cp.async.
template <typename T>
__device__ __forceinline__ void load_h(T* sh, const T* __restrict__ h, int e0,
                                       int rows, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = MID / VEC;
  for (int idx = tid; idx < BE * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS, ch = idx % CHUNKS;
    T* dst = sh + r * Tile<T>::HS + ch * VEC;
    if (r < rows)
      cp_async16(dst, h + (size_t)(e0 + r) * MID + ch * VEC);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// h's A fragments of one warp (rows we*16 .. +16, all MID) from the staged tile.
__device__ __forceinline__ void load_afrag(uint32_t (&a)[MID / 16][4],
                                           const __nv_bfloat16* sh, int we, int lane) {
  const int j = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < MID / 16; ++kk)
    ldmatrix_x4(a[kk], sh + (we * 16 + (j & 1) * 8 + rr) * Tile<__nv_bfloat16>::HS +
                           kk * 16 + (j >> 1) * 8);
}

// The same tile with fp32 FMAs (float32 h/W3; no TF32), in the same layout.
__device__ __forceinline__ void radial_tile_f32(float (&r)[4][4], const float* sh,
                                                const float* sw, int e_lo, int wo,
                                                int t) {
  const float* hlo = sh + e_lo * Tile<float>::HS;
  const float* hhi = hlo + 8 * Tile<float>::HS;
  const float* wcol = sw + wo * 32 + 2 * t;
#pragma unroll 4
  for (int m = 0; m < MID; ++m) {
    const float a0 = hlo[m], a1 = hhi[m];
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

// element (r, c) of a swizzled [rows][BO] bf16 tile: the 16-byte chunk
// c / 8 of row r sits at chunk (c / 8) ^ (r % 8), so ldmatrix and 16-byte
// stores hit 8 distinct chunks of any 8 rows with no padding
__device__ __forceinline__ int swz(int r, int c) {
  return r * BO + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// float32 -> its bf16 hi and lo arrays (hi = bf16(x), lo = bf16(x - hi));
// hi + lo is within 2^-17 of x, relative. One copy per source file.
static __global__ void split_bf16_kernel(const float4* __restrict__ x, size_t n4,
                                         uint2* __restrict__ hi, uint2* __restrict__ lo) {
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < n4;
       k += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[k];
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
    hi[k] = make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                       *reinterpret_cast<const uint32_t*>(&h23));
    lo[k] = make_uint2(*reinterpret_cast<const uint32_t*>(&l01),
                       *reinterpret_cast<const uint32_t*>(&l23));
  }
}

}  // namespace se3
