// Tile constants, mma.sync and wgmma helpers, the float32 split and the
// mbarrier and bulk-copy helpers shared by the pairwise kernels
// (pairwise_bxf.cu and pairwise_fwd.cu, the forwards; pairwise_bwd.cu,
// the backward) and the attention kernels (attention.cu, the fused
// attention; flash_fwd.cu, the streaming kNN attention; flash_global.cu,
// the global attention).
//
// They tile edges by BE = 64 and output channels by BO = 64 with
// 8 warps (4 along edges x 2 along O), and compute the radial tile
// R = h . W3[:, i, O-tile] in the mma.sync m16n8k16 accumulator layout:
// rows we*16 + {g, g+8}, columns wo*32 + nb*8 + 2t + {0, 1} for nb = 0..3
// (g = lane / 4, t = lane % 4).
//
// MID is the radial hidden width of #1, #2, #7 and 7g. Kernels #3, A and B
// (pairwise_fwd.cu, pairwise_bwd.cu, pairwise_narrow.cuh) take it as a
// template parameter KM, built for 128 and for 32 (the SE3TransformerV2
// family's trunk); the staging helpers below take KM with MID as default.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace se3 {

constexpr int MID = 128;       // radial hidden width (K of the product)
constexpr int MID32 = 32;      // the narrow trunk of #3, A and B (V2's mid_dim)
constexpr int BE = 64;         // edges per CTA (M tile)
constexpr int BO = 64;         // output channels per CTA (N tile)
constexpr int NTHREADS = 256;  // 8 warps: 4 along edges x 2 along O

template <typename T, int KM = MID> struct Tile;
template <int KM> struct Tile<__nv_bfloat16, KM> {
  static constexpr int HS = KM + 8;  // h row stride: conflict-free ldmatrix
  static constexpr int WS = BO + 8;  // W row stride: conflict-free ldmatrix
};
template <int KM> struct Tile<float, KM> {
  static constexpr int HS = KM + 4;
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
// two 8x8 tiles (lanes 0-15 give the rows): one 8-column block's mma.sync
// B fragment, from [n][k] rows (x2) or from [k][n] rows (x2_trans)
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// Stage W3[:, i, o0:o0+BO] as a [KM][BO] row-major tile (16-byte cp.async).
template <typename T, int KM = MID>
__device__ __forceinline__ void load_w(T* sw, const T* __restrict__ w3, int i,
                                       int CF, int O, int o0, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = BO / VEC;
  for (int idx = tid; idx < KM * CHUNKS; idx += NTHREADS) {
    const int m = idx / CHUNKS, ch = idx % CHUNKS;
    cp_async16(sw + m * Tile<T>::WS + ch * VEC,
               w3 + ((size_t)m * CF + i) * O + o0 + ch * VEC);
  }
}

// Stage the CTA's h rows [BE][KM] (zeros past E) with 16-byte cp.async.
template <typename T, int KM = MID>
__device__ __forceinline__ void load_h(T* sh, const T* __restrict__ h, int e0,
                                       int rows, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = KM / VEC;
  for (int idx = tid; idx < BE * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS, ch = idx % CHUNKS;
    T* dst = sh + r * Tile<T, KM>::HS + ch * VEC;
    if (r < rows)
      cp_async16(dst, h + (size_t)(e0 + r) * KM + ch * VEC);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// h's A fragments of one warp (rows we*16 .. +16, all KM) from the staged tile.
template <int KM = MID>
__device__ __forceinline__ void load_afrag(uint32_t (&a)[KM / 16][4],
                                           const __nv_bfloat16* sh, int we, int lane) {
  const int j = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KM / 16; ++kk)
    ldmatrix_x4(a[kk], sh + (we * 16 + (j & 1) * 8 + rr) * Tile<__nv_bfloat16, KM>::HS +
                           kk * 16 + (j >> 1) * 8);
}

// element (r, c) of a swizzled [rows][BO] bf16 tile: the 16-byte chunk
// c / 8 of row r sits at chunk (c / 8) ^ (r % 8), so ldmatrix and 16-byte
// stores hit 8 distinct chunks of any 8 rows with no padding
__device__ __forceinline__ int swz(int r, int c) {
  return r * BO + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// The pieces of the basis-fused tile that kernels #1/#2 (pairwise_bxf.cu)
// and #7 (flash_fwd.cu) share: 64 edge rows x 64 output channels, 8 warps,
// h's A fragments in registers, the radial tile R in mma.sync's
// accumulator layout (#1 computes it on mma.sync, #7 on wgmma), the
// [edge, P, O] accumulator in registers, V2 stored [edge][i][p] with p
// padded to PP.

// h's A fragments (mma.sync m16n8k16 row-major A: rows e_lo, e_hi of the
// warp, columns kk*16 + 2t (+1) and + 8) straight from device memory; a
// null row is zeros. float32 h is split into bf16 hi (ahi) and lo (alo).
// KM: the row's width.
template <typename T, int KM = MID>
__device__ __forceinline__ void load_afrag_global(uint32_t (&ahi)[KM / 16][4],
                                                  uint32_t (&alo)[sizeof(T) == 4 ? KM / 16 : 1][4],
                                                  const T* row_lo, const T* row_hi, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const T* row = half ? row_hi : row_lo;
#pragma unroll
    for (int kk = 0; kk < KM / 16; ++kk)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int col = kk * 16 + hc * 8 + 2 * t;
        uint32_t& dh = ahi[kk][half + 2 * hc];
        if constexpr (sizeof(T) == 4) {
          const float2 v = row ? __ldg(reinterpret_cast<const float2*>(row + col))
                               : make_float2(0.f, 0.f);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v.x, v.y);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(v.x - __low2float(hi), v.y - __high2float(hi));
          dh = *reinterpret_cast<const uint32_t*>(&hi);
          alo[kk][half + 2 * hc] = *reinterpret_cast<const uint32_t*>(&lo);
        } else {
          dh = row ? __ldg(reinterpret_cast<const uint32_t*>(row + col)) : 0u;
        }
      }
  }
}

// The epilogue of one i: acc[p] += V2[e, p, i] * (R + b3) on the
// accumulator registers. svl is V2 row e_lo at this i (PP values; row e_hi
// sits 8 rows of RS floats below), sbb b3[i] at the thread's columns.
template <int P, int PP, int RS>
__device__ __forceinline__ void apply_v2(float (&acc)[P][4][4], const float (&r)[4][4],
                                         const float* svl, const float* sbb) {
  float vl[PP], vh[PP];
  const float* svh = svl + 8 * RS;
  if constexpr (PP == 1) {
    vl[0] = svl[0];
    vh[0] = svh[0];
  } else {
#pragma unroll
    for (int u = 0; u < PP / 4; ++u) {
      const float4 a = *reinterpret_cast<const float4*>(svl + 4 * u);
      const float4 b = *reinterpret_cast<const float4*>(svh + 4 * u);
      vl[4 * u] = a.x, vl[4 * u + 1] = a.y, vl[4 * u + 2] = a.z, vl[4 * u + 3] = a.w;
      vh[4 * u] = b.x, vh[4 * u + 1] = b.y, vh[4 * u + 2] = b.z, vh[4 * u + 3] = b.w;
    }
  }
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const float2 bb = *reinterpret_cast<const float2*>(sbb + nb * 8);
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
}

// A staged value as float32: float itself, or a bf16 (the conv_bf16
// storage of the equivariant operands) upcast exactly.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// V2 of one stage of GC channels into sV, as [row][cc * F + f][p] (row
// stride RS): thread (row tid / 4, tid % 4) takes every 4th (p, f), reads
// its Q basis values once (sB row stride PFQ: (p, f, q)-ordered, or (p, q,
// f) with kPQF) and contracts them with the GC staged x rows (sX row
// stride XS, a row's GC Q values contiguous). TS is the staged basis' and
// x's type: float, or bf16 (conv_bf16), upcast here where V2 is built.
template <int P, int Q, int GC, int PP, int RS, int XS, int PFQ, bool kPQF,
          typename TS = float>
__device__ __forceinline__ void build_v2(float* sV, const TS* sX, const TS* sB, int tid) {
  constexpr int F = P < Q ? P : Q;
  const int r = tid >> 2;
  const TS* xr = sX + r * XS;
  float xv[GC][Q];
#pragma unroll
  for (int cc = 0; cc < GC; ++cc)
#pragma unroll
    for (int q = 0; q < Q; ++q) xv[cc][q] = to_float(xr[cc * Q + q]);
  const TS* br = sB + r * PFQ;
  float* vr = sV + r * RS;
#pragma unroll
  for (int pf = tid & 3; pf < P * F; pf += 4) {
    const int p = pf / F, f = pf - p * F;
    float b[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q)
      b[q] = to_float(kPQF ? br[(p * Q + q) * F + f] : br[pf * Q + q]);
#pragma unroll
    for (int cc = 0; cc < GC; ++cc) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) v = fmaf(b[q], xv[cc][q], v);
      vr[(cc * F + f) * PP + p] = v;
    }
  }
}

// wgmma's B operand from a [rows][64] bf16 tile whose 128-byte rows are
// swizzled as swz() lays them out: that is wgmma's 128-byte-swizzle layout
// for an MN-major B, a descriptor of the slice's start address (1024-byte
// aligned 8-row groups), 1024 bytes (8 rows) between 8-row groups, swizzle
// mode 1. A k-step of 16 rows advances it by 2048 bytes (128 units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// keeps the compiler from moving an accumulator's uses across the wgmma
// fence, commit and wait
template <int NB>
__device__ __forceinline__ void fence_acc(float (&d)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int v = 0; v < 4; ++v) asm volatile("" : "+f"(d[nb][v])::"memory");
}

// mbarriers and bulk copies (sm_90), shared by flash_global.cu's weight
// stream and attention.cu's row ring
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity; a wait
// that cannot end (a fault in the stream) traps rather than hang the card
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    if constexpr (kCluster)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 36)) __trap();
  }
}
// bytes [src, src + bytes) to this CTA's shared offset dst (both 16-byte
// aligned, bytes a multiple of 16), counted by the barrier at offset bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// orders this thread's earlier generic accesses to shared memory before
// the async proxy's later ones (a bulk copy that overwrites what was read)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The quantized-serving storage of W3 (int8, or fp8 e4m3: `Q` is int8_t or
// __nv_fp8_e4m3) upcast to bf16, which holds every value of either
// exactly: one 16-byte chunk of 16 values into two 16-byte chunks of bf16.
template <typename Q>
__device__ __forceinline__ void q16_to_bf16(const uint4 raw, uint4& lo, uint4& hi) {
  uint32_t o[8];
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t pair = (w[k / 2] >> (16 * (k % 2))) & 0xFFFFu;
    float2 f;
    if constexpr (std::is_same<Q, int8_t>::value) {
      f = make_float2((float)(int8_t)(pair & 0xFF), (float)(int8_t)(pair >> 8));
    } else {
      const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)pair, __NV_E4M3);
      f = __half22float2(__half2(hr));
    }
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    o[k] = *reinterpret_cast<const uint32_t*>(&b);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
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

// ---------------------------------------------------------------------
// The so2 arm (conv_backend='so2') of flash_fwd.cu and flash_global.cu.
//
// An edge's frame is (cos, sin)(m alpha) and (cos, sin)(m beta) for m = 0 ..
// L1 - 1, stored [cos_a | sin_a | cos_b | sin_b], L1 floats each
// (so2/frames.py::edge_frames). D_l(R_e) = Dz(alpha) J_l Dz(beta) J_l^T,
// Dz a 2x2 block over each (-m, +m) pair, J_l a constant (so2c + so2_j_off).
// The plain arm (kernels/flash.py::_kv_block) rotates x in, takes the band
// z = Kc_f xr, runs the radial product and rotates the result out. Here the
// two rotations are folded into the basis the dense arm's V2 build reads:
// the rotation out acts on p and the radial product on (c, f) -> o, so they
// commute, and
//
//   basis[p, q, f] = (D_out Kc_f D_in^T)[p, q]
//                  = rotate_out_{d_in}(Kc_f^T rotate_in_{d_out}(e_p))[q],
//
// per (edge, p): one rotation in at d_out, the band (two terms a row), and
// a rotation out at d_in per f. Everything after the basis is the dense
// arm's tile, unchanged.
// ---------------------------------------------------------------------

// offset of J_l (l = 1..3) in the so2 constants (kernels/flash.py::_J_OFFSETS)
__device__ __forceinline__ constexpr int so2_j_off(int l) { return l == 1 ? 0 : l == 2 ? 9 : 34; }

// v <- Dz_L(sign * t) v: v[q] = cos(|m| t) v[q] + sign s_q sin(|m| t)
// v[2L - q], m = q - L, s_q = +1 / 0 / -1 for m < 0 / = 0 / > 0
template <int L>
__device__ __forceinline__ void so2_dz(float (&v)[2 * L + 1], const float* cs, const float* sn,
                                       float sign) {
  float y[2 * L + 1];
#pragma unroll
  for (int q = 0; q <= 2 * L; ++q) {
    const int m = q - L, ma = m < 0 ? -m : m;
    const float s = m < 0 ? sign : (m > 0 ? -sign : 0.f);
    y[q] = cs[ma] * v[q] + s * sn[ma] * v[2 * L - q];
  }
#pragma unroll
  for (int q = 0; q <= 2 * L; ++q) v[q] = y[q];
}

// v <- J_L v, or J_L^T v with kT
template <int L, bool kT>
__device__ __forceinline__ void so2_j(float (&v)[2 * L + 1], const float* __restrict__ J) {
  constexpr int N = 2 * L + 1;
  float y[N];
#pragma unroll
  for (int p = 0; p < N; ++p) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) s = fmaf(__ldg(J + (kT ? q * N + p : p * N + q)), v[q], s);
    y[p] = s;
  }
#pragma unroll
  for (int p = 0; p < N; ++p) v[p] = y[p];
}

// v <- D_L(R_e)^T v (so2/frames.py::rotate_in): Dz(-alpha), J^T, Dz(-beta), J
template <int L>
__device__ __forceinline__ void so2_rotate_in(float (&v)[2 * L + 1], const float* fr, int L1,
                                              const float* __restrict__ so2c) {
  if constexpr (L > 0) {
    const float* J = so2c + so2_j_off(L);
    so2_dz<L>(v, fr, fr + L1, -1.f);
    so2_j<L, true>(v, J);
    so2_dz<L>(v, fr + 2 * L1, fr + 3 * L1, -1.f);
    so2_j<L, false>(v, J);
  }
}

// v <- D_L(R_e) v (so2/frames.py::rotate_out): J^T, Dz(+beta), J, Dz(+alpha)
template <int L>
__device__ __forceinline__ void so2_rotate_out(float (&v)[2 * L + 1], const float* fr, int L1,
                                               const float* __restrict__ so2c) {
  if constexpr (L > 0) {
    const float* J = so2c + so2_j_off(L);
    so2_j<L, true>(v, J);
    so2_dz<L>(v, fr + 2 * L1, fr + 3 * L1, 1.f);
    so2_j<L, false>(v, J);
    so2_dz<L>(v, fr, fr + L1, 1.f);
  }
}

// Row p of one pair's so2 basis at one edge: store(f, q, basis[p, q, f])
// for every f and q. ab: the pair's canonical blocks a [F][M + 1], then b
// [F][M + 1] (M = min(d_in, d_out); so2/canonical.py::canonical_blocks).
template <int P, int Q, typename Store>
__device__ __forceinline__ void so2_basis_row(const float* fr, int L1, int p,
                                              const float* __restrict__ so2c,
                                              const float* __restrict__ ab, Store store) {
  constexpr int DI = (Q - 1) / 2, DO = (P - 1) / 2;
  constexpr int F = P < Q ? P : Q, M = (F - 1) / 2;
  float u[P];  // row p of D_out
#pragma unroll
  for (int k = 0; k < P; ++k) u[k] = k == p ? 1.f : 0.f;
  so2_rotate_in<DO>(u, fr, L1, so2c);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float w[Q];  // Kc_f^T u: the band's two terms a row
#pragma unroll
    for (int q = 0; q < Q; ++q) w[q] = 0.f;
    const float* af = ab + f * (M + 1);
    const float* bf = ab + (F + f) * (M + 1);
    w[DI] = __ldg(af) * u[DO];
#pragma unroll
    for (int m = 1; m <= M; ++m) {
      const float am = __ldg(af + m), bm = __ldg(bf + m);
      w[DI - m] = am * u[DO - m] - bm * u[DO + m];
      w[DI + m] = am * u[DO + m] + bm * u[DO - m];
    }
    so2_rotate_out<DI>(w, fr, L1, so2c);
#pragma unroll
    for (int q = 0; q < Q; ++q) store(f, q, w[q]);
  }
}

// An edge's frame from its offset (so2/frames.py::edge_frames, float32): on
// the z axis alpha = 0, at zero length the identity rotation; sin(beta) is
// the clamped rho. L: the frame's degree (L1 = L + 1).
__device__ __forceinline__ void so2_edge_frame(float rx, float ry, float rz, int L, float* fr) {
  const float eps2 = 1e-16f;
  const float norm = sqrtf(fmaxf(rx * rx + ry * ry + rz * rz, eps2));
  const float x = rx / norm, y = ry / norm, z = rz / norm;
  const float rho_sq = x * x + y * y;
  const float rho = sqrtf(fmaxf(rho_sq, eps2));
  const bool on_axis = rho_sq <= eps2, degenerate = norm <= 1e-8f;
  const float c[2] = {on_axis ? 1.f : x / rho, degenerate ? 1.f : z};
  const float s[2] = {on_axis ? 0.f : y / rho, degenerate ? 0.f : rho};
  const int L1 = L + 1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {  // alpha, then beta
    float* cs = fr + 2 * k * L1;
    float* sn = cs + L1;
    cs[0] = 1.f;
    sn[0] = 0.f;
    for (int m = 1; m <= L; ++m) {
      cs[m] = cs[m - 1] * c[k] - sn[m - 1] * s[k];
      sn[m] = sn[m - 1] * c[k] + cs[m - 1] * s[k];
    }
  }
}

}  // namespace se3
