// Fused multi-degree kNN attention, forward and backward, for Hopper (sm_90a).
//
//   sim[bh, i, j] = scale * sum_d q[bh, i, d] k[bh / group, i, j, d]
//                   (masked slots: the finite float32 minimum)
//   a = softmax_j(sim),   out[bh, i, d] = sum_j a[j] v[bh / group, i, j, d]
//
// and its backward (dq, dk, dv in one pass; dk and dv summed over each kv
// head's group of query heads). Replace
// se3_transformer_tpu/kernels/pallas_attention.py::_kernel /
// _kernel_nomask (driven by _fused_attention_fwd_impl) and _bwd_kernel /
// _bwd_compute (driven by _fused_attention_bwd_impl). As there, the scores
// and the softmax never reach device memory.
//
// What bounds them on this card: device memory. Per row the forward reads
// J slots of k and v (2 * J * D floats) for ~4 * J * D flops, the
// backward reads them and writes dk and dv for ~8 * J * D: far left of
// the ridge. At the flagship (B*h = 8, n = 1024, J = 33, D = 8 .. 56) one
// attention block's forward moves ~0.28 GB, 85 us at 3.35 TB/s.
//
// What the design does about it: enough bytes in flight. A warp owns kv
// rows (bkv, i) and walks them, rows gridDim.x * warps apart, in
// persistent CTAs (as many as fit an SM: five of 8 warps at D = 8, one of
// 7 at D = 56). Its lane 0 stages each kv row whole in shared memory by
// bulk copies (cp.async.bulk on an mbarrier: the row's k and v blocks,
// each contiguous, and the q rows, for the backward also the g rows, of
// the kv head's group of query heads) through a ring of two stages, a row
// ahead, so that every SM keeps tens of KB in flight while its warps
// compute; the mask bytes of the next row are loaded into registers a row
// ahead too. The lanes then work from shared memory, the group's query
// heads in order over the one staged kv row: the scores a slot per lane
// (16-byte reads, q in registers), the softmax in registers, the weighted
// sums (and dq) split over (slot group, 4 features) so that every lane
// has work at D = 8, folded by shuffles. The widths the recipes use
// (dim_head 8 x (2d + 1): D = 8, 24, 40, 56) are compiled and staged;
// any other width, and a call that cannot be staged (16-byte misaligned
// pointers, a group past GB), takes the runtime-D instance, which reads
// device memory directly by the same arithmetic.
//
// The backward keeps the group's softmax weights and dsim in shared
// memory; each lane then sums the group's dk and dv for the same (j, 4
// features) in the same order and writes them once with 16-byte stores,
// so the group sum needs no atomics and is the same on every run.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using namespace se3;

constexpr int MAX_J = 128;   // slots a row may have (kernels/attention.py)
constexpr int MAX_D = 256;   // features a row may have
constexpr int SLOTS = MAX_J / 32;  // slots a lane holds
constexpr int MAX_WARPS = 8;
constexpr int STAGES = 2;  // ring stages of a warp
constexpr int GB = 8;      // query heads a staged kv row holds, and a pass of the backward
constexpr int SMEM_LIMIT = 220 * 1024;  // dynamic shared memory a CTA may take
constexpr int BAR_BYTES = MAX_WARPS * STAGES * 8;
constexpr float NEG_INF = -FLT_MAX;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;
  const float* g;
  float* out;  // the forward's out, the backward's dq
  float* dk;
  float* dv;
  long long rows;  // B*kv_h*n kv rows (bkv, i)
  int n, J, D, group, heads;
  float scale;
  int stage_floats;  // floats of a stage (a multiple of 32; 0: not staged)
  int warp_floats;   // floats of a warp's region: its stages, then scratch
};

// the warp's max in one redux.sync, on an order-preserving int image of
// the floats (negative ones with their magnitude bits flipped)
__device__ __forceinline__ float warp_max(float v) {
  int b = __float_as_int(v);
  b = __reduce_max_sync(FULL, b >= 0 ? b : b ^ 0x7fffffff);
  return __int_as_float(b >= 0 ? b : b ^ 0x7fffffff);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}
__device__ __forceinline__ float4 shfl_down4(const float4& x, int delta) {
  return make_float4(__shfl_down_sync(FULL, x.x, delta), __shfl_down_sync(FULL, x.y, delta),
                     __shfl_down_sync(FULL, x.z, delta), __shfl_down_sync(FULL, x.w, delta));
}

// One D-vector (q or g) that every lane dots with the slots' rows: in
// registers for a compiled D, read through its pointer for a runtime D.
template <int DC>
struct Vec {
  float4 x[DC / 4];
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int c = 0; c < DC / 4; ++c) x[c] = reinterpret_cast<const float4*>(p)[c];
  }
  __device__ __forceinline__ float dot(const float* y, int) const {
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int c = 0; c < DC / 4; ++c) {
      const float4 t = y4[c];
      s0 = fmaf(x[c].x, t.x, s0);
      s1 = fmaf(x[c].y, t.y, s1);
      s0 = fmaf(x[c].z, t.z, s0);
      s1 = fmaf(x[c].w, t.w, s1);
    }
    return s0 + s1;
  }
};
template <>
struct Vec<0> {
  const float* p;
  __device__ __forceinline__ void load(const float* src) { p = src; }
  __device__ __forceinline__ float dot(const float* y, int D) const {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(p[d], y[d], s);
    return s;
  }
};

// <x, y_j> for the lane's slots j = lane + 32 u; 0 past J
template <int DC>
__device__ __forceinline__ void slot_dots(float (&r)[SLOTS], const Vec<DC>& x, const float* y,
                                          int J, int D, int lane) {
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    r[u] = 0.f;
    if (32 * u < J && lane + 32 * u < J) r[u] = x.dot(y + (size_t)(lane + 32 * u) * D, D);
  }
}

// The mask bytes of the lane's slots j = lane + 32 u of one mask row (1
// without a mask or past J), loaded a row ahead of their use so that the
// load's latency hides behind the row before.
struct MaskRow {
  uint8_t m[SLOTS];
  __device__ __forceinline__ void load(const uint8_t* __restrict__ mr, int J, int lane) {
#pragma unroll
    for (int u = 0; u < SLOTS; ++u)
      m[u] = mr != nullptr && lane + 32 * u < J ? __ldg(mr + lane + 32 * u) : 1;
  }
};

// The row's softmax weights of the lane's slots j = lane + 32 u (0 past
// J): scores scale * <q, k_j>, masked slots at NEG_INF, then p_j =
// exp(sim_j - max) and a_j = p_j * (1 / sum p). A fully masked row is
// uniform.
template <int DC>
__device__ __forceinline__ void softmax_row(float (&a)[SLOTS], const Vec<DC>& q,
                                            const float* k, const MaskRow& mask, int J, int D,
                                            float scale, int lane) {
  slot_dots<DC>(a, q, k, J, D, lane);
  float mx = NEG_INF;
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    a[u] = lane + 32 * u < J && mask.m[u] ? a[u] * scale : NEG_INF;
    mx = fmaxf(mx, a[u]);
  }
  mx = warp_max(mx);
  float l = 0.f;
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    float p = 0.f;
    if (32 * u < J && lane + 32 * u < J) p = expf(a[u] - mx);  // the first test: warp-wide
    a[u] = p;
    l += p;
  }
  const float inv = 1.f / warp_sum(l);
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) a[u] *= inv;
}

// o = mul * sum_j w[j] x_j over the row's J slots x (out with w = a; dq
// with w = dsim, mul = scale). A compiled D splits the lanes into G slot
// groups x D/4 float4 columns (every lane busy at D = 8), each group
// summing every G-th slot, folded over the groups by shuffles.
template <int DC>
__device__ __forceinline__ void weighted_sum(const float* w, const float* x, float* o, float mul,
                                             int J, int D, int lane) {
  if constexpr (DC > 0) {
    constexpr int D4 = DC / 4, G = 32 / D4;
    const int sg = lane / D4, c = lane - sg * D4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (sg < G) {
      const float4* x4 = reinterpret_cast<const float4*>(x) + c;
#pragma unroll 4
      for (int j = sg; j < J; j += G) fma4(acc, w[j], x4[(size_t)j * D4]);
    }
#pragma unroll
    for (int off = 1; off < G; off *= 2) {
      const float4 t = shfl_down4(acc, off * D4);
      if (sg + off < G) acc = make_float4(acc.x + t.x, acc.y + t.y, acc.z + t.z, acc.w + t.w);
    }
    if (sg == 0)
      reinterpret_cast<float4*>(o)[c] =
          make_float4(mul * acc.x, mul * acc.y, mul * acc.z, mul * acc.w);
  } else {
    for (int d = lane; d < D; d += 32) {
      float s = 0.f;
      for (int j = 0; j < J; ++j) s = fmaf(w[j], x[(size_t)j * D + d], s);
      o[d] = mul * s;
    }
  }
}

// dk_j = sum_b scale dsim_b,j q_b and dv_j = sum_b a_b,j g_b over the nb
// query heads of a pass (their weights at sa / sds + b J, their q and g
// rows at qb / gb + b * stride), each lane the same (j, 4 features) of
// every pass in the same order; `add` adds to what an earlier pass wrote.
template <int DC>
__device__ __forceinline__ void store_dkdv(const float* sa, const float* sds, const float* qb,
                                           const float* gb, size_t stride, int nb, float* dk,
                                           float* dv, bool add, int J, int D, float scale,
                                           int lane) {
  if constexpr (DC > 0) {
    constexpr int D4 = DC / 4;
    float4* dk4 = reinterpret_cast<float4*>(dk);
    float4* dv4 = reinterpret_cast<float4*>(dv);
    for (int e = lane; e < J * D4; e += 32) {
      const int j = e / D4, c = e - j * D4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (add) kk = dk4[e], vv = dv4[e];
      for (int b = 0; b < nb; ++b) {
        fma4(kk, scale * sds[b * J + j], reinterpret_cast<const float4*>(qb + b * stride)[c]);
        fma4(vv, sa[b * J + j], reinterpret_cast<const float4*>(gb + b * stride)[c]);
      }
      dk4[e] = kk;
      dv4[e] = vv;
    }
  } else {
    for (int e = lane; e < J * D; e += 32) {
      const int j = e / D, d = e - j * D;
      float kk = add ? dk[e] : 0.f, vv = add ? dv[e] : 0.f;
      for (int b = 0; b < nb; ++b) {
        kk = fmaf(scale * sds[b * J + j], qb[b * stride + d], kk);
        vv = fmaf(sa[b * J + j], gb[b * stride + d], vv);
      }
      dk[e] = kk;
      dv[e] = vv;
    }
  }
}

// A warp's walk over rows (b, i) = b * n + i, `stride` rows a step,
// without a 64-bit division a row.
struct Cursor {
  long long row;
  int b, i, sb, si;  // stride = sb * n + si
  __device__ __forceinline__ Cursor(long long first, long long stride, int n)
      : row(first), b((int)(first / n)), i((int)(first % n)), sb((int)(stride / n)),
        si((int)(stride % n)) {}
  __device__ __forceinline__ void step(long long stride, int n) {
    row += stride, b += sb, i += si;
    if (i >= n) i -= n, ++b;
  }
};

// Lane 0 stages kv row (bkv, i): its k and v blocks [J][D], then the q
// rows (and, for the backward, the g rows) of the group's query heads,
// [group][D] each.
__device__ __forceinline__ void stage_row(const Args& p, const Cursor& c, float* st,
                                          uint32_t bar, int D, bool with_g) {
  const size_t kvf = (size_t)p.J * D;
  const uint32_t rb = D * 4, kb = (uint32_t)(kvf * 4), dst = smem_addr(st);
  mbar_expect(bar, 2 * kb + (with_g ? 2 : 1) * p.group * rb);
  bulk_copy(dst, p.k + (size_t)c.row * kvf, kb, bar);
  bulk_copy(dst + kb, p.v + (size_t)c.row * kvf, kb, bar);
  for (int h = 0; h < p.group; ++h) {
    const size_t qrow = (((size_t)c.b * p.group + h) * p.n + c.i) * D;
    bulk_copy(dst + 2 * kb + h * rb, p.q + qrow, rb, bar);
    if (with_g) bulk_copy(dst + 2 * kb + (p.group + h) * rb, p.g + qrow, rb, bar);
  }
}

// The warp's ring: its barriers' shared offset, its region (stages, then
// scratch), the first row it owns and the stride between its rows.
struct Warp {
  uint32_t bar;
  float* region;
  long long first, stride;
  int lane;
};

__device__ __forceinline__ Warp warp_setup(const Args& p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  Warp w;
  w.lane = threadIdx.x & 31;
  w.bar = smem_addr(smem) + warp * STAGES * 8;
  w.region = reinterpret_cast<float*>(smem + BAR_BYTES) + (size_t)warp * p.warp_floats;
  w.first = (long long)blockIdx.x * warps + warp;
  w.stride = (long long)gridDim.x * warps;
  return w;
}

// Lane 0 starts the ring: its barriers, then the warp's first rows; `ic`
// is left at the row the next refill stages.
template <typename Fill>
__device__ __forceinline__ void ring_start(const Args& p, const Warp& w, Cursor& ic,
                                           Fill fill) {
  if (w.lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(w.bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
    for (int s = 0; s < STAGES; ++s, ic.step(w.stride, p.n))
      if (ic.row < p.rows) fill(ic, w.region + s * p.stage_floats, w.bar + 8 * s);
  }
  __syncwarp();
}

// After the warp's t-th row (in stage t % STAGES) is done with: lane 0
// refills the stage with the row STAGES rows ahead (at ic).
template <typename Fill>
__device__ __forceinline__ void ring_next(const Args& p, const Warp& w, Cursor& ic, int t,
                                          Fill fill) {
  __syncwarp();  // every lane is done reading the stage
  if (w.lane == 0) {
    if (ic.row < p.rows) {
      const int s = t % STAGES;
      fence_proxy_async();
      fill(ic, w.region + s * p.stage_floats, w.bar + 8 * s);
    }
    ic.step(w.stride, p.n);
  }
}

// The operands of the warp's t-th kv row: k and v [J][D], and the q (g)
// row of query head h at q (g) + h * hstride; staged, once the stage's
// barrier says they arrived.
struct Row {
  const float *k, *v, *q, *g;
  size_t hstride;
};

template <int DC>
__device__ __forceinline__ Row row_operands(const Args& p, const Warp& w, const Cursor& c, int t,
                                            int D) {
  const size_t kvf = (size_t)p.J * D;
  Row r;
  if constexpr (DC > 0) {
    const int s = t % STAGES;
    const float* st = w.region + s * p.stage_floats;
    mbar_wait<false>(w.bar + 8 * s, (t / STAGES) & 1);
    r.k = st, r.v = st + kvf, r.q = st + 2 * kvf, r.g = r.q + (size_t)p.group * D;
    r.hstride = D;
  } else {
    const size_t q0 = ((size_t)c.b * p.group * p.n + c.i) * D;
    r.k = p.k + (size_t)c.row * kvf, r.v = p.v + (size_t)c.row * kvf;
    r.q = p.q + q0, r.g = p.g ? p.g + q0 : nullptr;
    r.hstride = (size_t)p.n * D;
  }
  return r;
}

__device__ __forceinline__ const uint8_t* mask_row(const Args& p, int bh, int i) {
  return p.mask ? p.mask + ((size_t)(bh / p.heads) * p.n + i) * p.J : nullptr;
}

// The mask of query head bh0 + h: the prefetched row of head bh0 where
// both share it, else loaded now.
__device__ __forceinline__ MaskRow head_mask(const Args& p, const MaskRow& m0, int bh0, int h,
                                             int i, int lane) {
  if (h == 0 || (bh0 + h) / p.heads == bh0 / p.heads) return m0;
  MaskRow m;
  m.load(mask_row(p, bh0 + h, i), p.J, lane);
  return m;
}

// Before the warp's row at c: the mask bytes of the row after it (its
// first query head's), for the next iteration.
__device__ __forceinline__ void prefetch_mask(const Args& p, const Warp& w, const Cursor& c,
                                              MaskRow& next) {
  Cursor nc = c;
  nc.step(w.stride, p.n);
  if (nc.row < p.rows) next.load(mask_row(p, nc.b * p.group, nc.i), p.J, w.lane);
}

template <int DC>
__global__ void __launch_bounds__(MAX_WARPS * 32) attention_fwd_kernel(const Args p) {
  const Warp w = warp_setup(p);
  const int J = p.J, D = DC > 0 ? DC : p.D, lane = w.lane;
  float* sa = w.region + STAGES * p.stage_floats;  // a head's weights [J]
  auto fill = [&](const Cursor& c, float* st, uint32_t bar) {
    stage_row(p, c, st, bar, D, false);
  };
  Cursor ic(w.first, w.stride, p.n), c(w.first, w.stride, p.n);
  if constexpr (DC > 0) ring_start(p, w, ic, fill);
  MaskRow next;
  if (c.row < p.rows) next.load(mask_row(p, c.b * p.group, c.i), J, lane);
  for (int t = 0; c.row < p.rows; c.step(w.stride, p.n), ++t) {
    const MaskRow m0 = next;
    prefetch_mask(p, w, c, next);
    const Row r = row_operands<DC>(p, w, c, t, D);
    const int bh0 = c.b * p.group;
    for (int h = 0; h < p.group; ++h) {
      Vec<DC> qv;
      qv.load(r.q + h * r.hstride);
      float a[SLOTS];
      softmax_row<DC>(a, qv, r.k, head_mask(p, m0, bh0, h, c.i, lane), J, D, p.scale, lane);
#pragma unroll
      for (int u = 0; u < SLOTS; ++u)
        if (lane + 32 * u < J) sa[lane + 32 * u] = a[u];
      __syncwarp();
      weighted_sum<DC>(sa, r.v, p.out + ((size_t)(bh0 + h) * p.n + c.i) * D, 1.f, J, D, lane);
      __syncwarp();  // sa is rewritten by the next head
    }
    if constexpr (DC > 0) ring_next(p, w, ic, t, fill);
  }
}

template <int DC>
__global__ void __launch_bounds__(MAX_WARPS * 32) attention_bwd_kernel(const Args p) {
  const Warp w = warp_setup(p);
  const int J = p.J, D = DC > 0 ? DC : p.D, lane = w.lane;
  const size_t kvf = (size_t)J * D;
  float* sa = w.region + STAGES * p.stage_floats;  // [GB][J] softmax weights
  float* sds = sa + GB * J;                         // [GB][J] dsim
  auto fill = [&](const Cursor& c, float* st, uint32_t bar) {
    stage_row(p, c, st, bar, D, true);
  };
  Cursor ic(w.first, w.stride, p.n), c(w.first, w.stride, p.n);
  if constexpr (DC > 0) ring_start(p, w, ic, fill);
  MaskRow next;
  if (c.row < p.rows) next.load(mask_row(p, c.b * p.group, c.i), J, lane);
  for (int t = 0; c.row < p.rows; c.step(w.stride, p.n), ++t) {
    const MaskRow m0 = next;
    prefetch_mask(p, w, c, next);
    const Row r = row_operands<DC>(p, w, c, t, D);
    const int bh0 = c.b * p.group;
    for (int h0 = 0; h0 < p.group; h0 += GB) {
      const int nb = min(GB, p.group - h0);
      for (int b = 0; b < nb; ++b) {
        const int h = h0 + b;
        Vec<DC> qv;
        qv.load(r.q + h * r.hstride);
        float a[SLOTS], da[SLOTS];
        softmax_row<DC>(a, qv, r.k, head_mask(p, m0, bh0, h, c.i, lane), J, D, p.scale, lane);
        // da_j = <g, v_j>; dsim_j = a_j (da_j - sum_l a_l da_l)
        Vec<DC> gv;
        gv.load(r.g + h * r.hstride);
        slot_dots<DC>(da, gv, r.v, J, D, lane);
        float tsum = 0.f;
#pragma unroll
        for (int u = 0; u < SLOTS; ++u) tsum = fmaf(a[u], da[u], tsum);  // a = 0 past J
        tsum = warp_sum(tsum);
#pragma unroll
        for (int u = 0; u < SLOTS; ++u) {
          const int j = lane + 32 * u;
          if (j < J) {
            sa[b * J + j] = a[u];
            sds[b * J + j] = a[u] * (da[u] - tsum);
          }
        }
        __syncwarp();
        // dq = scale sum_j dsim_j k_j
        weighted_sum<DC>(sds + b * J, r.k, p.out + ((size_t)(bh0 + h) * p.n + c.i) * D,
                         p.scale, J, D, lane);
      }
      __syncwarp();
      store_dkdv<DC>(sa, sds, r.q + h0 * r.hstride, r.g + h0 * r.hstride, r.hstride, nb,
                     p.dk + (size_t)c.row * kvf, p.dv + (size_t)c.row * kvf, h0 > 0, J, D,
                     p.scale, lane);
      __syncwarp();  // sa and sds are rewritten by the next pass
    }
    if constexpr (DC > 0) ring_next(p, w, ic, t, fill);
  }
}

using Kernel = void (*)(const Args);

// The launch shape of one call: the instance, the ring and the warps.
struct Plan {
  Kernel kernel;
  int warps;
  size_t smem;
};

int round32(long long x) { return (int)((x + 31) / 32 * 32); }

template <int DC>
Kernel instance(bool bwd) {
  return bwd ? attention_bwd_kernel<DC> : attention_fwd_kernel<DC>;
}

// A compiled D stages whole kv rows (k, v and the group's q and g rows):
// every pointer 16-byte aligned, the group within a pass of the backward,
// as many warps (up to 8) as two stages a warp fit in the shared memory.
// Any other call is read from device memory by the runtime-D instance.
Plan plan(Args& a, bool bwd, const void* const* ptrs, int nptrs) {
  bool staged = (a.D == 8 || a.D == 24 || a.D == 40 || a.D == 56) && a.group <= GB;
  for (int x = 0; x < nptrs; ++x)
    staged = staged && reinterpret_cast<uintptr_t>(ptrs[x]) % 16 == 0;
  const int scratch = round32(bwd ? 2LL * GB * a.J : a.J);
  const int stage = round32(2LL * a.J * a.D + (bwd ? 2LL : 1LL) * a.group * a.D);
  const long long per_warp = 4LL * (STAGES * (long long)stage + scratch);
  const int warps = (int)std::min<long long>(MAX_WARPS, (SMEM_LIMIT - BAR_BYTES) / per_warp);
  staged = staged && warps >= 1;
  Plan pl;
  a.stage_floats = staged ? stage : 0;
  a.warp_floats = STAGES * a.stage_floats + scratch;
  pl.warps = staged ? warps : MAX_WARPS;
  pl.smem = BAR_BYTES + (size_t)pl.warps * a.warp_floats * 4;
  switch (staged ? a.D : 0) {
    case 8: pl.kernel = instance<8>(bwd); break;
    case 24: pl.kernel = instance<24>(bwd); break;
    case 40: pl.kernel = instance<40>(bwd); break;
    case 56: pl.kernel = instance<56>(bwd); break;
    default: pl.kernel = instance<0>(bwd);
  }
  return pl;
}

// One CTA of pl.warps warps per row block, as many CTAs as the card holds
// at once (persistent: each warp walks its rows).
int launch(const Args& a, const Plan& pl, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)pl.smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pl.kernel, pl.warps * 32,
                                                       pl.smem);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (a.rows + pl.warps - 1) / pl.warps;
  const unsigned grid = (unsigned)std::min<long long>(blocks, (long long)per_sm * sms);
  pl.kernel<<<grid, pl.warps * 32, pl.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch status
// (cudaGetLastError() right after the launch); 0 is success. Pointers are
// device pointers to contiguous float32 tensors (mask: bool, or null):
// q / out / g / dq [BH, n, D], k / v / dk / dv [BKV, n, J, D], mask
// [BH / heads, n, J]; BH % BKV == 0, J <= 128, D <= 256 (the caller checks).
extern "C" int se3_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                 void* out, int BH, int BKV, int n, int J, int D, int heads,
                                 float scale, void* stream) {
  if (BH <= 0 || n <= 0) return 0;
  if (BKV <= 0 || BH % BKV || J <= 0 || J > MAX_J || D <= 0 || D > MAX_D || heads <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const uint8_t*>(mask), nullptr,
         static_cast<float*>(out), nullptr, nullptr, (long long)BKV * n, n, J, D, BH / BKV,
         heads, scale, 0, 0};
  const void* ptrs[] = {q, k, v, out};
  const Plan pl = plan(a, false, ptrs, 4);
  return launch(a, pl, static_cast<cudaStream_t>(stream));
}

extern "C" int se3_attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                                 const void* g, void* dq, void* dk, void* dv, int BH, int BKV,
                                 int n, int J, int D, int heads, float scale, void* stream) {
  if (BH <= 0 || n <= 0) return 0;
  if (BKV <= 0 || BH % BKV || J <= 0 || J > MAX_J || D <= 0 || D > MAX_D || heads <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
         static_cast<const float*>(g), static_cast<float*>(dq), static_cast<float*>(dk),
         static_cast<float*>(dv), (long long)BKV * n, n, J, D, BH / BKV, heads, scale, 0, 0};
  const void* ptrs[] = {q, k, v, g, dq, dk, dv};
  const Plan pl = plan(a, true, ptrs, 7);
  return launch(a, pl, static_cast<cudaStream_t>(stream));
}
