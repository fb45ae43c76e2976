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
// J = 33 slots of k and v (2 * J * D floats) for ~4 * J * D flops: well
// left of the ridge. At the flagship (B*h = 8, n = 1024, J = 33, D = 8 ..
// 56) one attention block reads ~0.28 GB of k and v, ~0.08 ms.
//
// What the design does about it: one warp per row (bh, i). Each lane
// takes slots j = lane, lane + 32, ... for the scores (its k row read
// whole, the warp's rows one contiguous block) and features d = lane, ...
// for the weighted sums, so every k and v value is read once from device
// memory; q, the scores and the softmax weights stay in shared memory.
// Rows past n do not exist: no padding is needed, where the TPU kernel
// padded rows to its block with True mask slots.
//
// The backward gives each warp one kv head's row (bkv, i) and walks the
// group's query heads bh = bkv * group + 0 .. group-1 in order; each lane
// owns the same (j, d) entries of dk and dv on every pass and adds into
// them, so the group sum needs no atomics and is the same on every run.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int MAX_J = 128;   // slots a row may have (kernels/attention.py)
constexpr int MAX_D = 256;   // features a row may have
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -FLT_MAX;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row's softmax weights into sa[0 .. J): scores scale * <q, k_j> with
// masked slots at NEG_INF, then p_j = exp(sim_j - max) and a_j = p_j / sum p.
__device__ __forceinline__ void row_softmax(float* sa, const float* sq,
                                            const float* __restrict__ kr,
                                            const uint8_t* __restrict__ mr, int J, int D,
                                            float scale, int lane) {
  float mx = NEG_INF;
  for (int j = lane; j < J; j += 32) {
    const float* kj = kr + (size_t)j * D;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(sq[d], __ldg(kj + d), s);
    s *= scale;
    if (mr != nullptr && !mr[j]) s = NEG_INF;
    sa[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float l = 0.f;
  for (int j = lane; j < J; j += 32) {
    const float p = expf(sa[j] - mx);
    sa[j] = p;
    l += p;
  }
  l = warp_sum(l);
  for (int j = lane; j < J; j += 32) sa[j] = sa[j] / l;
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ mask,
                     float* __restrict__ out, int BH, int n, int J, int D, int group,
                     int heads, float scale) {
  __shared__ float s_q[WARPS][MAX_D];
  __shared__ float s_a[WARPS][MAX_J];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= (long long)BH * n) return;  // the whole warp leaves together
  const int bh = (int)(row / n), i = (int)(row % n);
  const size_t kv_row = ((size_t)(bh / group) * n + i) * J * D;
  const float* kr = k + kv_row;
  const float* vr = v + kv_row;
  const uint8_t* mr = mask ? mask + ((size_t)(bh / heads) * n + i) * J : nullptr;
  float* sq = s_q[warp];
  float* sa = s_a[warp];

  for (int d = lane; d < D; d += 32) sq[d] = __ldg(q + (size_t)row * D + d);
  __syncwarp();
  row_softmax(sa, sq, kr, mr, J, D, scale, lane);
  for (int d = lane; d < D; d += 32) {
    float o = 0.f;
    for (int j = 0; j < J; ++j) o = fmaf(sa[j], __ldg(vr + (size_t)j * D + d), o);
    out[(size_t)row * D + d] = o;
  }
}

__global__ void __launch_bounds__(THREADS)
attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ mask,
                     const float* __restrict__ g, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int BKV, int n, int J,
                     int D, int group, int heads, float scale) {
  __shared__ float s_q[WARPS][MAX_D];
  __shared__ float s_g[WARPS][MAX_D];
  __shared__ float s_a[WARPS][MAX_J];
  __shared__ float s_ds[WARPS][MAX_J];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= (long long)BKV * n) return;
  const int bkv = (int)(row / n), i = (int)(row % n);
  const size_t kv_row = (size_t)row * J * D;
  const float* kr = k + kv_row;
  const float* vr = v + kv_row;
  float* dkr = dk + kv_row;
  float* dvr = dv + kv_row;
  float* sq = s_q[warp];
  float* sg = s_g[warp];
  float* sa = s_a[warp];
  float* sds = s_ds[warp];

  for (int gi = 0; gi < group; ++gi) {
    const int bh = bkv * group + gi;
    const size_t q_row = ((size_t)bh * n + i) * D;
    const uint8_t* mr = mask ? mask + ((size_t)(bh / heads) * n + i) * J : nullptr;
    for (int d = lane; d < D; d += 32) {
      sq[d] = __ldg(q + q_row + d);
      sg[d] = __ldg(g + q_row + d);
    }
    __syncwarp();
    row_softmax(sa, sq, kr, mr, J, D, scale, lane);
    // da_j = <g, v_j>; dsim_j = a_j (da_j - sum_l a_l da_l)
    float t = 0.f;
    for (int j = lane; j < J; j += 32) {
      const float* vj = vr + (size_t)j * D;
      float da = 0.f;
      for (int d = 0; d < D; ++d) da = fmaf(sg[d], __ldg(vj + d), da);
      sds[j] = da;
      t = fmaf(sa[j], da, t);
    }
    t = warp_sum(t);
    for (int j = lane; j < J; j += 32) sds[j] = sa[j] * (sds[j] - t);
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float s = 0.f;
      for (int j = 0; j < J; ++j) s = fmaf(sds[j], __ldg(kr + (size_t)j * D + d), s);
      dq[q_row + d] = scale * s;
    }
    // dk_j = scale dsim_j q, dv_j = a_j g: the first query head of the
    // group writes, the others add (the same lane owns the same entries)
    for (int e = lane; e < J * D; e += 32) {
      const int j = e / D, d = e - j * D;
      const float kk = scale * sds[j] * sq[d];
      const float vv = sa[j] * sg[d];
      if (gi == 0) {
        dkr[e] = kk;
        dvr[e] = vv;
      } else {
        dkr[e] += kk;
        dvr[e] += vv;
      }
    }
    __syncwarp();  // the shared rows are rewritten by the next query head
  }
}

unsigned blocks_for(long long rows) { return (unsigned)((rows + WARPS - 1) / WARPS); }

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
  attention_fwd_kernel<<<blocks_for((long long)BH * n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), BH, n, J, D, BH / BKV, heads, scale);
  return (int)cudaGetLastError();
}

extern "C" int se3_attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                                 const void* g, void* dq, void* dk, void* dv, int BH, int BKV,
                                 int n, int J, int D, int heads, float scale, void* stream) {
  if (BH <= 0 || n <= 0) return 0;
  if (BKV <= 0 || BH % BKV || J <= 0 || J > MAX_J || D <= 0 || D > MAX_D || heads <= 0)
    return (int)cudaErrorInvalidValue;
  attention_bwd_kernel<<<blocks_for((long long)BKV * n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(g), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), BKV, n, J, D, BH / BKV, heads, scale);
  return (int)cudaGetLastError();
}
