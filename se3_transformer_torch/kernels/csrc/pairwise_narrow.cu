// The narrow-O arms of kernels #3, A and B (pairwise_narrow.cuh), with
// their launches (pairwise_narrow.h): one instance per h/W3 type, O tile
// (16 or 32) and P (1, 2, 3, 5, 7), at the unit's radial width KMID (128;
// 32 with -DSE3_M32=1, P 1 and 2 only: V2's rows).

#include "pairwise_narrow.cuh"
#include "pairwise_narrow.h"

namespace SE3N {
namespace {

using bf16 = __nv_bfloat16;
constexpr int KMID = SE3_M32 ? se3::MID32 : MID;

template <typename T, int P, int ON>
cudaError_t fwd(const void* h, const void* w3, const void* b3, const void* v2, void* dst,
                int E, int IF, int O, int i_per_split, cudaStream_t stream) {
  constexpr size_t smem = NCfg<ON, P, KMID>::FWD;
  auto kern = fwd_kernel<T, P, ON, KMID>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int splits = (IF + i_per_split - 1) / i_per_split;
  kern<<<dim3((E + BE - 1) / BE, 1, splits), NTHREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w3), static_cast<const float*>(b3),
      static_cast<const float*>(v2), static_cast<float*>(dst), E, IF, O, i_per_split);
  return cudaGetLastError();
}

// one CTA per NI values of i and edge split
template <typename T, int P, int ON>
cudaError_t bwd_a(const void* h, const void* w3, const void* b3, const void* v2, const void* g,
                  void* dv2, void* work, int E, int IF, int O, int splits,
                  cudaStream_t stream) {
  constexpr size_t smem = NCfg<ON, P, KMID>::A;
  auto kern = bwd_a_kernel<T, P, ON, KMID>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (E + BE - 1) / BE;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  kern<<<dim3((IF + NI - 1) / NI, splits), NTHREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w3), static_cast<const float*>(b3),
      static_cast<const float*>(v2), static_cast<const float*>(g), static_cast<float*>(dv2),
      static_cast<float*>(work), E, IF, O, tiles_per_split);
  return cudaGetLastError();
}

// one CTA per 64-edge tile and i split
template <typename T, int P, int ON>
cudaError_t bwd_b(const void* w3, const void* v2, const void* g, void* dst, int E, int IF,
                  int O, int i_per_split, cudaStream_t stream) {
  constexpr size_t smem = NCfg<ON, P, KMID>::B;
  auto kern = bwd_b_kernel<T, P, ON, KMID>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int splits = (IF + i_per_split - 1) / i_per_split;
  kern<<<dim3((E + BE - 1) / BE, splits), NTHREADS, smem, stream>>>(
      static_cast<const T*>(w3), static_cast<const float*>(v2), static_cast<const float*>(g),
      static_cast<float*>(dst), E, IF, O, i_per_split);
  return cudaGetLastError();
}

}  // namespace

// The instance for the type, O's tile and P; an O or P the arms do not
// take is refused (at mid 32, P past 2: V2's rows are 1 and 2).
#if SE3_M32
#define SE3N_ODD(BF, CALL)
#else
#define SE3N_ODD(BF, CALL)                                                                \
    case 3: return BF ? (t16 ? CALL(bf16, 3, 16) : CALL(bf16, 3, 32))                    \
                      : (t16 ? CALL(float, 3, 16) : CALL(float, 3, 32));                 \
    case 5: return BF ? (t16 ? CALL(bf16, 5, 16) : CALL(bf16, 5, 32))                    \
                      : (t16 ? CALL(float, 5, 16) : CALL(float, 5, 32));                 \
    case 7: return BF ? (t16 ? CALL(bf16, 7, 16) : CALL(bf16, 7, 32))                    \
                      : (t16 ? CALL(float, 7, 16) : CALL(float, 7, 32));
#endif
#define SE3N_DISPATCH(BF, CALL)                                                           \
  if (!narrow(O)) return cudaErrorInvalidValue;                                          \
  const bool t16 = tile_for(O) == 16;                                                    \
  switch (P) {                                                                           \
    case 1: return BF ? (t16 ? CALL(bf16, 1, 16) : CALL(bf16, 1, 32))                    \
                      : (t16 ? CALL(float, 1, 16) : CALL(float, 1, 32));                 \
    case 2: return BF ? (t16 ? CALL(bf16, 2, 16) : CALL(bf16, 2, 32))                    \
                      : (t16 ? CALL(float, 2, 16) : CALL(float, 2, 32));                 \
    SE3N_ODD(BF, CALL)                                                                   \
  }                                                                                      \
  return cudaErrorInvalidValue;

cudaError_t launch_fwd(bool h_bf16, const void* h, const void* w3, const void* b3,
                       const void* v2, void* dst, int E, int IF, int O, int P,
                       int i_per_split, cudaStream_t stream) {
#define SE3N_FWD(T, PP, ON) fwd<T, PP, ON>(h, w3, b3, v2, dst, E, IF, O, i_per_split, stream)
  SE3N_DISPATCH(h_bf16, SE3N_FWD)
#undef SE3N_FWD
}

cudaError_t launch_bwd_a(bool h_bf16, const void* h, const void* w3, const void* b3,
                         const void* v2, const void* g, void* dv2, void* work, int E, int IF,
                         int O, int P, int splits, cudaStream_t stream) {
#define SE3N_A(T, PP, ON) bwd_a<T, PP, ON>(h, w3, b3, v2, g, dv2, work, E, IF, O, splits, stream)
  SE3N_DISPATCH(h_bf16, SE3N_A)
#undef SE3N_A
}

cudaError_t launch_bwd_b(bool w3_bf16, const void* w3, const void* v2, const void* g,
                         void* dst, int E, int IF, int O, int P, int i_per_split,
                         cudaStream_t stream) {
#define SE3N_B(T, PP, ON) bwd_b<T, PP, ON>(w3, v2, g, dst, E, IF, O, i_per_split, stream)
  SE3N_DISPATCH(w3_bf16, SE3N_B)
#undef SE3N_B
}

#undef SE3N_DISPATCH
#undef SE3N_ODD

}  // namespace SE3N
