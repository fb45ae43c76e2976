// The narrow-O arms' launches (O = 8, 16 or 32), compiled in a unit of
// their own (pairwise_narrow.cu, the kernels in pairwise_narrow.cuh) so
// that the 64-wide units (pairwise_fwd.cu, pairwise_bwd.cu) hold no device
// code of theirs: those units' entry points hand a narrow O to these and
// run the split reduces. Each returns cudaGetLastError() right after its
// launch; pointers are device pointers to contiguous tensors, h and W3
// float32 (h_bf16 == false) or bf16, the rest float32.
//
// The radial width KM is the unit's: 128, or 32 in the units compiled with
// -DSE3_M32=1 (pairwise_narrow.cu's mid-32 unit defines these launches in
// namespace se3n32, which the mid-32 units of pairwise_fwd.cu and
// pairwise_bwd.cu call through SE3N).
#pragma once

#include <cuda_runtime.h>

#ifndef SE3_M32
#define SE3_M32 0
#endif
#if SE3_M32
#define SE3N se3n32
#else
#define SE3N se3n
#endif

namespace SE3N {

// The O values the narrow arms take.
inline bool narrow(int O) { return O == 8 || O == 16 || O == 32; }

// #3: out [E, P, O], or with more than one i split (ceil(IF / i_per_split))
// each split's partial [E, P, O] in turn at dst.
cudaError_t launch_fwd(bool h_bf16, const void* h, const void* w3, const void* b3,
                       const void* v2, void* dst, int E, int IF, int O, int P,
                       int i_per_split, cudaStream_t stream);

// Kernel A: dv2 [E, P, IF] whole, and each of the `splits` edge splits'
// partial dW3 [KM, IF, O] then dB3 [IF, O] in turn at work.
cudaError_t launch_bwd_a(bool h_bf16, const void* h, const void* w3, const void* b3,
                         const void* v2, const void* g, void* dv2, void* work, int E, int IF,
                         int O, int P, int splits, cudaStream_t stream);

// Kernel B: dh [E, KM], or with more than one i split each split's
// partial [E, KM] in turn at dst.
cudaError_t launch_bwd_b(bool w3_bf16, const void* w3, const void* v2, const void* g,
                         void* dst, int E, int IF, int O, int P, int i_per_split,
                         cudaStream_t stream);

}  // namespace SE3N
