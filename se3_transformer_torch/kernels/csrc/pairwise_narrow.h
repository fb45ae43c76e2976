// The narrow-O arms' launches (O = 8, 16 or 32), compiled in a unit of
// their own (pairwise_narrow.cu, the kernels in pairwise_narrow.cuh) so
// that the 64-wide units (pairwise_fwd.cu, pairwise_bwd.cu) hold no device
// code of theirs: those units' entry points hand a narrow O to these and
// run the split reduces. Each returns cudaGetLastError() right after its
// launch; pointers are device pointers to contiguous tensors, h and W3
// float32 (h_bf16 == false) or bf16, the rest float32.
#pragma once

#include <cuda_runtime.h>

namespace se3n {

// The O values the narrow arms take.
inline bool narrow(int O) { return O == 8 || O == 16 || O == 32; }

// #3: out [E, P, O], or with more than one i split (ceil(IF / i_per_split))
// each split's partial [E, P, O] in turn at dst.
cudaError_t launch_fwd(bool h_bf16, const void* h, const void* w3, const void* b3,
                       const void* v2, void* dst, int E, int IF, int O, int P,
                       int i_per_split, cudaStream_t stream);

// Kernel A: dv2 [E, P, IF] whole, and each of the `splits` edge splits'
// partial dW3 [128, IF, O] then dB3 [IF, O] in turn at work.
cudaError_t launch_bwd_a(bool h_bf16, const void* h, const void* w3, const void* b3,
                         const void* v2, const void* g, void* dv2, void* work, int E, int IF,
                         int O, int P, int splits, cudaStream_t stream);

// Kernel B: dh [E, 128], or with more than one i split each split's
// partial [E, 128] in turn at dst.
cudaError_t launch_bwd_b(bool w3_bf16, const void* w3, const void* v2, const void* g,
                         void* dst, int E, int IF, int O, int P, int i_per_split,
                         cudaStream_t stream);

}  // namespace se3n
