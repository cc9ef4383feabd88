// Helpers shared by the hand-written Hopper kernels of the port.
//
// Every exported entry point has a plain C signature (pointers as void*,
// the stream as void*), launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so that a refused launch is seen
// by the Python wrapper (ops/kernels/_build.py) at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FMM_EXPORT extern "C" __attribute__((visibility("default")))

namespace fmm {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

}  // namespace fmm
