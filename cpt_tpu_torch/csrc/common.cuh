// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (bound from Python with ctypes,
// see cpt_tpu_torch/kernels/build.py): pointers and the stream arrive as
// void*, sizes as int. Each entry point launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError() so
// that a refused launch is reported to the wrapper at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CPT_EXPORT extern "C" __attribute__((visibility("default")))

namespace cpt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace cpt
