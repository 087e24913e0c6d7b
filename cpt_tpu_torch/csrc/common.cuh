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

// 4x4 byte transpose: r[i] holds bytes j = M[i][j] of a row-major 4x4 int8
// block; c[j] gets bytes i = M[i][j] (the block's column j, packed).
__device__ __forceinline__ void transpose4x4_s8(const int (&r)[4], int (&c)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const unsigned t1 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = static_cast<int>(__byte_perm(t0, t1, 0x5410));
  c[1] = static_cast<int>(__byte_perm(t0, t1, 0x7632));
  c[2] = static_cast<int>(__byte_perm(t2, t3, 0x5410));
  c[3] = static_cast<int>(__byte_perm(t2, t3, 0x7632));
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace cpt
