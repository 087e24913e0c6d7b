// Tiles of the flash-attention backward kernels (K6b dK/dV and K6c dQ,
// flash_attention_bwd.cu), which run on CUDA cores.
//
// A block of 128 threads works on a 64-query x 64-key tile: thread t owns the
// 4 x 8 micro-tile of query rows 4 * (t / 8) .. + 3 and keys t % 8, t % 8 + 8,
// ..., t % 8 + 56. Tiles are staged in shared memory as f32 with odd row
// strides (D + 1, 64 + 1), so a warp reading one column of 4 or 8 rows hits
// distinct banks. The backward recomputes the scores with dot_tile (d
// ascending, one fmaf chain per score). The forward (K6, mma_attention.cuh)
// sums them on tensor cores in another order, so a recomputed score may
// differ from the forward's by a few ulps and exceed the row max m that the
// forward saved by as much. The backward clamps the exponent of
// p = exp(s * scale - m) / l at 0: at scores of ordinary size the clamp
// moves p by a relative few 1e-7, far below the bf16 rounding of p (2^-9)
// that follows, and at scores of 1e17 (which a random detector's features
// give layer 0) an ulp of excess would overflow exp() and turn the
// gradients to NaN. What bounds them is the CUDA cores' f32 rate; moving
// them onto the forward's mma.sync fragments is a later change.
#pragma once

#include "common.cuh"

namespace cpt {
namespace flash {

constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kThreads = 128;    // 16 row groups x 8 column groups
constexpr int kColGroups = 8;
constexpr int kRows = 4;         // query rows per thread
static_assert(kTile == (kThreads / kColGroups) * kRows && kTile == 8 * kColGroups,
              "16 row groups of 4 rows and 8 column groups of 8 keys cover a 64 x 64 tile");

// rows [row0, row0 + 64) of one (batch, head) slice -> f32 shared tile with
// leading dimension ld; rows at or past S are zero. Global rows are 16-byte
// aligned (checked by the wrappers), so each thread loads 8 bf16 at a time.
template <int D>
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ base, long long row_stride,
                                           int row0, int S, float* __restrict__ dst, int ld) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) raw = *reinterpret_cast<const uint4*>(base + (row0 + r) * row_stride + c);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float* d = dst + r * ld + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(pairs[e]);
      d[2 * e] = f.x;
      d[2 * e + 1] = f.y;
    }
  }
}

// acc[i][j] = sum over d (ascending) of a[(r0 + i) * lda + d] * b[(cg + 8 j) * ldb + d]
template <int D>
__device__ __forceinline__ void dot_tile(const float* __restrict__ a, int lda,
                                         const float* __restrict__ b, int ldb, int r0, int cg,
                                         float acc[kRows][8]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[kRows], bv[8];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(r0 + i) * lda + d];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = b[(cg + 8 * j) * ldb + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

}  // namespace flash
}  // namespace cpt
