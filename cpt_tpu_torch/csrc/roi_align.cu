// K2: RoIAlign of one shared RoI set over a batch of feature maps,
// [B, H, W, C] bf16 x [N, 4] f32 -> [B, N, P, P, C] bf16, legacy
// maskrcnn semantics (aligned=False) with the adaptive per-RoI sampling grid
// ceil(bin) capped at max_sampling.
//
// Replaces cpt_tpu/ops/roi_align_pallas.py::batched_roi_align (_pool_kernel),
// which contracted separable interpolation matrices on the MXU because
// gathers are slow on a TPU. On Hopper a gather is cheap: this kernel reads
// the four bilinear corners of every sample directly.
//
// What bounds it: bytes moved through L2. Each output reads up to
// 4 * 8 * 8 corner vectors that neighbouring outputs share, so the feature
// map (5 MB per copy at the C4 extraction shape) stays L2-resident and the
// kernel writes its output once. One thread computes one 8-channel vector
// (16 bytes) of one (copy, RoI, py, px) cell, so threads of a warp load
// consecutive 16-byte vectors. Accumulation is f32 straight through; the JAX
// path rounds its intermediate to bf16 between its two contractions, so the
// two agree to bf16 tolerance.
#include "common.cuh"

namespace {

__device__ __forceinline__ void axpy8(float* acc, float wgt, const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    acc[2 * k] += wgt * f.x;
    acc[2 * k + 1] += wgt * f.y;
  }
}

// One axis of the legacy sample rule: returns false when the sample is
// skipped (outside [-1, size]); else the low/high indices and weights.
__device__ __forceinline__ bool axis_sample(float pos, int size, int* lo, int* hi,
                                            float* w_lo, float* w_hi) {
  if (!(pos >= -1.f && pos <= static_cast<float>(size))) return false;
  pos = fminf(fmaxf(pos, 0.f), static_cast<float>(size - 1));
  const float low = floorf(pos);
  const float frac = pos - low;
  *lo = static_cast<int>(low);
  *hi = min(*lo + 1, size - 1);
  *w_lo = 1.f - frac;
  *w_hi = frac;
  return true;
}

__global__ void roi_align_kernel(const cpt::bf16* __restrict__ feats,
                                 const float* __restrict__ rois,
                                 cpt::bf16* __restrict__ out, int B, int H, int W, int C,
                                 int N, int P, float spatial_scale, int sampling,
                                 int max_sampling) {
  const int CV = C / 8;
  const long long total = static_cast<long long>(B) * N * P * P * CV;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  long long r = idx;
  const int cv = static_cast<int>(r % CV);
  r /= CV;
  const int px = static_cast<int>(r % P);
  r /= P;
  const int py = static_cast<int>(r % P);
  r /= P;
  const int n = static_cast<int>(r % N);
  const int b = static_cast<int>(r / N);

  const float x1 = rois[4 * n + 0] * spatial_scale;
  const float y1 = rois[4 * n + 1] * spatial_scale;
  const float x2 = rois[4 * n + 2] * spatial_scale;
  const float y2 = rois[4 * n + 3] * spatial_scale;
  const float bin_w = fmaxf(x2 - x1, 1.f) / static_cast<float>(P);
  const float bin_h = fmaxf(y2 - y1, 1.f) / static_cast<float>(P);
  int sy = sampling, sx = sampling;
  if (sampling == 0) {
    sy = min(max(static_cast<int>(ceilf(bin_h)), 1), max_sampling);
    sx = min(max(static_cast<int>(ceilf(bin_w)), 1), max_sampling);
  }

  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  const cpt::bf16* fb = feats + static_cast<size_t>(b) * H * W * C + cv * 8;
  for (int iy = 0; iy < sy; ++iy) {
    const float y = y1 + (static_cast<float>(py) +
                          (static_cast<float>(iy) + 0.5f) / static_cast<float>(sy)) * bin_h;
    int ylo, yhi;
    float wylo, wyhi;
    if (!axis_sample(y, H, &ylo, &yhi, &wylo, &wyhi)) continue;
    for (int ix = 0; ix < sx; ++ix) {
      const float xx = x1 + (static_cast<float>(px) +
                             (static_cast<float>(ix) + 0.5f) / static_cast<float>(sx)) * bin_w;
      int xlo, xhi;
      float wxlo, wxhi;
      if (!axis_sample(xx, W, &xlo, &xhi, &wxlo, &wxhi)) continue;
      const uint4 v00 = *reinterpret_cast<const uint4*>(fb + (static_cast<size_t>(ylo) * W + xlo) * C);
      const uint4 v01 = *reinterpret_cast<const uint4*>(fb + (static_cast<size_t>(ylo) * W + xhi) * C);
      const uint4 v10 = *reinterpret_cast<const uint4*>(fb + (static_cast<size_t>(yhi) * W + xlo) * C);
      const uint4 v11 = *reinterpret_cast<const uint4*>(fb + (static_cast<size_t>(yhi) * W + xhi) * C);
      axpy8(acc, wylo * wxlo, v00);
      axpy8(acc, wylo * wxhi, v01);
      axpy8(acc, wyhi * wxlo, v10);
      axpy8(acc, wyhi * wxhi, v11);
    }
  }
  const float inv = 1.f / static_cast<float>(sy * sx);
  uint4 res;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(acc[2 * k] * inv, acc[2 * k + 1] * inv);
  *reinterpret_cast<uint4*>(out + (static_cast<size_t>(idx / CV) * C) + cv * 8) = res;
}

}  // namespace

// feats [B, H, W, C] bf16 (C % 8 == 0, 16-byte aligned), rois [N, 4] f32
// xyxy in image coordinates, out [B, N, P, P, C] bf16.
CPT_EXPORT int cpt_roi_align(const void* feats, const void* rois, void* out, int B, int H,
                             int W, int C, int N, int P, float spatial_scale,
                             int sampling, int max_sampling, void* stream) {
  const long long total = static_cast<long long>(B) * N * P * P * (C / 8);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  roi_align_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const cpt::bf16*>(feats), static_cast<const float*>(rois),
      static_cast<cpt::bf16*>(out), B, H, W, C, N, P, spatial_scale, sampling,
      max_sampling);
  return cpt::launch_status();
}
