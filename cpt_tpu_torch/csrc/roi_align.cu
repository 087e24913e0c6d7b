// K2: RoIAlign of one shared RoI set over a batch of feature maps,
// [B, H, W, C] bf16 x [N, 4] f32 -> [B, N, P, P, C] bf16, legacy
// maskrcnn semantics (aligned=False) with the adaptive per-RoI sampling grid
// ceil(bin) capped at max_sampling.
//
// Replaces cpt_tpu/ops/roi_align_pallas.py::batched_roi_align (_pool_kernel),
// which contracted separable interpolation matrices on the MXU. The function
// is separable: out[p, q, c] = sum_y sum_x Ry[p, y] Rx[q, x] f[y, x, c], where
// Ry (Rx) folds the bilinear weights of a bin's sy (sx) samples per distinct
// row (column) and divides by sy (sx). One block owns one bin row py of one
// RoI in one channel slice, for a group of copies of the batch (the RoI set
// is shared by the copies, so are its tables):
//   1. tables: threads 0 .. P-1 fold the samples of bin column q into
//      (column, weight) entries, thread P those of bin row py into (row,
//      weight) entries, in shared memory, with the legacy rules (the scale,
//      extents of at least 1, ceil(bin) samples capped at max_sampling,
//      samples outside [-1, size] dropped, the rest clamped to size - 1);
//      a bin reaches at most 2 * samples distinct rows, and a sample's two
//      entries merge with its neighbours' in registers;
//   2. a thread owns one 16-byte channel vector of one bin (py, px) and
//      sums Ry[py, y] Rx[px, x] f[y, x, c] over the bin's folded rows and
//      columns, two copies at a time (independent loads), rounds once to
//      bf16 and writes with a 16-byte streaming store. The bins of a row
//      share rows and columns, which the block's threads find in L1.
// Offsets inside one copy's map are 32-bit. 128 channels a block where
// the copies give it enough outputs (B P 16 >= 1024 vectors), else all of
// them; the copies split into groups (two at least each) until the grid has
// ~2100 blocks, so that a large RoI's bins (up to 16 x 16 folded taps at the
// 8-sample cap) spread over the card instead of queueing in a few blocks.
//
// What bounds it: bytes. The output ([B, N, 14, 14, C], larger than the
// input at the main path's shapes) is written once; a bin reads its folded
// rows x columns (<= 2 s each) instead of 4 corners per sample (the first
// kernel read 256 corner vectors per output vector at the 8-sample cap, and
// recomputed the RoI's geometry and weights in every thread). Accumulation
// is f32 straight through.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSliceChannels = 128;  // channels of one block (16 vectors a bin)
constexpr int kGridBlocks = 2112;    // 16 blocks an SM: enough to spread a large RoI

__device__ __forceinline__ void axpy8(float* acc, float wgt, const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    acc[2 * k] += wgt * f.x;
    acc[2 * k + 1] += wgt * f.y;
  }
}

// The folded table of bin p along one axis: s samples at
// start + (p + (i + .5) / s) * bin, those outside [-1, size] dropped, the
// rest clamped to [0, size - 1] and split between floor and floor + 1;
// writes (index, weight / s) entries in increasing index order and returns
// their count (<= 2 s). Samples come in increasing position, so an index
// is final once a sample's floor passes it: two pending entries live in
// registers.
__device__ int fold_bin(float start, float bin, int s, int p, int size, int* rows,
                        float* wts) {
  const float fs = static_cast<float>(s), inv = 1.f / fs;
  int n = 0, r0 = -2;
  float w0 = 0.f, w1 = 0.f;  // pending weights of indices r0 and r0 + 1
  auto flush = [&](int r, float w) {
    if (w != 0.f) {
      rows[n] = r;
      wts[n] = w * inv;
      ++n;
    }
  };
  for (int i = 0; i < s; ++i) {
    float pos = start + (static_cast<float>(p) + (static_cast<float>(i) + 0.5f) / fs) * bin;
    if (!(pos >= -1.f && pos <= static_cast<float>(size))) continue;
    pos = fminf(fmaxf(pos, 0.f), static_cast<float>(size - 1));
    const float low = floorf(pos);
    const float frac = pos - low;
    const int lo = static_cast<int>(low);  // lo = size - 1 only at frac 0
    if (lo == r0) {
      w0 += 1.f - frac;
      w1 += frac;
    } else if (lo == r0 + 1) {
      flush(r0, w0);
      w0 = w1 + (1.f - frac);
      w1 = frac;
    } else {
      flush(r0, w0);
      flush(r0 + 1, w1);
      w0 = 1.f - frac;
      w1 = frac;
    }
    r0 = lo;
  }
  flush(r0, w0);
  flush(r0 + 1, w1);
  return n;
}

// Shared memory: xrows [P][tab] | xw [P][tab] | yrows [tab] | yw [tab] |
// xn [P], where tab = 2 * (most samples a bin side).
template <int Copies>
__global__ void __launch_bounds__(kThreads)
    roi_align_kernel(const cpt::bf16* __restrict__ feats, const float* __restrict__ rois,
                     cpt::bf16* __restrict__ out, int B, int H, int W, int C, int N, int P,
                     float spatial_scale, int sampling, int max_sampling, int slice,
                     int tab, int cpb) {
  extern __shared__ int tables[];
  int* xrows = tables;
  float* xw = reinterpret_cast<float*>(xrows + P * tab);
  int* yrows = reinterpret_cast<int*>(xw + P * tab);
  float* yw = reinterpret_cast<float*>(yrows + tab);
  int* xn = reinterpret_cast<int*>(yw + tab);
  __shared__ int s_yn;

  const int slices = (C + slice - 1) / slice;
  const int py = blockIdx.x / slices;
  const int c0 = (blockIdx.x - py * slices) * slice;
  const int n = blockIdx.y;
  const int nv = min(slice, C - c0) / 8;  // 16-byte vectors of this slice
  const int tid = threadIdx.x;

  // tables, once for every copy: thread q < P folds bin column q, thread P
  // bin row py
  if (tid <= P) {
    const bool is_x = tid < P;
    const float lo = rois[4 * n + (is_x ? 0 : 1)] * spatial_scale;
    const float hi = rois[4 * n + (is_x ? 2 : 3)] * spatial_scale;
    const float bin = fmaxf(hi - lo, 1.f) / static_cast<float>(P);
    const int s = sampling ? sampling
                           : min(max(static_cast<int>(ceilf(bin)), 1), max_sampling);
    if (is_x) {
      xn[tid] = fold_bin(lo, bin, s, tid, W, xrows + tid * tab, xw + tid * tab);
    } else {
      s_yn = fold_bin(lo, bin, s, py, H, yrows, yw);
    }
  }
  __syncthreads();

  // one 16-byte output vector of bin (py, px) a thread, for Copies copies
  // at a time (independent loads); the bin's neighbours (the block's other
  // threads) share its rows and columns in L1
  const int ny = s_yn;
  const size_t map = static_cast<size_t>(H) * W * C;
  const size_t out_copy = static_cast<size_t>(N) * P * P * C;
  for (int e = tid; e < P * nv; e += blockDim.x) {
    const int px = e / nv, v = e - px * nv;
    const int nx = xn[px];
    const int* xr = xrows + px * tab;
    const float* xwp = xw + px * tab;
    const cpt::bf16* fv = feats + c0 + v * 8;
    cpt::bf16* ov = out + ((static_cast<size_t>(n) * P + py) * P + px) * C + c0 + v * 8;
    const int b1 = min(B, static_cast<int>(blockIdx.z + 1) * cpb);
    for (int b = blockIdx.z * cpb; b < b1; b += Copies) {
      const cpt::bf16* fb[Copies];
      float acc[Copies][8];
#pragma unroll
      for (int u = 0; u < Copies; ++u) {
        fb[u] = fv + min(b + u, b1 - 1) * map;  // a copy past b1 reloads the last
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[u][i] = 0.f;
      }
      for (int k = 0; k < ny; ++k) {
        const int ro = yrows[k] * W * C;
        const float wy = yw[k];
#pragma unroll 4
        for (int j = 0; j < nx; ++j) {
          const float w = wy * xwp[j];
          const int o = ro + xr[j] * C;
          uint4 f[Copies];
#pragma unroll
          for (int u = 0; u < Copies; ++u) f[u] = __ldg(reinterpret_cast<const uint4*>(fb[u] + o));
#pragma unroll
          for (int u = 0; u < Copies; ++u) axpy8(acc[u], w, f[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < Copies; ++u) {
        if (b + u < b1) {
          uint4 res;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            h[i] = __floats2bfloat162_rn(acc[u][2 * i], acc[u][2 * i + 1]);
          }
          __stcs(reinterpret_cast<uint4*>(ov + (b + u) * out_copy), res);
        }
      }
    }
  }
}

}  // namespace

// feats [B, H, W, C] bf16 (C % 8 == 0, 16-byte aligned), rois [N, 4] f32
// xyxy in image coordinates, out [B, N, P, P, C] bf16; P < 256,
// N <= 65535.
CPT_EXPORT int cpt_roi_align(const void* feats, const void* rois, void* out, int B, int H,
                             int W, int C, int N, int P, float spatial_scale,
                             int sampling, int max_sampling, void* stream) {
  if (P >= kThreads || N > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tab = 2 * (sampling > 0 ? sampling : max_sampling);
  const size_t smem = (2 * static_cast<size_t>(P + 1) * tab + P) * 4;
  // 128 channels a block where the copies give it enough outputs, else
  // all of them (a block's tables serve B x P x slice / 8 vectors)
  const int slice = static_cast<long long>(B) * P * kSliceChannels / 8 >= 4 * kThreads
                        ? min(C, kSliceChannels) : C;
  const long long blocks = static_cast<long long>(P) * ((C + slice - 1) / slice) * N;
  int groups = static_cast<int>(
      min(static_cast<long long>((B + 1) / 2), (kGridBlocks + blocks - 1) / blocks));
  groups = min(max(groups, 1), 65535);
  const int cpb = (B + groups - 1) / groups;  // copies a block
  groups = (B + cpb - 1) / cpb;
  const dim3 grid(P * ((C + slice - 1) / slice), N, groups);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cpt::bf16* f = static_cast<const cpt::bf16*>(feats);
  const float* r = static_cast<const float*>(rois);
  cpt::bf16* o = static_cast<cpt::bf16*>(out);
  cudaError_t err;
  if (B == 1) {
    err = cudaFuncSetAttribute(roi_align_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    roi_align_kernel<1><<<grid, kThreads, smem, st>>>(f, r, o, B, H, W, C, N, P, spatial_scale,
                                                      sampling, max_sampling, slice, tab, cpb);
  } else {
    err = cudaFuncSetAttribute(roi_align_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    roi_align_kernel<2><<<grid, kThreads, smem, st>>>(f, r, o, B, H, W, C, N, P, spatial_scale,
                                                      sampling, max_sampling, slice, tab, cpb);
  }
  return cpt::launch_status();
}
