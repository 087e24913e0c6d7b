// K5: greedy NMS with static shapes over B independent problems,
// boxes [B, K, 4] f32 xyxy, scores [B, K] f32, valid [B, K] bool ->
// indices [B, max_out] int32, keep [B, max_out] bool.
//
// Replaces cpt_tpu/ops/nms_pallas.py::nms_pallas (_nms_kernel), which kept
// the whole greedy loop in VMEM so that no pick leaves the chip. Here one
// thread block owns one problem and keeps the loop on the SM: the boxes,
// their areas and the live scores sit in shared memory (24 bytes per box,
// 144 KB at the RPN's K = 6000, so the block opts in to more than 48 KB),
// and each pick is
//   1. a block-wide argmax over (score, index) pairs: each thread scans its
//      strided share (ascending indices, strict '>' keeps the first), warps
//      combine with shuffles, warp 0 combines the warps; ties go to the
//      lower index, as jnp.argmax / torch.argmax do;
//   2. one thread writes the slot, and every thread suppresses its share
//      whose IoU with the pick is strictly greater than the threshold.
// The loop stops once nothing is live (score <= -5e9), leaving the rest of
// the output zero, which is what the plain version's remaining steps write.
//
// What bounds it: latency, not bytes or FLOPs. A pick is a dependent chain
// of a shared-memory scan, ~10 shuffles and three barriers; 300 picks at
// K = 6000 are ~6 elements per thread each. The plain PyTorch loop costs
// about ten launches per pick instead.
//
// The outputs are indices, so every decision must match the plain version
// bit for bit on the same f32 inputs: the IoU is written with the _rn
// intrinsics, which nvcc never contracts into FMAs, in the plain version's
// order of operations (and the library is not built with --use_fast_math).
// NaN scores or coordinates are not supported.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e10f;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float extent(float lo, float hi, float off) {
  return fmaxf(__fadd_rn(__fsub_rn(hi, lo), off), 0.f);
}

// (s, i) beats (bs, bi): higher score, or the same score at a lower index.
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ void warp_argmax(float* s, int* i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, *s, off);
    const int oi = __shfl_xor_sync(0xffffffffu, *i, off);
    if (beats(os, oi, *s, *i)) {
      *s = os;
      *i = oi;
    }
  }
}

__global__ void nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                           const unsigned char* __restrict__ valid, int* __restrict__ out_idx,
                           unsigned char* __restrict__ out_keep, int K, int max_out,
                           float thr, float off) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + K;
  float* x2 = y1 + K;
  float* y2 = x2 + K;
  float* area = y2 + K;
  float* live = area + K;
  __shared__ float red_s[kMaxThreads / 32];
  __shared__ int red_i[kMaxThreads / 32];
  __shared__ int s_pick, s_ok;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t b = blockIdx.x;
  boxes += b * K * 4;
  scores += b * K;
  valid += b * K;
  out_idx += b * max_out;
  out_keep += b * max_out;

  for (int j = tid; j < K; j += nt) {
    const float bx1 = boxes[4 * j], by1 = boxes[4 * j + 1];
    const float bx2 = boxes[4 * j + 2], by2 = boxes[4 * j + 3];
    x1[j] = bx1;
    y1[j] = by1;
    x2[j] = bx2;
    y2[j] = by2;
    area[j] = __fmul_rn(extent(bx1, bx2, off), extent(by1, by2, off));
    live[j] = valid[j] ? scores[j] : kNegInf;
  }
  for (int i = tid; i < max_out; i += nt) {
    out_idx[i] = 0;
    out_keep[i] = 0;
  }
  __syncthreads();

  for (int count = 0; count < max_out; ++count) {
    float bs = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int j = tid; j < K; j += nt) {
      if (live[j] > bs) {
        bs = live[j];
        bi = j;
      }
    }
    warp_argmax(&bs, &bi);
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < nwarps ? red_s[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? red_i[lane] : 0x7fffffff;
      warp_argmax(&bs, &bi);
      if (lane == 0) {
        s_pick = bi;
        s_ok = bs > kNegInf / 2;
      }
    }
    __syncthreads();
    if (!s_ok) break;  // block-uniform: nothing live, the rest stays zero
    const int pick = s_pick;
    if (tid == 0) {
      out_idx[count] = pick;
      out_keep[count] = 1;
    }
    const float px1 = x1[pick], py1 = y1[pick], px2 = x2[pick], py2 = y2[pick];
    const float parea = area[pick];
    for (int j = tid; j < K; j += nt) {
      const float iw = extent(fmaxf(px1, x1[j]), fminf(px2, x2[j]), off);
      const float ih = extent(fmaxf(py1, y1[j]), fminf(py2, y2[j]), off);
      const float inter = __fmul_rn(iw, ih);
      const float uni = fmaxf(__fsub_rn(__fadd_rn(parea, area[j]), inter), 1e-10f);
      if (j == pick || __fdiv_rn(inter, uni) > thr) live[j] = kNegInf;
    }
    __syncthreads();
  }
}

size_t nms_smem(int K) { return static_cast<size_t>(K) * 6 * sizeof(float); }

}  // namespace

// Dynamic shared memory (bytes) the kernel needs for K boxes; the wrapper
// checks it against what a Hopper block can opt in to.
CPT_EXPORT long long cpt_nms_smem_bytes(int K) { return static_cast<long long>(nms_smem(K)); }

// boxes [B, K, 4] f32, scores [B, K] f32, valid [B, K] bool (one byte),
// out_idx [B, max_out] int32, out_keep [B, max_out] bool; B, K, max_out > 0.
CPT_EXPORT int cpt_nms(const void* boxes, const void* scores, const void* valid, void* out_idx,
                       void* out_keep, int B, int K, int max_out, float iou_threshold,
                       float iou_offset, void* stream) {
  const size_t smem = nms_smem(K);
  cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = K < kMaxThreads ? (K + 31) / 32 * 32 : kMaxThreads;
  nms_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const unsigned char*>(valid), static_cast<int*>(out_idx),
      static_cast<unsigned char*>(out_keep), K, max_out, iou_threshold, iou_offset);
  return cpt::launch_status();
}
