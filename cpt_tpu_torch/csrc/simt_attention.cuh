// The CUDA-core attention forward for the head dims the tensor-core tile
// (mma_attention.cuh) does not take: a head dim that is not a multiple of 8
// (no 16-byte row loads) or one over 256 (hidden 512 over one head). It
// replaces the same TPU kernels as the tile does, with the same numerics in
// both modes (mma_attention.cuh's Mode): f32 scores, f32 softmax in log2
// units (one ex2 a probability), p rounded to bf16 before P.V (kCore:
// normalised first; kFlash: unnormalised, o divided by l at the end), f32
// accumulation. Arguments are mma_attention.cuh's Args; element loads only,
// so any head dim and any row stride.
//
// Design (simple first): a block of 4 warps owns one query row of one
// (batch, head), that row of Q staged in shared memory as f32. Pass 1: warp w
// scores keys w, w + 4, ... (each a warp-wide dot product over d, lanes
// strided over d, then a shuffle sum) and keeps an online max and sum; the
// four warps' pairs are merged. Pass 2 walks the keys in chunks of 128: the
// warps score them again into p (shared memory), then each thread adds
// p_j v_j for its columns (c = thread, thread + 128, ...) over the chunk,
// its accumulators in shared memory. No shared memory grows with S.
//
// What bounds it: the issue rate of the dot products' FMAs and shuffles and
// the latency of the key rows' loads (each block reads its sequence's K and V
// twice, from L2 after the first block): it is 10-100x off the tile's rate
// and takes only the head dims that no model of the repo uses.
#pragma once

#include "mma_attention.cuh"

namespace cpt {
namespace simt_attn {

namespace ma = cpt::mma_attn;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // keys scored per round of pass 2

// Shared memory of a block: Q's row and the accumulators (f32, d each), the
// chunk's p, the warps' (max, sum) pairs
inline int smem_bytes(int d) { return (2 * d + kChunk + 2 * kWarps) * 4; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int MODE>
__device__ __forceinline__ void attention_row(const ma::Args& a) {
  extern __shared__ float sh[];
  const int d = a.d, S = a.S;
  float* qs = sh;
  float* os = qs + d;
  float* ps = os + d;
  float* red = ps + kChunk;
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qrow = a.q + b * a.sq[0] + h * a.sq[1] + qi * a.sq[2];
  const bf16* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const bf16* vb = a.v + b * a.sv[0] + h * a.sv[1];
  for (int c = threadIdx.x; c < d; c += kThreads) {
    qs[c] = __bfloat162float(qrow[c]);
    os[c] = 0.f;
  }
  __syncthreads();
  const float scale2 = a.scale * ma::kLog2e;
  const bf16* brow = nullptr;  // kFlash: this query's bias row
  const float* kbias = nullptr;  // kCore: the sequence's key bias
  if (a.bias != nullptr) {
    if (MODE == ma::kFlash)
      brow = static_cast<const bf16*>(a.bias) + b * a.sbias[0] + h * a.sbias[1] +
             qi * a.sbias[2];
    else
      kbias = static_cast<const float*>(a.bias) + b * a.sbias[0];
  }
  // key j's score in log2 units, on every lane of the calling warp
  auto score = [&](int j) {
    const bf16* kr = kb + j * a.sk[2];
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc = fmaf(qs[c], __bfloat162float(kr[c]), acc);
    acc = warp_sum(acc);
    if (MODE == ma::kFlash)
      return (acc + (brow ? __bfloat162float(brow[j]) : 0.f)) * scale2;
    return fmaf(acc, scale2, kbias ? kbias[j] * ma::kLog2e : 0.f);
  };

  // pass 1: the row's max and sum (online within a warp, merged across)
  float m = -INFINITY, l = 0.f;
  for (int j = warp; j < S; j += kWarps) {
    const float x = score(j);
    const float m_new = fmaxf(m, x);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // every score -inf so far
    l = l * ma::fast_exp2(m - m_use) + ma::fast_exp2(x - m_use);
    m = m_new;
  }
  if (lane == 0) {
    red[2 * warp] = m;
    red[2 * warp + 1] = l;
  }
  __syncthreads();
  m = -INFINITY;
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[2 * w]);
  const float m_use = m == -INFINITY ? 0.f : m;
  l = 0.f;
  for (int w = 0; w < kWarps; ++w) l += red[2 * w + 1] * ma::fast_exp2(red[2 * w] - m_use);
  const float il = MODE == ma::kCore ? 1.f / l : 1.f;

  // pass 2: p of each chunk of keys, then o += p v
  for (int j0 = 0; j0 < S; j0 += kChunk) {
    const int n = min(kChunk, S - j0);
    for (int jj = warp; jj < n; jj += kWarps) {
      const float p = ma::fast_exp2(score(j0 + jj) - m_use) * il;
      if (lane == 0) ps[jj] = round_bf16(p);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float acc = os[c];
      for (int jj = 0; jj < n; ++jj)
        acc = fmaf(ps[jj], __bfloat162float(vb[(j0 + jj) * a.sv[2] + c]), acc);
      os[c] = acc;
    }
    __syncthreads();
  }

  const float inv = MODE == ma::kFlash && l != 0.f ? 1.f / l : 1.f;
  bf16* orow = a.out + b * a.so[0] + h * a.so[1] + qi * a.so[2];
  for (int c = threadIdx.x; c < d; c += kThreads) orow[c] = __float2bfloat16(os[c] * inv);
  if (MODE == ma::kFlash && a.m_out != nullptr && threadIdx.x == 0) {
    const long long at = (static_cast<long long>(b) * a.H + h) * S + qi;
    a.m_out[at] = m == -INFINITY ? 0.f : m * ma::kLn2;
    a.l_out[at] = l;
  }
}

// Launch kernel (a __global__ wrapper of attention_row, or one of the
// backward's, with its own argument struct A) over (S, heads, batch) blocks
// of kThreads with `smem` bytes of shared memory.
template <class Kernel, class A>
int launch(Kernel kernel, const A& a, int B, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.S, a.H, B), kThreads, smem, stream>>>(a);
  return launch_status();
}

}  // namespace simt_attn
}  // namespace cpt
