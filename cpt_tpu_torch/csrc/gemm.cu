// Tiled bf16 GEMM on the tensor cores, shared by K3 (fused attention) and
// K4 (fused FFN): C[M, N] = A[M, K] . B[K, N], both row-major bf16, f32
// accumulation, with three epilogues:
//   (a) + bias                              -> bf16   (K3 QKV projection)
//   (b) + bias, then erf-gelu or tanh-gelu  -> bf16   (K4 first product)
//   (c) + bias + residual, then LayerNorm over the whole row -> bf16
//       (K3 output projection, K4 second product)
//
// Replaces the matmuls inside cpt_tpu/ops/fused_ffn.py::_ffn_kernel and
// cpt_tpu/ops/fused_attention.py::_attn_kernel, which kept every
// intermediate in VMEM. Here the [M, 3H] QKV and [M, F] intermediates make
// one bf16 round trip through device memory each (a later change fuses them).
//
// What bounds it: at scoring shapes (M = 16 * 120, K and N 768..3072) the
// products are tensor-core bound once the tiles are fed; this first version
// is bound by its single-buffered shared-memory tiles (no cp.async or TMA
// pipeline, no wgmma yet). Tensor cores are reached through nvcuda::wmma
// (mma.sync, 16x16x16 bf16 fragments). Tiles are loaded with 16-byte
// vectors, zero-filled at the ragged M edge, so M is free; the wrapper
// requires K % 8 == 0 and N % 8 == 0 (16-byte rows).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, cpt::bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, cpt::bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

enum Act { kNone = 0, kGeluErf = 1, kGeluTanh = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGeluErf) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if (act == kGeluTanh) {
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + tanhf(u));
  }
  return v;
}

// Copy a rows x cols bf16 tile (cols % 8 == 0) from a row-major matrix with
// `ld` columns into shared memory with leading dimension `lds`, zero-filling
// rows >= row_lim and columns >= col_lim.
__device__ __forceinline__ void load_tile(cpt::bf16* dst, int lds, const cpt::bf16* src,
                                          int ld, int r0, int c0, int rows, int cols,
                                          int row_lim, int col_lim) {
  const int vec_per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row;
    const int c = (i % vec_per_row) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < row_lim && c0 + c < col_lim)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * ld + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * lds + c) = v;
  }
}

// Epilogues (a) and (b): 64x64 block tile, 4 warps of 32x32.
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLdA = kBK + 8, kLdB = kBN + 8, kLdC = kBN + 4;
constexpr int kTileBytes = (kBM * kLdA + kBK * kLdB) * 2;
constexpr int kOutBytes = kBM * kLdC * 4;
constexpr int kSmemBytes = kTileBytes > kOutBytes ? kTileBytes : kOutBytes;

__global__ void __launch_bounds__(128)
    gemm_bias_act_kernel(const cpt::bf16* __restrict__ A, const cpt::bf16* __restrict__ B,
                         const float* __restrict__ bias, cpt::bf16* __restrict__ C, int M,
                         int N, int K, int act) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  cpt::bf16* As = reinterpret_cast<cpt::bf16*>(smem);
  cpt::bf16* Bs = As + kBM * kLdA;
  float* Cs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_tile(As, kLdA, A, K, m0, k0, kBM, kBK, M, K);
    load_tile(Bs, kLdB, B, N, k0, n0, kBK, kBN, K, N);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[2];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdB + wn * 32 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += blockDim.x) {
    const int r = i / kBN, c = i % kBN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N)
      C[static_cast<size_t>(gr) * N + gc] =
          __float2bfloat16(activate(Cs[r * kLdC + c] + bias[gc], act));
  }
}

// Epilogue (c): one block owns 16 whole rows (N = 8 warps * NF * 16 columns),
// so the row LayerNorm needs no second pass.
constexpr int kLnBM = 16, kLnBK = 32, kLnThreads = 256;

template <int NF>
struct LnShape {
  static constexpr int N = 8 * NF * 16;
  static constexpr int LdA = kLnBK + 8;
  static constexpr int LdB = N + 8;
  static constexpr int LdC = N + 4;
  static constexpr int TileBytes = (kLnBM * LdA + kLnBK * LdB) * 2;
  static constexpr int OutBytes = kLnBM * LdC * 4;
  static constexpr int SmemBytes = TileBytes > OutBytes ? TileBytes : OutBytes;
};

template <int NF>
__global__ void __launch_bounds__(kLnThreads)
    gemm_residual_ln_kernel(const cpt::bf16* __restrict__ A, const cpt::bf16* __restrict__ B,
                            const float* __restrict__ bias,
                            const cpt::bf16* __restrict__ residual,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            cpt::bf16* __restrict__ out, int M, int K, float eps) {
  typedef LnShape<NF> S;
  constexpr int N = S::N;
  extern __shared__ __align__(128) unsigned char smem[];
  cpt::bf16* As = reinterpret_cast<cpt::bf16*>(smem);
  cpt::bf16* Bs = As + kLnBM * S::LdA;
  float* Cs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kLnBM;
  const int ncol0 = warp * NF * 16;

  FragC acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int k0 = 0; k0 < K; k0 += kLnBK) {
    load_tile(As, S::LdA, A, K, m0, k0, kLnBM, kLnBK, M, K);
    load_tile(Bs, S::LdB, B, N, k0, 0, kLnBK, N, K, N);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kLnBK; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, As + kk, S::LdA);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        FragB b;
        wmma::load_matrix_sync(b, Bs + kk * S::LdB + ncol0 + f * 16, S::LdB);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(Cs + ncol0 + f * 16, acc[f], S::LdC, wmma::mem_row_major);
  __syncthreads();

  const float inv_n = 1.f / static_cast<float>(N);
  for (int r = warp; r < kLnBM; r += kLnThreads / 32) {
    const int gr = m0 + r;
    if (gr >= M) continue;
    float* row = Cs + r * S::LdC;
    const cpt::bf16* res = residual + static_cast<size_t>(gr) * N;
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float y = row[c] + bias[c] + __bfloat162float(res[c]);
      row[c] = y;
      sum += y;
    }
    const float mu = cpt::warp_sum(sum) * inv_n;
    float sq = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float d = row[c] - mu;
      sq += d * d;
    }
    const float rstd = rsqrtf(cpt::warp_sum(sq) * inv_n + eps);
    cpt::bf16* o = out + static_cast<size_t>(gr) * N;
    for (int c = lane; c < N; c += 32)
      o[c] = __float2bfloat16((row[c] - mu) * rstd * gamma[c] + beta[c]);
  }
}

template <int NF>
int launch_residual_ln(const void* a, const void* b, const void* bias, const void* residual,
                       const void* gamma, const void* beta, void* out, int M, int K,
                       float eps, cudaStream_t stream) {
  const int smem = LnShape<NF>::SmemBytes;
  cudaError_t err = cudaFuncSetAttribute(gemm_residual_ln_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + kLnBM - 1) / kLnBM;
  gemm_residual_ln_kernel<NF><<<blocks, kLnThreads, smem, stream>>>(
      static_cast<const cpt::bf16*>(a), static_cast<const cpt::bf16*>(b),
      static_cast<const float*>(bias), static_cast<const cpt::bf16*>(residual),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<cpt::bf16*>(out), M, K, eps);
  return cpt::launch_status();
}

}  // namespace

// Epilogues (a)/(b): act 0 = none, 1 = erf-gelu, 2 = tanh-gelu.
// a [M, K], b [K, N] bf16; bias [N] f32; c [M, N] bf16.
CPT_EXPORT int cpt_gemm_bias_act(const void* a, const void* b, const void* bias, void* c,
                                 int M, int N, int K, int act, void* stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_bias_act_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const cpt::bf16*>(a), static_cast<const cpt::bf16*>(b),
      static_cast<const float*>(bias), static_cast<cpt::bf16*>(c), M, N, K, act);
  return cpt::launch_status();
}

// Epilogue (c): out = LayerNorm(a . b + bias + residual) * gamma + beta over
// rows of N = 128 * nf columns (nf in 1..8). Returns cudaErrorInvalidValue
// for any other N.
CPT_EXPORT int cpt_gemm_bias_residual_ln(const void* a, const void* b, const void* bias,
                                         const void* residual, const void* gamma,
                                         const void* beta, void* out, int M, int N, int K,
                                         float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (N / 128) {
    case 1: return launch_residual_ln<1>(a, b, bias, residual, gamma, beta, out, M, K, eps, s);
    case 2: return launch_residual_ln<2>(a, b, bias, residual, gamma, beta, out, M, K, eps, s);
    case 3: return launch_residual_ln<3>(a, b, bias, residual, gamma, beta, out, M, K, eps, s);
    case 4: return launch_residual_ln<4>(a, b, bias, residual, gamma, beta, out, M, K, eps, s);
    case 5: return launch_residual_ln<5>(a, b, bias, residual, gamma, beta, out, M, K, eps, s);
    case 6: return launch_residual_ln<6>(a, b, bias, residual, gamma, beta, out, M, K, eps, s);
    case 7: return launch_residual_ln<7>(a, b, bias, residual, gamma, beta, out, M, K, eps, s);
    case 8: return launch_residual_ln<8>(a, b, bias, residual, gamma, beta, out, M, K, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
