// The bf16 GEMM that K3 (fused attention block) and K4 (fused FFN block)
// share: C[M, N] = A[M, K] . B[K, N], A row-major (K-major), B the row-major
// [K, N] weight (MN-major), f32 accumulation, with three epilogues:
//   (a) + bias                              -> bf16   (K3 QKV projection)
//   (b) + bias, then erf-gelu or tanh-gelu  -> bf16   (K4 first product)
//   (c) + bias + residual, then LayerNorm over the whole row -> bf16
//       (K3 output projection, K4 second product)
//
// Replaces the matmuls inside cpt_tpu/ops/fused_ffn.py::_ffn_kernel and
// cpt_tpu/ops/fused_attention.py::_attn_kernel, which kept every
// intermediate in VMEM. Here the [M, 3H] QKV and the [M, F] intermediate make
// one bf16 round trip through device memory each, on purpose: at the scoring
// batch (M = 16 x 120 = 1920) the [M, 3072] intermediate is 11.8 MB, written
// and read once (~7 us at HBM rate, and it fits the 50 MB L2), while keeping
// it on chip would need a [BM, 768] f32 accumulator across the F loop in
// every block, which leaves 15-30 blocks for 132 SMs.
//
// What bounds it: tensor-core operations. K4 at M = 960 is 9.06 GFLOP
// (9.2 us at 989 TFLOP/s) against 12.4 MB (3.7 us at 3.35 TB/s); at M = 1920
// 18.1 GFLOP (18.3 us). So the design feeds the tensor cores:
//   * Mainloop: TMA (cp.async.bulk.tensor.2d, 128-byte swizzle) loads 64-deep
//     k tiles of A (BM x 64, K-major) and B (64 x 128, as two 64-column boxes,
//     MN-major) into a ring of shared-memory stages, each with a full and an
//     empty mbarrier. One producer warp issues the loads; consumer
//     warpgroups run wgmma.mma_async m64n128k16 (bf16 -> f32) on shared-memory
//     descriptors, B through the instruction's transpose bit, so the weight
//     is read as it lies (no per-call transpose). A consumer keeps one wgmma
//     group in flight and releases a stage when the group that read it is
//     done. TMA zero-fills the ragged M and K edges (K = 72 is one full and
//     one partial tile); the epilogues mask the stores.
//   * (a)/(b): 128 x 128 block tiles, two consumer warpgroups of 64 rows.
//     128 x 128 against 128 x 256 at M = 1920: N = 3072 gives 360 tiles (at
//     most 3 a SM against an average of 2.73) against 180 (at most 2 of
//     twice the size: 4 against 2.73); N = 2304 gives 270 (3 against 2.05)
//     against 135 (4 against 2.05). The smaller tile balances better at both
//     and keeps 64 accumulators a thread. Bias and activation are applied in
//     registers on the accumulator fragments, then the tile is staged in
//     shared memory and stored 16 bytes a thread.
//   * (c), the LN-GEMM: a thread-block cluster of N / 128 blocks (6 at
//     N = 768, 8 at 1024, the portable limit) owns the same 64 rows, each
//     block one 128-column slice (one consumer warpgroup, m64n128). At
//     M = 1920, N = 768 that is 30 x 6 = 180 blocks, two resident a SM, where
//     the first version gave 120 blocks that each streamed all of W. After
//     the mainloop each block adds bias and residual in f32, writes its
//     per-row partial sums to shared memory, and the cluster exchanges them
//     through distributed shared memory (mapa + ld.shared::cluster, summed in
//     rank order, so every block forms the same mean); the same again for
//     sum((y - mean)^2), which keeps E[(y - mean)^2] exactly. A last cluster
//     barrier keeps every block alive until its peers have read it.
// Tensor maps are encoded per call on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links no -lcuda)
// and passed as __grid_constant__ parameters; the PTX pieces are in
// hopper.cuh. The wrapper requires
// K % 8 == 0 and N % 8 == 0 (16-byte global strides for TMA).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace cpt::sm90;

enum Act { kNone = 0, kGeluErf = 1, kGeluTanh = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGeluErf) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if (act == kGeluTanh) {
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + tanhf(u));
  }
  return v;
}

// Ring depths and residency: (a)/(b) 3 stages of 32 KB and two blocks a SM,
// so that one block's epilogue and ring fill overlap the other's mainloop
// (at K = 768 a tile is only 12 k steps); the LN-GEMM 4 stages of 24 KB and
// two blocks a SM. Both were the faster of the depths tried on the card
// (4 stages and one block for (a)/(b); 6 and one, 3 and three for the LN-GEMM).
constexpr int kActStages = 3, kActMinBlocks = 2;
constexpr int kLnStages = 4, kLnMinBlocks = 2;

constexpr int kBK = 64;                  // k depth of a stage: one 128-byte swizzle row
constexpr int kWgRows = 64;              // rows of one consumer warpgroup (wgmma m64)
constexpr int kBN = 128;                 // columns of a block tile (wgmma n128)
constexpr int kABytesPerWg = kWgRows * kBK * 2;       // 8 KB
constexpr int kBBoxBytes = kBK * 64 * 2;              // one 64 x 64 box of B: 8 KB
constexpr int kBBytes = 2 * kBBoxBytes;               // 16 KB
constexpr int kPitch = kBN + 8;          // staging pitch in bf16: 272 bytes, conflict-free

template <int WGS, int STAGES>
struct Ring {
  static constexpr int kABytes = WGS * kABytesPerWg;
  static constexpr int kStageBytes = kABytes + kBBytes;           // a multiple of 1024
  static constexpr int kBarOffset = STAGES * kStageBytes;
  static constexpr int kRedOffset = kBarOffset + 2 * 8 * STAGES;  // LN partials
  static constexpr int kSmemBytes = kRedOffset + 2 * kWgRows * 4 + 1024;  // + alignment
  static constexpr int kThreads = WGS * 128 + 32;                 // + the producer warp
};

// Descriptor offsets (bytes). A, K-major, 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1024 bytes apart (SBO); LBO is not read for a swizzled
// K-major operand; a k16 step moves the start 32 bytes along the swizzled
// row. B, MN-major, 128-byte swizzle (canonical layout ((8,8,m),(8,k)) :
// ((1,8,LBO),(64,SBO)) in bf16): each k row of a box holds 64 columns in 128
// bytes; 8-row k groups lie 1024 bytes apart (SBO) and the two 64-column
// boxes 8 KB apart (LBO); a k16 step moves the start 16 rows, 2048 bytes.
constexpr unsigned kDescASbo = 1024, kDescBLbo = kBBoxBytes, kDescBSbo = 1024;

// ---- the shared mainloop -----------------------------------------------------

template <int WGS, int STAGES>
__device__ __forceinline__ void init_ring(unsigned base) {
  typedef Ring<WGS, STAGES> R;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(base + R::kBarOffset + 8 * s, 1);                    // full: the producer
      mbar_init(base + R::kBarOffset + 8 * (STAGES + s), 4 * WGS);  // empty: each warp
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The producer (one thread): the k tiles of rows m0.. of A and columns
// n0..n0+127 of B into the ring.
template <int WGS, int STAGES>
__device__ __forceinline__ void produce(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                        unsigned base, int nk, int m0, int n0) {
  typedef Ring<WGS, STAGES> R;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    if (kt >= STAGES) mbar_wait(base + R::kBarOffset + 8 * (STAGES + s), ((kt / STAGES) + 1) & 1);
    const unsigned stage = base + s * R::kStageBytes;
    const unsigned full = base + R::kBarOffset + 8 * s;
    mbar_expect_tx(full, R::kABytes + kBBytes);
    tma_load_2d(stage, map_a, full, kt * kBK, m0);
    tma_load_2d(stage + R::kABytes, map_b, full, n0, kt * kBK);
    tma_load_2d(stage + R::kABytes + kBBoxBytes, map_b, full, n0 + 64, kt * kBK);
  }
}

// A consumer warpgroup `wg`: acc (its 64 x 128 tile) = A rows . B over all k.
template <int WGS, int STAGES>
__device__ __forceinline__ void consume(float (&acc)[64], unsigned base, int nk, int wg) {
  typedef Ring<WGS, STAGES> R;
  const bool leader = threadIdx.x % 32 == 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(base + R::kBarOffset + 8 * s, (kt / STAGES) & 1);
    __syncwarp();
    const unsigned stage = base + s * R::kStageBytes;
    const uint64_t da = smem_desc(stage + wg * kABytesPerWg, 16, kDescASbo);
    const uint64_t db = smem_desc(stage + R::kABytes, kDescBLbo, kDescBSbo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n128k16(acc, da + 2 * kk, db + 128 * kk);  // +32 B of A, +2048 B of B
    wgmma_commit();
    wgmma_wait<1>();   // the group that read the previous stage is done
    fence_acc(acc);
    if (kt > 0 && leader)
      mbar_arrive(base + R::kBarOffset + 8 * (STAGES + (kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// Accumulator fragment of wgmma m64nN (f32): thread t of the warpgroup holds,
// for j in 0..N/8-1, rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns
// 8 j + 2 (t % 4) and + 1: acc[4j], acc[4j+1] (row r), acc[4j+2], acc[4j+3]
// (row r + 8).

// Stage the warpgroup's bf16 64 x 128 tile (rows of kPitch) and store the
// rows < M, columns < N of it to out[m0.., n0..] 16 bytes a thread. The
// caller has synchronised the warpgroup between the writes and this call.
__device__ __forceinline__ void store_tile(const cpt::bf16* tile, cpt::bf16* out, int m0, int n0,
                                           int M, int N) {
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < kWgRows * kBN / 8 / 128; ++i) {
    const int idx = t + 128 * i;
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    if (m0 + r < M && n0 + c < N)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * kPitch + c);
  }
}

__device__ __forceinline__ void put_pair(cpt::bf16* tile, int r, int c, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(tile + r * kPitch + c) = __floats2bfloat162_rn(a, b);
}

// ---- epilogues (a)/(b): 128 x 128 tiles ---------------------------------

__global__ void __launch_bounds__(Ring<2, kActStages>::kThreads, kActMinBlocks)
    wgmma_bias_act_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          const float* __restrict__ bias, cpt::bf16* __restrict__ C, int M,
                          int N, int K, int act) {
  constexpr int WGS = 2, STAGES = kActStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const unsigned base = cpt::smem_u32(smem);
  const int nk = (K + kBK - 1) / kBK;
  const int m0 = blockIdx.y * WGS * kWgRows, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring<WGS, STAGES>(base);
  if (warp == 4 * WGS) {
    if (lane == 0) produce<WGS, STAGES>(&map_a, &map_b, base, nk, m0, n0);
    return;
  }
  const int wg = warp / 4;
  float acc[64];
  consume<WGS, STAGES>(acc, base, nk, wg);

  named_barrier(1, WGS * 128);   // every consumer is done reading the ring
  cpt::bf16* tile = reinterpret_cast<cpt::bf16*>(smem) + wg * kWgRows * kPitch;
  const int r = (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const bool in = n0 + c < N;   // N % 8 == 0: both columns or neither
    const float b0 = in ? bias[n0 + c] : 0.f, b1 = in ? bias[n0 + c + 1] : 0.f;
    put_pair(tile, r, c, activate(acc[4 * j] + b0, act), activate(acc[4 * j + 1] + b1, act));
    put_pair(tile, r + 8, c, activate(acc[4 * j + 2] + b0, act),
             activate(acc[4 * j + 3] + b1, act));
  }
  named_barrier(2 + wg, 128);
  store_tile(tile, C, m0 + wg * kWgRows, n0, M, N);
}

// ---- epilogue (c): the LN-GEMM on a cluster of N / 128 blocks ---------------

__global__ void __launch_bounds__(Ring<1, kLnStages>::kThreads, kLnMinBlocks)
    wgmma_residual_ln_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_b,
                             const float* __restrict__ bias,
                             const cpt::bf16* __restrict__ residual,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             cpt::bf16* __restrict__ out, int M, int N, int K, float eps) {
  constexpr int STAGES = kLnStages;
  typedef Ring<1, STAGES> R;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const unsigned base = cpt::smem_u32(smem);
  const unsigned red_sum = base + R::kRedOffset, red_sq = red_sum + kWgRows * 4;
  float* sums = reinterpret_cast<float*>(smem + R::kRedOffset);
  float* sqs = sums + kWgRows;
  const int nk = (K + kBK - 1) / kBK;
  const int m0 = blockIdx.y * kWgRows, n0 = blockIdx.x * kBN;  // the cluster spans x
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool consumer = warp < 4;
  init_ring<1, STAGES>(base);

  const int r = warp * 16 + lane / 4;   // this thread's rows r and r + 8 (consumers)
  float acc[64];
  if (consumer) {
    // the residual of this thread's fragment, loaded before the mainloop
    unsigned res[2][kBN / 8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int gr = m0 + r + 8 * h, gc = n0 + 8 * j + 2 * (lane % 4);
        res[h][j] = gr < M ? *reinterpret_cast<const unsigned*>(
                                 residual + static_cast<size_t>(gr) * N + gc)
                           : 0u;
      }
    consume<1, STAGES>(acc, base, nk, 0);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      const float b0 = bias[c], b1 = bias[c + 1];
      const float2 x0 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&res[0][j]));
      const float2 x1 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&res[1][j]));
      acc[4 * j] += b0 + x0.x;
      acc[4 * j + 1] += b1 + x0.y;
      acc[4 * j + 2] += b0 + x1.x;
      acc[4 * j + 3] += b1 + x1.y;
      s0 += acc[4 * j] + acc[4 * j + 1];
      s1 += acc[4 * j + 2] + acc[4 * j + 3];
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (lane % 4 == 0) {
      sums[r] = s0;
      sums[r + 8] = s1;
    }
  } else if (lane == 0) {
    produce<1, STAGES>(&map_a, &map_b, base, nk, m0, n0);
  }
  __syncwarp();
  cluster_sync();   // every block's row sums are in its shared memory

  const unsigned nrank = cluster_size();
  const float inv_n = 1.f / static_cast<float>(N);
  float mu0 = 0.f, mu1 = 0.f;
  if (consumer) {
    for (unsigned q = 0; q < nrank; ++q) {
      mu0 += ld_cluster_f32(red_sum + 4 * r, q);
      mu1 += ld_cluster_f32(red_sum + 4 * (r + 8), q);
    }
    mu0 *= inv_n;
    mu1 *= inv_n;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float d0 = acc[4 * j] - mu0, d1 = acc[4 * j + 1] - mu0;
      const float d2 = acc[4 * j + 2] - mu1, d3 = acc[4 * j + 3] - mu1;
      q0 += d0 * d0 + d1 * d1;
      q1 += d2 * d2 + d3 * d3;
    }
    q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
    q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
    if (lane % 4 == 0) {
      sqs[r] = q0;
      sqs[r + 8] = q1;
    }
  }
  __syncwarp();
  cluster_sync();   // every block's sums of squares are in its shared memory

  if (consumer) {
    float v0 = 0.f, v1 = 0.f;
    for (unsigned q = 0; q < nrank; ++q) {
      v0 += ld_cluster_f32(red_sq + 4 * r, q);
      v1 += ld_cluster_f32(red_sq + 4 * (r + 8), q);
    }
    cluster_arrive();   // done reading the peers; wait for them before exit
    const float rstd0 = rsqrtf(v0 * inv_n + eps), rstd1 = rsqrtf(v1 * inv_n + eps);
    cpt::bf16* tile = reinterpret_cast<cpt::bf16*>(smem);   // the ring is free
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float g0 = gamma[n0 + c], g1 = gamma[n0 + c + 1];
      const float e0 = beta[n0 + c], e1 = beta[n0 + c + 1];
      put_pair(tile, r, c, (acc[4 * j] - mu0) * rstd0 * g0 + e0,
               (acc[4 * j + 1] - mu0) * rstd0 * g1 + e1);
      put_pair(tile, r + 8, c, (acc[4 * j + 2] - mu1) * rstd1 * g0 + e0,
               (acc[4 * j + 3] - mu1) * rstd1 * g1 + e1);
    }
    named_barrier(1, 128);
    store_tile(tile, out, m0, n0, M, N);
  } else {
    cluster_arrive();
  }
  cluster_wait();
}

}  // namespace

// Epilogues (a)/(b): act 0 = none, 1 = erf-gelu, 2 = tanh-gelu.
// a [M, K], b [K, N] bf16; bias [N] f32; c [M, N] bf16.
CPT_EXPORT int cpt_gemm_bias_act(const void* a, const void* b, const void* bias, void* c,
                                 int M, int N, int K, int act, void* stream) {
  typedef Ring<2, kActStages> R;
  if (M <= 0) return 0;
  CUtensorMap map_a, map_b;
  int err = encode_map(&map_a, a, M, K, 2 * kWgRows);
  if (err == 0) err = encode_map(&map_b, b, K, N, kBK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(wgmma_bias_act_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       R::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kBN - 1) / kBN, (M + 2 * kWgRows - 1) / (2 * kWgRows));
  wgmma_bias_act_kernel<<<grid, R::kThreads, R::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<const float*>(bias), static_cast<cpt::bf16*>(c), M, N, K, act);
  return cpt::launch_status();
}

// Epilogue (c): out = LayerNorm(a . b + bias + residual) * gamma + beta over
// rows of N = 128 * nf columns (nf in 1..8), on clusters of nf blocks.
// Returns cudaErrorInvalidValue for any other N, and the launch's error
// where the card refuses the cluster.
CPT_EXPORT int cpt_gemm_bias_residual_ln(const void* a, const void* b, const void* bias,
                                         const void* residual, const void* gamma,
                                         const void* beta, void* out, int M, int N, int K,
                                         float eps, void* stream) {
  typedef Ring<1, kLnStages> R;
  if (N % kBN != 0 || N / kBN < 1 || N / kBN > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return 0;
  CUtensorMap map_a, map_b;
  int err = encode_map(&map_a, a, M, K, kWgRows);
  if (err == 0) err = encode_map(&map_b, b, K, N, kBK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(wgmma_residual_ln_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       R::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / kBN, (M + kWgRows - 1) / kWgRows);
  cfg.blockDim = dim3(R::kThreads);
  cfg.dynamicSmemBytes = R::kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N / kBN;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wgmma_residual_ln_kernel, map_a, map_b,
                         static_cast<const float*>(bias),
                         static_cast<const cpt::bf16*>(residual),
                         static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<cpt::bf16*>(out), M, N, K, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return cpt::launch_status();
}
