// K7: the W8A8 BERT FFN of bench_int8.py's study,
//   out = LayerNorm(x + (hq . w2q) * (sh * s2) + b2),
//   h   = gelu((xq . w1q) * (sx * s1) + b1),
// with one dynamic scale per tm-row tile for x (sx) and one for the whole
// [tm, F] tile of h (sh), per-column weight scales s1, s2, erf gelu through
// the Abramowitz-Stegun polynomial, LayerNorm E[(y - mu)^2] in f32, and a bf16
// store.
//
// Replaces bench_int8.py::ffn_int8 (pallas_call :225, body kern :204-220). The
// TPU kernel held one 1024-row tile of x and its whole [tm, F] h in VMEM, so
// both tile maxima were in-kernel reductions. On Hopper a tile spans many
// blocks that run in no order, so each maximum is combined across them by
// atomics and read after a launch boundary, and h makes one f32 round trip
// through device memory. Seven launches on the caller's stream:
//   1. ffn_int8_absmax_kernel: max |x| of every tm-row tile (atomicMax on the
//      f32's bits: the values are >= 0, so their int order is their order);
//   2. ffn_int8_quantize_kernel<bf16>: xq = x quantized by its tile's scale,
//      one true division an element, int8 [M, H];
//   3. ffn_int8_transpose_kernel, twice: w1q [H, F] -> [F, H] and w2q [F, H]
//      -> [H, F]. wgmma takes s8 operands K-major only (no transpose bit),
//      and the weights arrive as the study's [K, N] matrices;
//   4. ffn_int8_gemm1_kernel: xq . w1q on the TMA / wgmma ring of gemm.cu
//      (one producer warp, two consumer warpgroups of m64n128k32 s8 -> s32,
//      128 x 128 tiles, 3 stages of 128-byte k, two blocks an SM), then
//      (acc * (sx * s1) + b1) and gelu; h is written in f32 and max |h| of
//      the block combined into its tm-tile's maximum by atomicMax (never a
//      block-local scale: a tile spans F / 128 x tm / 128 blocks);
//   5. ffn_int8_quantize_kernel<float>: hq = h quantized by its tile's scale;
//   6. ffn_int8_gemm2_ln_kernel: hq . w2q on the same ring (one consumer
//      warpgroup, 64 x 128 per block, 3 stages) on a thread-block cluster
//      of H / 128 blocks that own the same 64 rows, then acc * (sh * s2) + b2
//      + x and the row LayerNorm, its sums exchanged through distributed
//      shared memory as in gemm.cu's LN-GEMM, so no block stages more than
//      its 128 columns of w2q.
// Products are exact (|sum| <= 3072 * 127^2 < 2^31). Every f32 step before
// the LayerNorm mirrors the plain version's PyTorch order with unfused
// roundings (__fmul_rn, __fadd_rn, __fdiv_rn), so h and both quantizations
// match it bit for bit; only the LayerNorm's sums differ in order.
//
// What bounds it: the function's bound is its 4 * M * H * F int8 operations
// (154.6 G at the study's shape) against 1,979 TOP/s, 0.078 ms. This design
// moves h through device memory (201 MB written, read, and 50 MB of hq
// written and read at M = 16384, F = 3072) besides ~100 MB of x, xq and
// out: ~0.19 ms of HBM at 3.35 TB/s, its own floor. Keeping h on chip
// would take recomputing gemm1 inside gemm2 (1.5x the operations) or a
// [tm, F] tile per block; see PERF.md.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace cpt::sm90;

constexpr int kThreads = 256;            // the elementwise passes

__device__ __forceinline__ float tile_scale(const int* amax_bits) {
  return __fdiv_rn(fmaxf(__int_as_float(*amax_bits), 1e-8f), 127.f);
}

__device__ __forceinline__ int quant(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}

__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) |
         (static_cast<unsigned>(d) << 24);
}

// gelu(v) = 0.5 v (1 + erf(v / sqrt 2)), erf by Abramowitz-Stegun 7.1.26, in
// the plain version's operation order (ops/quant.py::gelu_poly).
__device__ __forceinline__ float gelu_poly(float v) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float z = __fmul_rn(v, 0.7071067811865476f);
  const float az = fabsf(z);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(p, az)));
  float poly = __fadd_rn(a4, __fmul_rn(t, a5));
  poly = __fadd_rn(a3, __fmul_rn(t, poly));
  poly = __fadd_rn(a2, __fmul_rn(t, poly));
  poly = __fadd_rn(a1, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  const float sign = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  const float erf = __fmul_rn(sign, __fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-az, az)))));
  return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.f, erf));
}

// ---- the elementwise passes ---------------------------------------------------

// 1. max |x| over kAbsRows rows per block into amax[row / tm].
constexpr int kAbsRows = 16;

__global__ void __launch_bounds__(kThreads)
    ffn_int8_absmax_kernel(const cpt::bf16* __restrict__ x, int* __restrict__ amax, int H,
                           int tm) {
  __shared__ float part[kThreads / 32];
  const int r0 = blockIdx.x * kAbsRows;
  const cpt::bf16* p = x + static_cast<size_t>(r0) * H;
  float m = 0.f;
  for (int i = threadIdx.x * 8; i < kAbsRows * H; i += kThreads * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h2[k]);
      m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  m = cpt::warp_max(m);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, part[i]);
    atomicMax(amax + r0 / tm, __float_as_int(m));
  }
}

__device__ __forceinline__ void load16(const cpt::bf16* p, float (&v)[16]) {
  const uint4 raw[2] = {reinterpret_cast<const uint4*>(p)[0],
                        reinterpret_cast<const uint4*>(p)[1]};
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float2 f = __bfloat1622float2(h2[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = reinterpret_cast<const float4*>(p)[k];
    v[4 * k] = a.x;
    v[4 * k + 1] = a.y;
    v[4 * k + 2] = a.z;
    v[4 * k + 3] = a.w;
  }
}

// 2. and 5. dst = src quantized by the scale of its tm-row tile (amax[row /
// tm]), 16 values a thread-step (all loads issued before the divisions);
// cols % 16 == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ffn_int8_quantize_kernel(const T* __restrict__ src, int8_t* __restrict__ dst,
                             const int* __restrict__ amax, int cols, int tm, long long n16) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n16;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long e = i * 16;
    float v[16];
    load16(src + e, v);
    const float s = tile_scale(amax + static_cast<int>(e / cols / tm));
    unsigned q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q[k] = pack4(quant(v[4 * k], s), quant(v[4 * k + 1], s), quant(v[4 * k + 2], s),
                   quant(v[4 * k + 3], s));
    *reinterpret_cast<uint4*>(dst + e) = make_uint4(q[0], q[1], q[2], q[3]);
  }
}

// 3. dst [C, R] = src [R, C] transposed, int8, 64 x 64 tiles; R, C % 64 == 0.
__global__ void __launch_bounds__(kThreads)
    ffn_int8_transpose_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst, int R,
                              int C) {
  __shared__ int8_t tile[64][64 + 4];
  const int r0 = blockIdx.y * 64, c0 = blockIdx.x * 64;
  const int row = threadIdx.x / 4, q = threadIdx.x % 4;   // one 16-byte chunk a thread
  const uint4 v =
      *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + row) * C + c0 + q * 16);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int k = 0; k < 16; ++k) tile[row][q * 16 + k] = b[k];
  __syncthreads();
  alignas(16) int8_t o[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = tile[q * 16 + k][row];   // dst row c0 + row
  *reinterpret_cast<uint4*>(dst + static_cast<size_t>(c0 + row) * R + r0 + q * 16) =
      *reinterpret_cast<const uint4*>(o);
}

// ---- the int8 ring: gemm.cu's producer / consumer mainloop on s8 tiles ------

constexpr int kBK = 128;                 // k depth of a stage: one 128-byte swizzle row
constexpr int kWgRows = 64;              // rows of one consumer warpgroup (wgmma m64)
constexpr int kBN = 128;                 // columns of a block tile (wgmma n128)
constexpr int kABytesPerWg = kWgRows * kBK;   // 8 KB
constexpr int kBBytes = kBN * kBK;            // 16 KB: 128 rows (n) of 128 k bytes
constexpr int kPitch = kBN + 8;          // LN staging pitch in bf16: conflict-free
// Ring depths and residency: gemm1 two consumer warpgroups (128 x 128
// tiles), 3 stages of 32 KB, two blocks an SM (96 registers); gemm2 one
// consumer warpgroup (64 rows a block), 3 stages of 24 KB, three blocks an
// SM (128 registers: its residual is loaded after the mainloop). Each was
// the fastest of the variants chip_variants.py timed on the H100 at the
// study's shape (PERF.md, section 6): gemm1 0.1716 ms against 0.1761-0.1766
// (2 stages), 0.2453 (4 stages, one block an SM) and 0.1884-0.2219 (one
// warpgroup, 3-4 blocks an SM); gemm2 0.1312-0.1314 against 0.1381 (4
// stages, two blocks), 0.1622 (2 stages), 0.2510 (6 stages, one block) and
// 0.1524-0.1785 (two warpgroups, one block).
constexpr int kG1Wgs = 2, kG1Stages = 3, kG1MinBlocks = 2;
constexpr int kG2Wgs = 1, kG2Stages = 3, kG2MinBlocks = 3;

template <int WGS, int STAGES>
struct Ring {
  static constexpr int kABytes = WGS * kABytesPerWg;
  static constexpr int kStageBytes = kABytes + kBBytes;           // a multiple of 1024
  static constexpr int kBarOffset = STAGES * kStageBytes;
  static constexpr int kRedOffset = kBarOffset + 2 * 8 * STAGES;  // LN partials
  static constexpr int kSmemBytes = kRedOffset + 2 * WGS * kWgRows * 4 + 1024;  // + alignment
  static constexpr int kThreads = WGS * 128 + 32;                 // + the producer warp
};

// Both operands K-major with the 128-byte swizzle: rows of 128 k bytes,
// 8-row atoms 1024 bytes apart (SBO); a k32 step moves the start 32 bytes
// along the swizzled row (+2 in the descriptor's 16-byte units).
constexpr unsigned kDescSbo = 1024;

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

// The producer (one thread): the k tiles of rows m0.. of A ([M, K]) and rows
// n0..n0+127 of B ([N, K]) into the ring.
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
    tma_load_2d(stage + R::kABytes, map_b, full, kt * kBK, n0);
  }
}

// A consumer warpgroup `wg`: acc (its 64 x 128 tile) = A rows . B^T over all k.
template <int WGS, int STAGES>
__device__ __forceinline__ void consume(int (&acc)[64], unsigned base, int nk, int wg) {
  typedef Ring<WGS, STAGES> R;
  const bool leader = threadIdx.x % 32 == 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(base + R::kBarOffset + 8 * s, (kt / STAGES) & 1);
    __syncwarp();
    const unsigned stage = base + s * R::kStageBytes;
    const uint64_t da = smem_desc(stage + wg * kABytesPerWg, 16, kDescSbo);
    const uint64_t db = smem_desc(stage + R::kABytes, 16, kDescSbo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();   // the group that read the previous stage is done
    fence_acc(acc);
    if (kt > 0 && leader)
      mbar_arrive(base + R::kBarOffset + 8 * (STAGES + (kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// Accumulator fragment of wgmma m64nN: thread t of the warpgroup holds, for j
// in 0..N/8-1, rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns
// 8 j + 2 (t % 4) and + 1: acc[4j], acc[4j+1] (row r), acc[4j+2], acc[4j+3]
// (row r + 8).

// 4. h = gelu((xq . w1q) * (sx * s1) + b1), f32 [M, F]; max |h| per tile.
__global__ void __launch_bounds__(Ring<kG1Wgs, kG1Stages>::kThreads, kG1MinBlocks)
    ffn_int8_gemm1_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w1,
                          const float* __restrict__ s1, const float* __restrict__ b1,
                          float* __restrict__ h, int* __restrict__ amax, int H, int F, int tm,
                          int T) {
  constexpr int WGS = kG1Wgs, STAGES = kG1Stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const unsigned base = cpt::smem_u32(smem);
  const int nk = (H + kBK - 1) / kBK;
  const int m0 = blockIdx.y * WGS * kWgRows, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring<WGS, STAGES>(base);
  if (warp == 4 * WGS) {
    if (lane == 0) produce<WGS, STAGES>(&map_x, &map_w1, base, nk, m0, n0);
    return;
  }
  const int wg = warp / 4;
  int acc[64];
  consume<WGS, STAGES>(acc, base, nk, wg);

  const int tile = m0 / tm;             // tm % 128 == 0: the block lies in one tile
  const float sx = tile_scale(amax + tile);
  const int r = m0 + wg * kWgRows + (warp % 4) * 16 + lane / 4;
  float hmax = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    const float m0s = __fmul_rn(sx, s1[col]), m1s = __fmul_rn(sx, s1[col + 1]);
    const float bb0 = b1[col], bb1 = b1[col + 1];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float v0 =
          gelu_poly(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * hr]), m0s), bb0));
      const float v1 =
          gelu_poly(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * hr + 1]), m1s), bb1));
      *reinterpret_cast<float2*>(h + static_cast<size_t>(r + 8 * hr) * F + col) =
          make_float2(v0, v1);
      hmax = fmaxf(hmax, fmaxf(fabsf(v0), fabsf(v1)));
    }
  }
  // the tile's maximum combines every block of it: one atomic per warp
  hmax = cpt::warp_max(hmax);
  if (lane == 0) atomicMax(amax + T + tile, __float_as_int(hmax));
}

__device__ __forceinline__ void put_pair(cpt::bf16* tile, int r, int c, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(tile + r * kPitch + c) = __floats2bfloat162_rn(a, b);
}

// 6. out = LayerNorm(hq . w2q * (sh * s2) + b2 + x) * gamma + beta, bf16, on
// a cluster of H / 128 blocks: kG2Wgs x 64 rows x one 128-column slice each.
__global__ void __launch_bounds__(Ring<kG2Wgs, kG2Stages>::kThreads, kG2MinBlocks)
    ffn_int8_gemm2_ln_kernel(const __grid_constant__ CUtensorMap map_hq,
                             const __grid_constant__ CUtensorMap map_w2,
                             const float* __restrict__ s2, const float* __restrict__ b2,
                             const cpt::bf16* __restrict__ x, const float* __restrict__ gamma,
                             const float* __restrict__ beta, const int* __restrict__ amax,
                             cpt::bf16* __restrict__ out, int H, int F, int tm, int T,
                             float eps) {
  constexpr int WGS = kG2Wgs, STAGES = kG2Stages, ROWS = WGS * kWgRows;
  typedef Ring<WGS, STAGES> R;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const unsigned base = cpt::smem_u32(smem);
  const unsigned red_sum = base + R::kRedOffset, red_sq = red_sum + ROWS * 4;
  float* sums = reinterpret_cast<float*>(smem + R::kRedOffset);
  float* sqs = sums + ROWS;
  const int nk = (F + kBK - 1) / kBK;
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * kBN;  // the cluster spans x
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool consumer = warp < 4 * WGS;
  const int wg = warp / 4;
  init_ring<WGS, STAGES>(base);

  const int r = warp * 16 + lane / 4;   // this thread's rows r and r + 8 (consumers)
  float y[64];
  if (consumer) {
    int acc[64];
    consume<WGS, STAGES>(acc, base, nk, wg);
    // the residual of this thread's fragment, loaded after the mainloop so
    // that its registers do not limit the blocks an SM
    unsigned res[2][kBN / 8];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        res[hr][j] = *reinterpret_cast<const unsigned*>(
            x + static_cast<size_t>(m0 + r + 8 * hr) * H + n0 + 8 * j + 2 * (lane % 4));
    const float sh = tile_scale(amax + T + m0 / tm);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      const float m0s = __fmul_rn(sh, s2[c]), m1s = __fmul_rn(sh, s2[c + 1]);
      const float bb0 = b2[c], bb1 = b2[c + 1];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 xr = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&res[hr][j]));
        y[4 * j + 2 * hr] = __fadd_rn(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * hr]), m0s), bb0), xr.x);
        y[4 * j + 2 * hr + 1] = __fadd_rn(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * hr + 1]), m1s), bb1), xr.y);
      }
      s0 += y[4 * j] + y[4 * j + 1];
      s1 += y[4 * j + 2] + y[4 * j + 3];
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
    produce<WGS, STAGES>(&map_hq, &map_w2, base, nk, m0, n0);
  }
  __syncwarp();
  cluster_sync();   // every block's row sums are in its shared memory

  const unsigned nrank = cluster_size();
  const float inv_n = 1.f / static_cast<float>(H);
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
      const float d0 = y[4 * j] - mu0, d1 = y[4 * j + 1] - mu0;
      const float d2 = y[4 * j + 2] - mu1, d3 = y[4 * j + 3] - mu1;
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
    named_barrier(1, WGS * 128);   // every consumer is done reading the ring
    cpt::bf16* tile = reinterpret_cast<cpt::bf16*>(smem);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float g0 = gamma[n0 + c], g1 = gamma[n0 + c + 1];
      const float e0 = beta[n0 + c], e1 = beta[n0 + c + 1];
      put_pair(tile, r, c, (y[4 * j] - mu0) * rstd0 * g0 + e0,
               (y[4 * j + 1] - mu0) * rstd0 * g1 + e1);
      put_pair(tile, r + 8, c, (y[4 * j + 2] - mu1) * rstd1 * g0 + e0,
               (y[4 * j + 3] - mu1) * rstd1 * g1 + e1);
    }
    named_barrier(2, WGS * 128);
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < ROWS * kBN / 8 / (WGS * 128); ++i) {
      const int idx = t + WGS * 128 * i;
      const int rr = idx / (kBN / 8), cc = (idx % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + rr) * H + n0 + cc) =
          *reinterpret_cast<const uint4*>(tile + rr * kPitch + cc);
    }
  } else {
    cluster_arrive();
  }
  cluster_wait();
}

int quantize(const void* src, bool bf16, void* dst, const void* amax, int rows, int cols,
             int tm, cudaStream_t s) {
  const long long n16 = static_cast<long long>(rows) * cols / 16;
  const long long want = (n16 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (bf16)
    ffn_int8_quantize_kernel<cpt::bf16><<<blocks, kThreads, 0, s>>>(
        static_cast<const cpt::bf16*>(src), static_cast<int8_t*>(dst),
        static_cast<const int*>(amax), cols, tm, n16);
  else
    ffn_int8_quantize_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(src), static_cast<int8_t*>(dst),
        static_cast<const int*>(amax), cols, tm, n16);
  return cpt::launch_status();
}

int transpose(const void* src, void* dst, int R, int C, cudaStream_t s) {
  ffn_int8_transpose_kernel<<<dim3(C / 64, R / 64), kThreads, 0, s>>>(
      static_cast<const int8_t*>(src), static_cast<int8_t*>(dst), R, C);
  return cpt::launch_status();
}

}  // namespace

// x [M, H] bf16; w1q [H, F], w2q [F, H] int8; s1, b1 [F], s2, b2, gamma, beta
// [H] f32; scratch: xq [M, H], w1t [F, H], w2t [H, F], hq [M, F] int8, h
// [M, F] f32, amax [2, M / tm] int32 (zeroed here); out [M, H] bf16. The
// wrapper guarantees M % tm == 0, tm % 128 == 0, F % 128 == 0, H % 128 == 0,
// H <= 1024 (a cluster of H / 128 blocks) and 16-byte aligned rows. Returns
// cudaErrorInvalidValue for any other H, and the launch's error where the
// card refuses the cluster.
CPT_EXPORT int cpt_ffn_int8(const void* x, const void* w1q, const void* s1, const void* b1,
                            const void* w2q, const void* s2, const void* b2,
                            const void* gamma, const void* beta, void* xq, void* w1t,
                            void* w2t, void* h, void* hq, void* amax, void* out, int M, int H,
                            int F, int tm, float eps, void* stream) {
  typedef Ring<kG1Wgs, kG1Stages> R1;
  typedef Ring<kG2Wgs, kG2Stages> R2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = M / tm;
  if (H % kBN != 0 || H / kBN > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return 0;
  CUtensorMap map_x, map_w1, map_hq, map_w2;
  int err = encode_map(&map_x, xq, M, H, kG1Wgs * kWgRows, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == 0) err = encode_map(&map_w1, w1t, F, H, kBN, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == 0)
    err = encode_map(&map_hq, hq, M, F, kG2Wgs * kWgRows, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == 0) err = encode_map(&map_w2, w2t, H, F, kBN, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(ffn_int8_gemm1_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       R1::kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ffn_int8_gemm2_ln_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, R2::kSmemBytes);
  if (e == cudaSuccess) e = cudaMemsetAsync(amax, 0, sizeof(int) * 2 * T, s);
  if (e != cudaSuccess) return static_cast<int>(e);

  ffn_int8_absmax_kernel<<<M / kAbsRows, kThreads, 0, s>>>(static_cast<const cpt::bf16*>(x),
                                                            static_cast<int*>(amax), H, tm);
  err = cpt::launch_status();
  if (err == 0) err = quantize(x, true, xq, amax, M, H, tm, s);
  if (err == 0) err = transpose(w1q, w1t, H, F, s);
  if (err == 0) err = transpose(w2q, w2t, F, H, s);
  if (err != 0) return err;

  ffn_int8_gemm1_kernel<<<dim3(F / kBN, M / (kG1Wgs * kWgRows)), R1::kThreads, R1::kSmemBytes,
                          s>>>(
      map_x, map_w1, static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<float*>(h), static_cast<int*>(amax), H, F, tm, T);
  err = cpt::launch_status();
  if (err == 0) err = quantize(h, false, hq, static_cast<const int*>(amax) + T, M, F, tm, s);
  if (err != 0) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H / kBN, M / (kG2Wgs * kWgRows));
  cfg.blockDim = dim3(R2::kThreads);
  cfg.dynamicSmemBytes = R2::kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = H / kBN;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ffn_int8_gemm2_ln_kernel, map_hq, map_w2,
                         static_cast<const float*>(s2), static_cast<const float*>(b2),
                         static_cast<const cpt::bf16*>(x), static_cast<const float*>(gamma),
                         static_cast<const float*>(beta), static_cast<const int*>(amax),
                         static_cast<cpt::bf16*>(out), H, F, tm, T, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return cpt::launch_status();
}
