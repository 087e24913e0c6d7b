// K7: the W8A8 BERT FFN of bench_int8.py's study,
//   out = LayerNorm(x + (hq . w2q) * (sh * s2) + b2),
//   h   = gelu((xq . w1q) * (sx * s1) + b1),
// with one dynamic scale per tm-row tile for x (sx) and one for the whole
// [tm, F] tile of h (sh), per-column weight scales s1, s2, erf gelu through
// the Abramowitz-Stegun polynomial, LayerNorm E[(y - mu)^2] in f32, and a bf16
// store. Three launches:
//   1. absmax_tiles: max |x| of every tm-row tile, by atomicMax on the f32's
//      bits (the values are >= 0, so their int order is their float order);
//   2. gemm1: x quantized by its tile's scale as it is staged, an int8 GEMM,
//      then (acc * (sx * s1) + b1) and gelu; h is written in f32 and max |h|
//      per tile gathered the same way;
//   3. gemm2_ln: h quantized by its tile's scale as it is staged, an int8
//      GEMM, then acc * (sh * s2) + b2 + x and the row LayerNorm: one block
//      owns 32 whole rows.
//
// Replaces bench_int8.py::ffn_int8 (pallas_call :225, body kern :204-220). The
// TPU kernel held one 1024-row tile of x and its whole [tm, F] h in VMEM, so
// both tile maxima were in-kernel reductions. On Hopper a tile spans many
// blocks that run in no order, so each maximum takes atomics and a launch
// boundary, and h makes one f32 round trip through device memory (201 MB at
// M = 16384, F = 3072).
//
// Products: mma.sync m16n8k32 s8 x s8 -> s32, exact (|sum| <= 3072 * 127^2 <
// 2^31). Tiles: 128 x 128 (gemm1) and 32 x H (gemm2) blocks of 8 warps,
// k-steps of 32; A is staged row-major, B transposed to [n][k] in shared
// memory (4x4 byte blocks transposed in registers). Single-buffered, no
// cp.async/TMA, no wgmma: a first, exact kernel. What bounds it: 4 * M * H * F
// int8 operations (154.6 G at the study's shape) against 1,979 TOP/s dense
// int8, i.e. 0.078 ms; mma.sync from single-buffered tiles reaches a fraction
// of that peak. Every f32 step mirrors the plain version's PyTorch order with
// unfused roundings (__fmul_rn, __fadd_rn, __fdiv_rn), so h and both
// quantizations match it bit for bit; only the LayerNorm's sums differ in
// order.
#include "common.cuh"

namespace {

constexpr int kBK = 32;                // k-step (bytes of int8)
constexpr int kLdA = kBK + 16;         // A row stride in shared memory (bytes)
constexpr int kLdB = kBK + 8;          // B row stride: conflict-free transposed stores
constexpr int kG1M = 128, kG1N = 128;  // gemm1 block tile
constexpr int kG2M = 32;               // gemm2 rows per block
constexpr int kThreads = 256;

__device__ __forceinline__ float tile_scale(const int* amax_bits) {
  return __fdiv_rn(fmaxf(__int_as_float(*amax_bits), 1e-8f), 127.f);
}

__device__ __forceinline__ int quant(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | (d << 24);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The m16n8k32 A fragment of rows r0.. r0+15 from a row-major tile.
__device__ __forceinline__ void load_a(int (&a)[4], const int8_t* As, int r0, int g, int t) {
  a[0] = *reinterpret_cast<const int*>(As + (r0 + g) * kLdA + 4 * t);
  a[1] = *reinterpret_cast<const int*>(As + (r0 + g + 8) * kLdA + 4 * t);
  a[2] = *reinterpret_cast<const int*>(As + (r0 + g) * kLdA + 16 + 4 * t);
  a[3] = *reinterpret_cast<const int*>(As + (r0 + g + 8) * kLdA + 16 + 4 * t);
}

// Rows k0..k0+31 of the row-major int8 [K, N] matrix w, columns n0 +
// 4 * ng.. (ng < n_groups), into Bs[n][k]; the thread mapping keeps 8
// consecutive threads on 8 k-groups, so the transposed stores hit 32 banks.
__device__ __forceinline__ void stage_b(int8_t* Bs, const int8_t* w, int N, int k0, int n0,
                                        int n_groups) {
  for (int i = threadIdx.x; i < 8 * n_groups; i += kThreads) {
    const int kg = i % 8, ng = i / 8;
    const int8_t* src = w + static_cast<size_t>(k0 + 4 * kg) * N + n0 + 4 * ng;
    int rows[4], cols[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rows[r] = *reinterpret_cast<const int*>(src + static_cast<size_t>(r) * N);
    cpt::transpose4x4_s8(rows, cols);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<int*>(Bs + (4 * ng + j) * kLdB + 4 * kg) = cols[j];
  }
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

__device__ __forceinline__ void atomic_max_block(float v, int* dst) {
  __shared__ float part[kThreads / 32];
  v = cpt::warp_max(v);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = part[0];
    for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, part[i]);
    atomicMax(dst, __float_as_int(m));
  }
}

// 1. max |x| over kRows rows per block into amax[row / tm].
constexpr int kAbsRows = 16;

__global__ void __launch_bounds__(kThreads)
    absmax_tiles_kernel(const cpt::bf16* __restrict__ x, int* __restrict__ amax, int H,
                        int tm) {
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
  atomic_max_block(m, amax + r0 / tm);
}

// 2. h = gelu((xq . w1q) * (sx * s1) + b1), f32 [M, F]; max |h| per tile.
// 8 warps as 2 (rows) x 4 (columns) of 64 x 32.
__global__ void __launch_bounds__(kThreads)
    ffn_int8_gemm1_kernel(const cpt::bf16* __restrict__ x, const int8_t* __restrict__ w1q,
                          const float* __restrict__ s1, const float* __restrict__ b1,
                          float* __restrict__ h, int* __restrict__ amax, int H, int F,
                          int tm, int T) {
  __shared__ __align__(16) int8_t As[kG1M * kLdA];
  __shared__ __align__(16) int8_t Bs[kG1N * kLdB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kG1M, n0 = blockIdx.x * kG1N;
  const int tile = m0 / tm;
  const float sx = tile_scale(amax + tile);

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  for (int k0 = 0; k0 < H; k0 += kBK) {
    // A: 128 rows x 32 bf16, quantized by the tile's scale, 8 values a thread-step
    for (int i = threadIdx.x; i < kG1M * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * H + k0 + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      int q[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h2[k]);
        q[2 * k] = quant(f.x, sx);
        q[2 * k + 1] = quant(f.y, sx);
      }
      *reinterpret_cast<uint2*>(As + r * kLdA + c) =
          make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
    }
    stage_b(Bs, w1q, F, k0, n0, kG1N / 4);
    __syncthreads();
    int a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) load_a(a[mt], As, wm * 64 + mt * 16, g, t);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int8_t* bp = Bs + (wn * 32 + nt * 8 + g) * kLdB;
      const int b0 = *reinterpret_cast<const int*>(bp + 4 * t);
      const int b1v = *reinterpret_cast<const int*>(bp + 16 + 4 * t);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1v);
    }
    __syncthreads();
  }

  float hmax = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + 2 * t;
    const float m0s = __fmul_rn(sx, s1[col]), m1s = __fmul_rn(sx, s1[col + 1]);
    const float bb0 = b1[col], bb1 = b1[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + 8 * half;
        const float v0 = gelu_poly(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), m0s), bb0));
        const float v1 = gelu_poly(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]), m1s), bb1));
        *reinterpret_cast<float2*>(h + static_cast<size_t>(row) * F + col) =
            make_float2(v0, v1);
        hmax = fmaxf(hmax, fmaxf(fabsf(v0), fabsf(v1)));
      }
    }
  }
  atomic_max_block(hmax, amax + T + tile);
}

// 3. out = LayerNorm(hq . w2q * (sh * s2) + b2 + x) * gamma + beta, bf16.
// Block: 32 rows x H = 64 * NT columns; warp w owns columns [w * 8 NT, ...).
template <int NT>
__global__ void __launch_bounds__(kThreads)
    ffn_int8_gemm2_ln_kernel(const float* __restrict__ h, const int8_t* __restrict__ w2q,
                             const float* __restrict__ s2, const float* __restrict__ b2,
                             const cpt::bf16* __restrict__ x,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta, const int* __restrict__ amax,
                             cpt::bf16* __restrict__ out, int F, int tm, int T,
                             float eps) {
  constexpr int H = 64 * NT;
  __shared__ __align__(16) int8_t As[kG2M * kLdA];
  __shared__ __align__(16) int8_t Bs[H * kLdB];
  __shared__ float red[kThreads / 32][kG2M];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * kG2M;
  const float sh = tile_scale(amax + T + m0 / tm);

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  for (int k0 = 0; k0 < F; k0 += kBK) {
    {  // A: 32 rows x 32 f32, quantized by the tile's scale, 4 values a thread
      const int r = threadIdx.x / 8, c = (threadIdx.x % 8) * 4;
      const float4 v =
          *reinterpret_cast<const float4*>(h + static_cast<size_t>(m0 + r) * F + k0 + c);
      *reinterpret_cast<int*>(As + r * kLdA + c) =
          pack4(quant(v.x, sh), quant(v.y, sh), quant(v.z, sh), quant(v.w, sh));
    }
    stage_b(Bs, w2q, H, k0, 0, H / 4);
    __syncthreads();
    int a[2][4];
    load_a(a[0], As, 0, g, t);
    load_a(a[1], As, 16, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int8_t* bp = Bs + (warp * NT * 8 + nt * 8 + g) * kLdB;
      const int b0 = *reinterpret_cast<const int*>(bp + 4 * t);
      const int b1v = *reinterpret_cast<const int*>(bp + 16 + 4 * t);
      mma_s8(acc[0][nt], a[0], b0, b1v);
      mma_s8(acc[1][nt], a[1], b0, b1v);
    }
    __syncthreads();
  }

  // this thread's rows: local (mt * 16 + half * 8 + g), index mt * 2 + half
  float y[2][NT][4];
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = warp * NT * 8 + nt * 8 + 2 * t;
    const float m0s = __fmul_rn(sh, s2[col]), m1s = __fmul_rn(sh, s2[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + mt * 16 + half * 8 + g;
        const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            x + static_cast<size_t>(row) * H + col));
        const float v0 = __fadd_rn(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), m0s), b2[col]), xr.x);
        const float v1 = __fadd_rn(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]), m1s), b2[col + 1]),
            xr.y);
        y[mt][nt][2 * half] = v0;
        y[mt][nt][2 * half + 1] = v1;
        part[mt * 2 + half] += v0 + v1;
      }
    }
  }
  // row sums: over the quad's 4 threads, then over the 8 warps
  float mu[4], rstd[4];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
      if (t == 0) red[warp][(i / 2) * 16 + (i % 2) * 8 + g] = part[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w][(i / 2) * 16 + (i % 2) * 8 + g];
      if (pass == 0)
        mu[i] = s / H;
      else
        rstd[i] = rsqrtf(s / H + eps);
      part[i] = 0.f;
    }
    __syncthreads();
    if (pass == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float d = y[mt][nt][k] - mu[mt * 2 + k / 2];
            part[mt * 2 + k / 2] += d * d;
          }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = warp * NT * 8 + nt * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = mt * 2 + half;
        const int row = m0 + mt * 16 + half * 8 + g;
        const float o0 = (y[mt][nt][2 * half] - mu[i]) * rstd[i] * gamma[col] + beta[col];
        const float o1 =
            (y[mt][nt][2 * half + 1] - mu[i]) * rstd[i] * gamma[col + 1] + beta[col + 1];
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * H + col) =
            __floats2bfloat162_rn(o0, o1);
      }
    }
  }
}

template <int NT>
void launch_gemm2(const void* h, const void* w2q, const void* s2, const void* b2,
                  const void* x, const void* gamma, const void* beta, const void* amax,
                  void* out, int M, int F, int tm, int T, float eps, cudaStream_t s) {
  ffn_int8_gemm2_ln_kernel<NT><<<M / kG2M, kThreads, 0, s>>>(
      static_cast<const float*>(h), static_cast<const int8_t*>(w2q),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<const cpt::bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const int*>(amax),
      static_cast<cpt::bf16*>(out), F, tm, T, eps);
}

}  // namespace

// x [M, H] bf16; w1q [H, F], w2q [F, H] int8; s1, b1 [F], s2, b2, gamma, beta
// [H] f32; h [M, F] f32 scratch; amax [2, M / tm] int32, zeroed by the
// caller; out [M, H] bf16. The wrapper guarantees M % tm == 0, tm % 128 == 0,
// F % 128 == 0, H / 64 in {2, 4, 12} and 16-byte aligned rows. Returns
// cudaErrorInvalidValue for any other H.
CPT_EXPORT int cpt_ffn_int8(const void* x, const void* w1q, const void* s1, const void* b1,
                            const void* w2q, const void* s2, const void* b2,
                            const void* gamma, const void* beta, void* h, void* amax,
                            void* out, int M, int H, int F, int tm, float eps,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = M / tm;
  if (H != 128 && H != 256 && H != 768) return static_cast<int>(cudaErrorInvalidValue);
  absmax_tiles_kernel<<<M / kAbsRows, kThreads, 0, s>>>(static_cast<const cpt::bf16*>(x),
                                                         static_cast<int*>(amax), H, tm);
  int err = cpt::launch_status();
  if (err) return err;
  ffn_int8_gemm1_kernel<<<dim3(F / kG1N, M / kG1M), kThreads, 0, s>>>(
      static_cast<const cpt::bf16*>(x), static_cast<const int8_t*>(w1q),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<float*>(h), static_cast<int*>(amax), H, F, tm, T);
  err = cpt::launch_status();
  if (err) return err;
  switch (H / 64) {
    case 2: launch_gemm2<2>(h, w2q, s2, b2, x, gamma, beta, amax, out, M, F, tm, T, eps, s); break;
    case 4: launch_gemm2<4>(h, w2q, s2, b2, x, gamma, beta, amax, out, M, F, tm, T, eps, s); break;
    default: launch_gemm2<12>(h, w2q, s2, b2, x, gamma, beta, amax, out, M, F, tm, T, eps, s);
  }
  return cpt::launch_status();
}
