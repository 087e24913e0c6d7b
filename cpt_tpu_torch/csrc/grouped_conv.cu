// K1: grouped 3x3 convolution, pad 1, stride 1 or 2, NHWC bf16, with the
// frozen-BN affine and ReLU fused into an f32 epilogue.
//
// Replaces cpt_tpu/ops/grouped_conv.py::grouped_conv3x3_sd (_sd_kernel, the
// slice-dense tap matmuls, stride 1) and grouped_conv3x3 (_kernel, per-group
// im2col, stride 1 or 2). The TPU kernels densified the groups into
// block-diagonal 128x128 tap matrices to feed the MXU; on Hopper that would
// multiply 128/cpg times more than needed, so both paths below compute the
// grouped sum directly.
//
// The tensor-core path (cpt_grouped_conv3x3_mma; cpg 8, 16, 32 or 64 and
// C % 64 == 0, which is every X152 shape) is an implicit GEMM per group:
// M = output pixels, N = the group's cpg output channels, K = 9 taps x cpg
// input channels, on mma.sync m16n8k16 bf16 -> f32. What bounds it: every
// X152 shape moves more bytes than its products cost on the tensor cores
// (at [8,40,64,1024] 0.025 ms of HBM traffic against 0.012 ms of bf16
// products), so the design keeps the products off the critical path and
// reads each input once:
//   - A block owns one 64-channel slice (64/cpg groups) and walks a strided
//     run of output tiles (TM = 64 or 128 pixels, 8 or 16 columns wide).
//     The slice's weights, 9*cpg x 64 bf16 (9-74 KB), are loaded into shared
//     memory once per block; rows are 128 bytes with the 16-byte chunks
//     XOR-swizzled by row, so ldmatrix.trans reads B fragments without bank
//     conflicts.
//   - The input patch of a tile (its halo included) is staged in bf16 with
//     16-byte cp.async copies into a two-stage ring: the next tile's patch
//     loads while this one computes. Out-of-image pixels are zero-filled by
//     the copy (src-size 0), which is the conv's zero padding. A pixel takes
//     144 bytes (64 channels + a 16-byte pad), so ldmatrix's eight rows
//     (eight neighbouring pixels) fall in distinct banks; at stride 2 the
//     patch stores even input columns before odd ones, so the pixels one tap
//     reads are again neighbours.
//   - One output pixel's 8 consecutive input channels at one tap are one
//     16-byte ldmatrix row: each lane computes its own row address, so the
//     tap shift and the stride-2 grid cost no copies. At cpg 8 a k16 step
//     spans two taps (its last half reads zero weights).
//   - 8 warps, 2 along pixels x 4 along channels: a warp holds TM/32 m16
//     tiles x 16 channels in f32 registers. The epilogue is acc * scale +
//     bias, ReLU and one bf16 rounding, staged through the tile's (now
//     free) patch buffer so that each pixel's 128 bytes leave in 16-byte
//     coalesced stores, not as 4-byte channel pairs that half-fill 32-byte
//     sectors.
//   - The grid is one resident wave (blocks per SM from the occupancy
//     query, shared out over the slices and rounded down); a block that
//     did not fit would run as a second wave for the whole kernel's time.
//     The query and the shared-memory opt-in are made once per
//     instantiation, device and patch size, not per launch: a request
//     launches K1 50 times, and the detect step is bound by the host.
//   What bounds it now: not its HBM bytes (0.063 ms on the H100 against a
//   0.025 ms byte bound at [8,40,64,1024]; PERF.md, section 6) but the
//   ldmatrix / mma.sync stream (320 bytes of shared-memory reads per MMA at
//   TM 128, more at cpg 8, where an A fragment feeds one n8 tile, and at
//   cpg 64) and, at stride 2, a patch of 4.6 input pixels an output pixel
//   that fills the shared memory of one block an SM.
//
// The CUDA-core path (cpt_grouped_conv3x3, the port's first K1) takes the
// other shapes (cpg a multiple of 4 that tiles 128-channel slices): one
// block per (image, TH x kTW output tile, 128-channel slice) stages its
// patch as f32 and each thread runs f32 FMAs for 4 output channels x 8
// columns. ops/grouped_conv.py::conv_path is the dispatch rule.
//
// K1q: the same conv on int8 activations and int8 weights, for the W8A8
// path (ops/quant.py::int8_conv with groups > 1;
// cpt_tpu/models/detector/resnet.py:176-179 runs it as an XLA int8 conv, so
// it has no Pallas kernel of its own), with exact int32 sums and the plain
// version's epilogue y * scale[c] + bias[c] in two roundings (__fmul_rn,
// __fadd_rn), ReLU and one bf16 rounding, so it equals the plain version
// bit for bit. Two kernels, chosen by the same rule as K1's:
//   - cpt_grouped_conv3x3_int8_mma (cpg 8-64, C % 64 == 0: every X152
//     shape) is K1's tensor-core tiling on mma.sync m16n8k32 s8 -> s32: a
//     64-channel slice a block, its weights staged once, transposed to
//     [n][k] (k = tap * cpg + ci, 16 pad bytes a row), the int8 patch in a
//     two-stage cp.async ring of 80-byte pixels (64 channels + a pad that
//     puts ldmatrix's eight rows in distinct banks), stride-2 columns even
//     before odd, and the bf16 output tile staged for 16-byte stores in a
//     buffer of its own. A k32 step is half a tap at cpg 64, a tap at 32,
//     two at 16 and four at 8 (K 72 -> 96, the tail's weights zero).
//     What bounds it: at [8,40,64,1024] its 63 MB of int8 reads and bf16
//     writes take 0.019 ms at 3.35 TB/s against 12 G int8 operations
//     (0.006 ms), and it runs at 0.042 ms on the H100 (45% of that bound,
//     below K1's 0.055 in bf16 on the same map). At stride 2 the int8
//     patch (47.5 KB for its two stages) leaves room for three blocks an
//     SM at cpg 16 and 32 and two at cpg 64, by shared memory and by the
//     registers in build.log, where K1's bf16 one (122-159 KB a block at
//     cpg 32 and 64) leaves one.
//   - cpt_grouped_conv3x3_int8 (the other shapes: cpg a multiple of 4
//     that tiles 128-channel slices) is the CUDA-core kernel: the patch
//     staged as int8, 4 input channels a __dp4a; each thread transposes 4
//     weight rows in registers for 4 output channels. It issues at the
//     CUDA cores' dp4a rate (0.19 ms at [8,40,64,1024], 4.6x the tensor-core
//     kernel).
#include <mutex>

#include "common.cuh"

namespace {

constexpr int kTW = 8;  // output columns per thread
constexpr int kCO = 4;  // output channels per thread

// shared-memory index of slice-local channel c (one pad word per 32)
__device__ __forceinline__ int padded(int c) { return c + (c >> 5); }

__global__ void grouped_conv3x3_kernel(const cpt::bf16* __restrict__ x,
                                       const cpt::bf16* __restrict__ w,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias,
                                       cpt::bf16* __restrict__ out, int H, int W, int C,
                                       int cpg, int stride, int Ho, int Wo, int relu,
                                       int CB) {
  extern __shared__ float patch[];  // [PR][PW][CBP]
  const int TH = blockDim.y;
  const int CBP = padded(CB - 1) + 1;
  const int n_slices = C / CB;
  const int n_wt = (Wo + kTW - 1) / kTW;
  const int n_ht = (Ho + TH - 1) / TH;
  long long bid = blockIdx.x;
  const int wt = static_cast<int>(bid % n_wt);
  bid /= n_wt;
  const int ht = static_cast<int>(bid % n_ht);
  bid /= n_ht;
  const int slice = static_cast<int>(bid % n_slices);
  const int n = static_cast<int>(bid / n_slices);
  const int c0 = slice * CB, oy0 = ht * TH, ox0 = wt * kTW;
  const int PR = (TH - 1) * stride + 3;
  const int PW = (kTW - 1) * stride + 3;

  // stage the patch with 16-byte loads (8 channels each; CB % 8 == 0)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int CV = CB / 8;
  for (int idx = tid; idx < PR * PW * CV; idx += nthr) {
    const int c = (idx % CV) * 8;
    const int j = (idx / CV) % PW;
    const int r = idx / (CV * PW);
    const int iy = oy0 * stride - 1 + r;
    const int ix = ox0 * stride - 1 + j;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      raw = *reinterpret_cast<const uint4*>(
          x + ((static_cast<size_t>(n) * H + iy) * W + ix) * C + c0 + c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float* dst = patch + (r * PW + j) * CBP + padded(c);  // 8 channels, one pad run
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h2[k]);
      dst[2 * k] = f.x;
      dst[2 * k + 1] = f.y;
    }
  }
  __syncthreads();

  const int oy = oy0 + threadIdx.y;
  if (oy >= Ho) return;
  const int cl = threadIdx.x * kCO;     // first output channel, slice-local
  const int gbase = (cl / cpg) * cpg;   // first input channel of its group
  float acc[kCO][kTW];
#pragma unroll
  for (int k = 0; k < kCO; ++k)
#pragma unroll
    for (int t = 0; t < kTW; ++t) acc[k][t] = 0.f;

  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const cpt::bf16* wp = w + static_cast<size_t>((ky * 3 + kx) * cpg) * C + c0 + cl;
      const float* prow = patch + ((threadIdx.y * stride + ky) * PW + kx) * CBP;
#pragma unroll 4
      for (int ci = 0; ci < cpg; ++ci) {
        const uint2 wraw = *reinterpret_cast<const uint2*>(wp + static_cast<size_t>(ci) * C);
        const float2 w01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wraw.x));
        const float2 w23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wraw.y));
        const float* px = prow + padded(gbase + ci);
#pragma unroll
        for (int t = 0; t < kTW; ++t) {
          const float xv = px[t * stride * CBP];
          acc[0][t] += xv * w01.x;
          acc[1][t] += xv * w01.y;
          acc[2][t] += xv * w23.x;
          acc[3][t] += xv * w23.y;
        }
      }
    }
  }

  float s[kCO], b[kCO];
#pragma unroll
  for (int k = 0; k < kCO; ++k) {
    s[k] = scale[c0 + cl + k];
    b[k] = bias[c0 + cl + k];
  }
#pragma unroll
  for (int t = 0; t < kTW; ++t) {
    const int ox = ox0 + t;
    if (ox >= Wo) break;
    float v[kCO];
#pragma unroll
    for (int k = 0; k < kCO; ++k) {
      v[k] = acc[k][t] * s[k] + b[k];
      if (relu) v[k] = fmaxf(v[k], 0.f);
    }
    uint2 packed;
    *reinterpret_cast<__nv_bfloat162*>(&packed.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&packed.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(out + ((static_cast<size_t>(n) * Ho + oy) * Wo + ox) * C +
                              c0 + cl) = packed;
  }
}

constexpr int kQTH = 8;  // K1q: output rows per block

__global__ void grouped_conv3x3_int8_kernel(const int8_t* __restrict__ x,
                                            const int8_t* __restrict__ w,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ bias,
                                            cpt::bf16* __restrict__ out, int H, int W,
                                            int C, int cpg, int stride, int Ho, int Wo,
                                            int relu, int CB) {
  extern __shared__ __align__(16) int qpatch[];  // [PR][PW][CB/4] words of 4 channels
  const int TH = blockDim.y;
  const int CW = CB / 4;
  const int n_slices = C / CB;
  const int n_wt = (Wo + kTW - 1) / kTW;
  const int n_ht = (Ho + TH - 1) / TH;
  long long bid = blockIdx.x;
  const int wt = static_cast<int>(bid % n_wt);
  bid /= n_wt;
  const int ht = static_cast<int>(bid % n_ht);
  bid /= n_ht;
  const int slice = static_cast<int>(bid % n_slices);
  const int n = static_cast<int>(bid / n_slices);
  const int c0 = slice * CB, oy0 = ht * TH, ox0 = wt * kTW;
  const int PR = (TH - 1) * stride + 3;
  const int PW = (kTW - 1) * stride + 3;

  // stage the patch with 16-byte loads (16 channels each; CB % 16 == 0)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int CV = CB / 16;
  for (int idx = tid; idx < PR * PW * CV; idx += nthr) {
    const int c = (idx % CV) * 16;
    const int j = (idx / CV) % PW;
    const int r = idx / (CV * PW);
    const int iy = oy0 * stride - 1 + r;
    const int ix = ox0 * stride - 1 + j;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      raw = *reinterpret_cast<const uint4*>(
          x + ((static_cast<size_t>(n) * H + iy) * W + ix) * C + c0 + c);
    *reinterpret_cast<uint4*>(qpatch + (r * PW + j) * CW + c / 4) = raw;
  }
  __syncthreads();

  const int oy = oy0 + threadIdx.y;
  if (oy >= Ho) return;
  const int cl = threadIdx.x * kCO;     // first output channel, slice-local
  const int gbase = (cl / cpg) * cpg;   // first input channel of its group
  int acc[kCO][kTW];
#pragma unroll
  for (int k = 0; k < kCO; ++k)
#pragma unroll
    for (int t = 0; t < kTW; ++t) acc[k][t] = 0;

  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const int8_t* wp = w + static_cast<size_t>((ky * 3 + kx) * cpg) * C + c0 + cl;
      const int* prow = qpatch + ((threadIdx.y * stride + ky) * PW + kx) * CW + gbase / 4;
      for (int ci4 = 0; ci4 < cpg / 4; ++ci4) {
        int rows[4], wc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rows[i] = *reinterpret_cast<const int*>(wp + static_cast<size_t>(4 * ci4 + i) * C);
        cpt::transpose4x4_s8(rows, wc);  // wc[k]: input channels 4*ci4.. of output cl+k
#pragma unroll
        for (int t = 0; t < kTW; ++t) {
          const int xv = prow[t * stride * CW + ci4];
#pragma unroll
          for (int k = 0; k < kCO; ++k) acc[k][t] = __dp4a(xv, wc[k], acc[k][t]);
        }
      }
    }
  }

  float s[kCO], b[kCO];
#pragma unroll
  for (int k = 0; k < kCO; ++k) {
    s[k] = scale[c0 + cl + k];
    b[k] = bias[c0 + cl + k];
  }
#pragma unroll
  for (int t = 0; t < kTW; ++t) {
    const int ox = ox0 + t;
    if (ox >= Wo) break;
    float v[kCO];
#pragma unroll
    for (int k = 0; k < kCO; ++k) {
      v[k] = __fadd_rn(__fmul_rn(__int2float_rn(acc[k][t]), s[k]), b[k]);
      if (relu) v[k] = fmaxf(v[k], 0.f);
    }
    uint2 packed;
    *reinterpret_cast<__nv_bfloat162*>(&packed.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&packed.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(out + ((static_cast<size_t>(n) * Ho + oy) * Wo + ox) * C +
                              c0 + cl) = packed;
  }
}


// ---- the tensor-core path -------------------------------------------------

constexpr int kMmaCB = 64;                  // channels per block (one slice)
constexpr int kMmaPS = kMmaCB * 2 + 16;     // patch bytes per pixel, 16-byte pad
constexpr int kMmaThreads = 256;            // 8 warps: 2 along pixels x 4 along channels

using cpt::cp_async16;
using cpt::cp_async_commit;
using cpt::cp_async_wait1;
using cpt::ldsm_x4;
using cpt::ldsm_x4_trans;
using cpt::mma_bf16;
using cpt::smem_u32;

// Rows of the weight matrix (K = 9 * cpg), padded to the k16 step.
template <int CPG>
__host__ __device__ constexpr int mma_k_rows() { return (9 * CPG + 15) / 16 * 16; }

// One block: the 64-channel slice blockIdx.y, output tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of n_tiles (image-major, then tile rows, then
// tile columns). A tile is TH = TM >> tw_log2 rows x TW = 1 << tw_log2
// columns of output pixels.
template <int CPG, int TM>
__global__ void __launch_bounds__(kMmaThreads)
    grouped_conv3x3_mma_kernel(const cpt::bf16* __restrict__ x, const cpt::bf16* __restrict__ w,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias, cpt::bf16* __restrict__ out,
                               int H, int W, int C, int stride, int Ho, int Wo, int relu,
                               int tw_log2, int n_tiles) {
  constexpr int KR = mma_k_rows<CPG>();
  constexpr int MT = TM / 32;               // m16 tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wsm = smem;                // [KR][64] bf16, chunks swizzled by row
  unsigned char* patch = smem + KR * kMmaCB * 2;  // 2 x [PR][PW] pixels of kMmaPS bytes

  const int TW = 1 << tw_log2, TH = TM >> tw_log2;
  const int PR = (TH - 1) * stride + 3, PW = (TW - 1) * stride + 3;
  const int PWe = (PW + 1) >> 1;            // stride 2: even columns, then odd ones
  const int patch_bytes = PR * PW * kMmaPS;
  const int n_wt = (Wo + TW - 1) >> tw_log2, n_ht = (Ho + TH - 1) / TH;
  const int c0 = blockIdx.y * kMmaCB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // pixel half, 16-channel quarter

  // the slice's weights: row k = tap * cpg + ci holds w[tap][ci][c0 .. c0+63]
  for (int i = tid; i < KR * 8; i += kMmaThreads) {
    const int k = i >> 3, ch = i & 7;
    const bool valid = k < 9 * CPG;
    cp_async16(smem_u32(wsm + k * 128 + ((ch ^ (k & 7)) << 4)),
               w + static_cast<size_t>(valid ? k : 0) * C + c0 + ch * 8, valid);
  }

  // this thread's first (row, column, chunk) of a patch; the walk steps by
  // kMmaThreads / 8 pixels
  const int ch = tid & 7;
  const int r_first = (tid >> 3) / PW, j_first = (tid >> 3) - r_first * PW;
  auto stage = [&](int tile, int buf) {
    const int wt = tile % n_wt;
    const int ht = (tile / n_wt) % n_ht;
    const int n = tile / (n_wt * n_ht);
    const int iy0 = ht * TH * stride - 1, ix0 = (wt << tw_log2) * stride - 1;
    const unsigned dst0 = smem_u32(patch + buf * patch_bytes) + ch * 16;
    const cpt::bf16* src0 = x + static_cast<size_t>(n) * H * W * C + c0 + ch * 8;
    int r = r_first, j = j_first;
    for (int pix = tid >> 3; pix < PR * PW; pix += kMmaThreads / 8) {
      const int iy = iy0 + r, ix = ix0 + j;
      const bool valid = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const int col = stride == 1 ? j : ((j & 1) ? PWe + (j >> 1) : (j >> 1));
      cp_async16(dst0 + (r * PW + col) * kMmaPS,
                 valid ? src0 + (static_cast<size_t>(iy) * W + ix) * C : x, valid);
      j += kMmaThreads / 8;
      while (j >= PW) {
        j -= PW;
        ++r;
      }
    }
  };

  // byte offset of tap (ky, kx) from an output pixel's (ky, kx) = (0, 0) pixel
  int toff[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int ky = t / 3, kx = t % 3;
    const int col = stride == 1 ? kx : (kx == 1 ? PWe : kx >> 1);
    toff[t] = (ky * PW + col) * kMmaPS;
  }
  // this lane's ldmatrix rows: pixel (lane & 15) of each m16 tile; k half lane >> 4
  const int half = lane >> 4;
  int apix[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = (wm * MT + mt) * 16 + (lane & 15);
    const int oy = p >> tw_log2, ox = p & (TW - 1);
    apix[mt] = (oy * stride * PW + ox) * kMmaPS;
  }
  // the first input channel (bytes) of the group of each n8 tile
  constexpr int NG = CPG >= 16 ? 1 : 2;     // groups a warp's 16 channels span
  int gbyte[NG];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) gbyte[gi] = ((wn * 16 + gi * 8) / CPG) * CPG * 2;
  // B: lanes 0-15 read n8 tile 0, 16-31 tile 1; rows k 0-7, 8-15 alternate
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const unsigned bbase =
      smem_u32(wsm) + brow * 128 + (((wn * 2 + (lane >> 4)) ^ (lane & 7)) << 4);

  // the epilogue's channels: this lane's pair in each n8 tile
  float sc[2][2], bi[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = c0 + wn * 16 + j * 8 + (lane & 3) * 2 + e;
      sc[j][e] = scale[co];
      bi[j][e] = bias[co];
    }

  int tile = blockIdx.x;
  if (tile < n_tiles) stage(tile, 0);
  cp_async_commit();
  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < n_tiles) stage(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();  // all but the newest group: this tile's patch (and the weights)
    __syncthreads();

    const unsigned pbase = smem_u32(patch + buf * patch_bytes);
    float acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
    for (int kc = 0; kc < KR / 16; ++kc) {
      // this lane's 8 input channels of the k16 step: a tap and a channel offset
      int aoff;
      if constexpr (CPG >= 16) {
        aoff = toff[(kc * 16) / CPG] + ((kc * 16) % CPG) * 2 + half * 16;
      } else {  // cpg 8: the halves are two taps; past tap 8 the weights are zero
        aoff = half ? toff[2 * kc + 1 < 9 ? 2 * kc + 1 : 8] : toff[2 * kc];
      }
      unsigned b[4];
      ldsm_x4_trans(bbase + kc * 16 * 128, b);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        ldsm_x4(pbase + apix[mt] + aoff + gbyte[0], a);
        mma_bf16(acc[mt][0], a, b[0], b[1]);
        if constexpr (NG == 2) ldsm_x4(pbase + apix[mt] + aoff + gbyte[1], a);
        mma_bf16(acc[mt][1], a, b[2], b[3]);
      }
    }

    const int wt = tile % n_wt;
    const int ht = (tile / n_wt) % n_ht;
    const int n = tile / (n_wt * n_ht);
    // stage the bf16 tile in this patch buffer (every warp is done reading
    // it), then store each pixel's 128 bytes with 16-byte coalesced writes
    __syncthreads();
    unsigned char* ost = patch + buf * patch_bytes;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = (wm * MT + mt) * 16 + (lane >> 2) + hr * 8;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v0 = acc[mt][j][hr * 2] * sc[j][0] + bi[j][0];
          float v1 = acc[mt][j][hr * 2 + 1] * sc[j][1] + bi[j][1];
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              ost + p * kMmaPS + (wn * 16 + j * 8 + (lane & 3) * 2) * 2) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    __syncthreads();
#pragma unroll
    for (int i = tid; i < TM * 8; i += kMmaThreads) {
      const int p = i >> 3, c = i & 7;
      const int oy = ht * TH + (p >> tw_log2), ox = (wt << tw_log2) + (p & (TW - 1));
      if (oy < Ho && ox < Wo)
        *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(n) * Ho + oy) * Wo + ox) * C +
                                  c0 + c * 8) =
            *reinterpret_cast<const uint4*>(ost + p * kMmaPS + c * 16);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

constexpr int kMaxDevices = 16;

// What the runtime says about one kernel instantiation on each device, asked
// once and not on every launch: the dynamic shared memory it is opted in to,
// the SM count, and its resident blocks per SM for each of its four patch
// sizes (stride 1 or 2, tiles 8 or 16 columns wide).
struct MmaLaunchCache {
  std::mutex mu;
  int opted_in[kMaxDevices] = {};
  int sms[kMaxDevices] = {};
  int per_sm[kMaxDevices][4] = {};
};

// Blocks per slice of one resident wave of `kernel` (kMmaThreads threads,
// `smem` bytes) shared by n_slices slices, rounded down (a block more than
// fits would run as a second wave) and at most n_tiles; 0 on success, else
// a cudaError_t value.
template <typename Kernel>
int resident_blocks(Kernel kernel, MmaLaunchCache& cache, int smem, int variant, int n_slices,
                    int n_tiles, int* per_slice) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    if (cache.opted_in[device] < smem) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      cache.opted_in[device] = smem;
    }
    if (cache.sms[device] == 0) {
      err = cudaDeviceGetAttribute(&cache.sms[device], cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (cache.per_sm[device][variant] == 0) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      cache.per_sm[device][variant] = per_sm > 0 ? per_sm : 1;
    }
    sms = cache.sms[device];
    per_sm = cache.per_sm[device][variant];
  }
  int n = sms * per_sm / n_slices;
  if (n < 1) n = 1;
  *per_slice = n < n_tiles ? n : n_tiles;
  return 0;
}

template <int CPG, int TM>
int launch_mma(const void* x, const void* w, const void* scale, const void* bias, void* out,
               int N, int H, int W, int C, int stride, int relu, cudaStream_t stream) {
  static MmaLaunchCache cache;
  auto kernel = grouped_conv3x3_mma_kernel<CPG, TM>;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const int tw_log2 = Wo <= 8 ? 3 : 4;
  const int TW = 1 << tw_log2, TH = TM / TW;
  const int PR = (TH - 1) * stride + 3, PW = (TW - 1) * stride + 3;
  const int smem = mma_k_rows<CPG>() * kMmaCB * 2 + 2 * PR * PW * kMmaPS;
  const int variant = (stride == 2) * 2 + (tw_log2 == 3);
  const int n_slices = C / kMmaCB;
  const int n_tiles = N * ((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW);
  // one resident wave shared by the slices; each block walks its run of tiles
  int per_slice = 0;
  const int err = resident_blocks(kernel, cache, smem, variant, n_slices, n_tiles, &per_slice);
  if (err != 0) return err;
  kernel<<<dim3(per_slice, n_slices), kMmaThreads, smem, stream>>>(
      static_cast<const cpt::bf16*>(x), static_cast<const cpt::bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<cpt::bf16*>(out), H, W, C, stride, Ho, Wo, relu, tw_log2, n_tiles);
  return cpt::launch_status();
}

template <int TM>
int launch_mma_cpg(int cpg, const void* x, const void* w, const void* scale, const void* bias,
                   void* out, int N, int H, int W, int C, int stride, int relu,
                   cudaStream_t stream) {
  switch (cpg) {
    case 8: return launch_mma<8, TM>(x, w, scale, bias, out, N, H, W, C, stride, relu, stream);
    case 16: return launch_mma<16, TM>(x, w, scale, bias, out, N, H, W, C, stride, relu, stream);
    case 32: return launch_mma<32, TM>(x, w, scale, bias, out, N, H, W, C, stride, relu, stream);
    case 64: return launch_mma<64, TM>(x, w, scale, bias, out, N, H, W, C, stride, relu, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- K1q's tensor-core path -----------------------------------------------

constexpr int kQPS = kMmaCB + 16;         // int8 patch bytes per pixel, 16-byte pad
constexpr int kQOutPS = kMmaCB * 2 + 16;  // staged bf16 output bytes per pixel

// Rows of K1q's weight matrix (K = 9 * cpg, k = tap * cpg + ci), padded to
// the k32 step, and the bytes between two output channels' rows of it in
// shared memory (16 past K: eight rows fall in distinct banks).
template <int CPG>
__host__ __device__ constexpr int q_k_rows() { return (9 * CPG + 31) / 32 * 32; }
template <int CPG>
__host__ __device__ constexpr int q_w_pitch() { return q_k_rows<CPG>() + 16; }

__device__ __forceinline__ unsigned lds32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// K1's tiling on int8: one block, the 64-channel slice blockIdx.y, output
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... of n_tiles; a tile is
// TM >> tw_log2 rows x 1 << tw_log2 columns. Differences from K1: a k32
// step of mma.sync m16n8k32 s8 is 32 input channels of one tap at cpg 32
// (half a tap at 64), two taps at cpg 16 and four at cpg 8 (K 72 -> 96: the
// tail's weights are zero and its A reads repeat tap 8); the weights are
// staged transposed ([n][k], k contiguous: s8 B fragments are k-major and
// sm_90 has no 8-bit ldmatrix.trans), so B comes from plain ldmatrix; at
// cpg 8 a 16-byte ldmatrix row would span two groups, so A comes from
// 4-byte shared loads there; the bf16 output tile has a buffer of its own
// (a 144-byte output pixel does not fit the 80-byte patch pixel).
template <int CPG, int TM>
__global__ void __launch_bounds__(kMmaThreads)
    grouped_conv3x3_int8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias,
                                    cpt::bf16* __restrict__ out, int H, int W, int C,
                                    int stride, int Ho, int Wo, int relu, int tw_log2,
                                    int n_tiles) {
  constexpr int KR = q_k_rows<CPG>(), WP = q_w_pitch<CPG>();
  constexpr int KS = KR / 32;               // k32 steps
  constexpr int MT = TM / 32;               // m16 tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wsm = smem;                // [64][WP]: output channel n's row of k
  unsigned char* ost = smem + kMmaCB * WP;  // [TM][kQOutPS] bf16 output tile
  unsigned char* patch = ost + TM * kQOutPS;  // 2 x [PR][PW] pixels of kQPS bytes

  const int TW = 1 << tw_log2, TH = TM >> tw_log2;
  const int PR = (TH - 1) * stride + 3, PW = (TW - 1) * stride + 3;
  const int PWe = (PW + 1) >> 1;            // stride 2: even columns, then odd ones
  const int patch_bytes = PR * PW * kQPS;
  const int n_wt = (Wo + TW - 1) >> tw_log2, n_ht = (Ho + TH - 1) / TH;
  const int c0 = blockIdx.y * kMmaCB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // pixel half, 16-channel quarter

  // the slice's weights, transposed: a thread takes 4 rows k of the HWIO
  // matrix x 4 output channels and writes 4 k-bytes of each channel's row;
  // rows past 9 * cpg are zero
  for (int i = tid; i < (KR / 4) * (kMmaCB / 4); i += kMmaThreads) {
    const int ng = i % (kMmaCB / 4), kg = i / (kMmaCB / 4);
    int rows[4], cols[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * kg + r;
      rows[r] = k < 9 * CPG
                    ? *reinterpret_cast<const int*>(w + static_cast<size_t>(k) * C + c0 + 4 * ng)
                    : 0;
    }
    cpt::transpose4x4_s8(rows, cols);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<int*>(wsm + (4 * ng + j) * WP + 4 * kg) = cols[j];
  }

  // this thread's first (row, column, chunk) of a patch; the walk steps by
  // kMmaThreads / 4 pixels (a pixel is four 16-byte chunks)
  const int ch = tid & 3;
  const int r_first = (tid >> 2) / PW, j_first = (tid >> 2) - r_first * PW;
  auto stage = [&](int tile, int buf) {
    const int wt = tile % n_wt;
    const int ht = (tile / n_wt) % n_ht;
    const int n = tile / (n_wt * n_ht);
    const int iy0 = ht * TH * stride - 1, ix0 = (wt << tw_log2) * stride - 1;
    const unsigned dst0 = cpt::smem_u32(patch + buf * patch_bytes) + ch * 16;
    const int8_t* src0 = x + static_cast<size_t>(n) * H * W * C + c0 + ch * 16;
    int r = r_first, j = j_first;
    for (int pix = tid >> 2; pix < PR * PW; pix += kMmaThreads / 4) {
      const int iy = iy0 + r, ix = ix0 + j;
      const bool valid = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const int col = stride == 1 ? j : ((j & 1) ? PWe + (j >> 1) : (j >> 1));
      cp_async16(dst0 + (r * PW + col) * kQPS,
                 valid ? src0 + (static_cast<size_t>(iy) * W + ix) * C : x, valid);
      j += kMmaThreads / 4;
      while (j >= PW) {
        j -= PW;
        ++r;
      }
    }
  };

  // byte offset of tap t (ky, kx) from an output pixel's (0, 0) pixel; the
  // k32 tail's taps (t > 8) read tap 8 against zero weights
  auto tap_off = [&](int t) {
    t = t < 9 ? t : 8;
    const int ky = t / 3, kx = t % 3;
    const int col = stride == 1 ? kx : (kx == 1 ? PWe : kx >> 1);
    return (ky * PW + col) * kQPS;
  };
  // the first input channel (byte) of the group of each n8 tile
  constexpr int NG = CPG >= 16 ? 1 : 2;     // groups a warp's 16 channels span
  int gbyte[NG];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) gbyte[gi] = ((wn * 16 + gi * 8) / CPG) * CPG;
  // A, cpg >= 16: ldmatrix rows, pixel (lane & 15) of each m16 tile, k
  // half lane >> 4 (16 channels); cpg 8: rows g and g + 8, k 4t..4t+3
  const int half = lane >> 4, g = lane >> 2, t4 = lane & 3;
  int apix[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = (wm * MT + mt) * 16 + (CPG >= 16 ? (lane & 15) : g + 8 * hr);
      const int oy = p >> tw_log2, ox = p & (TW - 1);
      apix[mt][hr] = (oy * stride * PW + ox) * kQPS;
    }
  // A's offset of this lane at each k32 step
  int aoff[KS][2];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
    if constexpr (CPG >= 32) {
      aoff[kc][0] = aoff[kc][1] = tap_off((kc * 32) / CPG) + (kc * 32) % CPG + half * 16;
    } else if constexpr (CPG == 16) {
      aoff[kc][0] = aoff[kc][1] = tap_off(2 * kc + half);
    } else {  // cpg 8: k 4t..4t+3 is tap t / 2 of the step, k 16 + 4t.. tap 2 + t / 2
      aoff[kc][0] = tap_off(4 * kc + (t4 >> 1)) + (t4 & 1) * 4;
      aoff[kc][1] = tap_off(4 * kc + 2 + (t4 >> 1)) + (t4 & 1) * 4;
    }
  }
  // B: ldmatrix x4 over the [n][k] rows: matrices (n8 tile 0, k 0-15),
  // (tile 0, k 16-31), (tile 1, k 0-15), (tile 1, k 16-31)
  const unsigned bbase = cpt::smem_u32(wsm) + (wn * 16 + (lane >> 4) * 8 + (lane & 7)) * WP +
                         ((lane >> 3) & 1) * 16;

  // the epilogue's channels: this lane's pair in each n8 tile
  float sc[2][2], bi[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = c0 + wn * 16 + j * 8 + t4 * 2 + e;
      sc[j][e] = scale[co];
      bi[j][e] = bias[co];
    }

  int tile = blockIdx.x;
  if (tile < n_tiles) stage(tile, 0);
  cp_async_commit();
  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < n_tiles) stage(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();  // all but the newest group: this tile's patch
    __syncthreads();   // ... from every thread (and, at the first tile, the weights)

    const unsigned pbase = cpt::smem_u32(patch + buf * patch_bytes);
    int acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      unsigned b[4];
      ldsm_x4(bbase + kc * 32, b);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        if constexpr (CPG >= 16) {
          ldsm_x4(pbase + apix[mt][0] + aoff[kc][0] + gbyte[0], a);
          cpt::mma_s8(acc[mt][0], a, b[0], b[1]);
          cpt::mma_s8(acc[mt][1], a, b[2], b[3]);
        } else {
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            a[0] = lds32(pbase + apix[mt][0] + aoff[kc][0] + gbyte[gi]);
            a[1] = lds32(pbase + apix[mt][1] + aoff[kc][0] + gbyte[gi]);
            a[2] = lds32(pbase + apix[mt][0] + aoff[kc][1] + gbyte[gi]);
            a[3] = lds32(pbase + apix[mt][1] + aoff[kc][1] + gbyte[gi]);
            cpt::mma_s8(acc[mt][gi], a, b[2 * gi], b[2 * gi + 1]);
          }
        }
      }
    }

    // the epilogue of the plain version, y * scale + bias with two
    // roundings, ReLU, one bf16 rounding, staged as 128-byte pixels
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = (wm * MT + mt) * 16 + g + hr * 8;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][j][hr * 2]), sc[j][0]), bi[j][0]);
          float v1 =
              __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][j][hr * 2 + 1]), sc[j][1]), bi[j][1]);
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(ost + p * kQOutPS + (wn * 16 + j * 8 + t4 * 2) * 2) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    __syncthreads();   // the tile is staged; every warp is done reading this patch
    const int wt = tile % n_wt;
    const int ht = (tile / n_wt) % n_ht;
    const int n = tile / (n_wt * n_ht);
#pragma unroll
    for (int i = tid; i < TM * 8; i += kMmaThreads) {
      const int p = i >> 3, c = i & 7;
      const int oy = ht * TH + (p >> tw_log2), ox = (wt << tw_log2) + (p & (TW - 1));
      if (oy < Ho && ox < Wo)
        *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(n) * Ho + oy) * Wo + ox) * C +
                                  c0 + c * 8) =
            *reinterpret_cast<const uint4*>(ost + p * kQOutPS + c * 16);
    }
    // the next tile's __syncthreads keeps its staging after these reads
  }
}

template <int CPG, int TM>
int launch_int8_mma(const void* x, const void* w, const void* scale, const void* bias,
                    void* out, int N, int H, int W, int C, int stride, int relu,
                    cudaStream_t stream) {
  static MmaLaunchCache cache;
  auto kernel = grouped_conv3x3_int8_mma_kernel<CPG, TM>;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const int tw_log2 = Wo <= 8 ? 3 : 4;
  const int TW = 1 << tw_log2, TH = TM / TW;
  const int PR = (TH - 1) * stride + 3, PW = (TW - 1) * stride + 3;
  const int smem = kMmaCB * q_w_pitch<CPG>() + TM * kQOutPS + 2 * PR * PW * kQPS;
  const int variant = (stride == 2) * 2 + (tw_log2 == 3);
  const int n_slices = C / kMmaCB;
  const int n_tiles = N * ((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW);
  int per_slice = 0;
  const int err = resident_blocks(kernel, cache, smem, variant, n_slices, n_tiles, &per_slice);
  if (err != 0) return err;
  kernel<<<dim3(per_slice, n_slices), kMmaThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<cpt::bf16*>(out), H, W, C, stride, Ho, Wo, relu, tw_log2, n_tiles);
  return cpt::launch_status();
}

template <int TM>
int launch_int8_mma_cpg(int cpg, const void* x, const void* w, const void* scale,
                        const void* bias, void* out, int N, int H, int W, int C, int stride,
                        int relu, cudaStream_t stream) {
  switch (cpg) {
    case 8: return launch_int8_mma<8, TM>(x, w, scale, bias, out, N, H, W, C, stride, relu, stream);
    case 16: return launch_int8_mma<16, TM>(x, w, scale, bias, out, N, H, W, C, stride, relu, stream);
    case 32: return launch_int8_mma<32, TM>(x, w, scale, bias, out, N, H, W, C, stride, relu, stream);
    case 64: return launch_int8_mma<64, TM>(x, w, scale, bias, out, N, H, W, C, stride, relu, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The CUDA-core path. x [N, H, W, C], w [3, 3, cpg, C] (HWIO), scale/bias
// [C] f32, out [N, Ho, Wo, C]. The wrapper guarantees cpg % 4 == 0, C % 8 == 0,
// C % CB == 0 and CB % cpg == 0 for the slice width CB = min(C, 128), and
// 16-byte aligned rows of x.
CPT_EXPORT int cpt_grouped_conv3x3(const void* x, const void* w, const void* scale,
                                   const void* bias, void* out, int N, int H, int W,
                                   int C, int cpg, int stride, int relu, void* stream) {
  const int Ho = (H + 2 - 3) / stride + 1;
  const int Wo = (W + 2 - 3) / stride + 1;
  const int CB = C < 128 ? C : 128;
  const int TH = stride == 1 ? 4 : 2;  // keeps the staged patch under 48 KB
  const long long blocks = static_cast<long long>(N) * (C / CB) * ((Ho + TH - 1) / TH) *
                           ((Wo + kTW - 1) / kTW);
  const int PR = (TH - 1) * stride + 3;
  const int PW = (kTW - 1) * stride + 3;
  const int CBP = (CB - 1) + ((CB - 1) >> 5) + 1;
  const size_t smem = sizeof(float) * PR * PW * CBP;
  grouped_conv3x3_kernel<<<static_cast<unsigned>(blocks), dim3(CB / kCO, TH), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const cpt::bf16*>(x), static_cast<const cpt::bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<cpt::bf16*>(out), H, W, C, cpg, stride, Ho, Wo, relu, CB);
  return cpt::launch_status();
}

// The tensor-core path. x [N, H, W, C], w [3, 3, cpg, C] (HWIO), scale/bias
// [C] f32, out [N, Ho, Wo, C]. The wrapper guarantees cpg in {8, 16, 32, 64},
// C % 64 == 0 and 16-byte aligned x and w. Tiles of 128 output pixels at
// stride 1; 64 at stride 2 (its patch is four times the tile) and on maps of
// at most 64 output pixels (stage 5's 7x7).
CPT_EXPORT int cpt_grouped_conv3x3_mma(const void* x, const void* w, const void* scale,
                                       const void* bias, void* out, int N, int H, int W,
                                       int C, int cpg, int stride, int relu, void* stream) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 2 || Ho * Wo <= 64)
    return launch_mma_cpg<64>(cpg, x, w, scale, bias, out, N, H, W, C, stride, relu, s);
  return launch_mma_cpg<128>(cpg, x, w, scale, bias, out, N, H, W, C, stride, relu, s);
}

// K1q's CUDA-core path. x [N, H, W, C] int8, w [3, 3, cpg, C] int8 (HWIO),
// scale/bias [C] f32 (scale = the whole dequant multiplier), out [N, Ho, Wo,
// C] bf16. The
// wrapper guarantees cpg % 4 == 0, C % 16 == 0, C % CB == 0 and CB % cpg == 0
// for CB = min(C, 128), and 16-byte aligned x and w.
CPT_EXPORT int cpt_grouped_conv3x3_int8(const void* x, const void* w, const void* scale,
                                        const void* bias, void* out, int N, int H, int W,
                                        int C, int cpg, int stride, int relu, void* stream) {
  const int Ho = (H + 2 - 3) / stride + 1;
  const int Wo = (W + 2 - 3) / stride + 1;
  const int CB = C < 128 ? C : 128;
  const long long blocks = static_cast<long long>(N) * (C / CB) *
                           ((Ho + kQTH - 1) / kQTH) * ((Wo + kTW - 1) / kTW);
  const int PR = (kQTH - 1) * stride + 3;
  const int PW = (kTW - 1) * stride + 3;
  const size_t smem = static_cast<size_t>(PR) * PW * CB;  // 37 KB at stride 2
  grouped_conv3x3_int8_kernel<<<static_cast<unsigned>(blocks), dim3(CB / kCO, kQTH), smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<cpt::bf16*>(out), H, W, C, cpg, stride, Ho, Wo, relu, CB);
  return cpt::launch_status();
}

// K1q's tensor-core path. x [N, H, W, C] int8, w [3, 3, cpg, C] int8 (HWIO),
// scale/bias [C] f32, out [N, Ho, Wo, C] bf16. The wrapper guarantees cpg in
// {8, 16, 32, 64}, C % 64 == 0 and 16-byte aligned x and w. Tiles as K1's
// tensor-core path: 128 output pixels at stride 1, 64 at stride 2 and on
// maps of at most 64 output pixels.
CPT_EXPORT int cpt_grouped_conv3x3_int8_mma(const void* x, const void* w, const void* scale,
                                            const void* bias, void* out, int N, int H, int W,
                                            int C, int cpg, int stride, int relu,
                                            void* stream) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 2 || Ho * Wo <= 64)
    return launch_int8_mma_cpg<64>(cpg, x, w, scale, bias, out, N, H, W, C, stride, relu, s);
  return launch_int8_mma_cpg<128>(cpg, x, w, scale, bias, out, N, H, W, C, stride, relu, s);
}
