// K1: grouped 3x3 convolution, pad 1, stride 1 or 2, NHWC bf16, with the
// frozen-BN affine and ReLU fused into an f32 epilogue.
//
// Replaces cpt_tpu/ops/grouped_conv.py::grouped_conv3x3_sd (_sd_kernel, the
// slice-dense tap matmuls, stride 1) and grouped_conv3x3 (_kernel, per-group
// im2col, stride 1 or 2). The TPU kernels densified the groups into
// block-diagonal 128x128 tap matrices to feed the MXU; on Hopper that would
// multiply 128/cpg times more than needed, so this kernel computes the
// grouped sum directly.
//
// What bounds it: the X152 grouped legs are small-K products (9 * cpg
// multiply-adds per output, cpg = 8..64), run here on the CUDA cores, so the
// limit is instruction issue: FMAs plus the loads that feed them. Design:
// one block per (image, tile of TH output rows x kTW output columns,
// 128-channel slice) stages its input patch once in shared memory as f32.
// Each thread owns kCO = 4 adjacent output channels (one group, since
// cpg % 4 == 0) of kTW = 8 columns of one row: 32 accumulators in
// registers, so each staged input value feeds 4 FMAs and each weight load
// (4 bf16, one 8-byte load, coalesced across the warp) feeds 8. Staged
// channels are padded one word per 32 so that the up-to-16 groups a warp
// reads at once fall in distinct banks. Tensor cores are not used yet.
//
// K1q (cpt_grouped_conv3x3_int8, below): the same conv on int8 activations
// and int8 weights, for the W8A8 path (ops/quant.py::int8_conv with
// groups > 1; cpt_tpu/models/detector/resnet.py:176-179 runs it as an XLA
// int8 conv, so it has no Pallas kernel of its own). Same tiling, but the
// patch is staged as int8 (4 channels a word) and each thread sums 4 input
// channels per __dp4a: exact int32 sums of 9 * cpg products. The 4 weights
// of one input channel for its 4 output channels are one 4-byte load of the
// HWIO row; four such rows are transposed in registers (byte permutes) into
// one word per output channel. The epilogue is y * scale[c] + bias[c] with
// two roundings (__fmul_rn, __fadd_rn), as the plain version computes it in
// PyTorch, then ReLU and a bf16 store. What bounds it: the int8 reads and
// bf16 writes at X152's shapes are ~63 MB at [8,40,64,1024] (~19 us of
// bandwidth) against 12 G int8 operations; dp4a on the CUDA cores issues far
// below the tensor cores' int8 rate, so instruction issue bounds it first.
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

}  // namespace

// x [N, H, W, C], w [3, 3, cpg, C] (HWIO), scale/bias [C] f32,
// out [N, Ho, Wo, C]. The wrapper guarantees cpg % 4 == 0, C % 8 == 0,
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

// K1q. x [N, H, W, C] int8, w [3, 3, cpg, C] int8 (HWIO), scale/bias [C]
// f32 (scale = the whole dequant multiplier), out [N, Ho, Wo, C] bf16. The
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
