// K6b and K6c, the flash-attention backward: the entry points, the
// CUDA-core kernels for the head dims the tile does not take, and the tile
// (flash_attention_bwd.cuh, where the design is described) at the dims up to
// mma_attn::kSplitD; flash_attention_bwd_wide.cu holds the larger ones.
#include "flash_attention_bwd.cuh"
#include "simt_attention.cuh"

namespace {

namespace sa = cpt::simt_attn;
namespace fb = cpt::flash_bwd;

// The CUDA-core K6c and K6b for the head dims the tile does not take, on
// simt_attention.cuh's plan: a block of 4 warps owns one row (K6c a query,
// K6b a key), staged in shared memory as f32; per chunk of 128 rows of the
// other side the warps form p and ds (two warp-wide dot products a row: q.k
// and do.v), rounded to bf16 into shared memory, then each thread adds them
// times the other side's rows for its columns, its accumulators in shared
// memory. Element loads only: any head dim, any row stride.

// Shared memory: K6c q, do, dq and the chunk's ds; K6b k, v, dk, dv and the
// chunk's p and ds
int dq_simt_smem(int d) { return (3 * d + sa::kChunk) * 4; }
int dkv_simt_smem(int d) { return (4 * d + 2 * sa::kChunk) * 4; }

__global__ void __launch_bounds__(sa::kThreads) flash_bwd_dq_kernel_simt(const BwdArgs a) {
  extern __shared__ float sh[];
  const int d = a.d, S = a.S;
  float* qs = sh;
  float* dos = qs + d;
  float* acc = dos + d;
  float* ws = acc + d;
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qrow = a.q + b * a.sq[0] + h * a.sq[1] + qi * a.sq[2];
  const bf16* dorow = a.dout + b * a.sdo[0] + h * a.sdo[1] + qi * a.sdo[2];
  for (int c = threadIdx.x; c < d; c += sa::kThreads) {
    qs[c] = __bfloat162float(qrow[c]);
    dos[c] = __bfloat162float(dorow[c]);
    acc[c] = 0.f;
  }
  __syncthreads();
  const long long at = (static_cast<long long>(b) * a.H + h) * S + qi;
  const float m2 = a.m[at] * ma::kLog2e, l = a.l[at], di = a.di[at];
  const float il = l == 0.f ? 0.f : 1.f / l;
  const float scale2 = a.scale * ma::kLog2e;
  const bf16* brow =
      a.bias ? a.bias + b * a.sbias[0] + h * a.sbias[1] + qi * a.sbias[2] : nullptr;
  const bf16* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const bf16* vb = a.v + b * a.sv[0] + h * a.sv[1];
  for (int j0 = 0; j0 < S; j0 += sa::kChunk) {
    const int n = min(sa::kChunk, S - j0);
    for (int jj = warp; jj < n; jj += sa::kWarps) {
      const bf16* kr = kb + (j0 + jj) * a.sk[2];
      const bf16* vr = vb + (j0 + jj) * a.sv[2];
      float s = 0.f, dp = 0.f;
      for (int c = lane; c < d; c += 32) {
        s = fmaf(qs[c], __bfloat162float(kr[c]), s);
        dp = fmaf(dos[c], __bfloat162float(vr[c]), dp);
      }
      s = cpt::warp_sum(s);
      dp = cpt::warp_sum(dp);
      const float bb = brow ? __bfloat162float(brow[j0 + jj]) : 0.f;
      const float p = ma::fast_exp2(fminf((s + bb) * scale2 - m2, 0.f)) * il;
      if (lane == 0) ws[jj] = sa::round_bf16((dp - di) * p * a.scale);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += sa::kThreads) {
      float t = acc[c];
      for (int jj = 0; jj < n; ++jj)
        t = fmaf(ws[jj], __bfloat162float(kb[(j0 + jj) * a.sk[2] + c]), t);
      acc[c] = t;
    }
    __syncthreads();
  }
  bf16* out = a.dq + b * a.sdq[0] + h * a.sdq[1] + qi * a.sdq[2];
  for (int c = threadIdx.x; c < d; c += sa::kThreads) out[c] = __float2bfloat16(acc[c]);
}

__global__ void __launch_bounds__(sa::kThreads) flash_bwd_dkv_kernel_simt(const BwdArgs a) {
  extern __shared__ float sh[];
  const int d = a.d, S = a.S;
  float* ks = sh;
  float* vs = ks + d;
  float* dk = vs + d;
  float* dv = dk + d;
  float* wp = dv + d;
  float* wd = wp + sa::kChunk;
  const int kj = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* krow = a.k + b * a.sk[0] + h * a.sk[1] + kj * a.sk[2];
  const bf16* vrow = a.v + b * a.sv[0] + h * a.sv[1] + kj * a.sv[2];
  for (int c = threadIdx.x; c < d; c += sa::kThreads) {
    ks[c] = __bfloat162float(krow[c]);
    vs[c] = __bfloat162float(vrow[c]);
    dk[c] = dv[c] = 0.f;
  }
  __syncthreads();
  const long long bh = static_cast<long long>(b) * a.H + h;
  const float scale2 = a.scale * ma::kLog2e;
  // bias[q][kj] at bcol[q * sbias[2]]
  const bf16* bcol = a.bias ? a.bias + b * a.sbias[0] + h * a.sbias[1] + kj : nullptr;
  const bf16* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const bf16* dob = a.dout + b * a.sdo[0] + h * a.sdo[1];
  for (int i0 = 0; i0 < S; i0 += sa::kChunk) {
    const int n = min(sa::kChunk, S - i0);
    for (int ii = warp; ii < n; ii += sa::kWarps) {
      const int i = i0 + ii;
      const bf16* qr = qb + i * a.sq[2];
      const bf16* dr = dob + i * a.sdo[2];
      float s = 0.f, dp = 0.f;
      for (int c = lane; c < d; c += 32) {
        s = fmaf(ks[c], __bfloat162float(qr[c]), s);
        dp = fmaf(vs[c], __bfloat162float(dr[c]), dp);
      }
      s = cpt::warp_sum(s);
      dp = cpt::warp_sum(dp);
      if (lane == 0) {
        const float l = a.l[bh * S + i];
        const float il = l == 0.f ? 0.f : 1.f / l;
        const float bb = bcol ? __bfloat162float(bcol[i * a.sbias[2]]) : 0.f;
        const float p = ma::fast_exp2(fminf((s + bb) * scale2 - a.m[bh * S + i] * ma::kLog2e,
                                            0.f)) * il;
        wp[ii] = sa::round_bf16(p);
        wd[ii] = sa::round_bf16((dp - a.di[bh * S + i]) * p * a.scale);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += sa::kThreads) {
      float tk = dk[c], tv = dv[c];
      for (int ii = 0; ii < n; ++ii) {
        tv = fmaf(wp[ii], __bfloat162float(dob[(i0 + ii) * a.sdo[2] + c]), tv);
        tk = fmaf(wd[ii], __bfloat162float(qb[(i0 + ii) * a.sq[2] + c]), tk);
      }
      dk[c] = tk;
      dv[c] = tv;
    }
    __syncthreads();
  }
  bf16* dko = a.dk + b * a.sdk[0] + h * a.sdk[1] + kj * a.sdk[2];
  bf16* dvo = a.dv + b * a.sdv[0] + h * a.sdv[1] + kj * a.sdv[2];
  for (int c = threadIdx.x; c < d; c += sa::kThreads) {
    dko[c] = __float2bfloat16(dk[c]);
    dvo[c] = __float2bfloat16(dv[c]);
  }
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* bias, const void* dout,
                  const void* m, const void* l, const void* di, void* dq, void* dk, void* dv,
                  const long long* strides, int H, int S, int D, float scale) {
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const bf16*>(bias);
  a.dout = static_cast<const bf16*>(dout);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.di = static_cast<const float*>(di);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  long long* dst[7] = {a.sq, a.sk, a.sv, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  for (int i = 0; i < 4; ++i) a.sbias[i] = strides[21 + i];
  a.H = H;
  a.S = S;
  a.d = D;
  a.scale = scale;
  return a;
}

}  // namespace

// q, k, v, dout [B, H, S, D] bf16 by pointer and element strides (batch,
// head, row; the last dim contiguous, rows 16-byte aligned); bias bf16
// broadcast to [B, H, S, S] by its four strides (keys contiguous), or null;
// m, l (the forward's row stats) and di (sum_d o * dout) contiguous f32
// [B, H, S]. strides: q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3],
// bias[4]. The tile where D is a multiple of 8 up to 256 and simt is 0 (rows
// 16-byte aligned), else the CUDA-core kernel. K6b writes dk and dv
// [B, H, S, D] bf16 (dq is not touched).
CPT_EXPORT int cpt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* bias, const void* dout, const void* m,
                                           const void* l, const void* di, void* dk, void* dv,
                                           const long long* strides, int B, int H, int S,
                                           int D, float scale, int simt, void* stream) {
  const BwdArgs a =
      make_args(q, k, v, bias, dout, m, l, di, nullptr, dk, dv, strides, H, S, D, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (simt) return sa::launch(flash_bwd_dkv_kernel_simt, a, B, dkv_simt_smem(D), s);
  if (D > ma::kSplitD) return fb::launch_dkv_wide(a, B, s);
  return ma::with_tile_dim<16, ma::kSplitD>(D, [&](auto dim) {
    constexpr int DT = decltype(dim)::value;
    return ma::launch<DT>(flash_bwd_dkv_kernel<DT>, a, B, s, dkv_smem_bytes<DT>());
  });
}

// K6c: the same inputs; writes dq [B, H, S, D] bf16 (dk, dv are not touched).
CPT_EXPORT int cpt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* bias, const void* dout, const void* m,
                                          const void* l, const void* di, void* dq,
                                          const long long* strides, int B, int H, int S, int D,
                                          float scale, int simt, void* stream) {
  const BwdArgs a = make_args(q, k, v, bias, dout, m, l, di, dq, nullptr, nullptr, strides, H, S,
                              D, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (simt) return sa::launch(flash_bwd_dq_kernel_simt, a, B, dq_simt_smem(D), s);
  if (D > ma::kSplitD) return fb::launch_dq_wide(a, B, s);
  return ma::with_tile_dim<16, ma::kSplitD>(D, [&](auto dim) {
    constexpr int DT = decltype(dim)::value;
    return ma::launch<DT>(flash_bwd_dq_kernel<DT>, a, B, s, dq_smem_bytes<DT>());
  });
}
