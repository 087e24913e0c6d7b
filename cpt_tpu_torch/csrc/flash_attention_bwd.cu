// K6b and K6c: the backward of the flash-attention forward (K6,
// flash_attention.cu), from the row stats m and l that the forward saved and
// di = sum_d o * do (computed beside them in f32):
//
//   p  = exp((q k^T + bias) * scale - m) / l      (0 where l == 0)
//   dv = p^T do,  ds = (do v^T - di) * p * scale,  dk = ds^T q,  dq = ds k
//
// Replace the two TPU kernels that jax.grad reaches through the library's
// flash attention (jax.experimental.pallas.ops.tpu.flash_attention,
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq), with their
// numerics: the bias (bf16) added before the scale, f32 scores and
// accumulators, p multiplied by 1/l (its exponent clamped at 0: see
// flash_tiles.cuh), p rounded to bf16 before p^T do and ds rounded to bf16
// before ds^T q and ds k. The TPU wrapper pads S to 128 with
// -1e9 keys; here the ragged edge is masked by index. ds itself (the bias
// gradient) is not written: no model path asks for it.
//
// Split as the library splits it, so that neither kernel needs atomics:
// K6b: one block per (batch, head, 64-key tile) stages its K and V tiles once
// and walks the query tiles, accumulating dK and dV for its keys in
// registers; K6c: one block per (batch, head, 64-query tile) stages its Q and
// dO tiles once and walks the key tiles, accumulating dQ. Both recompute the
// scores on CUDA cores with dot_tile (flash_tiles.cuh), which sums them in
// another order than the forward's tensor cores (a few ulps; see there).
// What bounds them: at the training shape ([32, 12, 120, 64]) latency and the
// CUDA cores' f32 rate (each kernel recomputes q k^T and do v^T); tensor
// cores are a later change.
#include "flash_tiles.cuh"

#include <math.h>

namespace {

using cpt::flash::kColGroups;
using cpt::flash::kRows;
using cpt::flash::kThreads;
using cpt::flash::kTile;
using cpt::flash::round_bf16;

struct BwdArgs {
  const cpt::bf16* q;
  const cpt::bf16* k;
  const cpt::bf16* v;
  const cpt::bf16* bias;  // nullptr: no bias
  const cpt::bf16* dout;
  const float* m;   // [B, H, S] contiguous
  const float* l;
  const float* di;
  cpt::bf16* dq;
  cpt::bf16* dk;
  cpt::bf16* dv;
  // element strides of batch, head, row
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  long long sbias[4];  // batch, head, query, key (0 = broadcast)
  int H, S;
  float scale;
};

template <int D>
struct Tiles {
  static constexpr int LD = D + 1;       // odd f32 row strides (see flash_tiles.cuh)
  static constexpr int PLD = kTile + 1;
};

// Row stats of the query tile at q0 into shared memory: m, 1/l (0 where l is
// 0 or the row is past S) and di.
__device__ __forceinline__ void stage_rows(const BwdArgs& a, long long bh, int q0, float* row_m,
                                           float* row_il, float* row_di) {
  if (threadIdx.x < kTile) {
    const int qi = q0 + threadIdx.x;
    float m = 0.f, il = 0.f, di = 0.f;
    if (qi < a.S) {
      const long long at = bh * a.S + qi;
      const float l = a.l[at];
      m = a.m[at];
      il = l == 0.f ? 0.f : 1.f / l;
      di = a.di[at];
    }
    row_m[threadIdx.x] = m;
    row_il[threadIdx.x] = il;
    row_di[threadIdx.x] = di;
  }
}

// p and ds of this thread's micro-tile (query rows q0 + r0 + i, keys
// k0 + cg + 8 j), from the staged q, do (query rows) and k, v (keys) tiles.
template <int D>
__device__ __forceinline__ void probs_and_dscores(const BwdArgs& a, const cpt::bf16* bias,
                                                  const float* Qs, const float* dOs,
                                                  const float* Ks, const float* Vs,
                                                  const float* row_m, const float* row_il,
                                                  const float* row_di, int q0, int k0, int r0,
                                                  int cg, float p[kRows][8],
                                                  float ds[kRows][8]) {
  using T = Tiles<D>;
  float dp[kRows][8];
  cpt::flash::dot_tile<D>(Qs, T::LD, Ks, T::LD, r0, cg, p);
  cpt::flash::dot_tile<D>(dOs, T::LD, Vs, T::LD, r0, cg, dp);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    const float m = row_m[r0 + i], il = row_il[r0 + i], di = row_di[r0 + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kj = k0 + cg + 8 * j;
      float x = 0.f;
      if (kj < a.S && il != 0.f) {  // il is 0 past S and where l == 0
        x = p[i][j];
        if (bias != nullptr) x += __bfloat162float(bias[qi * a.sbias[2] + kj * a.sbias[3]]);
        // the scaled score, no fma with -m; the exponent clamped at 0
        // (p <= 1 / l): the forward's tensor-core max may sit an ulp below
        // this recomputed score (flash_tiles.cuh)
        x = expf(fminf(__fmul_rn(x, a.scale) - m, 0.f)) * il;
      }
      p[i][j] = x;
      ds[i][j] = (dp[i][j] - di) * x * a.scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdArgs a) {
  using T = Tiles<D>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                   // [64][LD] this block's keys
  float* Vs = Ks + kTile * T::LD;
  float* Qs = Vs + kTile * T::LD;     // [64][LD] the current query tile
  float* dOs = Qs + kTile * T::LD;
  float* Ps = dOs + kTile * T::LD;    // [64 queries][PLD] p, rounded to bf16
  float* dSs = Ps + kTile * T::PLD;   // [64 queries][PLD] ds, rounded to bf16
  float* row_m = dSs + kTile * T::PLD;
  float* row_il = row_m + kTile;
  float* row_di = row_il + kTile;

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const int rg = threadIdx.x / kColGroups, cg = threadIdx.x % kColGroups;
  const int r0 = rg * kRows;  // micro-tile query rows; accumulated keys k0 + r0 + i
  const long long bh = static_cast<long long>(b) * a.H + h;
  const cpt::bf16* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const cpt::bf16* dob = a.dout + b * a.sdo[0] + h * a.sdo[1];
  const cpt::bf16* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.sbias[0] + h * a.sbias[1];

  cpt::flash::stage_tile<D>(a.k + b * a.sk[0] + h * a.sk[1], a.sk[2], k0, S, Ks, T::LD);
  cpt::flash::stage_tile<D>(a.v + b * a.sv[0] + h * a.sv[1], a.sv[2], k0, S, Vs, T::LD);

  float dk[kRows][D / 8], dv[kRows][D / 8];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    cpt::flash::stage_tile<D>(qb, a.sq[2], q0, S, Qs, T::LD);
    cpt::flash::stage_tile<D>(dob, a.sdo[2], q0, S, dOs, T::LD);
    stage_rows(a, bh, q0, row_m, row_il, row_di);
    __syncthreads();

    float p[kRows][8], ds[kRows][8];
    probs_and_dscores<D>(a, bias, Qs, dOs, Ks, Vs, row_m, row_il, row_di, q0, k0, r0, cg, p, ds);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Ps[(r0 + i) * T::PLD + cg + 8 * j] = round_bf16(p[i][j]);
        dSs[(r0 + i) * T::PLD + cg + 8 * j] = round_bf16(ds[i][j]);
      }
    __syncthreads();

    // dv[key][d] += sum_q p[q][key] do[q][d]; dk[key][d] += sum_q ds[q][key] q[q][d]
    // for keys k0 + r0 .. + 3 and dims cg, cg + 8, ...
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[kRows], sv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = Ps[qq * T::PLD + r0 + i];
        sv[i] = dSs[qq * T::PLD + r0 + i];
      }
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float dov = dOs[qq * T::LD + cg + 8 * c], qv = Qs[qq * T::LD + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          dv[i][c] = fmaf(pv[i], dov, dv[i][c]);
          dk[i][c] = fmaf(sv[i], qv, dk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + r0 + i;
    if (kj >= S) continue;
    cpt::bf16* dkrow = a.dk + b * a.sdk[0] + h * a.sdk[1] + kj * a.sdk[2];
    cpt::bf16* dvrow = a.dv + b * a.sdv[0] + h * a.sdv[1] + kj * a.sdv[2];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      dkrow[cg + 8 * c] = __float2bfloat16(dk[i][c]);
      dvrow[cg + 8 * c] = __float2bfloat16(dv[i][c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  using T = Tiles<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [64][LD] this block's query rows
  float* dOs = Qs + kTile * T::LD;
  float* Ks = dOs + kTile * T::LD;    // [64][LD] the current key tile
  float* Vs = Ks + kTile * T::LD;
  float* dSs = Vs + kTile * T::LD;    // [64 queries][PLD] ds, rounded to bf16
  float* row_m = dSs + kTile * T::PLD;
  float* row_il = row_m + kTile;
  float* row_di = row_il + kTile;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const int rg = threadIdx.x / kColGroups, cg = threadIdx.x % kColGroups;
  const int r0 = rg * kRows;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const cpt::bf16* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const cpt::bf16* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const cpt::bf16* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.sbias[0] + h * a.sbias[1];

  cpt::flash::stage_tile<D>(a.q + b * a.sq[0] + h * a.sq[1], a.sq[2], q0, S, Qs, T::LD);
  cpt::flash::stage_tile<D>(a.dout + b * a.sdo[0] + h * a.sdo[1], a.sdo[2], q0, S, dOs, T::LD);
  stage_rows(a, bh, q0, row_m, row_il, row_di);

  float dq[kRows][D / 8];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dq[i][c] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    cpt::flash::stage_tile<D>(kb, a.sk[2], k0, S, Ks, T::LD);
    cpt::flash::stage_tile<D>(vb, a.sv[2], k0, S, Vs, T::LD);
    __syncthreads();

    float p[kRows][8], ds[kRows][8];
    probs_and_dscores<D>(a, bias, Qs, dOs, Ks, Vs, row_m, row_il, row_di, q0, k0, r0, cg, p, ds);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dSs[(r0 + i) * T::PLD + cg + 8 * j] = round_bf16(ds[i][j]);
    __syncthreads();

    // dq[q][d] += sum_key ds[q][key] k[key][d], rows q0 + r0 .. + 3, dims cg, cg + 8, ...
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float sv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sv[i] = dSs[(r0 + i) * T::PLD + kk];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float kv = Ks[kk * T::LD + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) dq[i][c] = fmaf(sv[i], kv, dq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= S) continue;
    cpt::bf16* row = a.dq + b * a.sdq[0] + h * a.sdq[1] + qi * a.sdq[2];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) row[cg + 8 * c] = __float2bfloat16(dq[i][c]);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return (4 * kTile * Tiles<D>::LD + 2 * kTile * Tiles<D>::PLD + 3 * kTile) * sizeof(float);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return (4 * kTile * Tiles<D>::LD + kTile * Tiles<D>::PLD + 3 * kTile) * sizeof(float);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const BwdArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + kTile - 1) / kTile, a.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cpt::launch_status();
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* bias, const void* dout,
                  const void* m, const void* l, const void* di, void* dq, void* dk, void* dv,
                  const long long* strides, int H, int S, float scale) {
  BwdArgs a;
  a.q = static_cast<const cpt::bf16*>(q);
  a.k = static_cast<const cpt::bf16*>(k);
  a.v = static_cast<const cpt::bf16*>(v);
  a.bias = static_cast<const cpt::bf16*>(bias);
  a.dout = static_cast<const cpt::bf16*>(dout);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.di = static_cast<const float*>(di);
  a.dq = static_cast<cpt::bf16*>(dq);
  a.dk = static_cast<cpt::bf16*>(dk);
  a.dv = static_cast<cpt::bf16*>(dv);
  long long* dst[7] = {a.sq, a.sk, a.sv, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  for (int i = 0; i < 4; ++i) a.sbias[i] = strides[21 + i];
  a.H = H;
  a.S = S;
  a.scale = scale;
  return a;
}

}  // namespace

// q, k, v, dout [B, H, S, D] bf16 by pointer and element strides (batch,
// head, row; the last dim contiguous, rows 16-byte aligned); bias bf16
// broadcast to [B, H, S, S] by its four strides, or null; m, l (the forward's
// row stats) and di (sum_d o * dout) contiguous f32 [B, H, S]. strides:
// q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3], bias[4]. D must be 32, 64
// or 128. K6b writes dk and dv [B, H, S, D] bf16 (dq is not touched).
CPT_EXPORT int cpt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* bias, const void* dout, const void* m,
                                           const void* l, const void* di, void* dk, void* dv,
                                           const long long* strides, int B, int H, int S,
                                           int D, float scale, void* stream) {
  const BwdArgs a = make_args(q, k, v, bias, dout, m, l, di, nullptr, dk, dv, strides, H, S, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch(flash_bwd_dkv_kernel<32>, dkv_smem_bytes<32>(), a, B, s);
    case 64: return launch(flash_bwd_dkv_kernel<64>, dkv_smem_bytes<64>(), a, B, s);
    case 128: return launch(flash_bwd_dkv_kernel<128>, dkv_smem_bytes<128>(), a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6c: the same inputs; writes dq [B, H, S, D] bf16 (dk, dv are not touched).
CPT_EXPORT int cpt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* bias, const void* dout, const void* m,
                                          const void* l, const void* di, void* dq,
                                          const long long* strides, int B, int H, int S, int D,
                                          float scale, void* stream) {
  const BwdArgs a = make_args(q, k, v, bias, dout, m, l, di, dq, nullptr, nullptr, strides, H, S,
                              scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch(flash_bwd_dq_kernel<32>, dq_smem_bytes<32>(), a, B, s);
    case 64: return launch(flash_bwd_dq_kernel<64>, dq_smem_bytes<64>(), a, B, s);
    case 128: return launch(flash_bwd_dq_kernel<128>, dq_smem_bytes<128>(), a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
