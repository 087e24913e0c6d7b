// K6: flash-attention forward, o = softmax((q k^T + bias) * scale) v, per
// (batch, head), on [B, H, S, D] bf16 views with any batch/head/row strides
// (the last dim contiguous). The bias (bf16) is read through four strides,
// so a [B, 1, 1, S] key bias or a [B, 1, S, S] mask bias broadcast over heads
// is never materialised to [B, H, S, S].
//
// Replaces the TPU flash-attention forward that cpt_tpu/ops/attention.py
// flash_mha calls (jax.experimental.pallas.ops.tpu.flash_attention, reached
// through BertConfig.attention_impl = "flash"), with its numerics: the bias
// is added BEFORE the scale, scores, running max, running sum and the
// accumulator are f32, and the unnormalised probabilities are rounded to
// bf16 before P.V. The TPU wrapper pads S to its 128 block with -1e9 keys;
// here the ragged edge is masked by index, so nothing is padded.
//
// What bounds it: at the serving shape ([16, 12, 120, 64]) the work is
// small (2 * S^2 * D multiply-adds per head) and the bytes few, so launch
// and latency dominate; at long context ([2, 12, 2048, 64]) it is
// compute-bound. Design (simple first; tensor cores are a later change): one
// block of 128 threads per (batch, head, 64-row query tile) stages its Q tile
// in shared memory as f32 once, then walks the keys in tiles of 64: K and V
// tiles are staged as f32 (rows past S zero-filled), each thread scores a
// 4-row x 8-key micro-tile on CUDA cores (odd row strides keep the column
// reads conflict-free), two threads per row update the running max and sum
// (online softmax), and each thread accumulates a 4-row x D/8 slice of the
// output in registers, rescaled by exp(m_old - m_new) per tile. Shared
// memory does not grow with S. A row whose sum is 0 (every score -inf)
// yields 0, as the library's l_next_inv_safe guard. For training it also
// writes each row's final max m and sum l (the library's save_residuals
// outputs), from which K6b and K6c recompute the probabilities.
#include "flash_tiles.cuh"

#include <math.h>

namespace {

using cpt::flash::kColGroups;
using cpt::flash::kRows;
using cpt::flash::kThreads;
constexpr int kBQ = cpt::flash::kTile;  // query rows per block
constexpr int kBK = cpt::flash::kTile;  // keys per staged tile

struct FlashArgs {
  const cpt::bf16* q;
  const cpt::bf16* k;
  const cpt::bf16* v;
  const cpt::bf16* bias;  // nullptr: no bias
  cpt::bf16* out;
  float* m_out;           // [B, H, S] row max of the scaled scores, or nullptr
  float* l_out;           // [B, H, S] row sum of exp(s - m), or nullptr
  long long sq[3], sk[3], sv[3], so[3];  // element strides of batch, head, row
  long long sbias[4];                    // batch, head, query, key (0 = broadcast)
  int H, S;
  float scale;
};

template <int D>
struct Layout {
  static constexpr int QLD = D + 1;    // odd f32 row strides: a warp reading
  static constexpr int KLD = D + 1;    // one column of 4 or 8 rows hits
  static constexpr int PLD = kBK + 1;  // distinct banks
  static constexpr size_t floats = kBQ * QLD + kBK * KLD + kBK * D + kBQ * PLD + 3 * kBQ;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const FlashArgs a) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [kBQ][QLD]
  float* Ks = Qs + kBQ * L::QLD;     // [kBK][KLD]
  float* Vs = Ks + kBK * L::KLD;     // [kBK][D]
  float* Ps = Vs + kBK * D;          // [kBQ][PLD] scores, then probabilities
  float* row_m = Ps + kBQ * L::PLD;  // running max per query row
  float* row_l = row_m + kBQ;        // running sum
  float* row_a = row_l + kBQ;        // this tile's rescale exp(m_old - m_new)

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const int rg = threadIdx.x / kColGroups, cg = threadIdx.x % kColGroups;
  const int r0 = rg * kRows;  // this thread's first query row in the tile

  cpt::flash::stage_tile<D>(a.q + b * a.sq[0] + h * a.sq[1], a.sq[2], q0, S, Qs, L::QLD);
  if (threadIdx.x < kBQ) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.f;
  }
  const cpt::bf16* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const cpt::bf16* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const cpt::bf16* bias =
      a.bias == nullptr ? nullptr : a.bias + b * a.sbias[0] + h * a.sbias[1];

  float acc[kRows][D / 8];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    cpt::flash::stage_tile<D>(kb, a.sk[2], k0, S, Ks, L::KLD);
    cpt::flash::stage_tile<D>(vb, a.sv[2], k0, S, Vs, D);
    __syncthreads();

    // scores of rows r0..r0+3 against keys cg, cg + 8, ..., cg + 56
    float s[kRows][8];
    cpt::flash::dot_tile<D>(Qs, L::QLD, Ks, L::KLD, r0, cg, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + cg + 8 * j;
        float x = -INFINITY;
        if (kj < S) {
          x = s[i][j];
          if (bias != nullptr && qi < S)
            x += __bfloat162float(bias[qi * a.sbias[2] + kj * a.sbias[3]]);
          x *= a.scale;
        }
        Ps[(r0 + i) * L::PLD + cg + 8 * j] = x;
      }
    }
    __syncthreads();

    // online softmax: threads 2r and 2r + 1 share row r, 32 keys each
    {
      const int r = threadIdx.x / 2, half = threadIdx.x % 2;
      float* prow = Ps + r * L::PLD + half * (kBK / 2);
      const float m_old = row_m[r], l_old = row_l[r];
      float mx = -INFINITY;
#pragma unroll 8
      for (int j = 0; j < kBK / 2; ++j) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // every score -inf so far
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < kBK / 2; ++j) {
        const float p = expf(prow[j] - m_use);
        sum += p;
        prow[j] = __bfloat162float(__float2bfloat16(p));  // P.V takes bf16 probabilities
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (half == 0) {
        const float alpha = expf(m_old - m_use);
        row_a[r] = alpha;
        row_l[r] = alpha * l_old + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // o = o * alpha + P V for rows r0..r0+3, dims cg, cg + 8, ...
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float alpha = row_a[r0 + i];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(r0 + i) * L::PLD + j];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float vv = Vs[j * D + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  // the row stats the backward recomputes probabilities from (the last
  // softmax phase ended in a barrier, so row_m / row_l are final)
  if (a.m_out != nullptr && threadIdx.x < kBQ && q0 + threadIdx.x < S) {
    const long long at = (static_cast<long long>(b) * a.H + h) * S + q0 + threadIdx.x;
    const float m = row_m[threadIdx.x];
    a.m_out[at] = m == -INFINITY ? 0.f : m;
    a.l_out[at] = row_l[threadIdx.x];
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= S) continue;
    const float l = row_l[r0 + i];
    const float inv = l == 0.f ? 1.f : 1.f / l;
    cpt::bf16* orow = a.out + b * a.so[0] + h * a.so[1] + qi * a.so[2];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) orow[cg + 8 * c] = __float2bfloat16(acc[i][c] * inv);
  }
}

template <int D>
int launch(const FlashArgs& a, int B, int H, cudaStream_t stream) {
  const size_t smem = Layout<D>::floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return cpt::launch_status();
}

}  // namespace

// q, k, v [B, H, S, D] bf16 and out [B, H, S, D] bf16 given by pointer and
// element strides (batch, head, row; the last dim contiguous, rows 16-byte
// aligned for q/k/v); bias bf16 broadcast to [B, H, S, S] by its four
// strides, or null. m_out, l_out: contiguous f32 [B, H, S] for the row max
// (0 where every score is -inf) and row sum, both null on the serving path.
// strides: q[3], k[3], v[3], out[3], bias[4]. D must be 32, 64 or 128.
CPT_EXPORT int cpt_flash_attention(const void* q, const void* k, const void* v, const void* bias,
                                   void* out, void* m_out, void* l_out,
                                   const long long* strides, int B, int H, int S, int D,
                                   float scale, void* stream) {
  FlashArgs a;
  a.q = static_cast<const cpt::bf16*>(q);
  a.k = static_cast<const cpt::bf16*>(k);
  a.v = static_cast<const cpt::bf16*>(v);
  a.bias = static_cast<const cpt::bf16*>(bias);
  a.out = static_cast<cpt::bf16*>(out);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  for (int i = 0; i < 4; ++i) a.sbias[i] = strides[12 + i];
  a.H = H;
  a.S = S;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(a, B, H, s);
    case 64: return launch<64>(a, B, H, s);
    case 128: return launch<128>(a, B, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
