// K3 core: softmax(Q K^T * scale + key_bias) V per (sequence, head), with f32
// scores, f32 softmax and f32 accumulation of P.V, on the packed QKV
// projection [B*S, 3H] (columns [q | k | v], head-major within each).
//
// Replaces the per-head score/softmax/context loop inside
// cpt_tpu/ops/fused_attention.py::_attn_kernel. The TPU kernel required S to
// be a multiple of 128 (its tile rule); this kernel takes any S up to the
// shared-memory limit and masks the ragged edge itself, so the serving
// sequence (70 text tokens + 8..50 regions) runs without padding. A row
// whose keys are all masked stays finite: its scores are a constant -1e4
// shift, and the max subtraction keeps exp() in range.
//
// What bounds it: at S ~ 120 and head_dim 64 the work is small (2 * S^2 * 64
// multiply-adds per head) and latency-bound. Design: one block per
// (sequence, head, tile of kQT queries) stages that head's K and V once in
// shared memory (rows padded to an odd word count so a warp reading 32 rows
// hits 32 banks); each warp owns one query row at a time: lane j scores keys
// j, j+32, ...; two warp reductions give max and sum; probabilities are
// rounded to bf16 (as the TPU kernel feeds them to its P.V matmul) and each
// lane accumulates two of the 64 output dims. CUDA cores only; a tensor-core
// flash-style version is a later change.
#include "common.cuh"

namespace {

constexpr int kQT = 32;      // queries per block
constexpr int kWarps = 4;

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const cpt::bf16* __restrict__ qkv, const float* __restrict__ key_bias,
                     cpt::bf16* __restrict__ ctx, int S, int H, float scale) {
  constexpr int LDW = HD / 2 + 1;  // 32-bit words per staged K/V row (odd)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat162* Ks = reinterpret_cast<__nv_bfloat162*>(smem);
  __nv_bfloat162* Vs = Ks + S * LDW;
  float* bias_s = reinterpret_cast<float*>(Vs + S * LDW);
  float* Pbuf = bias_s + S;           // [kWarps][S]
  float* Qbuf = Pbuf + kWarps * S;    // [kWarps][HD]

  const int q_tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_words = static_cast<size_t>(3 * H) / 2;  // bf16 pairs per QKV row
  const __nv_bfloat162* qkv2 = reinterpret_cast<const __nv_bfloat162*>(qkv);
  const size_t seq0 = static_cast<size_t>(b) * S;

  for (int i = threadIdx.x; i < S * (HD / 2); i += blockDim.x) {
    const int j = i / (HD / 2), d2 = i % (HD / 2);
    const __nv_bfloat162* src = qkv2 + (seq0 + j) * row_words;
    Ks[j * LDW + d2] = src[(H + h * HD) / 2 + d2];
    Vs[j * LDW + d2] = src[(2 * H + h * HD) / 2 + d2];
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x) bias_s[j] = key_bias[seq0 + j];
  __syncthreads();

  float* P = Pbuf + warp * S;
  float* Q = Qbuf + warp * HD;
  const int q_end = min(q_tile * kQT + kQT, S);
  for (int q = q_tile * kQT + warp; q < q_end; q += kWarps) {
    const cpt::bf16* qrow = qkv + (seq0 + q) * 3 * static_cast<size_t>(H) + h * HD;
    for (int d = lane; d < HD; d += 32) Q[d] = __bfloat162float(qrow[d]);
    __syncwarp();

    float mx = -3.0e38f;
    for (int j = lane; j < S; j += 32) {
      const __nv_bfloat162* kr = Ks + j * LDW;
      float s = 0.f;
#pragma unroll
      for (int d2 = 0; d2 < HD / 2; ++d2) {
        const float2 kv = __bfloat1622float2(kr[d2]);
        s += Q[2 * d2] * kv.x + Q[2 * d2 + 1] * kv.y;
      }
      s = s * scale + bias_s[j];
      P[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = cpt::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(P[j] - mx);
      P[j] = e;
      sum += e;
    }
    sum = cpt::warp_sum(sum);
    for (int j = lane; j < S; j += 32) P[j] = __bfloat162float(__float2bfloat16(P[j] / sum));
    __syncwarp();

    cpt::bf16* out = ctx + (seq0 + q) * static_cast<size_t>(H) + h * HD;
    for (int d2 = lane; d2 < HD / 2; d2 += 32) {
      float2 acc = make_float2(0.f, 0.f);
      for (int j = 0; j < S; ++j) {
        const float p = P[j];
        const float2 v = __bfloat1622float2(Vs[j * LDW + d2]);
        acc.x += p * v.x;
        acc.y += p * v.y;
      }
      reinterpret_cast<__nv_bfloat162*>(out)[d2] = __floats2bfloat162_rn(acc.x, acc.y);
    }
    __syncwarp();
  }
}

template <int HD>
size_t attention_smem(int S) {
  return static_cast<size_t>(S) * (HD / 2 + 1) * 4 * 2 + static_cast<size_t>(S) * 4 +
         static_cast<size_t>(kWarps) * S * 4 + static_cast<size_t>(kWarps) * HD * 4;
}

}  // namespace

// Shared memory (bytes) the kernel needs for sequence length S and head dim
// hd; 0 for an unsupported head dim. The wrapper checks it against the card.
CPT_EXPORT long long cpt_attention_smem_bytes(int S, int hd) {
  if (hd != 64) return 0;
  return static_cast<long long>(attention_smem<64>(S));
}

// qkv [B*S, 3H] bf16, key_bias [B, S] f32 additive, ctx [B*S, H] bf16.
// Head dim H / num_heads must be 64 (every Oscar configuration).
CPT_EXPORT int cpt_attention(const void* qkv, const void* key_bias, void* ctx, int B, int S,
                             int H, int num_heads, float scale, void* stream) {
  if (H != num_heads * 64) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = attention_smem<64>(S);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<64>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kQT - 1) / kQT, num_heads, B);
  attention_kernel<64><<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const cpt::bf16*>(qkv), static_cast<const float*>(key_bias),
      static_cast<cpt::bf16*>(ctx), S, H, scale);
  return cpt::launch_status();
}
