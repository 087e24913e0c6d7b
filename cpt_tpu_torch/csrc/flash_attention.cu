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
// accumulator are f32, the unnormalised probabilities are rounded to bf16
// before P.V and the division by the row sum comes at the end; a row whose
// sum is 0 (every score -inf) yields 0, as the library's l_next_inv_safe
// guard. The TPU wrapper pads S to its 128 block with -1e9 keys; here the
// ragged edge is masked by index, so nothing is padded. For training it also
// writes each row's final max m and sum l (the library's save_residuals
// outputs), from which K6b and K6c recompute the probabilities.
//
// The body is the tensor-core tile of mma_attention.cuh in its kFlash mode:
// a block of 4 warps per (batch, head, 64 query rows), Q.K^T and P.V on
// mma.sync m16n8k16, K and V in 64-key tiles through a two-stage cp.async
// ring, P in registers; one softmax over both tiles up to S = 128, an online
// softmax over the streamed tiles beyond; D 32, 64 or 128.
//
// What bounds it: at the serving shape ([16, 12, 120, 64]) latency (two key
// tiles a block, one wave of 384 blocks); at long context ([2, 12, 2048, 64])
// the mma.sync rate and the f32 softmax between the products (the bound at
// the card's bf16 peak is 26 us for its 25.8 GFLOP).
#include "mma_attention.cuh"

namespace {

namespace ma = cpt::mma_attn;

template <int D>
__global__ void __launch_bounds__(ma::kThreads, ma::min_blocks<D>())
    flash_attention_kernel(const ma::Args a) {
  ma::attention_tile<D, ma::kFlash>(a);
}

}  // namespace

// q, k, v [B, H, S, D] bf16 and out [B, H, S, D] bf16 given by pointer and
// element strides (batch, head, row; the last dim contiguous, rows 16-byte
// aligned); bias bf16 broadcast to [B, H, S, S] by its four
// strides, or null. m_out, l_out: contiguous f32 [B, H, S] for the row max
// (0 where every score is -inf) and row sum, both null on the serving path.
// strides: q[3], k[3], v[3], out[3], bias[4]. D must be 32, 64 or 128.
CPT_EXPORT int cpt_flash_attention(const void* q, const void* k, const void* v, const void* bias,
                                   void* out, void* m_out, void* l_out,
                                   const long long* strides, int B, int H, int S, int D,
                                   float scale, void* stream) {
  ma::Args a{};
  a.q = static_cast<const cpt::bf16*>(q);
  a.k = static_cast<const cpt::bf16*>(k);
  a.v = static_cast<const cpt::bf16*>(v);
  a.bias = bias;
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
    case 32: return ma::launch<32>(flash_attention_kernel<32>, a, B, s);
    case 64: return ma::launch<64>(flash_attention_kernel<64>, a, B, s);
    case 128: return ma::launch<128>(flash_attention_kernel<128>, a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
