// K3 core: softmax(Q K^T * scale + key_bias) V per (sequence, head), with f32
// scores, f32 softmax and f32 accumulation of P.V, on the packed QKV
// projection [B*S, 3H] (columns [q | k | v], head-major within each).
//
// Replaces the per-head score/softmax/context loop inside
// cpt_tpu/ops/fused_attention.py::_attn_kernel, with its numerics: the f32
// key bias added after the scale, the probabilities normalised in f32 and
// only then rounded to bf16 for P.V. The TPU kernel required S to be a
// multiple of 128 (its tile rule); this one takes any S and masks the ragged
// edge by index, so the serving sequence (70 text tokens + 8..50 regions)
// runs unpadded, and shared memory does not grow with S (a 1020-slot
// long-context sequence runs as a 120-slot one does). A row whose keys are
// all masked stays finite: its scores are a constant -1e4 shift, and the max
// subtraction keeps exp() in range.
//
// The body is the tensor-core tile of mma_attention.cuh in its kCore mode:
// a block of 4 warps per (sequence, head, 64 query rows), Q.K^T and P.V on
// mma.sync m16n8k16, K and V in 64-key tiles through a two-stage cp.async
// ring, P in registers. Normalise-then-round needs each row's max and sum
// before P.V: up to S = 128 the block holds both key tiles' scores in
// registers and runs one softmax over them; beyond, it walks the keys twice
// (pass 1: Q.K^T for the row stats; pass 2: Q.K^T again, p, P.V), one extra
// Q.K^T a tile.
//
// What bounds it: at the serving shape ([16, 12, 120, 64]) latency (each
// block loads 40 KB and scores two key tiles; 384 blocks make one wave); the
// bytes (8.8 MB of qkv in, 2.9 MB of context out) take 3.5 us at 3.35 TB/s.
#include "mma_attention.cuh"

namespace {

namespace ma = cpt::mma_attn;

template <int D>
__global__ void __launch_bounds__(ma::kThreads, ma::min_blocks<D>())
    attention_kernel(const ma::Args a) {
  ma::attention_tile<D, ma::kCore>(a);
}

}  // namespace

// qkv [B*S, 3H] bf16, key_bias [B, S] f32 additive, ctx [B*S, H] bf16.
// Head dim H / num_heads must be 64 (every Oscar configuration).
CPT_EXPORT int cpt_attention(const void* qkv, const void* key_bias, void* ctx, int B, int S,
                             int H, int num_heads, float scale, void* stream) {
  if (H != num_heads * 64) return static_cast<int>(cudaErrorInvalidValue);
  const cpt::bf16* base = static_cast<const cpt::bf16*>(qkv);
  const long long row = 3LL * H, seq = row * S;
  ma::Args a{};
  a.q = base;
  a.k = base + H;
  a.v = base + 2 * H;
  a.bias = key_bias;
  a.out = static_cast<cpt::bf16*>(ctx);
  long long* qkv_strides[3] = {a.sq, a.sk, a.sv};
  for (long long* st : qkv_strides) {
    st[0] = seq;
    st[1] = 64;
    st[2] = row;
  }
  a.so[0] = static_cast<long long>(S) * H;
  a.so[1] = 64;
  a.so[2] = H;
  a.sbias[0] = S;  // key_bias [B, S]: per sequence and key
  a.sbias[3] = 1;
  a.H = num_heads;
  a.S = S;
  a.scale = scale;
  return ma::launch<64>(attention_kernel<64>, a, B, static_cast<cudaStream_t>(stream));
}
