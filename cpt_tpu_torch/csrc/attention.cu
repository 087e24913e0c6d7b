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
// Head dims: the tile at every multiple of 8 up to 256 (mma_attention.cuh's
// with_tile_dim; a multiple of 8 but not of 16 zero-pads its slice to the
// next 16 in shared memory), the CUDA-core kernel of simt_attention.cuh at
// any other (not a multiple of 8, or over 256), as the TPU kernel takes any
// hidden / num_heads. The wrapper's rule (kernels/gemm.attention_path) picks
// the path; `simt` forces the CUDA-core one.
//
// What bounds it: at the serving shape ([16, 12, 120, 64]) latency (each
// block loads 40 KB and scores two key tiles; 384 blocks make one wave); the
// bytes (8.8 MB of qkv in, 2.9 MB of context out) take 3.5 us at 3.35 TB/s.
#include "attention_kernels.cuh"
#include "simt_attention.cuh"

namespace {

namespace ma = cpt::mma_attn;
namespace sa = cpt::simt_attn;

__global__ void __launch_bounds__(sa::kThreads) attention_kernel_simt(const ma::Args a) {
  sa::attention_row<ma::kCore>(a);
}

}  // namespace

// qkv [B*S, 3H] bf16, key_bias [B, S] f32 additive, ctx [B*S, H] bf16, head
// dim d = H / num_heads: on the tensor-core tile where d is a multiple of 8
// up to 256 and simt is 0 (qkv 16-byte aligned), else on the CUDA cores.
CPT_EXPORT int cpt_attention(const void* qkv, const void* key_bias, void* ctx, int B, int S,
                             int H, int num_heads, float scale, int simt, void* stream) {
  if (num_heads <= 0 || H % num_heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int d = H / num_heads;
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
    st[1] = d;
    st[2] = row;
  }
  a.so[0] = static_cast<long long>(S) * H;
  a.so[1] = d;
  a.so[2] = H;
  a.sbias[0] = S;  // key_bias [B, S]: per sequence and key
  a.sbias[3] = 1;
  a.H = num_heads;
  a.S = S;
  a.d = d;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (simt) return sa::launch(attention_kernel_simt, a, B, sa::smem_bytes(d), s);
  if (d > ma::kSplitD) return ma::launch_core_wide(a, B, s);
  return ma::with_tile_dim<16, ma::kSplitD>(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return ma::launch<D>(attention_kernel<D>, a, B, s);
  });
}
