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
// accumulators, p multiplied by 1/l, p rounded to bf16 before p^T do and ds
// rounded to bf16 before ds^T q and ds k, bf16 outputs. The TPU wrapper pads
// S to 128 with -1e9 keys; here the ragged edge is masked by index: rows at
// or past S are zero-filled and never stored, and their 1/l is 0. ds itself
// (the bias gradient) is not written: no model path asks for it.
//
// The exponent of p is clamped at 0 (p <= 1/l). The recomputed scores come
// from other mma.sync products than the forward's (K6b's are transposed), so
// one may sit an ulp above the row max m that the forward saved; at scores
// of ordinary size the clamp moves p by a relative few 1e-7, far below the
// bf16 rounding of p (2^-9) that follows, and at scores of 1e17 (which a
// random detector's features give layer 0) an ulp of excess would overflow
// the exponential and turn the gradients to NaN. Like the forward, the
// kernels work in log2 units (one ex2 a probability).
//
// Split as the library splits it, so that neither kernel needs atomics and
// the gradients are the same bits from run to run. Both are built on the
// forward's tensor-core tile (mma_attention.cuh: mma.sync m16n8k16 fed by
// ldmatrix, 64-row tiles XOR-swizzled and streamed through a two-stage
// cp.async ring, accumulators packed to bf16 as the next product's A
// fragments, rows stored through shared memory), 4 warps a block, 16 rows a
// warp, grid (ceil(S / 64), heads, batch):
//
//   K6c (dq): a block owns 64 query rows, stages Q and dO once and holds them
//     as A fragments, and streams the 64-key K and V tiles. Per 32 keys:
//     S = Q K^T and dP = dO V^T with K and V as "col" B operands (ldmatrix,
//     as K in the forward), p and ds formed in the accumulators (each lane
//     owns two rows, so m, 1/l and di sit in registers), ds packed to bf16,
//     dQ += dS K with K through ldmatrix.trans (as V in the forward's P.V).
//   K6b (dk, dv), in the transposed orientation so that P and dS never touch
//     shared memory: a block owns 64 keys, stages its K and V tiles once
//     (held as A fragments up to D = 64, re-read from shared memory at
//     D = 128 to stay within the registers of 2 blocks an SM), and streams
//     the 64-query Q and dO tiles. Per 16 queries: S^T = K Q^T and
//     dP^T = V dO^T with Q and dO as "col" B operands, p^T and ds^T formed in
//     the accumulators with keys as rows and queries as columns, packed to
//     bf16, then dV += P^T dO and dK += dS^T Q with dO and Q through
//     ldmatrix.trans. The per-query stats (m, 1/l, di) are per column here:
//     each query tile's 64 values of each are staged in shared memory beside
//     the tile (loaded into registers while the ring's copies are awaited,
//     stored after the barrier) and read by column pair, 4 distinct
//     addresses a warp. The bias bias[q][k] is read at (column, row): a key
//     bias (sbias[2] == 0) is one value a row, hoisted out of the query loop;
//     any other bias takes one bf16 load per score, at stride sbias[2] along
//     the columns, loaded before the products.
// The score tile is formed 32 columns at a time in K6c and 16 in K6b, so
// that at D = 64 what a thread holds (K6b: K's and V's fragments and the
// two D-wide accumulators, 96 registers, beside the chunk's S^T, dP^T and
// bias) fits without spilling in the 168 registers of 3 blocks an SM (32
// columns spilled 4-72 bytes and ran no faster).
//
// Head dims: the same rule as the forward's (kernels/gemm.attention_path): the
// tile at every multiple of 8 up to 256, a multiple of 8 but not of 16
// zero-padded to the next 16 in shared memory (BwdArgs::d), and above D = 128
// K6c reads Q's and dO's fragments from their tiles instead of holding them
// (K6b's two D-wide accumulators spill at D = 256: 256 registers a thread);
// any other head dim takes the CUDA-core kernels below
// (flash_bwd_dq_kernel_simt, flash_bwd_dkv_kernel_simt), with the same
// numerics.
//
// What bounds them: at long context ([2, 12, 2048, 64]) the rate at which
// 12 warps an SM start the mma.sync products (K6b four a score tile, K6c
// three, one ldmatrix.x4 per two) and the f32 work between them, as in
// the forward, not the tensor cores' peak (on an H100 SXM at 700 W: K6b 0.22
// ms, 233 TFLOP/s, and K6c 0.21 ms, 183 TFLOP/s, of its 989); at the
// training shape ([32, 12, 120, 64]: 768 blocks of two tiles, two waves at
// 3 blocks an SM; 0.021 ms each, twice the bound of its bytes) the latency
// of a block's loads and of its short dependent chain of products.
#pragma once

#include "mma_attention.cuh"

#include <math.h>

namespace cpt {
namespace flash_bwd {

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* bias;  // nullptr: no bias; keys contiguous (sbias[3] == 1)
  const bf16* dout;
  const float* m;   // [B, H, S] contiguous
  const float* l;
  const float* di;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  // element strides of batch, head, row
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  long long sbias[4];  // batch, head, query, key (0 = broadcast)
  int H, S;
  int d;               // head dim: D, or D - 8 on the tile of D
  float scale;
};

// K6b and K6c at the tile dims above mma_attn::kSplitD (144 .. 256),
// compiled apart in flash_attention_bwd_wide.cu so that nvcc builds the two
// halves of the instantiations in parallel; cudaErrorInvalidValue for any
// other head dim.
int launch_dkv_wide(const BwdArgs& a, int B, cudaStream_t stream);
int launch_dq_wide(const BwdArgs& a, int B, cudaStream_t stream);

}  // namespace flash_bwd
}  // namespace cpt

namespace {

namespace ma = cpt::mma_attn;
using cpt::bf16;

constexpr int kTile = ma::kBK;    // rows a block owns and rows a ring stage holds
// columns of the score tile formed at a time (K6c: keys; K6b: queries) and
// their n8 tiles
constexpr int kChunk = 32;
constexpr int kCN = kChunk / 8;
constexpr int kChunkB = 16;
constexpr int kCNB = kChunkB / 8;

using cpt::flash_bwd::BwdArgs;

template <int D>
__host__ __device__ constexpr int tile_bytes() { return ma::tile_bytes<D>(); }

// K6b: K and V tiles, two ring stages of Q and dO, two stages of the stats
template <int D>
constexpr int dkv_smem_bytes() { return 6 * tile_bytes<D>() + 2 * 3 * kTile * 4; }

// K6c: Q and dO tiles, two ring stages of K and V
template <int D>
constexpr int dq_smem_bytes() { return 6 * tile_bytes<D>(); }

// The A fragment of k16 step kk of this warp's 16 rows of the tile at t
template <int D>
__device__ __forceinline__ void a_frag(unsigned t, int kk, unsigned (&r)[4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  cpt::ldsm_x4(t + ma::chunk_at<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)), r);
}

// The "col" B fragments of rows [r0, r0 + 16) of the tile at t for k16 step
// kk: r[0], r[1] for the n8 tile of rows r0 .. r0 + 7, r[2], r[3] for the next
template <int D>
__device__ __forceinline__ void b_frag(unsigned t, int r0, int kk, unsigned (&r)[4]) {
  const int lane = threadIdx.x % 32;
  cpt::ldsm_x4(t + ma::chunk_at<D>(r0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)),
               r);
}

// The B fragments of rows [r0, r0 + 16) of the tile at t as the k16 step of a
// product over its rows, columns 16 dp .. 16 dp + 15 as two n8 tiles
template <int D>
__device__ __forceinline__ void b_frag_trans(unsigned t, int r0, int dp, unsigned (&r)[4]) {
  const int lane = threadIdx.x % 32;
  cpt::ldsm_x4_trans(
      t + ma::chunk_at<D>(r0 + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * dp + (lane >> 4)), r);
}

// The accumulators of n8 tiles 2 kk and 2 kk + 1, rounded to bf16, as the A
// fragment of a k16 step over their columns
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N][4], int kk, unsigned (&r)[4]) {
  r[0] = ma::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  r[1] = ma::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  r[2] = ma::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  r[3] = ma::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

template <int D>
__global__ void __launch_bounds__(ma::kThreads, ma::min_blocks<D>())
    flash_bwd_dkv_kernel(const BwdArgs a) {
  static_assert(D % 16 == 0 && D >= 16 && D <= ma::kMaxD, "tile dims 16, 32, .., 256");
  constexpr unsigned kTB = tile_bytes<D>();
  constexpr bool kHold = D <= 64;  // K and V fragments in registers
  const int chunks = a.d / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned k_s = cpt::smem_u32(smem), v_s = k_s + kTB;
  const unsigned ring = v_s + kTB;  // stage i: Q at ring + 2i tiles, dO after it
  // stage i: m (log2 units), 1/l and di of the stage's 64 queries
  float* stats = reinterpret_cast<float*>(smem + 6 * kTB);

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4);  // this lane's first column in an n8 tile
  const long long bh = static_cast<long long>(b) * a.H + h;
  const bf16* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const bf16* dob = a.dout + b * a.sdo[0] + h * a.sdo[1];
  const float scale2 = a.scale * ma::kLog2e;

  // bias[q][key] of this lane's two key rows (a row past S reads row S - 1,
  // never stored): query q at bcol[i][q * sbias[2]]
  const bool has_bias = a.bias != nullptr;
  const bool key_bias = has_bias && a.sbias[2] == 0;
  const bf16* bcol[2] = {nullptr, nullptr};
  float kbias[2] = {0.f, 0.f};
  if (has_bias) {
    const bf16* base = a.bias + b * a.sbias[0] + h * a.sbias[1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bcol[i] = base + min(k0 + warp * 16 + lane / 4 + 8 * i, S - 1);
      if (key_bias) kbias[i] = __bfloat162float(*bcol[i]);
    }
  }

  const int n_qt = (S + kTile - 1) / kTile;
  auto load_stage = [&](int step) {
    const unsigned st = ring + (step & 1) * 2 * kTB;
    ma::load_tile<D>(st, qb, a.sq[2], step * kTile, S, chunks);
    ma::load_tile<D>(st + kTB, dob, a.sdo[2], step * kTile, S, chunks);
  };
  // the stats of query tile `step`, loaded into registers by threads 0..63
  // (zeros past S), then stored to its stage as m * log2 e, 1/l (0 where
  // l == 0) and di
  float sm_raw = 0.f, sl_raw = 0.f, sd_raw = 0.f;
  auto fetch = [&](int step) {
    const int qi = step * kTile + threadIdx.x;
    sm_raw = sl_raw = sd_raw = 0.f;
    if (threadIdx.x < kTile && qi < S) {
      const long long at = bh * S + qi;
      sm_raw = a.m[at];
      sl_raw = a.l[at];
      sd_raw = a.di[at];
    }
  };
  auto put = [&](int step) {
    if (threadIdx.x < kTile) {
      float* st = stats + (step & 1) * 3 * kTile;
      st[threadIdx.x] = sm_raw * ma::kLog2e;
      st[kTile + threadIdx.x] = sl_raw == 0.f ? 0.f : 1.f / sl_raw;
      st[2 * kTile + threadIdx.x] = sd_raw;
    }
  };

  ma::load_tile<D>(k_s, a.k + b * a.sk[0] + h * a.sk[1], a.sk[2], k0, S, chunks);
  ma::load_tile<D>(v_s, a.v + b * a.sv[0] + h * a.sv[1], a.sv[2], k0, S, chunks);
  load_stage(0);
  cpt::cp_async_commit();
  fetch(0);
  put(0);

  unsigned kf[kHold ? D / 16 : 1][4], vf[kHold ? D / 16 : 1][4];
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int step = 0; step < n_qt; ++step) {
    const bool more = step + 1 < n_qt;
    if (more) {
      load_stage(step + 1);
      fetch(step + 1);
    }
    cpt::cp_async_commit();
    cpt::cp_async_wait1();  // all but the newest group: this step's tiles (and K, V)
    __syncthreads();
    if (kHold && step == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        a_frag<D>(k_s, kk, kf[kHold ? kk : 0]);
        a_frag<D>(v_s, kk, vf[kHold ? kk : 0]);
      }
    }
    // the next tile's stats into the stage that step - 1 read (its readers
    // passed the barrier above); stored here, not after the products, so
    // that their registers are free during them
    if (more) put(step + 1);
    const unsigned q_st = ring + (step & 1) * 2 * kTB, do_st = q_st + kTB;
    const float* st = stats + (step & 1) * 3 * kTile;
    const int q0 = step * kTile;
#pragma unroll 1
    for (int cq = 0; cq < kTile; cq += kChunkB) {
      // the chunk's bias (any but a key bias), loaded ahead of the products;
      // accumulator element e is key row e / 2 and query column e % 2
      bf16 braw[kCNB][4];
      if (has_bias && !key_bias) {
#pragma unroll
        for (int n = 0; n < kCNB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            braw[n][e] = bcol[e >> 1][min(q0 + cq + n * 8 + col + (e & 1), S - 1) * a.sbias[2]];
      }
      // S^T = K Q^T and dP^T = V dO^T for keys (rows) x the chunk's queries
      float sT[kCNB][4], dpT[kCNB][4];
#pragma unroll
      for (int n = 0; n < kCNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned ka[4], va[4];
        if (kHold) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ka[j] = kf[kHold ? kk : 0][j];
            va[j] = vf[kHold ? kk : 0][j];
          }
        } else {
          a_frag<D>(k_s, kk, ka);
          a_frag<D>(v_s, kk, va);
        }
#pragma unroll
        for (int np = 0; np < kCNB / 2; ++np) {
          unsigned r[4];
          b_frag<D>(q_st, cq + np * 16, kk, r);
          cpt::mma_bf16(sT[2 * np], ka, r[0], r[1]);
          cpt::mma_bf16(sT[2 * np + 1], ka, r[2], r[3]);
          b_frag<D>(do_st, cq + np * 16, kk, r);
          cpt::mma_bf16(dpT[2 * np], va, r[0], r[1]);
          cpt::mma_bf16(dpT[2 * np + 1], va, r[2], r[3]);
        }
      }
      // p^T into sT and ds^T into dpT, by the stats of each column (query)
#pragma unroll
      for (int n = 0; n < kCNB; ++n) {
        const int c = cq + n * 8 + col;
        const float2 m2 = *reinterpret_cast<const float2*>(st + c);
        const float2 il = *reinterpret_cast<const float2*>(st + kTile + c);
        const float2 di = *reinterpret_cast<const float2*>(st + 2 * kTile + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float bb = !has_bias ? 0.f
                           : key_bias ? kbias[e >> 1]
                                      : __bfloat162float(braw[n][e]);
          const float x = (sT[n][e] + bb) * scale2 - (e & 1 ? m2.y : m2.x);
          const float p = ma::fast_exp2(fminf(x, 0.f)) * (e & 1 ? il.y : il.x);
          dpT[n][e] = (dpT[n][e] - (e & 1 ? di.y : di.x)) * p * a.scale;
          sT[n][e] = p;
        }
      }
      // dV += P^T dO and dK += dS^T Q over the chunk's queries
#pragma unroll
      for (int kk = 0; kk < kCNB / 2; ++kk) {
        unsigned pa[4], sa[4];
        pack_a(sT, kk, pa);
        pack_a(dpT, kk, sa);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          unsigned r[4];
          b_frag_trans<D>(do_st, cq + kk * 16, dp, r);
          cpt::mma_bf16(dv[2 * dp], pa, r[0], r[1]);
          cpt::mma_bf16(dv[2 * dp + 1], pa, r[2], r[3]);
          b_frag_trans<D>(q_st, cq + kk * 16, dp, r);
          cpt::mma_bf16(dk[2 * dp], sa, r[0], r[1]);
          cpt::mma_bf16(dk[2 * dp + 1], sa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before step + 2 refills it
  }

  // dK and dV through this warp's own rows of the K and V tiles
  const float one[2] = {1.f, 1.f};
  ma::store_rows<D>(smem, dk, one, a.dk + b * a.sdk[0] + h * a.sdk[1], a.sdk[2], k0, S, chunks);
  ma::store_rows<D>(smem + kTB, dv, one, a.dv + b * a.sdv[0] + h * a.sdv[1], a.sdv[2], k0, S,
                    chunks);
}

template <int D>
__global__ void __launch_bounds__(ma::kThreads, ma::min_blocks<D>())
    flash_bwd_dq_kernel(const BwdArgs a) {
  static_assert(D % 16 == 0 && D >= 16 && D <= ma::kMaxD, "tile dims 16, 32, .., 256");
  constexpr unsigned kTB = tile_bytes<D>();
  constexpr bool kHold = D <= 128;  // Q's and dO's fragments in registers
  const int chunks = a.d / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned q_s = cpt::smem_u32(smem), do_s = q_s + kTB;
  const unsigned ring = do_s + kTB;  // stage i: K at ring + 2i tiles, V after it

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4);
  const long long bh = static_cast<long long>(b) * a.H + h;
  const bf16* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const bf16* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const float scale2 = a.scale * ma::kLog2e;

  // this lane's two query rows: m in log2 units, 1/l and di (zeros past S)
  const int qi[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  float m2[2], il[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m2[i] = il[i] = di[i] = 0.f;
    if (qi[i] < S) {
      const long long at = bh * S + qi[i];
      const float l = a.l[at];
      m2[i] = a.m[at] * ma::kLog2e;
      il[i] = l == 0.f ? 0.f : 1.f / l;
      di[i] = a.di[at];
    }
  }
  // bias rows of the two query rows (a row past S reads row S - 1), as the
  // forward reads them
  const bool has_bias = a.bias != nullptr;
  const bf16* brow[2] = {nullptr, nullptr};
  bool vec = false, rows_share = false;
  if (has_bias) {
    const bf16* base = a.bias + b * a.sbias[0] + h * a.sbias[1];
#pragma unroll
    for (int i = 0; i < 2; ++i) brow[i] = base + min(qi[i], S - 1) * a.sbias[2];
    rows_share = a.sbias[2] == 0;
    vec = ((reinterpret_cast<uintptr_t>(brow[0]) | reinterpret_cast<uintptr_t>(brow[1])) & 3) ==
          0;
  }

  const int n_kt = (S + kTile - 1) / kTile;
  auto load_stage = [&](int step) {
    const unsigned st = ring + (step & 1) * 2 * kTB;
    ma::load_tile<D>(st, kb, a.sk[2], step * kTile, S, chunks);
    ma::load_tile<D>(st + kTB, vb, a.sv[2], step * kTile, S, chunks);
  };
  ma::load_tile<D>(q_s, a.q + b * a.sq[0] + h * a.sq[1], a.sq[2], q0, S, chunks);
  ma::load_tile<D>(do_s, a.dout + b * a.sdo[0] + h * a.sdo[1], a.sdo[2], q0, S, chunks);
  load_stage(0);
  cpt::cp_async_commit();

  unsigned qf[kHold ? D / 16 : 1][4], dof[kHold ? D / 16 : 1][4];  // Q's and dO's A fragments
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int step = 0; step < n_kt; ++step) {
    if (step + 1 < n_kt) load_stage(step + 1);
    cpt::cp_async_commit();
    cpt::cp_async_wait1();  // all but the newest group: this step's tiles (and Q, dO)
    __syncthreads();
    if (kHold && step == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        a_frag<D>(q_s, kk, qf[kHold ? kk : 0]);
        a_frag<D>(do_s, kk, dof[kHold ? kk : 0]);
      }
    }
    const unsigned k_st = ring + (step & 1) * 2 * kTB, v_st = k_st + kTB;
    const int k0 = step * kTile;
    const bool full = k0 + kTile <= S;
    const bool pre = has_bias && full && vec;
#pragma unroll 1
    for (int cq = 0; cq < kTile; cq += kChunk) {
      // the chunk's bias as raw bf16 pairs, loaded before the products
      unsigned braw[2][kCN];
      if (pre) {
#pragma unroll
        for (int n = 0; n < kCN; ++n) {
          const int kj = k0 + cq + n * 8 + col;
          braw[0][n] = __ldg(reinterpret_cast<const unsigned*>(brow[0] + kj));
          if (!rows_share) braw[1][n] = __ldg(reinterpret_cast<const unsigned*>(brow[1] + kj));
        }
      }
      // S = Q K^T and dP = dO V^T for the chunk's keys
      float s[kCN][4], dp[kCN][4];
#pragma unroll
      for (int n = 0; n < kCN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned qa[4], da[4];
        if (kHold) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qa[j] = qf[kHold ? kk : 0][j];
            da[j] = dof[kHold ? kk : 0][j];
          }
        } else {
          a_frag<D>(q_s, kk, qa);
          a_frag<D>(do_s, kk, da);
        }
#pragma unroll
        for (int np = 0; np < kCN / 2; ++np) {
          unsigned r[4];
          b_frag<D>(k_st, cq + np * 16, kk, r);
          cpt::mma_bf16(s[2 * np], qa, r[0], r[1]);
          cpt::mma_bf16(s[2 * np + 1], qa, r[2], r[3]);
          b_frag<D>(v_st, cq + np * 16, kk, r);
          cpt::mma_bf16(dp[2 * np], da, r[0], r[1]);
          cpt::mma_bf16(dp[2 * np + 1], da, r[2], r[3]);
        }
      }
      // p, then ds into dp; keys at or past S get p = 0
#pragma unroll
      for (int n = 0; n < kCN; ++n) {
        const int kj = k0 + cq + n * 8 + col;  // this lane's columns kj, kj + 1
        float2 bias[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
        if (has_bias) {
          bias[0] = pre ? ma::bf16_pair(braw[0][n]) : ma::bias_pair(brow[0] + kj, kj, S, full);
          bias[1] = rows_share ? bias[0]
                    : pre      ? ma::bf16_pair(braw[1][n])
                               : ma::bias_pair(brow[1] + kj, kj, S, full);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float bb = e & 1 ? bias[i].y : bias[i].x;
          const float x = (s[n][e] + bb) * scale2 - m2[i];
          float p = ma::fast_exp2(fminf(x, 0.f)) * il[i];
          if (!full && kj + (e & 1) >= S) p = 0.f;
          dp[n][e] = (dp[n][e] - di[i]) * p * a.scale;
        }
      }
      // dQ += dS K over the chunk's keys
#pragma unroll
      for (int kk = 0; kk < kCN / 2; ++kk) {
        unsigned sa[4];
        pack_a(dp, kk, sa);
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          unsigned r[4];
          b_frag_trans<D>(k_st, cq + kk * 16, dd, r);
          cpt::mma_bf16(dq[2 * dd], sa, r[0], r[1]);
          cpt::mma_bf16(dq[2 * dd + 1], sa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before step + 2 refills it
  }

  // dQ through this warp's own rows of the Q tile
  const float one[2] = {1.f, 1.f};
  ma::store_rows<D>(smem, dq, one, a.dq + b * a.sdq[0] + h * a.sdq[1], a.sdq[2], q0, S, chunks);
}

}  // namespace
