// The tensor-core attention forward tile shared by K3's attention core
// (attention.cu) and K6, the flash-attention forward (flash_attention.cu):
// o = softmax(scores) v per (batch, head) on [B, H, S, D] bf16 views given by
// pointer and element strides (the last dim contiguous, rows 16-byte
// aligned), with f32 scores, f32 softmax and f32 accumulation of P.V. The two
// entry points differ only in their numerics (Mode):
//
//   kFlash (K6, the library's TPU forward): s = (q k^T + bias) * scale, the
//     bias bf16 and added before the scale; one pass with an online softmax;
//     the unnormalised p rounded to bf16 before P.V and o divided by the row
//     sum l at the end (a row whose l is 0 yields 0); optionally each row's
//     max m and sum l for the backward (K6b, K6c).
//   kCore (K3's core, the TPU _attn_kernel): s = q k^T * scale + key_bias,
//     the bias f32 and key-only, added after the scale; p normalised BEFORE
//     it is rounded to bf16 for P.V, which needs each row's max and sum
//     first (see below).
//
// Design. A block of 4 warps owns 64 query rows of one (batch, head), a warp
// 16 of them. Q is staged once and held in registers as mma.sync m16n8k16 A
// fragments (ldmatrix). K and V arrive in 64-key tiles by 16-byte cp.async
// copies into a two-stage ring, XOR-swizzled by row so ldmatrix reads them
// without bank conflicts; shared memory does not grow with S. K rows
// [key][d] are the "col" B operand of Q.K^T as they lie (ldmatrix); V takes
// ldmatrix.trans for P.V. Scores stay in the f32 accumulator fragments: a
// row's max and sum take two __shfl_xor_sync within its quad, and the
// accumulators of two neighbouring n8 tiles pack to bf16 as the A fragment
// of P.V, so P never touches shared memory. Two schedules:
//   S <= 128 (every serving sequence): the ring holds all of K and V, tile t
//     in stage t; the block scores both tiles into registers, then runs one
//     softmax over them (one Q.K^T for kCore too) and P.V.
//   S > 128: the tiles stream through the ring, the next loading while this
//     one computes. kFlash runs one online-softmax pass (o rescaled by
//     exp(m_old - m_new)); kCore walks the keys twice, pass 1 for the row
//     stats (online max and sum), pass 2 recomputing Q.K^T for p and P.V.
// Ragged edges are masked by index: keys at or past S are -inf before the
// max (their K and V rows are zero-filled, so no stale value enters), query
// rows at or past S are computed on zeros and not stored. Nothing is padded.
//
// What bounds it: at the serving shape ([16, 12, 120, 64]) latency (a block
// loads 40 KB and runs two key tiles; 384 blocks make one wave of 132 SMs at
// 3 blocks an SM); at long context ([2, 12, 2048, 64]) the issue rate of the
// f32 softmax between the two mma.sync products (bias, scale, mask, max, one
// ex2 and the sum per score) and the latency between them at 3 blocks (12
// warps) an SM, not the tensor cores. wgmma, TMA and warp specialisation are
// later changes.
#pragma once

#include "common.cuh"

#include <math.h>

namespace cpt {
namespace mma_attn {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per ring stage
constexpr int kWarps = kBQ / 16;      // one m16 row tile per warp
constexpr int kThreads = kWarps * 32;

enum Mode { kFlash = 0, kCore = 1 };

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const void* bias;  // kFlash: bf16 [B, H, S, S] by sbias; kCore: f32 [B, S]; or nullptr.
                     // Keys are contiguous (sbias[3] == 1).
  bf16* out;
  float* m_out;      // kFlash: [B, H, S] row max of the scaled scores, or nullptr
  float* l_out;      // kFlash: [B, H, S] row sum of exp(s - m), or nullptr
  long long sq[3], sk[3], sv[3], so[3];  // element strides of batch, head, row
  long long sbias[4];                    // batch, head, query, key (0 = broadcast)
  int H, S;
  float scale;
};

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (kBQ + 2 * 2 * kBK) * D * 2;  // Q tile + two stages of K and V tiles
}

// Byte offset of 16-byte chunk c of row r in a tile of D bf16 a row: the
// chunk's low bits are XORed with the row so that the 8 rows one ldmatrix
// phase reads fall in 8 distinct 16-byte bank groups.
template <int D>
__device__ __forceinline__ unsigned chunk_at(int r, int c) {
  constexpr int kCPR = D / 8;  // chunks a row: 4, 8 or 16
  const int sw = kCPR >= 8 ? (r & 7) : ((r >> 1) & 3);
  return static_cast<unsigned>(r * kCPR + (c ^ sw)) * 16u;
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a swizzled tile at
// shared address dst; rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(unsigned dst, const bf16* __restrict__ base,
                                          long long row_stride, int row0, int S) {
  constexpr int kCPR = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kBK * kCPR; i += kThreads) {
    const int r = i / kCPR, c = i % kCPR;
    const bool valid = row0 + r < S;
    const bf16* src = base + (valid ? (row0 + r) * row_stride : 0) + c * 8;
    cp_async16(dst + chunk_at<D>(r, c), src, valid);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ float2 bf16_pair(unsigned raw) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}

// The bias of key columns kj and kj + 1 at p (p[0], p[1]), element by element
// (the aligned pairs of full tiles are loaded ahead, as raw pairs); in a tile
// that holds the ragged edge, columns at or past S read as 0 (they are
// masked anyway).
template <class T>
__device__ __forceinline__ float2 bias_pair(const T* p, int kj, int S, bool full) {
  auto at = [&](int i) {
    if constexpr (sizeof(T) == 2)
      return full || kj + i < S ? __bfloat162float(p[i]) : 0.f;
    else
      return full || kj + i < S ? p[i] : 0.f;
  };
  return make_float2(at(0), at(1));
}

// 2^x by the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0): the probabilities round to bf16 (2^-9) next
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The body of one block: query rows [blockIdx.x * 64, + 64) of head
// blockIdx.y of batch blockIdx.z. Lane l of warp w holds rows
// w * 16 + l / 4 (index 0) and + 8 (index 1) of the block, and in each n8
// tile columns 2 (l % 4) and 2 (l % 4) + 1.
template <int D, int MODE>
__device__ __forceinline__ void attention_tile(const Args& a) {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  constexpr unsigned kTileBytes = kBK * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned q_s = smem_u32(smem);
  const unsigned ring = q_s + kBQ * D * 2;  // stage i: K at ring + 2i tiles, V after it

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = a.q + b * a.sq[0] + h * a.sq[1];
  const bf16* kb = a.k + b * a.sk[0] + h * a.sk[1];
  const bf16* vb = a.v + b * a.sv[0] + h * a.sv[1];
  const int row0 = warp * 16 + lane / 4;  // this lane's first row in the block
  const int qi[2] = {q0 + row0, q0 + row0 + 8};
  const int col = 2 * (lane % 4);         // this lane's first column in an n8 tile

  // Scores and the softmax run in log2 units (exp2 of s * log2 e), so a
  // probability costs one ex2; the row max m goes out in natural units.
  const float scale2 = a.scale * kLog2e;
  // bias rows of this lane's two query rows (kFlash; a row past S reads row
  // S - 1, never stored) or the sequence's key bias (kCore); key stride 1
  const bool has_bias = a.bias != nullptr;
  const bf16* brow[2] = {nullptr, nullptr};
  const float* kbias = nullptr;
  bool vec = false, rows_share = false;
  if (has_bias) {
    if (MODE == kFlash) {
      const bf16* base = static_cast<const bf16*>(a.bias) + b * a.sbias[0] + h * a.sbias[1];
#pragma unroll
      for (int i = 0; i < 2; ++i) brow[i] = base + min(qi[i], S - 1) * a.sbias[2];
      rows_share = a.sbias[2] == 0;
      vec = ((reinterpret_cast<uintptr_t>(brow[0]) | reinterpret_cast<uintptr_t>(brow[1])) &
             3) == 0;
    } else {
      kbias = static_cast<const float*>(a.bias) + b * a.sbias[0];
      vec = (reinterpret_cast<uintptr_t>(kbias) & 7) == 0;
    }
  }

  const int n_kt = (S + kBK - 1) / kBK;
  // S <= 128 (the serving sequences): the ring holds every K and V tile, so
  // tile t loads into stage t once, and the block scores both tiles before
  // one softmax over them (no running rescale; kCore needs no second Q.K^T).
  // Longer S streams the tiles through the two-stage ring, one step a tile:
  // kFlash with the online softmax; kCore in two passes, steps 0 .. n_kt - 1
  // for the row stats and n_kt .. 2 n_kt - 1 for P.V.
  const bool resident = n_kt <= 2;
  const int n_steps = MODE == kCore ? 2 * n_kt : n_kt;
  auto issue = [&](int step) {
    const int k0 = (step % n_kt) * kBK;
    const unsigned st = ring + (step & 1) * 2 * kTileBytes;
    load_tile<D>(st, kb, a.sk[2], k0, S);
    if (MODE == kFlash || step >= n_kt || resident)
      load_tile<D>(st + kTileBytes, vb, a.sv[2], k0, S);
  };
  load_tile<D>(q_s, qb, a.sq[2], q0, S);
  issue(0);
  cp_async_commit();
  if (resident && n_kt == 2) {  // tile 1 loads while tile 0 computes
    issue(1);
    cp_async_commit();
  }

  unsigned qf[D / 16][4];  // Q's A fragments, one per k16 step over d
  float o[D / 8][4];       // P.V accumulators, one per n8 tile over d
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};  // this lane's share of the row sum (its columns)
  float row_il[2] = {0.f, 0.f}; // kCore: 1 / l of the whole row

  auto load_q = [&]() {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(q_s + chunk_at<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)), qf[kk]);
  };

  // s = the scores of the key tile at k0, staged at k_s: Q.K^T on the tensor
  // cores, then bias, scale (into log2 units) and the ragged edge
  auto scores = [&](unsigned k_s, int k0, float (&s)[kBK / 8][4]) {
    // the tile's bias as raw pairs, loaded before Q.K^T so that their
    // latency hides behind the MMAs (full tiles with aligned pairs; the
    // others read theirs after)
    const bool full = k0 + kBK <= S;
    const bool pre = has_bias && full && vec;
    unsigned braw[2][kBK / 8];  // kFlash: bf16 pairs of rows 0 and 1
    float2 kraw[kBK / 8];       // kCore: f32 pairs
    if (pre) {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const int kj = k0 + n * 8 + col;
        if (MODE == kFlash) {
          braw[0][n] = __ldg(reinterpret_cast<const unsigned*>(brow[0] + kj));
          if (!rows_share) braw[1][n] = __ldg(reinterpret_cast<const unsigned*>(brow[1] + kj));
        } else {
          kraw[n] = __ldg(reinterpret_cast<const float2*>(kbias + kj));
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        unsigned r[4];
        ldsm_x4(k_s + chunk_at<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)),
                r);
        mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const int kj = k0 + n * 8 + col;  // this lane's columns kj, kj + 1
      float2 bias[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      if (has_bias) {
        if (MODE == kFlash) {
          bias[0] = pre ? bf16_pair(braw[0][n]) : bias_pair(brow[0] + kj, kj, S, full);
          bias[1] = rows_share ? bias[0]
                    : pre      ? bf16_pair(braw[1][n])
                               : bias_pair(brow[1] + kj, kj, S, full);
        } else {
          const float2 kv = pre ? kraw[n] : bias_pair(kbias + kj, kj, S, full);
          bias[0] = bias[1] = make_float2(kv.x * kLog2e, kv.y * kLog2e);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bb = e & 1 ? bias[e >> 1].y : bias[e >> 1].x;
        // kFlash: (q.k + bias) * scale; kCore: q.k * scale + key_bias
        float x = MODE == kFlash ? (s[n][e] + bb) * scale2 : fmaf(s[n][e], scale2, bb);
        if (!full && kj + (e & 1) >= S) x = -INFINITY;
        s[n][e] = x;
      }
    }
  };

  // o += P V for the key tile whose V is staged at v_s: P's A fragments
  // straight from the score accumulators, rounded to bf16
  auto pv = [&](unsigned v_s, const float (&p)[kBK / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned r[4];
        ldsm_x4_trans(v_s + chunk_at<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                        2 * dp + (lane >> 4)),
                      r);
        mma_bf16(o[2 * dp], pa, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  };

  // this lane's largest score of row i in s, and exp2(s - m) in place with
  // this lane's sum of it
  auto row_max = [&](const float (&s)[kBK / 8][4], int i) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    return mx;
  };
  auto exp_sum = [&](float (&s)[kBK / 8][4], int i, float m) {
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        s[n][e] = fast_exp2(s[n][e] - m);
        sum += s[n][e];
      }
    }
    return sum;
  };

  if (resident) {
    // both tiles' scores, then one softmax over them
    if (n_kt == 2)
      cp_async_wait1();
    else
      cp_async_wait0();
    __syncthreads();
    load_q();
    float s0[kBK / 8][4], s1[kBK / 8][4];
    scores(ring, 0, s0);
    if (n_kt == 2) {
      cp_async_wait0();
      __syncthreads();
      scores(ring + 2 * kTileBytes, kBK, s1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = row_max(s0, i);
      if (n_kt == 2) mx = fmaxf(mx, row_max(s1, i));
      row_m[i] = quad_max(mx);
      const float m_use = row_m[i] == -INFINITY ? 0.f : row_m[i];  // every score -inf
      row_l[i] = exp_sum(s0, i, m_use);
      if (n_kt == 2) row_l[i] += exp_sum(s1, i, m_use);
      if (MODE == kCore) {  // p normalised before it is rounded for P.V
        row_il[i] = 1.f / quad_sum(row_l[i]);
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n) {
          s0[n][2 * i] *= row_il[i];
          s0[n][2 * i + 1] *= row_il[i];
          if (n_kt == 2) {
            s1[n][2 * i] *= row_il[i];
            s1[n][2 * i + 1] *= row_il[i];
          }
        }
      }
    }
    pv(ring + kTileBytes, s0);
    if (n_kt == 2) pv(ring + 3 * kTileBytes, s1);
  } else {
    for (int step = 0; step < n_steps; ++step) {
      if (step + 1 < n_steps) issue(step + 1);
      cp_async_commit();
      cp_async_wait1();  // all but the newest group: this step's tiles (and Q)
      __syncthreads();
      if (step == 0) load_q();
      const unsigned k_s = ring + (step & 1) * 2 * kTileBytes;
      float s[kBK / 8][4];
      scores(k_s, (step % n_kt) * kBK, s);
      if (MODE == kFlash || step < n_kt) {
        // online row max and sum; kFlash keeps p = exp(s - m) and rescales o
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(row_m[i], quad_max(row_max(s, i)));
          const float m_use = m_new == -INFINITY ? 0.f : m_new;  // every score -inf so far
          const float alpha = fast_exp2(row_m[i] - m_use);
          row_l[i] = alpha * row_l[i] + exp_sum(s, i, m_use);
          row_m[i] = m_new;
          if (MODE == kFlash) {
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
              o[n][2 * i] *= alpha;
              o[n][2 * i + 1] *= alpha;
            }
          }
        }
      } else {
        if (step == n_kt) {  // the row stats are final: reduce the sums once
#pragma unroll
          for (int i = 0; i < 2; ++i) row_il[i] = 1.f / quad_sum(row_l[i]);
        }
        // p normalised with the row's max and sum, then rounded for P.V
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = fast_exp2(s[n][e] - row_m[e >> 1]) * row_il[e >> 1];
      }
      if (MODE == kFlash || step >= n_kt) pv(k_s + kTileBytes, s);
      __syncthreads();  // this stage's readers are done before step + 2 refills it
    }
  }

  float inv[2] = {1.f, 1.f};
  if (MODE == kFlash) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = quad_sum(row_l[i]);
      inv[i] = l == 0.f ? 1.f : 1.f / l;
      if (a.m_out != nullptr && lane % 4 == 0 && qi[i] < S) {
        const long long at = (static_cast<long long>(b) * a.H + h) * S + qi[i];
        a.m_out[at] = row_m[i] == -INFINITY ? 0.f : row_m[i] * kLn2;
        a.l_out[at] = l;
      }
    }
  }
  // o to bf16 through this warp's own 16 rows of the Q tile (which only this
  // warp read, into its fragments), then 16-byte stores of whole rows
  unsigned char* stage = smem;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(stage + chunk_at<D>(row0 + 8 * i, n) + col * 2) =
          pack_bf16(o[n][2 * i] * inv[i], o[n][2 * i + 1] * inv[i]);
  __syncwarp();
  constexpr int kCPR = D / 8;
  bf16* ob = a.out + b * a.so[0] + h * a.so[1];
#pragma unroll
  for (int j = lane; j < 16 * kCPR; j += 32) {
    const int r = warp * 16 + j / kCPR, c = j % kCPR;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * a.so[2] + c * 8) =
          *reinterpret_cast<const uint4*>(stage + chunk_at<D>(r, c));
  }
}

// Blocks an SM should hold: 3 up to D = 64 (at most 170 registers a thread:
// a cap of 128 for 4 blocks spills), 2 at D = 128 (~200 registers). The
// serving shape's 384 blocks then make one wave of 132 SMs, S = 2048's 768
// blocks two.
template <int D>
constexpr int min_blocks() { return D <= 64 ? 3 : 2; }

// Launch kernel<D> (a __global__ wrapper of attention_tile<D, MODE>) over
// (ceil(S / 64), heads, batch) blocks on the caller's stream.
template <int D, class Kernel>
int launch(Kernel kernel, const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  if (smem > 48 * 1024) {  // D = 128: opt in above the default 48 KB
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return launch_status();
}

}  // namespace mma_attn
}  // namespace cpt
