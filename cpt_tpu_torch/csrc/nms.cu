// K5: greedy NMS with static shapes over B independent problems,
// boxes [B, K, 4] f32 xyxy, scores [B, K] f32, valid [B, K] bool ->
// indices [B, max_out] int32, keep [B, max_out] bool.
//
// Replaces cpt_tpu/ops/nms_pallas.py::nms_pallas (_nms_kernel), which kept
// the whole greedy loop in VMEM so that no pick leaves the chip. A loop of
// picks is a chain of dependent block-wide argmaxes; here it becomes a
// sorted-order bitmask NMS, exact for the same reason the greedy loop is
// well defined:
//   * greedy "pick the highest live score, ties to the lower index, drop
//     every box whose IoU with it is > thr" keeps exactly the boxes that no
//     earlier kept box overlaps > thr, walking the live boxes in the order
//     (score descending, index ascending); the live boxes (valid, score >
//     -5e9) are a prefix of that order, since the loop stops at the first
//     best score <= NEG_INF / 2;
//   * the IoU below is symmetric bit for bit (max, min and the sum of the
//     two areas commute in IEEE arithmetic), so each pair's bit is computed
//     once, for the earlier box's row.
// Two paths, which the caller picks by the problems' count and size (the
// wrapper's nms_path): the "grid" path (one problem: the RPN's 6000 boxes,
// the box head's 300) takes three kernels, one wrapper call:
//   1. rank: each live box's rank is the number of live boxes that beat it
//      (an O(K^2) count spread over the grid: 32 boxes a block, 8 warps
//      each counting a share of the others against keys staged in shared
//      memory); the box and its index are scattered to that rank, and the
//      problem's live count is written once;
//   2. mask: one block of 64 threads per 64 x 64 tile of the upper triangle
//      of the sorted order writes, per row, one 64-bit word of "IoU > thr"
//      bits, with the plain version's _rn arithmetic;
//   3. scan: one block per problem walks the sorted boxes in chunks of 64.
//      The chunk's mask rows (its columns onward, up to kStageWords words)
//      are staged in shared memory by cp.async one chunk ahead; warp 0
//      resolves the chunk from its diagonal words (resolve_chunk: the
//      diagonal transposed by ballots, then a few rounds that each decide
//      every box whose earlier overlappers are decided); then each warp ORs
//      the kept rows' words of later chunks into the `removed` bitset in
//      shared memory. It stops at max_out picks or after the last live box,
//      then writes zeros to the unused slots.
// The "block" path (a batch of per-class problems of 300 boxes) takes one
// block a problem (nms_block_kernel): the same rank, sorted
// order and chunk scan in shared memory, computing only the mask words the
// scan reads (a chunk's diagonal, then the kept rows' later words), so a
// batch pays no O(K^2) IoU pass over rows that are never kept.
//
// What bounds it: latency. The rank and mask passes do K^2 compares and
// K^2 / 2 IoUs across the whole card (a pair that does not intersect skips
// the division); the scan is a chain of chunk steps on one SM (a chunk
// resolved in a few warp rounds, its kept rows ORed, the next chunk's rows
// already in shared memory) and stops early once max_out boxes are kept.
// The first kernel paid a block-wide argmax, three barriers and a K-wide
// IoU row for each pick, on one SM.
//
// The outputs are indices, so every decision must match the plain version
// bit for bit on the same f32 inputs: the IoU is written with the _rn
// intrinsics, which nvcc never contracts into FMAs, in the plain version's
// order of operations (and the library is not built with --use_fast_math).
// NaN scores or coordinates are not supported.
#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr float kNegInf = -1e10f;
constexpr int kTile = 64;           // boxes per mask word, per scan chunk
constexpr int kRankWarps = 8;       // warps sharing out the compared boxes
constexpr int kRankStage = 1024;    // keys staged in shared memory at once
constexpr int kScanThreads = 256;
constexpr int kStageWords = 96;     // mask words of a chunk's rows staged (K <= 6144: all)

__device__ __forceinline__ float extent(float lo, float hi, float off) {
  return fmaxf(__fadd_rn(__fsub_rn(hi, lo), off), 0.f);
}

__device__ __forceinline__ float box_area(float4 b, float off) {
  return __fmul_rn(extent(b.x, b.z, off), extent(b.y, b.w, off));
}

// The sort key of box j: greater for a higher score, then for a lower
// index; 0 for a box that is not live (invalid, or score <= NEG_INF / 2).
__device__ __forceinline__ u64 order_key(const float* scores, const unsigned char* valid,
                                         int j) {
  float s = scores[j];
  if (!valid[j] || !(s > kNegInf / 2)) return 0;
  if (s == 0.f) s = 0.f;  // -0 ties with +0, as in argmax
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<unsigned>(~j);
}

// 32 boxes a block, one a lane; the 8 warps share out the compared boxes,
// whose keys are staged in shared memory (one key a warp: a broadcast).
__global__ void __launch_bounds__(kRankWarps * 32)
    nms_rank_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                    const unsigned char* __restrict__ valid, float4* __restrict__ sorted,
                    int* __restrict__ order, int* __restrict__ count, int K) {
  __shared__ u64 keys[kRankStage];
  __shared__ int part[kRankWarps][32];
  __shared__ int live_part[kRankWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t b = blockIdx.y;
  boxes += b * K;
  scores += b * K;
  valid += b * K;
  const int i = blockIdx.x * 32 + lane;
  const u64 ki = i < K ? order_key(scores, valid, i) : 0;
  int rank = 0, live = 0;
  for (int j0 = 0; j0 < K; j0 += kRankStage) {
    const int n = min(kRankStage, K - j0);
    __syncthreads();  // the previous stage's keys are read
    for (int e = threadIdx.x; e < n; e += blockDim.x) keys[e] = order_key(scores, valid, j0 + e);
    __syncthreads();
    for (int e = warp; e < n; e += kRankWarps) rank += keys[e] > ki;
    if (blockIdx.x == 0) {  // the problem's live count, once
      for (int e = warp; e < n; e += kRankWarps) live += keys[e] != 0;
    }
  }
  part[warp][lane] = rank;
  if (lane == 0) live_part[warp] = live;
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int w = 1; w < kRankWarps; ++w) rank += part[w][lane];
  if (ki != 0) {
    sorted[b * K + rank] = boxes[i];
    order[b * K + rank] = i;
  }
  if (blockIdx.x == 0 && lane == 0) {
#pragma unroll
    for (int w = 1; w < kRankWarps; ++w) live += live_part[w];
    count[b] = live;
  }
}

// IoU(p, c) > thr with the plain version's _rn arithmetic (p the earlier
// box); a pair that does not intersect skips the division.
__device__ __forceinline__ bool iou_above(float4 p, float parea, float4 c, float carea,
                                          float thr, float off) {
  const float iw = extent(fmaxf(p.x, c.x), fminf(p.z, c.z), off);
  const float ih = extent(fmaxf(p.y, c.y), fminf(p.w, c.w), off);
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.f) return 0.f > thr;  // 0 / union, exactly
  const float uni = fmaxf(__fsub_rn(__fadd_rn(parea, carea), inter), 1e-10f);
  return __fdiv_rn(inter, uni) > thr;
}

// mask[b, i, w] bit t: IoU(sorted i, sorted 64 w + t) > thr, for 64 w + t > i
// among the problem's live boxes. Tiles left of the diagonal and rows or
// columns past the live count are never written (and never read).
__global__ void __launch_bounds__(kTile)
    nms_mask_kernel(const float4* __restrict__ sorted, const int* __restrict__ count,
                    u64* __restrict__ mask, int K, int W, float thr, float off) {
  const int col = blockIdx.x, row = blockIdx.y;
  const size_t b = blockIdx.z;
  if (col < row) return;
  const int n = count[b];
  if (col * kTile >= n) return;
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  sorted += b * K;
  const int ncol = min(kTile, n - col * kTile), nrow = min(kTile, n - row * kTile);
  const int t = threadIdx.x;
  if (t < ncol) {
    const float4 c = sorted[col * kTile + t];
    cbox[t] = c;
    carea[t] = box_area(c, off);
  }
  __syncthreads();
  if (t >= nrow) return;
  const int i = row * kTile + t;
  const float4 p = sorted[i];
  const float parea = box_area(p, off);
  u64 bits = 0;
  for (int j = row == col ? t + 1 : 0; j < ncol; ++j) {
    if (iou_above(p, parea, cbox[j], carea[j], thr, off)) bits |= 1ull << j;
  }
  mask[(b * K + i) * W + col] = bits;
}

// One chunk of the scan on one warp. Box t of the chunk (lane t holds rows
// t and t + 32: their diagonal words d_lo, d_hi, the later boxes of the
// chunk each overlaps > thr) is a candidate where `avail` has bit t. The
// greedy scan keeps t iff no kept candidate before t overlaps it; with the
// diagonal transposed by ballots (e: the candidates before t that overlap
// t), each round decides every candidate whose earlier overlappers are all
// decided: kept if none of them is kept, dropped if one is. The lowest
// undecided candidate is always decided, and chains are short, so a few
// rounds replace a serial walk of up to 64 dependent steps. Returns the
// first `slots` kept boxes (warp-uniform).
__device__ u64 resolve_chunk(u64 avail, u64 d_lo, u64 d_hi, int slots) {
  const int lane = threadIdx.x & 31;
  u64 e_lo = 0, e_hi = 0;
#pragma unroll 8
  for (int t = 0; t < 32; ++t) {
    const u64 col = (static_cast<u64>(__ballot_sync(~0u, d_hi >> t & 1)) << 32) |
                    __ballot_sync(~0u, d_lo >> t & 1);
    const u64 col2 = (static_cast<u64>(__ballot_sync(~0u, d_hi >> (t + 32) & 1)) << 32) |
                     __ballot_sync(~0u, d_lo >> (t + 32) & 1);
    if (t == lane) {
      e_lo = col;
      e_hi = col2;
    }
  }
  u64 keep = 0, decided = ~avail;
  while (decided != ~0ull) {
    bool k_lo = false, d_lo_ = false, k_hi = false, d_hi_ = false;
    if (!(decided >> lane & 1)) {
      if (e_lo & keep) d_lo_ = true;
      else if (!(e_lo & ~decided)) k_lo = d_lo_ = true;
    }
    if (!(decided >> (lane + 32) & 1)) {
      if (e_hi & keep) d_hi_ = true;
      else if (!(e_hi & ~decided)) k_hi = d_hi_ = true;
    }
    keep |= (static_cast<u64>(__ballot_sync(~0u, k_hi)) << 32) | __ballot_sync(~0u, k_lo);
    decided |= (static_cast<u64>(__ballot_sync(~0u, d_hi_)) << 32) | __ballot_sync(~0u, d_lo_);
  }
  while (__popcll(keep) > slots) keep &= ~(1ull << (63 - __clzll(keep)));
  return keep;
}

__device__ __forceinline__ void cp_async8(u64* dst, const u64* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(cpt::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Shared memory: removed[W] | stage[2][kTile][S], 8-byte words.
__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const u64* __restrict__ mask, const int* __restrict__ order,
                    const int* __restrict__ count, int* __restrict__ out_idx,
                    unsigned char* __restrict__ out_keep, int K, int W, int S,
                    int max_out) {
  extern __shared__ u64 smem[];
  u64* removed = smem;
  u64* stage = smem + W;
  __shared__ u64 s_keep;
  __shared__ int s_kept;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t b = blockIdx.x;
  mask += b * K * W;
  order += b * K;
  out_idx += b * max_out;
  out_keep += b * max_out;
  const int n = count[b];
  const int chunks = (n + kTile - 1) / kTile;
  for (int w = tid; w < chunks; w += nt) removed[w] = 0;

  // chunk c's rows, its columns c .. c + S - 1, into stage[c % 2]; one
  // commit group a chunk (empty past the last), so wait_group 1 waits for
  // the chunk before the newest
  auto prefetch = [&](int c) {
    if (c < chunks) {
      u64* buf = stage + (c & 1) * kTile * S;
      const int rows = min(kTile, n - c * kTile), cols = min(S, chunks - c);
      for (int r = warp; r < rows; r += nwarps) {
        const u64* src = mask + static_cast<size_t>(c * kTile + r) * W + c;
        for (int q = lane; q < cols; q += 32) cp_async8(buf + r * S + q, src + q);
      }
    }
    cpt::cp_async_commit();
  };
  prefetch(0);
  prefetch(1);

  int kept = 0;
  for (int c = 0; c < chunks && kept < max_out; ++c) {
    // the chunk's original indices, loaded while the chunk is resolved
    const int idx = tid < kTile && c * kTile + tid < n ? order[c * kTile + tid] : 0;
    cpt::cp_async_wait1();
    __syncthreads();  // stage[c % 2] landed; removed[c] holds every earlier kept row
    const u64* buf = stage + (c & 1) * kTile * S;
    if (warp == 0) {
      const int rows = min(kTile, n - c * kTile);
      const u64 keep = resolve_chunk(~removed[c] & (rows == kTile ? ~0ull : (1ull << rows) - 1),
                                     buf[lane * S], buf[(lane + 32) * S], max_out - kept);
      if (lane == 0) {
        s_keep = keep;
        s_kept = kept + __popcll(keep);
      }
    }
    __syncthreads();
    const u64 keep = s_keep;
    if (tid < kTile && (keep >> tid & 1)) {
      const int slot = kept + __popcll(keep & ((1ull << tid) - 1));
      out_idx[slot] = idx;
      out_keep[slot] = 1;
    }
    kept = s_kept;
    if (kept < max_out) {
      // the kept rows' words for the later chunks: a warp a word, rows
      // lane and lane + 32 a lane, OR-reduced across the warp
      for (int q = 1 + warp; q < chunks - c; q += nwarps) {
        u64 acc = 0;
        for (int t = lane; t < kTile; t += 32) {
          if (keep >> t & 1) {
            acc |= q < S ? buf[t * S + q]
                         : mask[static_cast<size_t>(c * kTile + t) * W + c + q];
          }
        }
        const unsigned lo = __reduce_or_sync(~0u, static_cast<unsigned>(acc));
        const unsigned hi = __reduce_or_sync(~0u, static_cast<unsigned>(acc >> 32));
        if (lane == 0) removed[c + q] |= (static_cast<u64>(hi) << 32) | lo;
      }
    }
    __syncthreads();  // stage[c % 2] is free again
    prefetch(c + 2);
  }
  cpt::cp_async_wait0();
  for (int i = kept + tid; i < max_out; i += nt) {
    out_idx[i] = 0;
    out_keep[i] = 0;
  }
}

// The whole of one problem in one block of kScanThreads threads, in shared
// memory: keys [Kp] (Kp = K rounded up to even, so the boxes after them
// stay 16-byte aligned) | sorted boxes [K] | their areas [K] | sorted order
// [K] | removed [W] (32 bytes a box: K up to ~7000 fits) | diagonal words
// [64]. Each live box's rank is counted against the keys in shared
// memory; the scan walks the chunks as nms_scan_kernel does, but computes
// only the mask words it reads: a chunk's diagonal words before the chunk
// is resolved, then the kept rows' words for the later chunks. A batch of
// small problems (the per-class filters) is one block each, with no pass
// over the rows that are never kept.
__global__ void __launch_bounds__(kScanThreads)
    nms_block_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                     const unsigned char* __restrict__ valid, int* __restrict__ out_idx,
                     unsigned char* __restrict__ out_keep, int K, int Kp, int W, int max_out,
                     float thr, float off) {
  extern __shared__ u64 smem[];
  u64* keys = smem;
  float4* sbox = reinterpret_cast<float4*>(keys + Kp);
  float* sarea = reinterpret_cast<float*>(sbox + K);
  int* sorder = reinterpret_cast<int*>(sarea + K);
  u64* removed = reinterpret_cast<u64*>(sorder + K);  // 8-byte aligned: 8 Kp + 24 K
  __shared__ __align__(8) unsigned short diag[kTile][4];  // row t's word, 16 columns a quarter
  __shared__ u64 s_keep;
  __shared__ int s_kept, s_n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;
  boxes += b * K;
  scores += b * K;
  valid += b * K;
  out_idx += b * max_out;
  out_keep += b * max_out;

  if (tid == 0) s_n = 0;
  for (int i = tid; i < K; i += nt) keys[i] = order_key(scores, valid, i);
  for (int w = tid; w < W; w += nt) removed[w] = 0;
  __syncthreads();
  // rank by count (one key a step for the whole block: a broadcast), then
  // scatter to the rank
  int live = 0;
  for (int i = tid; i < K; i += nt) {
    const u64 ki = keys[i];
    if (!ki) continue;
    int rank = 0;
    for (int j = 0; j < K; ++j) rank += keys[j] > ki;
    const float4 bx = boxes[i];
    sbox[rank] = bx;
    sarea[rank] = box_area(bx, off);
    sorder[rank] = i;
    ++live;
  }
  if (live) atomicAdd(&s_n, live);
  __syncthreads();
  const int n = s_n;
  const int chunks = (n + kTile - 1) / kTile;

  int kept = 0;
  for (int c = 0; c < chunks && kept < max_out; ++c) {
    const int base = c * kTile, rows = min(kTile, n - base);
    {  // the chunk's diagonal words: row t >> 2, columns 16 (t & 3) ..
      const int r = tid >> 2, q = tid & 3;
      if (r < rows) {
        const float4 p = sbox[base + r];
        const float pa = sarea[base + r];
        unsigned bits = 0;
        for (int j = max(16 * q, r + 1); j < min(16 * q + 16, rows); ++j) {
          if (iou_above(p, pa, sbox[base + j], sarea[base + j], thr, off)) {
            bits |= 1u << (j - 16 * q);
          }
        }
        diag[r][q] = static_cast<unsigned short>(bits);
      }
    }
    __syncthreads();
    if (tid < 32) {
      const u64 keep = resolve_chunk(~removed[c] & (rows == kTile ? ~0ull : (1ull << rows) - 1),
                                     *reinterpret_cast<const u64*>(diag[tid]),
                                     *reinterpret_cast<const u64*>(diag[tid + 32]),
                                     max_out - kept);
      if (tid == 0) {
        s_keep = keep;
        s_kept = kept + __popcll(keep);
      }
    }
    __syncthreads();
    const u64 keep = s_keep;
    if (tid < kTile && (keep >> tid & 1)) {
      const int slot = kept + __popcll(keep & ((1ull << tid) - 1));
      out_idx[slot] = sorder[base + tid];
      out_keep[slot] = 1;
    }
    kept = s_kept;
    if (kept < max_out) {
      // the kept rows' words for the later chunks, 16 columns an item
      const int later = chunks - c - 1;
      for (int e = tid; e < kTile * later * 4; e += nt) {
        const int r = e / (later * 4), w = c + 1 + (e >> 2) % later, q = e & 3;
        if (!(keep >> r & 1)) continue;
        const float4 p = sbox[base + r];
        const float pa = sarea[base + r];
        const int j0 = w * kTile + 16 * q, j1 = min(j0 + 16, n);
        u64 bits = 0;
        for (int j = j0; j < j1; ++j) {
          if (iou_above(p, pa, sbox[j], sarea[j], thr, off)) bits |= 1ull << (j - w * kTile);
        }
        if (bits) atomicOr(&removed[w], bits);
      }
    }
    __syncthreads();
  }
  for (int i = kept + tid; i < max_out; i += nt) {
    out_idx[i] = 0;
    out_keep[i] = 0;
  }
}

// Device scratch, carved in this order: the sorted boxes [B, K] float4, the
// bitmask [B, K, W] words, the sorted order [B, K] int and the live counts
// [B] int.
size_t scratch_offset(int B, int K, int part) {
  const size_t bk = static_cast<size_t>(B) * K;
  const size_t sizes[4] = {bk * sizeof(float4), bk * ((K + kTile - 1) / kTile) * sizeof(u64),
                           bk * sizeof(int), static_cast<size_t>(B) * sizeof(int)};
  size_t at = 0;
  for (int i = 0; i < part; ++i) at += sizes[i];
  return at;
}

}  // namespace

// Bytes of device scratch cpt_nms's grid path needs for B problems of K
// boxes (sorted boxes, the bitmask, the sorted order and the live counts);
// the block path needs none.
CPT_EXPORT long long cpt_nms_scratch_bytes(int B, int K) {
  return static_cast<long long>(scratch_offset(B, K, 4));
}

// boxes [B, K, 4] f32 (16-byte aligned), scores [B, K] f32, valid [B, K]
// bool (one byte), out_idx [B, max_out] int32, out_keep [B, max_out] bool,
// 0 < B <= 65535, 0 < K, 0 < max_out. one_block: the block path (scratch
// unused; refused where K boxes do not fit one block's shared memory),
// else the grid path with scratch of cpt_nms_scratch_bytes(B, K) bytes
// (16-byte aligned).
CPT_EXPORT int cpt_nms(const void* boxes, const void* scores, const void* valid, void* out_idx,
                       void* out_keep, void* scratch, int B, int K, int max_out, int one_block,
                       float iou_threshold, float iou_offset, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = (K + kTile - 1) / kTile, S = W < kStageWords ? W : kStageWords;
  if (B > 65535 || W > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (one_block) {
    const int kp = K + (K & 1);
    const size_t smem =
        (static_cast<size_t>(kp) + W) * sizeof(u64) + K * (sizeof(float4) + sizeof(float) + sizeof(int));
    cudaError_t e = cudaFuncSetAttribute(
        nms_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    nms_block_kernel<<<B, kScanThreads, smem, st>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(scores),
        static_cast<const unsigned char*>(valid), static_cast<int*>(out_idx),
        static_cast<unsigned char*>(out_keep), K, kp, W, max_out, iou_threshold, iou_offset);
    return cpt::launch_status();
  }
  char* base = static_cast<char*>(scratch);
  float4* sorted = reinterpret_cast<float4*>(base);
  u64* mask = reinterpret_cast<u64*>(base + scratch_offset(B, K, 1));
  int* order = reinterpret_cast<int*>(base + scratch_offset(B, K, 2));
  int* count = reinterpret_cast<int*>(base + scratch_offset(B, K, 3));

  nms_rank_kernel<<<dim3((K + 31) / 32, B), kRankWarps * 32, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const unsigned char*>(valid), sorted, order, count, K);
  int err = cpt::launch_status();
  if (err) return err;
  nms_mask_kernel<<<dim3(W, W, B), kTile, 0, st>>>(sorted, count, mask, K, W,
                                                   iou_threshold, iou_offset);
  err = cpt::launch_status();
  if (err) return err;
  const size_t smem = (static_cast<size_t>(W) + 2 * kTile * S) * sizeof(u64);
  cudaError_t e = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_scan_kernel<<<B, kScanThreads, smem, st>>>(
      mask, order, count, static_cast<int*>(out_idx),
      static_cast<unsigned char*>(out_keep), K, W, S, max_out);
  return cpt::launch_status();
}
