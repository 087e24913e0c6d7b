// The entry kernels of the tensor-core attention tile (mma_attention.cuh):
// K3's core (attention_kernel, kCore) and K6 (flash_attention_kernel,
// kFlash), shared by the sources that instantiate them: attention.cu and
// flash_attention.cu at the tile dims up to mma_attn::kSplitD,
// attention_wide.cu and flash_attention_wide.cu above it.
#pragma once

#include "mma_attention.cuh"

namespace cpt {
namespace mma_attn {

// the tile dims above kSplitD (144 .. 256); cudaErrorInvalidValue for any
// other head dim
int launch_core_wide(const Args& a, int B, cudaStream_t stream);
int launch_flash_wide(const Args& a, int B, cudaStream_t stream);

}  // namespace mma_attn
}  // namespace cpt

namespace {

template <int D>
__global__ void __launch_bounds__(cpt::mma_attn::kThreads, cpt::mma_attn::min_blocks<D>())
    attention_kernel(const cpt::mma_attn::Args a) {
  cpt::mma_attn::attention_tile<D, cpt::mma_attn::kCore>(a);
}

template <int D>
__global__ void __launch_bounds__(cpt::mma_attn::kThreads, cpt::mma_attn::min_blocks<D>())
    flash_attention_kernel(const cpt::mma_attn::Args a) {
  cpt::mma_attn::attention_tile<D, cpt::mma_attn::kFlash>(a);
}

}  // namespace
