// K6, the flash-attention forward (flash_attention.cu), on the tile at the
// dims above mma_attn::kSplitD (144 .. 256), compiled apart so that nvcc
// builds the two halves of the instantiations in parallel.
#include "attention_kernels.cuh"

int cpt::mma_attn::launch_flash_wide(const Args& a, int B, cudaStream_t stream) {
  return with_tile_dim<kSplitD + 16>(a.d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return launch<D>(flash_attention_kernel<D>, a, B, stream);
  });
}
