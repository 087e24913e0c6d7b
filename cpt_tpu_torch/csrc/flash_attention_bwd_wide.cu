// K6b and K6c on the tile (flash_attention_bwd.cuh) at the dims above
// mma_attn::kSplitD (144 .. 256), compiled apart from flash_attention_bwd.cu
// so that nvcc builds the two halves of the instantiations in parallel.
#include "flash_attention_bwd.cuh"

int cpt::flash_bwd::launch_dkv_wide(const BwdArgs& a, int B, cudaStream_t stream) {
  return ma::with_tile_dim<ma::kSplitD + 16>(a.d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return ma::launch<D>(flash_bwd_dkv_kernel<D>, a, B, stream, dkv_smem_bytes<D>());
  });
}

int cpt::flash_bwd::launch_dq_wide(const BwdArgs& a, int B, cudaStream_t stream) {
  return ma::with_tile_dim<ma::kSplitD + 16>(a.d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return ma::launch<D>(flash_bwd_dq_kernel<D>, a, B, stream, dq_smem_bytes<D>());
  });
}
