// Asynchronous 16-byte copies from global to shared memory (cp.async),
// shared by the tile kernel (tile_traverse.cu, K1) and the pulse-ladder
// kernel (pulse_traverse.cu, K2): each stages the Wald rows of its
// candidates with them.
#pragma once

namespace lbt {

// Through L2 only (.cg).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(__cvta_generic_to_global(gmem)) : "memory");
}

// Through L1 as well (.ca): for data that many blocks of one SM copy, which
// would otherwise queue at the one L2 slice that holds it.
__device__ __forceinline__ void cp_async16_l1(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(__cvta_generic_to_global(gmem)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace lbt
