// cp.async building blocks shared by the kernels that stage device memory
// in shared memory while they compute (paged_attention, mamba_scan).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled where !live.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// G = 4, 8 or 16 bytes global -> shared (16 bypasses L1); zero-filled
// where !live.
template <int G>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool live) {
  if constexpr (G == 16) {
    cp_async16(dst, src, live);
  } else {
    static_assert(G == 4 || G == 8, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(G), "r"(live ? G : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
