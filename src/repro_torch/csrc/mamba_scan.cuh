// Staging helpers shared by mamba_scan's forward (mamba_scan.cu) and its
// backward (mamba_scan_bwd.cu): both copy four-element groups of a chunk of
// steps into shared memory with cp.async, convert them to f32 once, and read
// a step's (B, C) pairs in the same lane order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

// Four consecutive elements as f32 (16 bytes of f32 or 8 of bf16, aligned
// so; a bf16 is the high half of its f32).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ inline int r16(int v) { return (v + 15) / 16 * 16; }

// Four consecutive elements, `live` of them real (0-4), global -> shared,
// the rest zero-filled: one cp.async of 16 (f32) or 8 (bf16) bytes where
// `vec` (then live is 0 or 4), else one a float, or plain loads a bf16.
template <typename E>
__device__ __forceinline__ void copy4(E* dst, const E* src, const E* base, bool vec,
                                      int live) {
  if (vec) {
    cp_async<4 * sizeof(E)>(dst, live > 0 ? src : base, live > 0);
  } else if constexpr (sizeof(E) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) cp_async<4>(dst + i, i < live ? src + i : base, i < live);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = i < live ? src[i] : __float2bfloat16(0.f);
  }
}

// The float4 of a row of (B, C) pairs that holds state k's pair, in row t
// (S >= 2): float4 i of lane j (its states j * S + 2 i and 2 i + 1) at
// i * LPC + j, so that a warp's lanes read neighbouring words.
template <int S, int LPC>
__host__ __device__ __forceinline__ int bc_slot(int t, int k) {
  return t * (S * LPC / 2) + (k % S) / 2 * LPC + k / S;
}

// Lane j's S (B, C) pairs of row t of bc (laid out by bc_slot; S = 1: float2
// t * LPC + j).
template <int S, int LPC>
__device__ __forceinline__ void load_bc(const float2* bc, int t, int j, float (&bv)[S],
                                        float (&cv)[S]) {
  if constexpr (S == 1) {
    const float2 w = bc[t * LPC + j];
    bv[0] = w.x;
    cv[0] = w.y;
  } else {
    const float4* q = reinterpret_cast<const float4*>(bc) + t * (S * LPC / 2) + j;
#pragma unroll
    for (int i = 0; i < S / 2; ++i) {
      const float4 v = q[i * LPC];
      bv[2 * i] = v.x;
      cv[2 * i] = v.y;
      bv[2 * i + 1] = v.z;
      cv[2 * i + 1] = v.w;
    }
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace
