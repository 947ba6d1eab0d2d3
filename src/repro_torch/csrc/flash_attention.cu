// flash_attention: blocked prefill attention with an online softmax, on
// Hopper's CUDA cores.
//
// Replaces the TPU kernel flash_attention in
// src/repro/kernels/flash_attention.py, whose grid ran (batch * head, q
// block, kv block) with the running max, denominator and accumulator in
// VMEM scratch across the sequential kv axis, and pointed each query head at
// its kv head by an index map.  Here one CTA of 256 threads owns one
// (batch * head, 64-row q tile) and loops over the kv tiles itself:
//
//  1. the q tile is staged once in shared memory as f32, pre-scaled (the
//     TPU kernel scales q before the product too); the kv head is
//     h / (H / HKV), so GQA needs no copy of K or V;
//  2. per kv tile of 64 rows: K and V are staged in shared memory as f32;
//     each thread computes a 4 x 4 block of the 64 x 64 scores (rows
//     ty + 16 i, columns tx + 16 j), masks the tail (key >= Sk, query >=
//     Sq) and, when causal, keys above the diagonal q + (Sk - Sq); row
//     maxima and sums are reduced over the 16 threads of a row with
//     shuffles; the probabilities go through shared memory into the
//     thread's [4, D / 16] block of the output accumulator;
//  3. tiles wholly above the causal diagonal are never visited; the CTA
//     writes acc / max(l, 1e-30) in q's type.  Any Sq and Sk are taken: the
//     last q and kv tiles are masked, not asserted away.
//
// Bound: operations.  Per (query, key) pair the causal mask keeps, 4 * D
// flops (QK^T and PV); against the card's dense bf16 tensor-core peak this
// kernel, on CUDA cores in f32, is far above its bound by design: wgmma,
// TMA staging and warp specialisation are later work.  A row that no key
// is allowed to reach (causal with Sk < Sq) comes out 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 64;  // q rows and kv rows of a tile
constexpr int kThreads = 256;
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// NJ: output columns a thread owns, ceil(D / 16) rounded up to a power of 2.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int h,
                           int hkv, int sq, int sk, int d, float scale,
                           int causal) {
  extern __shared__ float smem[];
  const int dp = d + 1;  // padded row stride of Qs and Ks: no bank conflicts
  float* qs = smem;                   // [64][d + 1]
  float* ks = qs + kBlock * dp;       // [64][d + 1]
  float* vs = ks + kBlock * dp;       // [64][d]
  float* ps = vs + kBlock * d;        // [64][65]

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int kvh = b * hkv + (bh % h) / (h / hkv);
  const int q0 = blockIdx.x * kBlock;
  const int off = sk - sq;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qb = q + static_cast<int64_t>(bh) * sq * d;
  const T* kb = k + static_cast<int64_t>(kvh) * sk * d;
  const T* vb = v + static_cast<int64_t>(kvh) * sk * d;
  for (int e = tid; e < kBlock * d; e += kThreads) {
    const int r = e / d, c = e % d;
    qs[r * dp + c] =
        q0 + r < sq ? to_f32(qb[static_cast<int64_t>(q0 + r) * d + c]) * scale
                    : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInit;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // kv tiles to visit: all of them, or up to the causal diagonal of the
  // tile's last real row
  int last_key = sk - 1;
  if (causal) {
    const int last_q = min(q0 + kBlock, sq) - 1;
    last_key = min(last_key, last_q + off);
  }
  const int n_tiles = last_key < 0 ? 0 : last_key / kBlock + 1;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    for (int e = tid; e < kBlock * d; e += kThreads) {
      const int r = e / d, c = e % d;
      const bool in = k0 + r < sk;
      const int64_t g = static_cast<int64_t>(k0 + r) * d + c;
      ks[r * dp + c] = in ? to_f32(kb[g]) : 0.f;
      vs[r * d + c] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * dp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[4];
      float mx = kNegInit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < sk && qpos < sq && (!causal || kpos <= qpos + off);
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - mn) : 0.f;
        sum += p;
        ps[(ty + 16 * i) * (kBlock + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBlock; ++c) {
      float pa[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty + 16 * i) * (kBlock + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        vv[j] = col < d ? vs[c * d + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + static_cast<int64_t>(bh) * sq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) store1(ob + static_cast<int64_t>(qpos) * d + col, acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch_nj(const void* q, const void* k, const void* v, void* out,
                      int b, int h, int hkv, int sq, int sk, int d,
                      float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kBlock * (d + 1) + kBlock * d + kBlock * (kBlock + 1));
  auto kern = flash_attention_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBlock - 1) / kBlock, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), h, hkv, sq, sk, d, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     int b, int h, int hkv, int sq, int sk, int d, float scale,
                     int causal, cudaStream_t stream) {
  if (d <= 32)
    return launch_nj<T, 2>(q, k, v, out, b, h, hkv, sq, sk, d, scale, causal, stream);
  if (d <= 64)
    return launch_nj<T, 4>(q, k, v, out, b, h, hkv, sq, sk, d, scale, causal, stream);
  if (d <= 128)
    return launch_nj<T, 8>(q, k, v, out, b, h, hkv, sq, sk, d, scale, causal, stream);
  return launch_nj<T, 16>(q, k, v, out, b, h, hkv, sq, sk, d, scale, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q [b, h, sq, d]; k, v [b, hkv, sk, d];
// out like q.  d is a multiple of 8, at most 256; h is a multiple of hkv.
extern "C" int dex_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int dtype, int b, int h, int hkv,
                                   int sq, int sk, int d, float scale,
                                   int causal, void* stream) {
  if (b == 0 || h == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_t<float>(q, k, v, out, b, h, hkv, sq, sk, d, scale,
                                   causal, s)
                 : launch_t<__nv_bfloat16>(q, k, v, out, b, h, hkv, sq, sk, d,
                                           scale, causal, s);
  return static_cast<int>(err);
}
