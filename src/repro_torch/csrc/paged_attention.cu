// paged_attention: decode attention over KV pages through a page table, on
// Hopper's CUDA cores.
//
// Replaces the TPU kernel paged_attention in
// src/repro/kernels/paged_attention.py, whose grid ran (request, kv head,
// page) with the page table prefetched as scalars and the online softmax
// carried across the sequential page axis in VMEM scratch.  Here one CTA
// owns one (request b, kv head n) and walks the request's tokens itself:
//
//  1. the G = H / HKV query heads of head n are loaded once, scaled, into
//     registers: a "subgroup" of LPT lanes (LPT = D / 8 rounded up to a
//     power of two) holds one query row, 8 elements a lane;
//  2. each subgroup takes every NSG-th token below seq_len[b] (NSG = the
//     CTA's subgroups), reads page_table[b, t / page], and loads the token's
//     K and V row of head n (16 bytes a lane in bf16, 32 in f32); the G
//     dot products are reduced with shuffles inside the subgroup, and the
//     subgroup keeps a running max, denominator and [G, 8]-a-lane
//     accumulator (online softmax, f32);
//  3. the subgroups of a warp merge with shuffles, the warps through
//     shared memory, and the CTA writes out = acc / max(l, 1e-30) in q's
//     type.  Tokens at or past seq_len are never read, so a recycled page's
//     stale rows and whole pages past the length stay out; seq_len = 0
//     writes zeros, as the TPU kernel's floored denominator does.
//
// Bound: bytes.  A call must read the live tokens' K and V rows of every kv
// head once, plus q, the table entries it uses and seq_lens, and write the
// output; the arithmetic is 4 * G flops per element read.  Each K and V
// element is read once per CTA, and a CTA's G query heads share that read.
// The token loop is latency-bound at small lengths (no cp.async / TMA
// pipeline, no split over the sequence yet).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInit = -1e30f;

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Merge the online-softmax state (m, l, acc) with a partner lane's.
template <int G>
__device__ __forceinline__ void merge_xor(float* m, float* l, float (*acc)[8],
                                          int offset) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float om = __shfl_xor_sync(0xffffffffu, m[g], offset);
    const float ol = __shfl_xor_sync(0xffffffffu, l[g], offset);
    const float mn = fmaxf(m[g], om);
    const float a = expf(m[g] - mn);
    const float b = expf(om - mn);
    l[g] = l[g] * a + ol * b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float oa = __shfl_xor_sync(0xffffffffu, acc[g][j], offset);
      acc[g][j] = acc[g][j] * a + oa * b;
    }
    m[g] = mn;
  }
}

template <typename T, int G>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ table,
    const int32_t* __restrict__ seq_lens, T* __restrict__ out, int hkv, int d,
    int page, int ppr, int lpt, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sub = lane / lpt;     // subgroup within the warp
  const int sl = lane % lpt;      // lane within the subgroup
  const int per_warp = 32 / lpt;  // subgroups a warp
  const int nsg = nwarps * per_warp;
  const int c0 = sl * 8;          // this lane's first element of a row
  const bool live = c0 < d;
  const int h = hkv * G;

  float qv[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (live) {
      load8(q + (static_cast<int64_t>(b) * h + n * G + g) * d + c0, qv[g]);
#pragma unroll
      for (int j = 0; j < 8; ++j) qv[g][j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) qv[g][j] = 0.f;
    }
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInit;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

  int len = seq_lens[b];
  len = len < 0 ? 0 : (len > ppr * page ? ppr * page : len);
  const int32_t* row_table = table + static_cast<int64_t>(b) * ppr;
  const int64_t head_off = static_cast<int64_t>(n) * d + c0;
  // The warp walks its tokens in lockstep (every lane runs every iteration,
  // so the shuffles below see the whole warp); lane subgroup `sub` takes
  // token base + sub, and the next token's rows are loaded before this
  // one's are used.
  float kv[8], vv[8], kn[8], vn[8];
  auto load_token = [&](int t, float* kd, float* vd) {
    if (live && t < len) {
      const int64_t phys = row_table[t / page];
      const int64_t off = ((phys * page + t % page) * hkv) * d + head_off;
      load8(k_pages + off, kd);
      load8(v_pages + off, vd);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) kd[j] = vd[j] = 0.f;
    }
  };
  const int first = warp * per_warp;
  load_token(first + sub, kv, vv);
  for (int base = first; base < len; base += nsg) {
    load_token(base + nsg + sub, kn, vn);
    const bool tok = base + sub < len;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(qv[g][j], kv[j], s);
      for (int o = lpt >> 1; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (tok) {
        const float mn = fmaxf(m[g], s);
        const float a = expf(m[g] - mn);
        const float p = expf(s - mn);
        l[g] = l[g] * a + p;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j] * a);
        m[g] = mn;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      kv[j] = kn[j];
      vv[j] = vn[j];
    }
  }
  for (int o = lpt; o < 32; o <<= 1) merge_xor<G>(m, l, acc, o);

  // warps -> shared memory: [nwarps][G] m and l, [nwarps][G][d] acc
  float* sm_m = smem;
  float* sm_l = sm_m + nwarps * G;
  float* sm_acc = sm_l + nwarps * G;
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (sl == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sm_acc[(warp * G + g) * d + c0 + j] = acc[g][j];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * d; e += blockDim.x) {
    const int g = e / d;
    float mx = kNegInit;
    for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float f = expf(sm_m[w * G + g] - mx);
      den += sm_l[w * G + g] * f;
      num += sm_acc[(w * G + g) * d + (e % d)] * f;
    }
    store1(out + (static_cast<int64_t>(b) * h + n * G) * d + e,
           num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int G>
cudaError_t launch_g(const void* q, const void* kp, const void* vp,
                     const int32_t* table, const int32_t* seq_lens, void* out,
                     int b, int hkv, int d, int page, int ppr, int nwarps,
                     float scale, cudaStream_t stream) {
  int lpt = 1;
  while (lpt * 8 < d) lpt <<= 1;
  const size_t smem = sizeof(float) * nwarps * G * (2 + d);
  dim3 grid(b, hkv);
  paged_attention_kernel<T, G><<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, seq_lens, static_cast<T*>(out), hkv,
      d, page, ppr, lpt, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const int32_t* table, const int32_t* seq_lens, void* out,
                     int b, int hkv, int g, int d, int page, int ppr,
                     int nwarps, float scale, cudaStream_t stream) {
#define PA_CASE(GG)                                                          \
  case GG:                                                                   \
    return launch_g<T, GG>(q, kp, vp, table, seq_lens, out, b, hkv, d, page, \
                           ppr, nwarps, scale, stream);
  switch (g) {
    PA_CASE(1)
    PA_CASE(2)
    PA_CASE(3)
    PA_CASE(4)
    PA_CASE(5)
    PA_CASE(6)
    PA_CASE(7)
    PA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q [b, hkv * g, d]; k_pages / v_pages
// [P, page, hkv, d]; table [b, ppr] int32; seq_lens [b] int32; out like q.
extern "C" int dex_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const int32_t* table,
                                   const int32_t* seq_lens, void* out,
                                   int dtype, int b, int hkv, int g, int d,
                                   int page, int ppr, int nwarps, float scale,
                                   void* stream) {
  if (b == 0 || hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_t<float>(q, k_pages, v_pages, table, seq_lens, out,
                                   b, hkv, g, d, page, ppr, nwarps, scale, s)
                 : launch_t<__nv_bfloat16>(q, k_pages, v_pages, table,
                                           seq_lens, out, b, hkv, g, d, page,
                                           ppr, nwarps, scale, s);
  return static_cast<int>(err);
}
