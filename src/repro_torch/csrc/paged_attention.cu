// paged_attention: decode attention over KV pages through a page table, for
// Hopper.  bf16 (the served type) runs a split-KV kernel on tensor cores;
// float32 keeps the CUDA-core token walk.  Both return the log-sum-exp of
// the logits beside the output where asked.
//
// Replaces the TPU kernel paged_attention in
// src/repro/kernels/paged_attention.py, whose grid ran (request, kv head,
// page) with the page table prefetched as scalars and the online softmax
// carried across the sequential page axis in VMEM scratch.
//
// Bound: bytes.  A call must read the live tokens' K and V rows of every kv
// head once, plus q, the table entries it uses and seq_lens, and write the
// output (and lse); the arithmetic is 4 * G flops per element read, far
// below the card's ~295 operations a byte.  So the design is about keeping
// enough bytes in flight on all 132 SMs, whatever the requests' lengths.
//
// bf16, paged_attention_split: grid (split s, kv head n, request b).
//  1. Split s owns positions [s * ST, (s + 1) * ST) of request b (ST, the
//     split's tokens: 64, or the table cut to a multiple of 16 where it is
//     shorter; serving's 36 pages of 16 give 9 splits).  A CTA whose split starts at or
//     past seq_lens[b] exits at once; split 0 of an empty request writes
//     zeros and lse = -inf.  The critical path is one split, not the
//     request.
//  2. Warp w takes the split's tile w of 16 positions (a split is at most
//     4 tiles, 64 positions); it issues 16-byte cp.async copies of the
//     tile's K and V rows of head n (the page page_table[b, t / page] for
//     position t) into shared memory, zero-filled past the split's live
//     end: the whole split is in flight before the first product.  A staged
//     row is D (padded to the instantiation's DP) + 8 bf16 long, so the 8
//     rows that one ldmatrix reads fall in 8 different bank groups.
//  3. S^T = K q^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate): positions
//     on M, the G query heads on N (one n8 tile for G <= 8, two for
//     G <= 16).  q goes in unscaled: bf16 x bf16 products are exact in f32,
//     and the f32 logits are scaled after (rounding q * scale to bf16 would
//     put a 2^-9 relative error on every logit, and into lse).
//  4. The softmax of the tile in registers, in base 2: each head's max over
//     the tile by shuffles across the 8 lanes that hold its column.  The
//     weights P are split into two bf16 parts, hi and the rounding error lo
//     (as flash_attention does): hi alone rounds a weight by up to 2^-9,
//     and in serving a layer's output often reaches |o| >= 2, where that
//     moves a bf16 output across a rounding boundary, a 2^-7 step, far more
//     often than the plain version's f32 weights do; hi + lo is the weight
//     to about 2^-17.  Each part is transposed in registers (movmatrix)
//     into the B operand of
//  5. O^T += V^T P^T on mma.sync, V^T read with ldmatrix.trans.
//  6. The warps merge (m, l, acc) through shared memory.  A request with
//     one live split writes out = acc / l and lse = m + log l directly.
//     Else each live split writes its (acc [G, D], m, l) in f32 to a
//     scratch [B, HKV, S, G, D + 4] (rows of 16-byte multiples); the last
//     CTA of (b, n) to finish (an int32 counter per (b, n), kept zeroed by
//     the caller, which that CTA resets to 0) copies the splits' rows into
//     shared memory with cp.async, merges them and writes out and lse.  So a
//     call is one launch, with no memset.  Two calls that share the
//     counters must not run at once (the wrapper keeps them per device
//     and stream, and launches on the current stream).
//
// float32, paged_attention_walk: one CTA a (request, kv head) walks the
// request's tokens itself.  A "subgroup" of LPT lanes (LPT = D / 8 rounded
// up to a power of two) holds one query row, 8 elements a lane; each
// subgroup takes every NSG-th token, reads page_table[b, t / page] and the
// token's K and V row, keeps a running max, denominator and [G, 8]-a-lane
// accumulator (online softmax, f32); the subgroups merge with shuffles, the
// warps through shared memory.  It serves the float32 gate and the tests.
//
// Tokens at or past seq_len are never read, so a recycled page's stale rows
// and whole pages past the length stay out; seq_len = 0 writes zeros, as
// the TPU kernel's floored denominator does, and lse = -inf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cp_async.cuh"
#include "mma_sync.cuh"

namespace {

constexpr float kNegInit = -1e30f;
constexpr float kLn2 = 0.693147180559945309f;

// The bf16 kernel's plan; kernels/paged_attention.py::plan mirrors these,
// and tests/test_torch_paged_plan.py reads them from here.
constexpr int kTileTokens = 16;       // positions a tile: mma.sync's M
constexpr int kRowPad = 8;            // bf16 elements after each staged row
constexpr int kMaxWarps = 4;          // warps a CTA, a tile each
constexpr int kSmemLimit = 232448;    // shared bytes a CTA may use (H100)

// ---------------------------------------------------------------------------
// bf16: split-KV on tensor cores
// ---------------------------------------------------------------------------

// KD: k steps of 16 over the padded head dim DP = 16 KD; NT: n8 tiles of
// query heads.  Dynamic shared memory: q [8 NT][DP + 8] bf16, then a
// region (split_region_bytes) that holds the staged tiles [W][K, V][16]
// [DP + 8] bf16, then the warps' (m, l) [W][8 NT] and acc [W][8 NT][DP]
// in f32, then the last CTA's merge of the splits.
template <int KD, int NT>
__global__ void __launch_bounds__(kMaxWarps * 32) paged_attention_split(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int32_t* __restrict__ table,
    const int32_t* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ part, int32_t* __restrict__ counters,
    int hkv, int g, int d, int page, int ppr, int split_tokens, int region_floats,
    float scale_log2) {
  constexpr int DP = 16 * KD;
  constexpr int RS = DP + kRowPad;  // staged row stride, elements
  constexpr int GN = 8 * NT;        // query heads a CTA computes, G padded
  constexpr int C = DP / 8;         // 16-byte chunks of a staged row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stage = sq + GN * RS;

  const int s = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int h = hkv * g;
  const int64_t qo = (static_cast<int64_t>(b) * h + static_cast<int64_t>(n) * g) * d;
  const int64_t hrow = static_cast<int64_t>(b) * h + static_cast<int64_t>(n) * g;
  const int ctx = ppr * page;
  const int t0 = s * split_tokens;
  const int tb = t0 + warp * kTileTokens;  // this warp's tile of 16 positions
  // Row (lane & 15) of the tile: its table entry, loaded beside the length
  // (neither waits for the other).
  int len = seq_lens[b];
  const int tr = tb + (lane & 15);
  const int64_t phys = tr < ctx ? table[static_cast<int64_t>(b) * ppr + tr / page] : 0;
  len = len < 0 ? 0 : (len > ctx ? ctx : len);
  const int nlive = len == 0 ? 1 : (len + split_tokens - 1) / split_tokens;
  if (s >= nlive) return;
  if (len == 0) {  // split 0 of an empty request
    for (int e = threadIdx.x; e < g * d; e += blockDim.x) out[qo + e] = __float2bfloat16(0.f);
    if (lse != nullptr)
      for (int e = threadIdx.x; e < g; e += blockDim.x) lse[hrow + e] = -INFINITY;
    return;
  }
  const int t_end = min(len, t0 + split_tokens);

  // this warp's tile, all of its copies in flight; row r's element offset
  // comes from lane r
  __nv_bfloat16* ks = stage + warp * 2 * kTileTokens * RS;
  __nv_bfloat16* vs = ks + kTileTokens * RS;
  const bool live_tile = tb < t_end;  // warp-uniform
  if (live_tile) {
    const int64_t row = ((phys * page + tr % page) * hkv + n) * d;
#pragma unroll
    for (int k = 0; k < kTileTokens * C / 32; ++k) {
      const int e = lane + 32 * k;
      const int r = e / C, c = e % C;
      const int64_t off = __shfl_sync(0xffffffffu, row, r) + c * 8;
      if (c * 8 < d) {
        const bool live = tb + r < t_end;
        cp_async16(ks + r * RS + c * 8, live ? k_pages + off : k_pages, live);
        cp_async16(vs + r * RS + c * 8, live ? v_pages + off : v_pages, live);
      } else {  // padding columns: zeros, so no stale value reaches a product
        *reinterpret_cast<uint4*>(ks + r * RS + c * 8) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vs + r * RS + c * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  }
  // q of head n's G query heads, zero-padded to [GN][DP], while the
  // copies fly
  for (int e = threadIdx.x; e < GN * C; e += blockDim.x) {
    const int r = e / C, c = e % C;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < g && c * 8 < d) v = *reinterpret_cast<const uint4*>(q + qo + r * d + c * 8);
    *reinterpret_cast<uint4*>(sq + r * RS + c * 8) = v;
  }
  __syncthreads();  // q staged

  const int gid = lane >> 2, tig = lane & 3;
  float m[NT][2], lp[NT][2];  // the tile's max (base 2) and this lane's share
                              // of l, for heads 2 tig and 2 tig + 1 of each n tile
  float acc[KD][NT][4];       // O^T: rows d, columns heads
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[nt][0] = m[nt][1] = -INFINITY;  // a warp with no live position weighs 0
    lp[nt][0] = lp[nt][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < KD; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
  }
  if (live_tile) {
    cp_async_wait<0>();
    __syncwarp();
    // S^T [16 positions][8 NT heads] = K q^T
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ks + (((lane >> 3) & 1) * 8 + (lane & 7)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bq[2];
        ldmatrix_x2(bq, sq + (nt * 8 + (lane & 7)) * RS + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[nt], a, bq);
      }
    }
    // the tile's softmax; P^T hi and lo as the B operand
    const bool live0 = tb + gid < t_end, live1 = tb + gid + 8 < t_end;
    uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float x0 = live0 ? sc[nt][0] * scale_log2 : -INFINITY;
      const float x1 = live0 ? sc[nt][1] * scale_log2 : -INFINITY;
      const float x2 = live1 ? sc[nt][2] * scale_log2 : -INFINITY;
      const float x3 = live1 ? sc[nt][3] * scale_log2 : -INFINITY;
      float mx0 = fmaxf(x0, x2), mx1 = fmaxf(x1, x3);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      // position tb is live, so mx0 and mx1 are finite
      m[nt][0] = mx0;
      m[nt][1] = mx1;
      const float p0 = exp2f(x0 - mx0), p1 = exp2f(x1 - mx1);
      const float p2 = exp2f(x2 - mx0), p3 = exp2f(x3 - mx1);
      lp[nt][0] = p0 + p2;
      lp[nt][1] = p1 + p3;
      uint32_t h0, l0, h1, l1;
      split_bf16(p0, p1, h0, l0);  // positions gid
      split_bf16(p2, p3, h1, l1);  // positions gid + 8
      bhi[nt][0] = transpose8x8(h0);
      bhi[nt][1] = transpose8x8(h1);
      blo[nt][0] = transpose8x8(l0);
      blo[nt][1] = transpose8x8(l1);
    }
    // O^T [DP][8 NT] = V^T P^T
#pragma unroll
    for (int mt = 0; mt < KD; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, vs + ((lane >> 4) * 8 + (lane & 7)) * RS + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(acc[mt][nt], a, bhi[nt]);
        mma_bf16(acc[mt][nt], a, blo[nt]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        lp[nt][0] += __shfl_xor_sync(0xffffffffu, lp[nt][0], o);
        lp[nt][1] += __shfl_xor_sync(0xffffffffu, lp[nt][1], o);
      }
  }

  // the warps' (m, l, acc) through shared memory, over the staged tiles
  __syncthreads();
  float* mw = reinterpret_cast<float*>(stage);  // [W][GN]
  float* lw = mw + nwarps * GN;                 // [W][GN]
  float* aw = lw + nwarps * GN;                 // [W][GN][DP]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c0 = warp * GN + nt * 8 + 2 * tig;
    if (gid == 0) {
      mw[c0] = m[nt][0];
      mw[c0 + 1] = m[nt][1];
      lw[c0] = lp[nt][0];
      lw[c0 + 1] = lp[nt][1];
    }
#pragma unroll
    for (int mt = 0; mt < KD; ++mt) {
      aw[c0 * DP + mt * 16 + gid] = acc[mt][nt][0];
      aw[(c0 + 1) * DP + mt * 16 + gid] = acc[mt][nt][1];
      aw[c0 * DP + mt * 16 + gid + 8] = acc[mt][nt][2];
      aw[(c0 + 1) * DP + mt * 16 + gid + 8] = acc[mt][nt][3];
    }
  }
  __syncthreads();
  const bool single = nlive == 1;
  const int64_t bn = static_cast<int64_t>(b) * hkv + n;
  const int pw = d + 4;   // a partial row: acc [d], m, l, 2 floats of padding
  const int per = g * pw;  // floats a split
  // this (b, n)'s splits in the scratch
  float* base = single ? nullptr : part + bn * gridDim.x * per;
  for (int e = threadIdx.x; e < g * d; e += blockDim.x) {
    const int gg = e / d, dd = e % d;
    float mx = -INFINITY;
    for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, mw[w * GN + gg]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float f = exp2f(mw[w * GN + gg] - mx);  // 0 for a warp with no live tile
      den += lw[w * GN + gg] * f;
      num += aw[(w * GN + gg) * DP + dd] * f;
    }
    if (single) {
      out[qo + e] = __float2bfloat16(num / den);
      if (lse != nullptr && dd == 0) lse[hrow + gg] = (mx + log2f(den)) * kLn2;
    } else {
      float* row = base + static_cast<int64_t>(s) * per + gg * pw;
      row[dd] = num;
      if (dd == 0) {
        row[d] = mx;
        row[d + 1] = den;
      }
    }
  }
  if (single) return;

  // the last live split of (b, n) to finish merges them all: after the
  // barrier, one thread's fence orders the CTA's rows before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int prev = atomicAdd(counters + bn, 1);
    s_last = prev == nlive - 1;
    if (s_last) atomicExch(counters + bn, 0);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // The splits' partial rows come into shared memory (over the staged
  // tiles) a chunk of splits at a time, all of a chunk's copies in flight
  // together; a running max, denominator and rescale per head and a
  // running sum per element stay in shared memory beside them.
  float* run = reinterpret_cast<float*>(stage);  // [g][d]
  float* run_m = run + g * d;                     // [g]
  float* run_l = run_m + g;                       // [g]
  float* run_f = run_l + g;                       // [g]
  float* buf = run + ((g * d + 3 * g + 3) & ~3);  // [chunk][g][d + 4], 16-byte aligned
  const int chunk = (region_floats - static_cast<int>(buf - run)) / per;
  for (int e = threadIdx.x; e < g * d; e += blockDim.x) run[e] = 0.f;
  for (int gg = threadIdx.x; gg < g; gg += blockDim.x) {
    run_m[gg] = -INFINITY;
    run_l[gg] = 0.f;
  }
  for (int j0 = 0; j0 < nlive; j0 += chunk) {
    const int cs = min(chunk, nlive - j0);
    const float* src = base + static_cast<int64_t>(j0) * per;
    for (int e = threadIdx.x; e < cs * per / 4; e += blockDim.x)
      cp_async16(buf + 4 * e, src + 4 * e, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int gg = threadIdx.x; gg < g; gg += blockDim.x) {
      float mx = run_m[gg];
      for (int j = 0; j < cs; ++j) mx = fmaxf(mx, buf[j * per + gg * pw + d]);
      const float f = exp2f(run_m[gg] - mx);  // 0 at the first chunk
      float den = run_l[gg] * f;
      for (int j = 0; j < cs; ++j) {
        float* r = buf + j * per + gg * pw;
        const float w = exp2f(r[d] - mx);
        r[d] = w;  // the split's weight, for the sums below
        den += r[d + 1] * w;
      }
      run_m[gg] = mx;
      run_l[gg] = den;
      run_f[gg] = f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < g * d; e += blockDim.x) {
      const int gg = e / d, dd = e % d;
      float a = run[e] * run_f[gg];
      for (int j = 0; j < cs; ++j) {
        const float* r = buf + j * per + gg * pw;
        a += r[dd] * r[d];
      }
      run[e] = a;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < g * d; e += blockDim.x) {
    const int gg = e / d, dd = e % d;
    out[qo + e] = __float2bfloat16(run[e] / run_l[gg]);
    if (lse != nullptr && dd == 0) lse[hrow + gg] = (run_m[gg] + log2f(run_l[gg])) * kLn2;
  }
}

// The shared bytes of a plan; kernels/paged_attention.py::plan computes
// the same.
// The bytes after q that the tiles, then the merges, reuse: the staged K
// and V tiles; the warps' (m, l, acc); the last CTA's running sums and at
// least one split's partial rows.
int split_region_bytes(int dp, int nt, int warps) {
  const int gn = 8 * nt;
  const int staged = warps * 2 * kTileTokens * (dp + kRowPad) * 2;
  const int warps_merge = warps * gn * (dp + 2) * 4;
  const int splits_merge = (gn * (2 * dp + 7) + 4) * 4;
  const int m = staged > warps_merge ? staged : warps_merge;
  return m > splits_merge ? m : splits_merge;
}

int split_smem_bytes(int dp, int nt, int warps) {
  return 8 * nt * (dp + kRowPad) * 2 + split_region_bytes(dp, nt, warps);
}

template <int KD, int NT>
cudaError_t launch_split(const void* q, const void* kp, const void* vp, const int32_t* table,
                         const int32_t* seq_lens, void* out, float* lse, float* part,
                         int32_t* counters, int b, int hkv, int g, int d, int page, int ppr,
                         int warps, int splits, int split_tokens, int smem, float scale,
                         cudaStream_t stream) {
  auto kern = paged_attention_split<KD, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const float log2e = 1.4426950408889634f;
  kern<<<dim3(splits, hkv, b), warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), table, seq_lens,
      static_cast<__nv_bfloat16*>(out), lse, part, counters, hkv, g, d, page, ppr,
      split_tokens, split_region_bytes(16 * KD, NT, warps) / 4,
      scale * log2e);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* kp, const void* vp, const int32_t* table,
                        const int32_t* seq_lens, void* out, float* lse, float* part,
                        int32_t* counters, int b, int hkv, int g, int d, int page, int ppr,
                        int warps, int splits, int split_tokens, int padded_d, int smem,
                        float scale, cudaStream_t stream) {
  // the plan must be one this source computes and builds
  const int ctx = ppr * page;
  if (split_tokens <= 0 || split_tokens % kTileTokens || padded_d < d || padded_d % 16)
    return cudaErrorInvalidValue;
  const int want_splits = ctx == 0 ? 1 : (ctx + split_tokens - 1) / split_tokens;
  if (splits != want_splits || warps < 1 || warps > kMaxWarps ||
      warps != split_tokens / kTileTokens || b > 65535 || hkv > 65535)
    return cudaErrorInvalidValue;
  const int nt = g <= 8 ? 1 : 2;
  if (smem != split_smem_bytes(padded_d, nt, warps) || smem > kSmemLimit)
    return cudaErrorInvalidValue;
  if (splits > 1 && (part == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
#define DEX_PAGED_PLAN(KD, NT)                                                             \
  if (padded_d == 16 * KD && nt == NT)                                                     \
    return launch_split<KD, NT>(q, kp, vp, table, seq_lens, out, lse, part, counters, b,  \
                                hkv, g, d, page, ppr, warps, splits, split_tokens, smem,   \
                                scale, stream);
  DEX_PAGED_PLAN(1, 1)
  DEX_PAGED_PLAN(1, 2)
  DEX_PAGED_PLAN(2, 1)
  DEX_PAGED_PLAN(2, 2)
  DEX_PAGED_PLAN(4, 1)
  DEX_PAGED_PLAN(4, 2)
  DEX_PAGED_PLAN(6, 1)
  DEX_PAGED_PLAN(6, 2)
  DEX_PAGED_PLAN(8, 1)
  DEX_PAGED_PLAN(8, 2)
  DEX_PAGED_PLAN(12, 1)
  DEX_PAGED_PLAN(12, 2)
  DEX_PAGED_PLAN(16, 1)
  DEX_PAGED_PLAN(16, 2)
#undef DEX_PAGED_PLAN
  return cudaErrorInvalidValue;  // no instantiation for this plan
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core token walk
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
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

template <int G>
__global__ void paged_attention_walk(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int32_t* __restrict__ table,
    const int32_t* __restrict__ seq_lens, float* __restrict__ out, float* __restrict__ lse,
    int hkv, int d, int page, int ppr, int lpt, float scale) {
  extern __shared__ float smem_f[];
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
  float* sm_m = smem_f;
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
    const int64_t row = static_cast<int64_t>(b) * h + n * G + g;
    out[row * d + e % d] = num / fmaxf(den, 1e-30f);
    if (lse != nullptr && e % d == 0) lse[row] = len == 0 ? -INFINITY : mx + logf(den);
  }
}

template <int G>
cudaError_t launch_walk_g(const void* q, const void* kp, const void* vp,
                          const int32_t* table, const int32_t* seq_lens, void* out,
                          float* lse, int b, int hkv, int d, int page, int ppr, int nwarps,
                          int smem, float scale, cudaStream_t stream) {
  int lpt = 1;
  while (lpt * 8 < d) lpt <<= 1;
  if (smem != static_cast<int>(sizeof(float)) * nwarps * G * (2 + d) || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  paged_attention_walk<G><<<dim3(b, hkv), nwarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), table, seq_lens, static_cast<float*>(out), lse, hkv, d,
      page, ppr, lpt, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* kp, const void* vp, const int32_t* table,
                       const int32_t* seq_lens, void* out, float* lse, int b, int hkv, int g,
                       int d, int page, int ppr, int nwarps, int smem, float scale,
                       cudaStream_t stream) {
#define PA_CASE(GG)                                                                    \
  case GG:                                                                             \
    return launch_walk_g<GG>(q, kp, vp, table, seq_lens, out, lse, b, hkv, d, page, ppr, \
                             nwarps, smem, scale, stream);
  switch (g) {
    PA_CASE(1) PA_CASE(2) PA_CASE(3) PA_CASE(4) PA_CASE(5) PA_CASE(6) PA_CASE(7) PA_CASE(8)
    PA_CASE(9) PA_CASE(10) PA_CASE(11) PA_CASE(12) PA_CASE(13) PA_CASE(14) PA_CASE(15)
    PA_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef PA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q [b, hkv * g, d]; k_pages / v_pages
// [P, page, hkv, d]; table [b, ppr] int32; seq_lens [b] int32; out like q;
// lse [b, hkv * g] f32 or null; part [b, hkv, splits, g, d + 4] f32 and
// counters [>= b * hkv] int32, all 0, where splits > 1 (bf16).  warps,
// splits, split_tokens, padded_d and smem_bytes are the host's plan
// (kernels/paged_attention.py::plan); a plan this source does not compute
// or build is refused (CUDA error 1).
extern "C" int dex_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                   const int32_t* table, const int32_t* seq_lens, void* out,
                                   float* lse, float* part, int32_t* counters, int dtype,
                                   int b, int hkv, int g, int d, int page, int ppr, int warps,
                                   int splits, int split_tokens, int padded_d, int smem_bytes,
                                   float scale, void* stream) {
  if (b == 0 || hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_f32(q, k_pages, v_pages, table, seq_lens, out, lse, b, hkv, g, d, page,
                       ppr, warps, smem_bytes, scale, s)
          : launch_bf16(q, k_pages, v_pages, table, seq_lens, out, lse, part, counters, b,
                        hkv, g, d, page, ppr, warps, splits, split_tokens, padded_d,
                        smem_bytes, scale, s);
  return static_cast<int>(err);
}
