// flash_attention_bwd: the gradient of flash_attention (dQ, dK, dV), for
// Hopper.
//
// Replaces no TPU kernel.  The reference has no backward Pallas kernel: it
// trains through its jnp sdpa (src/repro/models/layers.py:144-209), which
// XLA differentiates.  The port's attention is the flash_attention kernel,
// so its gradient has to be a kernel of its own (the plain version may not
// run on the main path where a card is present).
//
// Bound: operations.  Per (query, key) pair the causal mask keeps and per
// head, 10 * D flops: S = Q K^T recomputed, dV += P^T dO, dP = dO V^T,
// dQ += dS K and dK += dS^T Q.  At minitron-4b's training shape ([2, 24,
// 4096, 128] over 8 kv heads, causal) that is 515 GFLOP, 0.52 ms at the
// card's dense bf16 tensor-core rate, far above its bytes.
//
// Three launches, none with atomics, so that every output element is summed
// by one thread in a fixed order and two runs are bit-equal (the remat
// recompute of a block relies on it):
//  1. a pre-pass, 8 lanes a row: Delta = rowsum(dO * O) and the base-2
//     log-sum-exp lse * log2(e) (+inf where lse = -inf: a row no key
//     reaches then gets P = 0) into the caller's f32 scratch [B, H, Sq];
//  2. dK / dV: one CTA a (64-key tile, batch * kv head).  It keeps its K and
//     V tile in shared memory and loops over the group's G query heads and
//     the q tiles the causal mask keeps (from row k0 - (Sk - Sq) on), their
//     Q and dO tiles double-buffered with cp.async; each of its 4 warps owns
//     16 keys and computes S^T = K Q^T and dP^T = V dO^T for them, P^T =
//     exp2(S^T scale log2(e) - lse2), dS^T = P^T (dP^T - Delta), then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T fed from registers as
//     the A operand (the accumulator's layout is the A fragment's);
//  3. dQ: one CTA a (64-row q tile, batch * head); its Q and dO rows go to
//     registers once as A fragments, the k tiles up to the causal diagonal
//     are double-buffered with cp.async, and each warp computes S, P, dP and
//     dS for its 16 rows, then dQ += dS K.
// bf16 runs on mma.sync.m16n8k16 (bf16 in, f32 accumulate; P and dS are
// rounded to bf16 as the products' operands), with ldmatrix (.trans where a
// tile is read along its rows) from rows padded by 8 elements, so the 8 rows
// that one ldmatrix reads fall in 8 bank groups.  float32 runs on CUDA cores
// (64 x 64 tiles, a 4 x 4 block of pairs a thread, fmaf): on tensor cores it
// would be TF32, which the float32 gates refuse.  Zero-filled rows past Sq
// or Sk add nothing (their Q, dO, K or V is 0); rows and keys the causal
// mask removes get P = 0.  Head dims 64, 80, 96 and 128; causal with offset
// Sk - Sq or not; any G, Sq and Sk.  wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "cp_async.cuh"
#include "mma_sync.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;                 // warps a tensor-core CTA
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kRowPad = 8;                // bf16 elements after each staged row
constexpr int kKvTile = 16 * kWarps;      // keys a dK / dV CTA: 16 a warp
constexpr int kQStep = 32;                // q rows a step of its loop
constexpr int kQTile = 16 * kWarps;       // q rows a dQ CTA: 16 a warp
constexpr int kKStep = 32;                // keys a step of its loop
constexpr int kBlock = 64;                // the f32 kernels' tile rows
constexpr int kF32Threads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// the pre-pass
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
    bwd_prepass(const T* __restrict__ o, const T* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ delta,
                float* __restrict__ lse2, int64_t rows, int d) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 8;
  const int sub = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    const T* a = o + row * d;
    const T* b = dout + row * d;
    for (int c = sub; c < d; c += 8) acc = fmaf(to_f32(a[c]), to_f32(b[c]), acc);
  }
#pragma unroll
  for (int x = 4; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (row < rows && sub == 0) {
    const float l = lse[row];
    const bool none = l == -CUDART_INF_F;
    delta[row] = none ? 0.f : acc;
    lse2[row] = none ? CUDART_INF_F : l * kLog2e;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on tensor cores (mma.sync)
// ---------------------------------------------------------------------------

// A fragment (16 x 16) of the matrix stored [m][k] at `base` (row stride
// rs), rows m0.., columns k0...
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* base, int rs,
                                       int m0, int k0, int lane) {
  ldmatrix_x4(a, base + (m0 + (lane & 15)) * rs + k0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (n0 and n0 + 8) of one k16 step at k0, from
// the matrix stored [n][k] (k contiguous): b[0..1] tile n0, b[2..3] n0 + 8.
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b)[4], const __nv_bfloat16* base, int rs,
                                          int n0, int k0, int lane) {
  ldmatrix_x4(b, base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * rs + k0 +
                     ((lane >> 3) & 1) * 8);
}

// The same from the matrix stored [k][n] (n contiguous), read transposed.
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&b)[4], const __nv_bfloat16* base, int rs,
                                          int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, base + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * rs + n0 +
                           (lane >> 4) * 8);
}

// rows [r0, r0 + n) of the [rows, D] bf16 matrix at `src` into `dst` (row
// stride RS) with 16-byte cp.async, zero-filled from row `limit` on.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                           int n, int limit) {
  constexpr int C = D / 8;
  constexpr int RS = D + kRowPad;
  for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
    const int r = e / C, c = e % C;
    const bool live = r0 + r < limit;
    cp_async16(dst + r * RS + c * 8, src + static_cast<int64_t>(live ? r0 + r : 0) * D + c * 8,
               live);
  }
}

// The 16 x 32 product of the A fragments `a` (KD k steps) and the [32][D]
// matrix at `bm` (row stride RS) read as B [n][k]: c[nt] n8 tile nt.
template <int KD>
__device__ __forceinline__ void mma_rows(float (&c)[4][4], const __nv_bfloat16* am, int am0,
                                         const __nv_bfloat16* bm, int lane) {
  constexpr int RS = 16 * KD + kRowPad;
#pragma unroll
  for (int x = 0; x < 4; ++x) c[x][0] = c[x][1] = c[x][2] = c[x][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    uint32_t a[4];
    ldsm_a(a, am, RS, am0, 16 * kd, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_b_nk(b, bm, RS, 16 * np, 16 * kd, lane);
      mma_bf16(c[2 * np], a, b);
      mma_bf16(c[2 * np + 1], a, b + 2);
    }
  }
}

// acc [16 x D] += w [16 x 32] (f32 in the accumulator layout, rounded to
// bf16 as A fragments) times the [32][D] matrix at `bm` read as B [k][n].
template <int KD>
__device__ __forceinline__ void mma_acc(float (&acc)[2 * KD][4], const float (&w)[4][4],
                                        const __nv_bfloat16* bm, int lane) {
  constexpr int RS = 16 * KD + kRowPad;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint32_t a[4] = {pack_bf16(w[2 * ks][0], w[2 * ks][1]),
                           pack_bf16(w[2 * ks][2], w[2 * ks][3]),
                           pack_bf16(w[2 * ks + 1][0], w[2 * ks + 1][1]),
                           pack_bf16(w[2 * ks + 1][2], w[2 * ks + 1][3])};
#pragma unroll
    for (int np = 0; np < KD; ++np) {
      uint32_t b[4];
      ldsm_b_kn(b, bm, RS, 16 * ks, 16 * np, lane);
      mma_bf16(acc[2 * np], a, b);
      mma_bf16(acc[2 * np + 1], a, b + 2);
    }
  }
}

// Rows row0 and row0 + 8 of a warp's [16 x D] accumulator, times `mul`, to
// the [rows, D] bf16 matrix at `dst`, rows below `limit`.
template <int KD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[2 * KD][4],
                                           int row0, int limit, float mul, int lane) {
  constexpr int D = 16 * KD;
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 2 * KD; ++nt) {
    if (row0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<int64_t>(row0) * D + 8 * nt + col) =
          __floats2bfloat162_rn(acc[nt][0] * mul, acc[nt][1] * mul);
    if (row0 + 8 < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<int64_t>(row0 + 8) * D + 8 * nt +
                                         col) =
          __floats2bfloat162_rn(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

template <int KD>
constexpr int dkdv_smem() {
  return (2 * kKvTile + 4 * kQStep) * (16 * KD + kRowPad) * 2 + 4 * kQStep * 4;
}

template <int KD>
constexpr int dq_smem() {
  return (2 * kQTile + 4 * kKStep) * (16 * KD + kRowPad) * 2;
}

// grid (ceil(Sk / 64), B * HKV)
template <int KD>
__global__ void __launch_bounds__(kMmaThreads)
    bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ delta, const float* __restrict__ lse2,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int h, int hkv,
                  int sq, int sk, float scale, float scale_log2, int causal) {
  constexpr int D = 16 * KD;
  constexpr int RS = D + kRowPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [kKvTile][RS]
  __nv_bfloat16* vs = ks + kKvTile * RS;                       // [kKvTile][RS]
  __nv_bfloat16* qs = vs + kKvTile * RS;                       // [2][kQStep][RS]
  __nv_bfloat16* dos = qs + 2 * kQStep * RS;                   // [2][kQStep][RS]
  float* ls = reinterpret_cast<float*>(dos + 2 * kQStep * RS); // [2][kQStep] base-2 lse
  float* dls = ls + 2 * kQStep;                                // [2][kQStep] Delta

  const int k0 = blockIdx.x * kKvTile;
  const int bn = blockIdx.y;  // b * hkv + n
  const int group = h / hkv;
  const int off = sk - sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_rows<D>(ks, k + static_cast<int64_t>(bn) * sk * D, k0, kKvTile, sk);
  stage_rows<D>(vs, v + static_cast<int64_t>(bn) * sk * D, k0, kKvTile, sk);
  cp_async_commit();

  // the q tiles whose rows may see a key of this tile: from row k0 - off on
  const int first = causal ? max(0, k0 - off) / kQStep : 0;
  const int steps = max(0, (sq + kQStep - 1) / kQStep - first);
  const int n_it = group * steps;
  const int64_t head0 = static_cast<int64_t>(bn / hkv) * h + (bn % hkv) * group;

  auto load = [&](int it, int buf) {
    const int64_t hq = head0 + it / steps;
    const int i0 = (first + it % steps) * kQStep;
    stage_rows<D>(qs + buf * kQStep * RS, q + hq * sq * D, i0, kQStep, sq);
    stage_rows<D>(dos + buf * kQStep * RS, dout + hq * sq * D, i0, kQStep, sq);
    const int t = threadIdx.x;
    if (t < 2 * kQStep) {
      const int r = t % kQStep;
      const bool live = i0 + r < sq;
      const float* src = (t < kQStep ? lse2 : delta) + hq * sq + (live ? i0 + r : 0);
      cp_async<4>((t < kQStep ? ls : dls) + buf * kQStep + r, src, live);
    }
  };

  float dka[2 * KD][4], dva[2 * KD][4];
#pragma unroll
  for (int x = 0; x < 2 * KD; ++x)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[x][c] = dva[x][c] = 0.f;

  if (n_it > 0) load(0, 0);
  cp_async_commit();
  const int key0 = k0 + 16 * warp + (lane >> 2);  // this thread's keys: key0, key0 + 8
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      load(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = (first + it % steps) * kQStep;
    const __nv_bfloat16* qt = qs + buf * kQStep * RS;
    const __nv_bfloat16* dt = dos + buf * kQStep * RS;
    const float* lt = ls + buf * kQStep;
    const float* delt = dls + buf * kQStep;

    float p[4][4];  // S^T, then P^T, then dS^T: [16 keys x 32 q rows]
    mma_rows<KD>(p, ks, 16 * warp, qt, lane);
    const bool mask = causal && k0 + 16 * warp + 15 > i0 + off;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = 8 * nt + 2 * (lane & 3) + (c & 1);
        const int key = key0 + (c >> 1) * 8;
        const float e = exp2f(p[nt][c] * scale_log2 - lt[qi]);
        p[nt][c] = mask && key > i0 + qi + off ? 0.f : e;
      }
    mma_acc<KD>(dva, p, dt, lane);  // dV += P^T dO
    float dp[4][4];                 // dP^T = V dO^T
    mma_rows<KD>(dp, vs, 16 * warp, dt, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[nt][c] *= dp[nt][c] - delt[8 * nt + 2 * (lane & 3) + (c & 1)];
    mma_acc<KD>(dka, p, qt, lane);  // dK += dS^T Q
    __syncthreads();  // this buffer is consumed before the next load refills it
  }
  store_rows<KD>(dk + static_cast<int64_t>(bn) * sk * D, dka, key0, sk, scale, lane);
  store_rows<KD>(dv + static_cast<int64_t>(bn) * sk * D, dva, key0, sk, 1.f, lane);
}

// grid (ceil(Sq / 64), B * H)
template <int KD>
__global__ void __launch_bounds__(kMmaThreads)
    bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ delta, const float* __restrict__ lse2,
                __nv_bfloat16* __restrict__ dq, int h, int hkv, int sq, int sk, float scale,
                float scale_log2, int causal) {
  constexpr int D = 16 * KD;
  constexpr int RS = D + kRowPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kQTile][RS]
  __nv_bfloat16* dos = qs + kQTile * RS;                       // [kQTile][RS]
  __nv_bfloat16* ks = dos + kQTile * RS;                       // [2][kKStep][RS]
  __nv_bfloat16* vs = ks + 2 * kKStep * RS;                    // [2][kKStep][RS]

  const int q0 = blockIdx.x * kQTile;
  const int bh = blockIdx.y;
  const int64_t kvh = static_cast<int64_t>(bh / h) * hkv + (bh % h) / (h / hkv);
  const int off = sk - sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const __nv_bfloat16* kb = k + kvh * sk * D;
  const __nv_bfloat16* vb = v + kvh * sk * D;
  stage_rows<D>(qs, q + static_cast<int64_t>(bh) * sq * D, q0, kQTile, sq);
  stage_rows<D>(dos, dout + static_cast<int64_t>(bh) * sq * D, q0, kQTile, sq);
  cp_async_commit();

  // k tiles up to the causal diagonal of the tile's last real row
  int last_key = sk - 1;
  if (causal) last_key = min(last_key, min(q0 + kQTile, sq) - 1 + off);
  const int n_t = last_key < 0 ? 0 : last_key / kKStep + 1;
  auto load = [&](int t, int buf) {
    stage_rows<D>(ks + buf * kKStep * RS, kb, t * kKStep, kKStep, sk);
    stage_rows<D>(vs + buf * kKStep * RS, vb, t * kKStep, kKStep, sk);
  };
  if (n_t > 0) load(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qa[KD][4], da[KD][4];  // this warp's 16 rows of Q and dO as A fragments
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    ldsm_a(qa[kd], qs, RS, 16 * warp, 16 * kd, lane);
    ldsm_a(da[kd], dos, RS, 16 * warp, 16 * kd, lane);
  }
  const int r0 = q0 + 16 * warp + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int64_t rb = static_cast<int64_t>(bh) * sq;
  float lr[2], dr[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + 8 * j;
    lr[j] = r < sq ? lse2[rb + r] : CUDART_INF_F;
    dr[j] = r < sq ? delta[rb + r] : 0.f;
  }
  float dqa[2 * KD][4];
#pragma unroll
  for (int x = 0; x < 2 * KD; ++x) dqa[x][0] = dqa[x][1] = dqa[x][2] = dqa[x][3] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_t) {
      load(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = t * kKStep;
    const __nv_bfloat16* kt = ks + buf * kKStep * RS;
    const __nv_bfloat16* vt = vs + buf * kKStep * RS;

    float p[4][4], dp[4][4];  // S then P then dS; dP: [16 rows x 32 keys]
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[x][c] = dp[x][c] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_b_nk(b, kt, RS, 16 * np, 16 * kd, lane);
        mma_bf16(p[2 * np], qa[kd], b);
        mma_bf16(p[2 * np + 1], qa[kd], b + 2);
        ldsm_b_nk(b, vt, RS, 16 * np, 16 * kd, lane);
        mma_bf16(dp[2 * np], da[kd], b);
        mma_bf16(dp[2 * np + 1], da[kd], b + 2);
      }
    // keys past Sk are masked too: their zero K row would give exp2(-lse2),
    // which overflows where every real logit is far below 0
    const bool mask = (causal && j0 + kKStep - 1 > q0 + 16 * warp + off) || j0 + kKStep > sk;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = j0 + 8 * nt + 2 * (lane & 3) + (c & 1);
        const int j = c >> 1;
        const float e = exp2f(p[nt][c] * scale_log2 - lr[j]);
        const float pv =
            mask && (key >= sk || (causal && key > r0 + 8 * j + off)) ? 0.f : e;
        p[nt][c] = pv * (dp[nt][c] - dr[j]);
      }
    mma_acc<KD>(dqa, p, kt, lane);  // dQ += dS K
    __syncthreads();
  }
  store_rows<KD>(dq + static_cast<int64_t>(bh) * sq * D, dqa, r0, sq, scale, lane);
}

template <int KD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* delta, const float* lse2, void* dq, void* dk, void* dv,
                        int b, int h, int hkv, int sq, int sk, float scale, int causal,
                        cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const float sl2 = scale * kLog2e;
  if (sk > 0) {
    auto kern = bwd_dkdv_bf16<KD>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           dkdv_smem<KD>());
    if (err != cudaSuccess) return err;
    dim3 grid((sk + kKvTile - 1) / kKvTile, b * hkv);
    kern<<<grid, kMmaThreads, dkdv_smem<KD>(), stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), delta, lse2, static_cast<bf*>(dk), static_cast<bf*>(dv),
        h, hkv, sq, sk, scale, sl2, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (sq > 0) {
    auto kern = bwd_dq_bf16<KD>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           dq_smem<KD>());
    if (err != cudaSuccess) return err;
    dim3 grid((sq + kQTile - 1) / kQTile, b * h);
    kern<<<grid, kMmaThreads, dq_smem<KD>(), stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), delta, lse2, static_cast<bf*>(dq), h, hkv, sq, sk,
        scale, sl2, causal);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------

int f32_dkdv_smem(int d) {
  return 4 * (4 * kBlock * (d + 1) + 2 * kBlock * (kBlock + 1) + 2 * kBlock);
}

int f32_dq_smem(int d) { return 4 * (4 * kBlock * (d + 1) + kBlock * (kBlock + 1)); }

// rows [r0, r0 + 64) of the [rows, d] f32 matrix at `src` into `dst` (row
// stride d + 1), zero from row `limit` on.
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int r0, int limit,
                                          int d) {
  for (int e = threadIdx.x; e < kBlock * d; e += blockDim.x) {
    const int r = e / d, c = e % d;
    dst[r * (d + 1) + c] = r0 + r < limit ? src[static_cast<int64_t>(r0 + r) * d + c] : 0.f;
  }
}

// NJ: output columns a thread owns, ceil(D / 16) rounded up to a power of 2.
// grid (ceil(Sk / 64), B * HKV); a thread owns keys ty + 16 a and q rows (or
// columns) tx + 16 b.
template <int NJ>
__global__ void __launch_bounds__(kF32Threads)
    bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ delta, const float* __restrict__ lse2,
                 float* __restrict__ dk, float* __restrict__ dv, int h, int hkv, int sq, int sk,
                 int d, float scale, float scale_log2, int causal) {
  extern __shared__ float fsm[];
  const int dp = d + 1;
  float* ks = fsm;                       // [64][d + 1]
  float* vs = ks + kBlock * dp;          // [64][d + 1]
  float* qs = vs + kBlock * dp;          // [64][d + 1]
  float* dos = qs + kBlock * dp;         // [64][d + 1]
  float* ps = dos + kBlock * dp;         // P^T [64 keys][65]
  float* dss = ps + kBlock * (kBlock + 1);  // dS^T [64 keys][65]
  float* ls = dss + kBlock * (kBlock + 1);  // [64] base-2 lse
  float* dls = ls + kBlock;                 // [64] Delta

  const int k0 = blockIdx.x * kBlock;
  const int bn = blockIdx.y;
  const int group = h / hkv;
  const int off = sk - sq;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  stage_f32(ks, k + static_cast<int64_t>(bn) * sk * d, k0, sk, d);
  stage_f32(vs, v + static_cast<int64_t>(bn) * sk * d, k0, sk, d);
  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[a][j] = dva[a][j] = 0.f;

  const int first = causal ? max(0, k0 - off) / kBlock : 0;
  const int n_qt = (sq + kBlock - 1) / kBlock;
  const int64_t head0 = static_cast<int64_t>(bn / hkv) * h + (bn % hkv) * group;
  for (int g = 0; g < group; ++g) {
    const int64_t hq = head0 + g;
    for (int st = first; st < n_qt; ++st) {
      const int i0 = st * kBlock;
      __syncthreads();  // the previous tile is consumed
      stage_f32(qs, q + hq * sq * d, i0, sq, d);
      stage_f32(dos, dout + hq * sq * d, i0, sq, d);
      if (tid < kBlock) {
        const bool live = i0 + tid < sq;
        ls[tid] = live ? lse2[hq * sq + i0 + tid] : CUDART_INF_F;
        dls[tid] = live ? delta[hq * sq + i0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dpv[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = dpv[a][c] = 0.f;
      for (int c = 0; c < d; ++c) {
        float ka[4], va[4], qb[4], ob[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ka[a] = ks[(ty + 16 * a) * dp + c];
          va[a] = vs[(ty + 16 * a) * dp + c];
          qb[a] = qs[(tx + 16 * a) * dp + c];
          ob[a] = dos[(tx + 16 * a) * dp + c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            s[a][bb] = fmaf(ka[a], qb[bb], s[a][bb]);
            dpv[a][bb] = fmaf(va[a], ob[bb], dpv[a][bb]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int key = k0 + ty + 16 * a, qi = tx + 16 * bb;
          float p = exp2f(s[a][bb] * scale_log2 - ls[qi]);
          if (causal && key > i0 + qi + off) p = 0.f;
          ps[(ty + 16 * a) * (kBlock + 1) + qi] = p;
          dss[(ty + 16 * a) * (kBlock + 1) + qi] = p * (dpv[a][bb] - dls[qi]);
        }
      __syncthreads();
      for (int i = 0; i < kBlock; ++i) {
        float pa[4], sa[4], ov[NJ], qv[NJ];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = ps[(ty + 16 * a) * (kBlock + 1) + i];
          sa[a] = dss[(ty + 16 * a) * (kBlock + 1) + i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          ov[j] = col < d ? dos[i * dp + col] : 0.f;
          qv[j] = col < d ? qs[i * dp + col] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dva[a][j] = fmaf(pa[a], ov[j], dva[a][j]);
            dka[a][j] = fmaf(sa[a], qv[j], dka[a][j]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= sk) continue;
    const int64_t row = (static_cast<int64_t>(bn) * sk + key) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        dk[row + col] = dka[a][j] * scale;
        dv[row + col] = dva[a][j];
      }
    }
  }
}

// grid (ceil(Sq / 64), B * H); a thread owns rows ty + 16 a and keys (or
// columns) tx + 16 b.
template <int NJ>
__global__ void __launch_bounds__(kF32Threads)
    bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ delta, const float* __restrict__ lse2,
               float* __restrict__ dq, int h, int hkv, int sq, int sk, int d, float scale,
               float scale_log2, int causal) {
  extern __shared__ float fsm[];
  const int dp = d + 1;
  float* qs = fsm;                   // [64][d + 1]
  float* dos = qs + kBlock * dp;     // [64][d + 1]
  float* ks = dos + kBlock * dp;     // [64][d + 1]
  float* vs = ks + kBlock * dp;      // [64][d + 1]
  float* dss = vs + kBlock * dp;     // dS [64 rows][65]

  const int q0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int64_t kvh = static_cast<int64_t>(bh / h) * hkv + (bh % h) / (h / hkv);
  const int off = sk - sq;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t rb = static_cast<int64_t>(bh) * sq;
  stage_f32(qs, q + rb * d, q0, sq, d);
  stage_f32(dos, dout + rb * d, q0, sq, d);
  float lr[4], dr[4], dqa[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    lr[a] = r < sq ? lse2[rb + r] : CUDART_INF_F;
    dr[a] = r < sq ? delta[rb + r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqa[a][j] = 0.f;
  }
  int last_key = sk - 1;
  if (causal) last_key = min(last_key, min(q0 + kBlock, sq) - 1 + off);
  const int n_t = last_key < 0 ? 0 : last_key / kBlock + 1;
  for (int t = 0; t < n_t; ++t) {
    const int j0 = t * kBlock;
    __syncthreads();  // the previous tile is consumed
    stage_f32(ks, k + kvh * sk * d, j0, sk, d);
    stage_f32(vs, v + kvh * sk * d, j0, sk, d);
    __syncthreads();
    float s[4][4], dpv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dpv[a][c] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = qs[(ty + 16 * a) * dp + c];
        oa[a] = dos[(ty + 16 * a) * dp + c];
        kb[a] = ks[(tx + 16 * a) * dp + c];
        vb[a] = vs[(tx + 16 * a) * dp + c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          s[a][bb] = fmaf(qa[a], kb[bb], s[a][bb]);
          dpv[a][bb] = fmaf(oa[a], vb[bb], dpv[a][bb]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int row = q0 + ty + 16 * a, key = j0 + tx + 16 * bb;
        float p = exp2f(s[a][bb] * scale_log2 - lr[a]);
        if (key >= sk || (causal && key > row + off)) p = 0.f;
        dss[(ty + 16 * a) * (kBlock + 1) + tx + 16 * bb] = p * (dpv[a][bb] - dr[a]);
      }
    __syncthreads();
    for (int j = 0; j < kBlock; ++j) {
      float sa[4], kv[NJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dss[(ty + 16 * a) * (kBlock + 1) + j];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = tx + 16 * jj;
        kv[jj] = col < d ? ks[j * dp + col] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) dqa[a][jj] = fmaf(sa[a], kv[jj], dqa[a][jj]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) dq[(rb + r) * d + col] = dqa[a][j] * scale;
    }
  }
}

template <int NJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* delta, const float* lse2, void* dq, void* dk, void* dv,
                       int b, int h, int hkv, int sq, int sk, int d, float scale, int causal,
                       cudaStream_t stream) {
  const float sl2 = scale * kLog2e;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  if (sk > 0) {
    auto kern = bwd_dkdv_f32<NJ>;
    const int smem = f32_dkdv_smem(d);
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((sk + kBlock - 1) / kBlock, b * hkv);
    kern<<<grid, kF32Threads, smem, stream>>>(qf, kf, vf, of, delta, lse2,
                                              static_cast<float*>(dk), static_cast<float*>(dv),
                                              h, hkv, sq, sk, d, scale, sl2, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (sq > 0) {
    auto kern = bwd_dq_f32<NJ>;
    const int smem = f32_dq_smem(d);
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((sq + kBlock - 1) / kBlock, b * h);
    kern<<<grid, kF32Threads, smem, stream>>>(qf, kf, vf, of, delta, lse2,
                                              static_cast<float*>(dq), h, hkv, sq, sk, d,
                                              scale, sl2, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q, o, dout
// [b, h, sq, d]; k, v [b, hkv, sk, d]; lse [b, h, sq] f32 (the forward's,
// natural log); dq like q, dk and dv like k; delta and lse2 [b, h, sq] f32
// scratch; all contiguous, 16-byte aligned.  d is 64, 80, 96 or 128; h is a
// multiple of hkv.  Returns 0 or a cudaError_t.
extern "C" int dex_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       void* dq, void* dk, void* dv, float* delta, float* lse2,
                                       int dtype, int b, int h, int hkv, int sq, int sk, int d,
                                       float scale, int causal, void* stream) {
  if (d != 64 && d != 80 && d != 96 && d != 128) return cudaErrorInvalidValue;
  if (hkv <= 0 || h % hkv) return cudaErrorInvalidValue;
  if (b == 0 || h == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = static_cast<int64_t>(b) * h * sq;
  if (rows > 0) {
    const unsigned blocks = static_cast<unsigned>((rows * 8 + 255) / 256);
    if (dtype == 0)
      bwd_prepass<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(o),
                                                static_cast<const float*>(dout), lse, delta,
                                                lse2, rows, d);
    else
      bwd_prepass<__nv_bfloat16><<<blocks, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse,
          delta, lse2, rows, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dtype == 0)
    return d == 64 ? launch_f32<4>(q, k, v, dout, delta, lse2, dq, dk, dv, b, h, hkv, sq, sk, d,
                                   scale, causal, s)
                   : launch_f32<8>(q, k, v, dout, delta, lse2, dq, dk, dv, b, h, hkv, sq, sk, d,
                                   scale, causal, s);
  switch (d) {
    case 64:
      return launch_bf16<4>(q, k, v, dout, delta, lse2, dq, dk, dv, b, h, hkv, sq, sk, scale,
                            causal, s);
    case 80:
      return launch_bf16<5>(q, k, v, dout, delta, lse2, dq, dk, dv, b, h, hkv, sq, sk, scale,
                            causal, s);
    case 96:
      return launch_bf16<6>(q, k, v, dout, delta, lse2, dq, dk, dv, b, h, hkv, sq, sk, scale,
                            causal, s);
    default:
      return launch_bf16<8>(q, k, v, dout, delta, lse2, dq, dk, dv, b, h, hkv, sq, sk, scale,
                            causal, s);
  }
}
