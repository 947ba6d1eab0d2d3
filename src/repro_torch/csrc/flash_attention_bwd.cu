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
// card's dense bf16 tensor-core rate, far above its bytes.  The design
// below executes 14 * D a pair: the dQ pass recomputes S and dP (4 D), so
// that no output is summed across CTAs.
//
// Three launches, none with atomics, so that every output element is summed
// by one warpgroup in a fixed order and two runs are bit-equal (the remat
// recompute of a block relies on it):
//  1. a pre-pass, 8 lanes a row: Delta = rowsum(dO * O) and the base-2
//     log-sum-exp lse * log2(e) (+inf where lse = -inf: a row no key
//     reaches then gets P = 0) into the caller's f32 scratch [B, H, Sq];
//  2. dK / dV (bwd_dkdv_wgmma): a persistent CTA of three warpgroups, one
//     an SM, walks (128-key tile, batch * kv head) items in a zigzag over
//     the CTAs, causal items longest first (the first keys, which every
//     later row sees).  Warpgroup 2 is the producer: it gives its registers
//     to the consumers (setmaxnreg 24 / 240), TMA-loads the item's K and V
//     once, into one of two buffers (full and empty mbarriers), so that the
//     next item's tiles load under this one's last products and epilogue, then
//     streams the Q and dO tiles of 64 rows of the group's G query heads,
//     from row k0 - (Sk - Sq) on where causal, into a ring of kStages slots
//     with full and empty mbarriers; its first warp also writes each tile's
//     64 base-2 lse and Delta values into the slot (+inf and 0 past Sq, so
//     rows past Sq get P = 0), and every lane arrives on the slot's full
//     barrier.  Warpgroups 0 and 1 each own 64 keys (wgmma's M).  For a tile
//     each starts S^T = K Q^T and dP^T = V dO^T (wgmma SS, f32
//     accumulators, K-major operands) as two groups; with S^T in, it forms
//     P^T = exp2(S^T scale log2(e) - lse2), masked only on tiles that cross
//     the diagonal, while dP^T finishes; then dS^T = P^T (dP^T - Delta);
//     both are rounded to bf16 pairs in registers and feed dV += P^T dO and
//     dK += dS^T Q (wgmma RS: the accumulator's layout is the A fragment's;
//     dO and Q read MN-major through the descriptor's transpose bit).  At a
//     padded D of 64 a tile's dV and dK start behind the next tile's S^T and
//     dP^T, so P^T and dS^T are formed under them; at 128 that would hold
//     224 registers (the 128 accumulators, S^T, dP^T and both packed tiles)
//     and ptxas serialises the products, so a tile's dV and dK run before
//     the next starts.  The two warpgroups take turns to start their
//     products (named barriers), so one's exponentials run under the
//     other's products.  The epilogue writes dK * scale and dV in bf16 from
//     the accumulators;
//  3. dQ (bwd_dq_wgmma): the same skeleton over (128-row q tile, batch *
//     head) items, causal q tiles longest first: the producer streams K and
//     V tiles of 64 keys up to the causal diagonal into the ring and loads
//     the item's Q and dO once (two buffers); each consumer warpgroup owns
//     64 rows, starts S = Q K^T and dP = dO V^T (SS) behind the previous
//     tile's dQ += dS K (RS, K read MN-major), and forms P and dS in
//     registers while they run (keys past Sk masked too: their zero K row
//     would give exp2(-lse2), which overflows where every real logit is far
//     below 0).
// Each product's depth runs over the true D in steps of 16 (D = 80 and 96
// take 5 and 6), the padded columns of the shared tiles being zeros from
// the tensor maps' fill; dV, dK and dQ run at a width of D padded to a
// multiple of 64 (a TMA box is 64 columns), so at D = 80 37.5% and at D =
// 96 25% of those three products' columns are padding: 20.5% and 12.5% of
// the executed work.  No copy is made.  Zero-filled rows past Sq or Sk add
// nothing; their outputs are not written.
//
// float32 runs on CUDA cores (64 x 64 tiles, a 4 x 4 block of pairs a
// thread, fmaf): on tensor cores it would be TF32, which the float32 gates
// refuse.  Head dims 64, 80, 96 and 128; causal with offset Sk - Sq or not;
// any G, Sq and Sk.  The plan (kernels/flash_attention.py::plan_bwd) must
// name a kernel built here (dex_flash_attention_bwd_plan checks it).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlock = 64;                // the f32 kernels' tile rows
constexpr int kF32Threads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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
// bfloat16 on tensor cores (wgmma fed by TMA)
// ---------------------------------------------------------------------------

constexpr int kTile = 128;       // keys of a dK / dV item, q rows of a dQ item
constexpr int kStep = 64;        // q rows (dK / dV) or keys (dQ) of a ring slot
constexpr int kStages = 3;       // ring slots
constexpr int kHold = 2;         // buffers of an item's held tiles (K and V; Q and dO)
constexpr int kPipelinedMaxD = 64;  // the widest padded D whose dK / dV loop is pipelined
constexpr int kConsumers = 2;    // consumer warpgroups, 64 rows each (wgmma's M)
constexpr int kWgThreads = 128;
constexpr int kThreadsWg = kWgThreads * (kConsumers + 1);
constexpr int kBox = tma::kBoxCols;
constexpr int kSmemSlack = 1024 + 128;  // 1024-byte alignment, barriers

// D padded to a multiple of 64 (the width of a TMA box)
template <int D>
__host__ __device__ constexpr int padded() {
  return (D + kBox - 1) / kBox * kBox;
}

template <int DP>
struct BwdTiles {
  static constexpr int kBig = kTile * DP * 2;    // bytes of a 128-row tile
  static constexpr int kSmall = kStep * DP * 2;  // bytes of a 64-row tile
  // dK / dV: kHold buffers of K and V; a slot holds Q and dO, and 64 lse2
  // and Delta values
  static constexpr int kDkdv =
      kHold * 2 * kBig + kStages * (2 * kSmall + 2 * kStep * 4) + kSmemSlack;
  // dQ: kHold buffers of Q and dO; a slot holds K and V
  static constexpr int kDq = kHold * 2 * kBig + kStages * 2 * kSmall + kSmemSlack;
  static_assert(kDkdv <= 232448 && kDq <= 232448, "shared memory");
};

// acc = A B^T over the true depth D, one wgmma a 16-column step: A the 64 rows
// at `a` (K-major, 64-column blocks of AR rows), B the 64 rows at `b`
// (K-major, blocks of BR rows).
template <int D, int AR, int BR>
__device__ __forceinline__ void mma_abt(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, k4 = kk % 4;
    hopper::wgmma_ss_n64(acc, hopper::desc_sw128(a + c * AR * 128 + k4 * 32, 16, 1024),
                         hopper::desc_sw128(b + c * BR * 128 + k4 * 32, 16, 1024), kk > 0);
  }
}

// acc [64 x DP] += A [64 x 64] (registers: 4 k16 slices of bf16 pairs) x the
// 64-row tile at `b` read MN-major (64-column blocks of 64 rows).
template <int DP>
__device__ __forceinline__ void mma_acc(float (&acc)[DP / 2], const uint32_t (&a)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = hopper::desc_sw128(b + kk * 16 * 128, kStep * 128, 1024);
    if constexpr (DP == 128)
      hopper::wgmma_rs_n128(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], db);
    else
      hopper::wgmma_rs_n64(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One consumer warp's arrival on an empty barrier: all its lanes are past
// their reads.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// A warpgroup's [64 x DP] accumulator times `mul` to rows row0 + r0 and
// row0 + r0 + 8 of the [rows, d] bf16 matrix at `dst`, rows below `limit`,
// columns below d.
template <int DP>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, const float (&acc)[DP / 2], int r,
                                          int limit, int d, int c_lane, float mul) {
#pragma unroll
  for (int x = 0; x < DP / 8; ++x) {
    const int col = 8 * x + c_lane;
    if (col >= d) continue;
    if (r < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<int64_t>(r) * d + col) =
          __floats2bfloat162_rn(acc[4 * x] * mul, acc[4 * x + 1] * mul);
    if (r + 8 < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<int64_t>(r + 8) * d + col) =
          __floats2bfloat162_rn(acc[4 * x + 2] * mul, acc[4 * x + 3] * mul);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Ping-pong: the consumer warpgroups take turns to start their products
// (named barriers 1 and 2), so that one's exponentials run under the
// other's products; warpgroup 0 goes first (warpgroup 1 arrives once
// before its first turn, warpgroup 0 waits once after its last).
__device__ __forceinline__ void turn_begin(int wg) {
  hopper::named_sync(1 + wg, 2 * kWgThreads);
}
__device__ __forceinline__ void turn_end(int wg) { hopper::named_arrive(2 - wg, 2 * kWgThreads); }

// f as bf16 pairs, the A fragments of an RS product (the accumulator's
// layout is the A fragment's).
__device__ __forceinline__ void pack(uint32_t (&a)[16], const float (&f)[32]) {
#pragma unroll
  for (int y = 0; y < 16; ++y) a[y] = pack_bf16(f[2 * y], f[2 * y + 1]);
}

// dK / dV: P^T of a tile in place, from S^T (keys are rows, the tile's q
// rows columns): exp2(S^T scale log2(e) - lse2 of the column); `first[x]`
// is the first q row that sees this thread's key of row x (causal, on a
// tile that crosses the diagonal), `q` the column c_lane's q row.
__device__ __forceinline__ void probs_t(float (&st)[32], const float* ls, int c_lane, bool mask,
                                        const int (&first)[2], int q, float scale_log2) {
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * x + c_lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = hopper::ex2(fmaf(st[4 * x + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
      if (mask && q + 8 * x + (e & 1) < first[e >> 1]) p = 0.f;
      st[4 * x + e] = p;
    }
  }
}

// dK / dV: dS^T = P^T (dP^T - Delta of the column), in place.
__device__ __forceinline__ void dsoft_t(float (&dpt)[32], const float (&st)[32], const float* dl,
                                        int c_lane) {
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const float2 de = *reinterpret_cast<const float2*>(dl + 8 * x + c_lane);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * x + e] = st[4 * x + e] * (dpt[4 * x + e] - ((e & 1) ? de.y : de.x));
  }
}

// dQ: P of a tile in place, from S (q rows are rows, keys columns); `last[x]`
// is the last key this thread's row x may see (on a tile that crosses the
// diagonal or Sk), `key` the column c_lane's key.
__device__ __forceinline__ void probs_r(float (&sc)[32], const float (&l2)[2], bool mask,
                                        const int (&last)[2], int key, float scale_log2) {
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = hopper::ex2(fmaf(sc[4 * x + e], scale_log2, -l2[e >> 1]));
      if (mask && key + 8 * x + (e & 1) > last[e >> 1]) p = 0.f;
      sc[4 * x + e] = p;
    }
}

// dQ: dS = P (dP - Delta of the row), in place.
__device__ __forceinline__ void dsoft_r(float (&dp)[32], const float (&sc)[32],
                                        const float (&de)[2]) {
#pragma unroll
  for (int x = 0; x < 32; ++x) dp[x] = sc[x] * (dp[x] - de[(x >> 1) & 1]);
}

// Round r of CTA c takes item r * G + c, or r * G + G - 1 - c in odd rounds
// (G CTAs): a zigzag that pairs long items with short ones.  -1 when done.
__device__ __forceinline__ int next_item(int r, int n_items) {
  const int g = gridDim.x, c = blockIdx.x;
  const int i = r * g + ((r & 1) ? g - 1 - c : c);
  return i < n_items ? i : -1;
}

// A dK / dV item: keys [k0, k0 + 128) of kv head bn (batch * HKV); the q
// tiles from `first` on (n_q of them) of each of the group's query heads,
// head0 the first.  Key tiles ascending, kv heads fastest.
struct KvItem {
  int k0, bn, first, n_q;
  int64_t head0;
};

__device__ __forceinline__ KvItem kv_item(int i, int bkv, int h, int hkv, int sq, int sk,
                                          int causal) {
  KvItem it;
  it.k0 = (i / bkv) * kTile;
  it.bn = i % bkv;
  it.first = causal ? max(0, it.k0 - (sk - sq)) / kStep : 0;
  it.n_q = max(0, (sq + kStep - 1) / kStep - it.first);
  it.head0 = static_cast<int64_t>(it.bn / hkv) * h + (it.bn % hkv) * (h / hkv);
  return it;
}

// A dQ item: q rows [q0, q0 + 128) of head bh (batch * H) and its kv head;
// n_t key tiles up to the causal diagonal of its last row.  Causal q tiles
// longest first, heads fastest.
struct QItem {
  int q0, bh, kvh, n_t;
};

__device__ __forceinline__ QItem q_item(int i, int bh_total, int h, int hkv, int sq, int sk,
                                        int causal, int n_qt) {
  QItem it;
  const int rank = i / bh_total;
  it.bh = i % bh_total;
  it.q0 = (causal ? n_qt - 1 - rank : rank) * kTile;
  it.kvh = (it.bh / h) * hkv + (it.bh % h) / (h / hkv);
  int last_key = sk - 1;
  if (causal) last_key = min(last_key, min(it.q0 + kTile, sq) - 1 + sk - sq);
  it.n_t = last_key < 0 ? 0 : last_key / kStep + 1;
  return it;
}

// Maps: q, dout [B*H, Sq, d] in boxes of 64 rows; k, v [B*HKV, Sk, d] in
// boxes of 128 rows.  Persistent: G CTAs walk the n_kt * B * HKV items.
template <int D>
__global__ void __launch_bounds__(kThreadsWg, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse2,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int bkv, int h, int hkv, int sq, int sk,
                   float scale, float scale_log2, int causal, int n_items) {
  constexpr int DP = padded<D>();
  using T = BwdTiles<DP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_kv = base;                           // buffer b: K, then V
  const uint32_t s_ring = s_kv + kHold * 2 * T::kBig;   // slot s: Q, then dO
  const uint32_t s_lse = s_ring + kStages * 2 * T::kSmall;  // [kStages][64] lse2, then Delta
  const uint32_t bar_kv = s_lse + kStages * 2 * kStep * 4;  // full: buffer b's K and V arrived
  const uint32_t bar_kve = bar_kv + 8 * kHold;           // empty: buffer b consumed
  const uint32_t bar_full = bar_kve + 8 * kHold;         // slot s at + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;
  float* lse_sm = reinterpret_cast<float*>(smem_raw + (s_lse - raw));
  const int group = h / hkv;
  const int off = sk - sq;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int b = 0; b < kHold; ++b) {
      hopper::mbar_init(bar_kv + 8 * b, 1);
      hopper::mbar_init(bar_kve + 8 * b, kConsumers * 4);  // one arrival a consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 32);   // the producer warp's lanes
      hopper::mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / kWgThreads;
  if (wg == kConsumers) {
    // producer: its first warp keeps the ring full; `kvi` counts the items
    // loaded, `qg` the q tiles (the ring's position)
    hopper::setmaxnreg_dec<24>();
    if (tid / 32 == kConsumers * 4) {
      const int lane = tid % 32;
      int kvi = 0, qg = 0;
      for (int r = 0, i; (i = next_item(r, n_items)) >= 0; ++r) {
        const KvItem it = kv_item(i, bkv, h, hkv, sq, sk, causal);
        if (it.n_q == 0) continue;
        if (lane == 0) {
          const int b = kvi % kHold;
          const uint32_t kv = s_kv + b * 2 * T::kBig;
          hopper::mbar_wait(bar_kve + 8 * b, ((kvi / kHold) & 1) ^ 1);
          hopper::mbar_expect_tx(bar_kv + 8 * b, 2 * T::kBig);
#pragma unroll
          for (int c = 0; c < DP / kBox; ++c) {
            hopper::tma_load_3d(kv + c * kTile * 128, &tm_k, bar_kv + 8 * b, c * kBox, it.k0,
                                it.bn);
            hopper::tma_load_3d(kv + T::kBig + c * kTile * 128, &tm_v, bar_kv + 8 * b, c * kBox,
                                it.k0, it.bn);
          }
        }
        ++kvi;
        for (int j = 0; j < group * it.n_q; ++j, ++qg) {
          const int s = qg % kStages;
          const int64_t hq = it.head0 + j / it.n_q;
          const int i0 = (it.first + j % it.n_q) * kStep;
          hopper::mbar_wait(bar_empty + 8 * s, ((qg / kStages) & 1) ^ 1);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int row = i0 + lane + 32 * x;
            const bool live = row < sq;
            lse_sm[s * kStep + lane + 32 * x] = live ? lse2[hq * sq + row] : CUDART_INF_F;
            lse_sm[(kStages + s) * kStep + lane + 32 * x] = live ? delta[hq * sq + row] : 0.f;
          }
          const uint32_t slot = s_ring + s * 2 * T::kSmall;
          if (lane == 0) {  // lane 0's arrival carries the tiles' bytes
            hopper::mbar_expect_tx(bar_full + 8 * s, 2 * T::kSmall);
#pragma unroll
            for (int c = 0; c < DP / kBox; ++c) {
              hopper::tma_load_3d(slot + c * kStep * 128, &tm_q, bar_full + 8 * s, c * kBox, i0,
                                  static_cast<int>(hq));
              hopper::tma_load_3d(slot + T::kSmall + c * kStep * 128, &tm_do, bar_full + 8 * s,
                                  c * kBox, i0, static_cast<int>(hq));
            }
          } else {
            hopper::mbar_arrive(bar_full + 8 * s);
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    if (wg == 1) hopper::named_arrive(1, 2 * kWgThreads);  // warpgroup 0 goes first
    const int wt = tid % kWgThreads;
    const int lane = wt % 32;
    const int r0 = 16 * (wt / 32) + lane / 4;  // this thread's keys in the warpgroup: r0, r0 + 8
    const int c_lane = 2 * (lane % 4);         // its first q column in each 8
    int kvi = 0, qg = 0;
    for (int r = 0, i; (i = next_item(r, n_items)) >= 0; ++r) {
      const KvItem it = kv_item(i, bkv, h, hkv, sq, sk, causal);
      const int kw0 = it.k0 + wg * 64;  // the warpgroup's first key
      float dka[DP / 2], dva[DP / 2];
      zero(dka);
      zero(dva);
      if (it.n_q > 0) {
        const int b = kvi % kHold;
        const uint32_t k_wg = s_kv + b * 2 * T::kBig + wg * 64 * 128;
        const uint32_t v_wg = k_wg + T::kBig;
        hopper::mbar_wait(bar_kv + 8 * b, (kvi / kHold) & 1);
        const int n_it = group * it.n_q;
        int first[2];  // the first q row that sees this thread's keys
#pragma unroll
        for (int x = 0; x < 2; ++x) first[x] = kw0 + r0 + 8 * x - off;
        if constexpr (DP <= kPipelinedMaxD) {
          // Tile j starts S^T_j and dP^T_j and, behind them, dV += P^T_{j-1}
          // dO_{j-1} and dK += dS^T_{j-1} Q_{j-1}; P^T_j and dS^T_j are formed
          // while those run.  Tile 0's products are peeled off the loop: with
          // a commit that only some iterations make, ptxas cannot tell which
          // group a wait retires and serialises every wgmma (C7514).
          float st[32], dpt[32];    // S^T then P^T; dP^T then dS^T: [64 keys x 64 q rows]
          uint32_t pa[16], da[16];  // the previous tile's P^T and dS^T in bf16 pairs
          {
            const int s = qg % kStages;
            const int i0 = it.first * kStep;
            const uint32_t slot = s_ring + s * 2 * T::kSmall;
            hopper::mbar_wait(bar_full + 8 * s, (qg / kStages) & 1);
            turn_begin(wg);
            hopper::wgmma_fence();
            mma_abt<D, kTile, kStep>(st, k_wg, slot);
            hopper::wgmma_commit();
            mma_abt<D, kTile, kStep>(dpt, v_wg, slot + T::kSmall);
            hopper::wgmma_commit();
            turn_end(wg);
            hopper::wgmma_wait<1>();
            hopper::fence_regs(st);
            probs_t(st, lse_sm + s * kStep, c_lane, causal && kw0 + 63 > i0 + off, first,
                    i0 + c_lane, scale_log2);
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dpt);
            if (n_it == 1) release(bar_kve + 8 * b, lane);  // the item's K and V are read
            dsoft_t(dpt, st, lse_sm + (kStages + s) * kStep, c_lane);
            pack(pa, st);
            pack(da, dpt);
          }
          for (int j = 1; j < n_it; ++j) {
            const int sp = qg % kStages;  // tile j - 1's slot
            const uint32_t prev = s_ring + sp * 2 * T::kSmall;
            ++qg;
            const int s = qg % kStages;
            const int i0 = (it.first + j % it.n_q) * kStep;
            const uint32_t slot = s_ring + s * 2 * T::kSmall;
            hopper::mbar_wait(bar_full + 8 * s, (qg / kStages) & 1);
            hopper::fence_regs(pa);
            hopper::fence_regs(da);
            hopper::fence_regs(dva);
            hopper::fence_regs(dka);
            turn_begin(wg);
            hopper::wgmma_fence();  // P^T and dS^T are written before wgmma reads them
            mma_abt<D, kTile, kStep>(st, k_wg, slot);
            hopper::wgmma_commit();
            mma_abt<D, kTile, kStep>(dpt, v_wg, slot + T::kSmall);
            hopper::wgmma_commit();
            mma_acc<DP>(dva, pa, prev + T::kSmall);
            mma_acc<DP>(dka, da, prev);
            hopper::wgmma_commit();
            turn_end(wg);
            hopper::wgmma_wait<2>();  // S^T_j is in
            hopper::fence_regs(st);
            probs_t(st, lse_sm + s * kStep, c_lane, causal && kw0 + 63 > i0 + off, first,
                    i0 + c_lane, scale_log2);
            hopper::wgmma_wait<1>();  // dP^T_j is in
            hopper::fence_regs(dpt);
            if (j == n_it - 1) release(bar_kve + 8 * b, lane);
            dsoft_t(dpt, st, lse_sm + (kStages + s) * kStep, c_lane);
            hopper::wgmma_wait<0>();  // tile j - 1's dV and dK are in
            hopper::fence_regs(dva);
            hopper::fence_regs(dka);
            hopper::fence_regs(pa);
            hopper::fence_regs(da);
            release(bar_empty + 8 * sp, lane);
            pack(pa, st);
            pack(da, dpt);
          }
          {  // the last tile's dV and dK
            const int sp = qg % kStages;
            const uint32_t prev = s_ring + sp * 2 * T::kSmall;
            ++qg;
            hopper::fence_regs(pa);
            hopper::fence_regs(da);
            hopper::fence_regs(dva);
            hopper::fence_regs(dka);
            turn_begin(wg);
            hopper::wgmma_fence();
            mma_acc<DP>(dva, pa, prev + T::kSmall);
            mma_acc<DP>(dka, da, prev);
            hopper::wgmma_commit();
            turn_end(wg);
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dva);
            hopper::fence_regs(dka);
            release(bar_empty + 8 * sp, lane);
          }
        } else {
          // one tile at a time: P^T while dP^T finishes, then dS^T, then dV
          // and dK.  The loop above would hold the 128 accumulators, S^T,
          // dP^T and both packed tiles (224 registers): ptxas serialises its
          // wgmma (C7512) and spills, and the backward ran 24-32% slower at
          // D = 80-128 on an H100 (tools/flash_bwd_variants.py, pipelined128)
          for (int j = 0; j < n_it; ++j, ++qg) {
            const int s = qg % kStages;
            const int i0 = (it.first + j % it.n_q) * kStep;
            const uint32_t slot = s_ring + s * 2 * T::kSmall;
            float st[32], dpt[32];  // S^T then P^T; dP^T then dS^T: [64 keys x 64 q rows]
            uint32_t pa[16], da[16];
            hopper::mbar_wait(bar_full + 8 * s, (qg / kStages) & 1);
            turn_begin(wg);
            hopper::wgmma_fence();
            mma_abt<D, kTile, kStep>(st, k_wg, slot);
            hopper::wgmma_commit();
            mma_abt<D, kTile, kStep>(dpt, v_wg, slot + T::kSmall);
            hopper::wgmma_commit();
            turn_end(wg);
            hopper::wgmma_wait<1>();  // S^T is in; dP^T may still run
            hopper::fence_regs(st);
            probs_t(st, lse_sm + s * kStep, c_lane, causal && kw0 + 63 > i0 + off, first,
                    i0 + c_lane, scale_log2);
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dpt);
            if (j == n_it - 1) release(bar_kve + 8 * b, lane);  // the item's K and V are read
            dsoft_t(dpt, st, lse_sm + (kStages + s) * kStep, c_lane);
            pack(pa, st);
            pack(da, dpt);
            hopper::fence_regs(pa);
            hopper::fence_regs(da);
            hopper::fence_regs(dva);
            hopper::fence_regs(dka);
            turn_begin(wg);
            hopper::wgmma_fence();  // P^T and dS^T are written before wgmma reads them
            mma_acc<DP>(dva, pa, slot + T::kSmall);
            mma_acc<DP>(dka, da, slot);
            hopper::wgmma_commit();
            turn_end(wg);
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dva);
            hopper::fence_regs(dka);
            release(bar_empty + 8 * s, lane);
          }
        }
        ++kvi;
      }
      const int64_t row0 = static_cast<int64_t>(it.bn) * sk * D;
      store_acc<DP>(dk + row0, dka, kw0 + r0, sk, D, c_lane, scale);
      store_acc<DP>(dv + row0, dva, kw0 + r0, sk, D, c_lane, 1.f);
    }
    if (wg == 0) hopper::named_sync(1, 2 * kWgThreads);  // warpgroup 1's last turn
  }
}

// Maps: q, dout [B*H, Sq, d] in boxes of 128 rows; k, v [B*HKV, Sk, d] in
// boxes of 64 rows.  Persistent: G CTAs walk the n_qt * B * H items.
template <int D>
__global__ void __launch_bounds__(kThreadsWg, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse2,
                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int bh_total,
                 int h, int hkv, int sq, int sk, float scale, float scale_log2, int causal,
                 int n_qt) {
  constexpr int DP = padded<D>();
  using T = BwdTiles<DP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_qd = base;                           // buffer b: Q, then dO
  const uint32_t s_ring = s_qd + kHold * 2 * T::kBig;   // slot s: K, then V
  const uint32_t bar_q = s_ring + kStages * 2 * T::kSmall;  // full: buffer b's Q and dO arrived
  const uint32_t bar_qe = bar_q + 8 * kHold;             // empty: buffer b consumed
  const uint32_t bar_full = bar_qe + 8 * kHold;          // slot s at + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int n_items = n_qt * bh_total;
  const int off = sk - sq;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int b = 0; b < kHold; ++b) {
      hopper::mbar_init(bar_q + 8 * b, 1);
      hopper::mbar_init(bar_qe + 8 * b, kConsumers * 4);
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 1);
      hopper::mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / kWgThreads;
  if (wg == kConsumers) {
    // producer: one thread; `tg` counts the key tiles loaded (the ring's
    // position), `qi` the items' Q and dO
    hopper::setmaxnreg_dec<24>();
    if (tid == kConsumers * kWgThreads) {
      int tg = 0, qi = 0;
      for (int r = 0, i; (i = next_item(r, n_items)) >= 0; ++r) {
        const QItem it = q_item(i, bh_total, h, hkv, sq, sk, causal, n_qt);
        for (int t = 0; t < it.n_t; ++t, ++tg) {
          const int s = tg % kStages;
          const uint32_t slot = s_ring + s * 2 * T::kSmall;
          hopper::mbar_wait(bar_empty + 8 * s, ((tg / kStages) & 1) ^ 1);
          hopper::mbar_expect_tx(bar_full + 8 * s, 2 * T::kSmall);
#pragma unroll
          for (int c = 0; c < DP / kBox; ++c) {
            hopper::tma_load_3d(slot + c * kStep * 128, &tm_k, bar_full + 8 * s, c * kBox,
                                t * kStep, it.kvh);
            hopper::tma_load_3d(slot + T::kSmall + c * kStep * 128, &tm_v, bar_full + 8 * s,
                                c * kBox, t * kStep, it.kvh);
          }
          if (t == 0) {  // Q and dO after the first K and V
            const int b = qi % kHold;
            const uint32_t qd = s_qd + b * 2 * T::kBig;
            hopper::mbar_wait(bar_qe + 8 * b, ((qi / kHold) & 1) ^ 1);
            hopper::mbar_expect_tx(bar_q + 8 * b, 2 * T::kBig);
#pragma unroll
            for (int c = 0; c < DP / kBox; ++c) {
              hopper::tma_load_3d(qd + c * kTile * 128, &tm_q, bar_q + 8 * b, c * kBox, it.q0,
                                  it.bh);
              hopper::tma_load_3d(qd + T::kBig + c * kTile * 128, &tm_do, bar_q + 8 * b,
                                  c * kBox, it.q0, it.bh);
            }
            ++qi;
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    if (wg == 1) hopper::named_arrive(1, 2 * kWgThreads);  // warpgroup 0 goes first
    const int wt = tid % kWgThreads;
    const int lane = wt % 32;
    const int r0 = wg * 64 + 16 * (wt / 32) + lane / 4;  // this thread's rows: r0, r0 + 8
    const int c_lane = 2 * (lane % 4);                   // its first key column in each 8
    int tg = 0, qi = 0;
    for (int r = 0, i; (i = next_item(r, n_items)) >= 0; ++r) {
      const QItem it = q_item(i, bh_total, h, hkv, sq, sk, causal, n_qt);
      const int qw0 = it.q0 + wg * 64;  // the warpgroup's first row
      const int row = it.q0 + r0;
      float l2[2], de[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const bool live = row + 8 * x < sq;
        const int64_t g = static_cast<int64_t>(it.bh) * sq + row + 8 * x;
        l2[x] = live ? lse2[g] : CUDART_INF_F;
        de[x] = live ? delta[g] : 0.f;
      }
      float dqa[DP / 2];
      zero(dqa);
      const int b = qi % kHold;
      const uint32_t q_wg = s_qd + b * 2 * T::kBig + wg * 64 * 128;
      const uint32_t do_wg = q_wg + T::kBig;
      if (it.n_t > 0) hopper::mbar_wait(bar_q + 8 * b, (qi / kHold) & 1);
      int last[2];  // the last key this thread's rows may see
#pragma unroll
      for (int x = 0; x < 2; ++x) last[x] = causal ? min(sk - 1, row + 8 * x + off) : sk - 1;
      // as in dK / dV: tile t starts S_t and dP_t and, behind them, dQ +=
      // dS_{t-1} K_{t-1}; tile 0 peeled off the loop
      if (it.n_t > 0) {
        float sc[32], dp[32];  // S then P; dP then dS: [64 rows x 64 keys]
        uint32_t da[16];       // the previous tile's dS in bf16 pairs
        {
          const int s = tg % kStages;
          const uint32_t slot = s_ring + s * 2 * T::kSmall;
          hopper::mbar_wait(bar_full + 8 * s, (tg / kStages) & 1);
          turn_begin(wg);
          hopper::wgmma_fence();
          mma_abt<D, kTile, kStep>(sc, q_wg, slot);
          hopper::wgmma_commit();
          mma_abt<D, kTile, kStep>(dp, do_wg, slot + T::kSmall);
          hopper::wgmma_commit();
          turn_end(wg);
          hopper::wgmma_wait<1>();
          hopper::fence_regs(sc);
          probs_r(sc, l2, (causal && kStep - 1 > qw0 + off) || kStep > sk, last, c_lane,
                  scale_log2);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dp);
          if (it.n_t == 1) release(bar_qe + 8 * b, lane);  // the item's Q and dO are read
          dsoft_r(dp, sc, de);
          pack(da, dp);
        }
        for (int t = 1; t < it.n_t; ++t) {
          const int sp = tg % kStages;  // tile t - 1's slot
          const uint32_t prev = s_ring + sp * 2 * T::kSmall;
          ++tg;
          const int s = tg % kStages;
          const int j0 = t * kStep;
          const uint32_t slot = s_ring + s * 2 * T::kSmall;
          hopper::mbar_wait(bar_full + 8 * s, (tg / kStages) & 1);
          hopper::fence_regs(da);
          hopper::fence_regs(dqa);
          turn_begin(wg);
          hopper::wgmma_fence();
          mma_abt<D, kTile, kStep>(sc, q_wg, slot);
          hopper::wgmma_commit();
          mma_abt<D, kTile, kStep>(dp, do_wg, slot + T::kSmall);
          hopper::wgmma_commit();
          mma_acc<DP>(dqa, da, prev);
          hopper::wgmma_commit();
          turn_end(wg);
          hopper::wgmma_wait<2>();  // S_t is in
          hopper::fence_regs(sc);
          probs_r(sc, l2, (causal && j0 + kStep - 1 > qw0 + off) || j0 + kStep > sk, last,
                  j0 + c_lane, scale_log2);
          hopper::wgmma_wait<1>();  // dP_t is in
          hopper::fence_regs(dp);
          if (t == it.n_t - 1) release(bar_qe + 8 * b, lane);
          dsoft_r(dp, sc, de);
          hopper::wgmma_wait<0>();  // tile t - 1's dQ is in
          hopper::fence_regs(dqa);
          hopper::fence_regs(da);
          release(bar_empty + 8 * sp, lane);
          pack(da, dp);
        }
        {  // the last tile's dQ
          const int sp = tg % kStages;
          ++tg;
          hopper::fence_regs(da);
          hopper::fence_regs(dqa);
          turn_begin(wg);
          hopper::wgmma_fence();
          mma_acc<DP>(dqa, da, s_ring + sp * 2 * T::kSmall);
          hopper::wgmma_commit();
          turn_end(wg);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dqa);
          release(bar_empty + 8 * sp, lane);
        }
      }
      if (it.n_t > 0) ++qi;
      store_acc<DP>(dq + static_cast<int64_t>(it.bh) * sq * D, dqa, row, sq, D, c_lane, scale);
    }
    if (wg == 0) hopper::named_sync(1, 2 * kWgThreads);  // warpgroup 1's last turn
  }
}

// Returns a cudaError_t, or -(CUresult) when a tensor map is refused.
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* delta, const float* lse2, void* dq, void* dk, void* dv, int b,
                int h, int hkv, int sq, int sk, float scale, int causal, cudaStream_t stream) {
  using T = BwdTiles<padded<D>()>;
  using bf = __nv_bfloat16;
  if (sk == 0)  // no key: dq is 0 (a tensor map cannot be empty); dk, dv are empty
    return cudaMemsetAsync(dq, 0, static_cast<size_t>(b) * h * sq * D * 2, stream);
  if (sq == 0) {  // no query: dk and dv are 0
    const size_t n = static_cast<size_t>(b) * hkv * sk * D * 2;
    const cudaError_t err = cudaMemsetAsync(dk, 0, n, stream);
    return err != cudaSuccess ? err : cudaMemsetAsync(dv, 0, n, stream);
  }
  tma::EncodeTiled enc = tma::encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  // dK / dV: q and dO in 64-row boxes, k and v in 128; dQ the other way round
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;
  CUresult r = tma::make_map(enc, &kq, q, b * h, sq, D, kStep);
  if (r == CUDA_SUCCESS) r = tma::make_map(enc, &kdo, dout, b * h, sq, D, kStep);
  if (r == CUDA_SUCCESS) r = tma::make_map(enc, &kk, k, b * hkv, sk, D, kTile);
  if (r == CUDA_SUCCESS) r = tma::make_map(enc, &kv, v, b * hkv, sk, D, kTile);
  if (r == CUDA_SUCCESS) r = tma::make_map(enc, &qq, q, b * h, sq, D, kTile);
  if (r == CUDA_SUCCESS) r = tma::make_map(enc, &qdo, dout, b * h, sq, D, kTile);
  if (r == CUDA_SUCCESS) r = tma::make_map(enc, &qk, k, b * hkv, sk, D, kStep);
  if (r == CUDA_SUCCESS) r = tma::make_map(enc, &qv, v, b * hkv, sk, D, kStep);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const float sl2 = scale * kLog2e;

  const int n_kt = (sk + kTile - 1) / kTile;
  const int64_t kv_items = static_cast<int64_t>(n_kt) * b * hkv;
  const int n_qt = (sq + kTile - 1) / kTile;
  const int64_t q_items = static_cast<int64_t>(n_qt) * b * h;
  if (kv_items > 0x7fffffff || q_items > 0x7fffffff) return cudaErrorInvalidConfiguration;

  auto kdkdv = bwd_dkdv_wgmma<D>;
  err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kDkdv);
  if (err != cudaSuccess) return err;
  kdkdv<<<static_cast<unsigned>(std::min<int64_t>(kv_items, sms)), kThreadsWg, T::kDkdv,
          stream>>>(kq, kk, kv, kdo, lse2, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
                    b * hkv, h, hkv, sq, sk, scale, sl2, causal, static_cast<int>(kv_items));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kdq = bwd_dq_wgmma<D>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kDq);
  if (err != cudaSuccess) return err;
  kdq<<<static_cast<unsigned>(std::min<int64_t>(q_items, sms)), kThreadsWg, T::kDq, stream>>>(
      qq, qk, qv, qdo, lse2, delta, static_cast<bf*>(dq), b * h, h, hkv, sq, sk, scale, sl2,
      causal, n_qt);
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

// The bf16 plan's shared bytes and padded D against the kernels' at head
// dim D.
template <int D>
int check_bf16_plan(int padded_d, int smem_dkdv, int smem_dq) {
  using T = BwdTiles<padded<D>()>;
  const bool ok = padded_d == padded<D>() && smem_dkdv == T::kDkdv && smem_dq == T::kDq;
  return ok ? 0 : cudaErrorInvalidValue;
}

}  // namespace

// 0 when the plan (kernels/flash_attention.py::plan_bwd: padded D, rows of
// an item, rows of a ring slot, slots, and each pass's shared bytes) names a
// kernel built here, else cudaErrorInvalidValue.  dtype as below.
extern "C" int dex_flash_attention_bwd_plan(int dtype, int d, int padded_d, int block_rows,
                                            int step_rows, int stages, int smem_dkdv,
                                            int smem_dq) {
  if (dtype == 0) {
    const bool ok = padded_d == d && block_rows == kBlock && step_rows == kBlock && stages == 1 &&
                    smem_dkdv == f32_dkdv_smem(d) && smem_dq == f32_dq_smem(d) &&
                    (d == 64 || d == 80 || d == 96 || d == 128);
    return ok ? 0 : cudaErrorInvalidValue;
  }
  if (block_rows != kTile || step_rows != kStep || stages != kStages) return cudaErrorInvalidValue;
#define DEX_FLASH_BWD_PLAN(D, DP) \
  if (d == D) return check_bf16_plan<D>(padded_d, smem_dkdv, smem_dq);
  DEX_FLASH_BWD_PLAN(64, 64)
  DEX_FLASH_BWD_PLAN(80, 128)
  DEX_FLASH_BWD_PLAN(96, 128)
  DEX_FLASH_BWD_PLAN(128, 128)
#undef DEX_FLASH_BWD_PLAN
  return cudaErrorInvalidValue;  // no kernel for this head dim
}

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q, o, dout
// [b, h, sq, d]; k, v [b, hkv, sk, d]; lse [b, h, sq] f32 (the forward's,
// natural log); dq like q, dk and dv like k; delta and lse2 [b, h, sq] f32
// scratch; all contiguous, 16-byte aligned.  d is 64, 80, 96 or 128; h is a
// multiple of hkv.  Returns 0, a cudaError_t, or -(CUresult) when a tensor
// map is refused.
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
#define DEX_FLASH_BWD_PLAN(D, DP)                                                          \
  static_assert(padded<D>() == DP, "padded head dim");                                     \
  if (d == D)                                                                              \
    return launch_bf16<D>(q, k, v, dout, delta, lse2, dq, dk, dv, b, h, hkv, sq, sk, scale, \
                          causal, s);
  DEX_FLASH_BWD_PLAN(64, 64)
  DEX_FLASH_BWD_PLAN(80, 128)
  DEX_FLASH_BWD_PLAN(96, 128)
  DEX_FLASH_BWD_PLAN(128, 128)
#undef DEX_FLASH_BWD_PLAN
  return cudaErrorInvalidValue;
}
