// flash_attention: blocked prefill attention with an online softmax.
//
// Replaces the TPU kernel flash_attention in
// src/repro/kernels/flash_attention.py, whose grid ran (batch * head, q
// block, kv block) with the running max, denominator and accumulator in
// VMEM scratch across the sequential kv axis, and pointed each query head at
// its kv head by an index map.  Here a CTA takes a (batch * head, q tile)
// and loops over the kv tiles itself; the kv head is h / (H / HKV), so GQA
// needs no copy of K or V.  Tiles wholly above the causal diagonal (offset
// Sk - Sq) are never loaded; any Sq and Sk are taken, the last tiles masked.
// A row that no key may reach (causal with Sk < Sq) comes out 0.  Given an
// lse pointer, both kernels also write each row's natural log-sum-exp of
// its scaled, masked logits (-inf for a row no key reaches), which the
// backward (flash_attention_bwd.cu) rebuilds the probabilities from; a null
// pointer writes nothing more.
//
// Bound: operations.  Per (query, key) pair the causal mask keeps, 4 * D
// flops (QK^T and PV); at minitron-4b's prefill shape that is 51.5 GFLOP,
// 0.052 ms at the card's dense bf16 tensor-core rate, against 0.02 ms of
// bytes.  Two kernels, chosen by dtype:
//
// bfloat16: tensor cores (flash_attention_wgmma).  A persistent CTA of
// three warpgroups, one an SM, walks (q tile, head) items in a zigzag over
// the CTAs, causal q tiles longest first, so the diagonal's short tiles
// fill the tail:
//  1. warpgroup 2 is the producer: one thread starts TMA loads of K and V
//     tiles of BN rows into two rings of ST slots, each slot with a full
//     and an empty mbarrier, K one tile ahead of V (the consumers read V_t
//     a tile after K_t), and q once per item after its first K, when the
//     consumers have released the last one; loads overlap the products and
//     the previous item's epilogue; it gives its registers to the
//     consumers (setmaxnreg 24 / 240);
//  2. warpgroups 0 and 1 each own 64 query rows (wgmma's M).  For tile t a
//     warpgroup starts S_t = Q K_t^T (wgmma SS, Q and K K-major, f32
//     accumulators in registers) and, behind it, O += P_{t-1} V_{t-1}
//     (wgmma RS: P from registers as the A operand, since the S
//     accumulator's layout is the A fragment's; V read MN-major through the
//     descriptor's transpose bit); it waits for S_t alone and runs its
//     softmax while the P V product is in flight.  The two warpgroups take
//     turns to start them (named barriers), so one's softmax also runs
//     under the other's products.  The first tile's S is peeled off the
//     loop: with a commit that only some iterations make, ptxas cannot tell
//     which group a wait retires and serialises every wgmma (C7514);
//  3. the softmax runs on the accumulator registers: scale * log2(e) folded
//     into one multiply and ex2, row maxima reduced over the 4 threads that
//     share a row by two shuffles, a mask only on tiles that cross the
//     diagonal or the Sk edge; O is rescaled once no wgmma owns it;
//  4. P is split into two bf16 parts, hi and the rounding error lo, and
//     both are multiplied: hi alone rounds every weight by up to 2^-9,
//     which moved minitron-4b's prefill outputs by a bf16 step, 0.031
//     where |O| >= 4, above the 2e-2 tolerance; with hi + lo 0.09% of them
//     differ from the plain version, by one step in [2, 4) at most;
//  5. the head dim is padded to a multiple of 64 without a copy: TMA boxes
//     are 64 columns (128 bytes, 128B-swizzled) and the tensor maps' inner
//     extent is the true D, so columns >= D, rows >= Sq or Sk of the last
//     tiles, are zero-filled in shared memory (D = 80 runs as 128); the
//     epilogue writes O / l in bf16, 0 where l = 0, and, asked for, the
//     natural log-sum-exp (m2 + log2 l) ln 2 of the base-2 running max m2
//     and sum l.
// The plan (padded D, tile sizes, stages, shared bytes) comes from
// kernels/flash_attention.py::plan and must match an instantiation here.
//
// float32: CUDA cores (flash_attention_f32), one CTA of 256 threads per 64-row q
// tile, 64-row K and V tiles staged in shared memory, each thread a 4 x 4
// block of scores and a 4 x D/16 block of the output, products by fmaf.  On
// tensor cores float32 runs only as TF32 (about three decimal digits),
// which would break the f32 tolerance (1e-4) and the float32 gates that
// refuse TF32, so f32 stays here.  Neither kernel stands in for the other.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16 on tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128;        // q rows a CTA: two consumer warpgroups of 64
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kWgThreads = 128;
constexpr int kThreadsWg = kWgThreads * (kConsumers + 1);
constexpr int kBox = tma::kBoxCols;  // columns of a TMA box: 128 bytes of bf16
constexpr int kSmemSlack = 1024 + 128;  // 1024-byte alignment, barriers
constexpr float kLn2 = 0.693147180559945309f;

template <int DP, int BN, int ST>
struct Tiles {
  static constexpr int kQ = kBM * DP * 2;   // bytes of the q tile
  static constexpr int kKV = BN * DP * 2;   // bytes of one K or V tile
  static constexpr int kBytes = kQ + 2 * ST * kKV + kSmemSlack;
  static_assert(DP % kBox == 0 && BN % 64 == 0, "tile shape");
  static_assert(kBytes <= 232448, "shared memory");
};

template <int BN>
__device__ __forceinline__ void mma_qk(float (&s)[BN / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 128)
    hopper::wgmma_ss_n128(s, da, db, acc);
  else
    hopper::wgmma_ss_n64(s, da, db, acc);
}

template <int DP>
__device__ __forceinline__ void mma_pv(float (&o)[DP / 2], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint64_t db) {
  if constexpr (DP == 256)
    hopper::wgmma_rs_n256(o, a0, a1, a2, a3, db);
  else if constexpr (DP == 192)
    hopper::wgmma_rs_n192(o, a0, a1, a2, a3, db);
  else if constexpr (DP == 128)
    hopper::wgmma_rs_n128(o, a0, a1, a2, a3, db);
  else
    hopper::wgmma_rs_n64(o, a0, a1, a2, a3, db);
}

// (a, b) rounded to a bf16 pair `hi` (a in the low half) and the rounding
// errors rounded to a second pair `lo`: hi + lo is (a, b) to about 2^-17.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// O's rows r0 (o[4i], o[4i + 1]) and r0 + 8 (o[4i + 2], o[4i + 3]) times
// a0 and a1.
template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2], float a0, float a1) {
#pragma unroll
  for (int x = 0; x < DP / 8; ++x) {
    o[4 * x] *= a0;
    o[4 * x + 1] *= a0;
    o[4 * x + 2] *= a1;
    o[4 * x + 3] *= a1;
  }
}

// Starts S = Q K^T as one committed wgmma group: the warpgroup's 64 q rows
// at `q` (64-column blocks of kBM 128-byte rows) against the BN x DP K tile
// at `k` (64-column blocks of BN rows).
template <int DP, int BN>
__device__ __forceinline__ void start_qk(float (&sc)[BN / 2], uint32_t q, uint32_t k) {
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < DP / kBox; ++c)
#pragma unroll
    for (int kk = 0; kk < kBox / 16; ++kk)
      mma_qk<BN>(sc, hopper::desc_sw128(q + c * kBM * 128 + kk * 32, 16, 1024),
                 hopper::desc_sw128(k + c * BN * 128 + kk * 32, 16, 1024), c + kk > 0);
  hopper::wgmma_commit();
}

// Starts O += (P_hi + P_lo) V as one committed wgmma group; V is the BN x DP
// tile at `v` (64-column blocks of BN 128-byte rows), read MN-major.
template <int DP, int BN>
__device__ __forceinline__ void start_pv(float (&o)[DP / 2], uint32_t (&p)[BN / 4],
                                         uint32_t (&pl)[BN / 4], uint32_t v) {
  hopper::fence_regs(p);
  hopper::fence_regs(pl);
  hopper::fence_regs(o);
  hopper::wgmma_fence();  // P and the rescaled O are written before wgmma reads them
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t dv = hopper::desc_sw128(v + kk * 16 * 128, BN * 128, 1024);
    mma_pv<DP>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], dv);
    mma_pv<DP>(o, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], dv);
  }
  hopper::wgmma_commit();
}

// The weights of a tile as two bf16 pairs each, hi and lo: hi alone would
// put one bf16 rounding (2^-9) in every weight, which moves outputs by a
// bf16 step.
template <int BN>
__device__ __forceinline__ void to_bf16_pair(const float (&e)[BN / 2], uint32_t (&p)[BN / 4],
                                             uint32_t (&pl)[BN / 4]) {
#pragma unroll
  for (int x = 0; x < BN / 4; ++x) split_bf16(e[2 * x], e[2 * x + 1], p[x], pl[x]);
}

// One consumer warp's arrival on an empty barrier: all its lanes are past
// their reads.
__device__ __forceinline__ void release_stage(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// A thread's two rows: r0 and r0 + 8; qw0 is its warpgroup's first row;
// lim0 and lim1 the last key each row may see.
struct Rows {
  int qw0, r0, lim0, lim1;
};

// The online softmax of a thread's two rows.  `step` turns the scores of
// the tile at key k0 into weights exp2(s * scale log2(e) - max), in place,
// masking keys past a row's limit where the tile reaches them; al0 and al1
// are the factors that take O from the previous max to the new one.
struct Softmax {
  float m0, m1, l0, l1, al0, al1;

  __device__ __forceinline__ void reset() {
    m0 = m1 = -CUDART_INF_F;
    l0 = l1 = 0.f;
    al0 = al1 = 1.f;
  }

  template <int BN>
  __device__ __forceinline__ void step(float (&sc)[BN / 2], int k0, const Rows& rw, int sk,
                                       int sq, int causal, int c_lane, float scale_log2) {
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) sc[x] *= scale_log2;
    if (k0 + BN > sk || (causal && k0 + BN - 1 > rw.qw0 + sk - sq)) {
#pragma unroll
      for (int x = 0; x < BN / 8; ++x)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = k0 + 8 * x + c_lane + j;
          if (kpos > rw.lim0) sc[4 * x + j] = -CUDART_INF_F;
          if (kpos > rw.lim1) sc[4 * x + 2 + j] = -CUDART_INF_F;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int x = 0; x < BN / 8; ++x) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * x], sc[4 * x + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * x + 2], sc[4 * x + 3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {  // the 4 threads that share a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // a row that has seen no key yet keeps max -inf: subtract 0 instead
    const float b0 = mx0 == -CUDART_INF_F ? 0.f : mx0;
    const float b1 = mx1 == -CUDART_INF_F ? 0.f : mx1;
    al0 = hopper::ex2(m0 - b0);
    al1 = hopper::ex2(m1 - b1);
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int x = 0; x < BN / 8; ++x) {
      sc[4 * x] = hopper::ex2(sc[4 * x] - b0);
      sc[4 * x + 1] = hopper::ex2(sc[4 * x + 1] - b0);
      sc[4 * x + 2] = hopper::ex2(sc[4 * x + 2] - b1);
      sc[4 * x + 3] = hopper::ex2(sc[4 * x + 3] - b1);
      l0 += sc[4 * x] + sc[4 * x + 1];
      l1 += sc[4 * x + 2] + sc[4 * x + 3];
    }
  }
};

// The producer's load of kv tile `g` (counted over the CTA's items) into
// ring slot g % ST of `ring`: waits until the slot's last tile is consumed
// (`empty`), then one TMA box a 64-column block, completing on `full`.
template <int DP, int BN, int ST>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t ring, uint32_t full,
                                          uint32_t empty, int g, int row, int head) {
  constexpr int kTile = BN * DP * 2;
  const int s = g % ST;
  hopper::mbar_wait(empty + 8 * s, ((g / ST) & 1) ^ 1);
  hopper::mbar_expect_tx(full + 8 * s, kTile);
#pragma unroll
  for (int c = 0; c < DP / kBox; ++c)
    hopper::tma_load_3d(ring + s * kTile + c * BN * 128, map, full + 8 * s, c * kBox, row, head);
}

// One work item: a (q tile, batch * head) pair.  Items are numbered with q
// tiles longest first when causal (the diagonal's short tiles last), heads
// fastest.
struct Item {
  int q0, bh, kvh, n_tiles;
};

template <int BN>
__device__ __forceinline__ Item item_at(int i, int bh_total, int h, int hkv, int sq, int sk,
                                        int causal, int n_qt) {
  Item it;
  const int rank = i / bh_total;
  it.bh = i % bh_total;
  it.q0 = (causal ? n_qt - 1 - rank : rank) * kBM;
  it.kvh = (it.bh / h) * hkv + (it.bh % h) / (h / hkv);
  int last_key = sk - 1;  // kv tiles to visit: up to the diagonal of the tile's last row
  if (causal) last_key = min(last_key, min(it.q0 + kBM, sq) - 1 + sk - sq);
  it.n_tiles = last_key < 0 ? 0 : last_key / BN + 1;
  return it;
}

// Round r of CTA c takes item r * G + c, or r * G + G - 1 - c in odd rounds
// (G CTAs): a zigzag that pairs long items with short ones.  -1 when done.
__device__ __forceinline__ int next_item(int r, int n_items) {
  const int g = gridDim.x, c = blockIdx.x;
  const int i = r * g + ((r & 1) ? g - 1 - c : c);
  return i < n_items ? i : -1;
}

// Persistent: G CTAs (at most one an SM) walk the n_qt * bh_total items.
// Maps: q [B*H, Sq, D], k and v [B*HKV, Sk, D], boxes of 64 columns by kBM
// (q) or BN (k, v) rows.
template <int DP, int BN, int ST>
__global__ void __launch_bounds__(kThreadsWg, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int bh_total,
                    int h, int hkv, int sq, int sk, int d, float scale_log2, int causal,
                    int n_qt) {
  using T = Tiles<DP, BN, ST>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = s_q + T::kQ;         // stage s at s_k + s * kKV
  const uint32_t s_v = s_k + ST * T::kKV;   // stage s at s_v + s * kKV
  const uint32_t bar_q = s_v + ST * T::kKV; // full: q arrived
  const uint32_t bar_qe = bar_q + 8;        // empty: q consumed
  const uint32_t bar_k = bar_qe + 8;        // full: K of stage s arrived
  const uint32_t bar_v = bar_k + 8 * ST;    // full: V of stage s arrived
  const uint32_t bar_ek = bar_v + 8 * ST;   // empty: K of stage s consumed
  const uint32_t bar_ev = bar_ek + 8 * ST;  // empty: V of stage s consumed
  const int n_items = n_qt * bh_total;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(bar_q, 1);
    hopper::mbar_init(bar_qe, kConsumers * 4);  // one arrival a consumer warp
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(bar_k + 8 * s, 1);
      hopper::mbar_init(bar_v + 8 * s, 1);
      hopper::mbar_init(bar_ek + 8 * s, kConsumers * 4);
      hopper::mbar_init(bar_ev + 8 * s, kConsumers * 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / kWgThreads;
  if (wg == kConsumers) {
    // producer: one thread keeps the rings full, K one tile ahead of V (the
    // consumers read V_t a tile after K_t); `tg` counts the kv tiles of
    // earlier items (the rings' position), `qi` the q tiles loaded
    hopper::setmaxnreg_dec<24>();
    if (tid == kConsumers * kWgThreads) {
      int tg = 0, qi = 0;
      for (int r = 0, i; (i = next_item(r, n_items)) >= 0; ++r) {
        const Item it = item_at<BN>(i, bh_total, h, hkv, sq, sk, causal, n_qt);
        for (int t = 0; t <= it.n_tiles; ++t) {
          if (t < it.n_tiles)
            load_tile<DP, BN, ST>(&tm_k, s_k, bar_k, bar_ek, tg + t, t * BN, it.kvh);
          if (t == 0 && it.n_tiles > 0) {  // q after the first K: the last one may be in use
            hopper::mbar_wait(bar_qe, (qi & 1) ^ 1);
            hopper::mbar_expect_tx(bar_q, T::kQ);
#pragma unroll
            for (int c = 0; c < DP / kBox; ++c)
              hopper::tma_load_3d(s_q + c * kBM * 128, &tm_q, bar_q, c * kBox, it.q0, it.bh);
            ++qi;
          }
          if (t > 0)
            load_tile<DP, BN, ST>(&tm_v, s_v, bar_v, bar_ev, tg + t - 1, (t - 1) * BN, it.kvh);
        }
        tg += it.n_tiles;
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int wt = tid % kWgThreads;
    const int lane = wt % 32;
    const int row = wg * 64 + (wt / 32) * 16 + lane / 4;  // this thread's rows: row, row + 8
    const int c_lane = 2 * (lane % 4);                    // its first column in each 8
    const uint32_t q_wg = s_q + wg * 64 * 128;
    // ping-pong: the warpgroups take turns to start S = Q K^T (named
    // barriers 1 and 2), so one's softmax runs under the other's products;
    // warpgroup 0 goes first
    if (wg == 1) hopper::named_arrive(1, 2 * kWgThreads);
    int tg = 0, qi = 0;
    for (int r = 0, i; (i = next_item(r, n_items)) >= 0; ++r) {
      const Item it = item_at<BN>(i, bh_total, h, hkv, sq, sk, causal, n_qt);
      Rows rows;
      rows.qw0 = it.q0 + wg * 64;
      rows.r0 = it.q0 + row;
      rows.lim0 = causal ? min(sk - 1, rows.r0 + sk - sq) : sk - 1;
      rows.lim1 = causal ? min(sk - 1, rows.r0 + 8 + sk - sq) : sk - 1;
      float o[DP / 2];
#pragma unroll
      for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
      float sc[BN / 2];                // S of a tile, then its weights in f32
      uint32_t p[BN / 4], pl[BN / 4];  // the previous tile's weights, hi and lo
      Softmax sm;
      sm.reset();
      if (it.n_tiles > 0) {
        hopper::mbar_wait(bar_q, qi & 1);
        // tile 0: S and its softmax
        hopper::mbar_wait(bar_k + 8 * (tg % ST), (tg / ST) & 1);
        hopper::named_sync(1 + wg, 2 * kWgThreads);
        start_qk<DP, BN>(sc, q_wg, s_k + (tg % ST) * T::kKV);
        hopper::named_arrive(2 - wg, 2 * kWgThreads);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        release_stage(bar_ek + 8 * (tg % ST), lane);
        if (it.n_tiles == 1) release_stage(bar_qe, lane);
        sm.step<BN>(sc, 0, rows, sk, sq, causal, c_lane, scale_log2);
        to_bf16_pair<BN>(sc, p, pl);
        ++tg;
      }
      // Tile t starts S_t = Q K_t^T and, behind it, O += P_{t-1} V_{t-1};
      // the softmax of S_t runs while that product is in flight.
      for (int t = 1; t < it.n_tiles; ++t, ++tg) {
        const int s = tg % ST;
        const int sp = (tg + ST - 1) % ST;  // tile t - 1's stage
        hopper::mbar_wait(bar_k + 8 * s, (tg / ST) & 1);
        hopper::named_sync(1 + wg, 2 * kWgThreads);
        start_qk<DP, BN>(sc, q_wg, s_k + s * T::kKV);
        hopper::mbar_wait(bar_v + 8 * sp, ((tg - 1) / ST) & 1);
        start_pv<DP, BN>(o, p, pl, s_v + sp * T::kKV);
        hopper::named_arrive(2 - wg, 2 * kWgThreads);
        hopper::wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
        hopper::fence_regs(sc);
        release_stage(bar_ek + 8 * s, lane);
        if (t == it.n_tiles - 1) release_stage(bar_qe, lane);
        sm.step<BN>(sc, t * BN, rows, sk, sq, causal, c_lane, scale_log2);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        release_stage(bar_ev + 8 * sp, lane);
        // O to this tile's max, here where no wgmma owns it (a read of its
        // registers while one is in flight makes ptxas serialise them all)
        rescale<DP>(o, sm.al0, sm.al1);
        to_bf16_pair<BN>(sc, p, pl);
      }
      if (it.n_tiles > 0) {  // the last tile's P V
        const int sp = (tg + ST - 1) % ST;
        hopper::mbar_wait(bar_v + 8 * sp, ((tg - 1) / ST) & 1);
        start_pv<DP, BN>(o, p, pl, s_v + sp * T::kKV);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        release_stage(bar_ev + 8 * sp, lane);
        ++qi;
      }
      float l0 = sm.l0, l1 = sm.l1;
      const int r0 = rows.r0, r1 = rows.r0 + 8;

#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, x);
        l1 += __shfl_xor_sync(0xffffffffu, l1, x);
      }
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
      const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      if (lse != nullptr && (lane & 3) == 0) {  // one thread of the four a row
        float* lb = lse + static_cast<int64_t>(it.bh) * sq;
        if (r0 < sq) lb[r0] = l0 > 0.f ? (sm.m0 + log2f(l0)) * kLn2 : -CUDART_INF_F;
        if (r1 < sq) lb[r1] = l1 > 0.f ? (sm.m1 + log2f(l1)) * kLn2 : -CUDART_INF_F;
      }
      __nv_bfloat16* ob = out + static_cast<int64_t>(it.bh) * sq * d;
#pragma unroll
      for (int x = 0; x < DP / 8; ++x) {
        const int col = 8 * x + c_lane;
        if (col >= d) continue;
        if (r0 < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r0) * d + col) =
              __floats2bfloat162_rn(o[4 * x] * inv0, o[4 * x + 1] * inv0);
        if (r1 < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r1) * d + col) =
              __floats2bfloat162_rn(o[4 * x + 2] * inv1, o[4 * x + 3] * inv1);
      }
    }
    if (wg == 0) hopper::named_sync(1, 2 * kWgThreads);  // warpgroup 1's last turn
  }
}

// Returns a cudaError_t, or -(CUresult) when a tensor map is refused.
template <int DP, int BN, int ST>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                 int h, int hkv, int sq, int sk, int d, float scale, int causal, int smem,
                 cudaStream_t stream) {
  using T = Tiles<DP, BN, ST>;
  if (smem != T::kBytes) return cudaErrorInvalidValue;  // the plan disagrees
  tma::EncodeTiled enc = tma::encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = tma::make_map(enc, &tq, q, b * h, sq, d, kBM);
  if (r == CUDA_SUCCESS) r = tma::make_map(enc, &tk, k, b * hkv, sk, d, BN);
  if (r == CUDA_SUCCESS) r = tma::make_map(enc, &tv, v, b * hkv, sk, d, BN);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  auto kern = flash_attention_wgmma<DP, BN, ST>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kBM - 1) / kBM;
  const int64_t items = static_cast<int64_t>(n_qt) * b * h;
  if (items > 0x7fffffff) return cudaErrorInvalidConfiguration;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t blocks = std::min<int64_t>(items, sms);
  kern<<<static_cast<unsigned>(blocks), kThreadsWg, T::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, b * h, h, hkv, sq, sk, d,
      scale * 1.4426950408889634f, causal, n_qt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBlock = 64;  // q rows and kv rows of a tile
constexpr int kThreads = 256;
constexpr float kNegInit = -1e30f;

int f32_smem(int d) {
  return static_cast<int>(sizeof(float)) *
         (2 * kBlock * (d + 1) + kBlock * d + kBlock * (kBlock + 1));
}

// NJ: output columns a thread owns, ceil(D / 16) rounded up to a power of 2.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int h, int hkv, int sq, int sk, int d, float scale,
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

  const float* qb = q + static_cast<int64_t>(bh) * sq * d;
  const float* kb = k + static_cast<int64_t>(kvh) * sk * d;
  const float* vb = v + static_cast<int64_t>(kvh) * sk * d;
  for (int e = tid; e < kBlock * d; e += kThreads) {
    const int r = e / d, c = e % d;
    qs[r * dp + c] = q0 + r < sq ? qb[static_cast<int64_t>(q0 + r) * d + c] * scale : 0.f;
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
      ks[r * dp + c] = in ? kb[g] : 0.f;
      vs[r * d + c] = in ? vb[g] : 0.f;
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

  float* ob = out + static_cast<int64_t>(bh) * sq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sq) continue;
    // m and l are the same in the 16 threads of a row: one writes
    if (lse != nullptr && tx == 0)
      lse[static_cast<int64_t>(bh) * sq + qpos] = l[i] > 0.f ? m[i] + logf(l[i]) : -CUDART_INF_F;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) ob[static_cast<int64_t>(qpos) * d + col] = acc[i][j] * inv;
    }
  }
}

template <int NJ>
cudaError_t launch_f32_nj(const void* q, const void* k, const void* v, void* out, float* lse,
                          int b, int h, int hkv, int sq, int sk, int d, float scale,
                          int causal, cudaStream_t stream) {
  const int smem = f32_smem(d);
  auto kern = flash_attention_f32<NJ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBlock - 1) / kBlock, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, h, hkv, sq, sk, d, scale,
      causal);
  return cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int b,
               int h, int hkv, int sq, int sk, int d, float scale, int causal, int smem,
               cudaStream_t stream) {
  if (smem != f32_smem(d)) return cudaErrorInvalidValue;  // the plan disagrees
  if (d <= 32)
    return launch_f32_nj<2>(q, k, v, out, lse, b, h, hkv, sq, sk, d, scale, causal, stream);
  if (d <= 64)
    return launch_f32_nj<4>(q, k, v, out, lse, b, h, hkv, sq, sk, d, scale, causal, stream);
  if (d <= 128)
    return launch_f32_nj<8>(q, k, v, out, lse, b, h, hkv, sq, sk, d, scale, causal, stream);
  return launch_f32_nj<16>(q, k, v, out, lse, b, h, hkv, sq, sk, d, scale, causal, stream);
}

// lse[0, n) = -inf: the log-sum-exp of rows that no key reaches.
__global__ void fill_neg_inf(float* __restrict__ lse, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    lse[i] = -CUDART_INF_F;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q [b, h,
// sq, d]; k, v [b, hkv, sk, d]; out like q; all contiguous, 16-byte
// aligned; lse [b, h, sq] f32, or null to write no log-sum-exp.  d is a multiple of 8, at most 256; h is a multiple of hkv.  The
// plan (padded_d, block_kv, stages, smem_bytes) is
// kernels/flash_attention.py::plan's: a bf16 plan names one instantiation of
// flash_attention_wgmma, and smem_bytes must be that kernel's.  Returns 0, a
// cudaError_t, or -(CUresult) when a tensor map is refused.
extern "C" int dex_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int dtype, int b, int h, int hkv, int sq, int sk,
                                   int d, float scale, int causal, int padded_d, int block_kv,
                                   int stages, int smem_bytes, void* stream) {
  if (b == 0 || h == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, lse, b, h, hkv, sq, sk, d, scale, causal, smem_bytes, s);
  if (sk == 0) {  // no key at all: every row is 0 (a tensor map cannot be empty)
    cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(b) * h * sq * d * 2, s);
    if (err != cudaSuccess || lse == nullptr) return err;
    fill_neg_inf<<<128, 256, 0, s>>>(lse, static_cast<int64_t>(b) * h * sq);
    return cudaGetLastError();
  }
#define DEX_FLASH_PLAN(DP, BN, ST)                                                        \
  if (padded_d == DP && block_kv == BN && stages == ST)                                   \
    return launch_wgmma<DP, BN, ST>(q, k, v, out, lse, b, h, hkv, sq, sk, d, scale,       \
                                    causal, smem_bytes, s);
  DEX_FLASH_PLAN(64, 128, 3)
  DEX_FLASH_PLAN(128, 128, 3)
  DEX_FLASH_PLAN(192, 64, 2)
  DEX_FLASH_PLAN(256, 64, 2)
#undef DEX_FLASH_PLAN
  return cudaErrorInvalidValue;  // no instantiation for this plan
}
