// mamba_scan_bwd: the gradient of mamba_scan (mamba_scan.cu) on Hopper's
// CUDA cores.
//
// No TPU kernel: the reference's mamba_scan Pallas kernel
// (src/repro/kernels/mamba_scan.py) has no backward, and its model trains
// through a jnp chunked scan that jax.grad differentiates
// (src/repro/models/layers.py, _ssm_chunked_scan).  The port's forward is
// the exact recurrence in a kernel, so its gradient is a kernel too.  With
// a_t = exp(delta_t A) and g_t the gradient of the state h_t, from the last
// step back (g past the last step is dh_last, or 0):
//
//   g_t      = dy_t C_t + a_{t+1} g_{t+1}
//   dC_t     = sum_d dy_t h_t             dB_t     = sum_d g_t (delta_t x_t)
//   dx_t     = delta_t sum_n g_t B_t      ddelta_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
//   dA       = sum_{b, t} g_t a_t h_{t-1} delta_t
//
// Bounds.  Bytes: delta, x, dy, ddelta and dx at [B, L, D], B, C, dB and dC
// at [B, L, N], A, dA and dh_last (0.23 ms at zamba2-2.7b's training shape
// [2, 4096, 5120], N = 64, bf16 operands).  Exponentials: B L D N at 16 a
// clock an SM (0.64 ms there).  A (channel, state) pair has a decay of its
// own (A is [D, N]), so there is no product for the tensor cores; above
// both bounds sits the issue rate of about 30 FP32 operations a state and
// step, each rounded on its own.  The design issues little else:
//
//  1. One exponential and one recurrence a state and step.  Under grad the
//     forward keeps the state before every kBwdSub-th step (mamba_scan.cu,
//     kSaveEvery = kBwdSub).  The CTA walks its sub-blocks of kBwdSub steps
//     from the last; each refills its states and decays into registers from
//     its saved state, step by step (h_{t-1} is never got from
//     (h_t - b_t) / a_t: a_t underflows where the decay is strong), then
//     runs g back through them.  The refill rounds as the forward does
//     (expf, no fused multiply-add), so its states are the forward's bit for
//     bit.
//  2. Operands staged once.  A ring of kBwdStages landing slots takes each
//     sub-block's delta, dy, x, B and C and its saved states by cp.async,
//     kBwdStages - 1 sub-blocks ahead; the threads that copied a group
//     convert it once into f32 buffers: (delta, delta * x, dy, x) a (step,
//     channel), (B, C) pairs a (step, state) in the forward's lane order.
//     (Bulk copies of whole sub-blocks by the copy engine ran slower.)
//  3. Few shuffles and registers.  A lane keeps the ddelta and dx partial
//     sums (its S states in order) of half a sub-block's steps, and the
//     channel's lanes add them by a reduce-scatter butterfly: at each xor
//     mask, adjacent lanes first, a lane keeps half of what it holds and
//     adds its partner's copy of that half, so 8 sums take 8 shuffles over
//     16 lanes (a butterfly of each takes 32) and each lane writes the sums
//     it ends with.  dC (in the refill) and dB (in g's pass) go over the
//     warp's channels the same way, a step at a time.  ddelta's x B term is
//     x times dx's sum, a multiply a lane and step and not a state and step.
//  4. (dB, dC) summed on chip.  The CTAs along D run as thread-block
//     clusters of up to kBwdCluster.  A sub-block's (dB, dC) tile is the
//     warps' tiles added in warp order, then, through distributed shared
//     memory, the cluster's CTAs' tiles added in rank order: each CTA
//     stores each float4 of its tile into the shared memory of the rank
//     that adds it (a store does not wait, a load would), and that rank
//     adds the shares in rank order and writes one partial [B, L, clusters,
//     N] a cluster.  A second launch (mamba_bwd_partials_sum) adds the
//     clusters in order, and dA's partials [B, D, N] over the batch in
//     order.  Two buffers of each kind alternate, so one CTA barrier and
//     one cluster barrier a sub-block order them.  No CTA exits while a
//     peer may still store into it.
//  5. Waves.  kBwdThreads-thread CTAs, kBwdCtas an SM (128 registers a
//     thread), so the busiest SM holds at most 5% more CTAs than the mean at
//     both training shapes (640 CTAs at zamba2-2.7b's, 512 at
//     falcon-mamba-7b's).  A cluster's CTAs must share a GPC, which leaves
//     CTA slots empty: an H100 holds 30 clusters of 8 (240 of 264 slots) but
//     132 of 2.  kernels/mamba_scan.py::plan_bwd takes the largest cluster,
//     up to kBwdCluster, that needs the fewest rounds of the clusters the
//     card holds at once (dex_mamba_scan_bwd_active_clusters asks it).
//
// Every sum runs in a fixed order without atomics, so two launches are
// bit-equal, and every operation rounds on its own (__fmul_rn / __fadd_rn),
// so kernels/mamba_scan.py::lane_scan_bwd mirrors the kernel in torch.
//
// Tails: channels past D (in a CTA, or whole CTAs that fill the last
// cluster) and states past N hold zeros and add zeros.  The steps past L in
// the last sub-block are zero-filled, which makes each an identity of the
// recurrence (a = 1, nothing added), so dh_last enters at step L - 1; their
// outputs are not written.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mamba_scan.cuh"

namespace cg = cooperative_groups;

namespace {

// The backward's constants; kernels/mamba_scan.py mirrors these, and
// tests/test_torch_mamba_bwd.py reads them from here.
constexpr int kBwdSub = 8;        // steps a sub-block, held in registers: the forward's kSaveEvery
constexpr int kBwdThreads = 256;  // threads a CTA
constexpr int kBwdCtas = 2;       // fewest CTAs an SM: 128 registers a thread
constexpr int kBwdCluster = 8;    // most CTAs a cluster along D
constexpr int kBwdStages = 3;     // landing slots: sub-blocks in flight
constexpr int kBwdMaxState = 64;
constexpr int kBwdSmemLimit = 232448;  // shared bytes a CTA may use (H100)
constexpr int kSumThreads = 256;       // threads a CTA of the second launch
static_assert(kBwdStages >= 2, "a ring of at least two slots");

// Byte offsets of the dynamic shared memory (kernels/mamba_scan.py::
// smem_bytes_bwd): kBwdStages landing slots, each a sub-block's delta and dy
// (f32) and x [kBwdSub][ch], B and C [kBwdSub][np], and its saved states
// [ch][n] f32 (room for [ch][np]), each part rounded up to 16 bytes; two f32
// buffers, each (delta, delta * x, dy, x) [kBwdSub][ch] float4 then (B, C)
// [kBwdSub][np] float2; two of each warp's (dB, dC) tiles [kBwdSub][2][np]
// f32, and two buffers of the shares of a CTA tile the ranks store here (a
// tile and kBwdCluster float4s: each rank's share rounded up).
struct BwdLayout {
  int dy_off, x_off, b_off, c_off, st_off, slot, buf, bc_off, buf_bytes, wtile, recv, total;
};

BwdLayout bwd_layout(int ch, int np, int item) {
  BwdLayout o;
  o.dy_off = r16(kBwdSub * ch * 4);
  o.x_off = o.dy_off + r16(kBwdSub * ch * 4);
  o.b_off = o.x_off + r16(kBwdSub * ch * item);
  o.c_off = o.b_off + r16(kBwdSub * np * item);
  o.st_off = o.c_off + r16(kBwdSub * np * item);
  o.slot = o.st_off + r16(ch * np * 4);
  o.buf = kBwdStages * o.slot;
  o.bc_off = kBwdSub * ch * 16;
  o.buf_bytes = o.bc_off + kBwdSub * np * 8;
  const int tile = kBwdSub * 2 * np * 4;
  o.wtile = o.buf + 2 * o.buf_bytes;
  o.recv = o.wtile + 2 * (kBwdThreads / 32) * tile;
  o.total = o.recv + 2 * (tile + 16 * kBwdCluster);
  return o;
}

struct BwdParams {
  const float* delta;
  const float* a;
  const void* bmat;
  const void* cmat;
  const void* x;
  const float* dy;
  const float* dh_last;  // [b, d, n], or null
  const float* saved;    // [b, saves, d, n]: the forward's states
  float* ddelta;
  float* dx;
  float* da_part;  // [b, d, n]
  float* db_part;  // [b, l, clusters, n]
  float* dc_part;
  int l, d, n, clusters, saves;
  bool vec_dx, vec_bc, vec_st;  // 4-element copies for delta, dy and x, for B and C, for states
  BwdLayout lay;
};

// The values a lane holds after reduce_lanes<H, M, MEnd>: H halved at each
// mask while a reduce-scatter can split them.
template <int H, int M, int MEnd>
__host__ __device__ constexpr int kept() {
  if constexpr (M >= MEnd) {
    return H;
  } else {
    return kept<(H > 1) ? H / 2 : H, 2 * M, MEnd>();
  }
}

// Sums v[0..H) over the lanes that differ in the bits of the xor masks M,
// 2 M, ... below MEnd, adjacent lanes first (so each sum is the tree that
// kernels/mamba_scan.py::_tree takes).  A reduce-scatter: at each mask a
// lane keeps the upper half of what it holds where its lane has the mask's
// bit, else the lower, and adds its partner's copy of that half; once it
// holds one value, the masks left are a butterfly.  The lane ends with the
// sums of values [base, base + kept<H, M, MEnd>()) in v[0..), and returns
// base.
template <int H, int M, int MEnd, int V>
__device__ __forceinline__ int reduce_lanes(float (&v)[V], int lane) {
  if constexpr (M >= MEnd) {
    return 0;
  } else if constexpr (H > 1) {
    constexpr int kH = H / 2;
    const bool up = (lane & M) != 0;
#pragma unroll
    for (int i = 0; i < kH; ++i) {
      const float send = up ? v[i] : v[i + kH];
      const float keep = up ? v[i + kH] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, M));
    }
    return (up ? kH : 0) + reduce_lanes<kH, 2 * M, MEnd>(v, lane);
  } else {
#pragma unroll
    for (int i = 0; i < H; ++i) v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], M));
    return reduce_lanes<H, 2 * M, MEnd>(v, lane);
  }
}

// K consecutive floats of v to p (aligned to K floats).
template <int K, int V>
__device__ __forceinline__ void store_run(float* p, const float (&v)[V]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = v[i];
  }
}

// One quantity's S values a lane of a step, its states from `at` in a row
// of the warp's tile, summed over the warp's channels into it.
template <int S, int LPC>
__device__ __forceinline__ void channel_sums(float (&v)[S], float* at, int lane) {
  constexpr int kKept = kept<S, LPC, 32>();
  const int base = reduce_lanes<S, LPC, 32>(v, lane);
  // a lane whose channel bits above the split ones are set holds a copy
  if ((lane / LPC) * kKept / S == 0) store_run<kKept>(at + base, v);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// A sub-block of a lane (the kernel's design, items 1 and 3): from the
// state h0 before it, the refill and g's pass back through it, with the
// operands of buffer dd and bc; (dB, dC) summed over the warp's channels to
// the warp's tile wt, ddelta and dx written.  The pointers do not overlap.
template <int S, int LPC>
__device__ __forceinline__ void sub_block(const float4* __restrict__ dd,
                                          const float2* __restrict__ bc, float* __restrict__ wt,
                                          float* __restrict__ ddelta, float* __restrict__ dx,
                                          const float (&h0)[S], const float (&am)[S],
                                          float (&carry)[S], float (&da)[S], int cl, int j,
                                          int lane, int c, int d, int l, int t0, int64_t row0) {
  constexpr int kNP = S * LPC;
  constexpr int kCh = kBwdThreads / LPC;
  constexpr int kHalf = kBwdSub / 2;  // steps whose ddelta and dx are summed at once
  // the refill: a_t and a_t h_{t-1} a step; dC_t = dy_t h_t to the tile
  float ap[kBwdSub][S], ah[kBwdSub][S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) h[s] = h0[s];
#pragma unroll
  for (int r = 0; r < kBwdSub; ++r) {
    const float4 o = dd[r * kCh + cl];  // delta, delta * x, dy, x
    float bv[S], cv[S], dc[S];
    load_bc<S, LPC>(bc, r, j, bv, cv);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ap[r][s] = expf(__fmul_rn(o.x, am[s]));
      ah[r][s] = __fmul_rn(ap[r][s], h[s]);
      h[s] = __fadd_rn(ah[r][s], __fmul_rn(o.y, bv[s]));
      dc[s] = __fmul_rn(o.z, h[s]);
    }
    channel_sums<S, LPC>(dc, wt + (2 * r + 1) * kNP + j * S, lane);
  }
  // g back through the sub-block, a half of kHalf steps at a time; dB to
  // the tile; a lane's ddelta and dx terms of the half's steps summed over
  // the channel's lanes at the half's end.  ddelta_t = sum_n g A a h +
  // x_t sum_n g B, whose second sum is dx's.
#pragma unroll
  for (int half = 1; half >= 0; --half) {
    float sums[2 * kHalf];  // ddelta's terms of the half's steps, then dx's
#pragma unroll
    for (int rr = kHalf - 1; rr >= 0; --rr) {
      const int r = half * kHalf + rr;
      const float4 o = dd[r * kCh + cl];
      float bv[S], cv[S], db[S];
      load_bc<S, LPC>(bc, r, j, bv, cv);
      float sdd = 0.f, sdx = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float g = __fadd_rn(__fmul_rn(o.z, cv[s]), carry[s]);
        db[s] = __fmul_rn(g, o.y);
        const float gah = __fmul_rn(g, ah[r][s]);
        da[s] = __fadd_rn(da[s], __fmul_rn(gah, o.x));
        const float tdd = __fmul_rn(gah, am[s]);
        const float tdx = __fmul_rn(g, bv[s]);
        sdd = s == 0 ? tdd : __fadd_rn(sdd, tdd);
        sdx = s == 0 ? tdx : __fadd_rn(sdx, tdx);
        carry[s] = __fmul_rn(ap[r][s], g);
      }
      sums[rr] = __fadd_rn(sdd, __fmul_rn(o.w, sdx));
      sums[kHalf + rr] = sdx;
      channel_sums<S, LPC>(db, wt + 2 * r * kNP + j * S, lane);
    }
    constexpr int kKept = kept<2 * kHalf, 1, LPC>();
    const int base = reduce_lanes<2 * kHalf, 1, LPC>(sums, lane);
    if (c < d && j * kKept / (2 * kHalf) == 0) {  // the lanes without a copy
#pragma unroll
      for (int u = 0; u < kKept; ++u) {
        const int v = base + u, r = half * kHalf + v % kHalf, t = t0 + r;
        if (t < l) {
          const int64_t o = (row0 + t) * d + c;
          if (v < kHalf) {
            ddelta[o] = sums[u];
          } else {
            dx[o] = __fmul_rn(dd[r * kCh + cl].x, sums[u]);
          }
        }
      }
    }
  }
}

template <typename T, int S, int LPC>
__global__ void __launch_bounds__(kBwdThreads, kBwdCtas)
    mamba_scan_bwd_kernel(const BwdParams p) {
  constexpr int kNP = S * LPC;            // padded state width
  constexpr int kCPW = 32 / LPC;          // channels a warp
  constexpr int kCh = kBwdThreads / LPC;  // channels a CTA
  constexpr int kWarps = kBwdThreads / 32;
  constexpr int kTile = kBwdSub * 2 * kNP;  // floats of a (dB, dC) tile
  static_assert(kNP <= kBwdMaxState && kCPW >= 2, "at most 64 states, 16 lanes a channel");
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout& lay = p.lay;
  const int l = p.l, d = p.d, n = p.n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cl = warp * kCPW + lane / LPC;  // channel within the CTA
  const int j = lane % LPC;                 // lane within the channel
  const int c0 = blockIdx.x * kCh;
  const int c = c0 + cl;
  const int live_ch = min(kCh, d - c0);  // <= 0 in a CTA that fills the last cluster
  const int bi = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(bi) * l;
  const T* x = static_cast<const T*>(p.x);
  const T* bmat = static_cast<const T*>(p.bmat);
  const T* cmat = static_cast<const T*>(p.cmat);
  const cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / ranks;

  // A, the gradient carried into the step before (a_{t+1} g_{t+1}), dA's sum
  float am[S], carry[S], da[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = j * S + s;
    const bool live = c < d && k < n;
    am[s] = live ? p.a[static_cast<int64_t>(c) * n + k] : 0.f;
    carry[s] = live && p.dh_last != nullptr
                   ? p.dh_last[(static_cast<int64_t>(bi) * d + c) * n + k]
                   : 0.f;
    da[s] = 0.f;
  }

  // Sub-block i of the walk is steps [8 q, 8 q + 8), q = subs - 1 - i.  A
  // thread copies, and converts, its own four-element groups of it:
  // (step, channel) groups of [kBwdSub][ch] and (step, state) groups of
  // [kBwdSub][np]; the saved states, which other threads read, are used
  // after the barrier that follows the copying thread's wait.
  const int subs = (l + kBwdSub - 1) / kBwdSub;
  const int cc_d = 4 * tid % kCh, t_d = 4 * tid / kCh;
  const int k_b = 4 * tid % kNP, t_b = 4 * tid / kNP;
  auto slot_of = [&](int i) { return smem + (i % kBwdStages) * lay.slot; };
  auto issue = [&](int i) {  // sub-block i -> slot i % kBwdStages
    if (i < subs) {
      unsigned char* slot = slot_of(i);
      const int t0 = (subs - 1 - i) * kBwdSub, live = min(kBwdSub, l - t0);
      if (t_d < kBwdSub) {
        const int e = t_d * kCh + cc_d, lv = t_d < live ? max(0, min(4, live_ch - cc_d)) : 0;
        const int64_t g = (row0 + t0 + t_d) * d + c0 + cc_d;
        copy4(reinterpret_cast<float*>(slot) + e, p.delta + g, p.delta, p.vec_dx, lv);
        copy4(reinterpret_cast<float*>(slot + lay.dy_off) + e, p.dy + g, p.dy, p.vec_dx, lv);
        copy4(reinterpret_cast<T*>(slot + lay.x_off) + e, x + g, x, p.vec_dx, lv);
      }
      if (t_b < kBwdSub) {
        const int e = t_b * kNP + k_b, lv = t_b < live ? max(0, min(4, n - k_b)) : 0;
        const int64_t g = (row0 + t0 + t_b) * n + k_b;
        copy4(reinterpret_cast<T*>(slot + lay.b_off) + e, bmat + g, bmat, p.vec_bc, lv);
        copy4(reinterpret_cast<T*>(slot + lay.c_off) + e, cmat + g, cmat, p.vec_bc, lv);
      }
      float* st = reinterpret_cast<float*>(slot + lay.st_off);  // the state kept before it
      const int64_t gs = ((static_cast<int64_t>(bi) * p.saves + subs - 1 - i) * d + c0) * n;
      const int len = max(0, live_ch) * n;
      for (int e = 4 * tid; e < kCh * n; e += 4 * kBwdThreads) {
        copy4(st + e, p.saved + gs + e, p.saved, p.vec_st, max(0, min(4, len - e)));
      }
    }
    cp_async_commit();
  };
  auto buf_of = [&](int i) { return smem + lay.buf + (i % 2) * lay.buf_bytes; };
  auto convert = [&](int i) {  // slot i -> f32 buffer i % 2
    if (i >= subs) return;
    const unsigned char* slot = slot_of(i);
    unsigned char* buf = buf_of(i);
    if (t_d < kBwdSub) {
      const int e = t_d * kCh + cc_d;
      const float4 dt = load4(reinterpret_cast<const float*>(slot) + e);
      const float4 gy = load4(reinterpret_cast<const float*>(slot + lay.dy_off) + e);
      const float4 xv = load4(reinterpret_cast<const T*>(slot + lay.x_off) + e);
      float4* dd = reinterpret_cast<float4*>(buf) + e;
      dd[0] = make_float4(dt.x, __fmul_rn(dt.x, xv.x), gy.x, xv.x);
      dd[1] = make_float4(dt.y, __fmul_rn(dt.y, xv.y), gy.y, xv.y);
      dd[2] = make_float4(dt.z, __fmul_rn(dt.z, xv.z), gy.z, xv.z);
      dd[3] = make_float4(dt.w, __fmul_rn(dt.w, xv.w), gy.w, xv.w);
    }
    if (t_b < kBwdSub) {
      const int e = t_b * kNP + k_b;
      const float4 bv = load4(reinterpret_cast<const T*>(slot + lay.b_off) + e);
      const float4 cv = load4(reinterpret_cast<const T*>(slot + lay.c_off) + e);
      float4* bc = reinterpret_cast<float4*>(buf + lay.bc_off);
      const int lo = S == 1 ? e / 2 : bc_slot<S, LPC>(t_b, k_b);
      const int hi = S == 1 ? e / 2 + 1 : bc_slot<S, LPC>(t_b, k_b + 2);
      bc[lo] = make_float4(bv.x, cv.x, bv.y, cv.y);
      bc[hi] = make_float4(bv.z, cv.z, bv.w, cv.w);
    }
  };
  auto wtile_of = [&](int i) {
    return reinterpret_cast<float*>(smem + lay.wtile) + (i % 2) * kWarps * kTile;
  };
  // Sub-block i's CTA tiles, pushed by every rank into the rank that adds
  // them: float4 g of the tile belongs to rank g % ranks, which holds each
  // rank's share in a run of `per` float4s.
  const int per = (kTile / 4 + ranks - 1) / ranks;
  auto recv_of = [&](int i) {
    return reinterpret_cast<float4*>(smem + lay.recv) + (i % 2) * (kTile / 4 + kBwdCluster);
  };

  // The sub-block's recurrence and gradients; its (dB, dC) sums over the
  // warp's channels to the warp's tile.
  auto compute = [&](int i) {
    const int t0 = (subs - 1 - i) * kBwdSub;
    const unsigned char* buf = buf_of(i);
    const float4* dd = reinterpret_cast<const float4*>(buf);
    const float2* bc = reinterpret_cast<const float2*>(buf + lay.bc_off);
    float* wt = wtile_of(i) + warp * kTile;
    float h[S];
    const float* st = reinterpret_cast<const float*>(slot_of(i) + lay.st_off) + cl * n + j * S;
    if constexpr (S == 4) {
      if (n % 4 == 0) {
        const float4 v =
            j * S < n ? *reinterpret_cast<const float4*>(st) : make_float4(0.f, 0.f, 0.f, 0.f);
        h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) h[s] = j * S + s < n ? st[s] : 0.f;
      }
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) h[s] = j * S + s < n ? st[s] : 0.f;
    }

    sub_block<S, LPC>(dd, bc, wt, p.ddelta, p.dx, h, am, carry, da, cl, j, lane, c, d, l, t0,
                      row0);
  };
  // Sub-block i's warp tiles added in warp order; each float4 of the
  // CTA's sum stored into the shared memory of the rank that adds it.
  auto cta_sum = [&](int i) {
    const float4* wt = reinterpret_cast<const float4*>(wtile_of(i));
    float4* recv = recv_of(i);
    for (int g = tid; g < kTile / 4; g += kBwdThreads) {
      float4 acc = wt[g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) acc = add4(acc, wt[w * (kTile / 4) + g]);
      cluster.map_shared_rank(recv, g % ranks)[rank * per + g / ranks] = acc;
    }
  };
  // Sub-block i's float4s of this rank: the ranks' shares added in rank
  // order, into the cluster's partial.
  auto cluster_sum = [&](int i) {
    const int t0 = (subs - 1 - i) * kBwdSub;
    const float4* recv = recv_of(i);
    for (int u = tid; u < per && rank + u * ranks < kTile / 4; u += kBwdThreads) {
      const int g = rank + u * ranks;
      float4 acc = recv[u];
      for (int q = 1; q < ranks; ++q) acc = add4(acc, recv[q * per + u]);
      const int o = 4 * g, r = o / (2 * kNP), k0 = o % kNP, t = t0 + r;
      if (t < l && k0 < n) {
        float* part = (o / kNP) % 2 ? p.dc_part : p.db_part;
        float* dst = part + ((row0 + t) * p.clusters + cid) * n + k0;
        if (n % 4 == 0) {
          *reinterpret_cast<float4*>(dst) = acc;
        } else {
          const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k0 + e < n) dst[e] = v[e];
          }
        }
      }
    }
  };

  // Iteration i: after the CTA barrier and the cluster's wait, this rank
  // adds its float4s of sub-block i - 2 and the CTA adds sub-block i - 1's
  // warp tiles, pushing the sums to their ranks; it arrives, refills slot
  // i - 1 with sub-block i + kBwdStages - 1, converts sub-block i + 1 and
  // computes sub-block i.  A rank's shares of sub-block i - 1 are read
  // after the next iteration's wait; the shares of i + 1 overwrite them
  // after the wait after that, which the reading rank's arrival precedes.
#pragma unroll 1
  for (int i = 0; i < kBwdStages - 1; ++i) issue(i);
  cp_async_wait<kBwdStages - 2>();
  convert(0);
  cluster_arrive();
#pragma unroll 1
  for (int i = 0; i < subs + 2; ++i) {
    __syncthreads();  // sub-block i converted and its states landed; i - 1's warp tiles written
    cluster_wait();   // every rank's shares of i - 2 stored; every CTA has started
    if (i >= 2) cluster_sum(i - 2);
    if (i >= 1 && i <= subs) cta_sum(i - 1);
    cluster_arrive();
    if (i < subs) {
      issue(i + kBwdStages - 1);
      cp_async_wait<kBwdStages - 2>();
      convert(i + 1);
      compute(i);
    }
  }
  cluster_wait();  // no peer stores into this CTA any more
  cp_async_wait<0>();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int kk = j * S + s;
    if (c < d && kk < n) p.da_part[(static_cast<int64_t>(bi) * d + c) * n + kk] = da[s];
  }
}

struct BwdSums {
  const float* db_part;
  const float* dc_part;
  const float* da_part;
  float* db;
  float* dc;
  float* da;
  int64_t rows;  // b * l
  int64_t dn;    // d * n
  int n, clusters, b;
};

// The second launch: dB and dC [b, l, n] as their clusters' partials added
// in cluster order, dA [d, n] as the batch elements' added in order.
__global__ void __launch_bounds__(kSumThreads) mamba_bwd_partials_sum(const BwdSums s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  const int64_t nbc = s.rows * s.n;
  if (i < nbc) {
    const int64_t row = i / s.n, k = i % s.n;
    const int64_t base = row * s.clusters * s.n + k;
    float sb = s.db_part[base], sc = s.dc_part[base];
    for (int q = 1; q < s.clusters; ++q) {
      sb = __fadd_rn(sb, s.db_part[base + static_cast<int64_t>(q) * s.n]);
      sc = __fadd_rn(sc, s.dc_part[base + static_cast<int64_t>(q) * s.n]);
    }
    s.db[i] = sb;
    s.dc[i] = sc;
  } else if (i < nbc + s.dn) {
    const int64_t e = i - nbc;
    float sa = s.da_part[e];
    for (int q = 1; q < s.b; ++q) sa = __fadd_rn(sa, s.da_part[q * s.dn + e]);
    s.da[e] = sa;
  }
}

struct BwdArgs {
  BwdParams p;
  int b, cluster;
  cudaStream_t stream;
};

// A launch's configuration: a cluster of `cluster` CTAs along D.
struct BwdConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  BwdConfig(int grid_x, int grid_y, int cluster, int smem, cudaStream_t stream) : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(grid_x, grid_y);
    cfg.blockDim = dim3(kBwdThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename K>
cudaError_t prepare(K* kernel, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kBwdSmemLimit);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// Every (states a lane, threads a channel) pair plan_bwd may name: the
// forward's with at most 4 states a lane and at least 4 lanes a channel (at
// fewer, a warp holds more than 8 channels and a CTA stages more than
// fits); kernels/mamba_scan.py::BWD_INSTANTIATED lists the same.  `f` gets
// the kernel of the pair.
#define DEX_MAMBA_BWD_PLAN(S, LPC) \
  if (states == S && lanes == LPC) return f(mamba_scan_bwd_kernel<T, S, LPC>);

template <typename T, typename F>
cudaError_t with_kernel(int states, int lanes, F&& f) {
  DEX_MAMBA_BWD_PLAN(1, 4)
  DEX_MAMBA_BWD_PLAN(1, 8)
  DEX_MAMBA_BWD_PLAN(1, 16)
  DEX_MAMBA_BWD_PLAN(2, 4)
  DEX_MAMBA_BWD_PLAN(2, 8)
  DEX_MAMBA_BWD_PLAN(2, 16)
  DEX_MAMBA_BWD_PLAN(4, 4)
  DEX_MAMBA_BWD_PLAN(4, 8)
  DEX_MAMBA_BWD_PLAN(4, 16)
  return cudaErrorInvalidValue;
}
#undef DEX_MAMBA_BWD_PLAN

template <typename F>
cudaError_t with_kernel(int dtype, int states, int lanes, F&& f) {
  return dtype == 0 ? with_kernel<float>(states, lanes, f)
                    : with_kernel<__nv_bfloat16>(states, lanes, f);
}

// The clusters along D: CTAs of ch channels, as few clusters of at most
// `most` CTAs as cover them, all of one size (the last may hold CTAs with no
// live channel).  Returns the cluster size; *clusters their count.
int bwd_clusters(int d, int ch, int most, int* clusters) {
  const int blocks = (d + ch - 1) / ch;
  *clusters = (blocks + most - 1) / most;
  return (blocks + *clusters - 1) / *clusters;
}

bool valid_pair(int dtype, int n, int lanes, int states) {
  return n >= 1 && n <= kBwdMaxState && lanes >= 4 && lanes <= 16 && states >= 1 &&
         lanes * states >= n && (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype (of bmat, cmat and x): 0 = float32, 1 = bfloat16.  The forward's
// operands (delta, x [b, l, d]; a [d, n]; bmat, cmat [b, l, n]), dy [b, l,
// d], dh_last [b, d, n] or null, and saved [b, ceil(l / kBwdSub), d, n],
// the forward's states (mamba_scan.cu); out: ddelta, dx [b, l, d], da [d,
// n], db, dc [b, l, n], and the scratch da_part [b, d, n], db_part and
// dc_part [b, l, clusters, n]; all but x, bmat and cmat float32.  The plan
// (kernels/mamba_scan.py::plan_bwd): lanes threads a channel with states
// states each, the dynamic shared bytes they take, and clusters of at most
// `most` CTAs along D, `clusters` of them, which this entry recomputes.  A
// plan it has no kernel for, or that does not fit, is refused with
// cudaErrorInvalidValue and launches nothing.
extern "C" int dex_mamba_scan_bwd(const void* delta, const void* a, const void* bmat,
                                  const void* cmat, const void* x, const void* dy,
                                  const void* dh_last, const void* saved, void* ddelta, void* da,
                                  void* db, void* dc, void* dx, void* da_part, void* db_part,
                                  void* dc_part, int dtype, int b, int l, int d, int n, int lanes,
                                  int states, int smem_bytes, int most, int clusters,
                                  void* stream) {
  if (!valid_pair(dtype, n, lanes, states) || l < 0 || b < 1 || d < 1 || most < 1 ||
      most > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int item = dtype == 0 ? 4 : 2;
  const int ch = kBwdThreads / lanes;
  const BwdLayout lay = bwd_layout(ch, lanes * states, item);
  int ours = 0;
  const int cluster = bwd_clusters(d, ch, most, &ours);
  if (lay.total != smem_bytes || lay.total > kBwdSmemLimit || ours != clusters) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs g;
  g.p = BwdParams{static_cast<const float*>(delta),
                  static_cast<const float*>(a),
                  bmat,
                  cmat,
                  x,
                  static_cast<const float*>(dy),
                  static_cast<const float*>(dh_last),
                  static_cast<const float*>(saved),
                  static_cast<float*>(ddelta),
                  static_cast<float*>(dx),
                  static_cast<float*>(da_part),
                  static_cast<float*>(db_part),
                  static_cast<float*>(dc_part),
                  l,
                  d,
                  n,
                  clusters,
                  (l + kBwdSub - 1) / kBwdSub,
                  d % 4 == 0 && aligned(delta, 16) && aligned(dy, 16) && aligned(x, 4 * item),
                  n % 4 == 0 && aligned(bmat, 4 * item) && aligned(cmat, 4 * item),
                  n % 4 == 0 && aligned(saved, 16),
                  lay};
  g.b = b;
  g.cluster = cluster;
  g.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_kernel(dtype, states, lanes, [&](auto* kernel) {
    cudaError_t e = prepare(kernel, g.cluster);
    if (e != cudaSuccess) return e;
    BwdConfig c(g.p.clusters * g.cluster, g.b, g.cluster, g.p.lay.total, g.stream);
    return cudaLaunchKernelEx(&c.cfg, kernel, g.p);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdSums s{static_cast<const float*>(db_part),
            static_cast<const float*>(dc_part),
            static_cast<const float*>(da_part),
            static_cast<float*>(db),
            static_cast<float*>(dc),
            static_cast<float*>(da),
            static_cast<int64_t>(b) * l,
            static_cast<int64_t>(d) * n,
            n,
            clusters,
            b};
  const int64_t outs = s.rows * n + s.dn;
  mamba_bwd_partials_sum<<<static_cast<unsigned>((outs + kSumThreads - 1) / kSumThreads),
                           kSumThreads, 0, g.stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of `cluster` CTAs of the kernel for (dtype, lanes,
// states) that the card holds at once (cudaOccupancyMaxActiveClusters):
// kernels/mamba_scan.py::plan_bwd picks the cluster size by them.  A
// negative CUDA error on a refusal.
extern "C" int dex_mamba_scan_bwd_active_clusters(int dtype, int lanes, int states, int cluster) {
  if (!valid_pair(dtype, lanes * states, lanes, states) || cluster < 1 || cluster > 16) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int out = 0;
  const cudaError_t err = with_kernel(dtype, states, lanes, [&](auto* kernel) {
    cudaError_t e = prepare(kernel, cluster);
    if (e != cudaSuccess) return e;
    const BwdLayout lay = bwd_layout(kBwdThreads / lanes, lanes * states, dtype == 0 ? 4 : 2);
    BwdConfig c(cluster * 64, 1, cluster, lay.total, nullptr);
    return cudaOccupancyMaxActiveClusters(&out, kernel, &c.cfg);
  });
  return err == cudaSuccess ? out : -static_cast<int>(err);
}
