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
// at [B, L, N], A, dA, dh_last and the saved states (0.26 ms at zamba2-2.7b's
// training shape [2, 4096, 5120], N = 64, bf16 operands).  Exponentials:
// B L D N at 16 a clock an SM where each a_t is computed once (0.64 ms
// there).  This design computes each a_t 1.75 times (once to find the
// sub-blocks' states, once to refill a sub-block: 1 + (J - 1) / J at J = 4
// sub-blocks a chunk), and writes and reads back per-CTA partials of dB
// and dC.  A simple kernel that is right, first:
//
//  1. The forward's lane layout.  Every (channel, state) pair is a chain;
//     a channel's states sit in LPC adjacent lanes, S a lane, the pair the
//     forward's default plan picks at the shape (kernels/mamba_scan.py::
//     plan_bwd), and a CTA holds kBwdThreads / LPC channels of one batch
//     element.
//  2. Saved states, never an inverted recurrence.  Under grad the forward
//     writes the state before every kBwdChunk-th step (mamba_scan.cu,
//     kSaveEvery).  The CTA walks the chunks from the last.  While it works
//     on chunk k it stages chunk k - 1 (delta and dy in f32, x, B and C as
//     given) with cp.async into the other of two slots.  From chunk k's
//     saved state it steps the recurrence forward, keeping the state
//     before each sub-block of kBwdSub steps in shared memory; then, for
//     each sub-block from the last, it refills the sub-block's states and
//     decays (h_{t-1} and a_t a step) into registers and runs g back
//     through them.  h_{t-1} is never got from (h_t - b_t) / a_t: a_t
//     underflows where the decay is strong.  The recompute rounds as the
//     forward does (expf, no fused multiply-add), so its states are the
//     forward's bit for bit.
//  3. Sums in a fixed order, without atomics.  Over a channel's lanes
//     (ddelta, dx): a lane's S terms in order, then a butterfly of
//     shuffles.  Over channels (dB, dC): a butterfly across the warp's
//     channels, the warps' sums added in warp order into a per-CTA partial
//     [B, L, blocks, N], and a second launch (mamba_bwd_partials_sum) that
//     adds the blocks in order.  Over time and batch (dA): a thread's sum
//     from the last step back, a partial [B, D, N], the batch added in
//     order by the second launch.  Two launches are bit-equal.  Every
//     operation rounds on its own (__fmul_rn / __fadd_rn), so
//     kernels/mamba_scan.py::lane_scan_bwd mirrors the kernel in torch.
//
// Tails: channels past D and states past N hold zeros and add zeros.  The
// steps past L in the last chunk are zero-filled, which makes each an
// identity of the recurrence (a = 1, nothing added), so dh_last enters at
// step L - 1; their outputs are not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mamba_scan.cuh"

namespace {

// The backward's constants; kernels/mamba_scan.py mirrors these, and
// tests/test_torch_mamba_bwd.py reads them from here.
constexpr int kBwdChunk = 32;         // steps a chunk: the forward's kSaveEvery
constexpr int kBwdSub = 8;            // steps a sub-block, held in registers
constexpr int kBwdThreads = 512;      // threads a CTA
constexpr int kBwdCtas = 1;           // fewest CTAs an SM: 128 registers a thread
constexpr int kBwdMaxState = 64;
constexpr int kBwdSmemLimit = 232448;  // shared bytes a CTA may use (H100)
constexpr int kSumThreads = 256;       // threads a CTA of the second launch

// Byte offsets of the dynamic shared memory (kernels/mamba_scan.py::
// smem_bytes_bwd): two slots of a raw chunk (delta and dy f32, and x
// [kBwdChunk][ch]; B and C [kBwdChunk][np]; each part rounded up to 16
// bytes), the states before each sub-block [kBwdChunk / kBwdSub][S][threads]
// f32, and the warps' (dB, dC) tile [warps][kBwdSub][np] float2.
struct BwdLayout {
  int dy_off, x_off, b_off, c_off, slot, hb, tile, total;
};

BwdLayout bwd_layout(int ch, int np, int item) {
  BwdLayout o;
  o.dy_off = r16(kBwdChunk * ch * 4);
  o.x_off = o.dy_off + r16(kBwdChunk * ch * 4);
  o.b_off = o.x_off + r16(kBwdChunk * ch * item);
  o.c_off = o.b_off + r16(kBwdChunk * np * item);
  o.slot = o.c_off + r16(kBwdChunk * np * item);
  o.hb = 2 * o.slot;
  o.tile = o.hb + kBwdChunk / kBwdSub * ch * np * 4;
  o.total = o.tile + kBwdThreads / 32 * kBwdSub * np * 8;
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
  float* db_part;  // [b, l, blocks, n]
  float* dc_part;
  int l, d, n, blocks, saves;
  bool vec_dx, vec_bc;  // 4-element copies for delta, dy and x, for B and C
  BwdLayout lay;
};

// A lane's S consecutive states of a row of B or C, as f32.
template <int S, typename T>
__device__ __forceinline__ void load_states(const T* q, float (&v)[S]) {
  if constexpr (S == 4) {
    const float4 f = load4(q);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = to_f32(q[s]);
  }
}

template <typename T, int S, int LPC>
__global__ void __launch_bounds__(kBwdThreads, kBwdCtas)
    mamba_scan_bwd_kernel(const BwdParams p) {
  constexpr int kNP = S * LPC;          // padded state width
  constexpr int kCPW = 32 / LPC;        // channels a warp
  constexpr int kCh = kBwdThreads / LPC;  // channels a CTA
  constexpr int kWarps = kBwdThreads / 32;
  static_assert(kNP <= kBwdMaxState && kCPW >= 2, "at most 64 states, 16 lanes a channel");
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout& lay = p.lay;
  const int l = p.l, d = p.d, n = p.n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cl = warp * kCPW + lane / LPC;  // channel within the CTA
  const int j = lane % LPC;                 // lane within the channel
  const int c0 = blockIdx.x * kCh;
  const int c = c0 + cl;
  const int live_ch = min(kCh, d - c0);
  const int bi = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(bi) * l;
  const T* x = static_cast<const T*>(p.x);
  const T* bmat = static_cast<const T*>(p.bmat);
  const T* cmat = static_cast<const T*>(p.cmat);

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

  // A thread copies four-element groups of a chunk, as the forward's do:
  // (step, channel) groups of [kBwdChunk][ch] and (step, state) groups of
  // [kBwdChunk][np].
  const int cc_d = 4 * tid % kCh, t_d = 4 * tid / kCh;
  const int k_b = 4 * tid % kNP, t_b = 4 * tid / kNP;
  const int chunks = (l + kBwdChunk - 1) / kBwdChunk;
  auto issue = [&](int k) {  // raw chunk k -> slot k % 2
    if (k >= 0) {
      unsigned char* slot = smem + (k & 1) * lay.slot;
      float* rd = reinterpret_cast<float*>(slot);
      float* rg = reinterpret_cast<float*>(slot + lay.dy_off);
      T* rx = reinterpret_cast<T*>(slot + lay.x_off);
      T* rb = reinterpret_cast<T*>(slot + lay.b_off);
      T* rc = reinterpret_cast<T*>(slot + lay.c_off);
      const int t0 = k * kBwdChunk, live = min(kBwdChunk, l - t0);
      const int live_c = max(0, min(4, live_ch - cc_d));
      for (int t = t_d; t < kBwdChunk; t += 4 * LPC) {
        const int e = t * kCh + cc_d, lv = t < live ? live_c : 0;
        const int64_t g = (row0 + t0 + t) * d + c0 + cc_d;
        copy4(rd + e, p.delta + g, p.delta, p.vec_dx, lv);
        copy4(rg + e, p.dy + g, p.dy, p.vec_dx, lv);
        copy4(rx + e, x + g, x, p.vec_dx, lv);
      }
      const int live_k = max(0, min(4, n - k_b));
      for (int t = t_b; t < kBwdChunk; t += 4 * kBwdThreads / kNP) {
        const int e = t * kNP + k_b, lv = t < live ? live_k : 0;
        const int64_t g = (row0 + t0 + t) * n + k_b;
        copy4(rb + e, bmat + g, bmat, p.vec_bc, lv);
        copy4(rc + e, cmat + g, cmat, p.vec_bc, lv);
      }
    }
    cp_async_commit();
  };

  float* const hb = reinterpret_cast<float*>(smem + lay.hb);
  float2* const tile = reinterpret_cast<float2*>(smem + lay.tile);
  issue(chunks - 1);
#pragma unroll 1
  for (int k = chunks - 1; k >= 0; --k) {
    cp_async_wait<0>();
    __syncthreads();  // chunk k landed for every thread; chunk k + 1's slot read
    issue(k - 1);
    const unsigned char* slot = smem + (k & 1) * lay.slot;
    const float* rd = reinterpret_cast<const float*>(slot);
    const float* rg = reinterpret_cast<const float*>(slot + lay.dy_off);
    const T* rx = reinterpret_cast<const T*>(slot + lay.x_off);
    const T* rb = reinterpret_cast<const T*>(slot + lay.b_off);
    const T* rc = reinterpret_cast<const T*>(slot + lay.c_off);
    const int t0 = k * kBwdChunk, steps = min(kBwdChunk, l - t0);
    const int subs = (steps + kBwdSub - 1) / kBwdSub;

    // The recurrence from the chunk's saved state, keeping the state before
    // each sub-block.
    float h[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int kk = j * S + s;
      h[s] = c < d && kk < n
                 ? p.saved[((static_cast<int64_t>(bi) * p.saves + k) * d + c) * n + kk]
                 : 0.f;
    }
#pragma unroll 1
    for (int q = 0; q < subs; ++q) {
#pragma unroll
      for (int s = 0; s < S; ++s) hb[(q * S + s) * kBwdThreads + tid] = h[s];
      if (q + 1 == subs) break;
#pragma unroll
      for (int r = 0; r < kBwdSub; ++r) {
        const int t = q * kBwdSub + r;
        const float dt = rd[t * kCh + cl];
        const float dxt = __fmul_rn(dt, to_f32(rx[t * kCh + cl]));
        float bv[S];
        load_states<S>(rb + t * kNP + j * S, bv);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float decay = expf(__fmul_rn(dt, am[s]));
          h[s] = __fadd_rn(__fmul_rn(decay, h[s]), __fmul_rn(dxt, bv[s]));
        }
      }
    }

#pragma unroll 1
    for (int q = subs - 1; q >= 0; --q) {
      // the sub-block's h_{t-1} and a_t, step by step; h ends as h_t of its
      // last step
      float hp[kBwdSub][S], ap[kBwdSub][S];
#pragma unroll
      for (int s = 0; s < S; ++s) h[s] = hb[(q * S + s) * kBwdThreads + tid];
#pragma unroll
      for (int r = 0; r < kBwdSub; ++r) {
        const int t = q * kBwdSub + r;
        const float dt = rd[t * kCh + cl];
        const float dxt = __fmul_rn(dt, to_f32(rx[t * kCh + cl]));
        float bv[S];
        load_states<S>(rb + t * kNP + j * S, bv);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          hp[r][s] = h[s];
          ap[r][s] = expf(__fmul_rn(dt, am[s]));
          h[s] = __fadd_rn(__fmul_rn(ap[r][s], h[s]), __fmul_rn(dxt, bv[s]));
        }
      }
      // g back through the sub-block
#pragma unroll
      for (int r = kBwdSub - 1; r >= 0; --r) {
        const int t = q * kBwdSub + r;
        const float dt = rd[t * kCh + cl], dyt = rg[t * kCh + cl];
        const float xt = to_f32(rx[t * kCh + cl]);
        const float dxt = __fmul_rn(dt, xt);
        float bv[S], cv[S], db[S], dc[S];
        load_states<S>(rb + t * kNP + j * S, bv);
        load_states<S>(rc + t * kNP + j * S, cv);
        float sdd = 0.f, sdx = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float ht = r + 1 < kBwdSub ? hp[r + 1][s] : h[s];
          const float g = __fadd_rn(__fmul_rn(dyt, cv[s]), carry[s]);
          dc[s] = __fmul_rn(dyt, ht);
          db[s] = __fmul_rn(g, dxt);
          const float gah = __fmul_rn(g, __fmul_rn(ap[r][s], hp[r][s]));
          da[s] = __fadd_rn(da[s], __fmul_rn(gah, dt));
          const float tdd = __fadd_rn(__fmul_rn(gah, am[s]), __fmul_rn(g, __fmul_rn(xt, bv[s])));
          const float tdx = __fmul_rn(g, bv[s]);
          sdd = s == 0 ? tdd : __fadd_rn(sdd, tdd);
          sdx = s == 0 ? tdx : __fadd_rn(sdx, tdx);
          carry[s] = __fmul_rn(ap[r][s], g);
        }
        // ddelta and dx: the channel's lanes
#pragma unroll
        for (int m = 1; m < LPC; m <<= 1) {
          sdd = __fadd_rn(sdd, __shfl_xor_sync(0xffffffffu, sdd, m));
          sdx = __fadd_rn(sdx, __shfl_xor_sync(0xffffffffu, sdx, m));
        }
        if (j == 0 && c < d && t < steps) {
          const int64_t o = (row0 + t0 + t) * d + c;
          p.ddelta[o] = sdd;
          p.dx[o] = __fmul_rn(dt, sdx);
        }
        // dB and dC: the warp's channels, into the tile
#pragma unroll
        for (int s = 0; s < S; ++s) {
#pragma unroll
          for (int m = LPC; m < 32; m <<= 1) {
            db[s] = __fadd_rn(db[s], __shfl_xor_sync(0xffffffffu, db[s], m));
            dc[s] = __fadd_rn(dc[s], __shfl_xor_sync(0xffffffffu, dc[s], m));
          }
        }
        if (lane < LPC) {
          float2* row = tile + (warp * kBwdSub + r) * kNP + j * S;
#pragma unroll
          for (int s = 0; s < S; ++s) row[s] = make_float2(db[s], dc[s]);
        }
      }
      __syncthreads();  // every warp's sums of the sub-block in the tile
      for (int o = tid; o < kBwdSub * kNP; o += kBwdThreads) {
        const int r = o / kNP, kk = o % kNP, t = q * kBwdSub + r;
        float2 acc = tile[r * kNP + kk];
#pragma unroll 1
        for (int w = 1; w < kWarps; ++w) {
          const float2 v = tile[(w * kBwdSub + r) * kNP + kk];
          acc.x = __fadd_rn(acc.x, v.x);
          acc.y = __fadd_rn(acc.y, v.y);
        }
        if (t < steps && kk < n) {
          const int64_t i = ((row0 + t0 + t) * p.blocks + blockIdx.x) * n + kk;
          p.db_part[i] = acc.x;
          p.dc_part[i] = acc.y;
        }
      }
      __syncthreads();  // the tile read
    }
  }
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
  int n, blocks, b;
};

// The second launch: dB and dC [b, l, n] as their CTAs' partials added in
// block order, dA [d, n] as the batch elements' added in order.
__global__ void __launch_bounds__(kSumThreads) mamba_bwd_partials_sum(const BwdSums s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  const int64_t nbc = s.rows * s.n;
  if (i < nbc) {
    const int64_t row = i / s.n, k = i % s.n;
    const int64_t base = row * s.blocks * s.n + k;
    float sb = s.db_part[base], sc = s.dc_part[base];
    for (int q = 1; q < s.blocks; ++q) {
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
  int b, lanes, states;
  cudaStream_t stream;
};

template <typename T, int S, int LPC>
cudaError_t launch_bwd_plan(const BwdArgs& g) {
  auto* kernel = mamba_scan_bwd_kernel<T, S, LPC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kBwdSmemLimit);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid(g.p.blocks, g.b);
  kernel<<<grid, kBwdThreads, g.p.lay.total, g.stream>>>(g.p);
  return cudaGetLastError();
}

// Every (states a lane, threads a channel) pair plan_bwd may name: the
// forward's with at most 4 states a lane and at least 4 lanes a channel (at
// fewer, a CTA of 128-512 channels stages more than fits);
// kernels/mamba_scan.py::BWD_INSTANTIATED lists the same.
#define DEX_MAMBA_BWD_PLAN(S, LPC) \
  if (g.states == S && g.lanes == LPC) return launch_bwd_plan<T, S, LPC>(g);

template <typename T>
cudaError_t launch_bwd_t(const BwdArgs& g) {
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

}  // namespace

// dtype (of bmat, cmat and x): 0 = float32, 1 = bfloat16.  The forward's
// operands (delta, x [b, l, d]; a [d, n]; bmat, cmat [b, l, n]), dy [b, l,
// d], dh_last [b, d, n] or null, and saved [b, ceil(l / kBwdChunk), d, n],
// the forward's states (mamba_scan.cu); out: ddelta, dx [b, l, d], da [d,
// n], db, dc [b, l, n], and the scratch da_part [b, d, n], db_part and
// dc_part [b, l, ceil(d / (kBwdThreads / lanes)), n]; all but x, bmat and
// cmat float32.  The plan (kernels/mamba_scan.py::plan_bwd): lanes threads
// a channel with states states each, and the dynamic shared bytes they
// take, which this entry recomputes.  A plan it has no kernel for, or that
// does not fit, is refused with cudaErrorInvalidValue and launches nothing.
extern "C" int dex_mamba_scan_bwd(const void* delta, const void* a, const void* bmat,
                                  const void* cmat, const void* x, const void* dy,
                                  const void* dh_last, const void* saved, void* ddelta, void* da,
                                  void* db, void* dc, void* dx, void* da_part, void* db_part,
                                  void* dc_part, int dtype, int b, int l, int d, int n, int lanes,
                                  int states, int smem_bytes, void* stream) {
  if (n < 1 || n > kBwdMaxState || lanes < 4 || lanes > 16 || states < 1 ||
      lanes * states < n || (dtype != 0 && dtype != 1) || l < 0 || b < 1 || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int item = dtype == 0 ? 4 : 2;
  const int ch = kBwdThreads / lanes;
  const BwdLayout lay = bwd_layout(ch, lanes * states, item);
  if (lay.total != smem_bytes || lay.total > kBwdSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (d + ch - 1) / ch;
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
                  blocks,
                  (l + kBwdChunk - 1) / kBwdChunk,
                  d % 4 == 0 && aligned(delta, 16) && aligned(dy, 16) && aligned(x, 4 * item),
                  n % 4 == 0 && aligned(bmat, 4 * item) && aligned(cmat, 4 * item),
                  lay};
  g.b = b;
  g.lanes = lanes;
  g.states = states;
  g.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_bwd_t<float>(g) : launch_bwd_t<__nv_bfloat16>(g);
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
            blocks,
            b};
  const int64_t outs = s.rows * n + s.dn;
  mamba_bwd_partials_sum<<<static_cast<unsigned>((outs + kSumThreads - 1) / kSumThreads),
                           kSumThreads, 0, g.stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}
