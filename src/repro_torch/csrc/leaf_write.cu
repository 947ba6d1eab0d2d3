// leaf_write: staged updates and inserts applied to sorted leaf rows on Hopper.
//
// Replaces the TPU kernel leaf_write in src/repro/kernels/leaf_write.py,
// which computed every rank with a one-hot [B, S, F] compare over (hi, lo)
// int32 planes.  Here keys are int64 and one warp owns one row: lane i holds
// row slots 2i and 2i+1 and staged entries 2i and 2i+1 (16-byte loads).
//
//  1. updates: the warp loops over the active staged updates (a ballot of
//     slot >= 0); each is broadcast and the lane owning its slot takes the
//     value (several updates of one slot add up, as the plain version does);
//  2. inserts: the warp loops over the active staged keys; for each, two
//     ballots count the row keys below it, and every lane counts it against
//     its two row keys.  A row key's output column is its index plus the
//     active staged keys below it; a staged key's column is the active
//     staged keys before it plus the row keys below it;
//  3. each element is written to its column in a per-warp shared-memory row
//     that starts as padding (KEY_MAX, value 0), then the warp stores the
//     row with coalesced 16-byte stores; occupancy is the count of
//     non-KEY_MAX outputs.
//
// Bound: bytes.  A row needs its key and value planes read and written once;
// the loops run once per active staged entry, a few instructions each.  See
// src/repro_torch/kernels/leaf_write.py.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFanout = 64;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int64_t kKeyMax = INT64_MAX;

__device__ __forceinline__ int64_t shfl64(int64_t v, int src) {
  return static_cast<int64_t>(
      __shfl_sync(kFullMask, static_cast<long long>(v), src));
}

__global__ void leaf_write_kernel(const int64_t* __restrict__ rows_k,
                                  const int64_t* __restrict__ rows_v,
                                  const int32_t* __restrict__ upd_slot,
                                  const int64_t* __restrict__ upd_val,
                                  const int64_t* __restrict__ ins_key,
                                  const int64_t* __restrict__ ins_val,
                                  int64_t* __restrict__ out_k,
                                  int64_t* __restrict__ out_v,
                                  int32_t* __restrict__ occ, int64_t n) {
  __shared__ __align__(16) int64_t sk[kWarpsPerBlock][kFanout];
  __shared__ __align__(16) int64_t sv[kWarpsPerBlock][kFanout];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + w;
  if (r >= n) return;  // whole warp leaves together
  const int64_t base = r * kFanout;

  const longlong2 k = reinterpret_cast<const longlong2*>(rows_k + base)[lane];
  longlong2 v = reinterpret_cast<const longlong2*>(rows_v + base)[lane];
  const int2 us = reinterpret_cast<const int2*>(upd_slot + base)[lane];
  const longlong2 ik = reinterpret_cast<const longlong2*>(ins_key + base)[lane];

  // 1. updates
  const bool u0 = us.x >= 0 && us.x < kFanout;
  const bool u1 = us.y >= 0 && us.y < kFanout;
  const int64_t uv0 = u0 ? upd_val[base + 2 * lane] : 0;
  const int64_t uv1 = u1 ? upd_val[base + 2 * lane + 1] : 0;
  unsigned long long acc0 = 0, acc1 = 0;
  bool has0 = false, has1 = false;
  for (int half = 0; half < 2; ++half) {
    unsigned m = __ballot_sync(kFullMask, half ? u1 : u0);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const int slot = __shfl_sync(kFullMask, half ? us.y : us.x, src);
      const int64_t val = shfl64(half ? uv1 : uv0, src);
      if ((slot >> 1) == lane) {
        if (slot & 1) {
          acc1 += static_cast<unsigned long long>(val);
          has1 = true;
        } else {
          acc0 += static_cast<unsigned long long>(val);
          has0 = true;
        }
      }
    }
  }
  if (has0) v.x = static_cast<int64_t>(acc0);
  if (has1) v.y = static_cast<int64_t>(acc1);

  // 2. insert ranks
  const bool a0 = ik.x != kKeyMax;
  const bool a1 = ik.y != kKeyMax;
  const bool r0 = k.x != kKeyMax;
  const bool r1 = k.y != kKeyMax;
  const unsigned am0 = __ballot_sync(kFullMask, a0);
  const unsigned am1 = __ballot_sync(kFullMask, a1);
  const unsigned below = (1u << lane) - 1u;
  // active staged entries before 2*lane, and before 2*lane + 1
  const int before0 = __popc(am0 & below) + __popc(am1 & below);
  const int before1 = before0 + (a0 ? 1 : 0);
  int ins_below0 = 0, ins_below1 = 0;  // staged keys below my row keys
  int rank_i0 = kFanout, rank_i1 = kFanout;
  for (int half = 0; half < 2; ++half) {
    unsigned m = half ? am1 : am0;
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const int64_t s = shfl64(half ? ik.y : ik.x, src);
      ins_below0 += s < k.x;
      ins_below1 += s < k.y;
      const int row_below = __popc(__ballot_sync(kFullMask, r0 && k.x < s)) +
                            __popc(__ballot_sync(kFullMask, r1 && k.y < s));
      if (lane == src) {
        if (half) {
          rank_i1 = before1 + row_below;
        } else {
          rank_i0 = before0 + row_below;
        }
      }
    }
  }

  // 3. scatter into the warp's row in shared memory, then store it
  int64_t* wk = sk[w];
  int64_t* wv = sv[w];
  reinterpret_cast<longlong2*>(wk)[lane] = make_longlong2(kKeyMax, kKeyMax);
  reinterpret_cast<longlong2*>(wv)[lane] = make_longlong2(0, 0);
  __syncwarp();
  const int rank_r0 = 2 * lane + ins_below0;
  const int rank_r1 = 2 * lane + 1 + ins_below1;
  if (r0 && rank_r0 < kFanout) {
    wk[rank_r0] = k.x;
    wv[rank_r0] = v.x;
  }
  if (r1 && rank_r1 < kFanout) {
    wk[rank_r1] = k.y;
    wv[rank_r1] = v.y;
  }
  if (a0 && rank_i0 < kFanout) {
    wk[rank_i0] = ik.x;
    wv[rank_i0] = ins_val[base + 2 * lane];
  }
  if (a1 && rank_i1 < kFanout) {
    wk[rank_i1] = ik.y;
    wv[rank_i1] = ins_val[base + 2 * lane + 1];
  }
  __syncwarp();
  const longlong2 ok = reinterpret_cast<const longlong2*>(wk)[lane];
  const longlong2 ov = reinterpret_cast<const longlong2*>(wv)[lane];
  reinterpret_cast<longlong2*>(out_k + base)[lane] = ok;
  reinterpret_cast<longlong2*>(out_v + base)[lane] = ov;
  const int filled = __popc(__ballot_sync(kFullMask, ok.x != kKeyMax)) +
                     __popc(__ballot_sync(kFullMask, ok.y != kKeyMax));
  if (lane == 0) occ[r] = filled;
}

}  // namespace

extern "C" int dex_leaf_write(const int64_t* rows_k, const int64_t* rows_v,
                              const int32_t* upd_slot, const int64_t* upd_val,
                              const int64_t* ins_key, const int64_t* ins_val,
                              int64_t* out_k, int64_t* out_v, int32_t* occ,
                              int64_t n, cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    leaf_write_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                        stream>>>(rows_k, rows_v, upd_slot, upd_val, ins_key,
                                  ins_val, out_k, out_v, occ, n);
  }
  return static_cast<int>(cudaGetLastError());
}
