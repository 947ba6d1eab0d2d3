// leaf_split: staged inserts merged into sorted leaf rows, a row cut in two
// where the merge overflows it, on Hopper.
//
// Replaces the TPU kernel leaf_split in src/repro/kernels/leaf_split.py,
// which ranked every element and placed every output column with one-hot
// [B, 2F, F] compares over (hi, lo) int32 planes.  Here keys are int64 and
// one warp owns one row: lane i holds row slots 2i and 2i+1 and staged
// entries 2i and 2i+1 (16-byte loads).
//
//  1. ranks: the warp loops over the active staged keys (a ballot of
//     key != KEY_MAX); for each, ballots count the row keys and the active
//     staged keys below it, and every lane counts it against its two row
//     keys.  A row key's merged position is its index plus the active staged
//     keys below it (rows are sorted); a staged key's position is the row
//     keys plus the active staged keys below it, so staged keys may come in
//     any order;
//  2. m = row keys + active staged keys and left_n = m > 64 ? m / 2 : m:
//     each element goes to the left row at its position, or to the right
//     row at position - left_n, in per-warp shared-memory rows that start as
//     padding (KEY_MAX, value 0);
//  3. the warp stores both rows with coalesced 16-byte stores (the right row
//     only where the row split, else it writes padding), then occ_l = left_n,
//     occ_r = m - left_n, sep (the right row's first key, else KEY_MAX) and
//     did_split.
//
// Bound: bytes.  A row's key and value planes are read once and the left
// row written once; a row that splits also writes its right row.  The loop
// runs once per active staged key, a few instructions each.  See
// src/repro_torch/kernels/leaf_split.py.
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

struct WarpRows {
  int64_t lk[kFanout];
  int64_t lv[kFanout];
  int64_t rk[kFanout];
  int64_t rv[kFanout];
};

__device__ __forceinline__ void place(WarpRows& s, int pos, int left_n,
                                      int64_t key, int64_t val) {
  if (pos < left_n) {
    s.lk[pos] = key;
    s.lv[pos] = val;
  } else {
    s.rk[pos - left_n] = key;
    s.rv[pos - left_n] = val;
  }
}

__global__ void leaf_split_kernel(
    const int64_t* __restrict__ rows_k, const int64_t* __restrict__ rows_v,
    const int64_t* __restrict__ ins_key, const int64_t* __restrict__ ins_val,
    int64_t* __restrict__ left_k, int64_t* __restrict__ left_v,
    int64_t* __restrict__ right_k, int64_t* __restrict__ right_v,
    int32_t* __restrict__ occ_l, int32_t* __restrict__ occ_r,
    int64_t* __restrict__ sep, int32_t* __restrict__ did_split, int64_t n) {
  __shared__ __align__(16) WarpRows smem[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + w;
  if (r >= n) return;  // whole warp leaves together
  const int64_t base = r * kFanout;

  const longlong2 k = reinterpret_cast<const longlong2*>(rows_k + base)[lane];
  const longlong2 ik = reinterpret_cast<const longlong2*>(ins_key + base)[lane];
  const bool r0 = k.x != kKeyMax;
  const bool r1 = k.y != kKeyMax;
  const bool a0 = ik.x != kKeyMax;
  const bool a1 = ik.y != kKeyMax;
  const unsigned am0 = __ballot_sync(kFullMask, a0);
  const unsigned am1 = __ballot_sync(kFullMask, a1);
  const int n_row = __popc(__ballot_sync(kFullMask, r0)) +
                    __popc(__ballot_sync(kFullMask, r1));
  const int m = n_row + __popc(am0) + __popc(am1);
  const bool split = m > kFanout;
  const int left_n = split ? m / 2 : m;

  // 1. ranks
  int ins_below0 = 0, ins_below1 = 0;  // active staged keys below my row keys
  int rank_i0 = 0, rank_i1 = 0;
  for (int half = 0; half < 2; ++half) {
    unsigned todo = half ? am1 : am0;
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int64_t s = shfl64(half ? ik.y : ik.x, src);
      ins_below0 += s < k.x;
      ins_below1 += s < k.y;
      const int below = __popc(__ballot_sync(kFullMask, r0 && k.x < s)) +
                        __popc(__ballot_sync(kFullMask, r1 && k.y < s)) +
                        __popc(__ballot_sync(kFullMask, a0 && ik.x < s)) +
                        __popc(__ballot_sync(kFullMask, a1 && ik.y < s));
      if (lane == src) {
        if (half) {
          rank_i1 = below;
        } else {
          rank_i0 = below;
        }
      }
    }
  }

  // 2. place into the warp's rows in shared memory
  WarpRows& s = smem[w];
  const longlong2 pad_k = make_longlong2(kKeyMax, kKeyMax);
  const longlong2 pad_v = make_longlong2(0, 0);
  reinterpret_cast<longlong2*>(s.lk)[lane] = pad_k;
  reinterpret_cast<longlong2*>(s.lv)[lane] = pad_v;
  reinterpret_cast<longlong2*>(s.rk)[lane] = pad_k;
  reinterpret_cast<longlong2*>(s.rv)[lane] = pad_v;
  __syncwarp();
  if (r0 || r1) {
    const longlong2 v = reinterpret_cast<const longlong2*>(rows_v + base)[lane];
    if (r0) place(s, 2 * lane + ins_below0, left_n, k.x, v.x);
    if (r1) place(s, 2 * lane + 1 + ins_below1, left_n, k.y, v.y);
  }
  if (a0) place(s, rank_i0, left_n, ik.x, ins_val[base + 2 * lane]);
  if (a1) place(s, rank_i1, left_n, ik.y, ins_val[base + 2 * lane + 1]);
  __syncwarp();

  // 3. store
  reinterpret_cast<longlong2*>(left_k + base)[lane] =
      reinterpret_cast<const longlong2*>(s.lk)[lane];
  reinterpret_cast<longlong2*>(left_v + base)[lane] =
      reinterpret_cast<const longlong2*>(s.lv)[lane];
  reinterpret_cast<longlong2*>(right_k + base)[lane] =
      split ? reinterpret_cast<const longlong2*>(s.rk)[lane] : pad_k;
  reinterpret_cast<longlong2*>(right_v + base)[lane] =
      split ? reinterpret_cast<const longlong2*>(s.rv)[lane] : pad_v;
  if (lane == 0) {
    occ_l[r] = left_n;
    occ_r[r] = m - left_n;
    sep[r] = split ? s.rk[0] : kKeyMax;
    did_split[r] = split ? 1 : 0;
  }
}

}  // namespace

extern "C" int dex_leaf_split(const int64_t* rows_k, const int64_t* rows_v,
                              const int64_t* ins_key, const int64_t* ins_val,
                              int64_t* left_k, int64_t* left_v,
                              int64_t* right_k, int64_t* right_v,
                              int32_t* occ_l, int32_t* occ_r, int64_t* sep,
                              int32_t* did_split, int64_t n,
                              cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    leaf_split_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                        stream>>>(rows_k, rows_v, ins_key, ins_val, left_k,
                                  left_v, right_k, right_v, occ_l, occ_r, sep,
                                  did_split, n);
  }
  return static_cast<int>(cudaGetLastError());
}
