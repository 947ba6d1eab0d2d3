// leaf_scan: range-scan compaction over a window of leaf rows on Hopper.
//
// Replaces the TPU kernel leaf_scan in src/repro/kernels/leaf_scan.py, which
// ranked the window with a cumsum and gathered each output column with a
// one-hot [B, max_count, W] compare over (hi, lo) int32 planes.  Here keys
// are int64 and one warp owns one lane of the batch:
//
//  1. a lane with count 0 (or start KEY_MAX) selects nothing: the warp
//     writes its padded row and taken = 0 and leaves;
//  2. otherwise the warp walks the window in 32-key chunks, one key a
//     thread (256-byte coalesced reads).  A ballot marks the keys that are
//     not KEY_MAX and not below the start; a selected key's rank is the
//     running total plus the selected keys before it in the chunk
//     (__popc of the ballot under the lane mask), and the thread writes the
//     key and its value straight to out[rank - 1];
//  3. the walk stops as soon as the running total reaches the count, so
//     the rest of the window is never read; the warp then pads
//     [taken, max_count) with KEY_MAX / 0.
//
// Bound: bytes.  An active lane needs the part of its window up to its last
// selected record, its output row and taken; an inactive one its start and
// count and its padded output row.  See src/repro_torch/kernels/leaf_scan.py.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int64_t kKeyMax = INT64_MAX;

__global__ void leaf_scan_kernel(const int64_t* __restrict__ wk,
                                 const int64_t* __restrict__ wv,
                                 const int64_t* __restrict__ start,
                                 const int32_t* __restrict__ counts,
                                 int64_t* __restrict__ out_k,
                                 int64_t* __restrict__ out_v,
                                 int32_t* __restrict__ taken, int64_t n,
                                 int w, int max_count) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n) return;  // whole warp leaves together
  const int64_t s = start[b];
  int count = counts[b];
  count = count < 0 ? 0 : (count > max_count ? max_count : count);
  if (s == kKeyMax) count = 0;
  const int64_t* rk = wk + b * static_cast<int64_t>(w);
  const int64_t* rv = wv + b * static_cast<int64_t>(w);
  int64_t* ok = out_k + b * static_cast<int64_t>(max_count);
  int64_t* ov = out_v + b * static_cast<int64_t>(max_count);
  const unsigned below = (1u << lane) - 1u;
  int total = 0;
  for (int base = 0; base < w && total < count; base += 32) {
    const int j = base + lane;
    const int64_t key = j < w ? rk[j] : kKeyMax;
    const bool sel = key != kKeyMax && key >= s;
    const unsigned m = __ballot_sync(kFullMask, sel);
    const int rank = total + __popc(m & below);  // 0-based
    if (sel && rank < count) {
      ok[rank] = key;
      ov[rank] = rv[j];
    }
    total += __popc(m);
  }
  const int got = total < count ? total : count;
  for (int c = got + lane; c < max_count; c += 32) {
    ok[c] = kKeyMax;
    ov[c] = 0;
  }
  if (lane == 0) taken[b] = got;
}

}  // namespace

extern "C" int dex_leaf_scan(const int64_t* wk, const int64_t* wv,
                             const int64_t* start, const int32_t* counts,
                             int64_t* out_k, int64_t* out_v, int32_t* taken,
                             int64_t n, int w, int max_count,
                             cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    leaf_scan_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       stream>>>(wk, wv, start, counts, out_k, out_v, taken, n,
                                 w, max_count);
  }
  return static_cast<int>(cudaGetLastError());
}
