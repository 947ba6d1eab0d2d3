// node_search: batched in-node lower bound and exact match on Hopper.
//
// Replaces the TPU kernel node_search in src/repro/kernels/node_search.py.
// One warp per lane's row: a 512-byte coalesced read of the keys, ballots
// and popcounts for the slot, and a value read only by the lane that holds
// the match.  See src/repro_torch/kernels/node_search.py for what bounds it.
#include <cuda_runtime.h>

#include "warp_search.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void node_search_kernel(const int64_t* __restrict__ rows,
                                   const int64_t* __restrict__ queries,
                                   const int64_t* __restrict__ values,
                                   int32_t* __restrict__ slot,
                                   uint8_t* __restrict__ found,
                                   int64_t* __restrict__ value, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // whole warp leaves together
  const int64_t q = queries[i];
  const dex::RowSearch r = dex::search_row(rows + i * dex::kFanout, q, lane);
  const int64_t v = dex::matched_value(
      values == nullptr ? nullptr : values + i * dex::kFanout, r, lane);
  if (lane == 0) {
    slot[i] = r.count > 0 ? r.count - 1 : 0;
    found[i] = r.any != 0;
    value[i] = v;
  }
}

}  // namespace

extern "C" int dex_node_search(const int64_t* rows, const int64_t* queries,
                               const int64_t* values, int32_t* slot,
                               uint8_t* found, int64_t* value, int64_t n,
                               cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    node_search_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                         stream>>>(rows, queries, values, slot, found, value, n);
  }
  return static_cast<int>(cudaGetLastError());
}
