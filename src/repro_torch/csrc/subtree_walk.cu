// subtree_walk: the owner-side offload walk on Hopper.
//
// Replaces the TPU kernel subtree_walk in src/repro/kernels/subtree_walk.py.
// One warp per query: levels - 1 row searches, each followed by a read of
// the chosen child id, then the leaf match.  Returns found, value and the
// leaf's block-local id as read from its parent (unwrapped, so a NULL child
// comes back as -1, as the reference engine's walk reports it).  The walk
// is a chain of dependent row reads across the pool, so it is bound by
// memory latency; see src/repro_torch/kernels/subtree_walk.py.
#include <cuda_runtime.h>

#include "warp_search.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void subtree_walk_kernel(const int64_t* __restrict__ keys,
                                    const int32_t* __restrict__ children,
                                    const int64_t* __restrict__ values,
                                    const int32_t* __restrict__ subtree,
                                    const int64_t* __restrict__ queries,
                                    uint8_t* __restrict__ found,
                                    int64_t* __restrict__ value,
                                    int32_t* __restrict__ leaf, int64_t n,
                                    int64_t n_subtrees, int64_t cap,
                                    int levels) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // whole warp leaves together
  const int64_t q = queries[i];
  int64_t st = subtree[i];
  if (st < 0) st += n_subtrees;  // negative ids count from the end
  int64_t local = 0;
  int32_t read = 0;  // the child id as stored
  for (int l = 0; l < levels - 1; ++l) {
    const int64_t node = (st * cap + local) * dex::kFanout;
    const dex::RowSearch r = dex::search_row(keys + node, q, lane);
    const int slot = r.count > 0 ? r.count - 1 : 0;
    read = children[node + slot];
    local = read < 0 ? read + cap : read;
  }
  const int64_t node = (st * cap + local) * dex::kFanout;
  const dex::RowSearch r = dex::search_row(keys + node, q, lane);
  const int64_t v = dex::matched_value(values + node, r, lane);
  if (lane == 0) {
    found[i] = r.any != 0;
    value[i] = v;
    leaf[i] = read;
  }
}

}  // namespace

extern "C" int dex_subtree_walk(const int64_t* keys, const int32_t* children,
                                const int64_t* values, const int32_t* subtree,
                                const int64_t* queries, uint8_t* found,
                                int64_t* value, int32_t* leaf, int64_t n,
                                int64_t n_subtrees, int64_t cap, int levels,
                                cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    subtree_walk_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                          stream>>>(keys, children, values, subtree, queries,
                                    found, value, leaf, n, n_subtrees, cap,
                                    levels);
  }
  return static_cast<int>(cudaGetLastError());
}
