// node_search_prefix: batched lower bound over prefix-compressed separator
// rows on Hopper.
//
// Replaces the TPU kernel node_search_prefix in
// src/repro/kernels/node_search.py, which carried int64 as (hi, lo) int32
// planes with a sign-flipped compare; here int64 compares natively.  One
// warp per lane: each thread loads two int32 suffixes with one 8-byte load
// (the warp reads the 256-byte suffix row in one coalesced transaction),
// ballots and popcounts count the suffixes <= the query's suffix and the
// real ones, and the prefix compare is scalar.  Only a lane whose row is
// incompressible (nbits < 0) reads its canonical key row, 16 bytes a
// thread; the branch is warp-uniform because a warp serves one lane.  See
// src/repro_torch/kernels/node_search.py for what bounds it.
#include <cuda_runtime.h>

#include "warp_search.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int32_t kSentinel = 0x7FFFFFFF;

__global__ void node_search_prefix_kernel(const int64_t* __restrict__ prefix,
                                          const int32_t* __restrict__ nbits,
                                          const int32_t* __restrict__ suffix,
                                          const int64_t* __restrict__ rows,
                                          const int64_t* __restrict__ queries,
                                          int32_t* __restrict__ slot,
                                          int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // whole warp leaves together
  const int64_t q = queries[i];
  const int nb = nbits[i];
  int count;
  if (nb >= 0) {
    const int64_t mask =
        static_cast<int64_t>((1ull << nb) - 1ull);  // nb <= 30 by contract
    const int32_t q_suf = static_cast<int32_t>(q & mask);
    const int64_t q_pref = q & ~mask;
    const int64_t p = prefix[i];
    const int2 s =
        reinterpret_cast<const int2*>(suffix + i * dex::kFanout)[lane];
    const int n_real = __popc(__ballot_sync(dex::kFullMask, s.x != kSentinel)) +
                       __popc(__ballot_sync(dex::kFullMask, s.y != kSentinel));
    const int n_le = __popc(__ballot_sync(dex::kFullMask, s.x <= q_suf)) +
                     __popc(__ballot_sync(dex::kFullMask, s.y <= q_suf));
    count = q_pref == p ? n_le : (p < q_pref ? n_real : 0);
  } else {
    count = dex::search_row(rows + i * dex::kFanout, q, lane).count;
  }
  if (lane == 0) slot[i] = count > 0 ? count - 1 : 0;
}

}  // namespace

extern "C" int dex_node_search_prefix(const int64_t* prefix,
                                      const int32_t* nbits,
                                      const int32_t* suffix,
                                      const int64_t* rows,
                                      const int64_t* queries, int32_t* slot,
                                      int64_t n, cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    node_search_prefix_kernel<<<static_cast<unsigned>(blocks),
                                kWarpsPerBlock * 32, 0, stream>>>(
        prefix, nbits, suffix, rows, queries, slot, n);
  }
  return static_cast<int>(cudaGetLastError());
}
