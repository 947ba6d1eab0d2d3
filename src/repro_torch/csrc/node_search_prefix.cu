// node_search_prefix: batched lower bound over prefix-compressed separator
// rows on Hopper.
//
// Replaces the TPU kernel node_search_prefix in
// src/repro/kernels/node_search.py, which carried int64 as (hi, lo) int32
// planes with a sign-flipped compare; here int64 compares natively.  What
// bounds it: bytes.  A group of G lanes serves one lane's row and reads
// only the sectors a search needs (sector_search.cuh).  The prefix
// compare comes first, and decides whether the suffix row is read at all:
//   prefix > the query's prefix: count = 0, no suffix read;
//   prefix == the query's prefix: count = #(suffix <= the query's suffix);
//   prefix < the query's prefix: count = n_real, the suffixes below the
//     0x7FFFFFFF sentinel, which is #(suffix <= 0x7FFFFFFE), the same search.
// A suffix search reads at most four of the row's eight sectors in two
// rounds.  A lane whose row is incompressible (nbits < 0) searches its
// canonical key row as node_search does: no key read for a KEY_MAX query,
// else the default design.  The suffix and key rows must be sorted
// non-decreasing (kernels/node_search.py).  One lane of each group writes
// the slot.
#include <cuda_runtime.h>

#include "sector_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultGroup = 2;
constexpr int32_t kSentinel = 0x7FFFFFFF;

template <int G>
__global__ void __launch_bounds__(kThreads)
    node_search_prefix_kernel(const int64_t* __restrict__ prefix,
                              const int32_t* __restrict__ nbits,
                              const int32_t* __restrict__ suffix,
                              const int64_t* __restrict__ rows,
                              const int64_t* __restrict__ queries,
                              int32_t* __restrict__ slot, int64_t n) {
  const dex::Group<G> g;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  if (i >= n) return;  // the whole group leaves together
  const int64_t q = queries[i];
  const int nb = nbits[i];
  int count;
  if (nb >= 0) {
    const int64_t mask =
        static_cast<int64_t>((1ull << nb) - 1ull);  // nb <= 30 by contract
    const int64_t q_pref = q & ~mask;
    const int64_t p = prefix[i];
    if (p > q_pref) {
      count = 0;
    } else {
      const int32_t q_suf =
          p == q_pref ? static_cast<int32_t>(q & mask) : kSentinel - 1;
      count = dex::count_suffix(g, suffix + i * dex::kRowKeys, q_suf);
    }
  } else if (q == dex::kKeyMax) {
    count = dex::kRowKeys;
  } else {
    count = dex::count_row<dex::kDefaultDesign>(g, rows + i * dex::kRowKeys, q);
  }
  if (g.rank == 0) slot[i] = count > 0 ? count - 1 : 0;
}

template <int G>
void launch(const int64_t* prefix, const int32_t* nbits, const int32_t* suffix,
            const int64_t* rows, const int64_t* queries, int32_t* slot,
            int64_t n, cudaStream_t stream) {
  constexpr int64_t per_block = kThreads / G;
  const int64_t blocks = (n + per_block - 1) / per_block;
  node_search_prefix_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(prefix, nbits, suffix, rows, queries,
                                           slot, n);
}

using Launch = void (*)(const int64_t*, const int32_t*, const int32_t*,
                        const int64_t*, const int64_t*, int32_t*, int64_t,
                        cudaStream_t);

// Variant 0 is the default; the others, in the order of
// kernels/node_search.py::PREFIX_VARIANTS, are there to be timed.
constexpr Launch kVariants[] = {
    launch<kDefaultGroup>, launch<2>, launch<4>, launch<8>,
};

}  // namespace

extern "C" int dex_node_search_prefix(const int64_t* prefix,
                                      const int32_t* nbits,
                                      const int32_t* suffix,
                                      const int64_t* rows,
                                      const int64_t* queries, int32_t* slot,
                                      int64_t n, int variant,
                                      cudaStream_t stream) {
  if (variant < 0 || variant >= static_cast<int>(sizeof(kVariants) / sizeof(Launch)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) kVariants[variant](prefix, nbits, suffix, rows, queries, slot, n, stream);
  return static_cast<int>(cudaGetLastError());
}
