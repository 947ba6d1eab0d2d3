// node_search: batched in-node lower bound and exact match on Hopper.
//
// Replaces the TPU kernel node_search in src/repro/kernels/node_search.py.
// What bounds it: bytes.  The TPU kernel, and this kernel's first design,
// read every key of the row; a sorted row needs only the few 32-byte
// sectors a search reads (sector_search.cuh), so a group of G lanes serves
// one row and reads those.  The rows must be sorted non-decreasing, as
// every caller's are (kernels/node_search.py).
//
// A query below KEY_MAX: count = #(row <= q) by the search, slot =
// max(count - 1, 0), and found = row[count - 1] == q.  That key lies in a
// sector the search read: a search ends either inside a sector it read, at
// position count - 1 of it, or just past a sector it read full, whose last
// key is row[count - 1].  With values, on a hit: the one value at count -
// 1, unless row[count - 2] == q too.  Under design B that key was read as
// well: the chosen quarter holds count - 2 unless count - 1 opens the
// quarter or precedes it, and then count - 2 lies in the splitter pair
// that ends the quarter before.  (Under A and C it may lie in a sector not
// read.)  Then the match is a run, its start the lower bound of q, #(row
// <= q - 1), found by a second search, and the group sums values[lo:count]
// with wrapping unsigned adds.
//
// A KEY_MAX query needs no search: every key is <= KEY_MAX, so count = 64
// and found = row[63] == KEY_MAX, one sector.  With values the run is the
// row's KEY_MAX padding, from the row's first KEY_MAX: row[0] is read with
// row[63], and an all-KEY_MAX row, as the engine's padding slots are, sums
// its whole value row; another row searches for its first KEY_MAX.
//
// One lane of each group writes slot, found and value.
#include <cuda_runtime.h>

#include "sector_search.cuh"

namespace {

constexpr int kThreads = 256;

template <char D, int G>
__global__ void __launch_bounds__(kThreads)
    node_search_kernel(const int64_t* __restrict__ rows,
                       const int64_t* __restrict__ queries,
                       const int64_t* __restrict__ values,
                       int32_t* __restrict__ slot, uint8_t* __restrict__ found,
                       int64_t* __restrict__ value, int64_t n) {
  const dex::Group<G> g;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  if (i >= n) return;  // the whole group leaves together
  const int64_t* row = rows + i * dex::kRowKeys;
  const dex::Match m = dex::match_row<D>(
      g, row, values == nullptr ? nullptr : values + i * dex::kRowKeys, queries[i]);
  if (g.rank == 0) {
    slot[i] = m.count > 0 ? m.count - 1 : 0;
    found[i] = m.hit;
    value[i] = m.value;
  }
}

template <char D, int G>
void launch(const int64_t* rows, const int64_t* queries, const int64_t* values,
            int32_t* slot, uint8_t* found, int64_t* value, int64_t n,
            cudaStream_t stream) {
  constexpr int64_t per_block = kThreads / G;
  const int64_t blocks = (n + per_block - 1) / per_block;
  node_search_kernel<D, G><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      rows, queries, values, slot, found, value, n);
}

using Launch = void (*)(const int64_t*, const int64_t*, const int64_t*, int32_t*,
                        uint8_t*, int64_t*, int64_t, cudaStream_t);

// Variant 0 is the default; the others, in the order of
// kernels/node_search.py::VARIANTS, are there to be timed.
constexpr Launch kVariants[] = {
    launch<dex::kDefaultDesign, dex::kDefaultGroup>,
    launch<'A', 1>, launch<'A', 2>, launch<'A', 4>,
    launch<'B', 1>, launch<'B', 2>, launch<'B', 4>, launch<'B', 8>,
    launch<'C', 1>, launch<'C', 2>, launch<'C', 4>,
};

}  // namespace

extern "C" int dex_node_search(const int64_t* rows, const int64_t* queries,
                               const int64_t* values, int32_t* slot,
                               uint8_t* found, int64_t* value, int64_t n,
                               int variant, cudaStream_t stream) {
  if (variant < 0 || variant >= static_cast<int>(sizeof(kVariants) / sizeof(Launch)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) kVariants[variant](rows, queries, values, slot, found, value, n, stream);
  return static_cast<int>(cudaGetLastError());
}
