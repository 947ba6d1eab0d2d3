// subtree_walk: the owner-side offload walk on Hopper.
//
// Replaces the TPU kernel subtree_walk in src/repro/kernels/subtree_walk.py.
// Each lane walks its subtree block from the root (local id 0) down
// ``levels`` levels: levels - 1 inner rows, each searched for the slot of
// the child to follow, then the leaf's exact match.  Returns found, value
// and the leaf's block-local id as read from its parent (unwrapped, so a
// NULL child comes back as -1, as the reference engine's walk reports it).
// An inactive lane (``active[i] == 0``) reads nothing but its mask byte and
// returns (0, 0, 0).
//
// What bounds it: memory latency.  A lane's reads form a chain (row, child
// id, row, ..., value), each address known only once the read before it
// returns, so the kernel is as fast as the number of chains in flight.  The
// first design served a lane with a warp that read each 512-byte row whole
// (variant W, kept for timing): at most 64 warps an SM, about 8,400 chains
// on the card.  A sorted row needs only the few 32-byte sectors a search
// reads (sector_search.cuh), so a group of G lanes serves a lane: at G = 4
// an SM holds eight times as many chains, each reading 4-5 of a row's
// eight 64-byte L2 granules.  Inner level: count = #(row <= q) by design
// D (64 for a KEY_MAX query, which needs no search), slot = max(count - 1,
// 0); the group's rank 0 reads the child id and shuffles it to the group.
// Leaf: node_search's match (dex::match_row).  The rows must be sorted
// non-decreasing, as the pool's are (kernels/subtree_walk.py).
//
// The engine hands the kernel every slot of its padded exchange and marks
// the lanes it walks; pack_by_dest puts each bucket's live lanes first, so
// whole warps of padding leave at once.
#include <cuda_runtime.h>

#include "sector_search.cuh"
#include "warp_search.cuh"

namespace {

constexpr int kThreads = 256;
// the default design and group size (kernels/subtree_walk.py: DESIGN, GROUP)
constexpr char kWalkDesign = 'B';
constexpr int kWalkGroup = 4;

// The launchers pass the arguments along as one struct; the kernels take
// them as __restrict__ parameters, so the pool is read as read-only data.
struct WalkArgs {
  const int64_t* keys;
  const int32_t* children;
  const int64_t* values;
  const int32_t* subtree;
  const int64_t* queries;
  const uint8_t* active;  // nullptr: every lane walks
  uint8_t* found;
  int64_t* value;
  int32_t* leaf;
  int64_t n;
  int64_t n_subtrees;
  int64_t cap;
  int levels;
};

#define DEX_WALK_PARAMS                                                          \
  const int64_t *__restrict__ keys, const int32_t *__restrict__ children,        \
      const int64_t *__restrict__ values, const int32_t *__restrict__ subtree,   \
      const int64_t *__restrict__ queries, const uint8_t *__restrict__ active,   \
      uint8_t *__restrict__ found, int64_t *__restrict__ value,                  \
      int32_t *__restrict__ leaf, int64_t n, int64_t n_subtrees, int64_t cap,    \
      int levels
#define DEX_WALK_ARGS(a)                                                         \
  a.keys, a.children, a.values, a.subtree, a.queries, a.active, a.found,         \
      a.value, a.leaf, a.n, a.n_subtrees, a.cap, a.levels

template <char D, int G>
__global__ void __launch_bounds__(kThreads) subtree_walk_kernel(DEX_WALK_PARAMS) {
  const dex::Group<G> g;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  if (i >= n) return;  // the whole group leaves together
  if (active != nullptr && active[i] == 0) {
    if (g.rank == 0) {
      found[i] = 0;
      value[i] = 0;
      leaf[i] = 0;
    }
    return;
  }
  const int64_t q = queries[i];
  int64_t st = subtree[i];
  if (st < 0) st += n_subtrees;  // negative ids count from the end
  const int64_t block = st * cap;
  int64_t local = 0;
  int32_t read = 0;  // the child id as stored
  for (int l = 0; l < levels - 1; ++l) {
    const int64_t node = (block + local) * dex::kRowKeys;
    const int count =
        q == dex::kKeyMax ? dex::kRowKeys : dex::count_row<D>(g, keys + node, q);
    int32_t child = 0;
    if (g.rank == 0) child = children[node + (count > 0 ? count - 1 : 0)];
    read = __shfl_sync(g.mask, child, 0, G);
    local = read < 0 ? read + cap : read;
  }
  const int64_t node = (block + local) * dex::kRowKeys;
  const dex::Match m = dex::match_row<D>(g, keys + node, values + node, q);
  if (g.rank == 0) {
    found[i] = m.hit;
    value[i] = m.value;
    leaf[i] = read;
  }
}

// Variant W: the first design, one warp a lane reading whole rows.
__global__ void __launch_bounds__(kThreads) subtree_walk_warp(DEX_WALK_PARAMS) {
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (i >= n) return;  // whole warp leaves together
  if (active != nullptr && active[i] == 0) {
    if (lane == 0) {
      found[i] = 0;
      value[i] = 0;
      leaf[i] = 0;
    }
    return;
  }
  const int64_t q = queries[i];
  int64_t st = subtree[i];
  if (st < 0) st += n_subtrees;
  int64_t local = 0;
  int32_t read = 0;
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

template <char D, int G>
void launch(const WalkArgs& a, cudaStream_t stream) {
  constexpr int64_t per_block = kThreads / G;
  const int64_t blocks = (a.n + per_block - 1) / per_block;
  subtree_walk_kernel<D, G><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      DEX_WALK_ARGS(a));
}

void launch_warp(const WalkArgs& a, cudaStream_t stream) {
  constexpr int64_t per_block = kThreads / 32;
  const int64_t blocks = (a.n + per_block - 1) / per_block;
  subtree_walk_warp<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      DEX_WALK_ARGS(a));
}

using Launch = void (*)(const WalkArgs&, cudaStream_t);

// Variant 0 is the default; the others, in the order of
// kernels/subtree_walk.py::VARIANTS, are there to be timed.
constexpr Launch kVariants[] = {
    launch<kWalkDesign, kWalkGroup>,
    launch<'B', 2>, launch<'B', 4>, launch<'B', 8>,
    launch<'C', 2>, launch<'C', 4>,
    launch_warp,
};

}  // namespace

extern "C" int dex_subtree_walk(const int64_t* keys, const int32_t* children,
                                const int64_t* values, const int32_t* subtree,
                                const int64_t* queries, const uint8_t* active,
                                uint8_t* found, int64_t* value, int32_t* leaf,
                                int64_t n, int64_t n_subtrees, int64_t cap,
                                int levels, int variant, cudaStream_t stream) {
  if (variant < 0 || variant >= static_cast<int>(sizeof(kVariants) / sizeof(Launch)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const WalkArgs a{keys,  children, values, subtree,    queries, active, found,
                     value, leaf,     n,      n_subtrees, cap,     levels};
    kVariants[variant](a, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
