// Searches of one sorted row that read only the 32-byte sectors they need.
//
// A row is 64 keys sorted non-decreasing: 512 bytes of int64 keys (sixteen
// sectors of 4 keys) or 256 bytes of int32 suffixes (eight sectors of 8).
// Every search here counts the keys <= q; on a sorted row that count is
// the first position whose key exceeds q, so a search reads a few sectors
// and infers the rest.  Reads are 2-key pairs: 16 bytes of int64 keys, 8
// of int32 suffixes.  On an unsorted row the count is wrong: the callers'
// rows are sorted (kernels/node_search.py states and, on the CPU, checks
// it).
//
// A group of G consecutive lanes of a warp serves one row.  Its shuffles
// name only its own lanes, so the groups of one warp may branch apart.
// Every branch inside a search depends only on values the whole group
// shares, so the group always shuffles together.
//
// The designs for the int64 key row (kernels/node_search.py mirrors each
// in plain Python, search_schedule):
//   'A': a binary search over the sixteen sectors, one sector a round:
//        at most five rounds and five sectors;
//   'B': two rounds: the pairs that end the first three 16-key quarters
//        (keys 14-15, 30-31, 46-47: sectors 3, 7, 11), then the chosen
//        quarter's 128 bytes in one read: at most seven sectors;
//   'C': three rounds of 1, 2 and 2 sectors: sector 8, then two sectors
//        that cut the half it leaves into runs of at most two, then one
//        such run: at most five sectors.
// The int32 suffix row takes C's last two rounds: sectors 2 and 5, then
// the run of two they leave: two rounds, at most four sectors.
#pragma once

#include <cstdint>

namespace dex {

constexpr int64_t kKeyMax = INT64_MAX;
constexpr int64_t kKeyMin = INT64_MIN;
constexpr int kRowKeys = 64;

// The default design and group size of node_search (the fastest on the
// engine's descent mix, PERF.md); the design is also node_search_prefix's
// for a canonical row.
constexpr char kDefaultDesign = 'B';
constexpr int kDefaultGroup = 4;

template <int G>
struct Group {
  static_assert(G >= 1 && G <= 16 && (G & (G - 1)) == 0, "G: a power of 2");
  unsigned mask;  // the group's lanes
  int rank;       // this lane's place in the group

  __device__ __forceinline__ Group() {
    const int lane = threadIdx.x & 31;
    rank = lane & (G - 1);
    mask = ((1u << G) - 1u) << (lane & ~(G - 1));
  }

  template <typename T>
  __device__ __forceinline__ T sum(T v) const {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off, G);
    return v;
  }
};

// Keys <= q in pair p (keys 2p and 2p + 1) of the row.
__device__ __forceinline__ int le_pair(const int64_t* row, int p, int64_t q) {
  const longlong2 k = reinterpret_cast<const longlong2*>(row)[p];
  return (k.x <= q) + (k.y <= q);
}

__device__ __forceinline__ int le_pair(const int32_t* row, int p, int32_t q) {
  const int2 k = reinterpret_cast<const int2*>(row)[p];
  return (k.x <= q) + (k.y <= q);
}

// Keys <= q among N pairs of the row, pair j at pair_of(j): the group's
// lanes read the pairs in turn, in one round, and sum their counts.
template <int N, int G, typename K, typename F>
__device__ __forceinline__ int count_le(const Group<G>& g, const K* row, K q,
                                        F pair_of) {
  int c = 0;
#pragma unroll
  for (int j0 = 0; j0 < N; j0 += G) {
    const int j = j0 + g.rank;
    if (N % G == 0 || j < N) c += le_pair(row, pair_of(j), q);
  }
  return g.sum(c);
}

// #(row <= q) over a sorted row of 64 int64 keys, by design D.  A round's
// count c over sorted positions says where the first key > q lies: after
// the c-th key read and before the next, so a count strictly inside a
// sector gives the answer, and a full or empty sector narrows the range.
// Every branch depends only on counts the group shares.
template <char D, int G>
__device__ __forceinline__ int count_row(const Group<G>& g, const int64_t* row,
                                         int64_t q) {
  if constexpr (D == 'A') {
    int lo = 0, hi = 16;  // the count lies in [4 lo, 4 hi]
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int c = count_le<2>(g, row, q, [mid](int j) { return 2 * mid + j; });
      if (c == 4) {
        lo = mid + 1;
      } else if (c == 0) {
        hi = mid;
      } else {
        return 4 * mid + c;
      }
    }
    return 4 * lo;
  } else if constexpr (D == 'B') {
    // the pairs ending quarters 0-2: (their keys <= q) / 2 is the quarter
    const int c = count_le<3>(g, row, q, [](int j) { return 8 * j + 7; });
    const int quarter = c >> 1;
    return 16 * quarter +
           count_le<8>(g, row, q, [quarter](int j) { return 8 * quarter + j; });
  } else {
    static_assert(D == 'C', "design: 'A', 'B' or 'C'");
    int c = count_le<2>(g, row, q, [](int j) { return 16 + j; });  // sector 8
    if (c & 3) return 32 + c;
    const int s0 = c ? 9 : 0;  // the half left: sectors 0-7 or 9-15
    // sectors s0 + 2 and s0 + 5 leave runs s0..+1, s0+3..+4, s0+6..
    c = count_le<4>(g, row, q,
                    [s0](int j) { return 2 * (s0 + 2 + 3 * (j >> 1)) + (j & 1); });
    if (c & 3) return 4 * (s0 + 2 + 3 * (c >> 2)) + (c & 3);
    // the run left, two sectors (the upper half's last run, sector 15
    // alone, is read with sector 14, already known to be full)
    const int t = min(s0 + 3 * (c >> 2), 14);
    return 4 * t + count_le<4>(g, row, q, [t](int j) { return 2 * t + j; });
  }
}

// #(suffix <= q) over a sorted row of 64 int32 suffixes: sectors 2 and 5,
// then the two sectors they leave the first suffix > q in.
template <int G>
__device__ __forceinline__ int count_suffix(const Group<G>& g,
                                            const int32_t* row, int32_t q) {
  const int c =
      count_le<8>(g, row, q, [](int j) { return 8 + 12 * (j >> 2) + (j & 3); });
  if (c & 7) return 16 + 24 * (c >> 3) + (c & 7);
  const int t = 3 * (c >> 3);  // sectors 0-1, 3-4 or 6-7
  return 8 * t + count_le<8>(g, row, q, [t](int j) { return 4 * t + j; });
}

// The leaf of a search: count = #(row <= q), and the exact match of q with
// the sum of the matched values (wrapping unsigned adds; 0 without
// ``vrow``, the row's values).  node_search and subtree_walk share it; the
// rules are node_search's (csrc/node_search.cu states why each read lies
// in a sector the search read).  A KEY_MAX query needs no search: count =
// 64, and found reads row[63].  A hit at count - 1 reads one value, unless
// row[count - 2] == q too: then the run's start is found (row 0 for
// KEY_MIN, or for KEY_MAX on an all-KEY_MAX row; else a second search for
// q - 1) and the group sums values[lo:count].
struct Match {
  int count;
  bool hit;
  int64_t value;
};

template <char D, int G>
__device__ __forceinline__ Match match_row(const Group<G>& g, const int64_t* row,
                                           const int64_t* vrow, int64_t q) {
  int count;
  int64_t last = 0, prev = 0, first = 0;
  if (q == kKeyMax) {
    count = kRowKeys;
    const longlong2 tail = reinterpret_cast<const longlong2*>(row)[31];
    prev = tail.x;
    last = tail.y;
    if (vrow != nullptr) first = row[0];
  } else {
    count = count_row<D>(g, row, q);
    if (count > 0) last = row[count - 1];
  }
  const bool hit = count > 0 && last == q;
  int64_t v = 0;
  if (hit && vrow != nullptr) {
    if (q != kKeyMax && count > 1) prev = row[count - 2];
    if (count > 1 && prev == q) {
      const bool from_0 = q == kKeyMin || (q == kKeyMax && first == q);
      const int lo = from_0 ? 0 : count_row<D>(g, row, q - 1);
      unsigned long long s = 0;
      for (int j = lo + g.rank; j < count; j += G)
        s += static_cast<unsigned long long>(vrow[j]);
      v = static_cast<int64_t>(g.sum(s));
    } else {
      v = vrow[count - 1];
    }
  }
  return {count, hit, v};
}

}  // namespace dex
