// One warp searches one 64-key node row.
//
// Lane i holds keys 2i and 2i+1 (one 16-byte load per lane, so the warp
// reads the whole 512-byte row in one coalesced transaction).  Two ballots
// count the keys <= q, two more mark the exact matches.
#pragma once

#include <cstdint>

namespace dex {

constexpr int kFanout = 64;
constexpr unsigned kFullMask = 0xffffffffu;

struct RowSearch {
  int count;        // keys <= q in the row
  bool match_lo;    // this lane's key 2i equals q
  bool match_hi;    // this lane's key 2i+1 equals q
  unsigned any;     // ballot of lanes holding a match
};

__device__ __forceinline__ RowSearch search_row(const int64_t* row, int64_t q,
                                                int lane) {
  const longlong2 k = reinterpret_cast<const longlong2*>(row)[lane];
  RowSearch r;
  r.count = __popc(__ballot_sync(kFullMask, k.x <= q)) +
            __popc(__ballot_sync(kFullMask, k.y <= q));
  r.match_lo = k.x == q;
  r.match_hi = k.y == q;
  r.any = __ballot_sync(kFullMask, r.match_lo || r.match_hi);
  return r;
}

// Sum of the values at the matching slots, wrapping like int64 addition;
// only lanes that hold a match read their value.  Warp-uniform: call with
// the whole warp.
__device__ __forceinline__ int64_t matched_value(const int64_t* values,
                                                 const RowSearch& r,
                                                 int lane) {
  if (r.any == 0 || values == nullptr) return 0;
  unsigned long long v = 0;
  if (r.match_lo) v += static_cast<unsigned long long>(values[2 * lane]);
  if (r.match_hi) v += static_cast<unsigned long long>(values[2 * lane + 1]);
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return static_cast<int64_t>(v);
}

}  // namespace dex
