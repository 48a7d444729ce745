// Bool bitmaps turned into 32-bit words by one warp, shared by
// select_boundaries.cu, select_boundaries_gather.cu and
// select_boundaries_event.cu.
//
// A group is 1024 positions of a row: 32 words of each bitmap.  Bit q of
// word i of group g is position 1024g + 32i + q, zero past the row.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bitmap_words {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 1024;  // positions a group
constexpr int kWords = 32;    // words a group and bitmap

// By one warp: lane i returns word i of the candidate (cw) and opposing
// (ow) bitmaps of the group starting at position p0 of rows crow and orow
// (n bytes each).  Each load reads 32 neighbouring bytes; __ballot_sync
// turns a step's 32 bytes into one word, which lane r of step r keeps.
__device__ __forceinline__ void pack_group(const uint8_t* __restrict__ crow,
                                           const uint8_t* __restrict__ orow,
                                           long long p0, long long n,
                                           int lane, unsigned& cw,
                                           unsigned& ow) {
  uint8_t cv[32], ov[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const long long pos = p0 + 32 * r + lane;
    cv[r] = pos < n ? crow[pos] : 0;
    ov[r] = pos < n ? orow[pos] : 0;
  }
  cw = ow = 0;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const unsigned c = __ballot_sync(kFull, cv[r] != 0);
    const unsigned o = __ballot_sync(kFull, ov[r] != 0);
    if (lane == r) {
      cw = c;
      ow = o;
    }
  }
}

// The warp's inclusive prefix sum of v over its lanes.
__device__ __forceinline__ unsigned warp_inclusive_sum(unsigned v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

}  // namespace bitmap_words
