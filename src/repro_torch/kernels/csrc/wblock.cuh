// The W-block scan's shared pieces, used by fused_pipeline.cu and
// packed_pipeline.cu.
//
// Both kernels give one 8-warp block a row and walk its tiles in order:
// per tile of kTile positions every thread stages its share of the bytes
// (plus the L-1 halo) in shared memory, the warps turn the compares into
// 32-bit candidate/opposing words with __ballot_sync, and warp 0 resolves
// the tile's W-blocks from those words (W <= 1024, so at most 32 words a
// block: lane i takes word i).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "modp.cuh"

namespace wblock {

using modp::kFull;

constexpr int kTile = 4096;   // positions staged per tile, a multiple of W
constexpr int kMaxHalo = 64;  // L - 1 <= 64 bytes read past a tile
constexpr int kBig = 1 << 30;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = (kTile + kMaxHalo + kThreads - 1) / kThreads;

// Stages row[t0, t0 + kTile + L - 1) into sx, zero past the row end n,
// every thread with its kStage loads in flight at once.  The caller
// synchronises before reading sx.
__device__ __forceinline__ void stage_tile(uint8_t* sx, const uint8_t* row,
                                           long long t0, long long n, int L,
                                           int tid) {
  uint8_t v[kStage];
#pragma unroll
  for (int r = 0; r < kStage; ++r) {
    const int i = tid + r * kThreads;
    const long long pos = t0 + i;
    v[r] = (i < kTile + L - 1 && pos < n) ? row[pos] : 0;
  }
#pragma unroll
  for (int r = 0; r < kStage; ++r) {
    const int i = tid + r * kThreads;
    if (i < kTile + kMaxHalo) sx[i] = v[r];
  }
}

struct BlockHit {
  long long kc;  // first active candidate position, or kBig
  long long kt;  // skip-trigger position, or kBig
  int total;     // active opposing pairs in the block
};

// Warp 0's search of the W-block [bstart, bstart + W), whose mask words
// start at tile offset rel, from the scan position's offset o into the
// block: the first candidate is a warp min of __ffs, the trigger the m-th
// active opposing bit (m = T - c + 1, c <= T) found by a warp prefix sum
// of __popc.  Every lane returns the same values.
__device__ __forceinline__ BlockHit block_search(const uint32_t* scand,
                                                 const uint32_t* sopp,
                                                 int rel, int W, long long o,
                                                 long long bstart,
                                                 long long c, int T,
                                                 int lane) {
  unsigned cw = 0, ow = 0;
  if (lane < (W >= 32 ? W / 32 : 1)) {
    const unsigned wmask = W >= 32 ? kFull : ((1u << W) - 1u);
    const int sh = W >= 32 ? 0 : (rel & 31);
    cw = (scand[(rel >> 5) + lane] >> sh) & wmask;
    ow = (sopp[(rel >> 5) + lane] >> sh) & wmask;
    const long long lo = 32LL * lane;
    const unsigned act =
        o <= lo ? kFull : (o >= lo + 32 ? 0u : kFull << (o - lo));
    cw &= act;
    ow &= act;
  }
  int kc_rel = cw ? 32 * lane + __ffs(cw) - 1 : kBig;
  kc_rel = __reduce_min_sync(kFull, kc_rel);
  const int pc = __popc(ow);
  int incl = pc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int excl = incl - pc;
  const long long m = T - c + 1;
  int kt_rel = kBig;
  if (excl < m && m <= incl) {
    unsigned u = ow;
    for (long long r = 1; r < m - excl; ++r) u &= u - 1;
    kt_rel = 32 * lane + __ffs(u) - 1;
  }
  kt_rel = __reduce_min_sync(kFull, kt_rel);
  return BlockHit{kc_rel < kBig ? bstart + kc_rel : kBig,
                  kt_rel < kBig ? bstart + kt_rel : kBig, total};
}

}  // namespace wblock
