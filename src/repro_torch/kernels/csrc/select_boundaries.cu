// The `wide` W-block boundary automaton over given (B, n) bitmaps on Hopper.
//
// The device form of repro/core/automaton.py:_scan_wide, as
// select_boundaries (automaton.py:409) runs it: the split path's phase 2,
// which the reference runs as a lax.scan on the TPU (it has no Pallas
// kernel of its own).  Its callers: the seqcdc chunker and the scheduler's
// split pipeline (candidate/opposing bitmaps from the masks kernel), and the
// hash-based chunkers' selector (a match bitmap, no opposing pairs, L = 1,
// T = 2^30, skip 2^20: core/baselines/selectors.py).  Per row, bit for bit:
//   bounds (B, mc) int32, sentinel 1<<30 past the kept chunks;
//   counts (B,) int32, every emit counted, kept or not.
//
// Bound on this card: memory.  The function needs each bitmap byte once
// (2 * B * n bytes) and writes 4 bytes per bound slot and a count per row:
// least time (2 * B * n + 4 * B * mc + 4 * B) / 3.35 TB/s.  The automaton
// is serial along a row, so with few rows the kernel is far from that.
//
// Design: the fused kernel's (fused_pipeline.cu) without the byte compares
// and the hashing.  One 8-warp block owns a row and walks its tiles of 4096
// positions in order; per tile every thread loads its 16 candidate and 16
// opposing bytes at once (a warp's loads are 32 neighbouring bytes), the
// warps turn them into 32-bit words with __ballot_sync, and warp 0 resolves
// the tile's W-blocks (wblock.cuh: block_search and scan_tile).  A tile the
// scan position has passed is not loaded, and the walk stops once s >= n:
// the split path's padding past n (2^20 bytes for the selectors) holds no
// event and is never read.  The scan registers are 64-bit, so T - c + 1 and
// kt + skip cannot overflow for the selectors' T = 2^30.
#include <cstdint>
#include <cuda_runtime.h>

#include "wblock.cuh"

namespace {

using wblock::kBig;
using wblock::kFull;
using wblock::kThreads;
using wblock::kTile;
using wblock::kWarps;

constexpr int kWordsPerWarp = kTile / 32 / kWarps;  // 16

__global__ void __launch_bounds__(kThreads)
select_boundaries_kernel(const uint8_t* __restrict__ cand,
                         const uint8_t* __restrict__ opp,
                         int32_t* __restrict__ bounds,
                         int32_t* __restrict__ counts,
                         wblock::ScanParams P) {
  __shared__ uint32_t scand[kTile / 32];
  __shared__ uint32_t sopp[kTile / 32];
  __shared__ long long sh_k, sh_s;  // warp 0's scan state, for every warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const long long n = P.n;
  const uint8_t* crow = cand + b * n;
  const uint8_t* orow = opp + b * n;
  int32_t* bnd = bounds + b * P.mc;
  for (int i = tid; i < P.mc; i += kThreads) bnd[i] = kBig;
  if (tid == 0) {
    sh_k = P.sub_min;
    sh_s = 0;
  }
  __syncthreads();

  wblock::ScanState st{P.sub_min, 0, 0, 0, 0};
  for (long long t0 = 0; t0 < P.cover; t0 += kTile) {
    if (sh_s >= n) break;              // the row is done
    if (sh_k >= t0 + kTile) continue;  // every block of this tile is a no-op
    // -- the tile's words: bit q of word w is position t0 + 32w + q --------
    uint8_t cv[kWordsPerWarp], ov[kWordsPerWarp];
#pragma unroll
    for (int r = 0; r < kWordsPerWarp; ++r) {
      const long long pos = t0 + (warp + r * kWarps) * 32 + lane;
      cv[r] = pos < n ? crow[pos] : 0;
      ov[r] = pos < n ? orow[pos] : 0;
    }
#pragma unroll
    for (int r = 0; r < kWordsPerWarp; ++r) {
      const unsigned cw = __ballot_sync(kFull, cv[r] != 0);
      const unsigned ow = __ballot_sync(kFull, ov[r] != 0);
      if (lane == 0) {
        scand[warp + r * kWarps] = cw;
        sopp[warp + r * kWarps] = ow;
      }
    }
    __syncthreads();
    if (warp == 0) {
      wblock::scan_tile(st, scand, sopp, t0, P, bnd, nullptr, lane);
      if (lane == 0) {
        sh_k = st.k;
        sh_s = st.s;
      }
    }
    __syncthreads();
  }
  if (tid == 0) counts[b] = (int32_t)wblock::final_cut(st, P, bnd, nullptr);
}

}  // namespace

extern "C" int select_boundaries_launch(const void* cand, const void* opp,
                                        void* bounds, void* counts, int B,
                                        long long n, long long cover, int mc,
                                        int L, int W, int T, int skip,
                                        int sub_min, int max_size,
                                        void* stream) {
  if (W < 1 || W > 1024 || (W & (W - 1)) != 0 || kTile % W != 0 || L < 1 ||
      mc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const wblock::ScanParams P{n, cover, mc, L, W, T, skip, sub_min, max_size};
  if (B > 0) {
    select_boundaries_kernel<<<B, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(cand), static_cast<const uint8_t*>(opp),
        static_cast<int32_t*>(bounds), static_cast<int32_t*>(counts), P);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* select_boundaries_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
