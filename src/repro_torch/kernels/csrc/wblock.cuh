// The W-block scan's shared pieces, used by fused_pipeline.cu,
// packed_pipeline.cu and select_boundaries.cu.
//
// fused_pipeline.cu and select_boundaries.cu walk a row event by event over
// windows of kWin positions (walk_windows): lane i holds word i of the
// window's candidate and opposing bits (computed from the row's bytes, or
// read from packed bitmaps), and block_search_words and resolve find and
// apply the next event.  packed_pipeline.cu gives one 8-warp block a row
// and walks its tiles in order: per tile of kTile positions the warps turn
// the staged tile's byte compares into 32-bit words with __ballot_sync, and
// warp 0 resolves the tile's W-blocks with block_search.  W <= 1024, so at
// most 32 words a block: lane i takes word i.
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
constexpr int kWin = 1024;  // positions a search window: 32 words

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

// Position of the r-th set bit of u (1 <= r <= popc(u)), by halves.
__device__ __forceinline__ int nth_bit(unsigned u, int r) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int cnt = __popc(u & ((1u << half) - 1u));
    if (cnt < r) {
      r -= cnt;
      u >>= half;
      pos += half;
    }
  }
  return pos;
}

// The search of the W-block [bstart, bstart + W) by one warp, lane i
// holding word i of the block's candidate and opposing bits (cw, ow; zero
// past the block), from the scan position's offset o into the block: the
// first candidate is a warp min of __ffs, the trigger the m-th active
// opposing bit (m = T - c + 1, c <= T) found by a warp prefix sum of
// __popc.  A window with no active bit returns at once.  Every lane
// returns the same values.
__device__ __forceinline__ BlockHit block_search_words(unsigned cw,
                                                       unsigned ow,
                                                       long long o,
                                                       long long bstart,
                                                       long long c, int T,
                                                       int lane) {
  const long long lo = 32LL * lane;
  const unsigned act =
      o <= lo ? kFull : (o >= lo + 32 ? 0u : kFull << (o - lo));
  cw &= act;
  ow &= act;
  if (!__any_sync(kFull, cw | ow)) return BlockHit{kBig, kBig, 0};
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
  if (excl < m && m <= incl)
    kt_rel = 32 * lane + nth_bit(ow, (int)(m - excl));
  kt_rel = __reduce_min_sync(kFull, kt_rel);
  return BlockHit{kc_rel < kBig ? bstart + kc_rel : kBig,
                  kt_rel < kBig ? bstart + kt_rel : kBig, total};
}

// block_search_words over the block's words in scand/sopp, which start at
// tile offset rel.
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
  }
  return block_search_words(cw, ow, o, bstart, c, T, lane);
}

// The split path's scan parameters: the row length, the padded block range
// it covers, the bounds table width and the automaton's integers.
struct ScanParams {
  long long n;      // row length
  long long cover;  // nb * W: the split path's padded block range
  int mc, L, W, T, skip, sub_min, max_size;
};

// The `wide` step's registers (warp 0's copy is the live one) and the last
// bound kept in the table, for the final-cut fix-up.
struct ScanState {
  long long k, c, s, cnt, last_kept;
};

// The reference's _resolve (repro/core/automaton.py) for the W-block
// ending at bend that holds the scan position st.k (in_block), given its
// search h; every lane on the same values.  An emitted bound (and, where
// ln is not null, the chunk length) goes to the row's table; emits past mc
// are counted and dropped, as the split path's mode="drop" scatter drops
// them.
__device__ __forceinline__ void resolve(ScanState& st, const BlockHit& h,
                                        long long bend, const ScanParams& P,
                                        int32_t* bnd, int32_t* ln, int lane) {
  const long long kc = h.kc, kt = h.kt, k = st.k, s = st.s;
  const long long cut_b = s + P.max_size < P.n ? s + P.max_size : P.n;
  const long long cut_k = cut_b - (P.L - 1);
  const long long e_cut = cut_k > k ? cut_k : k;
  const bool fire_cut = e_cut < bend && e_cut <= (kc < kt ? kc : kt);
  const bool fire_cand = !fire_cut && kc < kt;
  const bool fire_trig = !fire_cut && !fire_cand && kt < kBig;
  const bool emit_cut = fire_cut || (fire_trig && kt + P.skip >= cut_k);
  const bool emit = emit_cut || fire_cand;
  const long long bound = emit_cut ? cut_b : kc + P.L;
  if (emit)
    st.k = bound + P.sub_min;
  else if (fire_trig)
    st.k = kt + P.skip;
  else
    st.k = bend;
  st.c = (fire_cut || fire_cand || fire_trig) ? 0 : st.c + h.total;
  if (emit) {
    if (st.cnt < P.mc) {  // the split path's mode="drop" scatter
      if (lane == 0) {
        bnd[st.cnt] = (int32_t)bound;
        if (ln) ln[st.cnt] = (int32_t)(bound - s);
      }
      st.last_kept = bound;
    }
    ++st.cnt;
    st.s = bound;
  }
}

// The automaton's walk over a row by one warp, event by event: the W-block
// walk of the split path decides each block from the first candidate, the
// trigger (the m-th opposing pair counted since the last event) and the
// cut at or after k, and an event moves k past its block (W <= min(skip,
// sub_min)) unless the row is done; so the outcome depends on where the
// events fall, not on the block boundaries, and blocks the scan jumps over
// are no-ops.  The walk therefore searches a window of kWin positions from
// wstart = k & ~align (align + 1 a power of two from W to kWin): an event
// inside the window updates the state and the search repeats from the new
// k; no event moves k to the window's end with the opposing pairs counted.
// words(wstart, cw, ow) gives lane i the candidate and opposing words of
// positions wstart + 32i .. wstart + 32i + 31, zero past the row; it is
// called when k first leaves the previous window.
template <class Words>
__device__ __forceinline__ void walk_windows(ScanState& st,
                                             const ScanParams& P,
                                             long long align, int32_t* bnd,
                                             int32_t* ln, int lane,
                                             Words&& words) {
  long long wstart = -kWin;
  unsigned cw = 0, ow = 0;
  while (st.s < P.n && st.k < P.cover) {
    if (st.k >= wstart + kWin) {
      wstart = st.k & ~align;
      words(wstart, cw, ow);
    }
    const long long wend = wstart + kWin < P.cover ? wstart + kWin : P.cover;
    resolve(st,
            block_search_words(cw, ow, st.k - wstart, wstart, st.c, P.T,
                               lane),
            wend, P, bnd, ln, lane);
  }
}

// select_boundaries' fix-up (the final boundary n) by one thread; returns
// the count, every emit counted, kept or not.
__device__ __forceinline__ long long final_cut(const ScanState& st,
                                               const ScanParams& P,
                                               int32_t* bnd, int32_t* ln) {
  long long cnt = st.cnt;
  if ((cnt > 0 ? st.last_kept : 0) < P.n) {
    if (cnt < P.mc) {
      bnd[cnt] = (int32_t)P.n;
      if (ln) ln[cnt] = (int32_t)(P.n - st.s);
    }
    ++cnt;
  }
  return cnt;
}

}  // namespace wblock
