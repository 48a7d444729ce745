// The W-block scan's shared pieces, used by fused_pipeline.cu,
// packed_pipeline.cu and select_boundaries.cu.
//
// The kernels give one 8-warp block a row and walk its tiles in order:
// per tile of kTile positions the warps turn the tile's candidate/opposing
// bits (byte compares of a staged tile, or given bitmaps) into 32-bit words
// with __ballot_sync, and warp 0 resolves
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

// Warp 0's walk over the W-blocks of the tile starting at t0, whose mask
// words are in scand/sopp: per block, block_search and the reference's
// _resolve (repro/core/automaton.py), every lane on the same values.  A
// block the scan position has passed is a no-op in the split path (its
// state is unchanged), so the walk jumps to the block holding k.  Emitted
// bounds (and, where ln is not null, chunk lengths) go to the row's table
// as they come; emits past mc are counted and dropped, as the split path's
// mode="drop" scatter drops them.
__device__ __forceinline__ void scan_tile(ScanState& st, const uint32_t* scand,
                                          const uint32_t* sopp, long long t0,
                                          const ScanParams& P, int32_t* bnd,
                                          int32_t* ln, int lane) {
  const int W = P.W;
  const long long tend = t0 + kTile;
  const long long blk_end = tend < P.cover ? tend : P.cover;
  long long k = st.k, c = st.c, s = st.s, cnt = st.cnt,
            last_kept = st.last_kept;
  long long bstart = (k / W) * W;
  if (bstart < t0) bstart = t0;
  while (bstart < blk_end && s < P.n) {
    const long long bend = bstart + W;
    if (k >= bend) {  // not in_block: state unchanged, jump to k's block
      const long long to = (k / W) * W;
      bstart = to > bend ? to : bend;
      continue;
    }
    const long long o = k > bstart ? k - bstart : 0;  // first active pos
    const BlockHit h = block_search(scand, sopp, (int)(bstart - t0), W, o,
                                    bstart, c, P.T, lane);
    const long long kc = h.kc, kt = h.kt;
    // _resolve (in_block holds here)
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
      k = bound + P.sub_min;
    else if (fire_trig)
      k = kt + P.skip;
    else
      k = bend;
    c = (fire_cut || fire_cand || fire_trig) ? 0 : c + h.total;
    if (emit) {
      if (cnt < P.mc) {  // the split path's mode="drop" scatter
        if (lane == 0) {
          bnd[cnt] = (int32_t)bound;
          if (ln) ln[cnt] = (int32_t)(bound - s);
        }
        last_kept = bound;
      }
      ++cnt;
      s = bound;
    }
    bstart = bend;
  }
  st = ScanState{k, c, s, cnt, last_kept};
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
