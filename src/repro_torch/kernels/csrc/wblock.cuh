// The W-block scan's shared pieces, used by fused_pipeline.cu,
// select_boundaries.cu and (through packed_walk.cuh) packed_pipeline.cu and
// select_boundaries_packed.cu.
//
// The first three walk a stream event by event over windows of kWin
// positions (walk_windows): lane i holds word i of the window's candidate
// and opposing bits, and block_search_words and resolve find and apply the
// next event.  fused_pipeline.cu and packed_pipeline.cu compute a window's
// words from the stream's bytes in shared memory (mask_word: a row fed
// through a ring, a packed row resident whole); select_boundaries.cu reads
// them from bitmaps turned into words.  select_boundaries_packed.cu walks
// the same windows with a loop of its own: it builds a window's words from
// the resident bitmap bytes and searches an event from the window's
// opposing prefix (its window_hit finds what block_search_words finds),
// then applies resolve and final_cut.  W <= 1024, so at most 32 words a
// block.  select_boundaries_gather.cu resolves a block from its tables
// with resolve and nth_bit (one W-block a step, not a window), and
// select_boundaries_event.cu finds a rank's bit with nth_bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "modp.cuh"

namespace wblock {

using modp::kFull;

constexpr int kMaxHalo = 64;  // L - 1 <= 64: mask_word<24> takes L <= 65
constexpr int kBig = 1 << 30;
constexpr int kWin = 1024;  // positions a search window: 32 words

__device__ __forceinline__ unsigned low_bits(long long count) {
  return count >= 32 ? kFull : count <= 0 ? 0u : (1u << count) - 1u;
}

// Four 0x00/0xff bytes -> four bits (byte j -> bit j)
__device__ __forceinline__ unsigned byte_bits(uint32_t v) {
  return ((v & 0x01010101u) * 0x01020408u) >> 24;
}

// The candidate and opposing words of the 32 positions from p0 (bit q is
// position p0 + q) of a stream of n bytes whose position p0 is byte v0 of
// the shared buffer rb: 4 positions a step with byte-wise compares
// (__vcmpgtu4/__vcmpltu4) of unaligned words, which the lane assembles from
// aligned 4-byte loads (word index & wrap: a ring of a power-of-two size
// passes its word mask, a resident buffer -1).  Bit t of (lo, hi) is the
// pair (p0 + t, p0 + t + 1) continuing a run (increasing, or decreasing); a
// candidate is L-1 of them in a row.  Positions whose pair or run leaves
// the stream are not set.  Reads at most 104 bytes from v0, none when
// p0 >= n - 1.  kG bounds the steps: 10 for L <= 7, 24 for L <= 65.
template <int kG>
__device__ __forceinline__ void mask_word(const uint8_t* rb, int v0,
                                          long long p0, long long n, int L,
                                          int inc, int wrap, unsigned& cw,
                                          unsigned& ow) {
  cw = ow = 0;
  if (p0 >= n - 1) return;  // no pair starts in the word
  const uint32_t* r32 = reinterpret_cast<const uint32_t*>(rb);
  const int sh = (v0 & 3) * 8;
  const int w0 = v0 >> 2;
  const int G = (33 + L) >> 2;  // steps covering positions p0 .. p0+29+L
  uint32_t cur_w = r32[w0 & wrap], nxt_w = r32[(w0 + 1) & wrap];
  unsigned long long lo = 0;
  unsigned hi = 0, opp = 0;
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    if (j < G) {
      const uint32_t cur = __funnelshift_rc(cur_w, nxt_w, sh);
      const uint32_t nx = __funnelshift_rc(cur_w, nxt_w, sh + 8);
      const uint32_t up = __vcmpgtu4(nx, cur), dn = __vcmpltu4(nx, cur);
      const unsigned run = byte_bits(inc ? up : dn);
      if (4 * j < 64)
        lo |= (unsigned long long)run << (4 * j);
      else
        hi |= run << (4 * j - 64);
      if (j < 8) opp |= byte_bits(inc ? dn : up) << (4 * j);
      cur_w = nxt_w;
      nxt_w = r32[(w0 + 2 + j) & wrap];
    }
  }
  const unsigned long long mid = (lo >> 32) | ((unsigned long long)hi << 32);
  unsigned cand = kFull;
#pragma unroll
  for (int t = 0; t < 4 * kG - 32; ++t)
    if (t <= L - 2)
      cand &= t < 32 ? (unsigned)(lo >> t) : (unsigned)(mid >> (t - 32));
  cw = cand & low_bits(n - L - p0 + 1);  // runs inside the stream
  ow = opp & low_bits(n - 1 - p0);       // pairs inside the stream
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
// them.  Returns 0 (no emit), 1 (a cut) or 2 (a candidate's emit).
__device__ __forceinline__ int resolve(ScanState& st, const BlockHit& h,
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
  return emit ? (emit_cut ? 1 : 2) : 0;
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
