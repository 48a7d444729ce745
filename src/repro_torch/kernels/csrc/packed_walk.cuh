// The segment-parallel packed automaton, shared by packed_pipeline.cu
// (walk_segments, mask words computed from the row's bytes) and
// select_boundaries_packed.cu (take_segments with a walk of its own: words
// built from the resident bitmap bytes a window at a time, no pack pass,
// and a trigger search from a window prefix).
//
// The packed automaton (repro/core/automaton.py:_scan_wide_packed) resets
// at every segment end, and the per-segment mask clip keeps every bit of a
// segment inside it, so a packed row's bounds are each segment's own
// bounds, chunked alone, plus its offset: the segments of a row are
// independent streams.  One CTA of kWarps warps a row, in three steps with
// a barrier between each:
//
// 1. classify: every thread takes entries of the ends table.  A segment
//    shorter than min_size is one chunk, its own length: no candidate fits
//    before sub_min + L and the only cut is the segment end (max_size >=
//    min_size).  Longer segments go on a list.
// 2. walk_segments: the warps take the listed segments from a shared
//    counter and walk each as its own stream of length l with wblock.cuh's
//    walk_windows, resolve and final_cut (take_segments: the same with the
//    caller's walk, which ends in final_cut).  A warp cannot know where its
//    segment's chunks go in the row's table before the segments ahead are
//    scanned, so segment g writes its bounds at slot start_g / min_size + g
//    of a scratch area: a stream of l bytes emits at most l / min_size + 1
//    bounds (every chunk but the last is min_size or longer), and
//    start_{g+1} / min_size - start_g / min_size >= l_g / min_size, so the
//    ranges never overlap.  The longest chain is the longest segment.
// 3. place: a block-wide prefix sum over the per-segment counts places
//    segment g's bounds at [prefix_g, prefix_g + count_g) of the table,
//    only slots below mc kept (emits past mc dropped whole, every emit
//    counted), then select_boundaries_packed's fix-up at n_row.
//
// The scratch a row: G counts, the list (n / min_size + 1 entries) and the
// slots (n / min_size + G): 2 G + 2 (n / min_size) + 1 ints.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "wblock.cuh"

namespace pwalk {

using wblock::kBig;
using wblock::kFull;

// A row's scratch, cut as above.
struct Scratch {
  int32_t* cnt;   // per-segment counts, then their inclusive prefix sums
  int32_t* list;  // the segments of min_size or more
  int32_t* slot;  // segment g's bounds from start_g / min_size + g
};

template <int kWarps>
struct Shared {
  int nlong, next, wsum[kWarps];
  long long last;  // the last kept bound
};

// ends[g] clamped to the row: a malformed table cannot send a read outside
// the row
__device__ __forceinline__ long long end_at(const int32_t* ends, int g,
                                            long long n) {
  const long long e = g < 0 ? 0 : ends[g];
  return e < 0 ? 0 : e > n ? n : e;
}

// Step 1, by every thread of the CTA.  Params holds n (the row width), G
// and the automaton's integers (L, W, T, skip, sub_min, max_size, mc).
template <int kThreads, int kWarps, class Params>
__device__ __forceinline__ void classify(const Params& P,
                                         const int32_t* ends,
                                         const Scratch& sc,
                                         Shared<kWarps>& sh, int tid) {
  const int m = P.sub_min + P.L;  // min_size
  for (int g = tid; g < P.G; g += kThreads) {
    const long long st = end_at(ends, g - 1, P.n);
    const long long l = end_at(ends, g, P.n) - st;
    if (l >= m) {
      sc.list[atomicAdd(&sh.nlong, 1)] = g;
    } else {
      sc.cnt[g] = l > 0;
      if (l > 0) sc.slot[st / m + g] = (int32_t)l;
    }
  }
}

// Step 2, by every warp.  wait(st, l) runs before a segment's walk (the
// whole warp); words(st, l, wstart, cw, ow) gives lane i the candidate and
// opposing words of segment positions wstart + 32i .. wstart + 32i + 31,
// zero at and past l.
template <int kWarps, class Params, class Wait, class Words>
__device__ __forceinline__ void walk_segments(const Params& P,
                                              const int32_t* ends,
                                              const Scratch& sc,
                                              Shared<kWarps>& sh, int lane,
                                              Wait&& wait, Words&& words) {
  const int m = P.sub_min + P.L;
  const int W = P.W, L = P.L;
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(&sh.next, 1);
    i = __shfl_sync(kFull, i, 0);
    if (i >= sh.nlong) break;
    const int g = sc.list[i];
    const long long st = end_at(ends, g - 1, P.n);
    const long long l = end_at(ends, g, P.n) - st;
    wait(st, l);
    const wblock::ScanParams SP{
        l, (l + P.skip + W + W - 1) / W * W, (int)(l / m) + 1, L, W, P.T,
        P.skip, P.sub_min, P.max_size};
    int32_t* sb = sc.slot + st / m + g;
    wblock::ScanState ss{P.sub_min, 0, 0, 0, 0};
    wblock::walk_windows(
        ss, SP, W - 1, sb, nullptr, lane,
        [&](long long wstart, unsigned& cw, unsigned& ow) {
          words(st, l, wstart, cw, ow);
        });
    if (lane == 0) sc.cnt[g] = (int32_t)wblock::final_cut(ss, SP, sb, nullptr);
  }
}

// Step 2 with the walk the caller's, by every warp: warp w takes listed
// segment w, then the next from the shared counter, as walk_segments does;
// walk(st, l, SP, sb) runs the whole walk of segment [st, st + l) (SP its
// scan parameters, sb its slots) and returns its count, every emit
// counted.  Its integers are 32-bit (a row is at most 65,536 bytes) and W a
// power of two.
template <int kWarps, class Params, class Walk>
__device__ __forceinline__ void take_segments(const Params& P,
                                              const int32_t* ends,
                                              const Scratch& sc,
                                              Shared<kWarps>& sh, int warp,
                                              int lane, Walk&& walk) {
  const int m = P.sub_min + P.L;
  const int W = P.W, nlong = sh.nlong;
  for (int i = warp; i < nlong;) {
    const int g = sc.list[i];
    const int st = (int)end_at(ends, g - 1, P.n);
    const int l = (int)end_at(ends, g, P.n) - st;
    const wblock::ScanParams SP{
        l, (l + P.skip + W + W - 1) & -W, l / m + 1, P.L, W, P.T,
        P.skip, P.sub_min, P.max_size};
    const long long c = walk(st, l, SP, sc.slot + st / m + g);
    int j = 0;
    if (lane == 0) {
      sc.cnt[g] = (int32_t)c;
      j = atomicAdd(&sh.next, 1);
    }
    i = kWarps + __shfl_sync(kFull, j, 0);
  }
}

// Step 3, by every thread of the CTA: the row's table bnd (mc slots), its
// lengths ln where kLens, and its count.
template <int kThreads, int kWarps, bool kLens, class Params>
__device__ __forceinline__ void place(const Params& P, const int32_t* ends,
                                      const Scratch& sc, Shared<kWarps>& sh,
                                      int32_t* bnd, int32_t* ln,
                                      int32_t* count, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int m = P.sub_min + P.L;
  const long long n = P.n;
  int32_t* cnt = sc.cnt;
  // -- inclusive prefix sum of the counts, in place, kThreads at a time ----
  long long total = 0;
  for (int base = 0; base < P.G; base += kThreads) {
    const int g = base + tid;
    int v = g < P.G ? cnt[g] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += u;
    }
    if (lane == 31) sh.wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kWarps ? sh.wsum[lane] : 0;
#pragma unroll
      for (int d = 1; d < kWarps; d <<= 1) {
        const int u = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += u;
      }
      if (lane < kWarps) sh.wsum[lane] = w;
    }
    __syncthreads();
    if (g < P.G)
      cnt[g] = (int32_t)(total + v + (warp ? sh.wsum[warp - 1] : 0));
    total += sh.wsum[kWarps - 1];
    __syncthreads();
  }

  // -- placement: segment g's bounds to [prefix_g, prefix_g + count_g) -----
  const long long kept = total < P.mc ? total : P.mc;
  for (int g = tid; g < P.G; g += kThreads) {
    const long long lo = g > 0 ? cnt[g - 1] : 0, hi = cnt[g];
    if (lo >= kept || hi == lo) continue;
    const long long st = end_at(ends, g - 1, n);
    const int32_t* sb = sc.slot + st / m + g;
    int32_t prev = 0;
    for (long long j = lo; j < hi && j < kept; ++j) {
      const int32_t v = sb[j - lo];
      bnd[j] = (int32_t)(st + v);
      if (kLens) ln[j] = v - prev;
      prev = v;
      if (j == kept - 1) sh.last = st + v;
    }
  }
  for (long long j = kept + tid; j < P.mc; j += kThreads) {
    bnd[j] = kBig;
    if (kLens) ln[j] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    // select_boundaries_packed's fixup at the payload end.  With every emit
    // kept the last bound is n_row (each segment ends in its own end), so
    // it fires only when an emit was dropped: a count, no table slot.
    const long long n_row = end_at(ends, P.G - 1, n);
    const long long last = kept > 0 ? sh.last : 0;
    long long c = total;
    if (last < n_row && n_row > 0) {
      if (c < P.mc) {
        bnd[c] = (int32_t)n_row;
        if (kLens) ln[c] = (int32_t)(n_row - last);
      }
      ++c;
    }
    *count = (int32_t)c;
  }
}

}  // namespace pwalk
