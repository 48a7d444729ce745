// The node table and the chase, shared by select_boundaries_gather.cu and
// select_boundaries_event.cu: a row's boundaries found in parallel over
// every SM, then linked in one short chase.
//
// Why it is exact.  Both steps leave the same state after every emit at a
// bound b: (k, c, s) = (b + sub_min, 0, b) (the reference's _resolve and
// new_c, repro/core/automaton.py; _scan_event's body).  So what a row emits
// after b depends on b alone, and the emits form a chain.  Every emit is
// one of two kinds: a candidate's emit at kc + L (kc a set candidate bit)
// or a cut at min(s + max_size, n).  A node is a place the chain can stand
// after a candidate's emit: position 0 (the row's start, the same state
// with b = 0) and c + L for every candidate c.  From a node at b, the walk
// runs the kernel's own step until the first candidate's emit e (its
// node's entry) or until the row ends (kEnd).  Between b and e it can only
// cut, and a cut from s lands at s + max_size (s + max_size < e <= n, since
// the candidate fires only before the cut position): the cuts are b +
// j * max_size for j = 1 .. m, and e - b lies in (m * max_size, (m + 1) *
// max_size] because e is at most the next cut, so m = ceil((e - b) /
// max_size) - 1.  One int32 a node suffices.  A node at kEnd cuts at
// min(b + j * max_size, n), j = 1, 2, .., and stops at the first such s at
// or past lim: n, or (gather) cover - sub_min, where the reference's scan
// stops because the next scan position s + sub_min lies past its padded
// block range.  A node at or past lim emits nothing (the chain's end).
//
// The three tables are the design's scratch (the bounds do not count
// them), each indexed by position, n + 1 entries a row:
//   nxt (B, n + 1) int32   a node's next candidate's emit, or kEnd
//   jmp (B, n + 1) int2    its K-th successor along nxt (fewer where the
//                          chain ends first) and the emits on the way
// Only node positions are written or read.
//
// The stages after each kernel's own table launch:
// 1. nodes: one CTA a window of kWindow positions of a row, on every SM;
//    window_nodes lists the window's nodes in shared memory from the
//    candidate words of the kernel's records, and each kernel walks them
//    with its own step (gather a thread a node, event a warp a node).
// 2. jump_body: the same windows; a thread a node follows nxt K times.
// 3. chase_body: one CTA a row.  Thread 0 hops along jmp from node 0, a
//    dependent read each K nodes, and notes each hop's node and emit
//    index (an anchor) while the index is below max_chunks; each batch of
//    kChaseThreads anchors is expanded in parallel, a thread writing an
//    anchor's K edges (its cuts, then its candidate's emit) at their
//    indices.  The CTA then writes the last node's run of cuts, and thread
//    0 select_boundaries' fix-up (the final boundary n).  count_all: the
//    gather count (every emit, writes below max_chunks); else the event
//    count (the reference's while_loop stops at the max_chunks-th emit),
//    plus the fix-up's one either way.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bitmap_words.cuh"
#include "wblock.cuh"

namespace chain {

constexpr int kEnd = -1;        // the node's walk ends the row
constexpr int kWindow = 4096;   // positions a node or jump CTA
constexpr int kWindowWords = kWindow / 32;
constexpr int kChaseThreads = 256;  // anchors a batch

struct ChainParams {
  long long n;    // row length
  long long lim;  // a node at or past lim ends the chain
  int mc, max_size, K;
};

// The nodes of positions [w0, w0 + kWindow) of a row (w0 a multiple of
// kWindow) into list, node 0 first where w0 = 0: position 0 and c + L for
// each candidate c of the window with c + L < lim.  rec_row: the row's
// records, rec_words uint32 each, whose first 32 words are the group's
// candidate words.  warp_tot: kThreads / 32 shared words.  By the whole
// CTA; returns the count (at most kWindow + 1).
template <int kThreads>
__device__ __forceinline__ int window_nodes(const uint32_t* rec_row,
                                            int rec_words, long long G,
                                            long long w0, long long lim,
                                            int L, int* list,
                                            unsigned* warp_tot) {
  static_assert(kThreads >= kWindowWords && kThreads % 32 == 0,
                "a thread a candidate word");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p0 = w0 + 32LL * tid;  // bit q of the word: p0 + q
  unsigned word = 0;
  if (tid < kWindowWords) {
    const long long g = p0 / bitmap_words::kGroup;
    const long long room = lim - L - p0;  // bits below room: c + L < lim
    if (g < G && room > 0)
      word = rec_row[g * rec_words + (tid & 31)] &
             (room >= 32 ? 0xffffffffu : (1u << room) - 1u);
  }
  const unsigned pc = __popc(word);
  const unsigned incl = bitmap_words::warp_inclusive_sum(pc, lane);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  const int head = (w0 == 0 && lim > 0) ? 1 : 0;
  unsigned at = head + incl - pc, count = head;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    if (i < warp) at += warp_tot[i];
    count += warp_tot[i];
  }
  while (word) {
    list[at++] = (int)(p0 + __ffs(word) - 1 + L);
    word &= word - 1;
  }
  if (tid == 0 && head) list[0] = 0;
  __syncthreads();
  return (int)count;
}

// Emits along the edge from a node at z to its candidate's emit at v:
// m cuts and v.
__device__ __forceinline__ int edge_emits(long long z, long long v,
                                          int max_size) {
  return (int)((v - z + max_size - 1) / max_size);
}

// Stage 2, by a CTA of kThreads for window blockIdx.x % nwin of row
// blockIdx.x / nwin: each node's K-th successor along nxt.
template <int kThreads>
__device__ __forceinline__ void jump_body(const uint32_t* rec_all,
                                          int rec_words, long long G,
                                          const int32_t* nxt_all,
                                          int2* jmp_all, const ChainParams& C,
                                          int L, long long nwin, int* list,
                                          unsigned* warp_tot) {
  const long long row = blockIdx.x / nwin, w = blockIdx.x % nwin;
  const int cnt = window_nodes<kThreads>(rec_all + row * G * rec_words,
                                         rec_words, G, w * kWindow, C.lim, L,
                                         list, warp_tot);
  const int32_t* nxt = nxt_all + row * (C.n + 1);
  int2* jmp = jmp_all + row * (C.n + 1);
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    const int x = list[i];
    int z = x, emits = 0;
    for (int s = 0; s < C.K && z < C.lim; ++s) {
      const int v = nxt[z];
      if (v == kEnd) break;
      emits += edge_emits(z, v, C.max_size);
      z = v;
    }
    jmp[x] = make_int2(z, emits);
  }
}

// Stage 3, by a CTA of kChaseThreads for row blockIdx.x.  stats, where not
// null, gets the row's serial hops and expanded edges.
__device__ __forceinline__ void chase_body(const int32_t* nxt_all,
                                           const int2* jmp_all,
                                           int32_t* bounds, int32_t* counts,
                                           int32_t* stats,
                                           const ChainParams& C,
                                           bool count_all) {
  __shared__ int anchor_x[kChaseThreads], anchor_i[kChaseThreads];
  __shared__ int batch, finished, edges;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int32_t* nxt = nxt_all + row * (C.n + 1);
  const int2* jmp = jmp_all + row * (C.n + 1);
  int32_t* bnd = bounds + row * C.mc;
  for (int i = tid; i < C.mc; i += kChaseThreads) bnd[i] = wblock::kBig;
  if (tid == 0) edges = 0;
  // thread 0's hop along the chain: the node x, the emits before it
  long long x = 0, idx = 0;
  int hops = 0;
  bool done = false, last_end = false;
  __syncthreads();
  for (;;) {
    if (tid == 0) {
      int na = 0;
      while (na < kChaseThreads) {
        if (x >= C.lim || (!count_all && idx >= C.mc)) {
          done = true;
          break;
        }
        const int2 j = jmp[x];
        ++hops;
        if (j.x == x) {  // x's walk ends the row: its cuts come last
          done = last_end = true;
          break;
        }
        if (idx < C.mc) {
          anchor_x[na] = (int)x;
          anchor_i[na] = (int)idx;
          ++na;
        }
        idx += j.y;
        x = j.x;
      }
      batch = na;
      finished = done;
    }
    __syncthreads();
    const int na = batch;
    const bool fin = finished;
    if (tid < na) {  // an anchor's K edges
      int z = anchor_x[tid];
      long long i = anchor_i[tid];
      int e = 0;
      for (; e < C.K && z < C.lim && i < C.mc; ++e) {
        const int v = nxt[z];
        if (v == kEnd) break;
        for (long long cut = (long long)z + C.max_size; cut < v;
             cut += C.max_size, ++i)
          if (i < C.mc) bnd[i] = (int32_t)cut;
        if (i < C.mc) bnd[i] = v;
        ++i;
        z = v;
      }
      if (stats) atomicAdd(&edges, e);
    }
    __syncthreads();  // the batch is written before the next, or the end
    if (fin) break;
  }
  // the last node's cuts, to n or to lim: j of them from x, at idx on
  __shared__ long long end_x, end_i, end_j;
  if (tid == 0) {
    end_x = x;
    end_i = idx;
    end_j = last_end ? (C.lim - x + C.max_size - 1) / C.max_size : 0;
  }
  __syncthreads();
  for (long long t = tid; t < end_j && end_i + t < C.mc;
       t += kChaseThreads) {
    const long long cut = end_x + (t + 1) * C.max_size;
    bnd[end_i + t] = (int32_t)(cut < C.n ? cut : C.n);
  }
  __syncthreads();
  if (tid != 0) return;
  const long long total = idx + end_j;
  // select_boundaries' fix-up: the final boundary n
  long long count = count_all || total < C.mc ? total : C.mc;
  const long long last = count > 0 ? bnd[(count < C.mc ? count : C.mc) - 1]
                                   : 0;
  if (last < C.n) {
    if (count < C.mc) bnd[count] = (int32_t)C.n;
    ++count;
  }
  counts[row] = (int32_t)count;
  if (stats) {
    stats[2 * row] = hops;
    stats[2 * row + 1] = edges;
  }
}

}  // namespace chain
