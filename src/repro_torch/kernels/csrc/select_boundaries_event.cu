// The `event` boundary automaton over given (B, n) bitmaps on Hopper.
//
// The device form of repro/core/automaton.py:_scan_event with
// select_boundaries' fix-up (automaton.py:426-433): exclusive prefix sums
// of both bitmaps, then a walk that jumps from event to event (an emit or
// a skip), finding the next candidate at or after the scan position k and
// the skip trigger by a search over those sums.  The reference runs the
// walk as a lax.while_loop on the TPU (it has no Pallas kernel of its
// own).  Its callers are the `wide` select kernel's (select_boundaries.cu)
// with step_impl="event".  Per row, bit for bit:
//   bounds (B, mc) int32, sentinel 1<<30 past the kept chunks;
//   counts (B,) int32.
// The walk stops when s >= n or cnt == mc, as the reference's while_loop
// condition does, so at an undersized mc the count is mc plus the
// fix-up's one, not every emit (the `wide` and `gather` count).
//
// Bound on this card: memory.  The function needs each bitmap byte once
// (2 * B * n bytes) and writes 4 bytes per bound slot and a count per row:
// least time (2 * B * n + 4 * B * mc + 4 * B) / 3.35 TB/s.
//
// Design.  The walk is serial along a row, but the state after every emit
// is the same function of the emit's bound (boundary_chain.cuh: the
// exactness argument; here k = bound + sub_min and c = 0 after every
// event), so the walk runs from every candidate's emit at once, on every
// SM, and one short chase a row links the results.  The prefix sums are
// in two levels, in scratch the wrapper allocates with the chain's tables
// (the design's, not the function's: the bound does not count it).  Five
// launches behind one call:
//
// 1. select_boundaries_event_prefix_kernel, one warp per group of 1024
//    positions of the batch on every SM (bitmap_words.cuh): lane i packs
//    word i of the group's candidate and opposing bitmaps, and a warp
//    prefix sum of both popcounts at once (candidates in the low 16 bits,
//    opposing pairs in the high 16: a group holds at most 1024 of each)
//    gives each word's exclusive in-group prefix.  Per group a record
//    (B, G, 3, 32) uint32: cand[i], opp[i], ex[i]; and the group's two
//    totals in sums (B, G + 1, 2) uint32.
// 2. select_boundaries_event_scan_kernel, one CTA of 1024 threads a row:
//    the row's group totals into their exclusive prefix in place (each
//    thread a contiguous run of groups, a block scan of the runs), the
//    row's totals at [G]; the prefix of either bitmap at any position x
//    is then sums[x / 1024] + ex[x / 32 % 32] + popc(word below bit
//    x % 32).  Before the nodes, because every node CTA reads it.
// 3. select_boundaries_event_nodes_kernel, one CTA of 8 warps a window of
//    4096 positions of a row, on every SM: the window's nodes
//    (boundary_chain.cuh) in shared memory, a warp a node walking from
//    (b + sub_min, 0, b) one iteration per event, every lane on the same
//    registers, to its first candidate's emit:
//      kk = clip(k, 0, n); rank_c, rank_o = the prefixes at kk;
//      kc = the candidate of rank rank_c (if rank_c < its total);
//      kt = the opposing pair of rank rank_o + T - c (if below its
//           total; c is 0 at every event, as in the reference);
//    then the reference's resolution (cut first, then the candidate, else
//    the skip).  Either bit, where it lies in the group holding kk, is
//    found there: lanes read the group's words with the prefixes, a
//    ballot gives the first candidate at or after kk, a warp prefix sum
//    of the opposing pairs at or after kk the pair T + 1.  Else the search
//    for the bit of rank r from group g0 = kk / 1024
//    (the reference's searchsorted): lanes probe the 32 groups after g0 at
//    once (a ballot finds the last group whose prefix is <= r); past them,
//    a 32-way search over the row's remaining groups, each step one probe
//    a lane, at most ceil(log32 G) steps; within the group, lanes read
//    the 32 ex entries at once for the word, and wblock::nth_bit finds the
//    bit.  The registers are 64-bit, so rank_o + T + 1 cannot overflow
//    for the selectors' T = 2^30.
// 4. select_boundaries_event_jump_kernel and
// 5. select_boundaries_event_chase_kernel: boundary_chain.cuh's jump
//    table and chase, stopping at the mc-th emit (the event count); the
//    chase's stop lim is n (a k past n clips to n, where the cut fires).
#include <cstdint>
#include <cuda_runtime.h>

#include "bitmap_words.cuh"
#include "boundary_chain.cuh"
#include "wblock.cuh"

namespace {

using bitmap_words::kGroup;
using wblock::kBig;
using wblock::kFull;

constexpr int kRecWords = 3 * 32;  // cand, opp, ex
constexpr int kPrefixThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kNodeThreads = 256;  // a warp a node

struct EventParams {
  long long n;
  int mc, L, T, skip, sub_min, max_size;
};

__global__ void __launch_bounds__(kPrefixThreads)
select_boundaries_event_prefix_kernel(const uint8_t* __restrict__ cand,
                                      const uint8_t* __restrict__ opp,
                                      uint32_t* __restrict__ rec,
                                      uint2* __restrict__ sums, int B,
                                      long long n, long long G) {
  const long long grp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (grp >= (long long)B * G) return;  // the whole warp
  const long long b = grp / G;
  const long long g = grp - b * G;
  unsigned cw, ow;
  bitmap_words::pack_group(cand + b * n, opp + b * n, g * kGroup, n, lane, cw,
                           ow);
  const unsigned pc = __popc(cw) | (__popc(ow) << 16);
  const unsigned incl = bitmap_words::warp_inclusive_sum(pc, lane);
  uint32_t* dst = rec + grp * kRecWords;
  dst[lane] = cw;
  dst[32 + lane] = ow;
  dst[64 + lane] = incl - pc;
  if (lane == 31)
    sums[b * (G + 1) + g] = make_uint2(incl & 0xffffu, incl >> 16);
}

__device__ __forceinline__ unsigned field(uint2 v, int f) {
  return f ? v.y : v.x;
}

// The exclusive block-wide sum of (x, y) over the CTA's threads; every
// thread also gets the totals.  warp_sums: 2 * 32 shared words.
__device__ __forceinline__ uint2 block_exclusive(uint2 v, uint2& total,
                                                 unsigned* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned ix = bitmap_words::warp_inclusive_sum(v.x, lane);
  const unsigned iy = bitmap_words::warp_inclusive_sum(v.y, lane);
  if (lane == 31) {
    warp_sums[warp] = ix;
    warp_sums[32 + warp] = iy;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    const unsigned wx = lane < nw ? warp_sums[lane] : 0u;
    const unsigned wy = lane < nw ? warp_sums[32 + lane] : 0u;
    const unsigned sx = bitmap_words::warp_inclusive_sum(wx, lane);
    const unsigned sy = bitmap_words::warp_inclusive_sum(wy, lane);
    warp_sums[lane] = sx - wx;  // exclusive, by warp
    warp_sums[32 + lane] = sy - wy;
    if (lane == 31) {
      warp_sums[64] = sx;
      warp_sums[65] = sy;
    }
  }
  __syncthreads();
  total = make_uint2(warp_sums[64], warp_sums[65]);
  return make_uint2(warp_sums[warp] + ix - v.x,
                    warp_sums[32 + warp] + iy - v.y);
}

// The row's exclusive prefix of field f at position x (0 <= x <= n); every
// lane on the same values.
__device__ __forceinline__ unsigned prefix_at(const uint32_t* rec,
                                              const uint2* sums, long long G,
                                              long long x, int f) {
  const long long g = x / kGroup;
  if (g >= G) return field(sums[G], f);
  const uint32_t* r = rec + g * kRecWords;
  const int w = (int)((x >> 5) & 31);
  const unsigned below = (1u << (x & 31)) - 1u;
  const unsigned ex = r[64 + w];
  return field(sums[g], f) + (f ? ex >> 16 : ex & 0xffffu) +
         __popc(r[32 * f + w] & below);
}

// The position of the bit of rank r (0-based) of field f, given that it
// lies in group g0 or later (r >= the prefix at the start of g0) and
// exists (r < the row's total); by the whole warp, every lane on the same
// values.
__device__ __forceinline__ long long find_rank(const uint32_t* rec,
                                               const uint2* sums, long long G,
                                               long long g0, unsigned r,
                                               int f, int lane) {
  // the group: the last g >= g0 with sums[g] <= r (sums[G] > r)
  long long g;
  {
    const long long probe = g0 + 1 + lane;
    const bool past = probe >= G || field(sums[probe], f) > r;
    const unsigned m = __ballot_sync(kFull, past);
    if (m) {
      g = g0 + __ffs(m) - 1;
    } else {  // 32-way search of (g0 + 32, G): sums[lo] <= r < sums[hi]
      long long lo = g0 + 32, hi = G;
      while (hi - lo > 1) {
        const long long stride = (hi - lo + 31) / 32;
        const long long at = lo + stride * (lane + 1);
        const bool over = at >= hi || field(sums[at], f) > r;
        const int l = __ffs(__ballot_sync(kFull, over)) - 1;  // lane 31 over
        const long long nlo = lo + stride * l;
        const long long nhi = lo + stride * (l + 1);
        lo = nlo;
        hi = nhi < hi ? nhi : hi;
      }
      g = lo;
    }
  }
  // the word: the last i with ex[i] <= r - sums[g], lanes reading all 32
  const uint32_t* rg = rec + g * kRecWords;
  const unsigned rr = r - field(sums[g], f);
  const unsigned ex_l = rg[64 + lane];
  const unsigned ex = f ? ex_l >> 16 : ex_l & 0xffffu;
  const int w = __popc(__ballot_sync(kFull, ex <= rr)) - 1;
  const unsigned word = __shfl_sync(kFull, rg[32 * f + lane], w);
  const unsigned ex_w = __shfl_sync(kFull, ex, w);
  return g * kGroup + 32 * w + wblock::nth_bit(word, (int)(rr - ex_w) + 1);
}

__global__ void __launch_bounds__(kScanThreads)
select_boundaries_event_scan_kernel(uint2* sums_all, long long G) {
  __shared__ unsigned warp_sums[66];
  const int tid = threadIdx.x;
  uint2* sums = sums_all + blockIdx.x * (G + 1);
  const long long run = (G + kScanThreads - 1) / kScanThreads;
  const long long g_lo = tid * run < G ? tid * run : G;
  const long long g_hi = g_lo + run < G ? g_lo + run : G;
  uint2 acc = make_uint2(0u, 0u);
  for (long long g = g_lo; g < g_hi; ++g) {
    const uint2 v = sums[g];
    acc.x += v.x;
    acc.y += v.y;
  }
  uint2 total;
  uint2 ex = block_exclusive(acc, total, warp_sums);
  for (long long g = g_lo; g < g_hi; ++g) {
    const uint2 v = sums[g];
    sums[g] = ex;
    ex.x += v.x;
    ex.y += v.y;
  }
  if (tid == 0) sums[G] = total;
}

// The walk from an emit at b, state (b + sub_min, 0, b), to its first
// candidate's emit (its bound), or chain::kEnd if the row ends first; by
// the whole warp, every lane on the same values.  An event's reads: the
// prefixes at kk, and lane i word i of both bitmaps in the group holding
// kk, all at once; where the candidate of rank rank_c (the first at or
// after kk) or the opposing pair of rank rank_o + T (the pair T + 1 at or
// after kk) lies in that group, a ballot or a warp prefix sum over those
// words finds it, else find_rank.
__device__ __forceinline__ int node_walk(const uint32_t* rec,
                                         const uint2* sums, long long G,
                                         uint2 total, long long b,
                                         const EventParams& P, int lane) {
  const long long n = P.n;
  long long k = b + P.sub_min, s = b;
  while (s < n) {
    const long long kk = k < 0 ? 0 : (k > n ? n : k);
    const long long g0 = kk / kGroup;
    const unsigned rank_c = prefix_at(rec, sums, G, kk, 0);
    const unsigned rank_o = prefix_at(rec, sums, G, kk, 1);
    unsigned cm = 0, om = 0;  // the group's bits at or after kk
    if (g0 < G) {
      const uint32_t* r = rec + g0 * kRecWords;
      const int xo = (int)(kk - g0 * kGroup), wx = xo >> 5;
      const unsigned keep =
          lane > wx ? kFull : (lane == wx ? kFull << (xo & 31) : 0u);
      cm = r[lane] & keep;
      om = r[32 + lane] & keep;
    }
    long long kc = kBig, kt = kBig;
    if (rank_c < total.x) {
      const unsigned cb = __ballot_sync(kFull, cm != 0);
      if (cb) {
        const int l = __ffs(cb) - 1;
        kc = g0 * kGroup + 32 * l + __ffs(__shfl_sync(kFull, cm, l)) - 1;
      } else {
        kc = find_rank(rec, sums, G, g0, rank_c, 0, lane);
      }
    }
    // c is 0 at every iteration: each event resets the counter
    const long long want = (long long)rank_o + P.T + 1;  // 1-based rank
    if (want <= (long long)total.y) {
      const unsigned pc = __popc(om);
      const unsigned incl = bitmap_words::warp_inclusive_sum(pc, lane);
      const long long need = want - rank_o;  // T + 1 at or after kk
      if (need <= (long long)__shfl_sync(kFull, incl, 31)) {
        const unsigned excl = incl - pc;
        const int l =
            __ffs(__ballot_sync(kFull, excl < need && need <= incl)) - 1;
        const int bit = wblock::nth_bit(om, (int)(need - excl));
        kt = g0 * kGroup + 32 * l + __shfl_sync(kFull, bit, l);
      } else {
        kt = find_rank(rec, sums, G, g0, (unsigned)(want - 1), 1, lane);
      }
    }
    const long long cut_b = s + P.max_size < n ? s + P.max_size : n;
    const long long cut_k = cut_b - (P.L - 1);
    const long long e_cut = cut_k > k ? cut_k : k;
    if (e_cut <= (kc < kt ? kc : kt)) {  // the cut
      s = cut_b;
      k = cut_b + P.sub_min;
    } else if (kc < kt) {
      return (int)(kc + P.L);
    } else {
      k = kt + P.skip;
    }
  }
  return chain::kEnd;
}

__global__ void __launch_bounds__(kNodeThreads)
select_boundaries_event_nodes_kernel(const uint32_t* __restrict__ recs,
                                     const uint2* __restrict__ sums_all,
                                     int32_t* __restrict__ nxt_all,
                                     EventParams P, long long G,
                                     long long nwin) {
  __shared__ int list[chain::kWindow + 1];
  __shared__ unsigned warp_tot[kNodeThreads / 32];
  const long long row = blockIdx.x / nwin, w = blockIdx.x % nwin;
  const uint32_t* rec = recs + row * G * kRecWords;
  const uint2* sums = sums_all + row * (G + 1);
  const int cnt = chain::window_nodes<kNodeThreads>(
      rec, kRecWords, G, w * chain::kWindow, P.n, P.L, list, warp_tot);
  const uint2 total = sums[G];
  int32_t* nxt = nxt_all + row * (P.n + 1);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < cnt; i += kNodeThreads / 32) {
    const int x = list[i];
    const int e = node_walk(rec, sums, G, total, x, P, lane);
    if (lane == 0) nxt[x] = e;
  }
}

__global__ void __launch_bounds__(kNodeThreads)
select_boundaries_event_jump_kernel(const uint32_t* __restrict__ recs,
                                    const int32_t* __restrict__ nxt,
                                    int2* __restrict__ jmp,
                                    chain::ChainParams C, int L, long long G,
                                    long long nwin) {
  __shared__ int list[chain::kWindow + 1];
  __shared__ unsigned warp_tot[kNodeThreads / 32];
  chain::jump_body<kNodeThreads>(recs, kRecWords, G, nxt, jmp, C, L, nwin,
                                 list, warp_tot);
}

__global__ void __launch_bounds__(chain::kChaseThreads)
select_boundaries_event_chase_kernel(const int32_t* __restrict__ nxt,
                                     const int2* __restrict__ jmp,
                                     int32_t* __restrict__ bounds,
                                     int32_t* __restrict__ counts,
                                     int32_t* __restrict__ stats,
                                     chain::ChainParams C) {
  chain::chase_body(nxt, jmp, bounds, counts, stats, C, false);
}

}  // namespace

extern "C" int select_boundaries_event_launch(
    const void* cand, const void* opp, void* rec, void* sums, void* nxt,
    void* jmp, void* bounds, void* counts, void* stats, int B, long long n,
    int mc, int L, int T, int skip, int sub_min, int max_size, int K,
    void* stream) {
  if (L < 1 || mc < 1 || K < 1 || max_size < 1 || n < 0 ||
      n >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const EventParams P{n, mc, L, T, skip, sub_min, max_size};
  const chain::ChainParams C{n, n, mc, max_size, K};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const long long G = (n + kGroup - 1) / kGroup;
  const long long threads = (long long)B * G * 32;
  if (threads > 0) {
    select_boundaries_event_prefix_kernel<<<
        (unsigned)((threads + kPrefixThreads - 1) / kPrefixThreads),
        kPrefixThreads, 0, st>>>(static_cast<const uint8_t*>(cand),
                                 static_cast<const uint8_t*>(opp),
                                 static_cast<uint32_t*>(rec),
                                 static_cast<uint2*>(sums), B, n, G);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    select_boundaries_event_scan_kernel<<<B, kScanThreads, 0, st>>>(
        static_cast<uint2*>(sums), G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long nwin = (n + chain::kWindow - 1) / chain::kWindow;
    const unsigned grid = (unsigned)(B * nwin);
    select_boundaries_event_nodes_kernel<<<grid, kNodeThreads, 0, st>>>(
        static_cast<const uint32_t*>(rec), static_cast<const uint2*>(sums),
        static_cast<int32_t*>(nxt), P, G, nwin);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    select_boundaries_event_jump_kernel<<<grid, kNodeThreads, 0, st>>>(
        static_cast<const uint32_t*>(rec), static_cast<const int32_t*>(nxt),
        static_cast<int2*>(jmp), C, L, G, nwin);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // n = 0: no node; the chase writes the sentinels and count 0
  select_boundaries_event_chase_kernel<<<B, chain::kChaseThreads, 0, st>>>(
      static_cast<const int32_t*>(nxt), static_cast<const int2*>(jmp),
      static_cast<int32_t*>(bounds), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(stats), C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* select_boundaries_event_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
