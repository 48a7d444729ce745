// The `gather` W-block boundary automaton over given (B, n) bitmaps on
// Hopper.
//
// The device form of repro/core/automaton.py:_scan_gather, as
// select_boundaries (automaton.py:409) runs it: tables built in parallel
// over every W-block, then a scan over the blocks that resolves each block
// with a constant number of table reads.  The reference runs the scan as a
// lax.scan on the TPU (it has no Pallas kernel of its own).  Its callers
// are the `wide` select kernel's (select_boundaries.cu) with
// step_impl="gather": the seqcdc chunker, the scheduler's split pipeline
// and the hash-based chunkers' selector (L = 1, T = 2^30, skip 2^20).  Per
// row, bit for bit:
//   bounds (B, mc) int32, sentinel 1<<30 past the kept chunks;
//   counts (B,) int32, every emit counted, kept or not.
//
// Bound on this card: memory.  The function needs each bitmap byte once
// (2 * B * n bytes) and writes 4 bytes per bound slot and a count per row:
// least time (2 * B * n + 4 * B * mc + 4 * B) / 3.35 TB/s.
//
// Design.  The scan is serial along a row, but the state after every emit
// is the same function of the emit's bound (boundary_chain.cuh: the
// exactness argument), so the walk runs from every candidate's emit at
// once, on every SM, and one short chase a row links the results.  Four
// launches behind one call, in scratch the wrapper allocates (the
// design's, not the function's: the bound does not count it):
//
// 1. select_boundaries_gather_tables_kernel, one warp per group of 1024
//    positions of the batch on every SM: lane i packs word i of the
//    group's candidate and opposing bitmaps and writes the group's
//    512-byte record, (B, G, 4, 32) uint32 with G = ceil(n / 1024)
//    (bitmap_words.cuh):
//      cand[i]  candidate word i (bit q: position 1024g + 32i + q)
//      opp[i]   opposing word i
//      ex[i]    opposing pairs in words 0 .. i-1 (a warp prefix sum)
//      next[i]  the group-relative position of the first candidate in
//               words i .. 31, or kNone (a warp suffix min)
//    From these, for any group-relative x: the opposing prefix
//    pre(x) = ex[x/32] + popc(opp[x/32] below bit x%32); the first
//    candidate at or after x is the lowest set bit of cand[x/32] at or
//    above x%32, else next[x/32 + 1]; and the m-th opposing pair of a
//    block is in the last of the block's words whose ex is at most m, at
//    the (m - ex)-th set bit of that word (wblock::nth_bit).  The
//    reference's opp_pref, next_cand, mth_opp and opp_total, read in
//    constant work.
// 2. select_boundaries_gather_nodes_kernel, one CTA of 128 threads a
//    window of 4096 positions of a row, on every SM: the window's nodes
//    (boundary_chain.cuh) and the records its walks read first (to a
//    max_size past the window, at most 48: 24 KB) in shared memory, a
//    thread a node walking the reference's step from (b + sub_min, 0, b)
//    to its first candidate's emit, any other record read from global
//    memory (the L2 holds them): for the
//    W-block holding the scan position k, the first candidate at or after
//    k (two reads), the trigger (the opposing prefix at the block's
//    start, at k and at its end: three reads each, then, only when the
//    trigger's rank falls in the block, a search of at most log2(W / 32)
//    <= 5 reads over ex and one word), then wblock.cuh's resolve.  Blocks
//    before k are no-ops in the reference's scan (k >= their end) and are
//    not visited; blocks past the row's groups read as empty; a walk stops
//    at the row's end (s >= n) or past the padded block range (cover =
//    nb * W).  Where the cut lies past the group holding k, the group's
//    rest holds no candidate and its opposing pairs keep the count at most
//    T, every block of that rest is a no-event pass: the walk adds the
//    pairs and moves k to the group's end in one step (a candidate-free
//    stretch costs a step a group, not a step a block).  The registers
//    are 64-bit, so T - c + pref and kt + skip cannot overflow for the
//    selectors' T = 2^30.
// 3. select_boundaries_gather_jump_kernel and
// 4. select_boundaries_gather_chase_kernel: boundary_chain.cuh's jump
//    table and chase, counting every emit (the gather count); the chase's
//    stop lim is min(n, cover - sub_min).
#include <cstdint>
#include <cuda_runtime.h>

#include "bitmap_words.cuh"
#include "boundary_chain.cuh"
#include "wblock.cuh"

namespace {

using bitmap_words::kGroup;
using wblock::kBig;
using wblock::kFull;

constexpr int kRecWords = 4 * 32;  // cand, opp, ex, next
constexpr int kNone = 1 << 16;     // no candidate in the words
constexpr int kTableThreads = 256;
constexpr int kNodeThreads = 128;  // a thread a node
constexpr int kStageMax = 48;      // records a node CTA stages: 24 KB

__global__ void __launch_bounds__(kTableThreads)
select_boundaries_gather_tables_kernel(const uint8_t* __restrict__ cand,
                                       const uint8_t* __restrict__ opp,
                                       uint32_t* __restrict__ tab, int B,
                                       long long n, long long G) {
  const long long grp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (grp >= (long long)B * G) return;  // the whole warp
  const long long b = grp / G;
  unsigned cw, ow;
  bitmap_words::pack_group(cand + b * n, opp + b * n, (grp - b * G) * kGroup,
                           n, lane, cw, ow);
  const unsigned pc = __popc(ow);
  const unsigned ex = bitmap_words::warp_inclusive_sum(pc, lane) - pc;
  int next = cw ? 32 * lane + __ffs(cw) - 1 : kNone;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_down_sync(kFull, next, d);
    if (lane + d < 32 && v < next) next = v;
  }
  uint32_t* dst = tab + grp * kRecWords;
  dst[lane] = cw;
  dst[32 + lane] = ow;
  dst[64 + lane] = ex;
  dst[96 + lane] = (uint32_t)next;
}

// A row's records, some of them staged in shared memory: groups
// [g_lo, g_lo + ng) from smem, the rest from global memory (glob).
struct Staged {
  const uint32_t* glob;
  const uint32_t* smem;
  long long g_lo, ng;

  __device__ __forceinline__ const uint32_t* at(long long g) const {
    const long long d = g - g_lo;
    return d >= 0 && d < ng ? smem + d * kRecWords : glob + g * kRecWords;
  }
};

// The groups a window's node walks read first: from the first walk's
// start, the window's start plus sub_min, to a max_size past the
// window's last node (a walk's first cut), at most max_groups.
long long stage_groups(int L, int sub_min, int max_size, int max_groups) {
  const long long span = (long long)chain::kWindow + L + max_size - sub_min;
  const long long g = (span > 0 ? span : 0) / kGroup + 2;
  return g < max_groups ? g : max_groups;
}

// By the whole CTA: copy records [g_lo, g_lo + ng) of rec_row (at most
// ng_max, none past the row's G) into smem, 16 bytes a thread and step.
// Readable after the CTA's next barrier.
__device__ __forceinline__ Staged stage(const uint32_t* rec_row, long long G,
                                        long long g_lo, long long ng_max,
                                        uint32_t* smem) {
  long long ng = G - g_lo < ng_max ? G - g_lo : ng_max;
  if (ng < 0) ng = 0;
  const uint4* src =
      reinterpret_cast<const uint4*>(rec_row + g_lo * kRecWords);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (long long i = threadIdx.x; i < ng * kRecWords / 4; i += kNodeThreads)
    dst[i] = src[i];
  return Staged{rec_row, smem, g_lo, ng};
}

// Opposing pairs at group-relative positions [0, x) of record r, 0 <= x
// <= 1024.
__device__ __forceinline__ int opp_before(const uint32_t* r, int x) {
  if (x >= kGroup) return (int)(r[64 + 31] + __popc(r[32 + 31]));
  const int w = x >> 5;
  return (int)(r[64 + w] + __popc(r[32 + w] & ((1u << (x & 31)) - 1u)));
}

// The group-relative position of record r's first candidate at or after
// q (0 <= q < 1024), or kNone.
__device__ __forceinline__ int first_cand(const uint32_t* r, int q) {
  const unsigned m = r[q >> 5] & (kFull << (q & 31));
  return m ? (q & ~31) + __ffs(m) - 1
           : ((q >> 5) < 31 ? (int)r[96 + (q >> 5) + 1] : kNone);
}

// The reference's reads for the W-block holding st.k, from the row's
// records (G groups); the block's start in bstart.
__device__ __forceinline__ wblock::BlockHit block_hit(
    const Staged& rec, long long G, const wblock::ScanState& st,
    const wblock::ScanParams& P, long long& bstart) {
  const int W = P.W;
  bstart = st.k & ~(long long)(W - 1);
  const long long g = bstart / kGroup;
  const int gb = (int)(bstart - g * kGroup);  // the block in its group
  const int o = (int)(st.k - bstart);         // 0 <= o < W
  wblock::BlockHit h{kBig, kBig, 0};
  if (g >= G) return h;
  const uint32_t* r = rec.at(g);
  const int q = gb + o;
  const int kc = first_cand(r, q);  // next_cand[o]
  if (kc < gb + W) h.kc = bstart + (kc - gb);
  // the trigger: the pair of block rank T - c + pref_before (0-based)
  const int p_b = opp_before(r, gb);
  const int p_q = opp_before(r, q);
  const int p_e = opp_before(r, gb + W);
  const long long rank = (long long)P.T - st.c + (p_q - p_b);
  if (rank < p_e - p_b) {  // mth_opp[rank] exists: rank < W
    const int want = p_b + (int)rank;  // its group rank
    int lo = gb >> 5, hi = (gb + W - 1) >> 5;
    while (lo < hi) {  // the last word of the block with ex <= want
      const int mid = (lo + hi + 1) >> 1;
      if ((int)r[64 + mid] <= want)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int kt =
        32 * lo + wblock::nth_bit(r[32 + lo], want - (int)r[64 + lo] + 1);
    if (kt - gb >= o) h.kt = bstart + (kt - gb);
  }
  h.total = p_e - p_q;  // the active opposing pairs: total - pref
  return h;
}

// The reference's scan from an emit at b, state (b + sub_min, 0, b), to
// its first candidate's emit (its bound), or chain::kEnd if the row ends
// first.  P.mc is 0: resolve keeps no bound.
__device__ __forceinline__ int node_walk(const Staged& rec,
                                         long long G, long long b,
                                         const wblock::ScanParams& P) {
  wblock::ScanState st{b + P.sub_min, 0, b, 0, 0};
  while (st.s < P.n && st.k < P.cover) {
    const long long g = st.k / kGroup;
    const long long gend = (g + 1) * kGroup;
    const long long cut_b = st.s + P.max_size < P.n ? st.s + P.max_size : P.n;
    const long long cut_k = cut_b - (P.L - 1);
    if ((cut_k > st.k ? cut_k : st.k) >= gend) {  // no cut in the group
      if (g >= G) {  // past the row: no bit
        st.k = gend;
        continue;
      }
      const uint32_t* r = rec.at(g);
      const int q = (int)(st.k - g * kGroup);
      const int rest = opp_before(r, kGroup) - opp_before(r, q);
      if (first_cand(r, q) == kNone && st.c + rest <= P.T) {
        st.c += rest;  // every block of the rest passes
        st.k = gend;
        continue;
      }
    }
    long long bstart;
    const wblock::BlockHit h = block_hit(rec, G, st, P, bstart);
    if (wblock::resolve(st, h, bstart + P.W, P, nullptr, nullptr, 0) == 2)
      return (int)st.s;
  }
  return chain::kEnd;
}

__global__ void __launch_bounds__(kNodeThreads)
select_boundaries_gather_nodes_kernel(const uint32_t* __restrict__ tab,
                                      int32_t* __restrict__ nxt_all,
                                      wblock::ScanParams P, long long G,
                                      long long lim, long long nwin,
                                      long long ng_max) {
  __shared__ int list[chain::kWindow + 1];
  __shared__ unsigned warp_tot[kNodeThreads / 32];
  extern __shared__ uint4 staged[];  // ng_max records
  const long long row = blockIdx.x / nwin, w = blockIdx.x % nwin;
  const long long w0 = w * chain::kWindow;
  const uint32_t* rec_row = tab + row * G * kRecWords;
  const Staged rec =
      stage(rec_row, G, (w0 + P.sub_min) / kGroup, ng_max,
            reinterpret_cast<uint32_t*>(staged));
  const int cnt = chain::window_nodes<kNodeThreads>(
      rec_row, kRecWords, G, w0, lim, P.L, list, warp_tot);
  int32_t* nxt = nxt_all + row * (P.n + 1);
  for (int i = threadIdx.x; i < cnt; i += kNodeThreads) {
    const int x = list[i];
    nxt[x] = node_walk(rec, G, x, P);
  }
}

__global__ void __launch_bounds__(kNodeThreads)
select_boundaries_gather_jump_kernel(const uint32_t* __restrict__ tab,
                                     const int32_t* __restrict__ nxt,
                                     int2* __restrict__ jmp,
                                     chain::ChainParams C, int L, long long G,
                                     long long nwin) {
  __shared__ int list[chain::kWindow + 1];
  __shared__ unsigned warp_tot[kNodeThreads / 32];
  chain::jump_body<kNodeThreads>(tab, kRecWords, G, nxt, jmp, C, L, nwin,
                                 list, warp_tot);
}

__global__ void __launch_bounds__(chain::kChaseThreads)
select_boundaries_gather_chase_kernel(const int32_t* __restrict__ nxt,
                                      const int2* __restrict__ jmp,
                                      int32_t* __restrict__ bounds,
                                      int32_t* __restrict__ counts,
                                      int32_t* __restrict__ stats,
                                      chain::ChainParams C) {
  chain::chase_body(nxt, jmp, bounds, counts, stats, C, true);
}

}  // namespace

extern "C" int select_boundaries_gather_launch(
    const void* cand, const void* opp, void* tab, void* nxt, void* jmp,
    void* bounds, void* counts, void* stats, int B, long long n,
    long long cover, int mc, int L, int W, int T, int skip, int sub_min,
    int max_size, int K, void* stream) {
  if (W < 1 || W > kGroup || (W & (W - 1)) != 0 || L < 1 || mc < 1 ||
      K < 1 || max_size < 1 || n < 0 || n >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // the walks keep no bound (mc 0); the chase writes them
  const wblock::ScanParams P{n, cover, 0, L, W, T, skip, sub_min, max_size};
  const long long lim = cover - sub_min < n ? cover - sub_min : n;
  const chain::ChainParams C{n, lim, mc, max_size, K};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const long long G = (n + kGroup - 1) / kGroup;
  const long long threads = (long long)B * G * 32;
  if (threads > 0) {
    select_boundaries_gather_tables_kernel<<<
        (unsigned)((threads + kTableThreads - 1) / kTableThreads),
        kTableThreads, 0, st>>>(static_cast<const uint8_t*>(cand),
                                static_cast<const uint8_t*>(opp),
                                static_cast<uint32_t*>(tab), B, n, G);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long nwin = (n + chain::kWindow - 1) / chain::kWindow;
    const unsigned grid = (unsigned)(B * nwin);
    const long long ng_max =
        stage_groups(L, sub_min, max_size, kStageMax);
    select_boundaries_gather_nodes_kernel<<<
        grid, kNodeThreads, (size_t)ng_max * kRecWords * 4, st>>>(
        static_cast<const uint32_t*>(tab), static_cast<int32_t*>(nxt), P, G,
        lim, nwin, ng_max);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    select_boundaries_gather_jump_kernel<<<grid, kNodeThreads, 0, st>>>(
        static_cast<const uint32_t*>(tab), static_cast<const int32_t*>(nxt),
        static_cast<int2*>(jmp), C, L, G, nwin);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // n = 0: no node; the chase writes the sentinels and count 0
  select_boundaries_gather_chase_kernel<<<B, chain::kChaseThreads, 0, st>>>(
      static_cast<const int32_t*>(nxt), static_cast<const int2*>(jmp),
      static_cast<int32_t*>(bounds), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(stats), C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* select_boundaries_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
