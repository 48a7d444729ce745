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
// least time (2 * B * n + 4 * B * mc + 4 * B) / 3.35 TB/s.  The scan is
// serial along a row, one W-block a step, so with few rows the kernel is
// far from that.
//
// Design.  The reference's three (nb, W) int32 tables (12 bytes a
// position) become one 512-byte record per group of 1024 positions
// (bitmap_words.cuh), half a byte a position; W divides 1024, so a W-block
// lies in one group.  Two launches behind one call:
//
// 1. select_boundaries_gather_tables_kernel, one warp per group of the
//    batch on every SM: lane i packs word i of the group's candidate and
//    opposing bitmaps and writes the group's record to the scratch the
//    wrapper allocates, (B, G, 4, 32) uint32 with G = ceil(n / 1024):
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
//    constant work.  The scratch is the design's, not the function's: the
//    bound does not count it.
// 2. select_boundaries_gather_walk_kernel, one CTA of two warps per row.
//    A producer thread streams the row's records into a ring of
//    shared-memory slabs with cp.async.bulk (ring.cuh); one thread runs
//    the reference's step for the W-block holding the scan position k,
//    from the ring: the first candidate at or after k (two reads), the
//    trigger (the opposing prefix at the block's start, at k and at its
//    end: three reads each, then, only when the trigger's rank falls in
//    the block, a search of at most log2(W / 32) <= 5 reads over ex and
//    one word), then wblock.cuh's resolve.  Blocks before k are no-ops
//    in the reference's scan (k >= their end) and are not visited; blocks
//    past the row's groups read as empty; the walk stops once the row is
//    done (s >= n) or past the padded block range (cover = nb * W).  The
//    scan registers are 64-bit, so T - c + pref and kt + skip cannot
//    overflow for the selectors' T = 2^30.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitmap_words.cuh"
#include "ring.cuh"
#include "wblock.cuh"

namespace {

using bitmap_words::kGroup;
using wblock::kBig;
using wblock::kFull;

using Ring = ring::Ring<8192, 4>;  // 16 records a bulk copy, four slots
constexpr int kRecWords = 4 * 32;          // cand, opp, ex, next
constexpr int kRecBytes = 4 * kRecWords;   // 512
constexpr int kNone = 1 << 16;             // no candidate in the words
constexpr int kTableThreads = 256;
constexpr int kWalkThreads = 64;  // thread 0 walks, thread 32 produces
static_assert(Ring::kSlab % kRecBytes == 0, "a record lies in one slab");

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

// Opposing pairs at group-relative positions [0, x) of record r, 0 <= x
// <= 1024.
__device__ __forceinline__ int opp_before(const uint32_t* r, int x) {
  if (x >= kGroup) return (int)(r[64 + 31] + __popc(r[32 + 31]));
  const int w = x >> 5;
  return (int)(r[64 + w] + __popc(r[32 + w] & ((1u << (x & 31)) - 1u)));
}

__global__ void __launch_bounds__(kWalkThreads)
select_boundaries_gather_walk_kernel(const uint32_t* __restrict__ tab,
                                     int32_t* __restrict__ bounds,
                                     int32_t* __restrict__ counts,
                                     wblock::ScanParams P, long long G) {
  __shared__ __align__(128) uint8_t buf[Ring::kBytes];
  __shared__ __align__(8) uint64_t full[Ring::kSlabs], empty[Ring::kSlabs];
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const uint8_t* row =
      reinterpret_cast<const uint8_t*>(tab + b * G * kRecWords);
  int32_t* bnd = bounds + b * P.mc;
  for (int i = tid; i < P.mc; i += kWalkThreads) bnd[i] = kBig;
  const long long vlen = G * kRecBytes;
  const long long nslabs = Ring::slabs(vlen);
  Ring rg{buf, full, empty};
  if (tid == 0) rg.init();
  __syncthreads();

  if (tid >= 32) {  // -- the producer: one thread streams the row -------
    if (tid == 32) rg.produce(row, vlen);
    return;
  }
  if (tid != 0) return;

  // -- the scan: one thread, one W-block a step ----------------------------
  const int W = P.W;
  wblock::ScanState st{P.sub_min, 0, 0, 0, 0};
  while (st.s < P.n && st.k < P.cover) {
    const long long bstart = st.k & ~(long long)(W - 1);
    const long long g = bstart / kGroup;
    const int gb = (int)(bstart - g * kGroup);  // the block in its group
    const int o = (int)(st.k - bstart);         // 0 <= o < W
    wblock::BlockHit h{kBig, kBig, 0};
    if (g < G) {
      const long long j = g * kRecBytes / Ring::kSlab;
      if (j > rg.released || j >= rg.ready) rg.need(j, j, true);
      const uint32_t* r = reinterpret_cast<const uint32_t*>(
          buf + ((g * kRecBytes) & (Ring::kBytes - 1)));
      // the first candidate at or after k: next_cand[o]
      const int q = gb + o;
      const unsigned m = r[q >> 5] & (kFull << (q & 31));
      const int kc = m ? (q & ~31) + __ffs(m) - 1
                       : ((q >> 5) < 31 ? (int)r[96 + (q >> 5) + 1] : kNone);
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
    }
    wblock::resolve(st, h, bstart + W, P, bnd, nullptr, 0);
  }
  counts[b] = (int32_t)wblock::final_cut(st, P, bnd, nullptr);
  rg.need(nslabs, nslabs - 1, true);  // every copy has landed
}

}  // namespace

extern "C" int select_boundaries_gather_launch(
    const void* cand, const void* opp, void* tab, void* bounds, void* counts,
    int B, long long n, long long cover, int mc, int L, int W, int T,
    int skip, int sub_min, int max_size, void* stream) {
  if (W < 1 || W > kGroup || (W & (W - 1)) != 0 || L < 1 || mc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const wblock::ScanParams P{n, cover, mc, L, W, T, skip, sub_min, max_size};
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
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_boundaries_gather_walk_kernel<<<B, kWalkThreads, 0, st>>>(
      static_cast<const uint32_t*>(tab), static_cast<int32_t*>(bounds),
      static_cast<int32_t*>(counts), P, G);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* select_boundaries_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
