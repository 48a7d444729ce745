// The `wide` W-block boundary automaton over given packed-row bitmaps on
// Hopper.
//
// The device form of repro/core/automaton.py:_scan_wide_packed, as
// select_boundaries_packed (automaton.py:243) runs it: the packed split
// path's phase 2, which the reference runs as a lax.scan over W-blocks with
// a while_loop a block (it has no Pallas kernel of its own).  Its caller:
// core/seqcdc.boundaries_packed_batch with select_impl="cuda", which the
// scheduler's packed split and chunk-only dispatches run on the masks
// kernel's bitmaps.  Each row of a (B, S) batch holds several streams back
// to back; ends (B, G) int32 lists their exclusive ends, nondecreasing,
// padded with the row's payload end n_row = ends[G-1].  Per row, bit for
// bit with the plain loop on bitmaps clipped per segment as
// boundaries_packed_batch clips them (candidates at pos <= end - L and
// opposing pairs at pos < end - 1 of their own segment, none past n_row):
//   bounds (B, mc) int32 in row coordinates, every segment end a bound,
//     sentinel 1<<30 past the kept chunks;
//   counts (B,) int32, every emit counted, kept or not, with the fix-up at
//     n_row.
// Emits past mc are dropped whole.
//
// Bound on this card: memory.  The function needs each bitmap byte once
// (2 * B * S), the ends table once (4 * B * G), and writes 4 bytes per
// bound slot and a count per row: least time (2 * B * S + 4 * B * G + 4 * B
// * mc + 4 * B) / 3.35 TB/s.  The automaton is serial along a segment, so
// with few rows the longest segment's chain, not the bytes, sets the time.
//
// Design: packed_walk.cuh's segment-parallel scan, one launch, one CTA of
// kWarps warps a row, no pass over the bitmaps before the walk:
// 1. One thread of the last warp has the copy engine bring both bitmap rows
//    (bool bytes, 0 or 1) into shared memory, a cp.async.bulk each from the
//    row's 16-byte floor (virtual byte v is row byte v - a, a per bitmap),
//    both completing one mbarrier, while every thread sorts the segments
//    from the ends table (classify; its lines prefetched into L1 before the
//    first barrier).  The 16-byte floor and ceiling of a row lie in the
//    16-byte granules that hold its first and last bytes, so a copy reads
//    no page the tensor does not touch (PyTorch's caching allocator also
//    rounds blocks to 512 bytes); bytes outside the row are copied but never
//    used.
// 2. The warps walk the segments of min_size or more (take_segments), each
//    as a stream of its own; a warp waits on the mbarrier before its first
//    walk, and a CTA with no long segment never waits until its exit.  When
//    the walk enters a window of kWin positions, lane i builds the
//    candidate and opposing words of positions wstart + 32i .. from the
//    resident bytes: three aligned 16-byte loads a bitmap, byte_bits, a
//    funnel shift by the segment's byte offset, bits at and past the
//    segment end masked off; a walk never builds the words it jumps over
//    (sub_min after every emit).  Each lane also keeps its exclusive
//    popcount prefix of the window's opposing bits, so an event's search
//    (window_hit) is a warp min for the first candidate, one shuffle for
//    the opposing bits below k, one ballot for the lane holding the
//    trigger's rank beside every lane's nth_bit, and one shuffle of the hit
//    lane's; wblock.cuh's resolve and final_cut apply it.
// 3. A block prefix sum places the segments' bounds, then the fix-up at
//    n_row (place).  Thread 0 waits on the mbarrier before the CTA exits.
// The scratch (G counts, the list, n / min_size + G slots) lies in shared
// memory where it fits beside both bitmap regions, else in the device
// buffer the wrapper passes (kernels/select_boundaries_packed.py repeats
// the rule; a launch that needs the buffer and gets none is refused).
#include <cstdint>
#include <cuda_runtime.h>

#include "packed_walk.cuh"
#include "ring.cuh"
#include "wblock.cuh"

namespace {

using ring::bulk_copy;
using ring::mbar_expect_tx;
using ring::mbar_wait;
using wblock::byte_bits;
using wblock::kBig;
using wblock::kFull;
using wblock::kWin;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRow = 1 << 16;  // the reference's packed row bound
// shared memory a block may take, the bitmaps and the scratch together
constexpr int kSmemMax = 200 << 10;

// Shared bytes a bitmap row of n bytes takes: its 16-byte floor and
// ceiling (n + 15 at most), and the 48 bytes the last word's loads may
// reach past them.
constexpr long long region_bytes(long long n) {
  return ((n + 15) & ~15LL) + 64;
}

struct Params {
  long long n;  // row width S
  int G, mc, L, W, T, skip, sub_min, max_size;
  int list;          // entries of the long-segment list: n / min_size + 1
  int scratch;       // scratch ints a row: G counts, the list, the slots
  int region;        // shared bytes a bitmap row: region_bytes(n)
  int smem_scratch;  // 1: the scratch lies in shared memory
};

// A search window's words, lane i holding word i (positions wstart + 32i
// ..), and the exclusive prefix of the opposing bits' popcounts over the
// lanes below, with the window's total.
struct Window {
  unsigned cw, ow;
  int excl, total;
};

// The 32 bits of positions p0 .. p0 + 31 of a segment whose position 0 is
// virtual byte vst of the resident bitmap rb (bit q: byte vst + p0 + q),
// bits at and past the segment's length l zero.
__device__ __forceinline__ unsigned word_from_bytes(const uint8_t* rb,
                                                    long long vst,
                                                    long long p0,
                                                    long long l) {
  if (p0 >= l) return 0;
  const int v = (int)(vst + p0);
  const uint4* q = reinterpret_cast<const uint4*>(rb + (v & ~15));
  const uint4 a = q[0], b = q[1], c = q[2];
  const unsigned lo = byte_bits(a.x) | byte_bits(a.y) << 4 |
                      byte_bits(a.z) << 8 | byte_bits(a.w) << 12 |
                      byte_bits(b.x) << 16 | byte_bits(b.y) << 20 |
                      byte_bits(b.z) << 24 | byte_bits(b.w) << 28;
  const unsigned hi = byte_bits(c.x) | byte_bits(c.y) << 4 |
                      byte_bits(c.z) << 8 | byte_bits(c.w) << 12;
  return __funnelshift_r(lo, hi, v & 15) & wblock::low_bits(l - p0);
}

// The window from wstart of a segment of length l: its words from both
// resident bitmaps (the segment's position 0 at virtual bytes vc, vo) and
// the opposing prefix, by the whole warp.
__device__ __forceinline__ Window load_window(const uint8_t* crb,
                                              const uint8_t* orb,
                                              long long vc, long long vo,
                                              long long wstart, long long l,
                                              int lane) {
  const long long p0 = wstart + 32 * lane;
  Window w;
  w.cw = word_from_bytes(crb, vc, p0, l);
  w.ow = word_from_bytes(orb, vo, p0, l);
  const int pc = __popc(w.ow);
  w.total = __reduce_add_sync(kFull, pc);
  int incl = pc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  w.excl = incl - pc;
  return w;
}

// The search of the window from the scan position's offset o (0 <= o <
// kWin) with c opposing pairs counted (c <= T), what
// wblock::block_search_words finds on the same words: the first candidate
// at or after o, the trigger (the (T - c + 1)-th opposing bit at or after
// o: window rank below + T - c + 1, below the bits under o, read from o's
// lane; the lane whose prefix range holds that rank found by a ballot) and
// the opposing bits at or after o.  Every lane returns the same values.
__device__ __forceinline__ wblock::BlockHit window_hit(const Window& w, int o,
                                                       long long wstart,
                                                       long long c, int T,
                                                       int lane) {
  const int lo = 32 * lane;
  const unsigned act =
      o <= lo ? kFull : (o >= lo + 32 ? 0u : kFull << (o - lo));
  const unsigned cw = w.cw & act;
  int kc = cw ? lo + __ffs(cw) - 1 : kBig;
  kc = __reduce_min_sync(kFull, kc);
  const int below =
      __shfl_sync(kFull, w.excl + __popc(w.ow & ~act), o >> 5);
  const long long m = T - c + 1, rank = below + m;
  const unsigned hit = __ballot_sync(
      kFull, m >= 1 && w.excl < rank && rank <= w.excl + __popc(w.ow));
  // every lane's nth_bit alongside the ballot; the hit lane's is the one
  const int kt_lane = lo + wblock::nth_bit(w.ow, (int)(rank - w.excl));
  int kt = kBig;
  if (hit) kt = __shfl_sync(kFull, kt_lane, __ffs(hit) - 1);
  return wblock::BlockHit{kc < kBig ? wstart + kc : kBig,
                          kt < kBig ? wstart + kt : kBig, w.total - below};
}

__global__ void __launch_bounds__(kThreads)
select_boundaries_packed_kernel(const uint8_t* __restrict__ cand,
                                const uint8_t* __restrict__ opp,
                                const int32_t* __restrict__ ends_all,
                                int32_t* __restrict__ bounds,
                                int32_t* __restrict__ counts,
                                int32_t* __restrict__ gscratch, Params P) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t landed;  // both copies' mbarrier
  __shared__ pwalk::Shared<kWarps> sh;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const long long n = P.n;
  const uint8_t* crow = cand + b * n;
  const uint8_t* orow = opp + b * n;
  const int32_t* ends = ends_all + b * P.G;
  uint8_t* crb = smem;
  uint8_t* orb = smem + P.region;
  int32_t* cnt = P.smem_scratch
                     ? reinterpret_cast<int32_t*>(smem + 2 * P.region)
                     : gscratch + b * P.scratch;
  const pwalk::Scratch sc{cnt, cnt + P.G, cnt + P.G + P.list};

  if (tid == 0) {
    sh.nlong = 0;
    sh.next = 0;
  }
  for (int g = 32 * tid; g < P.G; g += 32 * kThreads)  // classify's lines
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(ends + g));
  __syncthreads();

  // -- both bitmap rows into shared memory by the copy engine, issued by the
  // last warp (the last to get classify's work) while classify runs --------
  const int ac = (int)(reinterpret_cast<uintptr_t>(crow) & 15);
  const int ao = (int)(reinterpret_cast<uintptr_t>(orow) & 15);
  if (tid == kThreads - 32) {
    const int vlc = ((int)n + ac + 15) & ~15;
    const int vlo = ((int)n + ao + 15) & ~15;
    ring::mbar_init(&landed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&landed, vlc + vlo);
    bulk_copy(crb, crow - ac, vlc, &landed);
    bulk_copy(orb, orow - ao, vlo, &landed);
  }
  pwalk::classify<kThreads>(P, ends, sc, sh, tid);
  __syncthreads();

  // -- the warps: each long segment a stream of its own ---------------------
  bool resident = false;  // this warp has seen the copies land
  pwalk::take_segments(
      P, ends, sc, sh, tid >> 5, lane,
      [&](int st, int l, const wblock::ScanParams& SP, int32_t* sb) {
        if (!resident) mbar_wait(&landed, 0);
        resident = true;
        wblock::ScanState ss{P.sub_min, 0, 0, 0, 0};
        const long long align = P.W - 1;
        long long wstart = -kWin;
        Window w{0u, 0u, 0, 0};
        while (ss.s < SP.n && ss.k < SP.cover) {
          if (ss.k >= wstart + kWin) {
            wstart = ss.k & ~align;
            w = load_window(crb, orb, st + ac, st + ao, wstart, l, lane);
          }
          const long long wend =
              wstart + kWin < SP.cover ? wstart + kWin : SP.cover;
          wblock::resolve(ss,
                          window_hit(w, (int)(ss.k - wstart), wstart, ss.c,
                                     P.T, lane),
                          wend, SP, sb, nullptr, lane);
        }
        return wblock::final_cut(ss, SP, sb, nullptr);
      });
  __syncthreads();

  pwalk::place<kThreads, kWarps, false>(P, ends, sc, sh, bounds + b * P.mc,
                                        nullptr, counts + b, tid);
  if (tid == 0) mbar_wait(&landed, 0);  // no copy may land after the exit
}

}  // namespace

extern "C" int select_boundaries_packed_launch(
    const void* cand, const void* opp, const void* ends, void* bounds,
    void* counts, void* scratch, long long ints, int B, long long n, int G,
    int mc, int L, int W, int T, int skip, int sub_min, int max_size,
    void* stream) {
  // scratch: null where the scratch fits in shared memory, else B rows of
  // ints, at least G counts, the long-segment list (n / min_size + 1) and
  // the slots (n / min_size + G)
  const int min_size = sub_min + L;
  if (W < 1 || W > wblock::kWin || (W & (W - 1)) != 0 || L < 1 || G < 1 ||
      n < 1 || n > kMaxRow || min_size < 1 || mc < 1 ||
      ints < 2LL * G + 2 * (n / min_size) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long region = region_bytes(n);
  const bool in_smem = 2 * region + 4 * ints <= kSmemMax;
  if (!in_smem && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{n,        G,
                 mc,       L,
                 W,        T,
                 skip,     sub_min,
                 max_size, (int)(n / min_size) + 1,
                 (int)ints, (int)region,
                 in_smem ? 1 : 0};
  const int smem = (int)(2 * region + (in_smem ? 4 * ints : 0));
  if (smem > (48 << 10)) {  // above 48 KiB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        select_boundaries_packed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  select_boundaries_packed_kernel<<<B, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(cand), static_cast<const uint8_t*>(opp),
      static_cast<const int32_t*>(ends), static_cast<int32_t*>(bounds),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(scratch), P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* select_boundaries_packed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
