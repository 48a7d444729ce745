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
// Design: packed_pipeline.cu's segment-parallel scan (packed_walk.cuh),
// its mask words read from the bitmaps instead of computed from bytes.
// One launch, one CTA of kWarps warps a row:
// 1. Every thread turns 16-byte pieces of both bitmap rows (bool bytes, 0
//    or 1) into 16 bits, two neighbouring lanes making a 32-bit word, into
//    shared memory: bit q of word j is byte 32 j + q from the row's 16-byte
//    floor (virtual byte v is row byte v - a, with a per bitmap), a zero
//    word past the row; at most 2 x 2,050 words (16.4 KiB) for a 64 KiB
//    row.  The same threads sort the segments (packed_walk.cuh's classify).
// 2. The warps walk the segments of min_size or more (walk_segments).  A
//    segment starts at any byte, so its word q is a funnel shift of two row
//    words; bits at and past its end belong to the next segment or the
//    padding and are masked off, which makes each walk a stream of its own.
// 3. A block prefix sum places the segments' bounds, then the fix-up at
//    n_row (place).
// The scratch (G counts, the list, n / min_size + G slots) lies in shared
// memory where it fits beside the words, else in the device buffer the
// wrapper passes.
#include <cstdint>
#include <cuda_runtime.h>

#include "packed_walk.cuh"
#include "wblock.cuh"

namespace {

using wblock::byte_bits;
using wblock::kFull;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRow = 1 << 16;  // the reference's packed row bound
// shared memory a block may take, the words and the scratch together
constexpr int kSmemMax = 200 << 10;

struct Params {
  long long n;  // row width S
  int G, mc, L, W, T, skip, sub_min, max_size;
  int list;          // entries of the long-segment list: n / min_size + 1
  int scratch;       // scratch ints a row: G counts, the list, the slots
  int words;         // shared words a bitmap row: (n + 15) / 32 + 2
  int smem_scratch;  // 1: the scratch lies in shared memory
};

// A bitmap row of n bool bytes into words[0, words): bit q of word j is
// virtual byte 32 j + q, virtual byte v being row byte v - a.
__device__ __forceinline__ void pack_row(const uint8_t* row, int a,
                                         long long n, uint32_t* w, int words,
                                         int tid) {
  const uint4* src = reinterpret_cast<const uint4*>(row - a);
  const int pieces = (int)((n + a + 15) >> 4);
  for (int i0 = 0; i0 < 2 * words; i0 += kThreads) {
    const int i = i0 + tid;
    unsigned bits = 0;
    if (i < pieces) {
      const uint4 v = src[i];
      bits = byte_bits(v.x) | byte_bits(v.y) << 4 | byte_bits(v.z) << 8 |
             byte_bits(v.w) << 12;
    }
    const unsigned hi = __shfl_down_sync(kFull, bits, 1);
    if ((i & 1) == 0 && (i >> 1) < words) w[i >> 1] = bits | hi << 16;
  }
}

// The 32 bits from virtual position v of a packed bitmap row.
__device__ __forceinline__ unsigned word_at(const uint32_t* w, int v) {
  const int j = v >> 5;
  return __funnelshift_r(w[j], w[j + 1], v & 31);
}

__global__ void __launch_bounds__(kThreads)
select_boundaries_packed_kernel(const uint8_t* __restrict__ cand,
                                const uint8_t* __restrict__ opp,
                                const int32_t* __restrict__ ends_all,
                                int32_t* __restrict__ bounds,
                                int32_t* __restrict__ counts,
                                int32_t* __restrict__ gscratch, Params P) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ pwalk::Shared<kWarps> sh;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const long long n = P.n;
  const uint8_t* crow = cand + b * n;
  const uint8_t* orow = opp + b * n;
  const int32_t* ends = ends_all + b * P.G;
  uint32_t* cws = smem;
  uint32_t* ows = smem + P.words;
  int32_t* cnt = P.smem_scratch
                     ? reinterpret_cast<int32_t*>(smem + 2 * P.words)
                     : gscratch + b * P.scratch;
  const pwalk::Scratch sc{cnt, cnt + P.G, cnt + P.G + P.list};
  if (tid == 0) {
    sh.nlong = 0;
    sh.next = 0;
  }
  __syncthreads();

  // -- both bitmap rows into words, the segments sorted ---------------------
  const int ac = (int)(reinterpret_cast<uintptr_t>(crow) & 15);
  const int ao = (int)(reinterpret_cast<uintptr_t>(orow) & 15);
  pack_row(crow, ac, n, cws, P.words, tid);
  pack_row(orow, ao, n, ows, P.words, tid);
  pwalk::classify<kThreads>(P, ends, sc, sh, tid);
  __syncthreads();

  // -- the warps: each long segment a stream of its own ---------------------
  pwalk::walk_segments(
      P, ends, sc, sh, lane, [](long long, long long) {},
      [&](long long st, long long l, long long wstart, unsigned& cw,
          unsigned& ow) {
        // lane i: word i, positions wstart + 32i .. of the segment
        const long long p0 = wstart + 32 * lane;
        if (p0 >= l) {
          cw = ow = 0;
          return;
        }
        const unsigned keep = wblock::low_bits(l - p0);
        const int v = (int)(st + p0);
        cw = word_at(cws, v + ac) & keep;
        ow = word_at(ows, v + ao) & keep;
      });
  __syncthreads();

  pwalk::place<kThreads, kWarps, false>(P, ends, sc, sh, bounds + b * P.mc,
                                        nullptr, counts + b, tid);
}

}  // namespace

extern "C" int select_boundaries_packed_launch(
    const void* cand, const void* opp, const void* ends, void* bounds,
    void* counts, void* scratch, long long ints, int B, long long n, int G,
    int mc, int L, int W, int T, int skip, int sub_min, int max_size,
    void* stream) {
  // scratch: B rows of ints, at least G counts, the long-segment list
  // (n / min_size + 1) and the slots (n / min_size + G)
  const int min_size = sub_min + L;
  if (W < 1 || W > wblock::kWin || (W & (W - 1)) != 0 || L < 1 || G < 1 ||
      n < 1 || n > kMaxRow || min_size < 1 || mc < 1 ||
      ints < 2LL * G + 2 * (n / min_size) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (int)((n + 15) / 32) + 2;
  const long long word_bytes = 2LL * 4 * words;
  const bool in_smem = word_bytes + 4 * ints <= kSmemMax;
  const Params P{n,    G,        mc,       L,
                 W,    T,        skip,     sub_min,
                 max_size, (int)(n / min_size) + 1, (int)ints, words,
                 in_smem ? 1 : 0};
  const int smem = (int)(word_bytes + (in_smem ? 4 * ints : 0));
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
