// The `wide` W-block boundary automaton over given (B, n) bitmaps on Hopper.
//
// The device form of repro/core/automaton.py:_scan_wide, as
// select_boundaries (automaton.py:409) runs it: the split path's phase 2,
// which the reference runs as a lax.scan on the TPU (it has no Pallas
// kernel of its own).  Its callers: the seqcdc chunker and the scheduler's
// split pipeline (candidate/opposing bitmaps from the masks kernel), and the
// hash-based chunkers' selector (a match bitmap, no opposing pairs, L = 1,
// T = 2^30, skip 2^20: core/baselines/selectors.py).  Per row, bit for bit:
//   bounds (B, mc) int32, sentinel 1<<30 past the kept chunks;
//   counts (B,) int32, every emit counted, kept or not.
//
// Bound on this card: memory.  The function needs each bitmap byte once
// (2 * B * n bytes) and writes 4 bytes per bound slot and a count per row:
// least time (2 * B * n + 4 * B * mc + 4 * B) / 3.35 TB/s.  The automaton
// is serial along a row, so with few rows the kernel is far from that.
//
// Design: the fused kernel's scan (fused_pipeline.cu) over words packed in
// advance.  Two launches behind one call:
//
// 1. select_boundaries_pack_kernel, one warp per 1024 positions of the
//    batch on every SM: the warp turns the group's candidate and opposing
//    bytes into 32-bit words (bitmap_words.cuh) and writes them to the
//    scratch the wrapper allocates, (B, G, 2, 32) uint32 with G =
//    ceil(n / 1024): group g of row b holds the candidate words of
//    positions 1024g .. 1024g + 1023, then the opposing words, bit q of
//    word i at position 1024g + 32i + q, zero past n.  The scratch is the
//    design's choice, not the function's: the bound does not count it.
// 2. select_boundaries_scan_kernel, one CTA of two warps per row.  A
//    producer thread streams the row's groups into a ring of shared-memory
//    slabs with cp.async.bulk (ring.cuh); the scanning warp runs the
//    automaton event by event with wblock.cuh's walk_windows over one group
//    a window, lane i reading word i of each bitmap from the ring.  No
//    block-wide barrier: the chain is one window search per event and per
//    group reached.  Groups past the row (the split path pads by skip + W,
//    2^20 positions for the selectors) hold no event and are not read.  The
//    scan registers are 64-bit, so T - c + 1 and kt + skip cannot overflow
//    for the selectors' T = 2^30.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitmap_words.cuh"
#include "ring.cuh"
#include "wblock.cuh"

namespace {

using wblock::kBig;
using wblock::kFull;
using wblock::kWin;

using Ring = ring::Ring<8192, 4>;  // 32 groups a bulk copy, four slots
constexpr int kGroupWords = 2 * kWin / 32;   // 64: candidate, opposing
constexpr int kGroupBytes = 4 * kGroupWords;  // 256
constexpr int kPackThreads = 256;
constexpr int kScanThreads = 64;  // warp 0 scans, thread 32 produces
static_assert(Ring::kSlab % kGroupBytes == 0, "a group lies in one slab");

__global__ void __launch_bounds__(kPackThreads)
select_boundaries_pack_kernel(const uint8_t* __restrict__ cand,
                              const uint8_t* __restrict__ opp,
                              uint32_t* __restrict__ words, int B,
                              long long n, long long G) {
  const long long grp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (grp >= (long long)B * G) return;
  const long long b = grp / G;
  unsigned cw, ow;
  bitmap_words::pack_group(cand + b * n, opp + b * n, (grp - b * G) * kWin, n,
                           lane, cw, ow);
  uint32_t* dst = words + grp * kGroupWords;
  dst[lane] = cw;
  dst[32 + lane] = ow;
}

__global__ void __launch_bounds__(kScanThreads)
select_boundaries_scan_kernel(const uint32_t* __restrict__ words,
                              int32_t* __restrict__ bounds,
                              int32_t* __restrict__ counts,
                              wblock::ScanParams P, long long G) {
  __shared__ __align__(128) uint8_t buf[Ring::kBytes];
  __shared__ __align__(8) uint64_t full[Ring::kSlabs], empty[Ring::kSlabs];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const uint8_t* row =
      reinterpret_cast<const uint8_t*>(words + b * G * kGroupWords);
  int32_t* bnd = bounds + b * P.mc;
  for (int i = tid; i < P.mc; i += kScanThreads) bnd[i] = kBig;
  const long long vlen = G * kGroupBytes;  // 256-byte aligned rows
  const long long nslabs = Ring::slabs(vlen);
  Ring rg{buf, full, empty};
  if (tid == 0) rg.init();
  __syncthreads();

  if (tid >= 32) {  // -- the producer: one thread streams the row -------
    if (tid == 32) rg.produce(row, vlen);
    return;
  }

  // -- the scanning warp: one group a window --------------------------------
  wblock::ScanState st{P.sub_min, 0, 0, 0, 0};
  wblock::walk_windows(
      st, P, kWin - 1, bnd, nullptr, lane,
      [&](long long wstart, unsigned& cw, unsigned& ow) {
        const long long g = wstart / kWin;
        if (g >= G) {  // past the row
          cw = ow = 0;
          return;
        }
        const long long j = g * kGroupBytes / Ring::kSlab;
        if (j > rg.released || j >= rg.ready) {
          __syncwarp();  // every lane is done reading what is handed back
          rg.need(j, j, lane == 0);
        }
        const uint32_t* w = reinterpret_cast<const uint32_t*>(
            buf + ((g * kGroupBytes) & (Ring::kBytes - 1)));
        cw = w[lane];
        ow = w[32 + lane];
      });
  if (lane == 0) counts[b] = (int32_t)wblock::final_cut(st, P, bnd, nullptr);
  __syncwarp();
  rg.need(nslabs, nslabs - 1, lane == 0);  // every copy has landed
}

}  // namespace

extern "C" int select_boundaries_launch(const void* cand, const void* opp,
                                        void* words, void* bounds,
                                        void* counts, int B, long long n,
                                        long long cover, int mc, int L, int W,
                                        int T, int skip, int sub_min,
                                        int max_size, void* stream) {
  if (W < 1 || W > kWin || (W & (W - 1)) != 0 || L < 1 || mc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const wblock::ScanParams P{n, cover, mc, L, W, T, skip, sub_min, max_size};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const long long G = (n + kWin - 1) / kWin;
  const long long threads = (long long)B * G * 32;
  if (threads > 0) {
    select_boundaries_pack_kernel<<<
        (unsigned)((threads + kPackThreads - 1) / kPackThreads), kPackThreads,
        0, st>>>(static_cast<const uint8_t*>(cand),
                 static_cast<const uint8_t*>(opp),
                 static_cast<uint32_t*>(words), B, n, G);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_boundaries_scan_kernel<<<B, kScanThreads, 0, st>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(bounds),
      static_cast<int32_t*>(counts), P, G);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* select_boundaries_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
