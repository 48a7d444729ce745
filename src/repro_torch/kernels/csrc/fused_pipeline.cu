// Fused SeqCDC chunk + fingerprint pipeline for a (B, S) batch on Hopper.
//
// Replaces the TPU kernel repro/kernels/fused_pipeline.py:fused_pipeline_batch
// (body _pipeline_kernel).  Per row it computes what the composed split path
// computes (phase-1 masks, the `wide` W-block automaton of
// repro/core/automaton.py:_scan_wide with _resolve and select_boundaries'
// final-cut fixup, then the per-chunk fingerprints), bit for bit:
//   bounds (B, mc) int32, sentinel 1<<30 past the kept chunks;
//   counts (B,) int32, every emit counted, kept or not;
//   fps (B, mc, 2) uint32 and lens (B, mc) int32, zero past the kept chunks.
// Emits past mc are counted and dropped whole, as the TPU kernel drops
// them (keep = emit & cnt < mc).
//
// Bound on this card: memory.  The function needs each input byte once
// (B * S bytes) and writes 16 bytes per chunk slot plus a count per row; its
// operations (about L compares per byte for the masks, two 64-bit
// multiply-adds per byte for the hashes) are far below the card's integer
// rate.  Least time: (B * S + 16 * B * mc + 4 * B) / 3.35 TB/s.
//
// What bounds this design is the scan's serial chain: each W-block's
// resolution depends on the previous one's, and a row has one.  So the
// design keeps everything else off that chain.  Two launches behind one
// call:
//
// 1. fused_pipeline_scan_kernel, one CTA of two warps per row.  A producer
//    thread streams the row into a ring of shared-memory slabs with
//    cp.async.bulk (ring.cuh), so the copy runs ahead of the scan at the
//    card's bandwidth and never waits on it while the ring has room.  The
//    scanning warp runs the automaton event by event over windows of kWin
//    positions from the W-block holding k (wblock.cuh's walk_windows:
//    block_search_words over 32 words, then resolve).  A window's mask
//    words are computed on demand, when k first leaves the previous
//    window: lane i computes word i by itself (wblock.cuh's mask_word)
//    from aligned 4-byte loads of the ring (4 positions a step with
//    __vcmpgtu4/__vcmpltu4), the L-1 run test as shifts and ands of the run
//    pairs.  After each emit k skips
//    sub_min bytes, which are never compared; the words of a window past
//    its last event are computed and not used.  Words per W-block instead
//    (one search a block, as the split path walks) ran slower on random
//    rows and several times slower on constant ones: a window's words cost
//    about what one block's do, one warp's latency.  No whole-tile mask
//    pass, no block-wide barrier: the chain is one window search per event
//    and per kWin positions reached.  Bounds and lengths are written as
//    they come; the final cut once per row.
// 2. fused_pipeline_hash_kernel, one warp per chunk slot over the whole
//    batch (B * mc warps on every SM, as fingerprint.cu spreads them):
//    modp.cuh's hash_slot, which packed_pipeline.cu launches too; the rows
//    are L2-resident from the scan's copies.
#include <cstdint>
#include <cuda_runtime.h>

#include "modp.cuh"
#include "ring.cuh"
#include "wblock.cuh"

namespace {

using wblock::kBig;
using wblock::kMaxHalo;
using wblock::kWin;
using wblock::mask_word;

using Ring = ring::Ring<8192, 4>;  // 8 KiB a bulk copy, four slots
constexpr int kSlab = Ring::kSlab;
constexpr int kRing = Ring::kBytes;
constexpr int kWrap = kRing / 4 - 1;  // the ring's word-index mask
constexpr int kScanThreads = 64;  // warp 0 scans, warp 1 produces
constexpr int kHashThreads = 128;
static_assert(kWin + 96 <= kSlab, "a window's bytes span at most two slabs");

__global__ void __launch_bounds__(kScanThreads)
fused_pipeline_scan_kernel(const uint8_t* __restrict__ x,
                           int32_t* __restrict__ bounds,
                           int32_t* __restrict__ counts,
                           int32_t* __restrict__ lens, wblock::ScanParams P,
                           int inc) {
  __shared__ __align__(128) uint8_t buf[kRing];
  __shared__ __align__(8) uint64_t full[Ring::kSlabs], empty[Ring::kSlabs];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const long long n = P.n;
  const uint8_t* row = x + b * n;
  int32_t* bnd = bounds + b * P.mc;
  int32_t* ln = lens + b * P.mc;
  for (int i = tid; i < P.mc; i += kScanThreads) {
    bnd[i] = kBig;
    ln[i] = 0;
  }
  // the ring holds the row from its 16-byte floor: position p is virtual
  // byte p + a (ring.cuh)
  const int a = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const long long vlen = n + a;
  const long long nslabs = Ring::slabs(vlen);
  Ring rg{buf, full, empty};
  if (tid == 0) rg.init();
  __syncthreads();

  if (tid >= 32) {  // -- the producer: one thread streams the row -------
    if (tid == 32) rg.produce(row - a, vlen);
    return;
  }

  // -- the scanning warp: the window walk, each window's mask words
  // computed when k first leaves the previous window (windows from the
  // W-block holding k) -------------------------------------------------------
  const int W = P.W, L = P.L;
  wblock::ScanState st{P.sub_min, 0, 0, 0, 0};
  wblock::walk_windows(
      st, P, W - 1, bnd, ln, lane,
      [&](long long wstart, unsigned& cw, unsigned& ow) {
        const long long hi_pos =
            wstart + kWin + L - 1 < n ? wstart + kWin + L - 1 : n;
        if (wstart >= hi_pos) {  // past the row
          cw = ow = 0;
          return;
        }
        const long long lo = (wstart + a) / kSlab;
        const long long hi = (hi_pos - 1 + a) / kSlab;
        if (lo > rg.released || hi >= rg.ready) {
          __syncwarp();  // every lane is done reading what is handed back
          rg.need(lo, hi, lane == 0);
        }
        // lane i: word i, positions wstart + 32i ..
        const int v0 = (int)((wstart + 32 * lane + a) & (kRing - 1));
        if (L <= 7)
          mask_word<10>(buf, v0, wstart + 32 * lane, n, L, inc, kWrap,
                        cw, ow);
        else
          mask_word<24>(buf, v0, wstart + 32 * lane, n, L, inc, kWrap,
                        cw, ow);
      });
  if (lane == 0) counts[b] = (int32_t)wblock::final_cut(st, P, bnd, ln);
  __syncwarp();
  rg.need(nslabs, nslabs - 1, lane == 0);  // every copy has landed
}

// One warp per chunk slot of the batch (modp.cuh's hash_slot).
__global__ void __launch_bounds__(kHashThreads)
fused_pipeline_hash_kernel(const uint8_t* __restrict__ x,
                           const int32_t* __restrict__ bounds,
                           const int32_t* __restrict__ counts,
                           const int32_t* __restrict__ pw,
                           uint32_t* __restrict__ fps, int B, long long n,
                           int mc) {
  modp::hash_slot<1, 1>(
      x, bounds, counts, pw, fps, B, n, mc,
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5, 0,
      threadIdx.x & 31);
}

}  // namespace

extern "C" int fused_pipeline_launch(const void* x, const void* pw,
                                     void* bounds, void* counts, void* fps,
                                     void* lens, int B, long long n,
                                     long long cover, int mc, int L, int inc,
                                     int W, int T, int skip, int sub_min,
                                     int max_size, void* stream) {
  if (W < 1 || W > 1024 || (W & (W - 1)) != 0 || L < 2 || L - 1 > kMaxHalo)
    return static_cast<int>(cudaErrorInvalidValue);
  const wblock::ScanParams P{n, cover, mc, L, W, T, skip, sub_min, max_size};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  fused_pipeline_scan_kernel<<<B, kScanThreads, 0, st>>>(
      static_cast<const uint8_t*>(x), static_cast<int32_t*>(bounds),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(lens), P, inc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = (long long)B * mc * 32;
  if (threads > 0) {
    fused_pipeline_hash_kernel<<<
        (unsigned)((threads + kHashThreads - 1) / kHashThreads), kHashThreads,
        0, st>>>(static_cast<const uint8_t*>(x),
                 static_cast<const int32_t*>(bounds),
                 static_cast<const int32_t*>(counts),
                 static_cast<const int32_t*>(pw), static_cast<uint32_t*>(fps),
                 B, n, mc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_pipeline_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
