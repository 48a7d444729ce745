// Segment-packed SeqCDC chunk + fingerprint pipeline for a (B, S) batch.
//
// Replaces the TPU kernel repro/kernels/fused_pipeline.py:packed_pipeline_batch
// (body _packed_pipeline_kernel).  Each row holds several streams back to
// back; ends (B, G) int32 lists their exclusive ends, nondecreasing, padded
// with the row's payload end n_row = ends[G-1].  Per row it computes what
// the packed split path computes (phase-1 masks clipped per segment, the
// segment-resetting automaton of repro/core/automaton.py:_scan_wide_packed
// with select_boundaries_packed's fixup at n_row, then the per-chunk
// fingerprints), bit for bit:
//   bounds (B, mc) int32 in row coordinates, every segment end a bound,
//     sentinel 1<<30 past the kept chunks;
//   counts (B,) int32, every emit counted, kept or not;
//   fps (B, mc, 2) uint32 and lens (B, mc) int32, zero past the kept chunks.
// Emits past mc are dropped whole (keep = emit & cnt < mc); the scheduler's
// mc = S / min_size + 2G + 2 is a true upper bound.
//
// Bound on this card: memory.  The function needs each data byte once
// (B * S), the ends table once (4 * B * G), and writes 16 bytes per chunk
// slot plus a count per row; its operations are far below the card's
// integer rate.  Least time: (B * S + 4 * B * G + 16 * B * mc + 4 * B) /
// 3.35 TB/s.
//
// Design.  The packed automaton resets at every segment end: a bound on
// the end leaves the registers in a fresh stream's init state, and the
// clipped masks never pair bytes of two segments.  So a packed row's
// bounds are each segment's own bounds, chunked alone, plus its offset
// (tests/test_torch_packing.py holds the reference to that), and the
// segments of a row are independent streams.  Two launches behind one
// call:
//
// 1. packed_pipeline_scan_kernel, one CTA of kWarps warps per row.
//    - Thread 0 copies the whole row (at most 64 KiB, from its 16-byte
//      floor) into dynamic shared memory with cp.async.bulk, kSlab bytes a
//      copy, each copy completing its own mbarrier; a warp waits only for
//      the slabs its segment reads.
//    - Then packed_walk.cuh's three steps, which
//      select_boundaries_packed.cu shares: every thread
//      sorts the segments (shorter than min_size: one chunk, its own
//      length; longer: a list), the warps take the listed segments and
//      walk each as its own stream of length l, the fused kernel's walk
//      (wblock.cuh's walk_windows, resolve and final_cut) with mask_word
//      reading the resident row (a segment's mask clip is the stream end
//      itself), each segment's bounds to its own range of a scratch area,
//      and a block-wide prefix sum over the counts places them in the
//      row's table (lengths are differences of consecutive bounds) before
//      select_boundaries_packed's fix-up at n_row.  The scratch lies in
//      shared memory where it fits beside the row, else in the device
//      buffer the wrapper passes; an undersized mc never runs short of it.
// 2. packed_pipeline_hash_kernel, one CTA per chunk slot over the batch,
//    its kHashWarps warps each hashing a kHashWarps-th of the chunk
//    (modp.cuh's hash_slot, which the fused kernel runs one warp a slot):
//    a chunk starts at the previous bound of its row, every segment end
//    being a bound.  A batch of 8 packed rows has a few hundred chunks at
//    most, so the longest chunk, not the card's width, sets the time (one
//    warp a slot, the hash took most of a heavy-tail call on an H100:
//    bench_scans.py times the two launches apart).
#include <cstdint>
#include <cuda_runtime.h>

#include "modp.cuh"
#include "packed_walk.cuh"
#include "ring.cuh"
#include "wblock.cuh"

namespace {

using ring::bulk_copy;
using ring::mbar_expect_tx;
using ring::mbar_wait;
using wblock::kMaxHalo;
using wblock::mask_word;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHashWarps = 8;  // warps hashing one chunk
constexpr int kMaxRow = 1 << 16;  // the reference's packed row bound
constexpr int kSlab = 4096;       // bytes a bulk copy
constexpr int kMaxSlabs = (kMaxRow + 16 + kSlab - 1) / kSlab;
constexpr int kTail = 112;  // bytes mask_word reads past a stream end
// shared memory a block may take, the row and the scratch together
constexpr int kSmemMax = 200 << 10;

struct Params {
  long long n;  // row width S
  int G, mc, L, inc, W, T, skip, sub_min, max_size;
  int list;          // entries of the long-segment list: n / min_size + 1
  int scratch;       // scratch ints a row: G counts, the list, the slots
  int row_bytes;     // shared bytes for the row (its floor, tail included)
  int smem_scratch;  // 1: the scratch lies in shared memory
};

__global__ void __launch_bounds__(kThreads)
packed_pipeline_scan_kernel(const uint8_t* __restrict__ x,
                            const int32_t* __restrict__ ends_all,
                            int32_t* __restrict__ bounds,
                            int32_t* __restrict__ counts,
                            int32_t* __restrict__ lens,
                            int32_t* __restrict__ gscratch, Params P) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kMaxSlabs];
  __shared__ pwalk::Shared<kWarps> sh;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const long long n = P.n;
  const uint8_t* row = x + b * n;
  const int32_t* ends = ends_all + (long long)b * P.G;
  int32_t* cnt = P.smem_scratch
                     ? reinterpret_cast<int32_t*>(smem + P.row_bytes)
                     : gscratch + b * P.scratch;
  const pwalk::Scratch sc{cnt, cnt + P.G, cnt + P.G + P.list};

  // -- the row into shared memory: virtual byte v is row byte v - a --------
  const int a = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const int vlen = ((int)n + a + 15) & ~15;
  const int nslabs = (vlen + kSlab - 1) / kSlab;
  if (tid == 0) {
    for (int j = 0; j < nslabs; ++j) ring::mbar_init(&full[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < nslabs; ++j) {
      const int bytes = vlen - j * kSlab < kSlab ? vlen - j * kSlab : kSlab;
      mbar_expect_tx(&full[j], bytes);
      bulk_copy(smem + j * kSlab, row - a + j * kSlab, bytes, &full[j]);
    }
    sh.nlong = 0;
    sh.next = 0;
  }
  __syncthreads();

  pwalk::classify<kThreads>(P, ends, sc, sh, tid);
  __syncthreads();

  // -- the warps: mask words from the resident row, a warp waiting only for
  // the slabs its segment reads; a segment's mask clip is its own end -----
  const int L = P.L;
  pwalk::walk_segments(
      P, ends, sc, sh, lane,
      [&](long long st, long long l) {
        const int vst = (int)st + a;
        const int vend = vst + (int)l + kTail < vlen ? vst + (int)l + kTail
                                                     : vlen;
        for (int j = vst / kSlab; j <= (vend - 1) / kSlab; ++j)
          mbar_wait(&full[j], 0);
      },
      [&](long long st, long long l, long long wstart, unsigned& cw,
          unsigned& ow) {
        // lane i: word i, positions wstart + 32i .. of the segment
        const long long p0 = wstart + 32 * lane;
        const int v0 = p0 < l ? (int)st + a + (int)p0 : 0;
        if (L <= 7)
          mask_word<10>(smem, v0, p0, l, L, P.inc, -1, cw, ow);
        else
          mask_word<24>(smem, v0, p0, l, L, P.inc, -1, cw, ow);
      });
  __syncthreads();

  pwalk::place<kThreads, kWarps, true>(P, ends, sc, sh, bounds + b * P.mc,
                                       lens + b * P.mc, counts + b, tid);
  if (tid == 0)
    for (int j = 0; j < nslabs; ++j) mbar_wait(&full[j], 0);  // all landed
}

// One CTA per chunk slot of the batch, its kHashWarps warps each over a
// kHashWarps-th of the chunk (modp.cuh's hash_slot).
__global__ void __launch_bounds__(32 * kHashWarps)
packed_pipeline_hash_kernel(const uint8_t* __restrict__ x,
                            const int32_t* __restrict__ bounds,
                            const int32_t* __restrict__ counts,
                            const int32_t* __restrict__ pw,
                            uint32_t* __restrict__ fps, int B, long long n,
                            int mc) {
  modp::hash_slot<4, kHashWarps>(x, bounds, counts, pw, fps, B, n, mc,
                                 blockIdx.x, threadIdx.x >> 5,
                                 threadIdx.x & 31);
}

}  // namespace

extern "C" int packed_pipeline_launch(const void* x, const void* ends,
                                      const void* pw, void* bounds,
                                      void* counts, void* fps, void* lens,
                                      void* scratch, long long ints, int B,
                                      long long n, int G, int mc, int L,
                                      int inc, int W, int T, int skip,
                                      int sub_min, int max_size,
                                      void* stream) {
  // scratch: B rows of ints, at least G counts, the long-segment list
  // (n / min_size + 1) and the slots (n / min_size + G)
  const int min_size = sub_min + L;
  if (W < 1 || W > 1024 || (W & (W - 1)) != 0 || L < 2 ||
      L - 1 > kMaxHalo || G < 1 || n < 1 || n > kMaxRow || min_size < 1 ||
      ints < 2LL * G + 2 * (n / min_size) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = ((int)n + 15 + kTail + 15) & ~15;
  const bool in_smem = row_bytes + 4 * ints <= kSmemMax;
  const int list = (int)(n / min_size) + 1;
  const Params P{n, G,    mc,        L,         inc,
                 W, T,    skip,      sub_min,   max_size,
                 list, (int)ints, row_bytes, in_smem ? 1 : 0};
  const int smem = row_bytes + (in_smem ? 4 * (int)ints : 0);
  if (smem > (48 << 10)) {  // above 48 KiB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        packed_pipeline_scan_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  packed_pipeline_scan_kernel<<<B, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(x), static_cast<const int32_t*>(ends),
      static_cast<int32_t*>(bounds), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(lens), static_cast<int32_t*>(scratch), P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = (long long)B * mc;
  if (slots > 0) {
    packed_pipeline_hash_kernel<<<(unsigned)slots, 32 * kHashWarps, 0, st>>>(
        static_cast<const uint8_t*>(x), static_cast<const int32_t*>(bounds),
        static_cast<const int32_t*>(counts), static_cast<const int32_t*>(pw),
        static_cast<uint32_t*>(fps), B, n, mc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* packed_pipeline_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
