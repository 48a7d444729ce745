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
// Design: fused_pipeline.cu's (wblock.cuh): one 8-warp block owns a row and
// walks its tiles in order, stages each tile's bytes in shared memory,
// builds candidate/opposing words with __ballot_sync, runs the automaton in
// warp 0 and hashes the kept chunks from device memory after the scan.
// What packing changes:
// - The segment clip.  The TPU kernel reads a per-position segment-end
//   operand (4 bytes a byte).  Here the kernel derives it from ends: a
//   candidate at pos survives iff no segment end lies in [pos+1, pos+L-1]
//   and pos < n_row, an opposing pair iff pos+1 is not an end and
//   pos < n_row, which is the reference's pos <= sep-L and pos < sep-1 for
//   the sep layout the scheduler builds (core/seqcdc.segment_end_positions).
//   Per tile the ends in (t0, t0 + kTile + L - 1) go into a shared bitmap
//   (a binary search finds the first, then one atomicOr each).  So the
//   kernel reads 4 bytes per segment, not 4 per position.
// - The se register.  ends stays in device memory: G reaches 65536 entries
//   (a 64 KiB row of 1-byte streams), more than a block's shared memory.
//   warp 0 reads it in order through a pointer that only moves forward, 32
//   entries a warp load (next_end below), so no emit rescans the table.
// - Several events per W-block.  An emit re-resolves the same block while
//   the clamped scan position k = min(k', se - (L-1)) lies inside it and the
//   row has payload left; every pass emits a strictly larger bound or
//   leaves, so the loop ends.  The clamp can pull k below the block start
//   (negative for a segment shorter than L-1): registers are signed 64-bit.
// - Fingerprints.  The hash weights bytes by offset from the chunk end, so
//   hashing each kept chunk [prev, bound) straight from the row gives the
//   stream's own fingerprint; the TPU kernel's per-segment prefix operands
//   and left stash exist only for its running prefix carry.
// With 8 rows per dispatch this fills 8 of the card's 132 SMs.
#include <cstdint>
#include <cuda_runtime.h>

#include "modp.cuh"
#include "wblock.cuh"

namespace {

using modp::add_range;
using modp::kFull;
using modp::warp_sum_mod;
using wblock::kBig;
using wblock::kMaxHalo;
using wblock::kThreads;
using wblock::kTile;
using wblock::kWarps;

constexpr int kEndWords = (kTile + kMaxHalo) / 32;

struct Params {
  long long n;      // row width S
  long long cover;  // nb_split * W: the split path's padded block range
  int G, mc, L, inc, W, T, skip, sub_min, max_size;
};

// The first end strictly greater than x at or after index ei (kBig when
// none), 32 entries a warp load; ei moves to its index.  Called by a whole
// warp with the same arguments.  ends is nondecreasing and x never
// decreases between calls, so the pointer only moves forward.
__device__ __forceinline__ long long next_end(const int32_t* ends, int G,
                                              int& ei, long long x,
                                              int lane) {
  for (;;) {
    const int i = ei + lane;
    const long long e = i < G ? (long long)ends[i] : (long long)kBig;
    const unsigned hit = __ballot_sync(kFull, e > x);
    if (hit) {
      const int f = __ffs(hit) - 1;
      ei += f;
      return __shfl_sync(kFull, e, f);
    }
    ei += 32;
  }
}

__device__ __forceinline__ bool is_end(const uint32_t* send, int q) {
  return (send[q >> 5] >> (q & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
packed_pipeline_kernel(const uint8_t* __restrict__ x,
                       const int32_t* __restrict__ ends_all,
                       const int32_t* __restrict__ pw,
                       int32_t* __restrict__ bounds,
                       int32_t* __restrict__ counts,
                       uint32_t* __restrict__ fps,
                       int32_t* __restrict__ lens, Params P) {
  __shared__ uint8_t sx[kTile + kMaxHalo];
  __shared__ uint32_t scand[kTile / 32];
  __shared__ uint32_t sopp[kTile / 32];
  __shared__ uint32_t send[kEndWords];  // bit q: t0 + q is a segment end
  __shared__ long long sh_k, sh_s;      // warp 0's scan state, for all
  __shared__ int sh_lo, sh_kept;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const long long S = P.n;
  const int W = P.W;
  const uint8_t* row = x + b * S;
  const int32_t* ends = ends_all + b * P.G;
  const long long n_row = ends[P.G - 1];  // the payload end
  int32_t* bnd = bounds + b * P.mc;
  int32_t* ln = lens + b * P.mc;
  uint32_t* fp = fps + b * P.mc * 2;
  for (int i = tid; i < P.mc; i += kThreads) {
    bnd[i] = kBig;
    ln[i] = 0;
    fp[2 * i] = 0;
    fp[2 * i + 1] = 0;
  }
  // the scan registers; only warp 0's copy is live.  se is the current
  // segment's end; k starts clamped to its first cut, as the reference's
  // init does (the first segment may be shorter than min_size)
  long long k = 0, c = 0, s = 0, se = 0, cnt = 0, last_kept = 0;
  int ei = 0;
  if (warp == 0) {
    se = next_end(ends, P.G, ei, 0, lane);
    k = se - (P.L - 1) < P.sub_min ? se - (P.L - 1) : P.sub_min;
    if (lane == 0) {
      sh_k = k;
      sh_s = 0;
    }
  }
  __syncthreads();

  for (long long t0 = 0; t0 < P.cover; t0 += kTile) {
    const long long tend = t0 + kTile;
    if (sh_s >= n_row) break;      // the row is done
    if (sh_k >= tend) continue;    // every block of this tile is a no-op
    // -- stage the tile's bytes and mark the segment ends that clip it ----
    wblock::stage_tile(sx, row, t0, S, P.L, tid);
    for (int w = tid; w < kEndWords; w += kThreads) send[w] = 0;
    if (tid == 0) {  // first end > t0
      int lo = 0, hi = P.G;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ends[mid] > t0)
          hi = mid;
        else
          lo = mid + 1;
      }
      sh_lo = lo;
    }
    __syncthreads();
    const long long reach = t0 + kTile + P.L - 1;  // ends that clip a mask
    for (int i = sh_lo + tid; i < P.G; i += kThreads) {
      const long long e = ends[i];
      if (e >= reach) break;
      const int q = (int)(e - t0);
      atomicOr(&send[q >> 5], 1u << (q & 31));
    }
    __syncthreads();
    // -- phase-1 mask words, clipped per segment ---------------------------
    for (int w = warp; w < kTile / 32; w += kWarps) {
      const int i = w * 32 + lane;
      const long long pos = t0 + i;
      bool cd = false, op = false;
      if (pos < n_row) {
        if (!is_end(send, i + 1)) {
          const uint8_t a = sx[i], nx = sx[i + 1];
          op = P.inc ? (nx < a) : (nx > a);
        }
        cd = true;
        for (int j = 0; j < P.L - 1; ++j) {
          const uint8_t a = sx[i + j], nx = sx[i + j + 1];
          cd = cd && !is_end(send, i + j + 1) &&
               (P.inc ? (nx > a) : (nx < a));
        }
      }
      const unsigned cw = __ballot_sync(kFull, cd);
      const unsigned ow = __ballot_sync(kFull, op);
      if (lane == 0) {
        scand[w] = cw;
        sopp[w] = ow;
      }
    }
    __syncthreads();
    // -- warp 0: the packed W-block automaton over this tile ----------------
    if (warp == 0) {
      const long long blk_end = tend < P.cover ? tend : P.cover;
      long long bstart = (k / W) * W;
      if (bstart < t0) bstart = t0;
      while (bstart < blk_end && s < n_row) {
        const long long bend = bstart + W;
        if (k >= bend) {  // not in_block: state unchanged, jump to k's block
          const long long to = (k / W) * W;
          bstart = to > bend ? to : bend;
          continue;
        }
        const long long o = k > bstart ? k - bstart : 0;  // first active pos
        const wblock::BlockHit h = wblock::block_search(
            scand, sopp, (int)(bstart - t0), W, o, bstart, c, P.T, lane);
        const long long kc = h.kc, kt = h.kt;
        // _resolve against the segment end se (in_block holds here)
        const long long cut_b = s + P.max_size < se ? s + P.max_size : se;
        const long long cut_k = cut_b - (P.L - 1);
        const long long e_cut = cut_k > k ? cut_k : k;
        const bool fire_cut = e_cut < bend && e_cut <= (kc < kt ? kc : kt);
        const bool fire_cand = !fire_cut && kc < kt;
        const bool fire_trig = !fire_cut && !fire_cand && kt < kBig;
        const bool emit_cut = fire_cut || (fire_trig && kt + P.skip >= cut_k);
        const bool emit = emit_cut || fire_cand;
        const long long bound = emit_cut ? cut_b : kc + P.L;
        c = (fire_cut || fire_cand || fire_trig) ? 0 : c + h.total;
        if (!emit) {
          k = fire_trig ? kt + P.skip : bend;  // both clear the block
          bstart = bend;
          continue;
        }
        if (cnt < P.mc) {  // the split path's mode="drop" scatter
          if (lane == 0) {
            bnd[cnt] = (int32_t)bound;
            ln[cnt] = (int32_t)(bound - s);
          }
          last_kept = bound;
        }
        ++cnt;
        s = bound;
        // a bound on the segment end starts the next segment: the emit's
        // registers are a fresh stream's init state
        if (bound >= se) se = next_end(ends, P.G, ei, bound, lane);
        k = bound + P.sub_min;
        if (k > se - (P.L - 1)) k = se - (P.L - 1);  // the post-emit clamp
        // a cut that resets the scan inside this block resolves it again
        if (!(k < bend && s < n_row)) bstart = bend;
      }
      if (lane == 0) {
        sh_k = k;
        sh_s = s;
      }
    }
    __syncthreads();
  }
  // -- select_boundaries_packed's fixup (the payload end), then hashes -----
  if (tid == 0) {
    if ((cnt > 0 ? last_kept : 0) < n_row && n_row > 0) {
      if (cnt < P.mc) {
        bnd[cnt] = (int32_t)n_row;
        ln[cnt] = (int32_t)(n_row - s);
      }
      ++cnt;
    }
    counts[b] = (int32_t)cnt;
    sh_kept = (int)(cnt < P.mc ? cnt : P.mc);
  }
  __syncthreads();
  for (int j = warp; j < sh_kept; j += kWarps) {
    const long long e = bnd[j], st = j > 0 ? bnd[j - 1] : 0;
    unsigned long long a1 = 0, a2 = 0;
    add_range<4>(row, st, e, e, pw, lane, a1, a2);
    a1 = warp_sum_mod(a1);
    a2 = warp_sum_mod(a2);
    if (lane == 0) {
      fp[2 * j] = (uint32_t)a1;
      fp[2 * j + 1] = (uint32_t)a2;
    }
  }
}

}  // namespace

extern "C" int packed_pipeline_launch(const void* x, const void* ends,
                                      const void* pw, void* bounds,
                                      void* counts, void* fps, void* lens,
                                      int B, long long n, long long cover,
                                      int G, int mc, int L, int inc, int W,
                                      int T, int skip, int sub_min,
                                      int max_size, void* stream) {
  if (W < 1 || W > 1024 || (W & (W - 1)) != 0 || kTile % W != 0 ||
      L < 2 || L - 1 > kMaxHalo || G < 1 || n > (1 << 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{n, cover, G, mc, L, inc, W, T, skip, sub_min, max_size};
  if (B > 0) {
    packed_pipeline_kernel<<<B, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int32_t*>(ends),
        static_cast<const int32_t*>(pw), static_cast<int32_t*>(bounds),
        static_cast<int32_t*>(counts), static_cast<uint32_t*>(fps),
        static_cast<int32_t*>(lens), P);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* packed_pipeline_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
