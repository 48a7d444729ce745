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
// Emits past mc are dropped whole, as the split path's mode="drop" scatter
// drops them (keep = emit & cnt < mc); max_chunks must be a true upper
// bound on the chunk count, as for the TPU kernel.
//
// Bound on this card: memory.  The function needs each input byte once
// (B * S bytes) and writes 16 bytes per chunk slot plus a count per row; its
// operations (about L compares per byte for the masks, two 64-bit
// multiply-adds per byte for the hashes) are far below the card's integer
// rate.  Least time: (B * S + 16 * B * mc + 4 * B) / 3.35 TB/s.
//
// Design: the TPU kernel walks a row's tiles in grid order with the scan
// state in scratch memory; blocks on this card run in no order, so here one
// thread block (8 warps) owns one row and a loop inside it walks the row's
// tiles in order.  Per tile of 4096 positions all 8 warps stage the bytes
// (plus the L-1 halo) in shared memory, every thread with its 17 loads in
// flight at once, and turn the compares into 32-bit candidate/opposing
// words with __ballot_sync.  Warp 0 then runs the automaton over the
// tile's W-blocks (wblock.cuh: lane i takes word i of a block, the first
// candidate is a warp min of __ffs, the skip trigger the m-th opposing bit
// found by a warp prefix sum of __popc), and every lane applies _resolve
// on the same values; the scan state stays in its registers and the scan
// position goes to shared memory for the next tile's skip test.  A block the scan position has already passed is a
// no-op in the split path (its state is unchanged), so the loop jumps to
// the block holding the scan position, and a tile with no such block is
// not even staged.  Emitted bounds and lengths are written as they come;
// once the row is scanned the 8 warps hash the kept chunks [s, e) straight
// from device memory (L2-resident: the row was just staged), a warp per
// chunk, with modp.cuh's add_range and warp_sum_mod.
// With B <= 8 rows per dispatch this fills 8 of the card's 132 SMs: the
// parallel form across a row is later work.
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

struct Params {
  long long n;       // row length S
  long long cover;   // nb_split * W: the split path's padded block range
  int mc, L, inc, W, T, skip, sub_min, max_size;
};

__global__ void __launch_bounds__(kThreads)
fused_pipeline_kernel(const uint8_t* __restrict__ x,
                      const int32_t* __restrict__ pw,
                      int32_t* __restrict__ bounds,
                      int32_t* __restrict__ counts,
                      uint32_t* __restrict__ fps,
                      int32_t* __restrict__ lens, Params P) {
  __shared__ uint8_t sx[kTile + kMaxHalo];
  __shared__ uint32_t scand[kTile / 32];
  __shared__ uint32_t sopp[kTile / 32];
  __shared__ long long sh_k, sh_s;  // warp 0's scan state, for every warp
  __shared__ int sh_kept;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const long long n = P.n;
  const int W = P.W;
  const uint8_t* row = x + b * n;
  int32_t* bnd = bounds + b * P.mc;
  int32_t* ln = lens + b * P.mc;
  uint32_t* fp = fps + b * P.mc * 2;
  for (int i = tid; i < P.mc; i += kThreads) {
    bnd[i] = kBig;
    ln[i] = 0;
    fp[2 * i] = 0;
    fp[2 * i + 1] = 0;
  }
  if (tid == 0) {
    sh_k = P.sub_min;
    sh_s = 0;
  }
  __syncthreads();

  // the scan registers; only warp 0's copy is live
  long long k = P.sub_min, c = 0, s = 0, cnt = 0, last_kept = 0;
  for (long long t0 = 0; t0 < P.cover; t0 += kTile) {
    const long long tend = t0 + kTile;
    if (sh_s >= n) break;          // the row is done
    if (sh_k >= tend) continue;    // every block of this tile is a no-op
    // -- stage the tile's bytes (zero past the row), all loads in flight --
    wblock::stage_tile(sx, row, t0, n, P.L, tid);
    __syncthreads();
    // -- phase-1 mask words: bit q of word w is position t0 + 32w + q ------
    for (int w = warp; w < kTile / 32; w += kWarps) {
      const int i = w * 32 + lane;
      const long long pos = t0 + i;
      bool cd = false, op = false;
      if (pos < n - 1) {
        const uint8_t a = sx[i], nx = sx[i + 1];
        op = P.inc ? (nx < a) : (nx > a);
      }
      if (pos <= n - P.L) {
        cd = true;
        for (int j = 0; j < P.L - 1; ++j) {
          const uint8_t a = sx[i + j], nx = sx[i + j + 1];
          cd = cd && (P.inc ? (nx > a) : (nx < a));
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
    // -- warp 0: the W-block automaton over this tile -----------------------
    if (warp == 0) {
      const long long blk_end = tend < P.cover ? tend : P.cover;
      long long bstart = (k / W) * W;
      if (bstart < t0) bstart = t0;
      while (bstart < blk_end && s < n) {
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
        // _resolve (in_block holds here)
        const long long cut_b = s + P.max_size < n ? s + P.max_size : n;
        const long long cut_k = cut_b - (P.L - 1);
        const long long e_cut = cut_k > k ? cut_k : k;
        const bool fire_cut = e_cut < bend && e_cut <= (kc < kt ? kc : kt);
        const bool fire_cand = !fire_cut && kc < kt;
        const bool fire_trig = !fire_cut && !fire_cand && kt < kBig;
        const bool emit_cut = fire_cut || (fire_trig && kt + P.skip >= cut_k);
        const bool emit = emit_cut || fire_cand;
        const long long bound = emit_cut ? cut_b : kc + P.L;
        if (emit)
          k = bound + P.sub_min;
        else if (fire_trig)
          k = kt + P.skip;
        else
          k = bend;
        c = (fire_cut || fire_cand || fire_trig) ? 0 : c + h.total;
        if (emit) {
          if (cnt < P.mc) {  // the split path's mode="drop" scatter
            if (lane == 0) {
              bnd[cnt] = (int32_t)bound;
              ln[cnt] = (int32_t)(bound - s);
            }
            last_kept = bound;
          }
          ++cnt;
          s = bound;
        }
        bstart = bend;
      }
      if (lane == 0) {
        sh_k = k;
        sh_s = s;
      }
    }
    __syncthreads();
  }
  // -- select_boundaries' fixup (the final boundary n), then the hashes ----
  if (tid == 0) {
    if ((cnt > 0 ? last_kept : 0) < n) {
      if (cnt < P.mc) {
        bnd[cnt] = (int32_t)n;
        ln[cnt] = (int32_t)(n - s);
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

extern "C" int fused_pipeline_launch(const void* x, const void* pw,
                                     void* bounds, void* counts, void* fps,
                                     void* lens, int B, long long n,
                                     long long cover, int mc, int L, int inc,
                                     int W, int T, int skip, int sub_min,
                                     int max_size, void* stream) {
  if (W < 1 || W > 1024 || (W & (W - 1)) != 0 || kTile % W != 0 ||
      L < 2 || L - 1 > kMaxHalo)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{n, cover, mc, L, inc, W, T, skip, sub_min, max_size};
  if (B > 0) {
    fused_pipeline_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int32_t*>(pw),
        static_cast<int32_t*>(bounds), static_cast<int32_t*>(counts),
        static_cast<uint32_t*>(fps), static_cast<int32_t*>(lens), P);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_pipeline_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
