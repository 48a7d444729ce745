// The native per-byte CDC scans on Hopper (sm_90a): one thread per stream.
//
// The device form of the reference's unaccelerated baselines, which it runs
// as per-byte lax.scans on the TPU (no Pallas kernel):
//   gear, crc, rabin, fastcdc  core/baselines/hash_based.py:36 _scan_native
//                              with each chunker's update/match;
//   ae, ram                    core/baselines/hashless.py:102-121, 182-199;
//   seqcdc                     core/seqcdc.py:125 boundaries_sequential
//                              (the scalar algorithm with data-dependent
//                              skipping).
// Per (B, n) row, bit for bit:
//   bounds (B, mc) int32, the exclusive chunk ends (the wrapper fills the
//   sentinel 1<<30 past them; ends past mc are counted and dropped);
//   counts (B,) int32.
// The reference emits a per-byte `ends` mask and cuts on the host
// (flatnonzero + 1, then n appended if it is not the last end); this kernel
// emits the same bounds directly, with the same trailing-n rule.  seqcdc
// emits as boundaries_sequential does (its last bound is always n).
//
// Bound on this card: none that the card's rates reach.  Its bytes bound is
// (n + 4 * mc) * B / 3.35 TB/s, but each step depends on the one before
// (the rolling register, the chunk-relative counters, the scan position),
// so a stream is one thread's serial loop: this is the paper's
// unaccelerated baseline, and its distance from the bound is the point.
//
// Design: a block of 32 threads, one stream each; the block stages the
// algorithm's tables (up to 3 x 256 uint32: the Gear table; CRC's byte
// step, first-offset and removal tables; Rabin's x^8 reduction,
// first-offset and removal tables) in shared memory.  The hash and hashless
// scans read 16 bytes ahead into registers (and the 16 bytes leaving the
// window for CRC/Rabin), so the loads do not wait on the register chain;
// the algorithm is a template parameter, so each loop holds only its own
// update and match.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kAhead = 16;

enum Algo { kGear = 0, kCrc, kRabin, kFastCdc, kAe, kRam, kSeqCdc, kAlgos };

struct Cfg {
  long long n;
  int mc, mn, mx;
  unsigned mask, mask_l;
  int avg, window;            // fastcdc's region switch; crc/rabin/ae/ram
  int L, T, skip, sub_min, inc;  // seqcdc
};

struct Out {
  int32_t* bnd;
  int mc;
  long long cnt = 0, last = -1;
  __device__ void emit(long long v) {
    if (cnt < mc) bnd[cnt] = (int32_t)v;
    ++cnt;
    last = v;
  }
};

template <int A>
__device__ void scan_bytes(const uint8_t* __restrict__ row,
                           const uint32_t* t, const Cfg& c, Out& o) {
  constexpr bool kRemove = A == kCrc || A == kRabin;
  const long long n = c.n;
  uint32_t h = 0;
  int rel = 0;                // hash scans: bytes in the chunk so far
  int arel = -1, ev = -1, ep = 0, m = 0;  // ae / ram registers
  for (long long i0 = 0; i0 < n; i0 += kAhead) {
    uint8_t bi[kAhead], bo[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const long long i = i0 + q;
      bi[q] = i < n ? row[i] : 0;
      if (kRemove) bo[q] = (i < n && i >= c.window) ? row[i - c.window] : 0;
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const long long i = i0 + q;
      if (i >= n) break;
      const int b = bi[q];
      bool end;
      if (A == kAe) {
        ++arel;
        if (b > ev) {
          ev = b;
          ep = arel;
        }
        end = (arel - ep >= c.window && arel + 1 >= c.mn) || arel + 1 >= c.mx;
        if (end) {
          arel = -1;
          ev = -1;
          ep = 0;
        }
      } else if (A == kRam) {
        ++arel;
        const bool in_win = arel < c.window;
        if (in_win) m = b > m ? b : m;
        end = (!in_win && b >= m && arel + 1 >= c.mn) || arel + 1 >= c.mx;
        if (end) {
          arel = -1;
          m = 0;
        }
      } else {
        if (A == kCrc) {
          h = (h << 8) ^ t[h >> 24];
          h ^= t[256 + b] ^ t[512 + bo[q]];
        } else if (A == kRabin) {
          h = ((h << 8) & 0x7FFFFFFFu) ^ t[(h >> 23) & 0xFF];
          h ^= t[256 + b] ^ t[512 + bo[q]];
        } else {  // gear, fastcdc
          h = (h << 1) + t[b];
        }
        ++rel;
        bool match;
        if (A == kFastCdc)
          match = rel < c.avg ? (h & c.mask) == 0 : (h & c.mask_l) == 0;
        else
          match = (h & c.mask) == 0;
        end = (match && rel >= c.mn) || rel >= c.mx;
        if (end) rel = 0;
      }
      if (end) o.emit(i + 1);
    }
  }
  if (o.cnt == 0 || o.last != n) o.emit(n);
}

// boundaries_sequential's loop, one scanned position an iteration
// (n >= max(L, 2), which the wrapper checks).
__device__ void scan_seqcdc(const uint8_t* __restrict__ row, const Cfg& c,
                            Out& o) {
  const long long n = c.n;
  const int L = c.L;
  long long k = c.sub_min, s = 0;
  int cnt_opp = 0;
  while (s < n) {
    const long long cut_b = s + c.mx < n ? s + c.mx : n;
    const bool hit_cut = k >= cut_b - (L - 1);
    const long long lim = n - L > 0 ? n - L : 0;  // a window's last start
    const long long sk = k < lim ? k : lim;
    bool is_cand = false;
    if (!hit_cut) {
      is_cand = true;
      for (int j = 0; j < L - 1; ++j) {
        const uint8_t a = row[sk + j], b = row[sk + j + 1];
        if (c.inc ? !(b > a) : !(b < a)) {
          is_cand = false;
          break;
        }
      }
    }
    const uint8_t a = row[sk < n - 2 ? sk : n - 2];
    const uint8_t b = row[sk + 1 < n - 1 ? sk + 1 : n - 1];
    const bool is_opp =
        !hit_cut && !is_cand && (c.inc ? (b < a) : (b > a));
    const bool trig = is_opp && (long long)cnt_opp + 1 > c.T;
    if (hit_cut || is_cand) {
      const long long bound = hit_cut ? cut_b : k + L;
      o.emit(bound);
      s = bound;
      k = bound + c.sub_min;
      cnt_opp = 0;
    } else if (trig) {
      k += c.skip;
      cnt_opp = 0;
    } else {
      ++k;
      cnt_opp += is_opp;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
native_scan_kernel(const uint8_t* __restrict__ x,
                   const uint32_t* __restrict__ tables,
                   int32_t* __restrict__ bounds, int32_t* __restrict__ counts,
                   int B, int algo, Cfg c) {
  __shared__ uint32_t st[3 * 256];
  for (int i = threadIdx.x; i < 3 * 256; i += kThreads) st[i] = tables[i];
  __syncthreads();
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= B) return;
  const uint8_t* row = x + r * c.n;
  Out o{bounds + r * c.mc, c.mc};
  switch (algo) {
    case kGear: scan_bytes<kGear>(row, st, c, o); break;
    case kCrc: scan_bytes<kCrc>(row, st, c, o); break;
    case kRabin: scan_bytes<kRabin>(row, st, c, o); break;
    case kFastCdc: scan_bytes<kFastCdc>(row, st, c, o); break;
    case kAe: scan_bytes<kAe>(row, st, c, o); break;
    case kRam: scan_bytes<kRam>(row, st, c, o); break;
    default: scan_seqcdc(row, c, o); break;
  }
  counts[r] = (int32_t)o.cnt;
}

}  // namespace

extern "C" int native_scan_launch(const void* x, const void* tables,
                                  void* bounds, void* counts, int B,
                                  long long n, int mc, int algo, int mn,
                                  int mx, unsigned mask, unsigned mask_l,
                                  int avg, int window, int L, int T, int skip,
                                  int sub_min, int inc, void* stream) {
  if (algo < 0 || algo >= kAlgos || mc < 1 ||
      (algo == kSeqCdc && (L < 2 || n < L)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Cfg c{n, mc, mn, mx, mask, mask_l, avg, window, L, T, skip, sub_min,
              inc};
  const int grid = (B + kThreads - 1) / kThreads;
  if (grid > 0) {
    native_scan_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint32_t*>(tables),
        static_cast<int32_t*>(bounds), static_cast<int32_t*>(counts), B, algo,
        c);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* native_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
