// The native per-byte CDC scans on Hopper (sm_90a): one thread's serial
// loop per stream, fed from a shared-memory ring.
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
// unaccelerated (SEQ) baseline, and its distance from the bound is the
// point.  Its floor is the chain: the dependent instructions of one byte's
// update and match times their latencies.
//
// Design: the chain stays whole (one thread does each byte's update and
// match, in order); the data movement and the bookkeeping are taken off it.
// One CTA of two warps per stream: a producer thread streams the row into a
// ring of shared-memory slabs with cp.async.bulk (ring.cuh), and the
// scanning thread reads its bytes 32 at a time from shared memory (two
// 16-byte loads), so no load from device memory is on the chain.  The
// algorithm's tables (up to 3 x 256 uint32: the Gear table; CRC's byte
// step, first-offset and removal tables; Rabin's x^8 reduction,
// first-offset and removal tables) sit in shared memory; the algorithm is a
// template parameter, so each loop holds only its own update and match.
// Per unit of 32 bytes the hash scans load every byte's table operands
// first, then run the hash update alone on the chain, each byte's match a
// bit of a mask; the chunk-size tests are thresholds on the position, so
// the cuts come from the masks after the unit (the reference's `rel`
// counter is not on the chain).  The hashless scans keep only the extremum
// on the chain and rescan the rest of a unit after a cut.  CRC and Rabin
// keep `window` bytes behind the scan resident for the bytes leaving the
// window.  The seqcdc scan holds the 8 bytes from its scan position in a
// register and, when the position moves by one, shifts in the next byte,
// loaded the step before; after a skip or an emit it reloads from the ring.
#include <cstdint>
#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

using Ring = ring::Ring<8192, 4>;  // 8 KiB a bulk copy, four slots
constexpr int kSlab = Ring::kSlab;
constexpr int kMask = Ring::kBytes - 1;
constexpr int kThreads = 64;  // thread 0 scans, thread 32 produces
constexpr int kWinMax = (Ring::kSlabs - 1) * kSlab;  // CRC/Rabin window
constexpr int kSeqReg = 8;  // bytes of the seqcdc scan's register window
constexpr int kUnit = 32;   // bytes a step of the byte scans: two loads
constexpr unsigned kAll = 0xFFFFFFFFu;

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
  int cnt = 0, last = -1;
  __device__ __forceinline__ void emit(int v) {
    if (cnt < mc) bnd[cnt] = v;
    ++cnt;
    last = v;
  }
};

// The bits of a unit below q (bit j: byte j of the unit).
__device__ __forceinline__ unsigned below(int q) {
  return q <= 0 ? 0u : q >= kUnit ? kAll : (1u << q) - 1u;
}

__device__ __forceinline__ int byte_of(const uint32_t wd[kUnit / 4], int q) {
  return (wd[q >> 2] >> (8 * (q & 3))) & 0xFF;
}

// The registers of the byte scans.  Positions are row offsets; a chunk
// starts at `start`, so its length after byte i is i - start + 1 (the
// reference's `rel`), and its size tests are thresholds on i, not a
// counter on the chain.
struct ByteState {
  uint32_t h = 0;       // hash scans: the rolling hash
  int start = 0;        // the current chunk's first byte
  int ev = -1, ep = 0;  // ae: the extremum and its position
  int m = 0;            // ram: the window's maximum
};

// The cuts among the bytes of a unit whose flags (the hash match, or the
// extremum test) are in `flags`: every byte i with a flag and a length of
// at least mn, or a length of mx, ends a chunk, in order, each cut moving
// `start`.  valid: the unit's bytes inside the row.  Returns the bytes
// past the first cut (0 if none), for the hashless scans, whose registers
// restart there.
template <int A>
__device__ __forceinline__ unsigned cut_unit(ByteState& st, unsigned ms,
                                             unsigned ml, unsigned valid,
                                             int i0, const Cfg& c, Out& o,
                                             bool first_only) {
  for (;;) {
    const int rq = st.start - i0;  // the unit byte the chunk starts at
    unsigned m = ms;
    if (A == kFastCdc) {  // the small mask while the chunk is below avg
      const unsigned lt = below(rq + c.avg - 1);
      m = (ms & lt) | (ml & ~lt);
    }
    const unsigned e =
        ((m & ~below(rq + c.mn - 1)) | ~below(rq + c.mx - 1)) & valid;
    if (!e) return 0;
    const int q = __ffs(e) - 1;
    o.emit(i0 + q + 1);
    st.start = i0 + q + 1;
    valid &= ~below(q + 1);
    if (first_only) return valid;
  }
}

// One unit of a hash scan (bytes [qa, qb) inside the row; all of them
// unless kEdge).  The per-byte operands (the Gear table entry; CRC's and
// Rabin's entering and leaving bytes through their tables) are loaded
// first, off the chain; the chain is the hash update alone, each byte's
// match a bit of ms (ml: fastcdc's large mask); the cuts come after.
template <int A, bool kEdge>
__device__ __forceinline__ void hash_unit(ByteState& st,
                                          const uint32_t wd[kUnit / 4],
                                          const uint8_t* buf, int u, int i0,
                                          int qa, int qb, const uint32_t* t,
                                          const Cfg& c, Out& o) {
  constexpr bool kRemove = A == kCrc || A == kRabin;
  uint32_t x[kUnit];
#pragma unroll
  for (int q = 0; q < kUnit; ++q) {
    const int b = byte_of(wd, q);
    if (kRemove) {
      const int bo = !kEdge || i0 + q >= c.window
                         ? buf[(u + q - c.window) & kMask]
                         : 0;
      x[q] = t[256 + b] ^ t[512 + bo];
    } else {
      x[q] = t[b];
    }
  }
  uint32_t h = st.h;
  unsigned ms = 0, ml = 0;
#pragma unroll
  for (int q = 0; q < kUnit; ++q) {
    if (kEdge && (q < qa || q >= qb)) continue;
    if (A == kCrc)
      h = ((h << 8) ^ x[q]) ^ t[h >> 24];
    else if (A == kRabin)
      h = (((h << 8) & 0x7FFFFFFFu) ^ x[q]) ^ t[(h >> 23) & 0xFF];
    else  // gear, fastcdc
      h = (h << 1) + x[q];
    ms |= (unsigned)((h & c.mask) == 0) << q;
    if (A == kFastCdc) ml |= (unsigned)((h & c.mask_l) == 0) << q;
  }
  st.h = h;
  cut_unit<A>(st, ms, ml, kEdge ? below(qb) & ~below(qa) : kAll, i0, c, o,
              false);
}

// The hashless scans' flags over bytes [q0, qe) of a unit from the
// registers in st (which it advances): AE's "the maximum lies window bytes
// back", RAM's "past the window and at least its maximum".
template <int A, bool kWhole>
__device__ __forceinline__ unsigned extremum_pass(ByteState& st,
                                                  const uint32_t* wd, int i0,
                                                  int q0, int qe,
                                                  const Cfg& c) {
  const int win_q = st.start - i0 + c.window;  // ram: bytes below are in
  unsigned flags = 0;
#pragma unroll
  for (int q = 0; q < kUnit; ++q) {
    if (!kWhole && (q < q0 || q >= qe)) continue;
    const int b = byte_of(wd, q);
    if (A == kAe) {
      if (b > st.ev) {
        st.ev = b;
        st.ep = i0 + q;
      }
      flags |= (unsigned)(i0 + q - st.ep >= c.window) << q;
    } else {  // ram
      const bool in_win = q < win_q;
      if (in_win) st.m = b > st.m ? b : st.m;
      flags |= (unsigned)(!in_win && b >= st.m) << q;
    }
  }
  return flags;
}

// One unit of a hashless scan: its registers restart after each cut, so
// the bytes past a cut are scanned again from the fresh registers.
template <int A, bool kEdge>
__device__ __forceinline__ void extremum_unit(ByteState& st,
                                              const uint32_t* wd, int i0,
                                              int qa, int qb, const Cfg& c,
                                              Out& o) {
  ByteState run = st;
  unsigned flags = kEdge ? extremum_pass<A, false>(run, wd, i0, qa, qb, c)
                         : extremum_pass<A, true>(run, wd, i0, 0, kUnit, c);
  unsigned rest = kEdge ? below(qb) & ~below(qa) : kAll;
  for (;;) {
    const int start = st.start;
    rest = cut_unit<A>(run, flags, 0, rest, i0, c, o, true);
    if (run.start == start) break;  // no cut: the registers stand
    run.ev = -1;  // a fresh chunk's registers (ae's position follows)
    run.m = 0;
    st.start = run.start;
    const int q0 = run.start - i0;
    flags = extremum_pass<A, false>(run, wd, i0, q0, kEdge ? qb : kUnit, c);
  }
  st = run;
}

// The hash and hashless scans: the row slab by slab, a unit of 32 bytes (two
// 16-byte loads) a step.  a is the row's offset from its 16-byte floor
// (ring.cuh's virtual bytes); a row's last unit may reach 16 bytes past
// what was copied, bytes it never scans.
template <int A>
__device__ __forceinline__ void scan_bytes(Ring& rg, const uint8_t* buf,
                                           int a, const uint32_t* t,
                                           const Cfg& c, Out& o) {
  constexpr bool kHash = A == kGear || A == kCrc || A == kRabin ||
                         A == kFastCdc;
  constexpr bool kRemove = A == kCrc || A == kRabin;
  const int n = (int)c.n, vlen = n > 0 ? n + a : 0;
  const int back = kRemove ? c.window : 0;  // bytes kept behind the scan
  ByteState st;
  for (int v0 = 0; v0 < vlen; v0 += kSlab) {
    rg.need(v0 > back ? (v0 - back) / kSlab : 0, v0 / kSlab, true);
    const int vend = v0 + kSlab < vlen ? v0 + kSlab : vlen;
    for (int u = v0; u < vend; u += kUnit) {
      const uint4 w0 = *reinterpret_cast<const uint4*>(buf + (u & kMask));
      const uint4 w1 =
          *reinterpret_cast<const uint4*>(buf + ((u + 16) & kMask));
      const uint32_t wd[kUnit / 4] = {w0.x, w0.y, w0.z, w0.w,
                                      w1.x, w1.y, w1.z, w1.w};
      const int i0 = u - a;  // row position of the unit's first byte
      if (i0 >= back && u + kUnit <= vlen) {  // the unit inside the row
        if (kHash)
          hash_unit<A, false>(st, wd, buf, u, i0, 0, kUnit, t, c, o);
        else
          extremum_unit<A, false>(st, wd, i0, 0, kUnit, c, o);
      } else {  // the row's first units or its last
        const int qa = i0 < 0 ? -i0 : 0;
        const int qb = n - i0 < kUnit ? n - i0 : kUnit;
        if (kHash)
          hash_unit<A, true>(st, wd, buf, u, i0, qa, qb, t, c, o);
        else
          extremum_unit<A, true>(st, wd, i0, qa, qb, c, o);
      }
    }
  }
  if (o.cnt == 0 || o.last != n) o.emit(n);
}

// boundaries_sequential's loop, one scanned position an iteration
// (n >= max(L, 2), which the wrapper checks).  win holds the bytes from
// the scan position sk = min(k, n - L), nxt the byte after them.  The
// inner loop is the common step, no event: k moves by one, the window
// shifts nxt in and loads the byte after, so the compares read registers;
// an event (a cut, a candidate, the skip trigger) or the row's last window
// leaves it, and the window reloads from the ring.  L > kSeqReg (kShort
// false) compares from the ring.
template <bool kInc, bool kShort>
__device__ __forceinline__ void scan_seqcdc(Ring& rg, const uint8_t* buf,
                                            int a, const Cfg& c, Out& o) {
  const int n = (int)c.n, L = c.L;
  const int lim = n - L;  // a window's last start
  const int last_slab = (int)Ring::slabs(n + a) - 1;
  const int ahead = L - 1 > kSeqReg ? L - 1 : kSeqReg;  // bytes past sk
  // virtual bytes below ready_end are resident (all, once the last slab is)
  int ready_end = 0;
  auto resident = [&](int v) {  // make virtual bytes [v, v + ahead] so
    int hi = (v + ahead) / kSlab;
    hi = hi < last_slab ? hi : last_slab;
    rg.need(v / kSlab, hi, true);
    ready_end = rg.ready > last_slab ? INT32_MAX : (int)rg.ready * kSlab;
  };
  auto at = [&](int v) -> unsigned { return buf[v & kMask]; };
  int k = c.sub_min, s = 0, cnt_opp = 0;
  int cut_b = c.mx < n ? c.mx : n;
  while (s < n) {
    // the window at sk
    int sk = k < lim ? k : lim;
    if (sk + a + ahead >= ready_end) resident(sk + a);
    unsigned long long win = 0;
#pragma unroll
    for (int j = 0; j < kSeqReg; ++j)
      win |= (unsigned long long)at(sk + a + j) << (8 * j);
    unsigned nxt = at(sk + a + kSeqReg);
    const int cut_k = cut_b - (L - 1);
    bool hit_cut, is_cand, trig;
    for (;;) {
      hit_cut = k >= cut_k;
      bool run = true;
      if (kShort) {
#pragma unroll
        for (int j = 0; j < kSeqReg - 1; ++j) {
          const unsigned p = (unsigned)(win >> (8 * j)) & 0xFF;
          const unsigned q = (unsigned)(win >> (8 * j + 8)) & 0xFF;
          run &= (j >= L - 1) | (kInc ? q > p : q < p);
        }
      } else {
        for (int j = 0; j < L - 1 && run; ++j) {
          const unsigned p = at(sk + a + j), q = at(sk + a + j + 1);
          run = kInc ? q > p : q < p;
        }
      }
      const unsigned b0 = (unsigned)win & 0xFF;
      const unsigned b1 = (unsigned)(win >> 8) & 0xFF;
      is_cand = !hit_cut && run;
      const bool is_opp =
          !hit_cut && !is_cand && (kInc ? b1 < b0 : b1 > b0);
      trig = is_opp && cnt_opp >= c.T;  // the skip trigger
      if (hit_cut || is_cand || trig) break;
      cnt_opp += is_opp;
      if (++k > lim) break;  // the window stays at lim: reload
      win = (win >> 8) | ((unsigned long long)nxt << (8 * kSeqReg - 8));
      sk = k;
      if (k + a + ahead >= ready_end) resident(k + a);
      nxt = at(k + a + kSeqReg);
    }
    if (hit_cut || is_cand) {
      const int bound = hit_cut ? cut_b : k + L;
      o.emit(bound);
      s = bound;
      k = bound + c.sub_min;
      cnt_opp = 0;
      cut_b = s + c.mx < n ? s + c.mx : n;
    } else if (trig) {
      k += c.skip;
      cnt_opp = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
native_scan_kernel(const uint8_t* __restrict__ x,
                   const uint32_t* __restrict__ tables,
                   int32_t* __restrict__ bounds, int32_t* __restrict__ counts,
                   int algo, Cfg c) {
  __shared__ uint32_t t[3 * 256];
  __shared__ __align__(128) uint8_t buf[Ring::kBytes];
  __shared__ __align__(8) uint64_t full[Ring::kSlabs], empty[Ring::kSlabs];
  const int tid = threadIdx.x;
  const long long r = blockIdx.x;
  const uint8_t* row = x + r * c.n;
  const int a = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const long long vlen = c.n > 0 ? c.n + a : 0;
  Ring rg{buf, full, empty};
  for (int i = tid; i < 3 * 256; i += kThreads) t[i] = tables[i];
  if (tid == 0) rg.init();
  __syncthreads();
  if (tid == 32) rg.produce(row - a, vlen);
  if (tid != 0) return;
  Out o{bounds + r * c.mc, c.mc};
  switch (algo) {
    case kGear: scan_bytes<kGear>(rg, buf, a, t, c, o); break;
    case kCrc: scan_bytes<kCrc>(rg, buf, a, t, c, o); break;
    case kRabin: scan_bytes<kRabin>(rg, buf, a, t, c, o); break;
    case kFastCdc: scan_bytes<kFastCdc>(rg, buf, a, t, c, o); break;
    case kAe: scan_bytes<kAe>(rg, buf, a, t, c, o); break;
    case kRam: scan_bytes<kRam>(rg, buf, a, t, c, o); break;
    default:
      if (c.L <= kSeqReg) {
        if (c.inc) scan_seqcdc<true, true>(rg, buf, a, c, o);
        else scan_seqcdc<false, true>(rg, buf, a, c, o);
      } else {
        if (c.inc) scan_seqcdc<true, false>(rg, buf, a, c, o);
        else scan_seqcdc<false, false>(rg, buf, a, c, o);
      }
      break;
  }
  counts[r] = o.cnt;
  const long long nslabs = Ring::slabs(vlen);
  rg.need(nslabs, nslabs - 1, true);  // every copy has landed
}

}  // namespace

extern "C" int native_scan_launch(const void* x, const void* tables,
                                  void* bounds, void* counts, int B,
                                  long long n, int mc, int algo, int mn,
                                  int mx, unsigned mask, unsigned mask_l,
                                  int avg, int window, int L, int T, int skip,
                                  int sub_min, int inc, void* stream) {
  const bool remove = algo == kCrc || algo == kRabin;
  if (algo < 0 || algo >= kAlgos || mc < 1 || n >= (1LL << 30) ||
      (remove && (window < 0 || window > kWinMax)) ||
      (algo == kSeqCdc && (L < 2 || n < L)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Cfg c{n, mc, mn, mx, mask, mask_l, avg, window, L, T, skip, sub_min,
              inc};
  if (B > 0) {
    native_scan_kernel<<<B, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint32_t*>(tables),
        static_cast<int32_t*>(bounds), static_cast<int32_t*>(counts), algo,
        c);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* native_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
