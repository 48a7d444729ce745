// Per-position Gear rolling hash of a uint8 stream on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gear_hash.py:gear_hash_pallas (body
// _gear_kernel).  For every position i of an (n,) stream:
//   h[i] = sum over j <= min(i, 31) of G[b[i - j]] << j     (mod 2^32)
// with G the 256-entry uint32 Gear table: the sequential recurrence
// h[i] = (h[i-1] << 1) + G[b[i]] in closed window form (the 32-bit register
// forgets terms older than 32 bytes).  Positions 0-30 take only the terms
// that exist; the TPU kernel fixes those up in its wrapper, here the
// stream's first block starts from a zero carry.
//
// Bound on this card: memory.  n bytes in and 4n bytes out; the hash is a
// table lookup, a shift and an add per byte, far below the card's integer
// rate.  Least time: 5n / 3.35 TB/s.
//
// Design: one table lookup per output, every load and store contiguous
// across the warp.
// - A warp hashes blocks of 128 positions, lane l positions 4l .. 4l+3:
//   one 4-byte load (a warp's 128 contiguous bytes) and one 16-byte store
//   (512 contiguous bytes).  A misaligned stream (a view such as x[3:])
//   loads the aligned words around its bytes and funnel-shifts each with
//   the next lane's word.  Blocks that touch the stream's ends load byte by
//   byte, nothing past n.
// - No warm-up: each lane runs the recurrence from zero over its 4 bytes
//   (local[q], and s = local[3] for 4 positions), and the carry comes from
//   the lanes to its left by a shuffle scan over (s, 4 positions) pairs,
//   combined as s_left << 4d + s_right: three steps (d = 1, 2, 4), since
//   terms 32 positions back shift out.  Lane l then adds the block's
//   carry-in C (the hash at the position before the block) shifted by
//   4(l + 1), clamped past 32, and each of its outputs is
//   (h[p0 - 1] << (q + 1)) + local[q].
// - The next block's carry-in is lane 31's scanned value: it covers the
//   32 positions before the next block, so C itself shifts out and the
//   blocks of a step are independent.  Each warp owns a contiguous span
//   and walks it kUnroll blocks a step, all loads of a step in flight
//   together; only its first block needs the 128 positions before the span
//   hashed once for its carry.
// - The table (1 KiB) lies in shared memory.  A warp's 32 random lookups
//   meet on some banks; one copy of the table a lane (32 KiB, every lookup
//   on its own bank) measured no faster at 64 MiB on an H100: the kernel
//   waits on memory, not on banks.
// - Persistent CTAs: as many as are resident on the card at once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlock = 128;  // positions a warp's block, 4 a lane
constexpr int kUnroll = 8;   // blocks a warp's step
constexpr int kStep = kBlock * kUnroll;

// The 4 bytes from position p (zero past n), byte q in bits 8q..8q+7.
__device__ __forceinline__ uint32_t bytes_at(const uint8_t* x, long long p,
                                             long long n) {
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (p + q < n) v |= (uint32_t)x[p + q] << (8 * q);
  return v;
}

// Lane l's bytes of the kUnroll blocks from position p (a multiple of 4):
// aligned 4-byte loads where the step lies inside the stream, with a
// misalignment a (x & 3) funnel-shifted from the next lane's word; byte
// loads otherwise.
__device__ __forceinline__ void load_step(const uint8_t* x, int a,
                                          long long p, long long n,
                                          int lane, uint32_t (&v)[kUnroll]) {
  const bool inside = a == 0 ? p + kStep <= n : p > 0 && p + kStep + 4 <= n;
  if (inside) {
    const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x - a);
    const long long w = (p >> 2) + lane;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = x32[w + 32 * u];
    if (a != 0) {
      const int sh = 8 * a;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        uint32_t hi = __shfl_down_sync(kFull, v[u], 1);
        if (lane == 31) hi = x32[w + 32 * u + 1];
        v[u] = __funnelshift_r(v[u], hi, sh);
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = bytes_at(x, p + kBlock * u + 4 * lane, n);
  }
}

// One block's hashes: local[q] from this lane's bytes alone, and s, the
// hash at the lane's last position over the block's bytes (the shuffle
// scan: lanes l-7 .. l).
__device__ __forceinline__ uint32_t local_scan(const uint32_t* st, uint32_t v,
                                               int lane, uint32_t (&loc)[4]) {
  uint32_t h = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    h = (h << 1) + st[(v >> (8 * q)) & 255u];
    loc[q] = h;
  }
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, h, d);
    if (lane >= d) h += t << (4 * d);
  }
  return h;
}

__global__ void __launch_bounds__(kThreads)
gear_hash_kernel(const uint8_t* __restrict__ x,
                 const uint32_t* __restrict__ table,
                 uint32_t* __restrict__ out, long long n, long long span) {
  __shared__ uint32_t st[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) st[i] = table[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
  const long long p_begin = warp * span;
  if (p_begin >= n) return;
  const long long p_end = p_begin + span < n ? p_begin + span : n;
  const int a = (int)(reinterpret_cast<uintptr_t>(x) & 3);
  uint32_t loc[4];
  uint32_t carry = 0;  // the hash at the position before the next block
  if (p_begin > 0) {   // the 128 positions before the span
    carry = local_scan(
        st, bytes_at(x, p_begin - kBlock + 4 * lane, n), lane, loc);
    carry = __shfl_sync(kFull, carry, 31);
  }
  for (long long p = p_begin; p < p_end; p += kStep) {
    uint32_t v[kUnroll];
    load_step(x, a, p, n, lane, v);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p0 = p + kBlock * u + 4 * lane;
      const uint32_t s = local_scan(st, v[u], lane, loc);
      const uint32_t full = s + (lane < 7 ? carry << (4 * lane + 4) : 0u);
      uint32_t prev = __shfl_up_sync(kFull, full, 1);
      if (lane == 0) prev = carry;
      carry = __shfl_sync(kFull, s, 31);
      uint32_t h[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) h[q] = (prev << (q + 1)) + loc[q];
      if (p0 + 4 <= p_end) {
        *reinterpret_cast<uint4*>(out + p0) = make_uint4(h[0], h[1], h[2],
                                                         h[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (p0 + q < p_end) out[p0 + q] = h[q];
      }
    }
  }
}

}  // namespace

extern "C" int gear_hash_launch(const void* x, const void* table, void* out,
                                long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gear_hash_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // spans of whole steps, as many warps as are resident at once
  const long long steps = (n + kStep - 1) / kStep;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  long long grid = (steps + kWarps - 1) / kWarps;
  if (grid > resident) grid = resident;
  const long long span =
      (steps + grid * kWarps - 1) / (grid * kWarps) * kStep;
  gear_hash_kernel<<<(unsigned)grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint32_t*>(table),
      static_cast<uint32_t*>(out), n, span);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gear_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
