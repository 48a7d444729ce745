// Per-position Gear rolling hash of a uint8 stream on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gear_hash.py:gear_hash_pallas (body
// _gear_kernel).  For every position i of an (n,) stream:
//   h[i] = sum over j <= min(i, 31) of G[b[i - j]] << j     (mod 2^32)
// with G the 256-entry uint32 Gear table: the sequential recurrence
// h[i] = (h[i-1] << 1) + G[b[i]] in closed window form (the 32-bit register
// forgets terms older than 32 bytes).  Positions 0-30 take only the terms
// that exist; the TPU kernel fixes those up in its wrapper, here each tile
// gets them right in place.
//
// Bound on this card: memory.  n bytes in and 4n bytes out; the hash is a
// table lookup, a shift and an add per byte and window step, far below the
// card's integer rate.  Least time: 5n / 3.35 TB/s.
//
// Design: the table (1 KiB) goes to shared memory.  A block of 256 threads
// owns a tile of 4096 positions and stages the tile's bytes plus a 31-byte
// left halo in shared memory with coalesced loads.  Each thread owns 16
// consecutive positions and runs the recurrence itself, starting 31
// positions early (or at 0): after 31 warm-up steps the register holds
// exactly the window sum, so a thread does 47 lookup-shift-adds for 16
// outputs instead of the 32 x 16 of the window form.  It writes its 16
// outputs as four 16-byte stores.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;  // positions a thread
constexpr int kTile = kThreads * kPer;
constexpr int kHalo = 31;

__global__ void __launch_bounds__(kThreads)
gear_hash_kernel(const uint8_t* __restrict__ x,
                 const uint32_t* __restrict__ table,
                 uint32_t* __restrict__ out, long long n) {
  __shared__ uint32_t st[256];
  __shared__ uint8_t sx[kHalo + kTile];
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kTile;
  st[tid] = table[tid];
  for (int i = tid; i < kHalo + kTile; i += kThreads) {
    const long long pos = t0 - kHalo + i;
    sx[i] = (pos >= 0 && pos < n) ? x[pos] : 0;
  }
  __syncthreads();
  const long long p0 = t0 + (long long)tid * kPer;  // first output position
  if (p0 >= n) return;
  // warm up over the 31 predecessors that exist
  const int warm = p0 < kHalo ? (int)p0 : kHalo;
  const int base = tid * kPer + kHalo;  // sx index of p0
  uint32_t h = 0;
  for (int j = base - warm; j < base; ++j) h = (h << 1) + st[sx[j]];
  uint32_t v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    h = (h << 1) + st[sx[base + q]];
    v[q] = h;
  }
  if (p0 + kPer <= n) {
    uint4* o = reinterpret_cast<uint4*>(out + p0);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q)
      o[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
    for (int q = 0; q < kPer && p0 + q < n; ++q) out[p0 + q] = v[q];
  }
}

}  // namespace

extern "C" int gear_hash_launch(const void* x, const void* table, void* out,
                                long long n, void* stream) {
  const long long grid = (n + kTile - 1) / kTile;
  if (grid > 0) {
    gear_hash_kernel<<<(unsigned)grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint32_t*>(table),
        static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gear_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
