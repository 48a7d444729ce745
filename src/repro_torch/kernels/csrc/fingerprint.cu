// Per-chunk 62-bit fingerprints for a (B, S) uint8 batch on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fingerprint.py:fingerprint_pallas
// (body _fp_kernel).  For chunk slot j of row b, with exclusive end
// e = bounds[b, j] and start s = bounds[b, j-1] (0 for j = 0):
//   fp[b, j, g] = sum_{s <= i < e} x[b, i] * r_g^min(e-1-i, 65535)  mod p,
//   p = 2^31 - 1, (r_0, r_1) = (R1, R2);   len[b, j] = e - s;
// slots j >= counts[b] are zero.  The last slot of the table also takes the
// bytes past its end with weight r^0, as the reference's clamped chunk id
// does when max_chunks undercounts (never on the service's path).
//
// Bound on this card: memory.  The function needs each byte once (B * S
// bytes), each slot's bound (4 bytes in) and its fingerprint and length
// (12 bytes out), and each row's count (4 bytes in): 16 bytes a slot.  The
// power table is this design's choice, not the function's (a Horner-form
// hash reads none); its 512 KiB stay resident in the 50 MB L2.  Two 64-bit
// multiply-adds per byte are far below the integer rate, so the least time
// is (B * S + 16 * B * mc + 4 * B) / 3.35 TB/s.
//
// Design: one warp per chunk slot, B * mc warps in all, so a batch of a few
// rows still spreads over every SM.  The warp hashes its chunk with
// modp.cuh's add_range (lanes striding the bytes and the r^e table, exact
// 64-bit sums) and warp_sum_mod: no per-byte gather of chunk ids, no
// scatter.
#include <cstdint>
#include <cuda_runtime.h>

#include "modp.cuh"

namespace {

using modp::add_range;
using modp::warp_sum_mod;

__global__ void fingerprint_kernel(const uint8_t* __restrict__ x,
                                   const int32_t* __restrict__ bounds,
                                   const int32_t* __restrict__ counts,
                                   const int32_t* __restrict__ pw,
                                   uint32_t* __restrict__ fps,
                                   int32_t* __restrict__ lens,
                                   int B, long long S, int mc) {
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * mc) return;
  const long long b = warp / mc;
  const int j = (int)(warp - b * mc);
  const long long slot = b * mc + j;
  if (j >= counts[b]) {
    if (lane == 0) {
      fps[2 * slot] = 0;
      fps[2 * slot + 1] = 0;
      lens[slot] = 0;
    }
    return;
  }
  const int32_t e32 = bounds[slot];
  const int32_t s32 = j > 0 ? bounds[slot - 1] : 0;
  const long long e = e32, s = s32 < 0 ? 0 : s32;
  const long long stop = e < S ? e : S;
  const uint8_t* row = x + b * S;
  unsigned long long a1 = 0, a2 = 0;
  add_range<1>(row, s, stop, e, pw, lane, a1, a2);
  if (j == mc - 1) {  // bytes past the table's last bound: weight r^0
    const long long from = e > s ? e : s;
    for (long long i = from + lane; i < S; i += 32) a1 += row[i], a2 += row[i];
  }
  a1 = warp_sum_mod(a1);
  a2 = warp_sum_mod(a2);
  if (lane == 0) {
    fps[2 * slot] = (uint32_t)a1;
    fps[2 * slot + 1] = (uint32_t)a2;
    lens[slot] = e32 - s32;
  }
}

}  // namespace

extern "C" int fingerprint_launch(const void* x, const void* bounds,
                                  const void* counts, const void* pw,
                                  void* fps, void* lens, int B, long long S,
                                  int mc, void* stream) {
  const long long warps = (long long)B * mc;
  const int block = 128;
  const long long grid = (warps * 32 + block - 1) / block;
  if (grid > 0) {
    fingerprint_kernel<<<(unsigned)grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int32_t*>(bounds),
        static_cast<const int32_t*>(counts), static_cast<const int32_t*>(pw),
        static_cast<uint32_t*>(fps), static_cast<int32_t*>(lens), B, S, mc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fingerprint_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
