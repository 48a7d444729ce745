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
// power tables are this design's choice, not the function's (a Horner-form
// hash reads none); they stay resident in the 50 MB L2.  The arithmetic,
// about two byte products a byte, is far below the integer rate, so the
// least time is (B * S + 16 * B * mc + 4 * B) / 3.35 TB/s.
//
// Design: the TPU kernel's refactor (a fixed weight vector and a factor
// table) at the size of one thread's four 16-byte loads.  One CTA of 4
// warps per chunk slot; a slot past its row's count writes its zeros and
// exits.  The chunk is cut into 64-byte pieces aligned in memory;
// a piece [q, q + 64) below the clamp, d = e - q - 64 its last byte's
// exponent, contributes
//   (sum_u b_u * r^(63-u)) * r^(64 (d >> 6)) * r^(d mod 64)  mod p.
// The inner sum takes its 64 constant weights one byte at a time
// (kPieceB: w = sum_k 256^k w_k, four dp4a a word of data, the four partial
// sums shifted together once a piece); r^(64 (d >> 6)) comes from pw64
// (every 64th power: consecutive pieces read consecutive words) and
// r^(d mod 64), the same for every piece of the chunk, multiplies the
// thread's sum once.  A piece wholly past the clamp weighs its byte sum by
// r^65535.  The ragged ends (under 64 bytes each, one thread a byte, loads
// issued with the pieces'), the piece that straddles the clamp and the
// last slot's bytes past its end take the per-byte path (modp.cuh's
// add_byte).  The warps' sums meet in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "modp.cuh"

namespace {

using modp::add_byte;
using modp::kMaxChunk;
using modp::kP;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPiece = 64;  // bytes a piece: four 16-byte loads
constexpr long long kPw64 = kMaxChunk / kPiece;  // pw64 entries a generator

// Byte k of r_g^(63-q) mod p, q = 4 wd + i, in byte i of word
// kPieceB[g][k][wd] (g 0: R1, 1: R2); held against the reference's power
// table by tests/test_torch_fingerprint.py.
__constant__ uint32_t kPieceB[2][4][16] = {
    {{0x7a0508feu, 0xd07a440cu, 0x47abf892u, 0x26c2c64du,
      0xc4f23cb6u, 0xdc00352eu, 0x359b3e94u, 0xc56d3996u,
      0xf43ab1e7u, 0x89cecebfu, 0x078103eeu, 0xda8f039du,
      0xf5bfbdacu, 0x8bceff23u, 0x46aa9859u, 0x016d4a21u},
     {0xa5512370u, 0x301151d6u, 0x1511bf6du, 0xf87ab3b5u,
      0x29fcb555u, 0xcdce7004u, 0xe52184abu, 0xe98e1c94u,
      0x92fe9cfau, 0x3bba308bu, 0x1d87bf66u, 0xe1560c79u,
      0x43eeb405u, 0xbdfc0fe4u, 0xdd73e07au, 0x004e354fu},
     {0x66ccea85u, 0xd6f95b95u, 0xc4dceb6eu, 0x00fb0e90u,
      0xb9430f7fu, 0x4981b59au, 0x34b80a53u, 0x1474b62bu,
      0x6bf037b0u, 0x1f1cfafdu, 0xdc52196fu, 0xa64cbe80u,
      0x0d255cfdu, 0xa8e9fa52u, 0x1188b489u, 0x00c66f6eu},
     {0x50212441u, 0x072d0c3au, 0x72521439u, 0x05021a71u,
      0x11112f53u, 0x04663a23u, 0x37772a36u, 0x4277725cu,
      0x433a7f7fu, 0x53681353u, 0x1d111d4au, 0x4708101eu,
      0x5c304e0bu, 0x6a6e126du, 0x60740c59u, 0x0041645au}},
    {{0x5fc0a787u, 0xdbbd421fu, 0x49e12652u, 0x2491cde7u,
      0x5a39b298u, 0xe82295deu, 0x8567b8abu, 0xed71425du,
      0x84875edcu, 0xa30776c7u, 0x6a627eb0u, 0x89df3df3u,
      0xb4164953u, 0xa747bb70u, 0x87235a64u, 0x01b5df3eu},
     {0x26b140c5u, 0xf106f900u, 0x5388f5d5u, 0xa0221772u,
      0xcf8ab62bu, 0x9613cbb8u, 0x21e96e39u, 0xd2fed98bu,
      0x82e10c07u, 0x62a33aeeu, 0xb839f72au, 0x13ff55e5u,
      0x237ae057u, 0x35e4a546u, 0xc2116aeeu, 0x00771f27u},
     {0x145cfa44u, 0x5557c1c6u, 0xf0e76dd0u, 0xad7cca2au,
      0xcc2aa9aau, 0xce13e90au, 0x920eafe7u, 0x00bde83du,
      0xec74c0ecu, 0x1d075fc2u, 0x01dc5a7fu, 0x0533d9a2u,
      0x6aec27bau, 0x46a84a71u, 0x175b7270u, 0x0092f35bu},
     {0x48230203u, 0x0923505fu, 0x154c5763u, 0x66764530u,
      0x2f4a707cu, 0x124b4d16u, 0x34257f44u, 0x56551637u,
      0x14626644u, 0x1b230b71u, 0x4c08374du, 0x743c1279u,
      0x7a5a3e06u, 0x75037e52u, 0x34172a60u, 0x002c0911u}}};

// A value below 2^63 reduced to one below 2^33, congruent mod p.
__device__ __forceinline__ unsigned long long fold(unsigned long long v) {
  return (v & kP) + (v >> 31);
}

// (sum_u b_u r_g^(63-u)) over a piece's 64 bytes for both generators, each
// below 2^45: per weight byte k a dp4a sum below 2^22.
__device__ __forceinline__ void piece_sums(const uint4 (&v)[4],
                                           unsigned long long& s1,
                                           unsigned long long& s2) {
  uint32_t c1[4] = {0, 0, 0, 0}, c2[4] = {0, 0, 0, 0};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c1[k] = __dp4a(w[i], kPieceB[0][k][4 * u + i], c1[k]);
        c2[k] = __dp4a(w[i], kPieceB[1][k][4 * u + i], c2[k]);
      }
    }
  }
  s1 = c1[0] + ((unsigned long long)c1[1] << 8) +
       ((unsigned long long)c1[2] << 16) + ((unsigned long long)c1[3] << 24);
  s2 = c2[0] + ((unsigned long long)c2[1] << 8) +
       ((unsigned long long)c2[2] << 16) + ((unsigned long long)c2[3] << 24);
}

// The CTA's sums (a1, a2) mod p (exact), in thread 0.  It folds where
// modp.cuh's warp_sum_mod takes a 64-bit %, fewer instructions a slot.
__device__ __forceinline__ void cta_sum_mod(unsigned long long& a1,
                                            unsigned long long& a2) {
  __shared__ unsigned long long part[kWarps][2];
  a1 = fold(fold(a1));  // below 2^31 + 2^2
  a2 = fold(fold(a2));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
    a2 += __shfl_xor_sync(0xffffffffu, a2, o);
  }
  if ((threadIdx.x & 31) == 0) {
    part[threadIdx.x >> 5][0] = a1;
    part[threadIdx.x >> 5][1] = a2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a1 = a2 = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {  // below 2^39
      a1 += part[k][0];
      a2 += part[k][1];
    }
    a1 = fold(fold(a1));  // below 2^31 + 1: one subtraction leaves [0, p)
    a2 = fold(fold(a2));
    a1 = a1 >= kP ? a1 - kP : a1;
    a2 = a2 >= kP ? a2 - kP : a2;
  }
}

__global__ void __launch_bounds__(kThreads)
    fingerprint_kernel(const uint8_t* __restrict__ x,
                       const int32_t* __restrict__ bounds,
                       const int32_t* __restrict__ counts,
                       const int32_t* __restrict__ pw,
                       const int32_t* __restrict__ pw64,
                       uint32_t* __restrict__ fps, int32_t* __restrict__ lens,
                       long long S, int mc) {
  const int tid = threadIdx.x;
  const long long slot = blockIdx.x;
  const long long b = slot / mc;
  const int j = (int)(slot - b * mc);
  const int count = counts[b];
  const int32_t e32 = bounds[slot];
  const int32_t s32 = j > 0 ? bounds[slot - 1] : 0;
  if (j >= count) {
    if (tid == 0) {
      fps[2 * slot] = 0;
      fps[2 * slot + 1] = 0;
      lens[slot] = 0;
    }
    return;
  }
  const long long e = e32, s = s32 < 0 ? 0 : s32;
  const long long stop = e < S ? e : S;
  const uint8_t* row = x + b * S;
  // pieces [i0, i1) between the first and last 64-byte boundaries in memory
  // inside [s, stop); the head [s, i0) and tail [i1, stop) are under 64
  // bytes each (both empty when stop <= s)
  const uintptr_t at = reinterpret_cast<uintptr_t>(row);
  const long long lo = s + ((kPiece - ((at + s) & (kPiece - 1))) &
                            (kPiece - 1));
  const long long hi = stop - ((at + stop) & (kPiece - 1));
  const long long i0 = lo < stop ? lo : stop;
  const long long i1 = hi > i0 ? hi : i0;
  // every load is issued before any sum waits on one: a byte of the ends
  // (threads 0-63 the head, 64-127 the tail) with its two table words ...
  const long long ib = tid < kPiece ? s + tid : i1 + tid - kPiece;
  const bool end_byte = tid < kPiece ? ib < i0 : ib < stop;
  uint32_t eb = 0, ew1 = 0, ew2 = 0;
  if (end_byte) {
    long long ex = e - 1 - ib;
    if (ex > kMaxChunk - 1) ex = kMaxChunk - 1;
    eb = row[ib];
    ew1 = (uint32_t)pw[ex];
    ew2 = (uint32_t)pw[kMaxChunk + ex];
  }
  // ... and the pieces, one a thread a round
  const long long pieces = (i1 - i0) / kPiece;
  unsigned long long a1 = 0, a2 = 0, p1 = 0, p2 = 0;
  for (long long k = tid; k < pieces; k += kThreads) {
    const long long q0 = i0 + kPiece * k;
    const long long d = e - q0 - kPiece;  // the piece's last byte's exponent
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = __ldg(reinterpret_cast<const uint4*>(row + q0) + u);
    if (d + kPiece - 1 < kMaxChunk) {
      const uint32_t f1 = (uint32_t)pw64[d / kPiece];
      const uint32_t f2 = (uint32_t)pw64[kPw64 + d / kPiece];
      unsigned long long s1, s2;
      piece_sums(v, s1, s2);
      p1 += fold(fold(s1) * f1);
      p2 += fold(fold(s2) * f2);
    } else if (d >= kMaxChunk - 1) {  // every byte at the clamped weight
      uint32_t sum = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sum = __dp4a(v[u].x, 0x01010101u, sum);
        sum = __dp4a(v[u].y, 0x01010101u, sum);
        sum = __dp4a(v[u].z, 0x01010101u, sum);
        sum = __dp4a(v[u].w, 0x01010101u, sum);
      }
      a1 += (unsigned long long)sum * (uint32_t)pw[kMaxChunk - 1];
      a2 += (unsigned long long)sum * (uint32_t)pw[2 * kMaxChunk - 1];
    } else {  // the piece that straddles the clamp
      for (int q = 0; q < kPiece; ++q) add_byte(row, q0 + q, e, pw, a1, a2);
    }
  }
  const long long r = (e - i0) & (kPiece - 1);  // every piece's d mod 64
  a1 += fold(fold(p1) * (uint32_t)pw[r]) + (unsigned long long)eb * ew1;
  a2 += fold(fold(p2) * (uint32_t)pw[kMaxChunk + r]) +
        (unsigned long long)eb * ew2;
  if (j == mc - 1) {  // bytes past the table's last bound: weight r^0
    const long long from = e > s ? e : s;
    for (long long i = from + tid; i < S; i += kThreads)
      a1 += row[i], a2 += row[i];
  }
  cta_sum_mod(a1, a2);
  if (tid == 0) {
    fps[2 * slot] = (uint32_t)a1;
    fps[2 * slot + 1] = (uint32_t)a2;
    lens[slot] = e32 - s32;
  }
}

}  // namespace

extern "C" int fingerprint_launch(const void* x, const void* bounds,
                                  const void* counts, const void* pw,
                                  const void* pw64, void* fps, void* lens,
                                  int B, long long S, int mc, void* stream) {
  const long long slots = (long long)B * mc;
  if (slots > 0) {
    fingerprint_kernel<<<(unsigned)slots, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int32_t*>(bounds),
        static_cast<const int32_t*>(counts), static_cast<const int32_t*>(pw),
        static_cast<const int32_t*>(pw64), static_cast<uint32_t*>(fps),
        static_cast<int32_t*>(lens), S, mc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fingerprint_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
