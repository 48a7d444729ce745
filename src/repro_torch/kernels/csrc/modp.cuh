// Exact mod-(2^31 - 1) chunk hashing, shared by fingerprint.cu,
// fused_pipeline.cu and packed_pipeline.cu.
//
// The chunk [s, e) of a row hashes to sum_i x[i] * r^min(e-1-i, 65535)
// mod p for each generator r.  Both generators' power tables lie back to
// back in `pw` (r1^k, then r2^k, kMaxChunk entries each: the reference's
// _pow_table_np).  Every entry is below 2^31, so a byte times an entry is
// below 2^39 and a lane can add 2^24 such products in 64 bits before it
// must fold; lanes fold their sums mod p and a shuffle reduction adds the
// 32 residues.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace modp {

constexpr unsigned long long kP = (1ull << 31) - 1;
constexpr long long kMaxChunk = 1 << 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long warp_sum_mod(
    unsigned long long v) {
  v %= kP;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v % kP;  // 32 residues < 2^31 sum below 2^36
}

__device__ __forceinline__ void add_byte(const uint8_t* row, long long i,
                                         long long e, const int32_t* pw,
                                         unsigned long long& a1,
                                         unsigned long long& a2) {
  long long ex = e - 1 - i;
  if (ex > kMaxChunk - 1) ex = kMaxChunk - 1;
  const unsigned long long v = row[i];
  a1 += v * (unsigned)pw[ex];
  a2 += v * (unsigned)pw[kMaxChunk + ex];
}

// Adds row[i] * r_g^min(e-1-i, kMaxChunk-1) for s <= i < stop into this
// lane's (a1, a2).  The warp's lanes stride the range 32 consecutive bytes
// and table words at a time (both coalesced); every 2^20 steps (at most
// 2^22 products) the sums are folded mod p.  kStrides = 4 takes four
// strides a step with no bound test inside a step, then single strides for
// the rest: the fused kernel, with 8 warps on an SM, needs a step's loads
// in flight together.  kStrides = 1 is a plain stride loop that the
// compiler unrolls itself: the fingerprint kernel, with its SMs full of
// warps, measured slower with any hand-unrolled form.
template <int kStrides>
__device__ __forceinline__ void add_range(const uint8_t* row, long long s,
                                          long long stop, long long e,
                                          const int32_t* pw, int lane,
                                          unsigned long long& a1,
                                          unsigned long long& a2) {
  static_assert(kStrides == 1 || kStrides == 4, "see above");
  int steps = 0;
  if constexpr (kStrides == 1) {
    for (long long i = s + lane; i < stop; i += 32) {
      add_byte(row, i, e, pw, a1, a2);
      if (++steps == (1 << 20)) {
        a1 %= kP;
        a2 %= kP;
        steps = 0;
      }
    }
  } else {
    long long i = s + lane;
    for (; i + 3 * 32 < stop; i += 4 * 32) {
#pragma unroll
      for (int u = 0; u < 4; ++u) add_byte(row, i + 32 * u, e, pw, a1, a2);
      if (++steps == (1 << 20)) {
        a1 %= kP;
        a2 %= kP;
        steps = 0;
      }
    }
    for (; i < stop; i += 32) add_byte(row, i, e, pw, a1, a2);
  }
}

// Slot `slot` (= b * mc + j) of a (B, mc) chunk table over a (B, n)
// batch, hashed by kParts warps: chunk j of row b spans [bounds[j-1] (0 for
// j = 0), bounds[j]) and warp `part` adds its part-th kParts-th of it.  The
// kept chunks' two hashes go to fps, zeros past them (counts[b] counts
// every emit, the table keeps mc of them).  With kParts > 1 the parts are
// the warps of one CTA, which calls this with all its threads for one
// slot, and they meet in shared memory.  The rows are L2-resident from the
// scan that wrote the bounds.
template <int kStrides, int kParts>
__device__ __forceinline__ void hash_slot(const uint8_t* x,
                                          const int32_t* bounds,
                                          const int32_t* counts,
                                          const int32_t* pw, uint32_t* fps,
                                          int B, long long n, int mc,
                                          long long slot, int part,
                                          int lane) {
  if (slot >= (long long)B * mc) return;
  const long long b = slot / mc;
  const int j = (int)(slot - b * mc);
  if (j >= counts[b]) {
    if (part == 0 && lane == 0) {
      fps[2 * slot] = 0;
      fps[2 * slot + 1] = 0;
    }
    return;
  }
  const long long e = bounds[slot], s = j > 0 ? bounds[slot - 1] : 0;
  unsigned long long a1 = 0, a2 = 0;
  add_range<kStrides>(x + b * n, s + (e - s) * part / kParts,
                      s + (e - s) * (part + 1) / kParts, e, pw, lane, a1,
                      a2);
  a1 = warp_sum_mod(a1);
  a2 = warp_sum_mod(a2);
  if constexpr (kParts > 1) {
    __shared__ unsigned long long sum[kParts][2];
    if (lane == 0) {
      sum[part][0] = a1;
      sum[part][1] = a2;
    }
    __syncthreads();
    a1 = a2 = 0;
#pragma unroll
    for (int k = 0; k < kParts; ++k) {  // kParts residues below 2^31 each
      a1 += sum[k][0];
      a2 += sum[k][1];
    }
    a1 %= kP;
    a2 %= kP;
  }
  if (part == 0 && lane == 0) {
    fps[2 * slot] = (uint32_t)a1;
    fps[2 * slot + 1] = (uint32_t)a2;
  }
}

}  // namespace modp
