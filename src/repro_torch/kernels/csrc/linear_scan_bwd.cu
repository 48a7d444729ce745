// The backward of the diagonal linear recurrence h_t = a_t * h_{t-1} + b_t
// on Hopper (sm_90a), float32: the RG-LRU's scan under a gradient.
//
// Replaces the reference's autodiff of the lax.associative_scan in
// repro/models/rglru.py:rglru_scan (jax.grad through it; not a Pallas
// kernel).  For a, the saved outputs h (B,T,N), h0 (B,N) and the upstream
// gradients g (B,T,N) of h and g_last (B,N) of h_{T-1}, all float32 and
// contiguous, the gradient dh_t of every h_t is the same recurrence run from
// the end:
//   dh_{T-1} = g_{T-1} + g_last,  dh_t = g_t + a_{t+1} dh_{t+1},
// and it writes db_t = dh_t, da_t = dh_t h_{t-1} (h0 before the first) and
// dh0 = a_0 dh_0.
//
// Bound on this card: bytes.  Each element reads a, g and h and writes da
// and db: 20 bytes against 3 operations.  At the RG-LRU's width (N =
// lru_width = 2560) a microbatch row of 4,096 tokens is 210 MB, 0.063 ms at
// 3.35 TB/s.
//
// Design: linear_scan.cu's single pass over the reversed steps.  Reverse
// step s is t = T - 1 - s; its map is x -> A_s x + G_s with A_s = a_{t+1}
// (1 at s = 0) and G_s = g_t, from the initial state g_last, so the
// forward's tiles, sub-chunk scans in registers, in-tile composition and
// decoupled look-back (the note in linear_scan.cu) carry over unchanged,
// and so does its determinism: every prefix is folded forward from the
// nearest published one in the order a chain of prefixes would, so the
// bits do not depend on timing.  A thread loads its 16 steps of a (shifted
// by one), g and the saved h_{t-1} at once, and writes db and da from its
// registers once its sub-chunk's incoming state is known.  The scratch is
// the forward's (one a stream, tags by generation): launches on a stream
// are ordered, so the two kernels share it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // channels a tile
constexpr int kWarps = 8;   // sub-chunks a tile
constexpr int kSteps = 16;  // steps a sub-chunk: a thread's registers
constexpr int kTile = kWarps * kSteps;
constexpr unsigned kGenerations = 1u << 30;  // tags: gen * 4 + kind
constexpr unsigned kAggregate = 1, kPrefix = 2;

__device__ __forceinline__ void publish(unsigned long long* p, unsigned gen,
                                        unsigned kind, float v) {
  const unsigned long long w =
      (static_cast<unsigned long long>(gen * 4 + kind) << 32) |
      __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}

// the word at p once this launch (generation gen) has published it
__device__ __forceinline__ unsigned long long poll(
    const unsigned long long* p, unsigned gen) {
  unsigned long long w;
  do {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(w) : "l"(p) : "memory");
  } while ((w >> 34) != gen);
  return w;
}

__device__ __forceinline__ unsigned kind(unsigned long long w) {
  return static_cast<unsigned>(w >> 32) & 3u;
}

__device__ __forceinline__ float value(unsigned long long w) {
  return __uint_as_float(static_cast<unsigned>(w));
}

__global__ void __launch_bounds__(kWarps * 32)
linear_scan_bwd_kernel(const float* __restrict__ a,
                       const float* __restrict__ h,
                       const float* __restrict__ h0,
                       const float* __restrict__ g,
                       const float* __restrict__ g_last,
                       float* __restrict__ da, float* __restrict__ db,
                       float* __restrict__ dh0, unsigned* __restrict__ ticket,
                       unsigned long long* __restrict__ status, int T, int N,
                       int groups, unsigned tiles, unsigned gen) {
  __shared__ float sa[kWarps][kLanes], sb[kWarps][kLanes];
  __shared__ float s_hin[kLanes];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicInc(ticket, tiles - 1));
  __syncthreads();
  const int tile = s_tile;
  const int k = tile / groups, gi = tile % groups;
  const int per_row = (N + kLanes - 1) / kLanes;
  const int bi = gi / per_row, n = (gi % per_row) * kLanes + lane;
  const bool live = n < N;
  const int s0 = k * kTile + warp * kSteps;  // reverse steps s0 .. s0 + 15
  const long long row = (long long)bi * T;   // step t of the row: row + t
  const long long col = (long long)bi * N + n;

  float va[kSteps], vb[kSteps], vh[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int t = T - 1 - (s0 + u);
    const bool ok = live && t >= 0;  // past the first step: the identity map
    va[u] = ok && t + 1 < T ? __ldcs(a + (row + t + 1) * N + n) : 1.f;
    vb[u] = ok ? __ldcs(g + (row + t) * N + n) : 0.f;
    vh[u] = !ok ? 0.f : t > 0 ? __ldcs(h + (row + t - 1) * N + n) : h0[col];
  }
#pragma unroll
  for (int u = 1; u < kSteps; ++u) {
    vb[u] = fmaf(va[u], vb[u - 1], vb[u]);
    va[u] *= va[u - 1];
  }
  sa[warp][lane] = va[kSteps - 1];
  sb[warp][lane] = vb[kSteps - 1];
  __syncthreads();
  if (warp == 0) {
    float A = 1.f, B = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wa = sa[w][lane], wb = sb[w][lane];
      sa[w][lane] = A;
      sb[w][lane] = B;
      B = fmaf(wa, B, wb);
      A *= wa;
    }
    unsigned long long* mine = status + (long long)tile * 2 * kLanes;
    float hin;
    if (k == 0) {
      hin = live ? g_last[col] : 0.f;
    } else {
      publish(mine + kLanes + lane, gen, kAggregate, B);
      publish(mine + lane, gen, kAggregate, A);
      long long j = tile - groups;
      unsigned long long w0 = poll(status + j * 2 * kLanes + lane, gen);
      while (kind(w0) != kPrefix) {
        j -= groups;
        w0 = poll(status + j * 2 * kLanes + lane, gen);
      }
      hin = value(w0);
      for (j += groups; j < tile; j += groups) {
        const unsigned long long* theirs = status + j * 2 * kLanes;
        w0 = poll(theirs + lane, gen);
        hin = kind(w0) == kPrefix
                  ? value(w0)
                  : fmaf(value(w0), hin,
                         value(poll(theirs + kLanes + lane, gen)));
      }
    }
    publish(mine + lane, gen, kPrefix, fmaf(A, hin, B));
    s_hin[lane] = hin;
  }
  __syncthreads();
  const float x_in = fmaf(sa[warp][lane], s_hin[lane], sb[warp][lane]);
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int t = T - 1 - (s0 + u);
    if (live && t >= 0) {
      const float x = fmaf(va[u], x_in, vb[u]);  // dh_t
      const long long at = (row + t) * N + n;
      db[at] = x;
      da[at] = x * vh[u];
      if (t == 0) dh0[col] = a[row * N + n] * x;
    }
  }
}

}  // namespace

// a, h, g, da, db: (B,T,N) float32 contiguous; h0, g_last, dh0: (B,N)
// float32; scratch as linear_scan_launch's (the same buffer may serve both).
extern "C" int linear_scan_bwd_launch(const void* a, const void* h,
                                      const void* h0, const void* g,
                                      const void* g_last, void* da, void* db,
                                      void* dh0, void* scratch,
                                      long long scratch_words, int B, int T,
                                      int N, unsigned gen, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (T <= 0 || gen == 0 || gen >= kGenerations)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (long long)B * ((N + kLanes - 1) / kLanes);
  const long long tiles = groups * ((T + kTile - 1) / kTile);
  if (tiles > 0x7fffffffLL || scratch_words < tiles * 2 * kLanes + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* words = static_cast<unsigned long long*>(scratch);
  linear_scan_bwd_kernel<<<static_cast<unsigned>(tiles), kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(g),
      static_cast<const float*>(g_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0),
      reinterpret_cast<unsigned*>(words), words + 1, T, N,
      static_cast<int>(groups), static_cast<unsigned>(tiles), gen);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* linear_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
