// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t on Hopper (sm_90a),
// float32, the RG-LRU's scan over the sequence.
//
// Replaces the lax.associative_scan of repro/models/rglru.py:rglru_scan
// (the reference's prefill form of the RG-LRU; not a Pallas kernel).  For
// a, b (B,T,N) and h0 (B,N), all float32 and contiguous:
//   h_0 = a_0 * h0 + b_0,  h_t = a_t * h_{t-1} + b_t,
// which is the reference's fold of h0 into the first input term
// (b[:, 0] += a[:, 0] * h0) followed by the scan.  It writes every h_t
// (B,T,N) and h_{T-1} (B,N).
//
// Bound on this card: bytes.  Each element reads a and b and writes h: 12
// bytes against 2 operations, so at the RG-LRU's width (N = lru_width =
// 2560) a 4,096-token prompt is 126 MB, 0.038 ms at 3.35 TB/s.
//
// Design (a first design, right before fast): one thread per (b, n)
// channel walks T in order, so the recurrence's chain is one fused
// multiply-add a step in a register.  A warp's loads are coalesced along
// N (32 neighbouring channels, 128 bytes a load).  The chain does not
// depend on the loads, so the thread keeps the next kGroup steps' a and b
// in flight while it folds the current ones (a register double buffer).
// Only B*N threads exist (2,560 at B = 1: 40 CTAs of 64, a third of the
// SMs), so the memory system is far from full: the loads in flight, not
// the card's rate, set the time.  A chunked form (each thread a chunk of
// T, the chunks' carries joined by a second short scan) would fill the
// card at 1.7x the bytes; that is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kGroup = 16;  // steps a thread keeps in flight

__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ out,
                   float* __restrict__ last, int T, int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (n >= N) return;
  const long long base = (long long)bi * T * N + n;
  const float* pa = a + base;
  const float* pb = b + base;
  float* po = out + base;
  float h = h0[(long long)bi * N + n];

  float ca[kGroup], cb[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const bool ok = u < T;
    ca[u] = ok ? __ldg(pa + (long long)u * N) : 0.f;
    cb[u] = ok ? __ldg(pb + (long long)u * N) : 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += kGroup) {
    float na[kGroup], nb[kGroup];
    const int t1 = t0 + kGroup;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {  // the next group, in flight
      const bool ok = t1 + u < T;
      na[u] = ok ? __ldg(pa + (long long)(t1 + u) * N) : 0.f;
      nb[u] = ok ? __ldg(pb + (long long)(t1 + u) * N) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (t0 + u < T) {
        h = fmaf(ca[u], h, cb[u]);
        po[(long long)(t0 + u) * N] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  last[(long long)bi * N + n] = h;
}

}  // namespace

// a, b, out: (B,T,N) float32 contiguous; h0, last: (B,N) float32.
extern "C" int linear_scan_launch(const void* a, const void* b, const void* h0,
                                  void* out, void* last, int B, int T, int N,
                                  void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  linear_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out),
      static_cast<float*>(last), T, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
