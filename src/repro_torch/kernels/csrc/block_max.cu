// Per-block byte maxima of a uint8 stream on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/extremum.py:block_max_pallas (body
// _block_max_kernel): out[j] = max of x[j*block, (j+1)*block), the tail past
// n read as 0 (neutral for a uint8 max), for j < ceil(n / block).
//
// Bound on this card: memory.  n bytes in and ceil(n / block) out, one
// compare per byte: least time (n + ceil(n / block)) / 3.35 TB/s.
//
// Design: one thread per output block.  Where the block is a multiple of 16
// bytes, the stream 16-byte aligned and the block inside the stream, the
// thread reads it as 16-byte loads, all in flight at once for a 128-byte
// block, and folds each with __vmaxu4 (four byte maxima an instruction); a
// ragged tail, an unaligned stream or a block size that is not a multiple
// of 16 takes byte loads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned max4(uint4 v) {
  return __vmaxu4(__vmaxu4(v.x, v.y), __vmaxu4(v.z, v.w));
}

__global__ void __launch_bounds__(kThreads)
block_max_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                 long long n, int block, long long nb) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= nb) return;
  const long long s = j * block;
  unsigned m = 0;
  if (block % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      s + block <= n) {
    const uint4* p = reinterpret_cast<const uint4*>(x + s);
    const int words = block / 16;
    int q = 0;
    for (; q + 8 <= words; q += 8) {
      uint4 v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = __ldg(p + q + r);
#pragma unroll
      for (int r = 0; r < 8; ++r) m = __vmaxu4(m, max4(v[r]));
    }
    for (; q < words; ++q) m = __vmaxu4(m, max4(__ldg(p + q)));
    m = __vmaxu4(m, m >> 16);
    m = __vmaxu4(m, m >> 8);
    m &= 0xff;
  } else {
    const long long e = s + block < n ? s + block : n;
    for (long long i = s; i < e; ++i) m = m > x[i] ? m : x[i];
  }
  out[j] = (uint8_t)m;
}

}  // namespace

extern "C" int block_max_launch(const void* x, void* out, long long n,
                                int block, void* stream) {
  if (block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (n + block - 1) / block;
  const long long grid = (nb + kThreads - 1) / kThreads;
  if (grid > 0) {
    block_max_kernel<<<(unsigned)grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), n, block,
        nb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
