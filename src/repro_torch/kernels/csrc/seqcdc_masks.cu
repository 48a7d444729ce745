// SeqCDC phase-1 bitmaps for a (B, S) uint8 batch on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/seqcdc_masks.py:seqcdc_masks_pallas
// (body _masks_kernel).  For every byte position k of a row:
//   cand[k] = AND over j < L-1 of the forward compare (b[k+j], b[k+j+1])
//             (">" increasing, "<" decreasing): a monotone run of L bytes
//             starts at k; false for k > S - L;
//   opp[k]  = the opposite compare of (b[k], b[k+1]); false for k >= S - 1.
// Outputs are (B, S) bytes holding 0 or 1 (torch bool storage).
//
// Bound on this card: memory.  Per input byte it moves 1 byte in and 2 out
// (3 bytes) and does about L compares, far below the operations the card
// could do in that time, so its least time is 3 * B * S / 3.35 TB/s.
//
// Design: one thread owns 4 consecutive positions of one row and reads the
// 4 + L - 1 bytes they need through the L1 cache (neighbouring threads
// share all but their first 4 bytes, so each byte comes from device memory
// once).  Where the 4 positions are 4-byte aligned and inside the row, the
// two outputs go out as one 4-byte store each; the ragged row end takes
// byte stores.  Rows are independent, so the grid covers B * ceil(S/4)
// threads at once and fills the card for any B.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPosPerThread = 4;

__global__ void seqcdc_masks_kernel(const uint8_t* __restrict__ x,
                                    uint8_t* __restrict__ cand,
                                    uint8_t* __restrict__ opp,
                                    int B, long long S, int L, int inc) {
  const long long per_row = (S + kPosPerThread - 1) / kPosPerThread;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= per_row * B) return;
  const long long b = t / per_row;
  const long long k0 = (t - b * per_row) * kPosPerThread;
  const uint8_t* row = x + b * S;
  uint8_t c_out[kPosPerThread], o_out[kPosPerThread];
#pragma unroll
  for (int q = 0; q < kPosPerThread; ++q) {
    const long long k = k0 + q;
    uint8_t c = 0, o = 0;
    if (k < S - 1) {
      const uint8_t a = row[k], n = row[k + 1];
      o = inc ? (n < a) : (n > a);
    }
    if (k <= S - L) {
      c = 1;
      for (int j = 0; j < L - 1; ++j) {
        const uint8_t a = row[k + j], n = row[k + j + 1];
        if (inc ? !(n > a) : !(n < a)) {
          c = 0;
          break;
        }
      }
    }
    c_out[q] = c;
    o_out[q] = o;
  }
  const long long off = b * S + k0;
  if (k0 + kPosPerThread <= S && (off % kPosPerThread) == 0) {
    uint32_t cw = 0, ow = 0;
#pragma unroll
    for (int q = 0; q < kPosPerThread; ++q) {
      cw |= uint32_t(c_out[q]) << (8 * q);
      ow |= uint32_t(o_out[q]) << (8 * q);
    }
    *reinterpret_cast<uint32_t*>(cand + off) = cw;
    *reinterpret_cast<uint32_t*>(opp + off) = ow;
  } else {
    for (int q = 0; q < kPosPerThread && k0 + q < S; ++q) {
      cand[off + q] = c_out[q];
      opp[off + q] = o_out[q];
    }
  }
}

}  // namespace

extern "C" int seqcdc_masks_launch(const void* x, void* cand, void* opp,
                                   int B, long long S, int L, int inc,
                                   void* stream) {
  const long long threads = B * ((S + kPosPerThread - 1) / kPosPerThread);
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  if (grid > 0) {
    seqcdc_masks_kernel<<<(unsigned)grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(cand),
        static_cast<uint8_t*>(opp), B, S, L, inc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* seqcdc_masks_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
