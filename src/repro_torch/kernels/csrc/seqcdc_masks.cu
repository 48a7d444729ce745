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
// Design (seqcdc_masks_kernel, L - 1 <= kMaxRun): the batch is one flat
// stream of N = B * S bytes.  cand[k] reads bytes k..k+L-1 and opp[k] reads
// k and k+1, which stay inside the row wherever the row-tail rules let the
// bit be true, so both are computed on the flat stream and zeroed at the
// row tails by position (k mod S).  Each lane owns 16 output positions
// (16-byte aligned, since the outputs are fresh allocations) and loads one
// 16-byte block of input, aligned in memory; the input may start at any
// byte, so block t holds flat bytes [16t - m, 16t - m + 16), m the input's
// offset from 16.  From its block and the next lane's first byte a lane
// forms 16 forward and 16 opposing pair bits (per-byte SIMD compares of the
// block against its one-byte funnel shift); the next four lanes' forward
// bits, by shuffle, give a 64-bit window starting at the lane's first
// output position (shifted by m), and the candidate bits are the AND of
// L - 1 consecutive window bits by log-doubling (m &= m >> 1, >> 2, ...,
// then one last shift): O(log L) steps, no branch on the data.  The bits
// go back to 0/1 bytes and out as one 16-byte store per output.  A warp
// takes kSteps segments of 32 blocks in turn; the window of a segment's
// last lanes reads the first five lanes of the next segment, which the
// warp loads with the rest (all its loads are in flight together).
//
// seqcdc_masks_kernel_long (L - 1 > kMaxRun, beyond the window) keeps the
// first design: one thread per 4 positions of a row, L + 3 byte loads, a
// compare loop that stops at the first failed pair.  The launcher picks
// the kernel by L before it launches.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSteps = 4;          // segments of 32 blocks a warp
constexpr int kWarps = 8;          // warps a CTA
constexpr int kHalo = 5;           // next-segment lanes a window reads
constexpr int kMaxRun = 48;        // L - 1 the 64-bit window covers

// Bits 0..3 of the four per-byte 0x00/0xff flags of a SIMD compare.
__device__ __forceinline__ uint32_t gather4(uint32_t flags) {
  return ((flags & 0x01010101u) * 0x00204081u) >> 21 & 0xFu;
}

// Four bits as four bytes of 0 or 1.
__device__ __forceinline__ uint32_t spread4(uint32_t bits) {
  return ((bits & 0xFu) * 0x00204081u) & 0x01010101u;
}

// The 16 input bytes at flat [lo, lo + 16), 16-byte aligned in memory;
// bytes outside [0, N) read as 0 (only a stream's first and last blocks).
__device__ __forceinline__ uint4 load_block(const uint8_t* x, long long N,
                                            long long lo) {
  if (lo >= 0 && lo + 16 <= N)
    return __ldg(reinterpret_cast<const uint4*>(x + lo));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const long long k = lo + i;
    if (k >= 0 && k < N) w[i >> 2] |= uint32_t(x[k]) << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Forward bits (low 16) and opposing bits (high 16) of a block's 16 pairs
// (b[i], b[i+1]); `next` holds the following block's first byte in its
// low byte.
__device__ __forceinline__ uint32_t pair_bits(uint4 v, uint32_t next,
                                              int inc) {
  const uint32_t w[5] = {v.x, v.y, v.z, v.w, next};
  uint32_t gt = 0, lt = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t succ = __funnelshift_r(w[k], w[k + 1], 8);
    gt |= gather4(__vcmpgtu4(succ, w[k])) << (4 * k);
    lt |= gather4(__vcmpltu4(succ, w[k])) << (4 * k);
  }
  return inc ? (gt | lt << 16) : (lt | gt << 16);
}

// Bit q (q < 16) of the result is the AND of bits q .. q + n - 1 of m
// (1 <= n <= kMaxRun + 1).
__device__ __forceinline__ uint32_t run_and(unsigned long long m, int n) {
  int c = 1;
  while (2 * c <= n) {
    m &= m >> c;
    c *= 2;
  }
  if (c < n) m &= m >> (n - c);
  return (uint32_t)m & 0xFFFFu;
}

__global__ void __launch_bounds__(32 * kWarps)
    seqcdc_masks_kernel(const uint8_t* __restrict__ x,
                        uint8_t* __restrict__ cand,
                        uint8_t* __restrict__ opp, long long N, long long S,
                        int L, int inc, int m) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
  const long long first = warp * kSteps * 32;  // the warp's first block
  if (first * 16 >= N) return;

  uint4 v[kSteps + 1];
#pragma unroll
  for (int u = 0; u <= kSteps; ++u) {
    v[u] = make_uint4(0, 0, 0, 0);
    if (u < kSteps || lane < kHalo)
      v[u] = load_block(x, N, 16 * (first + 32 * u + lane) - m);
  }
  // pair bits of every block; lane 31 takes its next byte from the next
  // segment's lane 0 (meaningless for the halo segment's lane 31: unused)
  uint32_t fo[kSteps + 1];
#pragma unroll
  for (int u = 0; u <= kSteps; ++u) {
    const uint32_t give = (u < kSteps && lane == 0) ? v[u + 1].x : v[u].x;
    fo[u] = pair_bits(v[u], __shfl_sync(kFull, give, (lane + 1) & 31), inc);
  }

  // row position of the warp's first output, then of each lane's
  const long long span = 16LL * 32 * kSteps;
  const long long r_warp = (first * 16) % S;
  const int n = L - 1;
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const long long k0 = 16 * (first + 32 * u + lane);
    // the next four lanes' bits: a source lane below k serves the reader
    // that wraps into the next segment
    uint32_t nb[5];
    nb[0] = fo[u];
#pragma unroll
    for (int k = 1; k <= 4; ++k)
      nb[k] = __shfl_sync(kFull, lane < k ? fo[u + 1] : fo[u],
                          (lane + k) & 31);
    unsigned long long win = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      win |= (unsigned long long)(nb[k] & 0xFFFFu) << (16 * k);
    win >>= m;
    if (m) win |= (unsigned long long)(nb[4] & 0xFFFFu) << (64 - m);
    uint32_t c = run_and(win, n);
    uint32_t o = ((nb[0] >> 16) | (nb[1] & 0xFFFF0000u)) >> m & 0xFFFFu;

    long long r0 = r_warp + (k0 - first * 16);
    r0 = S >= span ? (r0 >= S ? r0 - S : r0) : r0 % S;
    if (r0 + 15 + L > S) {  // a row tail lies in these 16 positions
      uint32_t cm = 0, om = 0;
      long long rp = r0;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        cm |= uint32_t(rp + L <= S) << q;
        om |= uint32_t(rp + 2 <= S) << q;
        if (++rp == S) rp = 0;
      }
      c &= cm;
      o &= om;
    }
    const uint4 cw = make_uint4(spread4(c), spread4(c >> 4), spread4(c >> 8),
                                spread4(c >> 12));
    const uint4 ow = make_uint4(spread4(o), spread4(o >> 4), spread4(o >> 8),
                                spread4(o >> 12));
    if (k0 >= N) continue;  // (after the shuffles its neighbours need)
    if (k0 + 16 <= N) {
      *reinterpret_cast<uint4*>(cand + k0) = cw;
      *reinterpret_cast<uint4*>(opp + k0) = ow;
    } else {
      const uint32_t cs[4] = {cw.x, cw.y, cw.z, cw.w};
      const uint32_t os[4] = {ow.x, ow.y, ow.z, ow.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (k0 + i < N) {
          cand[k0 + i] = (uint8_t)(cs[i >> 2] >> (8 * (i & 3)));
          opp[k0 + i] = (uint8_t)(os[i >> 2] >> (8 * (i & 3)));
        }
      }
    }
  }
}

constexpr int kPosPerThread = 4;

__global__ void seqcdc_masks_kernel_long(const uint8_t* __restrict__ x,
                                         uint8_t* __restrict__ cand,
                                         uint8_t* __restrict__ opp, int B,
                                         long long S, int L, int inc) {
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

// cand and opp must be 16-byte aligned (fresh allocations); x may start at
// any byte.  L >= 2.
extern "C" int seqcdc_masks_launch(const void* x, void* cand, void* opp,
                                   int B, long long S, int L, int inc,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = (long long)B * S;
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  if (L - 1 <= kMaxRun) {
    const long long per_cta = 16LL * 32 * kSteps * kWarps;
    const long long grid = (N + per_cta - 1) / per_cta;
    const int m = (int)(reinterpret_cast<uintptr_t>(x) & 15);
    seqcdc_masks_kernel<<<(unsigned)grid, 32 * kWarps, 0, st>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(cand),
        static_cast<uint8_t*>(opp), N, S, L, inc, m);
  } else {
    const long long threads = B * ((S + kPosPerThread - 1) / kPosPerThread);
    const int block = 256;
    const long long grid = (threads + block - 1) / block;
    seqcdc_masks_kernel_long<<<(unsigned)grid, block, 0, st>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(cand),
        static_cast<uint8_t*>(opp), B, S, L, inc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* seqcdc_masks_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
