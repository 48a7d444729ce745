// The sLSTM recurrence over a sequence on Hopper (sm_90a).
//
// Replaces the per-step lax.scan of repro/models/ssm.py:slstm_block
// (ssm.py:251) over the cell _slstm_cell (ssm.py:213), not a Pallas kernel.
// For the input gates xg (B,S,4,D) (x @ w_g + b_g for g = i, f, z, o: plain
// products outside the scan), the block-diagonal recurrent weights r
// (4,H,hd,hd) (D = H * hd) and the state (h, c, n, m) (B,D) float32, step
// t of head k computes, for each of its channels e,
//   pre_g = xg[b,t,g,k*hd+e] + sum_d h[k*hd+d] * r[g,k,d,e]     (float32)
//   m1 = max(pre_f + m, pre_i),  i = exp(pre_i - m1),  f = exp(pre_f + m - m1)
//   c1 = f c + i tanh(pre_z),  n1 = max(f n + i, 1e-6)
//   h1 = sigmoid(pre_o) * c1 / n1
// exactly the reference's cell: the float32 state times r (bf16 or
// float32, promoted to float32 as JAX promotes it), the gate inputs in
// their own type added in float32.  It writes h for every step (B,S,D)
// float32 and the final (h, c, n, m).
//
// Bound on this card: the serial chain of S steps, not bytes or
// operations.  A step of one head multiplies h by four hd x hd blocks
// (at xLSTM-125M's width, 4 heads of 192: 295 KB of bf16 weights a head)
// and cannot start before the last step's h; the whole run moves only
// xg, h and r once (a 4,096-token prompt: 25 MB of bf16 gates, 0.0075 ms
// at 3.35 TB/s), so the least time a step is set by latency.
//
// Design (a first design): one CTA per (b, head).  Each step's four
// products h . r_g are split over the CTA's threads: a thread takes one
// gate, kV neighbouring channels (one 16-byte word of r a row: 8 bf16 or
// 4 float32) and every kSplit-th row d (kSplit = 4), the quad's partial
// sums reduced by two xor-shuffles.  h, the gates' pre-activations and
// (c, n, m) live in shared memory, and so do as many rows of the head's
// four blocks of r as fit (144 of 192 at xLSTM's width: 221 KB, each
// row's words swizzled against bank conflicts), copied once; the last
// rows of every block are read from L2 every step, their loads issued
// before the shared-memory rows are folded, so their latency hides behind
// that work.  The gate inputs are prefetched a step ahead.  After a
// barrier the threads run the cell in float32 over the channels and write
// h back.  Only B * H CTAs run (4 at B = 1), one SM each, and every step
// waits on two barriers; PERF.md has a step's measured time against what
// its instructions and shared-memory reads account for.  A thread-block
// cluster holding a head's whole r across its CTAs' shared memory
// (exchanging h through distributed shared memory) would take the last L2
// reads off the chain and split a step's work over more SMs; that is
// later work.
#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSplit = 4;   // threads that split one dot product's rows
// 16-byte words of r a thread keeps in flight: from L2 (issued before the
// shared-memory rows are folded) and from shared memory
constexpr int kUnrollL2 = 12;
constexpr int kUnrollSm = 4;
constexpr int kMaxThreads = 512;  // 128 registers a thread
constexpr size_t kSmemMax = 232448;  // shared memory a CTA may opt in to

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// the kV values of r in one 16-byte word group, as float32
__device__ __forceinline__ void unpack(const uint4& w, float (&out)[4]) {
  out[0] = __uint_as_float(w.x);
  out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z);
  out[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&out)[8]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 to float32: the top 16 bits
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// channels a thread: one 16-byte load of r a row
template <typename RT>
struct Vec {
  static constexpr int kV = 16 / (int)sizeof(RT);
};

// threads of a CTA: 4 gates x hd / kV channel groups x kSplit, rounded up
// to whole warps (the quads' shuffles need every lane present)
template <typename RT>
int threads_for(int hd) {
  const int t = 4 * (hd / Vec<RT>::kV) * kSplit;
  return (t + 31) / 32 * 32;
}

// up to kN 16-byte words of r: rows i0, i0 + 1, ... (< rows) of a thread,
// at p + i * step
template <int kN, typename RT>
__device__ __forceinline__ void load_rows(uint4 (&w)[kN], const RT* p,
                                          long long step, int i0, int rows) {
#pragma unroll
  for (int u = 0; u < kN; ++u)
    w[u] = i0 + u < rows
               ? *reinterpret_cast<const uint4*>(p + (i0 + u) * step)
               : make_uint4(0u, 0u, 0u, 0u);
}

// acc += h[d] r[d, :] over the words loaded for rows i0, i0 + 1, ... (row i
// of the thread is d = ks + kSplit * i)
template <int kN, int kV>
__device__ __forceinline__ void fold_rows(const uint4 (&w)[kN], int i0,
                                          int rows, const float* h_sm, int ks,
                                          float (&acc)[kV]) {
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    if (i0 + u < rows) {
      const float hv = h_sm[ks + (i0 + u) * kSplit];
      float rv[kV];
      unpack(w[u], rv);
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[v] = fmaf(hv, rv[v], acc[v]);
    }
  }
}

template <typename XT, typename RT>
__global__ void __launch_bounds__(kMaxThreads)
slstm_scan_kernel(const XT* __restrict__ xg, const RT* __restrict__ r,
                  const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ hs, float* __restrict__ h_fin,
                  float* __restrict__ c_fin, float* __restrict__ n_fin,
                  float* __restrict__ m_fin, int S, int H, int hd,
                  int smem_rows, int swizzle) {
  constexpr int kV = Vec<RT>::kV;
  extern __shared__ __align__(16) float smem[];
  float* h_sm = smem;          // h of this head, hd floats
  float* pre = h_sm + hd;      // the four gates' pre-activations, 4 * hd
  float* c_sm = pre + 4 * hd;  // c, n, m of this head
  float* n_sm = c_sm + hd;
  float* m_sm = n_sm + hd;
  RT* r_sm = reinterpret_cast<RT*>(m_sm + hd);  // rows < smem_rows of r
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ks = tid % kSplit, rest = tid / kSplit;
  const int groups = hd / kV;
  const bool active = rest < 4 * groups;  // the rest only shuffle zeros
  const int j = active ? rest % groups : 0, g = active ? rest / groups : 0;
  const int e0 = j * kV;                  // this thread's first channel
  const int rows = hd / kSplit;  // its rows of r: ks, ks + kSplit, ...
  const int rows_sm = smem_rows / kSplit;  // the first ones in shared memory
  const int head = blockIdx.x, b = blockIdx.y;
  const long long D = (long long)H * hd;
  const long long chan = (long long)b * D + (long long)head * hd;
  // r[g, head, d, e0 .. e0 + kV) for d = ks + kSplit i: in global memory
  // at rp + i * kSplit * hd; in shared memory (rows below smem_rows) at
  // sp + i * kSplit * hd, each row's 16-byte words stored with their index
  // XOR 2 (d mod 4) (when a row has a multiple of 8 of them), so a quad's
  // four rows and a warp's neighbouring words fall in distinct banks
  const RT* rp = r + (((long long)g * H + head) * hd + ks) * hd + e0;
  const RT* sp = r_sm + ((long long)g * smem_rows + ks) * hd +
                 (j ^ (2 * ks & swizzle)) * kV;
  const XT* xb = xg + (long long)b * S * 4 * D + g * D + head * hd + e0;
  const long long xstep = 4 * D;
  float* hb = hs + (long long)b * S * D + head * hd;

  {  // rows d < smem_rows of this head's four blocks of r, once
    const RT* src = r + (long long)head * hd * hd;
    const long long words = 4LL * smem_rows * groups;
    for (long long w = tid; w < words; w += nthr) {
      const int c = (int)(w % groups);
      const long long gd = w / groups;  // g * smem_rows + d
      const int gg = (int)(gd / smem_rows), d = (int)(gd % smem_rows);
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          src + (long long)gg * H * hd * hd + (long long)d * hd + c * kV));
      *reinterpret_cast<uint4*>(r_sm + gd * hd +
                                (c ^ (2 * (d % kSplit) & swizzle)) * kV) = v;
    }
  }
  for (int e = tid; e < hd; e += nthr) {
    h_sm[e] = h0[chan + e];
    c_sm[e] = c0[chan + e];
    n_sm[e] = n0[chan + e];
    m_sm[e] = m0[chan + e];
  }
  const bool loads_x = active && ks == 0;
  float x_next[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) x_next[v] = loads_x ? to_f(xb[v]) : 0.f;
  __syncthreads();
  for (int t = 0; t < S; ++t) {
    float x[kV], acc[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      x[v] = x_next[v];
      acc[v] = 0.f;
    }
    if (loads_x && t + 1 < S) {
#pragma unroll
      for (int v = 0; v < kV; ++v)
        x_next[v] = to_f(xb[(long long)(t + 1) * xstep + v]);
    }
    if (active) {
      // the first L2 rows in flight while the shared-memory rows fold
      const long long step = (long long)kSplit * hd;
      uint4 wg[kUnrollL2], w[kUnrollSm];
      load_rows<kUnrollL2, RT>(wg, rp, step, rows_sm, rows);
      for (int i0 = 0; i0 < rows_sm; i0 += kUnrollSm) {
        load_rows<kUnrollSm, RT>(w, sp, step, i0, rows_sm);
        fold_rows<kUnrollSm, kV>(w, i0, rows_sm, h_sm, ks, acc);
      }
      fold_rows<kUnrollL2, kV>(wg, rows_sm, rows, h_sm, ks, acc);
      for (int i0 = rows_sm + kUnrollL2; i0 < rows; i0 += kUnrollL2) {
        load_rows<kUnrollL2, RT>(wg, rp, step, i0, rows);
        fold_rows<kUnrollL2, kV>(wg, i0, rows, h_sm, ks, acc);
      }
    }
#pragma unroll
    for (int v = 0; v < kV; ++v) {  // the quad's partial sums
      acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], 1);
      acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], 2);
    }
    if (loads_x) {
#pragma unroll
      for (int v = 0; v < kV; ++v) pre[g * hd + e0 + v] = x[v] + acc[v];
    }
    __syncthreads();
    for (int e = tid; e < hd; e += nthr) {
      const float i_pre = pre[e];
      const float f_pre = pre[hd + e];
      const float z = tanhf(pre[2 * hd + e]);
      const float o = 1.f / (1.f + expf(-pre[3 * hd + e]));
      const float m = m_sm[e];
      const float m1 = fmaxf(f_pre + m, i_pre);
      const float ip = expf(i_pre - m1);
      const float fp = expf(f_pre + m - m1);
      const float c = fp * c_sm[e] + ip * z;
      const float n = fmaxf(fp * n_sm[e] + ip, 1e-6f);
      const float h = o * (c / n);
      c_sm[e] = c;
      n_sm[e] = n;
      m_sm[e] = m1;
      h_sm[e] = h;
      hb[(long long)t * D + e] = h;
    }
    __syncthreads();
  }
  for (int e = tid; e < hd; e += nthr) {
    h_fin[chan + e] = h_sm[e];
    c_fin[chan + e] = c_sm[e];
    n_fin[chan + e] = n_sm[e];
    m_fin[chan + e] = m_sm[e];
  }
}

template <typename XT, typename RT>
int launch(const void* xg, const void* r, const float* const* st, float* hs,
           float* const* fin, int B, int S, int H, int hd,
           cudaStream_t stream) {
  if (hd % Vec<RT>::kV != 0 || hd % kSplit != 0 ||
      threads_for<RT>(hd) > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  // as many rows of the four gates' blocks of r in shared memory as fit
  // beside the state, a multiple of kSplit (144 of 192 at xLSTM's bf16
  // heads), the rest from L2
  const size_t state = (size_t)8 * hd * sizeof(float);
  const size_t row = (size_t)4 * hd * sizeof(RT);  // one row of each gate
  const int smem_rows = (int)std::min<size_t>(
      hd, (kSmemMax - state) / row / kSplit * kSplit);
  const size_t smem = state + smem_rows * row;
  cudaError_t err = cudaFuncSetAttribute(
      slstm_scan_kernel<XT, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int swizzle = (hd / Vec<RT>::kV) % 8 == 0 ? 6 : 0;
  const dim3 grid(H, B);
  slstm_scan_kernel<XT, RT><<<grid, threads_for<RT>(hd), smem, stream>>>(
      static_cast<const XT*>(xg), static_cast<const RT*>(r), st[0], st[1],
      st[2], st[3], hs, fin[0], fin[1], fin[2], fin[3], S, H, hd, smem_rows,
      swizzle);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xg: (B,S,4,D) float32 (xg_bf16 == 0) or bfloat16; r: (4,H,hd,hd) float32
// (r_bf16 == 0) or bfloat16; h0, c0, n0, m0, h_fin, c_fin, n_fin, m_fin:
// (B,D) float32; hs: (B,S,D) float32; all contiguous, r 16-byte aligned.
// hd a multiple of 8 (bfloat16 r) or 4 (float32 r), at most 256 or 128.
extern "C" int slstm_scan_launch(const void* xg, const void* r, const void* h0,
                                 const void* c0, const void* n0,
                                 const void* m0, void* hs, void* h_fin,
                                 void* c_fin, void* n_fin, void* m_fin, int B,
                                 int S, int H, int hd, int xg_bf16,
                                 int r_bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (hd <= 0 || reinterpret_cast<uintptr_t>(r) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* st[4] = {static_cast<const float*>(h0),
                        static_cast<const float*>(c0),
                        static_cast<const float*>(n0),
                        static_cast<const float*>(m0)};
  float* fin[4] = {static_cast<float*>(h_fin), static_cast<float*>(c_fin),
                   static_cast<float*>(n_fin), static_cast<float*>(m_fin)};
  float* out = static_cast<float*>(hs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xg_bf16)
    return r_bf16 ? launch<bf16, bf16>(xg, r, st, out, fin, B, S, H, hd, s)
                  : launch<bf16, float>(xg, r, st, out, fin, B, S, H, hd, s);
  return r_bf16 ? launch<float, bf16>(xg, r, st, out, fin, B, S, H, hd, s)
                : launch<float, float>(xg, r, st, out, fin, B, S, H, hd, s);
}

extern "C" const char* slstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
