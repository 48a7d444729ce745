// The mLSTM's chunk-to-chunk carry of (C, n, m) on Hopper (sm_90a), float32.
//
// Replaces the sequential half of repro/models/ssm.py:mlstm_chunkwise: its
// lax.scan over chunks (ssm.py:139), whose carry (ssm.py:123-131) is
//   m1 = max(Btot + m0, max_l(Btot - b_l + a_l))
//   C1 = exp(Btot + m0 - m1) C0 + sum_l exp(Btot - b_l + a_l - m1) k_l v_l^T
//   n1 = exp(Btot + m0 - m1) n0 + sum_l exp(Btot - b_l + a_l - m1) k_l
// (not a Pallas kernel).  The weights depend on m1 only through the scalar
// factor exp(M_c - m1), with M_c = max_l(Btot - b_l + a_l) the chunk's own
// stabiliser, so the chunk sums
//   KV_c = sum_l exp(Btot - b_l + a_l - M_c) k_l v_l^T,  K_c likewise,
// are plain batched products for all chunks at once (models/ssm.py), and
// this kernel is left the recurrence over chunks:
//   m1 = max(Btot_c + m, M_c);  x1 = exp(Btot_c + m - m1) x + exp(M_c - m1) X_c
// for every entry x of [C | n], with X_c its entry of [KV_c | K_c].  It
// writes (C, n, m) at every chunk's start (the state the chunk's queries
// read) and after the last chunk.
//
// Bound on this card: bytes.  Each entry reads its chunk sum and writes its
// chunk-start value: 8 bytes a chunk against 4 operations; at xLSTM-125M's
// full width (4 heads of 384) a chunk is 2.37 MB, so a 32,768-token prompt
// (128 chunks of 256) is 303 MB each way, 0.18 ms at 3.35 TB/s.
//
// Design: one thread per (b, h, entry) of [C | n], walking the chunks in
// order.  Each thread recomputes the (b, h) stabiliser m itself: a max-plus
// recurrence on two scalars a chunk, read by every thread of a CTA from
// the same address (one broadcast load), far cheaper than a second pass.
// A warp's loads and stores are coalesced along the entries; the next
// kGroup chunks' sums are in flight while the current ones fold, since the
// chain does not depend on them.  At hd = 384 that is 591,360 threads, so
// every SM has work.  (Kernel A, linear_scan.cu, could carry C with a
// precomputed a_c = exp(Btot_c + m - m1) only after a pass that finds m
// and with that factor materialised for every entry, twice the bytes.)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // chunks a thread keeps in flight

__global__ void __launch_bounds__(kThreads)
mlstm_scan_kernel(const float* __restrict__ btot, const float* __restrict__ mc,
                  const float* __restrict__ kv_sum,
                  const float* __restrict__ k_sum,
                  const float* __restrict__ C0, const float* __restrict__ n0,
                  const float* __restrict__ m0, float* __restrict__ C_start,
                  float* __restrict__ n_start, float* __restrict__ m_start,
                  float* __restrict__ C_fin, float* __restrict__ n_fin,
                  float* __restrict__ m_fin, int nc, int H, int hd) {
  const long long hd2 = (long long)hd * hd;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= hd2 + hd) return;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const bool in_C = e < hd2;
  const long long width = in_C ? hd2 : hd;  // entries of this part a (b, h)
  const long long j = in_C ? e : e - hd2;
  // chunk c of (b, h): index ((b * nc + c) * H + h) * width + j
  const long long stride = (long long)H * width;  // between chunks
  const long long first = ((long long)b * nc * H + h) * width + j;
  const float* src = (in_C ? kv_sum : k_sum) + first;
  float* dst = (in_C ? C_start : n_start) + first;
  const float* bt = btot + (long long)b * nc * H + h;  // chunk c at c * H
  const float* mx = mc + (long long)b * nc * H + h;
  float* ms = m_start + (long long)b * nc * H + h;
  const bool writes_m = e == 0;

  float x = (in_C ? C0 : n0)[(long long)bh * width + j];
  float m = m0[bh];
  float cur[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u)
    cur[u] = u < nc ? __ldg(src + u * stride) : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kGroup) {
    float nxt[kGroup];
    const int c1 = c0 + kGroup;
#pragma unroll
    for (int u = 0; u < kGroup; ++u)  // the next group, in flight
      nxt[u] = c1 + u < nc ? __ldg(src + (long long)(c1 + u) * stride) : 0.f;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        dst[(long long)c * stride] = x;
        if (writes_m) ms[(long long)c * H] = m;
        const float bc = __ldg(bt + (long long)c * H);
        const float mcc = __ldg(mx + (long long)c * H);
        const float m1 = fmaxf(bc + m, mcc);
        x = expf(bc + m - m1) * x + expf(mcc - m1) * cur[u];
        m = m1;
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) cur[u] = nxt[u];
  }
  (in_C ? C_fin : n_fin)[(long long)bh * width + j] = x;
  if (writes_m) m_fin[bh] = m;
}

}  // namespace

// btot, mc, m_start: (B,nc,H); kv_sum, C_start: (B,nc,H,hd,hd); k_sum,
// n_start: (B,nc,H,hd); C0, C_fin: (B,H,hd,hd); n0, n_fin: (B,H,hd); m0,
// m_fin: (B,H); all float32 contiguous.
extern "C" int mlstm_scan_launch(const void* btot, const void* mc,
                                 const void* kv_sum, const void* k_sum,
                                 const void* C0, const void* n0,
                                 const void* m0, void* C_start, void* n_start,
                                 void* m_start, void* C_fin, void* n_fin,
                                 void* m_fin, int B, int nc, int H, int hd,
                                 void* stream) {
  if (B <= 0 || H <= 0 || hd <= 0) return 0;
  if (nc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long entries = (long long)hd * hd + hd;
  const dim3 grid((unsigned)((entries + kThreads - 1) / kThreads), B * H);
  mlstm_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(btot), static_cast<const float*>(mc),
      static_cast<const float*>(kv_sum), static_cast<const float*>(k_sum),
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<float*>(C_start),
      static_cast<float*>(n_start), static_cast<float*>(m_start),
      static_cast<float*>(C_fin), static_cast<float*>(n_fin),
      static_cast<float*>(m_fin), nc, H, hd);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mlstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
