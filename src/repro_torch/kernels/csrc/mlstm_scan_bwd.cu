// The backward of the mLSTM's chunk-to-chunk carry of (C, n, m) on Hopper
// (sm_90a), float32.
//
// Replaces the reference's autodiff of its lax.scan over chunks
// (repro/models/ssm.py:139, jax.grad through the carry at ssm.py:123-131;
// not a Pallas kernel).  The forward (mlstm_scan.cu) carries, for every
// entry x of [C | n] with X_c its entry of the chunk sums [KV_c | K_c],
//   u = Btot_c + m,  m1 = max(u, M_c),  f = exp(u - m1),  s = exp(M_c - m1)
//   x1 = f x + s X_c
// and writes the state at every chunk start (C_start, n_start, m_start) and
// after the last.  Given those, the inputs and the gradients of all six
// outputs, the backward walks the chunks from the last with dx, the
// gradient of the entry after chunk c:
//   dX_c = s dx;  x's gradient before the chunk f dx + dx_start,c;
// and, per (b, h), two inner products over [C | n],
//   P1_c = <dx, x_c>,  P2_c = <dx, X_c>,
// which take the scalars back: dm1 = dm - f P1 - s P2 goes to u or M_c by
// the max (half each at a tie, as torch's maximum and JAX's max split it),
//   dBtot_c = f P1 + dm1 [u wins],  dM_c = s P2 + dm1 [M_c wins],
//   dm before the chunk = dBtot_c + dm_start,c.
// The entries' walk needs no scalar gradient (f and s come from the forward's
// values), so the scalars wait for it.
//
// Bound on this card: bytes.  Each entry reads x_c, X_c and dx_start,c and
// writes dX_c: 16 bytes a chunk against 6 operations; at xLSTM-125M's full
// width (4 heads of 384) a chunk of a row is 9.5 MB, 2.8 us at 3.35 TB/s.
//
// Design: two kernels on the stream.  The first is the forward's layout
// (one thread per (b, h, entry) of [C | n], every SM busy) walking the
// chunks backwards, kGroup chunks' loads in flight while the chain of dx
// folds; each thread's terms of P1 and P2 meet in a warp's shuffles, the
// warps' sums in shared memory, and each block leaves its two partial sums
// a chunk in a buffer the wrapper allocated.  The second, one block a
// (b, h), sums those partials in a fixed order (a warp a chunk) and walks
// the scalar recurrence over the chunks.  No atomics: every launch gives the
// same bits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;  // chunks a thread keeps in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_entries(const float* __restrict__ btot, const float* __restrict__ mc,
                  const float* __restrict__ kv_sum,
                  const float* __restrict__ k_sum,
                  const float* __restrict__ C_start,
                  const float* __restrict__ n_start,
                  const float* __restrict__ m_start,
                  const float* __restrict__ dC_start,
                  const float* __restrict__ dn_start,
                  const float* __restrict__ dC_fin,
                  const float* __restrict__ dn_fin, float* __restrict__ dkv,
                  float* __restrict__ dk, float* __restrict__ dC0,
                  float* __restrict__ dn0, float* __restrict__ partial,
                  int nc, int H, int hd) {
  __shared__ float red[kGroup][kWarps][2];
  const long long hd2 = (long long)hd * hd;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = e < hd2 + hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const bool in_C = e < hd2;
  const long long width = in_C ? hd2 : hd;
  const long long j = in_C ? e : e - hd2;
  const long long stride = (long long)H * width;  // between chunks
  const long long first = ((long long)b * nc * H + h) * width + j;
  const float* xs = (in_C ? C_start : n_start) + first;
  const float* Xs = (in_C ? kv_sum : k_sum) + first;
  const float* ds = (in_C ? dC_start : dn_start) + first;
  float* dX = (in_C ? dkv : dk) + first;
  const long long s0 = (long long)b * nc * H + h;  // scalars: chunk c at c H
  const int blocks = gridDim.x;

  float dx = live ? (in_C ? dC_fin : dn_fin)[(long long)bh * width + j] : 0.f;
  for (int hi = nc - 1; hi >= 0; hi -= kGroup) {
    float vx[kGroup], vX[kGroup], vd[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {  // the group's loads, in flight
      const int c = hi - u;
      const bool ok = live && c >= 0;
      vx[u] = ok ? __ldg(xs + c * stride) : 0.f;
      vX[u] = ok ? __ldg(Xs + c * stride) : 0.f;
      vd[u] = ok ? __ldg(ds + c * stride) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int c = hi - u;
      if (c < 0) break;
      const float uu = __ldg(btot + s0 + (long long)c * H) +
                       __ldg(m_start + s0 + (long long)c * H);
      const float mcc = __ldg(mc + s0 + (long long)c * H);
      const float m1 = fmaxf(uu, mcc);
      const float f = expf(uu - m1), s = expf(mcc - m1);
      const float p1 = warp_sum(dx * vx[u]);
      const float p2 = warp_sum(dx * vX[u]);
      if (lane == 0) {
        red[u][warp][0] = p1;
        red[u][warp][1] = p2;
      }
      if (live) dX[c * stride] = s * dx;
      dx = fmaf(f, dx, vd[u]);
    }
    __syncthreads();
    if (threadIdx.x < 2 * kGroup) {  // the block's sums, warps in order
      const int u = threadIdx.x >> 1, which = threadIdx.x & 1;
      const int c = hi - u;
      if (c >= 0) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += red[u][w][which];
        partial[(((long long)bh * nc + c) * blocks + blockIdx.x) * 2 + which] =
            v;
      }
    }
    __syncthreads();
  }
  if (live) (in_C ? dC0 : dn0)[(long long)bh * width + j] = dx;
}

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_scalars(const float* __restrict__ btot, const float* __restrict__ mc,
                  const float* __restrict__ m_start,
                  const float* __restrict__ dm_start,
                  const float* __restrict__ dm_fin, float* __restrict__ dbtot,
                  float* __restrict__ dmc, float* __restrict__ dm0,
                  float* __restrict__ partial, int nc, int H, int blocks) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // P1, P2 of chunk c: a warp sums the blocks' partials in a fixed order
  // and leaves them in the first block's slot
  for (int c = warp; c < nc; c += kWarps) {
    float* p = partial + ((long long)bh * nc + c) * blocks * 2;
    float v1 = 0.f, v2 = 0.f;
    for (int k = lane; k < blocks; k += 32) {
      v1 += p[2 * k];
      v2 += p[2 * k + 1];
    }
    v1 = warp_sum(v1);
    v2 = warp_sum(v2);
    __syncwarp();
    if (lane == 0) {
      p[0] = v1;
      p[1] = v2;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long s0 = (long long)b * nc * H + h;
  float dm = dm_fin[bh];
  for (int c = nc - 1; c >= 0; --c) {
    const long long at = s0 + (long long)c * H;
    const float* p = partial + ((long long)bh * nc + c) * blocks * 2;
    const float uu = btot[at] + m_start[at], mcc = mc[at];
    const float m1 = fmaxf(uu, mcc);
    const float gf = expf(uu - m1) * p[0], gs = expf(mcc - m1) * p[1];
    const float dm1 = dm - gf - gs;
    const float share = uu > mcc ? 1.f : uu < mcc ? 0.f : 0.5f;
    const float du = gf + share * dm1;
    dbtot[at] = du;
    dmc[at] = gs + (1.f - share) * dm1;
    dm = du + dm_start[at];
  }
  dm0[bh] = dm;
}

}  // namespace

// btot, mc, m_start, dm_start, dbtot, dmc: (B,nc,H); kv_sum, C_start,
// dC_start, dkv: (B,nc,H,hd,hd); k_sum, n_start, dn_start, dk: (B,nc,H,hd);
// dC_fin, dC0: (B,H,hd,hd); dn_fin, dn0: (B,H,hd); dm_fin, dm0: (B,H); all
// float32 contiguous; partial: partial_words floats, at least B H nc
// ceil((hd^2 + hd) / 256) 2 (its contents need no setting).
extern "C" int mlstm_scan_bwd_launch(
    const void* btot, const void* mc, const void* kv_sum, const void* k_sum,
    const void* C_start, const void* n_start, const void* m_start,
    const void* dC_start, const void* dn_start, const void* dm_start,
    const void* dC_fin, const void* dn_fin, const void* dm_fin, void* dbtot,
    void* dmc, void* dkv, void* dk, void* dC0, void* dn0, void* dm0,
    void* partial, long long partial_words, int B, int nc, int H, int hd,
    void* stream) {
  if (B <= 0 || H <= 0 || hd <= 0) return 0;
  if (nc <= 0 || B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long entries = (long long)hd * hd + hd;
  const long long blocks = (entries + kThreads - 1) / kThreads;
  if (partial_words < (long long)B * H * nc * blocks * 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto F = [](const void* p) { return static_cast<const float*>(p); };
  const auto W = [](void* p) { return static_cast<float*>(p); };
  mlstm_bwd_entries<<<dim3((unsigned)blocks, B * H), kThreads, 0, s>>>(
      F(btot), F(mc), F(kv_sum), F(k_sum), F(C_start), F(n_start),
      F(m_start), F(dC_start), F(dn_start), F(dC_fin), F(dn_fin), W(dkv),
      W(dk), W(dC0), W(dn0), W(partial), nc, H, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_scalars<<<B * H, kThreads, 0, s>>>(
      F(btot), F(mc), F(m_start), F(dm_start), F(dm_fin), W(dbtot), W(dmc),
      W(dm0), W(partial), nc, H, static_cast<int>(blocks));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mlstm_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
