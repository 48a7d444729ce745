// The backward of the sLSTM recurrence over a sequence on Hopper (sm_90a).
//
// Replaces the reference's autodiff of the per-step lax.scan of
// repro/models/ssm.py:slstm_block (ssm.py:251, jax.grad through the cell
// _slstm_cell; not a Pallas kernel).  The forward (slstm_scan.cu) computes
// at step t of head k, for each channel e,
//   pre_g = xg[b,t,g,e] + sum_d h_{t-1}[d] r[g,k,d,e]
//   m1 = max(pre_f + m, pre_i),  i = exp(pre_i - m1),  f = exp(pre_f + m - m1)
//   c1 = f c + i tanh(pre_z),  n1 = max(f n + i, 1e-6),  h1 = sigmoid(pre_o) c1 / n1.
// This kernel takes the pre-activations of every step, float32 (B,S,4,D)
// (the wrapper rebuilds them at once from the saved h and xg: one batched
// product off the chain), r (4,H,hd,hd) float32 or bfloat16, the state
// before the first step (c0, n0, m0) and the kept (c, n, m) after every
// step (B,S,3,D), and the gradients of hs (B,S,D) and of the final
// (h, c, n, m); it walks the steps from the last, differentiating the cell
// exactly (the m chain through both maxes and exps: the reference stops no
// gradient; a max's tie splits the gradient evenly, as torch's maximum and
// JAX's max do), and writes every step's gate gradients dpre (B,S,4,D)
// float32 and the initial state's gradient (dh0, dc0, dn0, dm0) (B,D).  The
// wrapper then takes dxg = dpre in xg's type and dr = sum_{b,t} h_{t-1} (x)
// dpre_t, a batched product.
//
// Bound on this card: the serial chain of S steps, as the forward's.  The
// gradient of h_{t-1} is sum_g sum_e r[g,k,d,e] dpre_g[e] over the head's
// 4 hd gate gradients of step t, so step t - 1 cannot start before every
// channel's dpre_t is known: a product of r with dpre (the transpose of the
// forward's), a reduction across lanes, the cell's backward and the
// exchange of dpre, a step.
//
// Design: the forward's cluster turned around.  A thread-block cluster of C
// CTAs a (b, head); CTA c owns the head's channels [c E, (c + 1) E), E = hd
// / C, as rows d of r: a warp takes two of them, its lane l holds, for the
// positions l + 32 i of the dpre buffer, r[g, k, d, e] for the 4 gates and
// its 2 rows in registers (converted to float32 once), and sums its 4 x NR
// terms a row before the warp folds the two rows' sums across its lanes (6
// shuffles).  Warp 0 waits for the rows' sums at a named barrier and runs
// the cell's backward, lane e for channel e, with the pre-activations, the
// previous state and the gradient of hs it loaded kAhead steps before; it
// stores dpre to global memory and sends it, four channels of a gate a
// 16-byte st.async, into the dpre buffer of every CTA of the cluster,
// counted on that CTA's mbarrier.  The buffer is double-buffered by the
// reverse step's parity, armed as the forward arms its h buffer: a buffer is
// re-armed for step u + 2 before this CTA sends its part of step u + 1,
// which every sender of step u + 2 needs first.  After the first step (the
// last to walk) one more product gives dh0.  The cluster size, the rows'
// padding and the head widths are the forward's.
#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHd = 256;       // the widest head: one buffer row's floats
constexpr int kMaxThreads = 512;  // 128 registers a thread
constexpr int kAhead = 4;         // steps of inputs a cell lane has in flight
constexpr int kMaxCluster = 8;    // portable
constexpr int kCPW = 2;           // rows of r (channels) a warp

__device__ __forceinline__ float load_val(const void* p, long long i,
                                          int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t map_rank(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void store_async(uint32_t addr, float a, float b,
                                            float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the share of max(x, y)'s gradient that goes to x
__device__ __forceinline__ float share(float x, float y) {
  return x > y ? 1.f : x < y ? 0.f : 0.5f;
}

// The sum over the dpre buffer bp (4 gates of kMaxHd positions) times the
// lane's registers of r, for the warp's two rows: lanes with bit 16 keep
// row 1 and hand row 0 to their partner, then a butterfly over 16 lanes, so
// lane l returns the sum of row l / 16
template <int NR>
__device__ __forceinline__ float rows_sum(const float (&rr)[kCPW][4][NR],
                                          const float* bp, int lane) {
  float acc[kCPW];
#pragma unroll
  for (int j = 0; j < kCPW; ++j) acc[j] = 0.f;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float v = bp[g * kMaxHd + lane + 32 * i];
#pragma unroll
      for (int j = 0; j < kCPW; ++j) acc[j] = fmaf(v, rr[j][g][i], acc[j]);
    }
  }
  const bool up = lane & 16;
  float s = (up ? acc[1] : acc[0]) +
            __shfl_xor_sync(kFull, up ? acc[0] : acc[1], 16);
#pragma unroll
  for (int off = 8; off >= 1; off /= 2) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// NR: positions of the dpre buffer a lane holds r for (in use <= 32 NR)
template <int NR>
__global__ void __launch_bounds__(kMaxThreads, 1)
slstm_scan_bwd_kernel(const float* __restrict__ pre,
                      const void* __restrict__ r,
                      const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0,
                      const float* __restrict__ cnm,
                      const float* __restrict__ dhs,
                      const float* __restrict__ dh_fin,
                      const float* __restrict__ dc_fin,
                      const float* __restrict__ dn_fin,
                      const float* __restrict__ dm_fin,
                      float* __restrict__ dpre, float* __restrict__ dh0,
                      float* __restrict__ dc0, float* __restrict__ dn0,
                      float* __restrict__ dm0, int S, int H, int hd, int C,
                      int r_bf16) {
  // dbuf[p][g]: the head's dpre_g of reverse step u in dbuf[u & 1], at
  // positions (d / E) Ep + d % E as the forward's h buffer; complete at phase
  // (u >> 1) & 1 of full[u & 1]
  __shared__ __align__(16) float dbuf[2][4][kMaxHd];
  __shared__ __align__(8) uint64_t full[2];
  __shared__ float s_dh[32];  // the step's sums: dh from the product with r
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cluster_rank());
  const int head = blockIdx.x / C, b = blockIdx.y;
  const int E = hd / C;
  const int Ep = (E + 3) & ~3;
  const long long D = (long long)H * hd;
  const long long chan0 = (long long)b * D + (long long)head * hd + rank * E;
  const long long dchan = chan0 - (long long)b * D;  // within a row of D

  // rr[j][g][i] = r[g, head, rank E + 2 warp + j, e] for the channel e at
  // position lane + 32 i of dbuf, zero at padding or past E rows
  float rr[kCPW][4][NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int pos = lane + 32 * i, q = pos / Ep, k = pos % Ep;
    const int e = q < C && k < E ? q * E + k : -1;
#pragma unroll
    for (int j = 0; j < kCPW; ++j) {
      const int el = warp * kCPW + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        rr[j][g][i] =
            el < E && e >= 0
                ? load_val(r,
                           (((long long)g * H + head) * hd + rank * E + el) *
                                   hd + e,
                           r_bf16)
                : 0.f;
    }
  }
  // after the fold, lane l holds the sum of the warp's row l / 16
  const int el = warp * kCPW + (lane >> 4);
  const bool writes_dh = el < E && (lane & 15) == 0;
  const bool cell = warp == 0 && lane < E;
  float dc = 0.f, dn = 0.f, dm = 0.f, dh_last = 0.f;
  if (cell) {
    dh_last = dh_fin[chan0 + lane];
    dc = dc_fin[chan0 + lane];
    dn = dn_fin[chan0 + lane];
    dm = dm_fin[chan0 + lane];
  }
  for (int pos = threadIdx.x; pos < 2 * 4 * kMaxHd; pos += blockDim.x)
    (&dbuf[0][0][0])[pos] = 0.f;
  const int bytes = 4 * C * Ep * 4;  // a step's arrivals at each CTA
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&full[0], bytes);              // reverse step 0
    if (S >= 2) mbar_expect(&full[1], bytes);  // reverse step 1
  }
  // the cell lane's inputs at step t: pre_t (4), the state before it (3,
  // from the kept state or the initial one) and the gradient of hs_t
  float in[kAhead][8];
  const auto load = [&](float (&v)[8], int t) {
    if (!cell || t < 0) return;
    const float* pp = pre + ((long long)b * S + t) * 4 * D + dchan + lane;
#pragma unroll
    for (int g = 0; g < 4; ++g) v[g] = pp[g * D];
    if (t >= 1) {
      const float* kp = cnm + ((long long)b * S + t - 1) * 3 * D + dchan + lane;
      v[4] = kp[0];
      v[5] = kp[D];
      v[6] = kp[2 * D];
    } else {
      v[4] = c0[chan0 + lane];
      v[5] = n0[chan0 + lane];
      v[6] = m0[chan0 + lane];
    }
    v[7] = dhs[((long long)b * S + t) * D + dchan + lane];
  };
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
#pragma unroll
    for (int k = 0; k < 8; ++k) in[u][k] = 0.f;
    load(in[u], S - 1 - u);
  }
  float* dp = dpre + (long long)b * S * 4 * D + dchan + lane;
  cluster_arrive();
  cluster_wait();

  for (int u0 = 0; u0 < S; u0 += kAhead) {
#pragma unroll
    for (int v = 0; v < kAhead; ++v) {
      const int u = u0 + v;  // reverse step: step t
      if (u >= S) break;
      const int t = S - 1 - u;
      if (u >= 1) {
        const int p = (u - 1) & 1;
        mbar_wait(&full[p], ((u - 1) >> 1) & 1);
        // its next use, step u + 1: its senders wait for this CTA's step u,
        // sent below, so it is armed before they send
        if (threadIdx.x == 0 && u + 1 < S) mbar_expect(&full[p], bytes);
        const float s = rows_sum<NR>(rr, &dbuf[p][0][0], lane);
        if (writes_dh) s_dh[el] = s;
        if (warp != 0) {
          asm volatile("bar.arrive 1, %0;\n" ::"r"(blockDim.x) : "memory");
          continue;
        }
        asm volatile("bar.sync 1, %0;\n" ::"r"(blockDim.x) : "memory");
      } else if (warp != 0) {
        continue;
      }
      // warp 0: the cell's backward at step t
      float g4[4] = {0.f, 0.f, 0.f, 0.f};
      if (cell) {
        const float* x = in[v];
        const float i_pre = x[0], f_pre = x[1];
        const float z = tanhf(x[2]);
        const float o = 1.f / (1.f + expf(-x[3]));
        const float c = x[4], n = x[5], m = x[6];
        const float fm = f_pre + m;
        const float m1 = fmaxf(fm, i_pre);
        const float ip = expf(i_pre - m1);
        const float fp = expf(fm - m1);
        const float c1 = fp * c + ip * z;
        const float nn = fp * n + ip;
        const float n1 = fmaxf(nn, 1e-6f);
        const float dh = (u >= 1 ? s_dh[lane] : dh_last) + x[7];
        const float d_ratio = dh * o;
        const float d_o = dh * (c1 / n1);
        const float dc1 = dc + d_ratio / n1;
        const float dnn = (dn - d_ratio * c1 / (n1 * n1)) * share(nn, 1e-6f);
        const float gi = (dc1 * z + dnn) * ip;
        const float gf = (dc1 * c + dnn * n) * fp;
        const float dm1 = dm - gi - gf;
        const float sh = share(fm, i_pre);
        g4[1] = gf + sh * dm1;
        g4[0] = gi + (1.f - sh) * dm1;
        g4[2] = dc1 * ip * (1.f - z * z);
        g4[3] = d_o * o * (1.f - o);
        dc = dc1 * fp;
        dn = dnn * fp;
        dm = g4[1];
#pragma unroll
        for (int g = 0; g < 4; ++g) dp[((long long)t * 4 + g) * D] = g4[g];
      }
      // into dbuf[u & 1] of every CTA, four channels of a gate a word
      const int p = u & 1;
      const uint32_t bar = smem_addr(&full[p]);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float v1 = __shfl_down_sync(kFull, g4[g], 1);
        const float v2 = __shfl_down_sync(kFull, g4[g], 2);
        const float v3 = __shfl_down_sync(kFull, g4[g], 3);
        if ((lane & 3) == 0 && lane < E) {
          const uint32_t at = smem_addr(&dbuf[p][g][rank * Ep + lane]);
          for (int q = 0; q < C; ++q)
            store_async(map_rank(at, q), g4[g], v1, v2, v3, map_rank(bar, q));
        }
      }
      if (cell) load(in[v], t - kAhead);
    }
  }
  // dh0: the product with the first step's dpre (reverse step S - 1)
  const int p = (S - 1) & 1;
  mbar_wait(&full[p], ((S - 1) >> 1) & 1);
  const float s = rows_sum<NR>(rr, &dbuf[p][0][0], lane);
  if (writes_dh) s_dh[el] = s;
  __syncthreads();
  if (cell) {
    dh0[chan0 + lane] = s_dh[lane];
    dc0[chan0 + lane] = dc;
    dn0[chan0 + lane] = dn;
    dm0[chan0 + lane] = dm;
  }
  // no CTA leaves while another may still write its buffers
  cluster_arrive();
  cluster_wait();
}

struct Args {
  const float* pre;
  const void* r;
  const float *c0, *n0, *m0, *cnm, *dhs, *dh_fin, *dc_fin, *dn_fin, *dm_fin;
  float *dpre, *dh0, *dc0, *dn0, *dm0;
  int B, S, H, hd, C, r_bf16;
};

template <int NR>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = slstm_scan_bwd_kernel<NR>;
  const int E = a.hd / a.C;
  const int threads = 32 * std::max(1, (E + kCPW - 1) / kCPW);
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C * a.H, a.B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&cfg, kernel, a.pre, a.r, a.c0, a.n0, a.m0, a.cnm,
                           a.dhs, a.dh_fin, a.dc_fin, a.dn_fin, a.dm_fin,
                           a.dpre, a.dh0, a.dc0, a.dn0, a.dm0, a.S, a.H, a.hd,
                           a.C, a.r_bf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pre, dpre: (B,S,4,D) float32; r: (4,H,hd,hd) float32 (r_bf16 == 0) or
// bfloat16; cnm: (B,S,3,D) float32 (the state after every step); dhs:
// (B,S,D) float32; c0, n0, m0, dh_fin, dc_fin, dn_fin, dm_fin, dh0, dc0,
// dn0, dm0: (B,D) float32; all contiguous.  hd as slstm_scan_launch takes.
extern "C" int slstm_scan_bwd_launch(
    const void* pre, const void* r, const void* c0, const void* n0,
    const void* m0, const void* cnm, const void* dhs, const void* dh_fin,
    const void* dc_fin, const void* dn_fin, const void* dm_fin, void* dpre,
    void* dh0, void* dc0, void* dn0, void* dm0, int B, int S, int H, int hd,
    int r_bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (hd <= 0 || hd > kMaxHd || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int C = 1;
  while (hd > 16 * kCPW * C) C *= 2;
  if (C > kMaxCluster || hd % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto F = [](const void* p) { return static_cast<const float*>(p); };
  const auto W = [](void* p) { return static_cast<float*>(p); };
  const Args a{F(pre),    r,       F(c0),     F(n0),     F(m0),   F(cnm),
               F(dhs),    F(dh_fin), F(dc_fin), F(dn_fin), F(dm_fin),
               W(dpre),   W(dh0),  W(dc0),    W(dn0),    W(dm0),  B,
               S,         H,       hd,        C,         r_bf16};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = C * ((hd / C + 3) & ~3);
  if (rows > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 64) return launch<2>(a, s);
  if (rows <= 128) return launch<4>(a, s);
  if (rows <= 192) return launch<6>(a, s);
  return launch<8>(a, s);
}

extern "C" const char* slstm_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
