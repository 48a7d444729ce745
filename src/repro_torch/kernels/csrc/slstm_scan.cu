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
// their own type added in float32 after the product.  It writes h for
// every step (B,S,D) float32 and the final (h, c, n, m); under a gradient
// (cnm not null, a separate instantiation, so serving runs the same code
// as without it) also (c, n, m) after every step (B,S,3,D) float32, which
// slstm_scan_bwd.cu reads.
//
// Bound on this card: the serial chain of S steps, not bytes or
// operations.  A step of one head multiplies h by four hd x hd blocks
// (at xLSTM-125M's width, 4 heads of 192: 147,456 multiply-adds) and
// cannot start before the last step's h; the whole run moves only xg, h
// and r once (a 4,096-token prompt: 25 MB of bf16 gates, 0.0075 ms at
// 3.35 TB/s), so a step's least time is set by latency: its products,
// a reduction across lanes, the cell, and the exchange of h.
//
// Design: a thread-block cluster of C CTAs a (b, head), on C neighbouring
// SMs (grid (C * H, B), launched with cudaLaunchKernelEx and the cluster
// dimension).  CTA c owns the head's channels [c E, (c + 1) E), E = hd / C,
// for all four gates, so no partial sum crosses CTAs and each dot product
// over d stays whole in one warp.  A warp takes two channels (8 sums: 4
// gates x 2); its lane l takes the rows at positions l + 32 i of the h
// buffer, and holds those rows of its channels' eight columns of r in
// registers, converted to float32 once at the start (at xLSTM's width, C =
// 8: 24 channels a CTA in 12 warps, 48 floats of r a lane), so r is read
// from global memory once and never unpacked again.  A step: every lane
// reads its rows of h from shared memory and folds them into its 8 partial
// sums, and the warp reduces them across its 32 lanes in 9 shuffles (a
// transposing reduction: each exchange hands the partner the half of the
// sums it does not keep); each (channel, gate) sum goes to shared memory.
// Warp 0 waits for them at a named barrier (the other warps only arrive
// there) and runs the cell, lane e for channel e, with the gate inputs it
// loaded kAhead steps before (kept as raw bits until used, so no
// conversion waits for a load on the chain).  It then stores the new h,
// four channels a 16-byte st.async, into the h buffer of every CTA of the
// cluster through distributed shared memory (mapa + st.async), each store
// counted on the receiving CTA's mbarrier.  The buffer is double-buffered
// by step parity: every thread waits on its own CTA's mbarrier for the
// phase of h_t, so no cluster-wide barrier, and no release fence, is on the
// chain; a buffer is re-armed for h_{t+2} before this CTA sends its part of
// h_{t+1}, which every sender of h_{t+2} needs first.  Rows of the buffer
// are C slots of E rounded up to 4 channels, the padding zero in h and r.
// Warp 1 writes h_t, from the registers it read it into, to hs at step t;
// no global store or load stalls warp 0's chain.  The sums stay float32
// products of the float32 state and r, as the reference's, in the same
// order in every run.
//
// The cluster size: the least power of two with E = hd / C <= 32 (at most
// 16 warps, 512 threads, so 128 registers a thread hold r): C = 8 at
// xLSTM's 192 (and 256), 4 at 128, 2 at 64, 1 at 32 and below, all
// portable sizes.  The least, since a step's time is its chain's latency,
// not its products (PERF.md has a step's time from the slope over 1, 2 and
// 64 steps): more CTAs would share the products and widen the exchange.
#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHd = 256;       // the widest head: one h buffer's floats
constexpr int kMaxThreads = 512;  // 128 registers a thread
constexpr int kAhead = 4;         // steps of gate inputs a lane has in flight
constexpr int kMaxCluster = 8;   // portable
constexpr int kCPW = 2;           // channels a warp

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

// the address of the same shared-memory word in the cluster's CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// 16 bytes into the shared memory at addr of a CTA of the cluster, counted
// on that CTA's mbarrier at bar (both cluster addresses)
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

// the barrier's next phase completes once `bytes` have arrived
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the completion of the barrier's phase of the given parity
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

// The sum over the warp's lanes of each of a lane's K values, K a power of
// two up to 32: while a lane keeps more than one, an exchange at offset o
// hands the partner the half it does not keep (lanes with bit o set keep
// the upper half), so K - 1 + 5 - log2 K shuffles in all; then lane l
// holds the sum of value l >> (5 - log2 K), every lane of a value alike.
template <int K>
__device__ __forceinline__ float fold_lanes(float (&v)[K], int lane) {
  int off = 16;
#pragma unroll
  for (int half = K / 2; half >= 1; half /= 2, off /= 2) {
    const bool up = lane & off;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float keep = up ? v[j + half] : v[j];
      const float send = up ? v[j] : v[j + half];
      v[j] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  float s = v[0];
#pragma unroll
  for (; off >= 1; off /= 2) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// the gate inputs' raw bits, kept as loaded until used: a conversion right
// after the load would wait for it on the chain
template <typename XT>
struct Raw {
  using T = float;
  static __device__ __forceinline__ float value(float v) { return v; }
};
template <>
struct Raw<bf16> {
  using T = unsigned short;
  static __device__ __forceinline__ float value(unsigned short v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
};

// NR: rows of r a lane holds a column (the hbuf positions in use <= 32 NR);
// kKeep: write (c, n, m) after every step to cnm
template <int NR, typename XT, bool kKeep>
__global__ void __launch_bounds__(kMaxThreads, 1)
slstm_scan_kernel(const XT* __restrict__ xg, const void* __restrict__ r,
                  const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ hs, float* __restrict__ h_fin,
                  float* __restrict__ c_fin, float* __restrict__ n_fin,
                  float* __restrict__ m_fin, float* __restrict__ cnm, int S,
                  int H, int hd, int C, int r_bf16) {
  using XR = typename Raw<XT>::T;
  constexpr int K = 4 * kCPW;  // sums a lane folds: 4 gates x 2 channels
  constexpr int kShift = 2;    // lane >> kShift: the sum it ends with
  __shared__ __align__(16) float hbuf[2][kMaxHd];
  // hbuf[p]'s arrivals: h_t lies in hbuf[t & 1], complete at phase
  // (t - 1) >> 1 of full[t & 1] (t >= 1; h_0 is set here)
  __shared__ __align__(8) uint64_t full[2];
  __shared__ float pre[4][32];  // the step's recurrent sums, gate x channel
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(cluster_rank());
  const int head = blockIdx.x / C, b = blockIdx.y;
  const int E = hd / C;  // channels of this CTA, at most 32
  // h lies in hbuf as C slots of Ep = E rounded up to 4 (16 bytes), so a
  // CTA sends its channels' h as whole 16-byte words: channel d of the
  // head at position (d / E) Ep + d % E, the rest zero
  const int Ep = (E + 3) & ~3;
  const long long D = (long long)H * hd;
  const long long head0 = (long long)b * D + (long long)head * hd;
  const long long chan0 = head0 + rank * E;  // the CTA's first channel

  // rr[j][g][i] = r[g, head, d, rank E + 2 warp + j] for the row d at
  // position lane + 32 i of hbuf, zero at padding or past E channels; own:
  // which of the lane's positions is a channel of this CTA (-1: none)
  float rr[kCPW][4][NR];
  int own = -1;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int pos = lane + 32 * i, q = pos / Ep, k = pos % Ep;
    const int d = q < C && k < E ? q * E + k : -1;
    if (q == rank && k < E) own = i;
#pragma unroll
    for (int j = 0; j < kCPW; ++j) {
      const int el = warp * kCPW + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        rr[j][g][i] = el < E && d >= 0
                          ? load_val(r,
                                     (((long long)g * H + head) * hd + d) * hd +
                                         rank * E + el,
                                     r_bf16)
                          : 0.f;
    }
  }
  // after the fold, lane l holds the sum of channel 2 warp + l / 16, gate
  // (l / 4) % 4; the first lane of each writes it
  const int idx = lane >> kShift;
  const int el = warp * kCPW + (idx >> 2);
  const bool writes_pre = el < E && (lane & ((1 << kShift) - 1)) == 0;
  // warp 0 runs the cell, lane e for channel e of the CTA
  const bool cell = warp == 0 && lane < E;
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f;
  if (cell) {
    h = h0[chan0 + lane];
    c = c0[chan0 + lane];
    n = n0[chan0 + lane];
    m = m0[chan0 + lane];
  }
  for (int pos = threadIdx.x; pos < kMaxHd; pos += blockDim.x) {
    const int q = pos / Ep, k = pos % Ep;
    hbuf[0][pos] = q < C && k < E ? h0[head0 + q * E + k] : 0.f;
    hbuf[1][pos] = 0.f;
  }
  const int bytes = C * Ep * 4;  // a step's arrivals at each CTA
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (S >= 2) mbar_expect(&full[1], bytes);  // h_1
    if (S >= 3) mbar_expect(&full[0], bytes);  // h_2
  }
  // the cell lane's gate inputs at step t: xg[b, t, g, head hd + rank E +
  // lane], kAhead steps in flight
  const XT* xp = xg + (long long)b * S * 4 * D + (chan0 - (long long)b * D) +
                 lane;
  const long long xstep = 4 * D;
  XR xq[kAhead][4];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xq[u][g] = cell && u < S
                     ? reinterpret_cast<const XR*>(xp)[u * xstep + g * D]
                     : XR(0);
  // hs[b, t, head hd + rank E + e]: h_t lands in every CTA's hbuf, so warp
  // 1 writes row t - 1 at step t from its registers; warp 0 the last row
  float* hrow = hs + (long long)b * S * D + (chan0 - (long long)b * D);
  // every CTA of the cluster has started and set its buffers
  cluster_arrive();
  cluster_wait();

  for (int t0 = 0; t0 < S; t0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u;
      if (t >= S) break;
      if (t >= 1) {
        mbar_wait(&full[t & 1], ((t - 1) >> 1) & 1);
        // the next use of this buffer, h_{t+2}: its senders wait for this
        // warp's h_{t+1}, sent below, so it is armed before they send
        if (threadIdx.x == 0 && t + 2 < S) mbar_expect(&full[t & 1], bytes);
      }
      const float* hp = hbuf[t & 1];
      float hv[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) hv[i] = hp[lane + 32 * i];
      float acc[K];
#pragma unroll
      for (int j = 0; j < kCPW; ++j) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < NR; ++i) s = fmaf(hv[i], rr[j][g][i], s);
          acc[4 * j + g] = s;
        }
      }
      const float sum = fold_lanes<K>(acc, lane);
      if (writes_pre) pre[idx & 3][el] = sum;
      // the sums meet warp 0; the other warps go on to wait for h_{t+1}
      // (their next writes of pre wait for it too, so pre is not overwritten
      // before warp 0 has read it)
      if (warp != 0) {
        asm volatile("bar.arrive 1, %0;\n" ::"r"(blockDim.x) : "memory");
        if (warp == 1 && t >= 1 && own >= 0) {
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < NR; ++i) v = i == own ? hv[i] : v;
          hrow[(long long)(t - 1) * D + lane + 32 * own - rank * Ep] = v;
        }
        continue;
      }
      asm volatile("bar.sync 1, %0;\n" ::"r"(blockDim.x) : "memory");
      if (cell) {
        const float i_pre = pre[0][lane] + Raw<XT>::value(xq[u][0]);
        const float f_pre = pre[1][lane] + Raw<XT>::value(xq[u][1]);
        const float z = tanhf(pre[2][lane] + Raw<XT>::value(xq[u][2]));
        const float o =
            1.f / (1.f + expf(-(pre[3][lane] + Raw<XT>::value(xq[u][3]))));
        const float m1 = fmaxf(f_pre + m, i_pre);
        const float ip = expf(i_pre - m1);
        const float fp = expf(f_pre + m - m1);
        c = fp * c + ip * z;
        n = fmaxf(fp * n + ip, 1e-6f);
        m = m1;
        h = o * (c / n);
        if (kKeep) {  // cnm[b, t, k, head hd + rank E + lane]
          float* kp = cnm + ((long long)b * S + t) * 3 * D +
                      (chan0 - (long long)b * D) + lane;
          kp[0] = c;
          kp[D] = n;
          kp[2 * D] = m;
        }
      }
      if (t + 1 < S) {  // into hbuf[(t + 1) & 1] of every CTA, 4 channels
        const float h1 = __shfl_down_sync(kFull, h, 1);  // to a 16-byte word
        const float h2 = __shfl_down_sync(kFull, h, 2);
        const float h3 = __shfl_down_sync(kFull, h, 3);
        if ((lane & 3) == 0 && lane < E) {
          const int p = (t + 1) & 1;
          const uint32_t at = smem_addr(&hbuf[p][rank * Ep + lane]);
          const uint32_t bar = smem_addr(&full[p]);
          for (int q = 0; q < C; ++q)
            store_async(map_rank(at, q), h, h1, h2, h3, map_rank(bar, q));
        }
      }
      if (cell && t + kAhead < S) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          xq[u][g] = reinterpret_cast<const XR*>(
              xp)[(long long)(t + kAhead) * xstep + g * D];
      }
    }
  }
  // no CTA leaves while another may still write its buffers
  __syncwarp();
  cluster_arrive();
  cluster_wait();
  if (cell) {
    hrow[(long long)(S - 1) * D + lane] = h;
    h_fin[chan0 + lane] = h;
    c_fin[chan0 + lane] = c;
    n_fin[chan0 + lane] = n;
    m_fin[chan0 + lane] = m;
  }
}

struct Args {
  const void *xg, *r;
  const float *h0, *c0, *n0, *m0;
  float *hs, *h_fin, *c_fin, *n_fin, *m_fin, *cnm;
  int B, S, H, hd, C, r_bf16;
};

template <int NR, typename XT>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = a.cnm ? slstm_scan_kernel<NR, XT, true>
                      : slstm_scan_kernel<NR, XT, false>;
  const int E = a.hd / a.C;
  // a warp for two channels, and at least two warps (warp 1 writes hs)
  const int threads = 32 * std::max(2, (E + kCPW - 1) / kCPW);
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
  // at least one cluster must fit on the card (the rest run in waves: the
  // clusters do not wait on each other)
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(a.xg), a.r,
                           a.h0, a.c0, a.n0, a.m0, a.hs, a.h_fin, a.c_fin,
                           a.n_fin, a.m_fin, a.cnm, a.S, a.H, a.hd, a.C,
                           a.r_bf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int launch_rows(const Args& a, cudaStream_t stream) {
  // positions of hbuf in use: C slots of E rounded up to 4
  const int rows = a.C * ((a.hd / a.C + 3) & ~3);
  if (rows > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 64) return launch<2, XT>(a, stream);
  if (rows <= 128) return launch<4, XT>(a, stream);
  if (rows <= 192) return launch<6, XT>(a, stream);
  return launch<8, XT>(a, stream);
}

}  // namespace

// xg: (B,S,4,D) float32 (xg_bf16 == 0) or bfloat16; r: (4,H,hd,hd) float32
// (r_bf16 == 0) or bfloat16; h0, c0, n0, m0, h_fin, c_fin, n_fin, m_fin:
// (B,D) float32; hs: (B,S,D) float32; cnm: null, or (B,S,3,D) float32; all
// contiguous.  hd at most 256 and a multiple of its cluster size C, the
// least power of two with hd / C at most 32.
extern "C" int slstm_scan_launch(const void* xg, const void* r, const void* h0,
                                 const void* c0, const void* n0,
                                 const void* m0, void* hs, void* h_fin,
                                 void* c_fin, void* n_fin, void* m_fin,
                                 void* cnm, int B, int S, int H, int hd,
                                 int xg_bf16, int r_bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (hd <= 0 || hd > kMaxHd || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int C = 1;
  while (hd > 16 * kCPW * C) C *= 2;
  if (C > kMaxCluster || hd % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{xg,
               r,
               static_cast<const float*>(h0),
               static_cast<const float*>(c0),
               static_cast<const float*>(n0),
               static_cast<const float*>(m0),
               static_cast<float*>(hs),
               static_cast<float*>(h_fin),
               static_cast<float*>(c_fin),
               static_cast<float*>(n_fin),
               static_cast<float*>(m_fin),
               static_cast<float*>(cnm),
               B,
               S,
               H,
               hd,
               C,
               r_bf16};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return xg_bf16 ? launch_rows<bf16>(a, s) : launch_rows<float>(a, s);
}

extern "C" const char* slstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
