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
// exchange of dpre, a step.  The chain is walked once for every cluster, so
// the clusters must all run at once: a second wave walks it again.
//
// Design: one wave of clusters, each serving one head and R rows of the
// batch, which share r.  A thread-block cluster of C CTAs (C the forward's:
// the least power of two with E = hd / C <= 32) serves a head and the rows
// [R y, R y + R) (grid (C H, ceil(B / R))).  R is the least of 1, 2 and 3
// for which the clusters fit on the card at once, by
// cudaOccupancyMaxActiveClusters, asked once a device, width and R (an
// H100 holds 15 clusters of 8 CTAs, so xLSTM's 8 rows of 4 heads take
// R = 3: 12 clusters), so a head's r is held once for R rows and the
// chain is walked once, not once a wave.
// CTA c owns the head's channels [c E, (c + 1) E) as rows d of r: a warp
// takes two of them, its lane l holds, for the slots l + 32 i of a row's
// dpre buffer (the 4 gates in turn), r[g, k, d, e] for its 2 rows in
// registers (converted to float32 once), and sums the slots' products for
// each of its 2 R (row d, batch row) pairs in turn before the warp folds
// the 2 R sums across its lanes (transposing shuffles, as the forward
// folds its sums): the same sums, in the same order, for any R.  The first
// R warps are also the cell warps (a CTA has at least R warps before the
// last: at hd 4, E 4 and R 3, the third sums nothing), warp w for batch
// row R y + w, lane e for channel e: before the step's dpre arrives they read the step's
// inputs from a ring in shared memory and run the cell's forward, off the
// chain; once the sums are in (a named barrier), the cell's backward gives
// the row's dpre_t, which the warp stages in shared memory and sends, a
// 16-byte word a lane (four channels of a gate), into the dpre buffer of
// every CTA of the cluster (st.async, counted on that CTA's mbarrier; the
// peers' addresses are mapped once, before the walk).  The buffer is
// double-buffered by the reverse step's parity.  A last warp keeps global
// memory and the mbarrier's arming off the chain: it waits for each step's
// buffer, re-arms its mbarrier for the step after next (before this CTA
// sends its part of the next step, which every sender of that step needs
// first), copies this CTA's channels of dpre from the buffer to global
// memory, and fills the input ring kAhead steps ahead (the
// pre-activations, the state before the step and the gradient of hs,
// loaded a step before they are stored).  After the first step (the last
// to walk) one more product gives dh0.  Every sum keeps one order, the
// same for any R, so two launches agree bit for bit.
#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHd = 256;        // the widest head
constexpr int kRowQ = 4 * kMaxHd;  // a row's (gate, position) slots
constexpr int kCPW = 2;            // rows of r (channels) a warp sums for
constexpr int kAhead = 4;          // steps the input ring is filled ahead
constexpr int kRing = kAhead + 1;
constexpr int kMaxCluster = 8;  // portable
constexpr int kMaxRows = 3;     // R

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// the least power of two at least x
__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

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

// the address of the same shared-memory byte in the cluster's CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// 16 bytes into the shared memory at addr of a CTA of the cluster, counted
// on that CTA's mbarrier at bar (both cluster addresses)
__device__ __forceinline__ void store_async(uint32_t addr, float4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
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

__device__ __forceinline__ void bar_arrive(int threads) {
  asm volatile("bar.arrive 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void bar_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// the share of max(x, y)'s gradient that goes to x
__device__ __forceinline__ float share(float x, float y) {
  return x > y ? 1.f : x < y ? 0.f : 0.5f;
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

// One step of the cell at a channel: its inputs (pre_i, pre_f, pre_z,
// pre_o, then c, n, m before the step) and what the backward reads
struct Fwd {
  float z, o, c, n, ip, fp, c1, n1, nn2, sh_n, sh_f;
};

__device__ __forceinline__ Fwd cell_forward(const float (&x)[7]) {
  Fwd f;
  const float i_pre = x[0], f_pre = x[1];
  f.z = tanhf(x[2]);
  f.o = 1.f / (1.f + expf(-x[3]));
  f.c = x[4];
  f.n = x[5];
  const float fm = f_pre + x[6];
  const float m1 = fmaxf(fm, i_pre);
  f.ip = expf(i_pre - m1);
  f.fp = expf(fm - m1);
  f.c1 = f.fp * f.c + f.ip * f.z;
  const float nn = f.fp * f.n + f.ip;
  f.n1 = fmaxf(nn, 1e-6f);
  f.nn2 = f.n1 * f.n1;
  f.sh_n = share(nn, 1e-6f);
  f.sh_f = share(fm, i_pre);
  return f;
}

// A row's slots in dbuf hold its dpre of one step: slot g Gs + j Ep + k is
// gate g of channel j E + k of the head (Ep = E rounded up to 4, so each
// CTA's part is whole 16-byte words; Gs = C Ep rounded up to 32, so a lane
// meets the gates in turn, each at the positions lane + 32 i); the rest
// stay zero.
template <int R>
struct alignas(16) Shared {
  float dbuf[2][R][kRowQ];      // by the reverse step's parity
  float ring[kRing][R][8][32];  // the cell's inputs of a step, by channel
  float stage[R][4][32];        // a cell warp's dpre before it is sent
  float dh[R][32];              // the step's sums: dh from the product
  uint64_t full[2];             // dbuf[p]'s arrivals
};

// the io warp, after the warps that sum (a warp for two of the E channels)
// and at least the R cell warps (at hd 4, E 4 and R 3, the third cell warp
// sums nothing)
__host__ __device__ constexpr int io_warp(int E, int R) {
  return (E + kCPW - 1) / kCPW > R ? (E + kCPW - 1) / kCPW : R;
}

// the most threads a CTA: a warp for two channels (at most 24 channels a
// CTA where C Ep is 129-192, 32 otherwise) and the io warp
__host__ __device__ constexpr int max_threads(int K64) {
  return 32 * ((K64 == 3 ? 24 : 32) / kCPW + 1);
}

// K64: slots of a gate in use (Gs) in 64s; R: rows a cluster
template <int K64, int R>
__global__ void __launch_bounds__(max_threads(K64), 1)
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
                      float* __restrict__ dm0, int B, int S, int H, int hd,
                      int C, int r_bf16) {
  constexpr int NQ = 8 * K64;  // slots a lane holds r for: 4 Gs / 32
  constexpr int KF = kCPW * R;  // sums a lane folds, padded to a power of 2
  constexpr int KP = pow2_at_least(KF);
  constexpr int kShift = 5 - log2i(KP);  // lane >> kShift: the sum it keeps
  __shared__ Shared<R> sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int threads = blockDim.x;
  const int rank = static_cast<int>(cluster_rank());
  const int head = blockIdx.x / C, b0 = blockIdx.y * R;
  const int E = hd / C;
  const int Ep = (E + 3) & ~3, Gs = (C * Ep + 31) & ~31;
  const long long D = (long long)H * hd;
  const int dchan = head * hd + rank * E;  // the CTA's first channel in D
  const int io = io_warp(E, R);            // the last warp; the rest sum

  // rr[j][i] = r[g, head, rank E + 2 warp + j, e] for the slot q = 32 i +
  // lane = g Gs + s Ep + k, e = s E + k; zero at padding or past E rows
  float rr[kCPW][NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int q = 32 * i + lane;
    const int g = q / Gs, pos = q % Gs, s = pos / Ep, k = pos % Ep;
    const int e = warp < io && g < 4 && s < C && k < E ? s * E + k : -1;
#pragma unroll
    for (int j = 0; j < kCPW; ++j) {
      const int el = warp * kCPW + j;
      rr[j][i] = e >= 0 && el < E
                     ? load_val(r,
                                (((long long)g * H + head) * hd + rank * E +
                                 el) * hd + e,
                                r_bf16)
                     : 0.f;
    }
  }
  for (int i = threadIdx.x; i < 2 * R * kRowQ; i += threads)
    (&sm.dbuf[0][0][0])[i] = 0.f;
  const int bytes = R * 4 * C * Ep * 4;  // a step's arrivals at each CTA
  if (threadIdx.x == 0) {
    mbar_init(&sm.full[0]);
    mbar_init(&sm.full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&sm.full[0], bytes);              // reverse step 0
    if (S >= 2) mbar_expect(&sm.full[1], bytes);  // reverse step 1
  }

  // The io warp, lane k < E: the inputs of step t for each row (pre_t, the
  // state before it, from the kept state or the initial one, and the
  // gradient of hs_t; zero for rows past B), into the ring's slot of its
  // reverse step u
  const auto load = [&](float (&v)[R][8], int t) {
#pragma unroll
    for (int w = 0; w < R; ++w) {
      const int b = b0 + w;
#pragma unroll
      for (int x = 0; x < 8; ++x) v[w][x] = 0.f;
      if (b >= B || lane >= E) continue;
      const float* pp = pre + ((long long)b * S + t) * 4 * D + dchan + lane;
#pragma unroll
      for (int g = 0; g < 4; ++g) v[w][g] = pp[g * D];
      if (t >= 1) {
        const float* kp =
            cnm + ((long long)b * S + t - 1) * 3 * D + dchan + lane;
        v[w][4] = kp[0];
        v[w][5] = kp[D];
        v[w][6] = kp[2 * D];
      } else {
        const long long at = (long long)b * D + dchan + lane;
        v[w][4] = c0[at];
        v[w][5] = n0[at];
        v[w][6] = m0[at];
      }
      v[w][7] = dhs[((long long)b * S + t) * D + dchan + lane];
    }
  };
  const auto put = [&](const float (&v)[R][8], int u) {
#pragma unroll
    for (int w = 0; w < R; ++w)
#pragma unroll
      for (int x = 0; x < 8; ++x) sm.ring[u % kRing][w][x][lane] = v[w][x];
  };
  // and its copy of this CTA's channels of a step's dpre, from dbuf[p] to
  // dpre at step t
  const auto take = [&](float (&v)[R][4], int p) {
#pragma unroll
    for (int w = 0; w < R; ++w)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        v[w][g] = lane < E ? sm.dbuf[p][w][g * Gs + rank * Ep + lane] : 0.f;
  };
  const auto give = [&](const float (&v)[R][4], int t) {
#pragma unroll
    for (int w = 0; w < R; ++w) {
      if (b0 + w >= B || lane >= E) continue;
      float* dp = dpre + ((long long)(b0 + w) * S + t) * 4 * D + dchan + lane;
#pragma unroll
      for (int g = 0; g < 4; ++g) dp[g * D] = v[w][g];
    }
  };
  float nxt[R][8];  // the io warp's loads for the step after the ring's
  if (warp == io) {
    for (int u = 0; u < kAhead && u < S; ++u) {
      load(nxt, S - 1 - u);
      put(nxt, u);
    }
    if (kAhead < S) load(nxt, S - 1 - kAhead);
  }

  // The cell warp w < R, row b0 + w, lane e for channel e.  It sends lane l
  // < Ep's word of its staged dpre (gate l / (Ep / 4), channels 4 (l % (Ep /
  // 4)) + 0..3) to every CTA q, at q's cluster address base[q] + the word's
  // offset (the peers' addresses mapped once)
  const bool cellw = warp < R;
  const int w = cellw ? warp : 0;
  const bool cell = cellw && b0 + w < B && lane < E;
  const uint32_t me = smem_addr(&sm);
  uint32_t base[kMaxCluster];
  int wg = 0, wk = 0;
  uint32_t woff = 0, foff = 0;
  if (cellw) {
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      base[q] = q < C ? map_rank(me, q) : 0u;
    wg = lane < Ep ? lane / (Ep / 4) : 0;
    wk = lane < Ep ? lane % (Ep / 4) : 0;
    woff = smem_addr(&sm.dbuf[0][w][wg * Gs + rank * Ep + 4 * wk]) - me;
    foff = smem_addr(&sm.full[0]) - me;
  }
  const uint32_t pstride = sizeof(sm.dbuf[0]);
  float dc = 0.f, dn = 0.f, dm = 0.f, dh_last = 0.f;
  if (cell) {
    const long long at = (long long)(b0 + w) * D + dchan + lane;
    dh_last = dh_fin[at];
    dc = dc_fin[at];
    dn = dn_fin[at];
    dm = dm_fin[at];
  }
  // A summing warp's product of its two rows of r with the R rows of dpre
  // in dbuf[p] (lane l sums its slots in turn, then the warp folds the
  // 2 R sums across its lanes), into sm.dh
  const auto product = [&](int p) {
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
#pragma unroll
      for (int v = 0; v < R; ++v) {
        const float d = sm.dbuf[p][v][32 * i + lane];
#pragma unroll
        for (int j = 0; j < kCPW; ++j)
          acc[j * R + v] = fmaf(d, rr[j][i], acc[j * R + v]);
      }
    }
    const float s = fold_lanes<KP>(acc, lane);
    const int idx = lane >> kShift, el = warp * kCPW + idx / R;
    if ((lane & ((1 << kShift) - 1)) == 0 && idx < KF && el < E)
      sm.dh[idx % R][el] = s;
  };
  // every CTA of the cluster has started and set its buffers
  cluster_arrive();
  cluster_wait();

  for (int u = 0; u < S; ++u) {  // reverse step u: step t
    const int t = S - 1 - u;
    const int p = (u - 1) & 1;  // dbuf[p]: step u - 1's dpre
    const unsigned phase = ((u - 1) >> 1) & 1;
    if (warp == io) {
      if (u >= 1) {
        mbar_wait(&sm.full[p], phase);
        // its next use, step u + 1: its senders wait for this CTA's step u,
        // sent after the barrier below, so it is armed before they send
        if (lane == 0 && u + 1 < S) mbar_expect(&sm.full[p], bytes);
        float v[R][4];
        take(v, p);  // read before the barrier lets dbuf[p] be refilled
        bar_arrive(threads);
        give(v, t + 1);
      }
      // the ring: the inputs of step u + kAhead (loaded at the last step)
      // in, into the slot of step u - 1, whose dpre this warp has seen
      if (u + kAhead < S) {
        put(nxt, u + kAhead);
        if (u + kAhead + 1 < S) load(nxt, t - kAhead - 1);
      }
      continue;
    }
    Fwd f;
    float dhs_t = 0.f;
    if (cellw) {  // the step's inputs and the cell's forward, off the chain
      float x[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) x[k] = sm.ring[u % kRing][w][k][lane];
      dhs_t = sm.ring[u % kRing][w][7][lane];
      f = cell_forward(x);
    }
    float dh = dh_last;
    if (u >= 1) {
      mbar_wait(&sm.full[p], phase);
      product(p);
      // the sums meet the cell warps; the other warps go on to wait for
      // step u's dpre (their next writes of sm.dh wait for it too)
      if (!cellw) {
        bar_arrive(threads);
        continue;
      }
      bar_sync(threads);
      dh = sm.dh[w][lane];
    } else if (!cellw) {
      continue;
    }
    // the cell warp: the cell's backward at step t
    float g4[4] = {0.f, 0.f, 0.f, 0.f};
    if (cell) {
      dh += dhs_t;
      const float d_ratio = dh * f.o;
      const float d_o = dh * (f.c1 / f.n1);
      const float dc1 = dc + d_ratio / f.n1;
      const float dnn = (dn - d_ratio * f.c1 / f.nn2) * f.sh_n;
      const float gi = (dc1 * f.z + dnn) * f.ip;
      const float gf = (dc1 * f.c + dnn * f.n) * f.fp;
      const float dm1 = dm - gi - gf;
      g4[1] = gf + f.sh_f * dm1;
      g4[0] = gi + (1.f - f.sh_f) * dm1;
      g4[2] = dc1 * f.ip * (1.f - f.z * f.z);
      g4[3] = d_o * f.o * (1.f - f.o);
      dc = dc1 * f.fp;
      dn = dnn * f.fp;
      dm = g4[1];
    }
    // into dbuf[u & 1] of every CTA: staged, then a 16-byte word a lane
    __syncwarp();  // the last step's words are read
    if (lane < Ep) {
#pragma unroll
      for (int g = 0; g < 4; ++g) sm.stage[w][g][lane] = g4[g];
    }
    __syncwarp();
    if (lane < Ep) {
      const float4 v =
          *reinterpret_cast<const float4*>(&sm.stage[w][wg][4 * wk]);
      const uint32_t at = woff + (u & 1) * pstride, bar = foff + (u & 1) * 8;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < C) store_async(base[q] + at, v, base[q] + bar);
    }
  }
  // dh0: the product with the first step's dpre (reverse step S - 1)
  const int p = (S - 1) & 1;
  mbar_wait(&sm.full[p], ((S - 1) >> 1) & 1);
  if (warp == io) {
    float v[R][4];
    take(v, p);
    give(v, 0);
  } else {
    product(p);
  }
  __syncthreads();
  if (cell) {
    const long long at = (long long)(b0 + w) * D + dchan + lane;
    dh0[at] = sm.dh[w][lane];
    dc0[at] = dc;
    dn0[at] = dn;
    dm0[at] = dm;
  }
  // no CTA leaves while another may still write its buffers
  __syncwarp();
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

template <int K64>
const void* kernel_rows(int R) {
  switch (R) {
    case 1: return (const void*)slstm_scan_bwd_kernel<K64, 1>;
    case 2: return (const void*)slstm_scan_bwd_kernel<K64, 2>;
    default: return (const void*)slstm_scan_bwd_kernel<K64, 3>;
  }
}

// the kernel of K64 (a gate's slots in 64s) and R rows a cluster
const void* kernel_for(int K64, int R) {
  switch (K64) {
    case 1: return kernel_rows<1>(R);
    case 2: return kernel_rows<2>(R);
    case 3: return kernel_rows<3>(R);
    default: return kernel_rows<4>(R);
  }
}

int threads_for(const Args& a, int R) {
  return 32 * (io_warp(a.hd / a.C, R) + 1);
}

// The launch of R rows a cluster: ceil(B / R) row groups of H clusters of
// C CTAs (attr holds the cluster's shape)
cudaLaunchConfig_t config(const Args& a, int R, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C * a.H, (a.B + R - 1) / R);
  cfg.blockDim = dim3(threads_for(a, R));
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of R rows the current device holds at once
// (cudaOccupancyMaxActiveClusters), asked once a (device, hd, R): it
// depends on nothing else
constexpr int kMaxDevices = 16;
std::atomic<int> g_active[kMaxDevices][kMaxHd + 1][kMaxRows];  // 0: not asked

int active_clusters(const Args& a, int K64, int R, int* active) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::atomic<int>* known =
      dev < kMaxDevices ? &g_active[dev][a.hd][R - 1] : nullptr;
  if (known != nullptr && (*active = known->load()) > 0) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(a, R, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(active, kernel_for(K64, R), &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (known != nullptr) known->store(*active);
  return 0;
}

// R, the least of 1 to kMaxRows for which the ceil(B / R) H clusters fit
// on the card at once, else kMaxRows (the fewest waves); launched, or with
// plan not null nothing launched and plan = {C, R, clusters launched,
// clusters the card holds at once, threads a CTA}
int run(const Args& a, cudaStream_t stream, int* plan) {
  // slots of a gate in use: C slots of E rounded up to 4, rounded up to 32
  const int slots = (a.C * ((a.hd / a.C + 3) & ~3) + 31) & ~31;
  const int K64 = (slots + 63) / 64;
  if (slots > kMaxHd || threads_for(a, kMaxRows) > max_threads(K64))
    return static_cast<int>(cudaErrorInvalidValue);
  int R = 1, active = 0;
  for (;; ++R) {
    const int err = active_clusters(a, K64, R, &active);
    if (err != 0) return err;
    if (R == kMaxRows || R >= a.B || (a.B + R - 1) / R * a.H <= active)
      break;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(a, R, stream, &attr);
  if (plan != nullptr) {
    plan[0] = a.C;
    plan[1] = R;
    plan[2] = (a.B + R - 1) / R * a.H;
    plan[3] = active;
    plan[4] = static_cast<int>(cfg.blockDim.x);
    return 0;
  }
  void* args[] = {(void*)&a.pre,    (void*)&a.r,      (void*)&a.c0,
                  (void*)&a.n0,     (void*)&a.m0,     (void*)&a.cnm,
                  (void*)&a.dhs,    (void*)&a.dh_fin, (void*)&a.dc_fin,
                  (void*)&a.dn_fin, (void*)&a.dm_fin, (void*)&a.dpre,
                  (void*)&a.dh0,    (void*)&a.dc0,    (void*)&a.dn0,
                  (void*)&a.dm0,    (void*)&a.B,      (void*)&a.S,
                  (void*)&a.H,      (void*)&a.hd,     (void*)&a.C,
                  (void*)&a.r_bf16};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel_for(K64, R), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the cluster size: the forward's (the least power of two with hd / C at
// most 32), or 0 where hd is not taken
int cluster_size(int hd) {
  if (hd <= 0 || hd > kMaxHd) return 0;
  int C = 1;
  while (hd > 32 * C) C *= 2;
  return C <= kMaxCluster && hd % C == 0 ? C : 0;
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
  const int C = cluster_size(hd);
  if (C == 0 || B > 65535 * kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto F = [](const void* p) { return static_cast<const float*>(p); };
  const auto W = [](void* p) { return static_cast<float*>(p); };
  const Args a{F(pre),    r,       F(c0),     F(n0),     F(m0),   F(cnm),
               F(dhs),    F(dh_fin), F(dc_fin), F(dn_fin), F(dm_fin),
               W(dpre),   W(dh0),  W(dc0),    W(dn0),    W(dm0),  B,
               S,         H,       hd,        C,         r_bf16};
  return run(a, static_cast<cudaStream_t>(stream), nullptr);
}

// The launch plan of B rows of H heads of width hd on the current device:
// plan[5] = {C, R, clusters launched, clusters the card holds at once,
// threads a CTA}; launches nothing
extern "C" int slstm_scan_bwd_plan(int B, int H, int hd, int* plan) {
  const int C = cluster_size(hd);
  if (B <= 0 || H <= 0 || C == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.B = B;
  a.S = 1;
  a.H = H;
  a.hd = hd;
  a.C = C;
  return run(a, nullptr, plan);
}

extern "C" const char* slstm_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
