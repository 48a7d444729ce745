// Flash attention forward on Hopper (sm_90a): causal, full or windowed
// grouped-query softmax attention with an online-softmax (m, l, acc) state
// in float32.
//
// Replaces the TPU kernel repro/kernels/flash_attn.py:flash_attention_pallas
// (body _flash_kernel) and, on the serving path, the lax.scan form
// repro/models/attention.py:_flash_attention that computes the same
// function.  For q (B,S,H,hd) and k, v (B,S,KV,hd), H a multiple of KV:
//   out[b,i,h] = sum_j softmax_j(scale * q[b,i,h] . k[b,j,g]) v[b,j,g]
// with g = h / (H/KV) (grouped-query attention by indexing, not by
// repeating K/V in memory), over the keys j that the mask keeps: j < S,
// j <= i when causal, j > i - window when window > 0.  Masked entries weigh
// exactly 0, so a row with no kept key yet carries (m, l, acc) =
// (-1e30, 0, 0), and the output is acc / max(l, 1e-30), as in the Pallas
// kernel.  Tiles above the diagonal or wholly before the window are not
// visited; a ragged S is masked in the kernel.
//
// Bound on this card: operations.  Under the causal mask the function
// needs 4*S*S*H*hd/2 operations against q, k, v and out read or written
// once: at S=4096, H=32, KV=8, hd=64, bf16 that is 68.7 GFLOP and 41.9 MB,
// 0.0695 ms at the bf16 tensor-core rate (989 TFLOP/s), 0.0125 ms of
// memory.  So the design's question is how much of the tensor-core rate
// it reaches.
//
// bfloat16 inputs (flash_attn_bf16_kernel, the serving path): FA2 style on
// mma.sync.m16n8k16 (bf16 in, float32 accumulate).  One CTA of 4 warps per
// (b, h, 64-query tile), the query tiles in the grid's slowest dimension
// and issued last-first, so every head's longest causal rows start first.
// Each warp owns 16 query rows; its Q fragments are read once with
// ldmatrix and stay in registers.  K and V tiles of 64 keys stay bf16 in
// shared memory (rows padded by 16 bytes: ldmatrix is conflict-free) in a
// ring of two stages filled by cp.async, so the next tile's load overlaps
// this tile's math (ragged rows are zero-filled by the copy).
// S = Q.K^T: products of bf16 values are exact in float32, so this is the
// reference's float32 dot product in another summation order.  The mask,
// running max, exp2 and running sums work on the accumulator fragments in
// registers; a row's four lanes (a quad) reduce with two xor-shuffles.
// P.V keeps P at near-float32 precision: P = hi + lo with hi = bf16(P) and
// lo = bf16(P - hi), two mma against V fragments read with
// ldmatrix.trans (V in bf16 is exact), so the sum carries P to about 2^-17
// where a single bf16 P would round each weight to 2^-9, as large as the
// tolerance at long S.  That costs half again the tensor work of a single
// bf16 P.V; what bounds this design is mma.sync's rate (below wgmma's) and
// the softmax between the two products, which 4 warps do not hide.
// At hd 256 (RecurrentGemma's heads) one warp's float32 accumulators for
// 16 rows x 256 columns would take 128 registers a lane before the score
// tile, and the build spilled; so the CTA has 8 warps, two sets of 4 that
// split hd in halves for P.V (64 registers of accumulators a lane), each
// set computing the whole score tile and softmax for its rows (Q.K^T, a
// third of the tensor work, done twice), and each k-step's Q fragment is
// read from shared memory instead of held in registers.  The tiles take
// 165 KB of shared memory (Q and two stages of K and V, opted in above
// 48 KB), one CTA an SM.
//
// float32 inputs (flash_attn_f32_kernel): float32 multiply-adds on the
// CUDA cores, no TF32 anywhere (its 2e-5 tolerance holds only in full
// float32).  One block of 128 threads per (b, h, 64-query tile), the query
// tiles issued last-first.  The Q tile is staged once in shared memory; a
// loop walks the 64-key tiles from the window's first tile up to the
// diagonal (all of them when not causal), staging K and V in shared
// memory.  Each thread owns 4 query rows x 8 key columns of the score tile
// (rows 4r..4r+3, columns c, c+8, ..., c+56, with r = tid/8 and c = tid%8,
// so the 8 lanes of a row group sit in one aligned group of 8 and reduce
// with three xor-shuffles) and the same 4 rows x hd/8 columns of the
// output accumulator in registers.  Score dot products read float4s along
// hd (rows padded to hd+4 floats: conflict-free); P goes through shared
// memory for the P.V product.  It is bound by shared-memory reads (three
// 16-byte loads for 32 multiply-adds).  At hd 256 its tiles take 211 KB of
// shared memory and its loops are not unrolled (the accumulators fill the
// registers).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;  // query rows a block
constexpr int kBK = 64;  // keys a tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// first key tile a query tile visits: 0, or the window's first tile
__device__ __forceinline__ int first_kv_tile(int q0, int window) {
  if (window <= 0) return 0;
  const int kv_begin = max(0, q0 - window + 1);
  return kv_begin - kv_begin % kBK;
}

// -- float32: the CUDA-core body ---------------------------------------------

template <int D>
constexpr size_t smem_floats() {
  // Q and K tiles padded to D+4, the V tile, the P tile padded to kBK+4
  return (size_t)kBQ * (D + 4) + (size_t)kBK * (D + 4) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int S, int H, int KV, float scale, int causal,
                      int window) {
  constexpr int kQS = D + 4;    // Q/K row stride (floats), 16-byte aligned
  constexpr int kPS = kBK + 4;  // P row stride
  constexpr int kCols = D / 8;  // output columns a thread
  constexpr int kVec = kCols < 4 ? kCols : 4;
  constexpr int kGroups = kCols / kVec;
  // loop unrolling: 2 up to hd 128; 1 at hd 256, whose 4 x 32 float32
  // accumulators leave no registers for a second iteration's loads
  constexpr int kUnroll = D > 128 ? 1 : 2;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * kQS;
  float* Vs = Ks + kBK * kQS;
  float* Ps = Vs + kBK * D;

  const int tid = threadIdx.x;
  const int r = tid >> 3;  // rows 4r..4r+3 of the tile
  const int c = tid & 7;   // score columns c + 8j; output columns below
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const long long qstride = (long long)H * D;  // between sequence positions
  const long long kstride = (long long)KV * D;
  const float* qb = q + (long long)b * S * qstride + (long long)h * D;
  const float* kb = k + (long long)b * S * kstride + (long long)g * D;
  const float* vb = v + (long long)b * S * kstride + (long long)g * D;
  float* ob = out + (long long)b * S * qstride + (long long)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int row = i / D, d = i % D, pos = q0 + row;
    Qs[row * kQS + d] = pos < S ? qb[pos * qstride + d] : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[i][e] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  // tiles wholly before every row's window are skipped
  for (int k0 = first_kv_tile(q0, window); k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with Vs and Ps
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int row = i / D, d = i % D, pos = k0 + row;
      float kx = 0.f, vx = 0.f;
      if (pos < S) {
        kx = kb[pos * kstride + d];
        vx = vb[pos * kstride + d];
      }
      Ks[row * kQS + d] = kx;
      Vs[row * D + d] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll(kUnroll)
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * r + i) * kQS + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(c + 8 * j) * kQS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, running max, weights, running sums
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * r + i;
      unsigned kept = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + c + 8 * j;
        const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        kept |= ok ? 1u << j : 0u;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (kept >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        Ps[(4 * r + i) * kPS + c + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    // acc += P . V over the tile's keys; output column of acc[i][gi*kVec+e]
    // is gi*8*kVec + c*kVec + e
#pragma unroll(kUnroll)
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(4 * r + i) * kPS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * D + c * kVec;
        float vv[kCols];
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          if constexpr (kVec == 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(vrow + gi * 8 * kVec);
            vv[gi * 4 + 0] = t.x;
            vv[gi * 4 + 1] = t.y;
            vv[gi * 4 + 2] = t.z;
            vv[gi * 4 + 3] = t.w;
          } else {
            const float2 t =
                *reinterpret_cast<const float2*>(vrow + gi * 8 * kVec);
            vv[gi * 2 + 0] = t.x;
            vv[gi * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0   ? pv[i].x
                          : jj == 1 ? pv[i].y
                          : jj == 2 ? pv[i].z
                                    : pv[i].w;
#pragma unroll
          for (int e = 0; e < kCols; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * r + i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = ob + qpos * qstride + c * kVec;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        orow[gi * 8 * kVec + e] = acc[i][gi * kVec + e] / den;
  }
}


// -- bfloat16: the tensor-core body -------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
struct Bf16Tile {
  static constexpr int kStride = D + 8;  // bf16 a row: 16 bytes of padding
  static constexpr int kElems = kBQ * kStride;  // one 64-row tile
  // Q, then two stages of (K, V)
  static constexpr size_t kSmemBytes = 5 * (size_t)kElems * sizeof(bf16);
  // groups of output columns: at hd 256 two sets of 4 warps split hd for
  // P.V (each set computes the whole score tile for its 16-row groups)
  static constexpr int kColGroups = D > 128 ? 2 : 1;
  static constexpr int kCTA = kThreads * kColGroups;  // threads a CTA
};
static_assert(kBQ == kBK, "one tile shape for Q, K and V");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 float32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16x2(x0, x1) and lo = bf16x2 of what hi leaves out
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h),
                                    x1 - __high2float(h)));
}

// rows [row0, row0 + 64) of a (S, stride) bf16 matrix into a padded tile,
// rows past S zero-filled; 16 bytes a cp.async, all in flight at once
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* g,
                                          long long stride, int row0, int S,
                                          int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < kBK * kChunks; i += Bf16Tile<D>::kCTA) {
    const int r = i / kChunks, c = i % kChunks, pos = row0 + r;
    const bool ok = pos < S;
    cp_async16(smem_addr(tile + r * Bf16Tile<D>::kStride + c * 8),
               g + (long long)(ok ? pos : 0) * stride + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(Bf16Tile<D>::kCTA)
flash_attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int S, int H, int KV, float scale, int causal,
                       int window) {
  using Tile = Bf16Tile<D>;
  constexpr int kStride = Tile::kStride;
  constexpr int kKD = D / 16;   // k-steps of Q.K^T along hd
  constexpr int kGroups = Tile::kColGroups;
  constexpr int kCols = D / kGroups;  // output columns a warp
  constexpr int kND = kCols / 8;      // 8-wide column blocks of those
  constexpr int kNK = kBK / 8;  // 8-wide key blocks of a score tile
  // Q's A fragments stay in registers up to hd 128 (kKD x 4 words); at hd
  // 256 each k-step reads its Q fragment from shared memory instead
  constexpr bool kQRegs = D <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  auto Ks = [&](int st) { return Qs + (1 + 2 * st) * Tile::kElems; };
  auto Vs = [&](int st) { return Qs + (2 + 2 * st) * Tile::kElems; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad_row = lane >> 2, quad_col = 2 * (lane & 3);
  // the warp's 16-row group and its first output column
  const int wrow = kGroups == 1 ? warp : warp % 4;
  const int col0 = kGroups == 1 ? 0 : (warp / 4) * kCols;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int g = h / (H / KV);
  const long long qstride = (long long)H * D;  // between sequence positions
  const long long kstride = (long long)KV * D;
  const bf16* qb = q + (long long)b * S * qstride + (long long)h * D;
  const bf16* kb = k + (long long)b * S * kstride + (long long)g * D;
  const bf16* vb = v + (long long)b * S * kstride + (long long)g * D;
  bf16* ob = out + (long long)b * S * qstride + (long long)h * D;
  const float scale2 = scale * 1.4426950408889634f;  // scores in log2 units

  const int kv_begin = first_kv_tile(q0, window);
  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  const int ntiles = (kv_end - kv_begin + kBK - 1) / kBK;

  load_tile<D>(Qs, qb, qstride, q0, S, tid);
  load_tile<D>(Ks(0), kb, kstride, kv_begin, S, tid);
  load_tile<D>(Vs(0), vb, kstride, kv_begin, S, tid);
  cp_async_commit();

  // this thread's rows of the warp's 16: quad_row and quad_row + 8
  const int row0 = q0 + 16 * wrow + quad_row, row1 = row0 + 8;
  uint32_t qf[kQRegs ? kKD : 1][4];
  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums
  // ldmatrix x4 lane addressing: matrix lane / 8, its row lane % 8
  const int lrow = lane & 7, lmat = lane >> 3;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kv_begin + it * kBK, st = it & 1;
    if (it + 1 < ntiles) {  // the next tile's load overlaps this tile
      load_tile<D>(Ks(st ^ 1), kb, kstride, k0 + kBK, S, tid);
      load_tile<D>(Vs(st ^ 1), vb, kstride, k0 + kBK, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (it == 0) {  // A fragments of Q: (rows 0-7 | 8-15) x (k 0-7 | 8-15)
#pragma unroll
        for (int kk = 0; kk < kKD; ++kk)
          ldsm_x4(smem_addr(Qs + (16 * wrow + (lmat & 1) * 8 + lrow) *
                                     kStride +
                            kk * 16 + (lmat >> 1) * 8),
                  qf[kk]);
      }
    }

    // S = Q.K^T: B fragments of 16 keys x 16 hd per ldmatrix x4
    float s[kNK][4];
#pragma unroll
    for (int nb = 0; nb < kNK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    const bf16* kt = Ks(st);
    if constexpr (kQRegs) {
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
#pragma unroll
        for (int nb2 = 0; nb2 < kNK / 2; ++nb2) {
          uint32_t r[4];
          ldsm_x4(smem_addr(kt + (16 * nb2 + (lmat >> 1) * 8 + lrow) *
                                     kStride +
                            16 * kk + (lmat & 1) * 8),
                  r);
          mma_bf16(s[2 * nb2], qf[kk], r[0], r[1]);
          mma_bf16(s[2 * nb2 + 1], qf[kk], r[2], r[3]);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
        uint32_t qa[4];
        ldsm_x4(smem_addr(Qs + (16 * wrow + (lmat & 1) * 8 + lrow) * kStride +
                          kk * 16 + (lmat >> 1) * 8),
                qa);
#pragma unroll
        for (int nb2 = 0; nb2 < kNK / 2; ++nb2) {
          uint32_t r[4];
          ldsm_x4(smem_addr(kt + (16 * nb2 + (lmat >> 1) * 8 + lrow) *
                                     kStride +
                            16 * kk + (lmat & 1) * 8),
                  r);
          mma_bf16(s[2 * nb2], qa, r[0], r[1]);
          mma_bf16(s[2 * nb2 + 1], qa, r[2], r[3]);
        }
      }
    }

    // scale, mask (-inf: weight exactly 0), running max over the quad
    const bool masked = k0 + kBK > S || (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + kBQ - 1 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < kNK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale2;
        if (masked) {
          const int kpos = k0 + 8 * nb + quad_col + (e & 1);
          const int qpos = e < 2 ? row0 : row1;
          const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x : -INFINITY;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nb = 0; nb < kNK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m[e >> 1]);  // 0 where masked
        s[nb][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }

    // O += P.V, 16 keys a step: the score fragments of key blocks 2j and
    // 2j+1 are the A fragment of step j; P = hi + lo, two mma each
    const bf16* vt = Vs(st);
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * j][0], s[2 * j][1], hi[0], lo[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], hi[1], lo[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int nd2 = 0; nd2 < kND / 2; ++nd2) {
        uint32_t r[4];  // (keys 0-7 | 8-15) x (hd 0-7 | 8-15), transposed
        ldsm_x4_trans(smem_addr(vt + (16 * j + (lmat & 1) * 8 + lrow) *
                                         kStride +
                                col0 + 16 * nd2 + (lmat >> 1) * 8),
                      r);
        mma_bf16(o[2 * nd2], hi, r[0], r[1]);
        mma_bf16(o[2 * nd2], lo, r[0], r[1]);
        mma_bf16(o[2 * nd2 + 1], hi, r[2], r[3]);
        mma_bf16(o[2 * nd2 + 1], lo, r[2], r[3]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = i ? row1 : row0;
    if (qpos >= S) continue;
    bf16* orow = ob + (long long)qpos * qstride + col0 + quad_col;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nd) =
          __floats2bfloat162_rn(o[nd][2 * i] * l[i], o[nd][2 * i + 1] * l[i]);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int S, int H, int KV, float scale, int causal, int window,
                cudaStream_t stream) {
  const size_t smem = Bf16Tile<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // query tiles slowest, so each head's longest causal rows start first
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  flash_attn_bf16_kernel<D><<<grid, Bf16Tile<D>::kCTA, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, KV, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int KV, float scale, int causal, int window,
               cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attn_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KV, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, float scale, int causal, int window, int bf,
           cudaStream_t stream) {
  return bf ? launch_bf16<D>(q, k, v, out, B, S, H, KV, scale, causal, window,
                             stream)
            : launch_f32<D>(q, k, v, out, B, S, H, KV, scale, causal, window,
                            stream);
}

}  // namespace

// q, out: (B,S,H,hd) contiguous; k, v: (B,S,KV,hd) contiguous; all of one
// type (bf16 != 0: bfloat16, else float32), bfloat16 pointers 16-byte
// aligned.  hd in {16, 32, 64, 128, 256}.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int S, int H, int KV,
                                 int hd, float scale, int causal, int window,
                                 int bf16, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out);
  if (bf16 && any % 16 != 0)  // cp.async moves 16 bytes at a time
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, out, B, S, H, KV, scale, causal, window,
                        bf16, st);
    case 32:
      return launch<32>(q, k, v, out, B, S, H, KV, scale, causal, window,
                        bf16, st);
    case 64:
      return launch<64>(q, k, v, out, B, S, H, KV, scale, causal, window,
                        bf16, st);
    case 128:
      return launch<128>(q, k, v, out, B, S, H, KV, scale, causal, window,
                         bf16, st);
    case 256:
      return launch<256>(q, k, v, out, B, S, H, KV, scale, causal, window,
                         bf16, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
