// Flash attention forward on Hopper (sm_90a): causal or full softmax
// attention with an online-softmax (m, l, acc) state in float32.
//
// Replaces the TPU kernel repro/kernels/flash_attn.py:flash_attention_pallas
// (body _flash_kernel) and, on the serving path, the lax.scan form
// repro/models/attention.py:_flash_attention that computes the same
// function.  For q (B,S,H,hd) and k, v (B,S,KV,hd), H a multiple of KV:
//   out[b,i,h] = sum_j softmax_j(scale * q[b,i,h] . k[b,j,g]) v[b,j,g]
// with g = h / (H/KV) (grouped-query attention by indexing, not by
// repeating K/V in memory), over the keys j that the mask keeps: j < S,
// j <= i when causal, j > i - window when window > 0.  Inputs and output
// are float32 or bfloat16; every product, sum and the running state are
// float32, as in the Pallas kernel, which upcasts its tiles.
//
// Bound on this card: at the serving shapes (S 2048-4096, hd 64) the
// operations, 4*S*S*H*hd/2 under the causal mask, against bytes of
// q, k, v and out read or written once: at S=4096, H=32, KV=8, bf16 that is
// 68.7 GFLOP and 41.9 MB, 0.0695 ms at the bf16 tensor-core rate.  This
// first design uses no tensor cores: it multiplies in float32 on the CUDA
// cores and is bound by shared-memory reads (three 16-byte loads for 32
// multiply-adds); wgmma, TMA and warp specialisation are later work.
//
// Design: one block of 128 threads per (b, h, 64-query tile), the query
// tiles issued last-first so the longest causal rows start first.  The Q
// tile is staged once in shared memory as float32; a loop walks the
// 64-key tiles from the window's first tile up to the diagonal (all of
// them when not causal), staging K and V in shared memory.  Each thread
// owns 4 query rows x 8 key columns of the score tile (rows 4r..4r+3,
// columns c, c+8, ..., c+56, with r = tid/8 and c = tid%8, so the 8 lanes
// of a row group sit in one aligned group of 8 and reduce with three
// xor-shuffles) and the same 4 rows x hd/8 columns of the output
// accumulator in registers.  Score dot products read float4s along hd
// (rows padded to hd+4 floats: conflict-free); P goes through shared
// memory for the P.V product.  Masked entries weigh exactly 0, so a row
// with no kept key yet carries (m, l, acc) = (-1e30, 0, 0), and the
// output is acc / max(l, 1e-30) as in the Pallas kernel.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;  // query rows a block
constexpr int kBK = 64;  // keys a tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_floats() {
  // Q and K tiles padded to D+4, the V tile, the P tile padded to kBK+4
  return (size_t)kBQ * (D + 4) + (size_t)kBK * (D + 4) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S, int H,
                  int KV, float scale, int causal, int window) {
  constexpr int kQS = D + 4;    // Q/K row stride (floats), 16-byte aligned
  constexpr int kPS = kBK + 4;  // P row stride
  constexpr int kCols = D / 8;  // output columns a thread
  constexpr int kVec = kCols < 4 ? kCols : 4;
  constexpr int kGroups = kCols / kVec;
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
  const T* qb = q + (long long)b * S * qstride + (long long)h * D;
  const T* kb = k + (long long)b * S * kstride + (long long)g * D;
  const T* vb = v + (long long)b * S * kstride + (long long)g * D;
  T* ob = out + (long long)b * S * qstride + (long long)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int row = i / D, d = i % D, pos = q0 + row;
    Qs[row * kQS + d] = pos < S ? to_f32(qb[pos * qstride + d]) : 0.f;
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
  int kv_begin = 0;
  if (window > 0) {  // tiles wholly before every row's window are skipped
    kv_begin = max(0, q0 - window + 1);
    kv_begin -= kv_begin % kBK;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with Vs and Ps
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int row = i / D, d = i % D, pos = k0 + row;
      float kx = 0.f, vx = 0.f;
      if (pos < S) {
        kx = to_f32(kb[pos * kstride + d]);
        vx = to_f32(vb[pos * kstride + d]);
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
#pragma unroll 2
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
#pragma unroll 2
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
    T* orow = ob + qpos * qstride + c * kVec;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        store(orow + gi * 8 * kVec + e, acc[i][gi * kVec + e] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, float scale, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KV, int hd, float scale, int causal,
              int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, S, H, KV, scale, causal, window,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, H, KV, scale, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, H, KV, scale, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, H, KV, scale, causal, window,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (B,S,H,hd) contiguous; k, v: (B,S,KV,hd) contiguous; all of one
// type (bf16 != 0: bfloat16, else float32).  hd in {16, 32, 64, 128}.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int S, int H, int KV,
                                 int hd, float scale, int causal, int window,
                                 int bf16, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hd<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, scale,
                                         causal, window, st)
              : launch_hd<float>(q, k, v, out, B, S, H, KV, hd, scale, causal,
                                 window, st);
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
