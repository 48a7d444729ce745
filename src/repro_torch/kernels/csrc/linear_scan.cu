// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t on Hopper (sm_90a),
// float32, the RG-LRU's scan over the sequence.
//
// Replaces the lax.associative_scan of repro/models/rglru.py:rglru_scan
// (the reference's prefill form of the RG-LRU; not a Pallas kernel).  For
// a, b (B,T,N) and h0 (B,N), all float32 and contiguous:
//   h_0 = a_0 * h0 + b_0,  h_t = a_t * h_{t-1} + b_t,
// which is the reference's fold of h0 into the first input term
// (b[:, 0] += a[:, 0] * h0) followed by the scan.  It writes every h_t
// (B,T,N) and h_{T-1} (B,N).
//
// Bound on this card: bytes.  Each element reads a and b and writes h: 12
// bytes against 2 operations, so at the RG-LRU's width (N = lru_width =
// 2560) a 4,096-token prompt is 126 MB, 0.038 ms at 3.35 TB/s.
//
// Design: a single pass over a and b, tiled, with tiles joined by a
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016).  A tile is kLanes = 32
// neighbouring channels (one warp's coalesced 128-byte row) by kTile = 128
// steps; its 8 warps take 16 steps each.  A thread loads its 16 steps of
// a and b at once (32 loads in flight) and scans them in registers from
// h = 0, keeping each step's local h and running product of a.  The
// warps' (A, B) pairs (h -> A h + B over their sub-chunks) meet in shared
// memory, where warp 0 composes them in order into each warp's incoming
// map and the tile's aggregate.  Tiles take their place from an atomic
// ticket, not blockIdx, so a tile never waits on one that has not
// started: ticket k G + g is T-tile k of channel group g.  Tile 0 of a
// group starts from h0; every other tile publishes its aggregate, then
// walks back over its predecessors until one has published its inclusive
// prefix P_i, and folds forward from it through the aggregates after it,
// P_j = fma(A_j, P_{j-1}, B_j), taking P_j itself where it has appeared
// meanwhile.  Those are the fmas a chain of prefixes makes, so every
// prefix, and every output, has the same bits whatever the timing: how
// far a walk goes changes its length, not its result.  Each published
// value is a 64-bit word holding its tag in the high half and the float in
// the low half, read and written whole, so a reader needs no fence: word
// 0 of a (tile, channel) holds the aggregate's A, then the prefix; word 1
// the aggregate's B.  A tag is the launch's generation times 4 plus the
// kind (1: aggregate, 2: prefix), so a word left by an earlier launch
// reads as not yet published; the ticket counts up to the last tile and
// back to 0 (atomicInc).  So the wrapper keeps one scratch a stream from
// launch to launch, zeroed only when it is allocated or the generation
// wraps, and the kernel allocates nothing.  Then each output is written
// once, h_t = fma(A_t, h_in, B_t), from the sub-chunk's incoming state
// h_in.  The first step is fma(a_0, h0, b_0).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // channels a tile
constexpr int kWarps = 8;   // sub-chunks a tile
constexpr int kSteps = 16;  // steps a sub-chunk: a thread's registers
constexpr int kTile = kWarps * kSteps;
constexpr unsigned kGenerations = 1u << 30;  // tags: gen * 4 + kind
constexpr unsigned kAggregate = 1, kPrefix = 2;

__device__ __forceinline__ void publish(unsigned long long* p, unsigned gen,
                                        unsigned kind, float v) {
  const unsigned long long w =
      (static_cast<unsigned long long>(gen * 4 + kind) << 32) |
      __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}

// the word at p once this launch (generation gen) has published it
__device__ __forceinline__ unsigned long long poll(
    const unsigned long long* p, unsigned gen) {
  unsigned long long w;
  do {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(w) : "l"(p) : "memory");
  } while ((w >> 34) != gen);
  return w;
}

__device__ __forceinline__ unsigned kind(unsigned long long w) {
  return static_cast<unsigned>(w >> 32) & 3u;
}

__device__ __forceinline__ float value(unsigned long long w) {
  return __uint_as_float(static_cast<unsigned>(w));
}

__global__ void __launch_bounds__(kWarps * 32)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ out,
                   float* __restrict__ last, unsigned* __restrict__ ticket,
                   unsigned long long* __restrict__ status, int T, int N,
                   int groups, unsigned tiles, unsigned gen) {
  // each warp's map over its sub-chunk, then (from warp 0) its incoming map
  __shared__ float sa[kWarps][kLanes], sb[kWarps][kLanes];
  __shared__ float s_hin[kLanes];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the last tile to draw puts the ticket back to 0 for the next launch
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicInc(ticket, tiles - 1));
  __syncthreads();
  const int tile = s_tile;
  const int k = tile / groups, g = tile % groups;
  const int per_row = (N + kLanes - 1) / kLanes;
  const int bi = g / per_row, n = (g % per_row) * kLanes + lane;
  const bool live = n < N;
  const int t0 = k * kTile + warp * kSteps;
  const long long base = ((long long)bi * T + t0) * N + n;

  float va[kSteps], vb[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const bool ok = live && t0 + u < T;  // past T: the identity map
    va[u] = ok ? __ldcs(a + base + (long long)u * N) : 1.f;
    vb[u] = ok ? __ldcs(b + base + (long long)u * N) : 0.f;
  }
  // from h = 0: vb[u] the local h, va[u] the product of a over 0 .. u
#pragma unroll
  for (int u = 1; u < kSteps; ++u) {
    vb[u] = fmaf(va[u], vb[u - 1], vb[u]);
    va[u] *= va[u - 1];
  }
  sa[warp][lane] = va[kSteps - 1];
  sb[warp][lane] = vb[kSteps - 1];
  __syncthreads();
  if (warp == 0) {
    // each warp's incoming map: the maps of the warps before it, composed
    float A = 1.f, B = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wa = sa[w][lane], wb = sb[w][lane];
      sa[w][lane] = A;
      sb[w][lane] = B;
      B = fmaf(wa, B, wb);
      A *= wa;
    }
    unsigned long long* mine = status + (long long)tile * 2 * kLanes;
    float hin;
    if (k == 0) {
      hin = live ? h0[(long long)bi * N + n] : 0.f;
    } else {
      publish(mine + kLanes + lane, gen, kAggregate, B);
      publish(mine + lane, gen, kAggregate, A);
      // back to the nearest predecessor with its prefix ...
      long long j = tile - groups;
      unsigned long long w0 = poll(status + j * 2 * kLanes + lane, gen);
      while (kind(w0) != kPrefix) {
        j -= groups;
        w0 = poll(status + j * 2 * kLanes + lane, gen);
      }
      // ... then forward through the aggregates after it, in order
      hin = value(w0);
      for (j += groups; j < tile; j += groups) {
        const unsigned long long* theirs = status + j * 2 * kLanes;
        w0 = poll(theirs + lane, gen);
        hin = kind(w0) == kPrefix
                  ? value(w0)
                  : fmaf(value(w0), hin,
                         value(poll(theirs + kLanes + lane, gen)));
      }
    }
    publish(mine + lane, gen, kPrefix, fmaf(A, hin, B));
    s_hin[lane] = hin;
  }
  __syncthreads();
  const float h_in = fmaf(sa[warp][lane], s_hin[lane], sb[warp][lane]);
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    if (live && t0 + u < T) {
      const float h = fmaf(va[u], h_in, vb[u]);
      out[base + (long long)u * N] = h;
      if (t0 + u == T - 1) last[(long long)bi * N + n] = h;
    }
  }
}

}  // namespace

// a, b, out: (B,T,N) float32 contiguous; h0, last: (B,N) float32; scratch:
// scratch_words 64-bit words, at least tiles x 64 + 1 (tiles = B ceil(N /
// 32) ceil(T / 128)): the ticket (word 0, zero between launches), then the
// status words, which hold no tag of generation gen (1 <= gen < 2^30):
// zero when allocated, then one generation more each launch.
extern "C" int linear_scan_launch(const void* a, const void* b, const void* h0,
                                  void* out, void* last, void* scratch,
                                  long long scratch_words, int B, int T, int N,
                                  unsigned gen, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (T <= 0 || gen == 0 || gen >= kGenerations)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (long long)B * ((N + kLanes - 1) / kLanes);
  const long long tiles = groups * ((T + kTile - 1) / kTile);
  if (tiles > 0x7fffffffLL || scratch_words < tiles * 2 * kLanes + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* words = static_cast<unsigned long long*>(scratch);
  linear_scan_kernel<<<static_cast<unsigned>(tiles), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out),
      static_cast<float*>(last), reinterpret_cast<unsigned*>(words),
      words + 1, T, N, static_cast<int>(groups), static_cast<unsigned>(tiles),
      gen);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
